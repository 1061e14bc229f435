"""The Camera: a pair of (CameraExtrinsics, CameraIntrinsics).

Port of ``kaolin_tpu/render/camera/camera.py``.  Attribute access is routed
to the extrinsics or the intrinsics; :meth:`Camera.from_args` picks their
constructors from the keyword arguments given.
"""

from typing import Sequence

import torch

from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch.render.camera.extrinsics import CameraExtrinsics
from kaolin_tpu_torch.render.camera.intrinsics import (CameraFOV,
                                                       CameraIntrinsics)
from kaolin_tpu_torch.render.camera.intrinsics_ortho import (
    OrthographicIntrinsics)
from kaolin_tpu_torch.render.camera.intrinsics_pinhole import (
    PinholeIntrinsics)

__all__ = ['Camera', 'allclose']

_EXTRINSICS_ATTRS = {
    'R', 't', 'view_matrix', 'inv_view_matrix', 'cam_pos', 'cam_right',
    'cam_up', 'cam_forward', 'translate', 'rotate', 'move_right', 'move_up',
    'move_forward', 'change_coordinate_system', 'reset_coordinate_system',
    'basis_change_matrix', 'inv_transform_rays', 'switch_backend',
    'backend_name',
}
_INTRINSICS_ATTRS = {
    'width', 'height', 'near', 'far', 'aspect_ratio', 'projection_matrix',
    'viewport_matrix', 'ndc_matrix', 'perspective_matrix', 'focal_x',
    'focal_y', 'x0', 'y0', 'cx', 'cy', 'fov', 'fov_x', 'fov_y',
    'tan_half_fov', 'fov_distance', 'zoom', 'lens_type', 'normalize_depth',
    'set_ndc_range', 'ndc_min', 'ndc_max', 'clip_mask', 'project',
    'orthographic_matrix',
}


class Camera:
    """A differentiable batch of cameras = extrinsics + intrinsics.

    Build with :meth:`from_args`, e.g.::

        Camera.from_args(eye=[0, 0, 3], at=[0, 0, 0], up=[0, 1, 0],
                         fov=math.radians(45), width=512, height=512)
    """

    def __init__(self, extrinsics: CameraExtrinsics,
                 intrinsics: CameraIntrinsics):
        if len(extrinsics) != len(intrinsics):
            raise ValueError(
                f"extrinsics ({len(extrinsics)}) and intrinsics "
                f"({len(intrinsics)}) must hold the same number of cameras")
        object.__setattr__(self, 'extrinsics', extrinsics)
        object.__setattr__(self, 'intrinsics', intrinsics)

    @classmethod
    def from_args(cls, **kwargs):
        """Build a camera; the keyword arguments pick the constructors.

        Extrinsics (one group): ``eye``, ``at``, ``up`` (lookat);
        ``view_matrix``; ``cam_pos``, ``cam_dir`` (pose).  Intrinsics:
        ``fov`` in radians [``fov_direction``, ``x0``, ``y0``] (pinhole);
        ``focal_x`` [``focal_y``, ``x0``, ``y0``] (pinhole); else
        ``fov_distance`` (orthographic, default 1).  Plus ``width``,
        ``height`` and optional ``near``, ``far``, ``dtype``, ``backend``,
        ``requires_grad`` and ``device`` (default: the device of the tensor
        extrinsics arguments, the card for numpy ones).
        """
        dtype = kwargs.pop('dtype', torch.float32)
        backend = kwargs.pop('backend', None)
        requires_grad = kwargs.pop('requires_grad', False)
        common = dict(dtype=dtype, requires_grad=requires_grad,
                      backend=backend, device=kwargs.pop('device', None))
        if 'eye' in kwargs:
            extrinsics = CameraExtrinsics.from_lookat(
                eye=kwargs.pop('eye'), at=kwargs.pop('at'),
                up=kwargs.pop('up'), **common)
        elif 'view_matrix' in kwargs:
            extrinsics = CameraExtrinsics.from_view_matrix(
                kwargs.pop('view_matrix'), **common)
        elif 'cam_pos' in kwargs:
            extrinsics = CameraExtrinsics.from_camera_pose(
                cam_pos=kwargs.pop('cam_pos'), cam_dir=kwargs.pop('cam_dir'),
                **common)
        else:
            raise ValueError(
                "Could not match extrinsics args: give (eye, at, up), "
                "view_matrix, or (cam_pos, cam_dir)")

        width = kwargs.pop('width')
        height = kwargs.pop('height')
        common = dict(num_cameras=len(extrinsics), dtype=dtype,
                      device=extrinsics.device)
        for k in ('near', 'far'):
            if k in kwargs:
                common[k] = kwargs.pop(k)
        if 'fov' in kwargs:
            intrinsics = PinholeIntrinsics.from_fov(
                width, height, kwargs.pop('fov'),
                kwargs.pop('fov_direction', CameraFOV.VERTICAL),
                x0=kwargs.pop('x0', 0.), y0=kwargs.pop('y0', 0.), **common)
        elif 'focal_x' in kwargs:
            intrinsics = PinholeIntrinsics.from_focal(
                width, height, kwargs.pop('focal_x'),
                kwargs.pop('focal_y', None), x0=kwargs.pop('x0', None),
                y0=kwargs.pop('y0', None), **common)
        else:
            intrinsics = OrthographicIntrinsics.from_frustum(
                width, height, kwargs.pop('fov_distance', 1.0), **common)
        if kwargs:
            raise ValueError(f"Unrecognized Camera.from_args kwargs: "
                             f"{sorted(kwargs)}")
        return cls(extrinsics, intrinsics)

    # -- attribute routing -------------------------------------------------
    def __getattr__(self, name):
        # only called when the normal lookup fails
        extr = object.__getattribute__(self, 'extrinsics')
        intr = object.__getattribute__(self, 'intrinsics')
        if name in _EXTRINSICS_ATTRS or hasattr(type(extr), name):
            return getattr(extr, name)
        if name in _INTRINSICS_ATTRS or hasattr(intr, name):
            return getattr(intr, name)
        raise AttributeError(f"Camera has no attribute {name!r}")

    def __setattr__(self, name, value):
        if name in ('extrinsics', 'intrinsics'):
            object.__setattr__(self, name, value)
        elif name in _EXTRINSICS_ATTRS:
            setattr(self.extrinsics, name, value)
        elif name in _INTRINSICS_ATTRS:
            setattr(self.intrinsics, name, value)
        else:
            object.__setattr__(self, name, value)

    # -- core --------------------------------------------------------------
    def __len__(self):
        return len(self.extrinsics)

    @property
    def dtype(self):
        return self.extrinsics.dtype

    @property
    def device(self):
        return self.extrinsics.device

    def transform(self, vectors):
        """World -> camera -> NDC."""
        return self.intrinsics.transform(self.extrinsics.transform(vectors))

    def view_projection_matrix(self):
        """(C, 4, 4) ``projection @ view``."""
        return (self.intrinsics.projection_matrix() @
                self.extrinsics.view_matrix())

    def __getitem__(self, item):
        if isinstance(item, int):
            n = len(self)
            if item < -n or item >= n:
                raise IndexError(
                    f'camera index {item} out of range for batch of {n}')
        return Camera(self.extrinsics[item], self.intrinsics[item])

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    @classmethod
    def cat(cls, cameras: Sequence['Camera']):
        """Concatenate camera batches."""
        return cls(
            CameraExtrinsics.cat([c.extrinsics for c in cameras]),
            type(cameras[0].intrinsics).cat([c.intrinsics for c in cameras]))

    def allclose(self, other, rtol=1e-5, atol=1e-8):
        return (self.extrinsics.allclose(other.extrinsics, rtol, atol) and
                self.intrinsics.allclose(other.intrinsics, rtol, atol))

    def parameters(self):
        return (self.extrinsics.params, self.intrinsics.params)

    def named_params(self):
        return [dict(**e, **i) for e, i in zip(
            self.extrinsics.named_params(), self.intrinsics.named_params())]

    def __repr__(self):
        return (f"Camera of {len(self)} cameras of "
                f"{self.width}x{self.height}:\n"
                f"{self.extrinsics!r}\n{self.intrinsics!r}")

    def generate_rays(self):
        """Per-pixel primary rays in world coords.

        Returns:
            (ray_orig, ray_dir): each (C, H*W, 3), in row-major pixel order
            (y outer, x inner, origin at the top left); directions of unit
            length (the norm is floored at 1e-12).
        """
        H, W, C = self.height, self.width, len(self)
        kw = dict(dtype=self.dtype, device=self.device)
        xs = (torch.arange(W, **kw) + 0.5) / W * 2. - 1.
        ys = 1. - (torch.arange(H, **kw) + 0.5) / H * 2.
        grid_y, grid_x = torch.meshgrid(ys, xs, indexing='ij')
        if isinstance(self.intrinsics, PinholeIntrinsics):
            tan_x = self.intrinsics.tan_half_fov(CameraFOV.HORIZONTAL)
            tan_y = self.intrinsics.tan_half_fov(CameraFOV.VERTICAL)
            dirs = torch.stack([
                grid_x[None] * tan_x[:, None, None],
                grid_y[None] * tan_y[:, None, None],
                -torch.ones((C, H, W), **kw)], dim=-1)
            orig = torch.zeros_like(dirs)
        else:
            fov_d = self.intrinsics.fov_distance
            aspect = self.intrinsics.aspect_ratio
            orig = torch.stack([
                grid_x[None] * fov_d[:, None, None] * aspect,
                grid_y[None] * fov_d[:, None, None],
                torch.zeros((C, H, W), **kw)], dim=-1)
            dirs = torch.cat([torch.zeros_like(orig[..., :2]),
                              -torch.ones_like(orig[..., :1])], dim=-1)
        out_orig, out_dir = self.extrinsics.inv_transform_rays(
            orig.reshape(C, -1, 3), dirs.reshape(C, -1, 3))
        out_dir = out_dir / clip(
            torch.linalg.norm(out_dir, dim=-1, keepdim=True), 1e-12)
        return out_orig, out_dir


def allclose(input, other, rtol=1e-5, atol=1e-8):
    """allclose over Camera, extrinsics or intrinsics objects."""
    return input.allclose(other, rtol=rtol, atol=atol)
