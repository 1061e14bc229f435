"""Differentiable camera extrinsics (the SE(3) world -> camera transform).

Port of ``kaolin_tpu/render/camera/extrinsics.py``.  The view matrix is::

    [ R | t ]     world2cam;  cam2world = [ R^T | -R^T t ]
    [ 0 | 1 ]

``params`` is one tensor, (C, num_params) in the backend's layout.  Built
with ``requires_grad=True`` it is a leaf tensor that requires grad, in the
6-DoF backend (unless another is named).  The motion ops (translate,
rotate, move_*, the R and t setters) change the camera and return it; on
such a leaf they write the new values into it in place, outside autograd,
so an optimizer keeps its reference, and otherwise replace ``params``.
"""

from typing import Sequence

import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.render.camera import extrinsics_backends as _backends
from kaolin_tpu_torch.render.camera.extrinsics_backends import (_bottom_row,
                                                                _normalize)

__all__ = ['CameraExtrinsics']

default_dtype = torch.float32


class CameraExtrinsics:
    """The extrinsics parameters of a batch of cameras.

    Build with :meth:`from_lookat`, :meth:`from_camera_pose` or
    :meth:`from_view_matrix`.
    """

    def __init__(self, params, backend_name='matrix_se3',
                 base_change_matrix=None):
        """``params``: a (C, num_params) tensor in ``backend_name``'s
        layout; ``base_change_matrix``: the basis changes made so far."""
        self.params = params
        self.backend_name = backend_name
        if base_change_matrix is None:
            base_change_matrix = torch.eye(3)
        self._base_change_matrix = torch.as_tensor(
            base_change_matrix, dtype=torch.float32).cpu()

    # -- constructors ------------------------------------------------------
    @classmethod
    def _from_mat(cls, mat, backend=None, requires_grad=False):
        if backend is None:
            backend = ('matrix_6dof_rotation' if requires_grad
                       else 'matrix_se3')
        params = _backends.get_backend(backend).from_mat(mat)
        if requires_grad:
            params = params.detach().requires_grad_()
        return cls(params, backend)

    @classmethod
    def from_view_matrix(cls, view_matrix, dtype=default_dtype,
                         requires_grad=False, backend=None, device=None):
        """From a (C, 4, 4) world2cam matrix, on ``device`` (default: the
        device of a tensor matrix, the card for a numpy one)."""
        mat = torch.as_tensor(view_matrix, dtype=dtype,
                              device=entry_device(device, view_matrix))
        if mat.ndim == 2:
            mat = mat[None]
        return cls._from_mat(mat, backend, requires_grad)

    @classmethod
    def from_camera_pose(cls, cam_pos, cam_dir, dtype=default_dtype,
                         requires_grad=False, backend=None, device=None):
        """From camera positions (C, 3) and 3x3 orientations (C, 3, 3) in
        world coords, on ``device`` (default: the device of the tensor
        inputs, the card for numpy ones)."""
        device = entry_device(device, cam_pos, cam_dir)
        cam_pos = torch.as_tensor(cam_pos, dtype=dtype, device=device)
        cam_dir = torch.as_tensor(cam_dir, dtype=dtype, device=device)
        if cam_dir.ndim == 2:
            cam_dir = cam_dir[None]
        if cam_pos.ndim == 1:
            cam_pos = cam_pos[None]
        if cam_pos.shape[-1] != 1:
            cam_pos = cam_pos[..., None]                         # (C, 3, 1)
        world_rotation = cam_dir.transpose(-1, -2)
        return cls._from_rt(world_rotation, -world_rotation @ cam_pos,
                            backend, requires_grad)

    @classmethod
    def _from_rt(cls, rotation, translation, backend=None,
                 requires_grad=False):
        top = torch.cat([rotation, translation], dim=2)
        return cls._from_mat(torch.cat([top, _bottom_row(top)], dim=1),
                             backend, requires_grad)

    @classmethod
    def from_lookat(cls, eye, at, up, dtype=default_dtype,
                    requires_grad=False, backend=None, device=None):
        """From eye / at / up (glm-style lookat, right handed), each (3,) or
        (C, 3), on ``device`` (default: the device of the tensor inputs,
        the card for numpy ones)."""
        device = entry_device(device, eye, at, up)
        eye, at, up = (torch.atleast_2d(torch.as_tensor(
            x, dtype=dtype, device=device).squeeze()) for x in (eye, at, up))
        backward = _normalize(at - eye)
        right = _normalize(torch.linalg.cross(backward, up, dim=-1))
        up_ortho = torch.linalg.cross(right, backward, dim=-1)
        world_rotation = torch.stack((right, up_ortho, -backward), dim=1)
        return cls._from_rt(world_rotation, -world_rotation @ eye[..., None],
                            backend, requires_grad)

    # -- core accessors ----------------------------------------------------
    def __len__(self):
        return self.params.shape[0]

    @property
    def backend(self):
        return _backends.get_backend(self.backend_name)

    @property
    def dtype(self):
        return self.params.dtype

    @property
    def device(self):
        return self.params.device

    @property
    def requires_grad(self):
        return self.params.requires_grad

    def view_matrix(self):
        """(C, 4, 4) world2cam matrix."""
        return self.backend.to_mat(self.params)

    def inv_view_matrix(self):
        """(C, 4, 4) cam2world matrix."""
        mat = self.view_matrix()
        Rt = mat[:, :3, :3].transpose(1, 2)
        top = torch.cat([Rt, -Rt @ mat[:, :3, 3:]], dim=2)
        return torch.cat([top, _bottom_row(top)], dim=1)

    @property
    def R(self):
        """(C, 3, 3) rotation of the view matrix."""
        return self.view_matrix()[:, :3, :3]

    @R.setter
    def R(self, val):
        mat = self.view_matrix().clone()
        mat[:, :3, :3] = val
        self.update(mat)

    @property
    def t(self):
        """(C, 3, 1) translation of the view matrix."""
        return self.view_matrix()[:, :3, 3:]

    @t.setter
    def t(self, val):
        val = torch.as_tensor(val, dtype=self.dtype, device=self.device)
        if val.shape[-1] != 1:
            val = val[..., None]
        mat = self.view_matrix().clone()
        mat[:, :3, 3:] = val
        self.update(mat)

    def update(self, mat):
        """Set the params from a (C, 4, 4) view matrix."""
        params = self.backend.from_mat(mat)
        if self.params.is_leaf and self.params.requires_grad:
            with torch.no_grad():
                self.params.copy_(params)
        else:
            self.params = params
        return self

    # -- transforms --------------------------------------------------------
    def transform(self, vectors):
        """World -> camera, ``R @ v + t``: (B, 3) or (C, B, 3) -> (C, B, 3).
        """
        v = vectors.expand((len(self),) + tuple(vectors.shape[-2:]))
        return torch.einsum('cij,cbj->cbi', self.R, v) + self.t[:, None, :, 0]

    def inv_transform_rays(self, ray_orig, ray_dir):
        """Camera -> world for ray origins and directions, each (B, 3) or
        (C, B, 3); returns two (C, B, 3)."""
        C = len(self)
        o = ray_orig.expand((C,) + tuple(ray_orig.shape[-2:]))
        d = ray_dir.expand((C,) + tuple(ray_dir.shape[-2:]))
        Rt = self.R.transpose(1, 2)
        out_d = torch.einsum('cij,cbj->cbi', Rt, d)
        out_o = torch.einsum('cij,cbj->cbi', Rt, o - self.t[:, None, :, 0])
        return out_o, out_d

    # -- coordinate system -------------------------------------------------
    def change_coordinate_system(self, basis_change):
        """Apply a 3x3 permutation / reflection change of world basis:
        ``R <- R @ P^T``."""
        P = torch.as_tensor(basis_change, dtype=torch.float32).cpu()
        self._base_change_matrix = self._base_change_matrix @ P
        self.R = self.R @ P.T.to(self.params)[None]
        return self

    def reset_coordinate_system(self):
        """Revert all the basis changes made so far."""
        self.change_coordinate_system(self._base_change_matrix.T)
        self._base_change_matrix = torch.eye(3)
        return self

    @property
    def basis_change_matrix(self):
        return self._base_change_matrix.to(self.device)

    # -- interactive ops ---------------------------------------------------
    def translate(self, t):
        """Move the camera by ``t`` in world coords (orientation kept):
        ``t <- t - R @ delta``."""
        t = torch.as_tensor(t, dtype=self.dtype, device=self.device)
        if t.shape[-1] != 1:
            t = t[..., None]
        self.t = self.t - self.R @ t
        return self

    def rotate(self, yaw=None, pitch=None, roll=None):
        """Rotate by yaw / pitch / roll (radians), in camera space."""
        C = len(self)
        eye = torch.eye(4, dtype=self.dtype, device=self.device)
        rotation_mat = eye.expand(C, 4, 4)

        def turn(angle, i, j, sign):
            a = torch.as_tensor(angle, dtype=self.dtype,
                                device=self.device).reshape(-1).expand(C)
            m = eye.repeat(C, 1, 1)
            m[:, i, i] = torch.cos(a)
            m[:, i, j] = -sign * torch.sin(a)
            m[:, j, i] = sign * torch.sin(a)
            m[:, j, j] = torch.cos(a)
            return m

        if yaw is not None:
            rotation_mat = turn(yaw, 0, 2, 1.) @ rotation_mat
        if pitch is not None:
            rotation_mat = turn(pitch, 1, 2, -1.) @ rotation_mat
        if roll is not None:
            rotation_mat = turn(roll, 0, 1, 1.) @ rotation_mat
        self.update(rotation_mat @ self.view_matrix())
        return self

    def _world_axis(self, i):
        col = torch.zeros_like(self.t)
        col[:, i] = 1.
        return col

    def move_right(self, amount):
        self.t = self.t - self._world_axis(0) * amount
        return self

    def move_up(self, amount):
        self.t = self.t - self._world_axis(1) * amount
        return self

    def move_forward(self, amount):
        self.t = self.t - self._world_axis(2) * amount
        return self

    def cam_pos(self):
        """(C, 3, 1) camera position in world coords: ``-R^T t``."""
        return -self.R.transpose(1, 2) @ self.t

    def cam_right(self):
        return self.R.transpose(1, 2) @ self._world_axis(0)

    def cam_up(self):
        return self.R.transpose(1, 2) @ self._world_axis(1)

    def cam_forward(self):
        return self.R.transpose(1, 2) @ self._world_axis(2)

    # -- misc --------------------------------------------------------------
    def parameters(self):
        return self.params

    def switch_backend(self, backend_name):
        """A copy in another param backend (a leaf that requires grad if
        this camera's params do)."""
        params = _backends.get_backend(backend_name).from_mat(
            self.view_matrix()).detach()
        return CameraExtrinsics(params.requires_grad_(self.requires_grad),
                                backend_name, self._base_change_matrix)

    def gradient_mask(self, *args):
        """Boolean mask over ``params`` selecting 'R' and / or 't'."""
        mask = torch.zeros(self.params.shape[-1], dtype=torch.bool)
        for a in args:
            if a == 'R':
                mask[self.backend.R_idx] = True
            elif a == 't':
                mask[self.backend.t_idx] = True
            else:
                raise ValueError(f"unknown component {a!r}")
        return mask.to(self.device).expand(self.params.shape)

    def __getitem__(self, item):
        if isinstance(item, int):
            item = slice(item, item + 1)
        return CameraExtrinsics(self.params[item], self.backend_name,
                                self._base_change_matrix)

    @classmethod
    def cat(cls, cameras: Sequence['CameraExtrinsics']):
        """Concatenate extrinsics into one batch (the first one's backend).
        """
        first = cameras[0]
        mats = torch.cat([c.view_matrix() for c in cameras], dim=0)
        return cls(first.backend.from_mat(mats), first.backend_name,
                   first._base_change_matrix)

    def allclose(self, other, rtol=1e-5, atol=1e-8):
        return (self.params.shape == other.params.shape and
                bool(torch.allclose(self.view_matrix(), other.view_matrix(),
                                    rtol=rtol, atol=atol)))

    def named_params(self):
        """Per camera, a dict of its R (3, 3) and t (3,)."""
        mats = self.view_matrix().detach().cpu()
        return [{'R': m[:3, :3], 't': m[:3, 3]} for m in mats]

    def __repr__(self):
        return (f"CameraExtrinsics of {len(self)} cameras, backend: "
                f"{self.backend_name}.\n{self.view_matrix()}")
