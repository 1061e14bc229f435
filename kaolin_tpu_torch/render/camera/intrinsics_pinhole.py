"""Pinhole (perspective) camera intrinsics.

Port of ``kaolin_tpu/render/camera/intrinsics_pinhole.py``, with its matrix
conventions:

* perspective_matrix = ``[[fx,0,-x0,0],[0,fy,-y0,0],[0,0,0,1],[0,0,1,0]]``;
* ndc_matrix normalizes the frustum cuboid to left-handed NDC, for the depth
  ranges [-1, 1] (OpenGL), [0, 1] and [1, 0] (reverse z);
* projection_matrix = ndc_matrix @ perspective_matrix.
"""

import math
from enum import IntEnum

import torch

from kaolin_tpu_torch.render.camera.intrinsics import (
    CameraFOV, CameraIntrinsics, default_dtype)

__all__ = ['PinholeIntrinsics', 'PinholeParamsDefEnum']


class PinholeParamsDefEnum(IntEnum):
    """Column indices of the pinhole ``params`` tensor."""
    x0 = 0
    y0 = 1
    focal_x = 2
    focal_y = 3


def _column(name):
    return property(lambda self: self._param_col(name),
                    lambda self, val: self._set_param_col(name, val))


class PinholeIntrinsics(CameraIntrinsics):
    """Pinhole intrinsics: params columns (x0, y0, focal_x, focal_y)."""

    DEFAULT_NEAR = 1e-2
    DEFAULT_FAR = 1e2
    param_names = ('x0', 'y0', 'focal_x', 'focal_y')
    x0 = _column('x0')
    y0 = _column('y0')
    focal_x = _column('focal_x')
    focal_y = _column('focal_y')

    @property
    def lens_type(self):
        return 'pinhole'

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_focal(cls, width, height, focal_x, focal_y=None, x0=None,
                   y0=None, near=DEFAULT_NEAR, far=DEFAULT_FAR,
                   num_cameras=1, dtype=default_dtype, device=None):
        """From focal lengths in pixels, on ``device`` (default: the card).
        """
        params = cls._allocate_params(
            0.0 if x0 is None else x0, 0.0 if y0 is None else y0, focal_x,
            focal_y if focal_y else focal_x, num_cameras=num_cameras,
            dtype=dtype, device=device)
        return cls(width, height, params, near, far)

    @classmethod
    def from_fov(cls, width, height, fov, fov_direction=CameraFOV.VERTICAL,
                 x0=0., y0=0., near=DEFAULT_NEAR, far=DEFAULT_FAR,
                 num_cameras=1, dtype=default_dtype, device=None):
        """From a field of view ``fov`` in radians, on ``device`` (default:
        the card)."""
        assert fov_direction in (CameraFOV.HORIZONTAL, CameraFOV.VERTICAL)
        aspect_scale = (width / 2.0 if fov_direction is CameraFOV.HORIZONTAL
                        else height / 2.0)
        focal = aspect_scale / math.tan(fov / 2.0)
        params = cls._allocate_params(x0, y0, focal, focal,
                                      num_cameras=num_cameras, dtype=dtype,
                                      device=device)
        return cls(width, height, params, near, far)

    @property
    def cx(self):
        """Principal point x in image coords (center + x0)."""
        return self.width / 2. + self.x0

    @property
    def cy(self):
        return self.height / 2. + self.y0

    # -- fov ---------------------------------------------------------------
    def tan_half_fov(self, camera_fov_direction=CameraFOV.VERTICAL):
        if camera_fov_direction is CameraFOV.HORIZONTAL:
            return (self.width / 2.0) / self.focal_x
        elif camera_fov_direction is CameraFOV.VERTICAL:
            return (self.height / 2.0) / self.focal_y
        raise ValueError(f"Unsupported fov direction {camera_fov_direction}")

    def fov(self, camera_fov_direction=CameraFOV.VERTICAL, in_degrees=True):
        if camera_fov_direction is CameraFOV.HORIZONTAL:
            x, y = self.focal_x, self.width / 2.0
        elif camera_fov_direction is CameraFOV.VERTICAL:
            x, y = self.focal_y, self.height / 2.0
        else:
            raise ValueError(
                f"Unsupported fov direction {camera_fov_direction}")
        out = 2 * torch.atan2(torch.full_like(x, y), x)
        return out * 180 / math.pi if in_degrees else out

    @property
    def fov_x(self):
        return self.fov(CameraFOV.HORIZONTAL, in_degrees=True)

    @fov_x.setter
    def fov_x(self, angle_degs):
        fov = torch.as_tensor(angle_degs, dtype=self.dtype,
                              device=self.device) / 180 * math.pi
        self.focal_x = (self.width / 2.0) / torch.tan(fov / 2.0)

    @property
    def fov_y(self):
        return self.fov(CameraFOV.VERTICAL, in_degrees=True)

    @fov_y.setter
    def fov_y(self, angle_degs):
        fov = torch.as_tensor(angle_degs, dtype=self.dtype,
                              device=self.device) / 180 * math.pi
        self.focal_y = (self.height / 2.0) / torch.tan(fov / 2.0)

    def zoom(self, amount):
        """Narrow the fov by ``amount`` degrees (positive zooms in)."""
        fov_ratio = self.fov_x / self.fov_y
        self.fov_y = self.fov_y - amount
        self.fov_x = self.fov_y * fov_ratio
        return self

    # -- matrices ----------------------------------------------------------
    def perspective_matrix(self):
        """(C, 4, 4) camera space -> homogeneous pre-NDC clip coords."""
        fx, fy = self.focal_x, self.focal_y
        zero, one = torch.zeros_like(fx), torch.ones_like(fx)
        return torch.stack([
            torch.stack([fx, zero, -self.x0, zero], dim=-1),
            torch.stack([zero, fy, -self.y0, zero], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1),
            torch.stack([zero, zero, one, zero], dim=-1)], dim=1)

    def ndc_matrix(self, left, right, bottom, top, near, far):
        """(1, 4, 4) matrix normalizing the frustum cuboid to clip space."""
        tx = -(right + left) / (right - left)
        ty = -(top + bottom) / (top - bottom)
        if self.ndc_min == -1 and self.ndc_max == 1:
            U = -2.0 * near * far / (far - near)
            V = -(far + near) / (far - near)
        elif self.ndc_min == 0 and self.ndc_max == 1:
            U = (near * far) / (near - far)
            V = far / (far - near)
        elif self.ndc_min == 1 and self.ndc_max == 0:
            U = (near * far) / (far - near)
            V = near / (far - near)
        else:
            raise NotImplementedError(
                'Perspective Projection does not support NDC range of '
                f'[{self.ndc_min}, {self.ndc_max}]')
        return torch.tensor([
            [2.0 / (right - left), 0.0, 0.0, -tx],
            [0.0, 2.0 / (top - bottom), 0.0, -ty],
            [0.0, 0.0, U, V],
            [0.0, 0.0, 0.0, -1.0]], dtype=self.dtype, device=self.device)[None]

    def projection_matrix(self):
        """(C, 4, 4) OpenGL-compatible projection = ndc @ perspective."""
        top = self.height / 2
        right = self.width / 2
        ndc = self.ndc_matrix(-right, right, -top, top, self.near, self.far)
        return ndc @ self.perspective_matrix()

    def normalize_depth(self, depth):
        """Depths normalized to [0, 1] within the NDC frustum."""
        if depth.ndim < 2:
            depth = depth.expand((len(self),) + tuple(depth.shape))
        proj = self.projection_matrix()
        a = -proj[:, 2, 2]
        b = -proj[:, 2, 3]
        depth = torch.clamp(depth, min(self.near, self.far),
                            max(self.near, self.far))
        ndc_depth = a[:, None] - b[:, None] / depth
        ndc_min = min(self.ndc_min, self.ndc_max)
        ndc_max = max(self.ndc_min, self.ndc_max)
        return torch.clamp((ndc_depth - ndc_min) / (ndc_max - ndc_min),
                           0.0, 1.0)
