"""Orthographic camera intrinsics.

Port of ``kaolin_tpu/render/camera/intrinsics_ortho.py``.
"""

from enum import IntEnum

import torch

from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch.render.camera.intrinsics import (
    CameraIntrinsics, default_dtype)

__all__ = ['OrthographicIntrinsics', 'OrthoParamsDefEnum']


class OrthoParamsDefEnum(IntEnum):
    """Column indices of the orthographic ``params`` tensor."""
    fov_distance = 0


class OrthographicIntrinsics(CameraIntrinsics):
    """Orthographic intrinsics: one ``fov_distance`` zoom-scale param."""

    DEFAULT_NEAR = 1e-2
    DEFAULT_FAR = 1e2
    param_names = ('fov_distance',)

    @property
    def lens_type(self):
        return 'ortho'

    @classmethod
    def from_frustum(cls, width, height, fov_distance=1.0,
                     near=DEFAULT_NEAR, far=DEFAULT_FAR, num_cameras=1,
                     dtype=default_dtype, device=None):
        """On ``device`` (default: the card)."""
        params = cls._allocate_params(fov_distance, num_cameras=num_cameras,
                                      dtype=dtype, device=device)
        return cls(width, height, params, near, far)

    @property
    def fov_distance(self):
        return self._param_col('fov_distance')

    @fov_distance.setter
    def fov_distance(self, val):
        self._set_param_col('fov_distance', val)

    def orthographic_matrix(self, left, right, bottom, top, near, far):
        """(C, 4, 4) glOrtho-style NDC normalization matrix."""
        fov = self.fov_distance
        zero, one = torch.zeros_like(fov), torch.ones_like(fov)

        def const(v):
            return torch.full_like(fov, v)

        return torch.stack([
            torch.stack([2.0 / (fov * (right - left)), zero, zero,
                         const(-(right + left) / (right - left))], dim=-1),
            torch.stack([zero, 2.0 / (fov * (top - bottom)), zero,
                         const(-(top + bottom) / (top - bottom))], dim=-1),
            torch.stack([zero, zero, -2.0 / const(far - near),
                         const(-(far + near) / (far - near))], dim=-1),
            torch.stack([zero, zero, zero, one], dim=-1)], dim=1)

    def projection_matrix(self):
        """(C, 4, 4) OpenGL-compatible orthographic projection matrix."""
        right = 1.0 * self.width / self.height
        return self.orthographic_matrix(-right, right, -1.0, 1.0, self.near,
                                        self.far)

    def normalize_depth(self, depth):
        """Depths normalized to [0, 1] linearly within [near, far]."""
        if depth.ndim < 2:
            depth = depth.expand((len(self),) + tuple(depth.shape))
        depth = clip(depth, min(self.near, self.far),
                     max(self.near, self.far))
        return clip((depth - self.near) / (self.far - self.near), 0., 1.)

    def zoom(self, amount):
        """Zoom in by decreasing ``fov_distance`` (kept >= 1e-4)."""
        self.fov_distance = torch.clamp(self.fov_distance - amount,
                                        min=1e-4)
        return self
