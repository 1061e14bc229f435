"""Camera intrinsics base class and homogeneous-coordinate helpers.

Port of ``kaolin_tpu/render/camera/intrinsics.py``.  ``params`` is one
(C, P) tensor, one column per name in ``param_names``; width, height, near,
far and the NDC depth range are plain attributes.
"""

import copy
from enum import IntEnum
from typing import Sequence

import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['CameraFOV', 'CameraIntrinsics', 'up_to_homogeneous',
           'down_from_homogeneous']

default_dtype = torch.float32


def up_to_homogeneous(vectors):
    """Append a homogeneous w = 1 coordinate if the last dim is 3."""
    if vectors.shape[-1] == 4:
        return vectors
    ones = vectors.new_ones(tuple(vectors.shape[:-1]) + (1,))
    return torch.cat([vectors, ones], dim=-1)


def down_from_homogeneous(homogeneous_vectors):
    """Perspective division: divide by w and drop it."""
    return homogeneous_vectors[..., :-1] / homogeneous_vectors[..., -1:]


class CameraFOV(IntEnum):
    """Camera field-of-view direction."""
    HORIZONTAL = 0
    VERTICAL = 1
    DIAGONAL = 2


class CameraIntrinsics:
    """Base class of lens intrinsics (pinhole, orthographic)."""

    param_names = ()   # subclass: the names of the columns of ``params``

    def __init__(self, width, height, params, near=1e-2, far=1e2):
        self.width = int(width)
        self.height = int(height)
        self.params = params
        self.near = float(near)
        self.far = float(far)
        self.ndc_min = -1.
        self.ndc_max = 1.

    def _with_params(self, params):
        out = copy.copy(self)
        out.params = params
        return out

    # -- basic accessors ---------------------------------------------------
    def __len__(self):
        return self.params.shape[0]

    @property
    def aspect_ratio(self):
        return self.width / self.height

    @property
    def dtype(self):
        return self.params.dtype

    @property
    def device(self):
        return self.params.device

    def parameters(self):
        return self.params

    @classmethod
    def _allocate_params(cls, *args, num_cameras=1, dtype=default_dtype,
                         device=None):
        row = torch.tensor(args, dtype=dtype, device=entry_device(device))
        return row[None].repeat(num_cameras, 1)

    def _param_col(self, name):
        return self.params[:, self.param_names.index(name)]

    def _set_param_col(self, name, val):
        params = self.params.clone()
        params[:, self.param_names.index(name)] = torch.as_tensor(
            val, dtype=self.dtype, device=self.device)
        self.params = params

    def named_params(self):
        return [dict(zip(self.param_names, row))
                for row in self.params.detach().cpu().tolist()]

    # -- NDC / viewport ----------------------------------------------------
    def set_ndc_range(self, ndc_min, ndc_max):
        """Set the NDC depth range convention (default [-1, 1])."""
        self.ndc_min = ndc_min
        self.ndc_max = ndc_max
        return self

    def viewport_matrix(self, vl=0, vr=None, vb=0, vt=None,
                        min_depth=0.0, max_depth=1.0):
        """(1, 4, 4) matrix from NDC [-1, 1] to viewport coords."""
        vr = self.width if vr is None else vr
        vt = self.height if vt is None else vt
        return torch.tensor([
            [(vr - vl) / 2., 0., 0., (vr + vl) / 2.],
            [0., (vt - vb) / 2., 0., (vt + vb) / 2.],
            [0., 0., (max_depth - min_depth) / 2.,
             (max_depth + min_depth) / 2.],
            [0., 0., 0., 1.]], dtype=self.dtype, device=self.device)[None]

    def clip_mask(self, depth):
        """Depths within the [near, far] frustum range."""
        return (depth <= -self.near) & (depth >= -self.far)

    # -- transforms --------------------------------------------------------
    def projection_matrix(self):
        raise NotImplementedError

    def zoom(self, amount):
        raise NotImplementedError

    @property
    def lens_type(self):
        raise NotImplementedError

    def project(self, vectors):
        """Homogeneous clip coords, no perspective division: (B, 3|4) or
        (C, B, 3|4) -> (C, B, 4)."""
        v = up_to_homogeneous(vectors)
        v = v.expand((len(self),) + tuple(v.shape[-2:]))
        return torch.einsum('cij,cbj->cbi', self.projection_matrix(), v)

    def transform(self, vectors):
        """NDC coords (with perspective division): (C, B, 3)."""
        return down_from_homogeneous(self.project(vectors))

    # -- misc --------------------------------------------------------------
    def gradient_mask(self, *args):
        """Boolean mask over ``params`` selecting named columns."""
        mask = torch.zeros(len(self.param_names), dtype=torch.bool)
        for a in args:
            mask[self.param_names.index(a)] = True
        return mask.to(self.device).expand(self.params.shape)

    def __getitem__(self, item):
        if isinstance(item, int):
            item = slice(item, item + 1)
        return self._with_params(self.params[item])

    @classmethod
    def cat(cls, cameras: Sequence['CameraIntrinsics']):
        """Concatenate intrinsics batches (the first one's attributes)."""
        return cameras[0]._with_params(
            torch.cat([c.params for c in cameras], dim=0))

    def allclose(self, other, rtol=1e-5, atol=1e-8):
        return (type(self) is type(other) and
                self.params.shape == other.params.shape and
                (self.width, self.height, self.near, self.far) ==
                (other.width, other.height, other.near, other.far) and
                bool(torch.allclose(self.params, other.params,
                                    rtol=rtol, atol=atol)))

    def __repr__(self):
        return (f"{type(self).__name__} of {len(self)} cameras of "
                f"{self.width}x{self.height}.\n{self.params}")
