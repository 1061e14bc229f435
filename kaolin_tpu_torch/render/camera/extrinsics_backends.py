"""Parameter backends of :class:`CameraExtrinsics`.

Port of ``kaolin_tpu/render/camera/extrinsics_backends.py``: a registry of
param <-> view-matrix conversions.

* ``matrix_se3``: params = the flattened 4x4 view matrix (16,); identity
  mapping, unconstrained under optimization.
* ``matrix_6dof_rotation``: params = (r1 r2 r3 u1 u2 u3 tx ty tz) (9,); the
  rotation is recovered with one Gram-Schmidt step (Zhou et al. 2019), so
  gradient steps stay in SE(3).
"""

from enum import IntEnum

import torch

__all__ = ['ExtrinsicsParamsDefEnum', 'ExtrinsicsRep', 'register_backend',
           'get_backend', 'available_backends', 'MatrixSE3Rep',
           'Matrix6DofRotationRep']

_REGISTRY = {}


class ExtrinsicsParamsDefEnum(IntEnum):
    """Semantic blocks of the extrinsics parameters (R then t)."""
    R = 0
    t = 1


class ExtrinsicsRep:
    """Base marker class of extrinsics parameter backends."""


def register_backend(name):
    """Class decorator: register a backend under ``name``."""
    def deco(cls):
        _REGISTRY[name] = cls
        cls.name = name
        return cls
    return deco


def get_backend(name):
    if name not in _REGISTRY:
        raise ValueError(
            f"Unknown extrinsics backend {name!r}; available: "
            f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def available_backends():
    return sorted(_REGISTRY)


def _normalize(v):
    """Rows of ``v`` over their norm, floored at 1e-12."""
    return v / torch.clamp(torch.linalg.norm(v, dim=-1, keepdim=True),
                           min=1e-12)


def _bottom_row(top):
    """The (C, 1, 4) row [0, 0, 0, 1] under a (C, 3, 4) matrix top."""
    return torch.tensor([[0., 0., 0., 1.]], dtype=top.dtype,
                        device=top.device).expand(top.shape[0], 1, 4)


@register_backend('matrix_se3')
class MatrixSE3Rep(ExtrinsicsRep):
    """The flattened 4x4 view matrix; identity representation."""
    num_params = 16
    # param indices of the R and t components
    R_idx = [0, 1, 2, 4, 5, 6, 8, 9, 10]
    t_idx = [3, 7, 11]

    @staticmethod
    def to_mat(params):
        return params.reshape(-1, 4, 4)

    @staticmethod
    def from_mat(mat):
        return mat.reshape(-1, 16)


@register_backend('matrix_6dof_rotation')
class Matrix6DofRotationRep(ExtrinsicsRep):
    """6-DoF rotation (the first two view-matrix rows) + 3-DoF
    translation."""
    num_params = 9
    R_idx = list(range(0, 6))
    t_idx = list(range(6, 9))

    @staticmethod
    def to_mat(params):
        b1 = _normalize(params[:, 0:3])
        a2 = params[:, 3:6]
        b2 = _normalize(a2 - torch.sum(b1 * a2, dim=1, keepdim=True) * b1)
        b3 = torch.linalg.cross(b1, b2, dim=1)
        rotation = torch.stack([b1, b2, b3], dim=1)          # (C, 3, 3) rows
        top = torch.cat([rotation, params[:, 6:9, None]], dim=2)
        return torch.cat([top, _bottom_row(top)], dim=1)

    @staticmethod
    def from_mat(mat):
        C = mat.shape[0]
        return torch.cat([mat[:, :2, :3].reshape(C, 6), mat[:, :3, 3]],
                         dim=1)
