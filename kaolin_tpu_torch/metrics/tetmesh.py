"""Tetrahedral mesh losses: volume, EquiVolume, AMIPS (DefTet/DMTet).

Port of ``kaolin_tpu/metrics/tetmesh.py``.
"""

import torch

from kaolin_tpu_torch.ops.mesh.tetmesh import _validate_tet_vertices

__all__ = ['tetrahedron_volume', 'equivolume', 'amips']


def tetrahedron_volume(tet_vertices):
    """Signed volume of each tetrahedron.

    Args:
        tet_vertices: ``(B, T, 4, 3)``.

    Returns:
        ``(B, T)`` volumes.
    """
    _validate_tet_vertices(tet_vertices)
    A, B, C, D = tet_vertices.unbind(dim=2)
    return torch.sum((A - D) * torch.linalg.cross(B - D, C - D, dim=-1),
                     dim=2) / 6.


def equivolume(tet_vertices, tetrahedrons_mean=None, pow=4):
    """EquiVolume loss (Gao et al., DefTet NeurIPS 2020).

    Returns:
        ``(B, 1)`` loss.
    """
    _validate_tet_vertices(tet_vertices)
    volumes = tetrahedron_volume(tet_vertices)
    if tetrahedrons_mean is None:
        tetrahedrons_mean = torch.mean(volumes, dim=-1)
    tetrahedrons_mean = torch.as_tensor(
        tetrahedrons_mean, dtype=volumes.dtype,
        device=volumes.device).reshape(1, -1)
    return torch.mean(torch.abs(volumes - tetrahedrons_mean) ** pow,
                      dim=-1, keepdim=True)


def amips(tet_vertices, inverse_offset_matrix):
    """AMIPS energy (Fu et al. SIGGRAPH 2015), over tets with positive
    Jacobian determinant.

    Args:
        tet_vertices: ``(B, T, 4, 3)``.
        inverse_offset_matrix: ``(B, T, 3, 3)`` from
            :func:`kaolin_tpu_torch.ops.mesh.inverse_vertices_offset` of the
            rest pose.

    Returns:
        ``(B, 1)`` energy.
    """
    _validate_tet_vertices(tet_vertices)
    offset = tet_vertices[:, :, 1:] - tet_vertices[:, :, 0:1]
    jacobian = torch.matmul(offset, inverse_offset_matrix)
    j_det = torch.linalg.det(jacobian)
    jj = torch.matmul(jacobian, jacobian.transpose(-2, -1))
    trace = jj.diagonal(dim1=-2, dim2=-1).sum(-1)
    denominator = (j_det ** 2 + 1e-10) ** (1. / 3.)
    return torch.mean((trace / denominator) * (j_det >= 0),
                      dim=1, keepdim=True)
