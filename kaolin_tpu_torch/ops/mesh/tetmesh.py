"""Tetrahedral mesh ops (DMTet utilities).

Port of ``kaolin_tpu/ops/mesh/tetmesh.py``.  Topology (edge dedup) is host
numpy, as in the JAX package; vertex and feature math stays in torch, on
the device of the vertices.
"""

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['inverse_vertices_offset', 'subdivide_tetmesh']

# edges of a tetrahedron (a,b), (a,c), (a,d), (b,c), (b,d), (c,d)
_BASE_TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3])


def _validate_tet_vertices(tet_vertices):
    if tet_vertices.ndim != 4 or tet_vertices.shape[2] != 4 \
            or tet_vertices.shape[3] != 3:
        raise ValueError(
            f"tet_vertices must be (B, T, 4, 3), got "
            f"{tuple(tet_vertices.shape)}")


def inverse_vertices_offset(tet_vertices):
    """Inverse of the per-tet offset matrix ``[B-A; C-A; D-A]``.

    Args:
        tet_vertices: ``(B, T, 4, 3)``.

    Returns:
        ``(B, T, 3, 3)`` inverse offset matrices.
    """
    _validate_tet_vertices(tet_vertices)
    offset = tet_vertices[:, :, 1:] - tet_vertices[:, :, 0:1]
    return torch.linalg.inv(offset)


def subdivide_tetmesh(vertices, tetrahedrons, features=None, device=None):
    """8-way midpoint subdivision of a tet mesh with feature interpolation.

    Args:
        vertices: ``(B, V, 3)`` tensor or array.
        tetrahedrons: ``(T, 4)`` int (tensor or array; read on the host).
        features: optional ``(B, V, D)``.
        device: where the results go (default: the device of ``vertices``
            when it is a tensor, else the card).

    Returns:
        (new_vertices, new_tetrahedrons[, new_features]).
    """
    device = entry_device(device, vertices)
    vertices = torch.as_tensor(vertices, device=device)
    tets = np.asarray(torch.as_tensor(tetrahedrons).cpu())
    all_edges = np.sort(tets[:, _BASE_TET_EDGES].reshape(-1, 2), axis=-1)
    unique_edges, idx_map = np.unique(all_edges, axis=0, return_inverse=True)
    idx_map = idx_map.reshape(-1) + vertices.shape[1]

    pos_feature = (torch.cat([vertices, torch.as_tensor(
        features, device=device)], dim=-1) if features is not None
        else vertices)
    ends = torch.as_tensor(unique_edges.reshape(-1), device=device)
    mid = pos_feature[:, ends].reshape(
        pos_feature.shape[0], -1, 2, pos_feature.shape[-1]).mean(dim=2)
    new_pos_feature = torch.cat([pos_feature, mid], dim=1)
    new_pos = new_pos_feature[..., :3]
    new_features = new_pos_feature[..., 3:]

    idx_a, idx_b, idx_c, idx_d = tets.T
    idx_ab, idx_ac, idx_ad, idx_bc, idx_bd, idx_cd = idx_map.reshape(-1, 6).T
    new_tets = np.concatenate([
        np.stack([idx_a, idx_ab, idx_ac, idx_ad], axis=1),
        np.stack([idx_b, idx_bc, idx_ab, idx_bd], axis=1),
        np.stack([idx_c, idx_ac, idx_bc, idx_cd], axis=1),
        np.stack([idx_d, idx_ad, idx_cd, idx_bd], axis=1),
        np.stack([idx_ab, idx_ac, idx_ad, idx_bd], axis=1),
        np.stack([idx_ab, idx_ac, idx_bd, idx_bc], axis=1),
        np.stack([idx_cd, idx_ac, idx_bd, idx_ad], axis=1),
        np.stack([idx_cd, idx_ac, idx_bc, idx_bd], axis=1),
    ], axis=0)
    new_tets = torch.as_tensor(new_tets, device=device)
    if features is None:
        return new_pos, new_tets
    return new_pos, new_tets, new_features
