"""Marching tetrahedra (DMTet iso-surface extraction).

Port of ``kaolin_tpu/ops/conversions/tetmesh.py``.  The topology (valid
tets, edge dedup, table lookups) is host numpy, as in the JAX package: its
output shapes depend on the data.  The vertex interpolation stays in torch,
differentiable with respect to ``vertices`` and ``sdf``, and every result
goes back to the device of the inputs.
"""

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['marching_tetrahedra']

TRIANGLE_TABLE = np.array([
    [-1, -1, -1, -1, -1, -1],
    [1, 0, 2, -1, -1, -1],
    [4, 0, 3, -1, -1, -1],
    [1, 4, 2, 1, 3, 4],
    [3, 1, 5, -1, -1, -1],
    [2, 3, 0, 2, 5, 3],
    [1, 4, 0, 1, 5, 4],
    [4, 2, 5, -1, -1, -1],
    [4, 5, 2, -1, -1, -1],
    [4, 1, 0, 4, 5, 1],
    [3, 2, 0, 3, 5, 2],
    [1, 3, 5, -1, -1, -1],
    [4, 1, 2, 4, 3, 1],
    [3, 0, 4, -1, -1, -1],
    [2, 0, 1, -1, -1, -1],
    [-1, -1, -1, -1, -1, -1]], dtype=np.int64)

NUM_TRIANGLES_TABLE = np.array(
    [0, 1, 1, 2, 1, 2, 2, 1, 1, 2, 2, 1, 2, 1, 1, 0], dtype=np.int64)
BASE_TET_EDGES = np.array([0, 1, 0, 2, 0, 3, 1, 2, 1, 3, 2, 3])


def _unbatched_marching_tetrahedra(vertices, tets_np, sdf, return_tet_idx):
    dev = vertices.device
    sdf_np = sdf.detach().cpu().numpy()

    occ_n = sdf_np > 0
    occ_fx4 = occ_n[tets_np.reshape(-1)].reshape(-1, 4)
    occ_sum = occ_fx4.sum(-1)
    valid_tets = (occ_sum > 0) & (occ_sum < 4)

    all_edges = tets_np[valid_tets][:, BASE_TET_EDGES].reshape(-1, 2)
    all_edges = np.sort(all_edges, axis=-1)
    unique_edges, idx_map = np.unique(all_edges, axis=0,
                                      return_inverse=True)
    idx_map = idx_map.reshape(-1)
    mask_edges = occ_n[unique_edges.reshape(-1)].reshape(-1, 2).sum(-1) == 1
    mapping = np.full((unique_edges.shape[0],), -1, dtype=np.int64)
    mapping[mask_edges] = np.arange(int(mask_edges.sum()))
    idx_map = mapping[idx_map]
    interp_v = torch.as_tensor(unique_edges[mask_edges].reshape(-1),
                               device=dev)

    # differentiable vertex interpolation:
    # v = (v0 * (-s1) + v1 * s0) / (s0 - s1)  via the flip trick
    e2i = vertices[interp_v].reshape(-1, 2, 3)
    e2i_sdf = sdf[interp_v].reshape(-1, 2, 1)
    e2i_sdf = e2i_sdf * torch.tensor([1., -1.], dtype=sdf.dtype,
                                     device=dev)[None, :, None]
    denominator = e2i_sdf.sum(1, keepdim=True)
    weights = torch.flip(e2i_sdf, dims=[1]) / denominator
    verts = (e2i * weights).sum(1)

    idx_map6 = idx_map.reshape(-1, 6)
    tetindex = (occ_fx4[valid_tets] * 2 ** np.arange(4)[None]).sum(-1)
    num_triangles = NUM_TRIANGLES_TABLE[tetindex]
    one = np.take_along_axis(
        idx_map6[num_triangles == 1], TRIANGLE_TABLE[
            tetindex[num_triangles == 1]][:, :3], axis=1).reshape(-1, 3)
    two = np.take_along_axis(
        idx_map6[num_triangles == 2], TRIANGLE_TABLE[
            tetindex[num_triangles == 2]][:, :6], axis=1).reshape(-1, 3)
    faces = torch.as_tensor(np.concatenate([one, two], axis=0), device=dev)

    if return_tet_idx:
        tet_idx = np.arange(tets_np.shape[0])[valid_tets]
        tet_idx = np.concatenate([
            tet_idx[num_triangles == 1],
            np.repeat(tet_idx[num_triangles == 2], 2)])
        return verts, faces, torch.as_tensor(tet_idx, device=dev)
    return verts, faces


def marching_tetrahedra(vertices, tets, sdf, return_tet_idx=False,
                        device=None):
    """Convert (batched) tetrahedral sdf grids to triangle meshes.

    Args:
        vertices: ``(B, V, 3)`` tensor or array.
        tets: ``(T, 4)`` int (shared topology; read on the host).
        sdf: ``(B, V)`` signed distance values.
        return_tet_idx: also return the tet index of each face.
        device: where the results go (default: the device of the tensor
            inputs, else the card).

    Returns:
        list of per-batch verts, list of faces[, list of tet_idx].
    """
    device = entry_device(device, vertices, sdf)
    vertices = torch.as_tensor(vertices, device=device)
    sdf = torch.as_tensor(sdf, device=device)
    tets_np = np.asarray(torch.as_tensor(tets).cpu())
    out = [_unbatched_marching_tetrahedra(vertices[b], tets_np, sdf[b],
                                          return_tet_idx)
           for b in range(vertices.shape[0])]
    verts = [o[0] for o in out]
    faces = [o[1] for o in out]
    if return_tet_idx:
        return verts, faces, [o[2] for o in out]
    return verts, faces
