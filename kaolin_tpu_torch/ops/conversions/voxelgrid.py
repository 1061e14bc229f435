"""Voxelgrid -> mesh conversions.

Port of ``kaolin_tpu/ops/conversions/voxelgrid.py``.

* :func:`voxelgrids_to_cubic_meshes`: the boundary-face ("Cubify")
  construction, on the grids' device; its vertices are deduplicated through
  one int64 key per vertex (``torch.unique``), in ``np.unique(axis=0)``'s
  order.
* :func:`voxelgrids_to_trianglemeshes`: marching cubes (``_mcube.py``) with
  the reference CUDA op's vertex and face order.  The JAX package counts
  each grid's vertices and faces on the host and pads its outputs to
  powers of two; here the counts are taken on the device and the outputs
  have exactly those sizes (the JAX outputs' ``[:nv]``, ``[:nf]``).
* :func:`voxelgrids_to_trianglemeshes_mt`: marching tetrahedra over a
  6-tet decomposition of each cell (a denser triangulation).
"""

import numpy as np
import torch
import torch.nn.functional as F

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.ops.conversions._mcube import unbatched_marching_cubes

__all__ = ['voxelgrids_to_cubic_meshes', 'voxelgrids_to_trianglemeshes',
           'voxelgrids_to_trianglemeshes_mt', 'unbatched_marching_cubes']

_VERTS_TEMPLATE = np.array([
    [0, 0, 0], [0, 0, 1], [0, 1, 0], [0, 1, 1],
    [1, 0, 0], [1, 0, 1], [1, 1, 0], [1, 1, 1]], dtype=np.float32)
_FACES_TEMPLATE = np.array([[0, 2, 1, 3], [0, 1, 4, 5], [0, 4, 2, 6]])
_QUAD_FACE = np.array([[0, 1, 3, 2]])

# 6-tetrahedra decomposition of the unit cube (all sharing diagonal 0-7)
_CUBE_TETS = np.array([
    [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
    [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]], dtype=np.int64)


def _faces_3x4x3():
    f = _VERTS_TEMPLATE[_FACES_TEMPLATE].copy()  # (3, 4, 3)
    for i in range(3):
        f[i, :, (i - 1) % 3] -= 1
        f[i, :, (i + 1) % 3] -= 1
    return f


def _padded(voxelgrids, device):
    grids = torch.as_tensor(voxelgrids, device=device).to(torch.float32)
    return grids, F.pad(grids, (1, 1) * 3)


def voxelgrids_to_cubic_meshes(voxelgrids, is_trimesh=True, device=None):
    """Convert binary voxelgrids to cuboid surface meshes ("Cubify").

    Args:
        voxelgrids: ``(B, X, Y, Z)`` binary occupancy.
        is_trimesh: triangles (True) or quads.
        device: where the meshes go (default: the device of a tensor
            ``voxelgrids``, else the card).

    Returns:
        (list of verts (V, 3) float32, list of faces (F, 3|4) int64).
    """
    device = entry_device(device, voxelgrids)
    _, padded = _padded(voxelgrids, device)
    faces3 = torch.as_tensor(_faces_3x4x3(), device=device)
    quad = torch.as_tensor(_QUAD_FACE, device=device)
    verts_batch, faces_batch = [], []
    for g in padded:
        quads, invert = [], []
        # the boundary between cells i - 1 and i along each axis: +1 = a
        # face looking down the axis, -1 = up
        for axis in range(3):
            d = torch.diff(g, dim=axis)
            idx = torch.nonzero(d)
            quads.append(faces3[axis][None] + idx[:, None, :].to(
                torch.float32))
            invert.append(d[tuple(idx.t())] < 0)
        quads = torch.cat(quads)                      # (N, 4, 3)
        invert = torch.cat(invert)
        N = quads.shape[0]
        if N == 0:
            verts_batch.append(torch.zeros((0, 3), device=device))
            faces_batch.append(torch.zeros(
                (0, 3 if is_trimesh else 4), dtype=torch.int64,
                device=device))
            continue
        verts = quads.reshape(-1, 3)
        faces = (quad[None] + (torch.arange(N, device=device)[:, None]
                               * 4)[:, :, None]).reshape(-1, 4)
        faces = torch.where(invert[:, None], faces.flip(1), faces)
        if is_trimesh:
            faces = torch.cat([faces[:, [0, 3, 1]], faces[:, [2, 1, 3]]])
        # vertex coords are integers in [-1, dim]: one key per vertex
        c = verts.long() + 1
        side = int(c.max()) + 1
        key, inv = torch.unique((c[:, 0] * side + c[:, 1]) * side + c[:, 2],
                                return_inverse=True)
        uverts = torch.stack([key // (side * side), key // side % side,
                              key % side], dim=-1).to(torch.float32) - 1.
        verts_batch.append(uverts)
        faces_batch.append(inv[faces])
    return verts_batch, faces_batch


def voxelgrids_to_trianglemeshes(voxelgrids, iso_value=0.5, device=None):
    """Extract iso-surface triangle meshes by marching cubes, in the
    reference CUDA op's vertex and face order.  Vertex coordinates live in
    the padded grid's frame (voxel (0, 0, 0)'s centre at (1, 1, 1)).

    Args:
        voxelgrids: ``(B, X, Y, Z)`` occupancy / density values.
        iso_value: iso level in [0, 1].
        device: where the meshes go (default: the device of a tensor
            ``voxelgrids``, else the card).

    Returns:
        (list of verts (V, 3) float32 (differentiable with respect to a
        float ``voxelgrids``), list of faces (F, 3) int32).
    """
    device = entry_device(device, voxelgrids)
    grids, padded = _padded(voxelgrids, device)
    verts_list, faces_list = [], []
    for grid, g in zip(grids, padded):
        if not bool((grid != 0).any()):
            verts_list.append(torch.zeros((0, 3), device=device))
            faces_list.append(torch.zeros((0, 3), dtype=torch.int32,
                                          device=device))
            continue
        verts, faces, _, _ = unbatched_marching_cubes(g, iso_value)
        verts_list.append(verts)
        faces_list.append(faces)
    return verts_list, faces_list


def voxelgrids_to_trianglemeshes_mt(voxelgrids, iso_value=0.5, device=None):
    """Iso-surface extraction by marching tetrahedra over 6-tet cells: the
    surface of :func:`voxelgrids_to_trianglemeshes` with a denser
    triangulation (vertices also on cell diagonals), in the same frame.
    The active tets are found on the host, as the tetmesh conversion's
    topology is."""
    from kaolin_tpu_torch.ops.conversions.tetmesh import (
        _unbatched_marching_tetrahedra)
    device = entry_device(device, voxelgrids)
    _, padded = _padded(voxelgrids, device)
    X, Y, Z = padded.shape[1:]
    coords = np.stack(np.meshgrid(np.arange(X), np.arange(Y), np.arange(Z),
                                  indexing='ij'), axis=-1).reshape(-1, 3)
    cells = np.stack(np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                                 np.arange(Z - 1), indexing='ij'),
                     axis=-1).reshape(-1, 3)

    def vid(pts):
        return (pts[..., 0] * Y + pts[..., 1]) * Z + pts[..., 2]

    cell_corners = vid(cells[:, None, :] + _VERTS_TEMPLATE.astype(
        np.int64)[None])                                   # (C, 8)
    tets = cell_corners[:, _CUBE_TETS.reshape(-1)].reshape(-1, 4)
    coords_t = torch.as_tensor(coords.astype(np.float32), device=device)
    verts_list, faces_list = [], []
    for g in padded:
        values = g.reshape(-1)
        occ = values - iso_value             # sdf-like: > 0 inside
        occ_np = occ.detach().cpu().numpy()
        if not (occ_np > 0).any():
            verts_list.append(torch.zeros((0, 3), device=device))
            faces_list.append(torch.zeros((0, 3), dtype=torch.int32,
                                          device=device))
            continue
        n_in = (occ_np[tets] > 0).sum(1)     # tets touching the surface
        active = (n_in > 0) & (n_in < 4)
        verts, faces = _unbatched_marching_tetrahedra(
            coords_t, tets[active], occ, False)
        verts_list.append(verts)
        faces_list.append(faces.to(torch.int32))
    return verts_list, faces_list
