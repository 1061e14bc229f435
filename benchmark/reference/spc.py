"""The SPC octree of a mesh and the trace of rays through its leaves, in
plain PyTorch.

- Voxelization (Takikawa et al. 2021; kaolin's ``mesh_to_spc``): a voxel
  of the level-``L`` grid over [-1, 1]^3 is in the octree where a triangle
  meets its closed box by the 13-axis separating-axis test (the box's 3
  axes, the triangle's normal, the 9 edge x axis products), in float64.
- The octree: per level the sorted unique morton codes (x in the high bit
  of each triple) grouped by parent; a parent's byte has bit ``c`` set for
  each child ``c = code & 7``; root first.  The point hierarchy lists the
  levels' points in that order, so a leaf's index is the number of points
  above its level plus its rank.
- The trace: a ray hits a voxel where the slab test gives
  ``t_far > t_near > 0`` (entry = the largest of the per-axis entries, exit
  the smallest exit; ``1 / d`` with |d| < 1e-12 taken as +-1e-12); a ray's
  hits in order of entry depth.
"""

import torch

__all__ = ['morton', 'voxelize', 'octree_bytes', 'trace']


def _spread3(v):
    out = torch.zeros_like(v)
    for i in range(21):
        out |= ((v >> i) & 1) << (3 * i)
    return out


def morton(vox):
    """(..., 3) integer coordinates -> (...) int64 morton codes."""
    v = vox.to(torch.int64)
    return (_spread3(v[..., 0]) << 2) | (_spread3(v[..., 1]) << 1) | _spread3(
        v[..., 2])


def _sat(tris, vox, level):
    """Triangle (N, 3, 3) vs closed voxel box (N, 3) separating-axis test."""
    r = 1.0 / (1 << level)
    center = vox.to(tris.dtype) * (2.0 * r) + r - 1.0
    v = tris - center[:, None, :]
    ok = torch.ones(tris.shape[0], dtype=torch.bool, device=tris.device)
    for a in range(3):
        ok &= ~((v[:, :, a].amin(1) > r) | (v[:, :, a].amax(1) < -r))
    e = torch.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 1], v[:, 0] - v[:, 2]],
                    dim=1)
    n = torch.linalg.cross(e[:, 0], e[:, 1], dim=-1)
    ok &= torch.abs(torch.sum(n * v[:, 0], dim=1)) <= n.abs().sum(1) * r
    for i in range(3):
        for a in range(3):
            axis = torch.zeros(3, dtype=tris.dtype, device=tris.device)
            axis[a] = 1.
            cross = torch.linalg.cross(e[:, i], axis.expand_as(e[:, i]),
                                       dim=-1)
            p = torch.einsum('nj,nkj->nk', cross, v)
            rad = cross.abs().sum(1) * r
            ok &= ~((p.amin(1) > rad) | (p.amax(1) < -rad))
    return ok


def voxelize(face_vertices, level, dtype=torch.float64, chunk=1 << 22):
    """The level-``level`` voxels (V, 3) int64 that the triangles
    ``face_vertices`` (F, 3, 3) meet, in morton order (computed in
    ``dtype``)."""
    fv = face_vertices.to(dtype)
    side = 2.0 / (1 << level)
    n_side = 1 << level
    lo = torch.floor((fv.amin(1).double() + 1.) / side).long() - 1
    hi = torch.floor((fv.amax(1).double() + 1.) / side).long() + 1
    lo, hi = lo.clamp(0, n_side - 1), hi.clamp(0, n_side - 1)
    ext = (hi - lo + 1).clamp(min=0)
    count = ext.prod(1)
    codes = []
    start = 0
    F = fv.shape[0]
    while start < F:
        csum = torch.cumsum(count[start:], 0)
        stop = start + max(1, int((csum <= chunk).sum()))
        n = count[start:stop]
        fid = start + torch.repeat_interleave(
            torch.arange(stop - start, device=fv.device), n)
        k = torch.arange(fid.shape[0], device=fv.device) - (
            torch.cumsum(n, 0) - n)[fid - start]
        ex = ext[fid]
        vox = lo[fid] + torch.stack(
            [k // (ex[:, 1] * ex[:, 2]), (k // ex[:, 2]) % ex[:, 1],
             k % ex[:, 2]], dim=1)
        keep = _sat(fv[fid], vox, level)
        codes.append(morton(vox[keep]))
        start = stop
    codes = torch.unique(torch.cat(codes))
    return _unmorton(codes)


def _unmorton(codes):
    out = []
    for shift in (2, 1, 0):
        v = torch.zeros_like(codes)
        for i in range(21):
            v |= ((codes >> (3 * i + shift)) & 1) << i
        out.append(v)
    return torch.stack(out, dim=1)


def octree_bytes(vox, level):
    """The octree (uint8, root first) of voxels ``vox`` at ``level``."""
    code = torch.unique(morton(vox))
    levels = []
    for _ in range(level):
        parents, inv = torch.unique_consecutive(code >> 3,
                                                return_inverse=True)
        byte = torch.zeros(parents.shape[0], dtype=torch.int64,
                           device=code.device).index_add_(
            0, inv, 1 << (code & 7))
        levels.append(byte.to(torch.uint8))
        code = parents
    return torch.cat(levels[::-1])


def trace(vox, level, origin, direction, knum, dtype=torch.float32,
          rays_per_chunk=64):
    """Hits of rays (R, 3) through voxels ``vox`` (V, 3) at ``level``:
    (count (R,) int64, t_near (R, knum) inf-padded, hit voxel ids
    (R, knum) int64 into ``vox``, -1-padded), each ray's hits in order of
    entry depth, computed in ``dtype``."""
    R = origin.shape[0]
    dev = origin.device
    side = 2.0 / (1 << level)
    lo = vox.to(dtype) * side - 1.
    o = origin.to(dtype)
    d = direction.to(dtype)
    tiny = torch.where(d < 0, -1e-12, 1e-12).to(dtype)
    inv = 1.0 / torch.where(d.abs() < 1e-12, tiny, d)
    count = torch.zeros(R, dtype=torch.int64, device=dev)
    t_out = torch.full((R, knum), float('inf'), dtype=torch.float32,
                       device=dev)
    id_out = torch.full((R, knum), -1, dtype=torch.int64, device=dev)
    for s in range(0, R, rays_per_chunk):
        sl = slice(s, s + rays_per_chunk)
        tn = tf = None
        for a in range(3):
            t0 = (lo[None, :, a] - o[sl, None, a]) * inv[sl, None, a]
            t1 = t0 + side * inv[sl, None, a]
            mn, mx = torch.minimum(t0, t1), torch.maximum(t0, t1)
            tn = mn if tn is None else torch.maximum(tn, mn)
            tf = mx if tf is None else torch.minimum(tf, mx)
        hit = (tf > tn) & (tf > 0.) & (tn > 0.)
        r, v = torch.nonzero(hit, as_tuple=True)
        t = tn[r, v].float()
        count[sl] = hit.sum(1)
        order = torch.argsort(t, stable=True)
        r, v, t = r[order], v[order], t[order]
        order = torch.argsort(r, stable=True)
        r, v, t = r[order], v[order], t[order]
        first = torch.zeros_like(r)
        if r.numel():
            starts = torch.ones_like(r, dtype=torch.bool)
            starts[1:] = r[1:] != r[:-1]
            idx = torch.arange(r.numel(), device=dev)
            first = idx - torch.cummax(torch.where(starts, idx, 0), 0)[0]
        keep = first < knum
        t_out[s + r[keep], first[keep]] = t[keep]
        id_out[s + r[keep], first[keep]] = v[keep]
    return count, t_out, id_out
