"""Device-side SPC octree construction (mesh -> octree on the card).

Port of ``kaolin_tpu/ops/spc/device.py``.  The JAX package pads every
intermediate to a static capacity for ``jit``; torch runs eagerly, so the
levels here carry only their live rows.  What the capacity means is kept:
``cap`` bounds the rows that survive each compaction (the first ``cap`` in
order, the rest dropped silently, as ``_compact`` does in JAX), and the
public outputs are padded to it, so both packages return the same arrays.

A morton code is one int64 key (45 bits through level 15); it sorts as the
JAX package's ``(hi, lo)`` int32 pair does.  The sort by (morton, triangle)
is two stable sorts, because the two keys do not fit one int64.

The SAT is float32, as in the JAX package, written as explicit elementwise
products and sums (no ``sum`` over 3-vectors, no ``einsum``), so the CPU and
the card round every operation the same way; the barycentric coordinates
are evaluated in float64.
"""

import torch

__all__ = ['morton_i32', 'morton2_i32', 'morton_i64',
           'points_to_octree_device', 'pack_octree_device',
           'mesh_to_spc_device']

_OFFS = torch.tensor([[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)],
                     dtype=torch.int32)
_BIG = 1 << 62          # sorts after every valid key
_SAT_BLOCK = 1 << 23    # proposals SAT-tested at once (bounds peak memory)


def _spread3(x):
    """Interleave the low 21 bits of x (int64) with two zero bits."""
    x = x & 0x1fffff
    x = (x | (x << 32)) & 0x1f00000000ffff
    x = (x | (x << 16)) & 0x1f0000ff0000ff
    x = (x | (x << 8)) & 0x100f00f00f00f00f
    x = (x | (x << 4)) & 0x10c30c30c30c30c3
    x = (x | (x << 2)) & 0x1249249249249249
    return x


def morton_i64(points):
    """(..., 3) int coords (< 2^21) -> int64 morton codes."""
    p = points.to(torch.int64)
    return ((_spread3(p[..., 0]) << 2) | (_spread3(p[..., 1]) << 1)
            | _spread3(p[..., 2]))


def morton_i32(points):
    """int32 morton codes, valid through level 10."""
    return morton_i64(points).to(torch.int32)


def morton2_i32(points):
    """The JAX package's two-word code: int32 ``(hi, lo)`` = bits
    [30, 45) and [0, 30) of the 45-bit code."""
    m = morton_i64(points)
    return (m >> 30).to(torch.int32), (m & ((1 << 30) - 1)).to(torch.int32)


def _compact(keep, arrays, cap):
    """Order-preserving compaction of the rows where ``keep`` is True.

    Returns (the first ``min(total, cap)`` kept rows of each array, total):
    rows past ``cap`` are dropped silently, as in the JAX package; callers
    that must not lose rows compare ``total`` with ``cap``.
    """
    src = torch.nonzero(keep).squeeze(1)
    total = src.shape[0]
    src = src[:cap]
    return [a[src] for a in arrays], total


def _pad(x, n, fill=0):
    """Pad dim 0 of x to n rows with ``fill``."""
    out = x.new_full((n,) + tuple(x.shape[1:]), fill)
    out[:x.shape[0]] = x
    return out


def _level_bytes(morton, cap):
    """One bottom-up level: occupancy bytes of sorted unique child codes and
    the parent codes.  Returns (bytes (cap,) uint8 front-aligned, parents,
    parent count)."""
    parent = morton >> 3
    first = torch.ones_like(parent, dtype=torch.bool)
    first[1:] = parent[1:] != parent[:-1]
    pidx = torch.cumsum(first.to(torch.int64), 0) - 1
    bits = (1 << (morton & 7)).to(torch.int32)
    byte = torch.zeros(cap, dtype=torch.int32, device=morton.device)
    byte.index_add_(0, pidx.clamp(max=cap - 1), bits)
    (parents,), n = _compact(first, (parent,), cap)
    return byte.to(torch.uint8), parents, n


def points_to_octree_device(points, valid, level, cap=None):
    """Octree from quantized points on their device.

    Args:
        points: (N, 3) int coords in [0, 2^level); duplicates allowed.
        valid: (N,) bool mask of real entries.
        level: octree depth (<= 15).
        cap: per-level capacity (default N).

    Returns:
        (octree_padded (level * cap,) uint8 — per level a block of ``cap``
        bytes, payload first, root level first; level_counts (level,) int32
        bytes per level; total_bytes int; leaf_morton (cap,) int64 sorted
        unique codes, 0-padded; leaf_count int).
    """
    assert level <= 15, 'SPC supports level <= 15 (spc_math.h:37)'
    if cap is None:
        cap = points.shape[0]
    key = torch.where(valid, morton_i64(points), _BIG)
    key = torch.sort(key).values
    first = key < _BIG
    first[1:] &= key[1:] != key[:-1]
    (leaf,), n_leaf = _compact(first, (key,), cap)
    n_leaf = min(n_leaf, cap)
    blocks, counts = [], []
    cur = leaf
    for _ in range(level):                    # deepest level first
        byte, cur, n = _level_bytes(cur, cap)
        blocks.append(byte)
        counts.append(n)
    counts = torch.tensor(counts[::-1], dtype=torch.int32)
    octree = (torch.cat(blocks[::-1]) if blocks else
              torch.zeros(0, dtype=torch.uint8, device=points.device))
    return (octree, counts, int(counts.sum()), _pad(leaf, cap), n_leaf)


def pack_octree_device(octree_padded, level_counts, cap, out_cap=None):
    """Compact the per-level blocks of :func:`points_to_octree_device` into
    one contiguous prefix of an ``out_cap`` buffer (default: the padded
    size).  Returns (octree (out_cap,) uint8, total_bytes int)."""
    levels = octree_padded.shape[0] // cap
    if out_cap is None:
        out_cap = octree_padded.shape[0]
    j = torch.arange(cap, device=octree_padded.device)
    counts = torch.as_tensor(level_counts).to(octree_padded.device)
    keep = (j[None, :] < counts[:levels, None]).reshape(-1)
    (packed,), total = _compact(keep, (octree_padded,), out_cap)
    return _pad(packed, out_cap), total


def _dot3(a, b):
    """Row-wise dot product of (..., 3) vectors, summed x, y, z in order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _abs_sum3(a):
    a = a.abs()
    return a[..., 0] + a[..., 1] + a[..., 2]


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _voxel_centers(vox, r):
    return vox.to(torch.float32) * (2.0 * r) + (r - 1.0)


def _tri_aabb_sat(tris, vox, r):
    """Triangle vs voxel separating-axis test (13 axes), float32.

    tris (N, 3, 3), vox (N, 3) int coords, ``r`` the voxel half side
    ``1 / 2**level``.  Parity: ``mesh_to_spc_cuda.cu:96-159``.
    """
    v = tris - _voxel_centers(vox, r)[:, None, :]           # (N, 3, 3)
    e = torch.stack([v[:, 1] - v[:, 0], v[:, 2] - v[:, 1],
                     v[:, 0] - v[:, 2]], dim=1)
    mn = v.amin(dim=1)                                       # (N, 3)
    mx = v.amax(dim=1)
    ok = ~((mn > r) | (mx < -r)).any(dim=1)
    n = _cross(e[:, 0], e[:, 1])
    ok &= _dot3(n, v[:, 0]).abs() <= _abs_sum3(n) * r
    for i in range(3):
        ex, ey, ez = e[:, i, 0], e[:, i, 1], e[:, i, 2]
        vx, vy, vz = v[..., 0], v[..., 1], v[..., 2]        # (N, 3) per vertex
        # e x (unit axis a): (0, ez, -ey), (-ez, 0, ex), (ey, -ex, 0)
        for ca, cb, va, vb in ((ez, -ey, vy, vz), (-ez, ex, vx, vz),
                               (ey, -ex, vx, vy)):
            p = ca[:, None] * va + cb[:, None] * vb          # (N, 3)
            rad = (ca.abs() + cb.abs()) * r
            ok &= ~((p.amin(dim=1) > rad) | (p.amax(dim=1) < -rad))
    return ok


def _voxel_center_bary(tris, vox, level):
    """Barycentric (u, w) of voxel centres on their triangles
    (``mesh_to_spc_cuda.cu:252-305``), evaluated in float64 and returned in
    float32: in float32 the formula cancels to ~1e-4 for a level-8 voxel of
    a 10k-face sphere, against ~1e-8 in float64 (once per voxel: cheap)."""
    r = 1.0 / (1 << level)
    tris = tris.to(torch.float64)
    center = vox.to(torch.float64) * (2.0 * r) + (r - 1.0)
    v0 = tris[:, 1] - tris[:, 0]
    v1 = tris[:, 2] - tris[:, 0]
    v2 = center - tris[:, 0]
    d00, d01, d11 = _dot3(v0, v0), _dot3(v0, v1), _dot3(v1, v1)
    d20, d21 = _dot3(v2, v0), _dot3(v2, v1)
    denom = d00 * d11 - d01 * d01
    denom = torch.where(denom.abs() < 1e-20, 1e-20, denom)
    u = (d11 * d20 - d01 * d21) / denom
    w = (d00 * d21 - d01 * d20) / denom
    return torch.stack([u, w], dim=-1).to(torch.float32)


def mesh_to_spc_device(face_vertices, level, cap=2 ** 21):
    """Conservative mesh voxelization on the faces' device.

    Coarse to fine: every (voxel, triangle) proposal is split into its 8
    children, SAT-tested, and the survivors compacted (at most ``cap`` per
    level).  At the leaf level voxels are deduplicated keeping the lowest
    triangle id (the reference's lexsort (morton, tri) + first occurrence).
    Parity: ``mesh_to_spc_cuda.cu:309-456``.

    Args:
        face_vertices: (T, 3, 3) float triangles in [-1, 1].
        level: target level (<= 15).
        cap: max surviving proposals per level, and max voxels.

    Returns:
        (octree_padded, level_counts, total_bytes — see
        :func:`points_to_octree_device`; vox (cap, 3) int32 leaf voxels in
        morton order; tri (cap,) int32 first intersecting triangle; bary
        (cap, 2) float32; count int — the number of leaf voxels).
    """
    assert level <= 15, 'SPC supports level <= 15 (spc_math.h:37)'
    T = face_vertices.shape[0]
    if T > cap:
        raise ValueError(
            f'mesh_to_spc_device: cap={cap} must be >= the face count '
            f'({T}) — every face is a level-0 proposal')
    device = face_vertices.device
    fv9 = face_vertices.to(torch.float32).reshape(T, 9)
    offs = _OFFS.to(device)
    vox = torch.zeros((T, 3), dtype=torch.int32, device=device)
    tri = torch.arange(T, dtype=torch.int64, device=device)
    for l in range(1, level + 1):
        r = 1.0 / (1 << l)
        vox8 = (vox[:, None, :] * 2 + offs).reshape(-1, 3)
        tri8 = tri.repeat_interleave(8)
        keep = torch.cat([
            _tri_aabb_sat(fv9[tri8[s:s + _SAT_BLOCK]].reshape(-1, 3, 3),
                          vox8[s:s + _SAT_BLOCK], r)
            for s in range(0, max(1, vox8.shape[0]), _SAT_BLOCK)])
        (vox, tri), _ = _compact(keep, (vox8, tri8), cap)

    # dedup by (morton, tri): two stable sorts, minor key first
    order = torch.sort(tri, stable=True).indices
    vox, tri = vox[order], tri[order]
    m = morton_i64(vox)
    order = torch.sort(m, stable=True).indices
    vox, tri, m = vox[order], tri[order], m[order]
    first = torch.ones_like(m, dtype=torch.bool)
    first[1:] = m[1:] != m[:-1]
    (vox, tri), count = _compact(first, (vox, tri), cap)
    count = min(count, cap)

    valid = torch.ones(count, dtype=torch.bool, device=device)
    octree, counts, nbytes, _, _ = points_to_octree_device(
        vox, valid, level, cap=cap)
    bary = _voxel_center_bary(fv9[tri].reshape(-1, 3, 3), vox, level)
    return (octree, counts, nbytes, _pad(vox, cap), _pad(tri.int(), cap),
            _pad(bary, cap), count)
