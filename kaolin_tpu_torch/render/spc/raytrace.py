"""SPC octree ray tracing (BFS) + pack primitives for volume rendering.

Port of ``kaolin_tpu/render/spc/raytrace.py``; parity
``kaolin/render/spc/raytrace.py`` and ``raytrace_cuda.cu``.

* :func:`unbatched_raytrace` is the level-synchronous breadth-first
  traversal in plain PyTorch: each level expands the live (ray, node)
  nuggets into their 8 children, slab-tests them, orders each node's
  children near-to-far by exact entry depth (a stable sort of 8 keys, ties
  by child slot) and compacts the survivors in order.  The JAX package's
  TPU layout tricks (an ``(8, cap)`` frontier, a 24-bit packed child
  permutation) are not needed; the nuggets are the same: ray-major,
  near-to-far, with the same per-level capacity and saturation rule.  It is
  the independent oracle of the coherent engine (``raster.py``).
* The pack ops turn nuggets into per-ray quantities.  Segmented scans are
  log-depth Hillis-Steele passes built from ``where`` and ``cat``, so
  autograd differentiates them in product-rule form (finite at zeros).
"""

from typing import NamedTuple

import torch

from kaolin_tpu_torch.ops.spc.uint8 import popcount_table

__all__ = [
    'RaytraceInfo',
    'unbatched_raytrace',
    'mark_pack_boundaries',
    'mark_first_hit',
    'diff',
    'sum_reduce',
    'cumsum',
    'cumprod',
    'exponential_integration',
]

_OFFS = torch.tensor([[(k >> 2) & 1, (k >> 1) & 1, k & 1] for k in range(8)],
                     dtype=torch.int32)


class RaytraceInfo(NamedTuple):
    """Aux outputs of :func:`unbatched_raytrace`."""
    count: int          # number of valid nuggets
    saturated: bool     # True if any level overflowed its capacity


def inverse_direction(direction):
    """1 / d with |d| < 1e-12 replaced by +-1e-12 (sign of d, + for 0)."""
    d = direction.to(torch.float32)
    return 1.0 / torch.where(d.abs() < 1e-12,
                             torch.where(d < 0, -1e-12, 1e-12), d)


def voxel_slab(q, side, o, inv):
    """Entry and exit depths of rays through the voxels of integer coords
    ``q`` (..., 3) whose side is ``side`` in [-1, 1] space: per axis
    ``t0 = (q * side - 1 - o) * inv``, ``t1 = t0 + side * inv``; entry =
    max over x, y, z (in that order) of the per-axis min, exit = min of
    the max.  ``o``/``inv`` broadcast against q."""
    lo = q.to(torch.float32) * side - 1.
    t0 = (lo - o) * inv
    t1 = t0 + side * inv
    tmin = torch.minimum(t0, t1)
    tmax = torch.maximum(t0, t1)
    t_near = torch.maximum(torch.maximum(tmin[..., 0], tmin[..., 1]),
                           tmin[..., 2])
    t_far = torch.minimum(torch.minimum(tmax[..., 0], tmax[..., 1]),
                          tmax[..., 2])
    return t_near, t_far


def _raytrace_bfs(octree, exsum, origin, direction, level, caps):
    """Level-synchronous BFS over one set of rays.

    ``caps[l]`` bounds the nuggets that survive pass l (nodes of level
    l + 1); survivors past it are dropped and flag saturation.

    Returns (ridx, pidx (n,) int64, t_near, t_far (n,) f32, saturated).
    """
    device = origin.device
    o = origin.to(torch.float32)
    inv = inverse_direction(direction)
    zero = torch.zeros((1, 3), dtype=torch.int32, device=device)
    root_near, root_far = voxel_slab(zero, 2., o, inv)
    alive = (root_far > root_near) & (root_far > 0.)
    if level == 0:
        alive &= root_near > 0.
    ridx = torch.nonzero(alive).squeeze(1)
    pidx = torch.zeros_like(ridx)
    q = torch.zeros((ridx.shape[0], 3), dtype=torch.int32, device=device)
    t_near, t_far = root_near[ridx], root_far[ridx]
    sat = False
    octree = octree.to(torch.int32)
    exsum = exsum.to(torch.int64)
    popc = popcount_table(device)
    offs = _OFFS.to(device)
    slots = torch.arange(8, dtype=torch.int32, device=device)
    for l in range(level):
        half = 1.0 / (1 << l)                   # side of the children
        bits = octree[pidx]
        has = ((bits[:, None] >> slots) & 1) == 1                  # (n, 8)
        qc = q[:, None, :] * 2 + offs                              # (n, 8, 3)
        tn, tf = voxel_slab(qc, half, o[ridx][:, None, :],
                            inv[ridx][:, None, :])
        ok = has & (tf > tn) & (tf > 0.)
        if l == level - 1:
            ok &= tn > 0.
        # each node's children near-to-far by entry depth, ties by slot
        perm = torch.sort(torch.where(ok, tn, torch.inf), dim=1,
                          stable=True).indices
        sel = torch.nonzero(ok.gather(1, perm).reshape(-1)).squeeze(1)
        sat = sat or sel.shape[0] > caps[l]
        sel = sel[:caps[l]]
        parent = sel // 8
        child = parent * 8 + perm.reshape(-1)[sel]               # flat (n*8)
        slot = child % 8
        below = bits[parent] & ((2 << slot) - 1)
        pidx = exsum[pidx[parent]] + popc[below]
        q = qc.reshape(-1, 3)[child]
        ridx = ridx[parent]
        t_near, t_far = tn.reshape(-1)[child], tf.reshape(-1)[child]
    return ridx, pidx, t_near, t_far, sat


def unbatched_raytrace(octree, point_hierarchy, pyramid, exsum, origin,
                       direction, level, return_depth=True, with_exit=False,
                       max_nuggets=None, trim=True, return_info=False,
                       chunk_rays=None, max_nuggets_coarse=None,
                       coarse_levels=0, max_hits_per_ray=None,
                       max_steps=None):
    """Trace rays against an SPC octree (BFS).

    Same arguments and results as the JAX package's ``unbatched_raytrace``:
    nuggets sorted by ray, near-to-far per ray.

    Args:
        octree: (num_bytes,) uint8.  exsum: (num_bytes + 1,) int32.
        point_hierarchy, pyramid: accepted for signature parity.
        origin, direction: (num_rays, 3) float.
        level: target level (<= 15).
        return_depth / with_exit: return entry depths (n, 1), or entry and
            exit depths (n, 2).
        max_nuggets: nugget capacity of every BFS level (default
            8 * num_rays, at least num_rays); overflow is dropped and
            reported through the saturation flag (a warning when
            ``trim``).
        trim: trim to the true count; otherwise pad to the capacity with
            -1 ids and 0 depths.
        return_info: also return a :class:`RaytraceInfo`.
        chunk_rays: trace in chunks of this many rays, each with its share
            of the capacity (default: none up to 128K rays, 64K above; 0 =
            none).
        max_nuggets_coarse, coarse_levels: a smaller capacity for the
            first ``coarse_levels`` levels.
        max_hits_per_ray, max_steps: deprecated, ignored.

    Returns:
        (ridx int32, pidx int32[, depths][, info]).
    """
    del point_hierarchy, pyramid, max_hits_per_ray, max_steps
    if level > 15:
        raise ValueError(
            f'unbatched_raytrace: level={level} > 15 (SPC int16 coord '
            'limit, reference KAOLIN_SPC_MAX_LEVELS)')
    num_rays = origin.shape[0]
    if max_nuggets is None:
        max_nuggets = num_rays * 8
    cap = max(int(max_nuggets), num_rays)
    if chunk_rays is None:
        chunk_rays = num_rays if num_rays <= (1 << 17) else (1 << 16)
    chunk_rays = int(chunk_rays) or num_rays
    if max_nuggets_coarse is not None and int(max_nuggets_coarse) > cap:
        raise ValueError(
            f'unbatched_raytrace: max_nuggets_coarse='
            f'{int(max_nuggets_coarse)} exceeds max_nuggets={cap}; the '
            'coarse band cannot be wider than the deep band')
    nchunks = max(1, -(-num_rays // chunk_rays))
    if nchunks == 1:
        chunk_rays = num_rays
        cap_chunk = cap
        cap_c = (max(int(max_nuggets_coarse), num_rays)
                 if max_nuggets_coarse else None)
    else:
        cap_chunk = max(-(-cap // nchunks), chunk_rays)
        cap_c = (max(-(-max(int(max_nuggets_coarse), num_rays) // nchunks),
                     chunk_rays) if max_nuggets_coarse else None)
    n_coarse = min(int(coarse_levels), level - 1) if cap_c else 0
    caps = [cap_c if l < n_coarse else cap_chunk for l in range(level)]

    exsum = torch.as_tensor(exsum)
    outs = []
    sat = False
    for start in range(0, num_rays, chunk_rays):
        r, p, tn, tf, s = _raytrace_bfs(
            octree, exsum, origin[start:start + chunk_rays],
            direction[start:start + chunk_rays], level, caps)
        outs.append((r + start, p, tn, tf))
        sat = sat or s
    ridx, pidx, t_in, t_out = (torch.cat(x) for x in zip(*outs))
    count = ridx.shape[0]
    ridx, pidx = ridx.to(torch.int32), pidx.to(torch.int32)
    depths = torch.stack([t_in, t_out], -1) if with_exit else t_in[:, None]
    if trim:
        if sat:
            import warnings
            warnings.warn(
                'unbatched_raytrace: nugget buffer saturated '
                f'(max_nuggets={cap}); intersections were dropped — '
                'raise max_nuggets', RuntimeWarning)
    else:
        total = cap_chunk * nchunks
        ridx = torch.cat([ridx, ridx.new_full((total - count,), -1)])
        pidx = torch.cat([pidx, pidx.new_full((total - count,), -1)])
        depths = torch.cat([depths, depths.new_zeros(
            (total - count, depths.shape[1]))])
    out = (ridx, pidx)
    if return_depth:
        out = out + (depths,)
    if return_info:
        out = out + (RaytraceInfo(count=count, saturated=sat),)
    return out


def mark_pack_boundaries(pack_ids):
    """True at the first element of each pack (of consecutive equal ids)."""
    first = torch.ones(1, dtype=torch.bool, device=pack_ids.device)
    return torch.cat([first, pack_ids[1:] != pack_ids[:-1]])


def mark_first_hit(ridx):
    """Deprecated alias of :func:`mark_pack_boundaries`."""
    return mark_pack_boundaries(ridx)


def diff(feats, boundaries):
    """Per-pack forward difference; the last element of each pack -> 0."""
    f = feats.reshape(feats.shape[0], -1)
    nxt = torch.cat([f[1:], torch.zeros_like(f[:1])])
    is_last = torch.cat([boundaries[1:].bool(),
                         torch.ones(1, dtype=torch.bool,
                                    device=boundaries.device)])
    return torch.where(is_last[:, None], 0., nxt - f).reshape(feats.shape)


def _segment_ids(boundaries):
    return torch.cumsum(boundaries.to(torch.int64), 0) - 1


def sum_reduce(feats, boundaries, num_packs=None):
    """Sum features within each pack -> (num_packs, ...)."""
    if num_packs is None:
        num_packs = int(boundaries.sum())
    out = feats.new_zeros((num_packs,) + tuple(feats.shape[1:]))
    return out.index_add(0, _segment_ids(boundaries), feats)


def _segmented_scan(feats, boundaries, exclusive, reverse, op):
    """Segmented inclusive/exclusive, forward/reverse scan along dim 0 in
    log2(n) Hillis-Steele passes; positions before the array start act as
    a pack boundary."""
    f = feats
    b = boundaries.bool()
    if reverse:
        f = f.flip(0)
        # pack starts of the reversed sequence = pack ends of the original
        b = torch.cat([b[1:], b.new_ones(1)]).flip(0)
    identity = 0. if op == 'sum' else 1.

    def col(m):
        return m.reshape((-1,) + (1,) * (f.dim() - 1))

    if exclusive:
        prev = torch.cat([torch.full_like(f[:1], identity), f[:-1]])
        f = torch.where(col(b), identity, prev)
    s = 1
    while s < f.shape[0]:
        pf = torch.cat([torch.full_like(f[:s], identity), f[:-s]])
        pb = torch.cat([b.new_ones(s), b[:-s]])
        f = torch.where(col(b), f, pf + f if op == 'sum' else pf * f)
        b = b | pb
        s *= 2
    return f.flip(0) if reverse else f


def cumsum(feats, boundaries, exclusive=False, reverse=False):
    """Segmented cumulative sum (tf.math.cumsum semantics per pack)."""
    return _segmented_scan(feats, boundaries, exclusive, reverse, 'sum')


def cumprod(feats, boundaries, exclusive=False, reverse=False):
    """Segmented cumulative product; autograd differentiates it in
    product-rule form (no division by the features)."""
    return _segmented_scan(feats, boundaries, exclusive, reverse, 'prod')


def exponential_integration(feats, tau, boundaries, exclusive=True,
                            num_packs=None):
    """Beer-Lambert transmittance integration across packs.

    Returns:
        (integrated feats (num_packs, feat_dim), transmittance
        (num_elems, 1)).
    """
    alpha = 1.0 - torch.exp(-tau)
    transmittance = torch.exp(-1.0 * cumsum(tau, boundaries,
                                            exclusive=exclusive))
    transmittance = transmittance * alpha
    feats_out = sum_reduce(transmittance * feats, boundaries,
                           num_packs=num_packs)
    return feats_out, transmittance
