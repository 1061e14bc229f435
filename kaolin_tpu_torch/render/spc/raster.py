"""Coherent-ray SPC ray tracing by conservative beam culling.

Port of ``kaolin_tpu/render/spc/raster.py``: the same hit set and per-ray
near-to-far order as the BFS :func:`~kaolin_tpu_torch.render.spc.raytrace.
unbatched_raytrace`, for coherent ray sets (camera grids, beam bundles),
returned as a dense per-ray k-buffer (:class:`CoherentHits`).

Rays are grouped into blocks of ``rays_per_tile`` consecutive rays and
super-tiles of 64 blocks; each group is bounded by interval boxes on
origins and directions (a conservative beam, :func:`_beam_chunk_test`).
Two engines, with the JAX package's names:

* ``'mosaic'`` (the default for every device): voxels binned by their
  level-(L - cell_shift) ancestor cells (:func:`build_cell_table`).
  Super-tiles cull all cells, blocks refine their super-tile's list
  (:func:`_cull_candidates`), the non-empty blocks are sorted by candidate
  count into a list of fixed length, and kernel K3 (:mod:`._trace`) traces
  them in one launch, writing each block's rows straight to its place.  On
  CUDA tensors the culling's first stage is one launch of
  ``spc_cull_kernel`` (``csrc/spc_cull.cu``, counted in
  ``LAUNCHES['cull']``) and K3 the CUDA kernel; on CPU tensors each is its
  plain PyTorch version.  The segment caps of the JAX engine are kept for
  what they mean (a block's candidate cells are cut to its segment's cap,
  and the cut flags saturation); the TPU's per-segment launches, cell-row
  pre-gather and scatter-back are not needed.
* ``'xla'``: voxels binned by morton chunks of 64, traced in plain PyTorch
  (the JAX package's pure-XLA engine).  It runs only when asked for.

The JAX package's log-shift compaction network (``_compact_rows``) is a
``cumsum`` + ``scatter`` here, with the same order-preserving result.
"""

from typing import NamedTuple

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.render.spc import _trace
from kaolin_tpu_torch.render.spc.raytrace import (inverse_direction,
                                                  voxel_slab)
from kaolin_tpu_torch.utils.profiler import span

__all__ = ['CoherentHits', 'CellTable', 'build_cell_table',
           'unbatched_raytrace_coherent', 'hits_to_nuggets', 'LAUNCHES']

_INF = float('inf')
_BIG = 4.                       # bounds of empty chunks / the dump cell
LAUNCHES = {'cull': 0}          # launches of the culling kernel


class CoherentHits(NamedTuple):
    """Per-ray k-buffer of voxel intersections, near-to-far.

    Attributes:
        t_near: (num_rays, knum) f32 entry depths, inf-padded.
        t_far: (num_rays, knum) f32 exit depths, inf-padded (all inf when
            traced with ``with_exit=False``).
        pidx: (num_rays, knum) int32 point-hierarchy indices, -1-padded.
        count: (num_rays,) int32 exact hit count over the ray's candidate
            set (can exceed ``knum``).
        saturated: () bool tensor — True if candidates were dropped by a
            cap or any ray's hits overflowed ``knum``.
    """
    t_near: torch.Tensor
    t_far: torch.Tensor
    pidx: torch.Tensor
    count: torch.Tensor
    saturated: torch.Tensor


class CellTable(NamedTuple):
    """Per-octree acceleration table of the ``'mosaic'`` engine.

    Attributes:
        rows: (Mc + 1, 4, cw) int32 — per cell: rows 0..2 = voxel x/y/z,
            row 3 = LOCAL leaf index (-1 padding).  The last row is an
            all-invalid dump row.
        blo, bhi: (Mc + 1, 3) f32 cell bounds in [-1, 1] space.
        level: leaf level.  offset: pyramid offset of the leaf level.
        overflow: number of voxels dropped because a cell held more than
            ``cw`` (must be 0; check once after building).
    """
    rows: torch.Tensor
    blo: torch.Tensor
    bhi: torch.Tensor
    level: int
    offset: int
    overflow: int


def _beam_chunk_test(olo, ohi, dlo, dhi, blo, bhi):
    """Conservative test: can ANY ray with origin in [olo, ohi] and
    direction in [dlo, dhi] (componentwise) hit the box [blo, bhi] at some
    t > 0?  Interval relaxation of the slab test, never a false negative.
    Shapes broadcast; the last axis is xyz and is reduced."""
    r1 = bhi - olo                       # t * dlo <= r1
    r2 = blo - ohi                       # t * dhi >= r2
    safe_dlo = torch.where(dlo == 0., 1., dlo)
    safe_dhi = torch.where(dhi == 0., 1., dhi)
    ub_a = torch.where(dlo > 0., r1 / safe_dlo, _INF)
    lb_a = torch.where(dlo < 0., r1 / safe_dlo, 0.)
    lb_b = torch.where(dhi > 0., r2 / safe_dhi, 0.)
    ub_b = torch.where(dhi < 0., r2 / safe_dhi, _INF)
    feas = ((dlo != 0.) | (r1 >= 0.)) & ((dhi != 0.) | (r2 <= 0.))
    tlo = torch.maximum(lb_a.amax(dim=-1), lb_b.amax(dim=-1))
    thi = torch.minimum(ub_a.amin(dim=-1), ub_b.amin(dim=-1))
    return feas.all(dim=-1) & (tlo <= thi) & (thi > 0.)


def _compact_rows(hit, payloads):
    """Stable stream compaction along the last axis: the ``hit`` entries of
    each row moved to the front in order (``cumsum`` + ``scatter``).

    Returns (valid (..., C) bool — True for j < the row's hit count, packed
    payloads (..., C), 0 after the packed prefix).
    """
    C = hit.shape[-1]
    rank = torch.cumsum(hit, dim=-1) - 1
    dst = torch.where(hit, rank, C)
    valid = (torch.arange(C, device=hit.device)
             < hit.sum(dim=-1, keepdim=True))
    out = []
    for x in payloads:
        buf = x.new_zeros(x.shape[:-1] + (C + 1,))
        out.append(buf.scatter_(-1, dst, torch.where(hit, x, 0))[..., :C])
    return valid, out


def _first_k(mask, k, fill, ids=None):
    """Ids (default: column index) of the first ``k`` True columns of each
    row, ascending, padded with ``fill``: (..., C) -> (..., k) int64."""
    if ids is None:
        ids = torch.arange(mask.shape[-1], device=mask.device).expand(
            mask.shape)
    valid, (packed,) = _compact_rows(mask, (ids,))
    out = torch.where(valid, packed, fill)[..., :k]
    if out.shape[-1] < k:
        out = torch.cat([out, out.new_full(
            out.shape[:-1] + (k - out.shape[-1],), fill)], dim=-1)
    return out


def _beam_bounds(o, d, nS):
    """Block and super-tile interval boxes of (nB, rt, 3) origins and
    directions: ((olo, ohi, dlo, dhi) per block, the same per super-tile)."""
    blk = (o.amin(dim=1), o.amax(dim=1), d.amin(dim=1), d.amax(dim=1))
    sup = tuple((x.reshape(nS, 64, 3).amin(dim=1) if i % 2 == 0
                 else x.reshape(nS, 64, 3).amax(dim=1))
                for i, x in enumerate(blk))
    return blk, sup


# ---------------------------------------------------------------------------
# 'xla' engine: morton chunks of 64 voxels, plain PyTorch

def _raster_trace(leaf_pts, origin, direction, level, rays_per_tile,
                  max_chunks, max_chunks_super, knum, block_group):
    """leaf_pts (Vp, 3) int32 padded to chunks of 64 with -1; origin and
    direction padded to a whole number of super-tiles with miss rays."""
    RT, CK, CS = rays_per_tile, max_chunks, max_chunks_super
    Cc = CK * 64
    N = origin.shape[0]
    nB = N // RT
    nS = nB // 64
    M = leaf_pts.shape[0] // 64
    side = 2. / (1 << level)
    device = origin.device
    o = origin.to(torch.float32).reshape(nB, RT, 3)
    d = direction.to(torch.float32).reshape(nB, RT, 3)
    (olo_b, ohi_b, dlo_b, dhi_b), (olo_s, ohi_s, dlo_s, dhi_s) = \
        _beam_bounds(o, d, nS)

    pts_c = leaf_pts.reshape(M, 64, 3)
    valid_pt = (pts_c[..., 0] >= 0)[..., None]
    wlo = pts_c.to(torch.float32) * side - 1.
    blo = torch.where(valid_pt, wlo, _BIG).amin(dim=1)            # (M, 3)
    bhi = torch.where(valid_pt, wlo + side, -_BIG).amax(dim=1)

    cand_s = _beam_chunk_test(olo_s[:, None], ohi_s[:, None], dlo_s[:, None],
                              dhi_s[:, None], blo[None], bhi[None])  # (nS, M)
    sat = (cand_s.sum(dim=1) > CS).any()
    sup_ids = _first_k(cand_s, CS, M)                              # (nS, CS)
    blo_f = torch.cat([blo, blo.new_full((1, 3), _BIG)])
    bhi_f = torch.cat([bhi, bhi.new_full((1, 3), -_BIG)])
    cand_b = _beam_chunk_test(
        olo_b.reshape(nS, 64, 1, 3), ohi_b.reshape(nS, 64, 1, 3),
        dlo_b.reshape(nS, 64, 1, 3), dhi_b.reshape(nS, 64, 1, 3),
        blo_f[sup_ids][:, None], bhi_f[sup_ids][:, None])       # (nS, 64, CS)
    sat |= (cand_b.sum(dim=-1) > CK).any()
    blk_ids = _first_k(cand_b, CK, M,
                       ids=sup_ids[:, None].expand(nS, 64, CS)).reshape(nB, CK)

    pts_flat = torch.cat([pts_c, pts_c.new_full((1, 64, 3), -1)])
    pidx_c = torch.arange((M + 1) * 64, dtype=torch.int32,
                          device=device).reshape(M + 1, 64)
    pidx_c = torch.where(pts_flat[..., 0] >= 0, pidx_c, -1)        # (M+1, 64)

    k_take = min(knum, Cc)
    tns = torch.full((nB, RT, knum), _INF, device=device)
    tfs = torch.full((nB, RT, knum), _INF, device=device)
    pis = torch.full((nB, RT, knum), -1, dtype=torch.int32, device=device)
    cnt = torch.zeros((nB, RT), dtype=torch.int32, device=device)
    for b0 in range(0, nB, block_group):
        sl = slice(b0, b0 + block_group)
        ids = blk_ids[sl]
        tg = ids.shape[0]
        cpts = pts_flat[ids].reshape(tg, 1, Cc, 3)
        cpix = pidx_c[ids].reshape(tg, 1, Cc)
        tn, tf = voxel_slab(cpts, side, o[sl][:, :, None],
                            inverse_direction(d[sl])[:, :, None])  # (tg, RT, Cc)
        hit = (tf > tn) & (tf > 0.) & (tn > 0.) & (cpix >= 0)
        cnt[sl] = hit.sum(dim=-1, dtype=torch.int32)
        _, (tn_p, tf_p, pi_p) = _compact_rows(
            hit, (tn, tf, cpix.expand(tg, RT, Cc)))
        live = torch.arange(k_take, device=device) < cnt[sl][..., None]
        tn_k = torch.where(live, tn_p[..., :k_take], _INF)
        # near-to-far: stable sort by t (ties keep morton order)
        tn_k, order = torch.sort(tn_k, dim=-1, stable=True)
        tns[sl, :, :k_take] = tn_k
        tfs[sl, :, :k_take] = torch.where(
            live, tf_p[..., :k_take], _INF).gather(-1, order)
        pis[sl, :, :k_take] = torch.where(
            live, pi_p[..., :k_take], -1).gather(-1, order)
    cnt = cnt.reshape(N)
    return (tns.reshape(N, knum), tfs.reshape(N, knum), pis.reshape(N, knum),
            cnt, sat | (cnt > knum).any())


# ---------------------------------------------------------------------------
# 'mosaic' engine: octree cells + kernel K3

def build_cell_table(point_hierarchy, pyramid, level, cell_shift=3,
                     cell_width=192):
    """Group the target level's voxels by their level-(level - cell_shift)
    ancestor cells (contiguous runs of the morton-sorted leaves) into rows
    of ``cell_width`` for the ``'mosaic'`` engine, on the hierarchy's device.

    ``cell_width`` must cover the most populated cell (<= 8^cell_shift);
    ``overflow`` counts the voxels dropped otherwise (check that it is 0).
    Dropped voxels are left out of the table (the JAX package writes them
    to the dump row).
    """
    pyramid = torch.as_tensor(pyramid)
    cl = level - cell_shift
    assert cl >= 0
    V = int(pyramid[0, level])
    off = int(pyramid[1, level])
    Mc = int(pyramid[0, cl])
    cell_off = int(pyramid[1, cl])
    cw = int(cell_width)
    device = point_hierarchy.device
    leaf = point_hierarchy[off:off + V].to(torch.int64)
    cello = point_hierarchy[cell_off:cell_off + Mc].to(torch.float32)

    c = leaf >> cell_shift
    key = (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]
    first = torch.ones(V, dtype=torch.bool, device=device)
    first[1:] = key[1:] != key[:-1]
    cidx = torch.cumsum(first, 0) - 1
    idx = torch.arange(V, device=device)
    wpos = idx - torch.nonzero(first).squeeze(1)[cidx]     # slot in the cell
    ok = wpos < cw
    overflow = int((~ok).sum())

    packed = torch.stack([leaf[:, 0], leaf[:, 1], leaf[:, 2], idx], dim=-1)
    flat = torch.zeros(((Mc + 1) * cw, 4), dtype=torch.int32, device=device)
    flat[:, 3] = -1
    flat[(cidx * cw + wpos)[ok]] = packed[ok].to(torch.int32)
    rows = flat.reshape(Mc + 1, cw, 4).permute(0, 2, 1).contiguous()

    csz = 2.0 / (1 << cl)
    blo = cello * csz - 1.
    bhi = blo + csz
    blo = torch.cat([blo, blo.new_full((1, 3), _BIG)])
    bhi = torch.cat([bhi, bhi.new_full((1, 3), -_BIG)])
    return CellTable(rows, blo, bhi, int(level), off, overflow)


def _cull_candidates_torch(blo, bhi, o, d, cs, ck_max):
    """Plain PyTorch version of :func:`_cull_candidates` (same arguments
    and outputs)."""
    nB = o.shape[0]
    nS = nB // 64
    Mc = blo.shape[0] - 1
    (olo_b, ohi_b, dlo_b, dhi_b), (olo_s, ohi_s, dlo_s, dhi_s) = \
        _beam_bounds(o, d, nS)
    cand_s = _beam_chunk_test(olo_s[:, None], ohi_s[:, None], dlo_s[:, None],
                              dhi_s[:, None], blo[None, :Mc], bhi[None, :Mc])
    sat = (cand_s.sum(dim=1) > cs).any()
    sup_ids = _first_k(cand_s, cs, Mc)                             # (nS, cs)
    cand_b = _beam_chunk_test(
        olo_b.reshape(nS, 64, 1, 3), ohi_b.reshape(nS, 64, 1, 3),
        dlo_b.reshape(nS, 64, 1, 3), dhi_b.reshape(nS, 64, 1, 3),
        blo[sup_ids][:, None], bhi[sup_ids][:, None]).reshape(nB, cs)
    n_b = cand_b.sum(dim=-1)
    sat |= (n_b > ck_max).any()
    gids = sup_ids[:, None].expand(nS, 64, cs).reshape(nB, cs)
    blk_ids = _first_k(cand_b, ck_max, Mc, ids=gids)           # (nB, ck_max)
    return n_b, blk_ids.to(torch.int32), sat


_ext = _stream = None       # the extension module, the stream getter


def _bind():
    global _ext, _stream
    if _ext is None:
        from kaolin_tpu_torch import _cuda
        _stream = _cuda.stream_getter()
        _ext = _cuda.load_module('spc_cull')
    return _ext


def _cull_refused(blo, bhi, o, d):
    """Raise for inputs the extension refused: the first that fails
    ``_trace._check``, else the sizes the kernel takes."""
    nB, rt = o.shape[:2]
    _trace._check('blo', blo, torch.float32, (blo.shape[0], 3), o.device)
    _trace._check('bhi', bhi, torch.float32, tuple(blo.shape), o.device)
    _trace._check('o', o, torch.float32, (nB, rt, 3), o.device)
    _trace._check('d', d, torch.float32, (nB, rt, 3), o.device)
    raise ValueError('spc_cull_kernel takes cs, ck_max >= 0 and indexes with '
                     'ints: blk_ids and the super-tiles\' lists must hold '
                     'fewer than 2^31 elements, and the cell table at least '
                     'its dump row')


def _cull_candidates_cuda(blo, bhi, o, d, cs, ck_max):
    """Launch ``spc_cull_kernel`` (``csrc/spc_cull.cu``) and add one to
    ``LAUNCHES['cull']``; same contract as the plain version."""
    nB, rt = o.shape[:2]
    if not 1 <= rt <= _trace._MAX_RT or nB % 64:
        raise ValueError(
            f'spc_cull_kernel (one ray per lane, 64 blocks a super-tile) '
            f'takes 1 <= rays_per_tile <= {_trace._MAX_RT} and a whole '
            f'number of super-tiles; got rays_per_tile={rt}, {nB} blocks')
    out = (_ext or _bind()).cull(blo, bhi, o, d, int(cs), int(ck_max),
                                 _stream(o.get_device()))
    if out is None:
        _cull_refused(blo, bhi, o, d)
    if nB:
        LAUNCHES['cull'] += 1
    return out


def _cull_candidates(blo, bhi, o, d, cs, ck_max):
    """Culling, first stage: beam boxes, super-tile x cell test (first
    ``cs`` kept), block x candidate test (first ``ck_max`` kept).

    o/d (nB, rt, 3) f32 with nB a whole number of super-tiles.  Returns
    (n_b (nB,) int64 candidate count per block, over its super-tile's whole
    list; blk_ids (nB, ck_max) int32 cell ids padded with Mc; saturated ()
    bool tensor).  CPU tensors run :func:`_cull_candidates_torch`; CUDA
    tensors launch ``spc_cull_kernel`` (the same outputs bit for bit) or
    raise.
    """
    if o.device.type == 'cpu':
        return _cull_candidates_torch(blo, bhi, o, d, cs, ck_max)
    if o.device.type != 'cuda':
        raise ValueError(f'no spc culling for device {o.device}')
    return _cull_candidates_cuda(blo, bhi, o, d, cs, ck_max)


def _order_blocks(n_b, segments, ck_max, ne_cap):
    """Culling, second stage: the non-empty blocks (first ``ne_cap`` by
    id), sorted by candidate count, descending and stable, then empty
    blocks (by id) up to ``ne_cap``; position p in that order gets the
    cell cap of the segment that holds p.

    Every shape is fixed by ``ne_cap`` (the JAX package's compaction), so
    nothing waits for the card: the kept blocks' count in place, 0 for the
    rest, sorted over all nB blocks.  ``segments`` ends in an open cap.

    Returns (block_ids (ne_cap,) int64, nb (ne_cap,) int32 cells to read,
    0 past the non-empty blocks, saturated () bool tensor).
    """
    ne = n_b > 0
    kept = ne & (torch.cumsum(ne, 0) <= ne_cap)
    n_sorted, block_ids = torch.sort(torch.where(kept, n_b, 0),
                                     descending=True, stable=True)
    n_sorted, block_ids = n_sorted[:ne_cap], block_ids[:ne_cap]
    ckb = torch.empty_like(n_sorted)    # the cap of each position's segment
    start = 0
    for cap, c in segments:
        stop = min(start + cap, ne_cap) if cap else ne_cap
        ckb[start:stop] = c
        start = stop
    sat = (ne.sum() > ne_cap) | (n_sorted > ckb).any()
    nb = torch.minimum(n_sorted, ckb.clamp(max=ck_max)).to(torch.int32)
    return block_ids, nb, sat


def _gather_inputs(o, d, blk_ids, block_ids):
    """Culling, last stage: the active blocks' rays (origin, 1 / direction)
    and candidate cell lists, in the sorted order, as K3 reads them."""
    rays = torch.cat([o, inverse_direction(d)], dim=-1)[block_ids]
    return rays.contiguous(), blk_ids[block_ids]


def _cull_blocks(blo, bhi, origin, direction, rt, cs, segments, ne_cap):
    """Beam culling of the ``'mosaic'`` engine: K3's inputs.

    origin/direction (N, 3) with N a whole number of super-tiles (64 * rt
    rays); blo/bhi (Mc + 1, 3) cell bounds.  Super-tiles take their first
    ``cs`` candidate cells, blocks refine that list (first ``segments[0][1]``
    kept); the non-empty blocks (first ``ne_cap``) are sorted by candidate
    count, descending and stable, and position p in that order gets the
    cell cap of the segment that holds p; empty blocks fill the list to
    ``ne_cap`` with nb = 0.  Three stages: :func:`_cull_candidates`,
    :func:`_order_blocks`, :func:`_gather_inputs`, each in its span
    (``spc.cull``, ``spc.order``, ``spc.gather``), none of which waits for
    the card.

    Returns (rays (ne_cap, rt, 6) f32 [origin, 1 / direction], block_cells
    (ne_cap, ckmax) int32, nb (ne_cap,) int32, block_ids (ne_cap,) int64,
    saturated () bool tensor, nB).
    """
    nB = origin.shape[0] // rt
    o = origin.to(torch.float32).reshape(nB, rt, 3)
    d = direction.to(torch.float32).reshape(nB, rt, 3)
    ck_max = segments[0][1]
    with span('spc.cull', o.device):
        n_b, blk_ids, sat = _cull_candidates(blo, bhi, o, d, cs, ck_max)
    with span('spc.order', o.device):
        block_ids, nb, sat_o = _order_blocks(n_b, segments, ck_max, ne_cap)
    with span('spc.gather', o.device):
        rays, block_cells = _gather_inputs(o, d, blk_ids, block_ids)
    return rays, block_cells, nb, block_ids, sat | sat_o, nB


def _pad_rays(origin, direction, rt):
    """Pad to a whole number of super-tiles (64 * rt rays) with rays that
    start outside [-1, 1]^3 and move away: they hit nothing."""
    rpad = (-origin.shape[0]) % (rt * 64)
    device = origin.device
    return (torch.cat([origin.to(torch.float32),
                       torch.full((rpad, 3), 3., device=device)]),
            torch.cat([direction.to(torch.float32),
                       torch.ones((rpad, 3), device=device)]))


def _cull_settings(cell_table, num_blocks, knum=64, segments=None,
                   max_super_voxels=None, max_active_blocks=None):
    """The ``'mosaic'`` engine's culling settings for ``num_blocks`` ray
    blocks (arguments as in :func:`unbatched_raytrace_coherent`): (kbuf,
    segments with a last open cap, cells kept per super-tile, most active
    blocks)."""
    Mc = cell_table.rows.shape[0] - 1
    cw = cell_table.rows.shape[2]
    if segments is None:
        segments = ((1024, 128), (3072, 32), (8192, 8), (None, 4))
    segs = [(cap, min(int(ckb), Mc)) for cap, ckb in segments]
    if segs[-1][0] is not None:
        segs.append((None, segs[-1][1]))
    cs = min(Mc, max(segs[0][1], int(max_super_voxels or 98304) // cw))
    if max_active_blocks is None:
        max_active_blocks = max(1024, num_blocks // 2)
    return _kbuf(knum), segs, cs, min(num_blocks, int(max_active_blocks))


def _kbuf(knum):
    """K3's k-buffer width for ``knum`` hits a ray: a power of two, at
    least 64."""
    return max(64, 1 << int(np.ceil(np.log2(max(2, knum)))))


def trace_inputs(cell_table, origin, direction, rays_per_tile=16, knum=64,
                 segments=None, max_super_voxels=None,
                 max_active_blocks=None):
    """The ``'mosaic'`` engine's culling: K3's arguments for a ray set, as a
    dict of the keyword arguments of :func:`._trace.trace` but
    ``with_exit``, and the culling's saturation flag.  Arguments as in
    :func:`unbatched_raytrace_coherent`.  ``block_ids`` and ``nb`` (and
    ``rays``, ``block_cells``) hold ``min(max_active_blocks, blocks)``
    entries: the non-empty blocks first, then empty ones with nb = 0;
    count the non-empty blocks as ``(nb > 0).sum()``."""
    rt = int(rays_per_tile)
    origin, direction = _pad_rays(origin, direction, rt)
    kbuf, segs, cs, ne_cap = _cull_settings(
        cell_table, origin.shape[0] // rt, knum, segments, max_super_voxels,
        max_active_blocks)
    rays, cells, nb, bids, sat, nB = _cull_blocks(
        cell_table.blo, cell_table.bhi, origin, direction, rt, cs, segs,
        ne_cap)
    return dict(rays=rays, cell_rows=cell_table.rows, block_cells=cells,
                nb=nb, block_ids=bids, kbuf=kbuf,
                half=1.0 / (1 << cell_table.level), num_blocks=nB), sat


def _trace_cells(cell_table, origin, direction, rays_per_tile, knum,
                 segments, max_super_voxels, max_active_blocks, with_exit,
                 pidx_offset):
    """The ``'mosaic'`` engine on rays in block order: the culling, K3 and
    the cut to the rays given and to ``knum`` entries.  Arguments as in
    :func:`unbatched_raytrace_coherent`; ``pidx_offset`` as in
    :func:`._trace.trace`.  The k-buffer is allocated and filled before the
    culling is enqueued (both in span ``spc.trace``), and nothing waits for
    the card.  Returns (t_near, t_far, pidx (N, knum), count (N,),
    saturated)."""
    N = origin.shape[0]
    rt = int(rays_per_tile)
    # the k-buffer first: its fills, the frame's largest work, start on the
    # card while the host enqueues the culling
    with span('spc.trace', origin.device):
        out = _trace._outputs((N + (-N) % (64 * rt)) // rt, rt, _kbuf(knum),
                              origin.device)
    args, sat = trace_inputs(cell_table, origin, direction, rt, knum,
                             segments, max_super_voxels, max_active_blocks)
    with span('spc.trace', origin.device):
        tns, tfs, pis, cnt = _trace.trace(with_exit=bool(with_exit),
                                          pidx_offset=pidx_offset, out=out,
                                          **args)
    tns, tfs, pis = (x.reshape(-1, args['kbuf'])[:N, :knum]
                     for x in (tns, tfs, pis))
    cnt = cnt.reshape(-1)[:N]
    return tns, tfs, pis, cnt, sat | (cnt > knum).any()


def _block_order(height, width, bh, bw):
    """Row-major order of pixels grouped into (bh, bw) blocks; returns
    (perm, inv_perm) host numpy index arrays of length height*width."""
    idx = np.arange(height * width).reshape(height, width)
    hp, wp = -(-height // bh) * bh, -(-width // bw) * bw
    pad = np.full((hp, wp), -1, np.int64)
    pad[:height, :width] = idx
    blocks = pad.reshape(hp // bh, bh, wp // bw, bw).transpose(0, 2, 1, 3)
    perm = blocks.reshape(-1)
    perm = perm[perm >= 0]
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0])
    return perm, inv


def grid_order(height, width, rays_per_tile):
    """The ray order that ``grid_shape=(height, width)`` traces in: the
    row-major pixels grouped into compact blocks of about ``rays_per_tile``
    (:func:`_block_order`); (perm, inv_perm) host numpy index arrays."""
    bw = max(1, min(width, int(np.sqrt(rays_per_tile))))
    return _block_order(height, width, max(1, rays_per_tile // bw), bw)


def unbatched_raytrace_coherent(octree, point_hierarchy, pyramid, exsum,
                                origin, direction, level,
                                rays_per_tile=16, max_tile_voxels=1024,
                                max_super_voxels=None, knum=64,
                                block_group=None, grid_shape=None,
                                engine='auto', cell_table=None,
                                segments=None, max_active_blocks=None,
                                with_exit=True, device=None):
    """Trace a coherent ray set against an SPC octree.

    Same inputs as :func:`~kaolin_tpu_torch.render.spc.raytrace.
    unbatched_raytrace` (``octree``/``exsum`` are accepted for signature
    parity; only the target level's voxels are read).  Returns a
    :class:`CoherentHits` k-buffer (see :func:`hits_to_nuggets`).

    Args:
        origin, direction: (num_rays, 3); CONSECUTIVE rays should be
            spatially coherent — blocks of ``rays_per_tile`` consecutive
            rays share a beam, and 64 consecutive blocks a super-beam.
        level: target octree level.
        rays_per_tile: rays per block (the CUDA kernel takes <= 32).
        max_tile_voxels: ``'xla'``: per-block candidate voxels (rounded up
            to chunks of 64).
        max_super_voxels: per-super-tile candidate voxels (``'mosaic'``:
            default 98304, in cells of the table's width; ``'xla'``:
            default 8x the block's).
        knum: per-ray hit capacity.
        block_group: ``'xla'``: blocks traced at once (memory knob).
        grid_shape: optional (H, W): rays are an image in row-major order;
            blocks are taken as compact pixel rectangles (one permutation
            in, one out).
        engine: ``'mosaic'`` (cell table + kernel K3), ``'xla'`` (morton
            chunks, plain PyTorch) or ``'auto'`` (= ``'mosaic'``).
        cell_table: prebuilt :func:`build_cell_table` output (``'mosaic'``).
        segments: ``'mosaic'``: (block_cap, cells_per_block) pairs, the
            largest cell count first; blocks sorted by candidate count take
            them in order (the last cap may be None = the rest).  Default
            ``((1024, 128), (3072, 32), (8192, 8), (None, 4))``.
        max_active_blocks: ``'mosaic'``: most non-empty blocks traced
            (default: half the blocks, at least 1024).  K3 always runs
            this many blocks (at most all of them): those past the
            non-empty ones read no cell, and the frame has a fixed shape
            that the host enqueues without waiting for the card.
        with_exit: also return exit depths (else ``t_far`` is all inf).
        device: where to trace (default: the device of the tensor inputs,
            the card for numpy ones).
    """
    device = entry_device(device, origin, direction, point_hierarchy)
    with span('spc.frame', device):
        pyramid = torch.as_tensor(pyramid)
        V = int(pyramid[0, level])
        off = int(pyramid[1, level])
        origin = torch.as_tensor(origin, device=device)
        direction = torch.as_tensor(direction, device=device)
        N = origin.shape[0]
        RT = int(rays_per_tile)
        if engine == 'auto':
            engine = 'mosaic'
        if engine not in ('mosaic', 'xla'):
            raise ValueError(f'unknown engine {engine!r}')
        inv = None
        if grid_shape is not None:
            h, w = grid_shape
            assert h * w == N, (grid_shape, N)
            perm, inv = grid_order(h, w, RT)
            origin = origin[torch.as_tensor(perm, device=device)]
            direction = direction[torch.as_tensor(perm, device=device)]

        if engine == 'mosaic':
            if cell_table is None:
                cell_table = build_cell_table(
                    torch.as_tensor(point_hierarchy, device=device), pyramid,
                    level)
            # K3 writes the final pidx: the leaf index + the level's offset
            tns, tfs, pis, cnt, sat = _trace_cells(
                cell_table, origin, direction, RT, knum, segments,
                max_super_voxels, max_active_blocks, with_exit,
                pidx_offset=off)
        else:
            origin, direction = _pad_rays(origin, direction, RT)
            nB = origin.shape[0] // RT
            leaf = torch.as_tensor(point_hierarchy, device=device)[
                off:off + V].to(torch.int32)
            vpad = (-V) % 64
            leaf = torch.cat([leaf, leaf.new_full((vpad, 3), -1)])
            M = leaf.shape[0] // 64
            CK = min(max(1, -(-int(max_tile_voxels) // 64)), M)
            if max_super_voxels is None:
                max_super_voxels = 8 * CK * 64
            CS = min(max(CK, -(-int(max_super_voxels) // 64)), M)
            if block_group is None:
                block_group = max(1, (4 << 20) // (RT * CK * 64))
            tns, tfs, pis, cnt, sat = _raster_trace(
                leaf, origin, direction, int(level), RT, CK, CS, int(knum),
                min(int(block_group), nB))
            tns, tfs, pis, cnt = tns[:N], tfs[:N], pis[:N], cnt[:N]
            pis = torch.where(pis >= 0, pis + off, -1)
        if inv is not None:
            iv = torch.as_tensor(inv, device=device)
            tns, tfs, pis, cnt = tns[iv], tfs[iv], pis[iv], cnt[iv]
        return CoherentHits(tns, tfs, pis, cnt, sat)


def hits_to_nuggets(hits, trim=True):
    """Convert a :class:`CoherentHits` k-buffer to the packed nugget format
    of ``unbatched_raytrace``: (ridx int32, pidx int32, depths (n, 2)),
    ray-major and near-to-far within each ray.  ``trim=False`` pads to
    num_rays * knum with -1 ids and 0 depths."""
    N, K = hits.pidx.shape
    live = torch.nonzero((hits.pidx >= 0).reshape(-1)).squeeze(1)
    ridx = (live // K).to(torch.int32)
    pidx = hits.pidx.reshape(-1)[live]
    depths = torch.stack([hits.t_near.reshape(-1)[live],
                          hits.t_far.reshape(-1)[live]], dim=-1)
    if not trim:
        pad = N * K - live.shape[0]
        ridx = torch.cat([ridx, ridx.new_full((pad,), -1)])
        pidx = torch.cat([pidx, pidx.new_full((pad,), -1)])
        depths = torch.cat([depths, depths.new_zeros((pad, 2))])
    return ridx, pidx, depths
