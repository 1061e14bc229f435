"""Kernel K3 (``spc_trace_kernel``) against its plain PyTorch version.

This file imports no JAX, so it also runs where only PyTorch is installed
(on the card: ``python -m pytest --noconftest tests/test_torch_spc_kernels.py``).
Tests marked ``cuda`` need a CUDA card and skip elsewhere.  The CPU tests
hold the plain version against a brute-force loop written in numpy.

Tolerance: exact.  count and pidx equal; t_near and t_far bitwise equal (the
kernel is built with ``-fmad=false`` and rounds each product and sum of the
slab test as PyTorch does; min/max are exact).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch.ops.spc import (generate_points, scan_octrees,
                                      unbatched_points_to_octree)
from kaolin_tpu_torch.probes import _kernels
from kaolin_tpu_torch.render.spc import _trace, raster
from kaolin_tpu_torch.render.spc.raster import build_cell_table, trace_inputs
from kaolin_tpu_torch.utils.testing import camera_grid, punch_cell_rows

# evaluated when the test runs, not at import
cuda = pytest.mark.skipif('not torch.cuda.is_available()',
                          reason='needs a CUDA card (run on the H100)')


def _diagonal_grid(side):
    o, d = camera_grid(side, z=-2.5, spread=0.05, extent=0.3)
    o[:, :2] -= 2.5
    d = d + np.array([1., 1., 0.], np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def scene(level, npts, seed, rays, rt, knum, holes=False, device='cpu',
          zero_nb=False):
    """K3's arguments for a random octree and a coherent ray set; with
    ``holes``, voxels are taken out of the cell rows (``punch_cell_rows``:
    rows with holes in the middle, emptied rows, untouched rows)."""
    rng = np.random.default_rng(seed)
    pts = torch.as_tensor(rng.integers(0, 2 ** level, (npts, 3)))
    octree = unbatched_points_to_octree(pts, level).to(device)
    _, pyr, exsum = scan_octrees(octree, [octree.shape[0]])
    ph = generate_points(octree, pyr, exsum)
    table = build_cell_table(ph, pyr[0], level, cell_shift=2, cell_width=64)
    o, d = camera_grid(24) if rays == 'camera' else _diagonal_grid(16)
    args, _ = trace_inputs(table, torch.as_tensor(o, device=device),
                           torch.as_tensor(d, device=device),
                           rays_per_tile=rt, knum=knum,
                           segments=((None, 4096),),
                           max_super_voxels=64 * 4096)
    if holes:
        args['cell_rows'] = torch.as_tensor(
            punch_cell_rows(args['cell_rows'].cpu().numpy(), seed),
            device=device)
    if zero_nb:
        args['nb'][::3] = 0
    return args


CASES = [  # level, points, seed, rays, rays per block, knum[, holes]
    (4, 300, 1, 'camera', 16, 64),
    (6, 3000, 2, 'camera', 32, 64),
    (5, 60000, 5, 'diagonal', 16, 64),      # counts > 64 = kbuf
    (5, 60000, 5, 'diagonal', 32, 128),     # counts > 64, < kbuf
    (5, 60000, 5, 'diagonal', 16, 64, True),    # holes, counts > kbuf
    (5, 60000, 5, 'diagonal', 32, 128, True),   # holes, counts < kbuf
    (4, 300, 1, 'camera', 16, 64, True),        # sparse rows with holes
]
OFFSET = 37449                  # a pidx_offset: level 5's in a full pyramid


def _row_kinds(args):
    """How many of the candidate rows the blocks read are full, empty, and
    hold a hole before their last voxel."""
    used = torch.arange(args['block_cells'].shape[1])[None] < args['nb'][:, None]
    live = args['cell_rows'][torch.unique(args['block_cells'][used]).long(),
                             3] >= 0
    cw = live.shape[1]
    last = (live * torch.arange(1, cw + 1)).amax(1)       # fill of the row
    return dict(full=int(live.all(1).sum()), empty=int((~live.any(1)).sum()),
                holes=int((live.sum(1) < last).sum()))


def _brute_force(args, with_exit):
    """K3 as a loop over blocks and rays in numpy float32."""
    rays = args['rays'].numpy()
    rows = args['cell_rows'].numpy()
    nA, rt = rays.shape[:2]
    kbuf, side = args['kbuf'], np.float32(2. * args['half'])
    out = [np.full((args['num_blocks'], rt, kbuf), np.inf, np.float32),
           np.full((args['num_blocks'], rt, kbuf), np.inf, np.float32),
           np.full((args['num_blocks'], rt, kbuf), -1, np.int32),
           np.zeros((args['num_blocks'], rt), np.int32)]
    for a in range(nA):
        cells = args['block_cells'][a, :int(args['nb'][a])].numpy()
        g = rows[cells].transpose(1, 0, 2).reshape(4, -1)    # candidate order
        lo = g[:3].T.astype(np.float32) * side - np.float32(1.)
        b = int(args['block_ids'][a])
        for r in range(rt):
            o, inv = rays[a, r, :3], rays[a, r, 3:]
            t0 = (lo - o) * inv
            t1 = t0 + side * inv
            tn = np.minimum(t0, t1).max(axis=1)
            tf = np.maximum(t0, t1).min(axis=1)
            hit = np.nonzero((tf > tn) & (tf > 0) & (tn > 0) & (g[3] >= 0))[0]
            out[3][b, r] = len(hit)
            kept = hit[:kbuf]
            order = np.argsort(tn[kept], kind='stable')
            n = len(kept)
            out[0][b, r, :n] = tn[kept][order]
            out[2][b, r, :n] = g[3][kept][order]
            if with_exit:
                out[1][b, r, :n] = tf[kept][order]
    return out


def _assert_same(out_a, out_b):
    for x, y in zip(out_a, out_b):
        x, y = torch.as_tensor(x).cpu(), torch.as_tensor(y).cpu()
        if x.dtype == torch.float32:
            x, y = x.view(torch.int32), y.view(torch.int32)   # bitwise
        assert torch.equal(x, y)


@pytest.mark.parametrize('with_exit', [True, False])
def test_plain_version_matches_brute_force(with_exit):
    """Hits in candidate order, only the first kbuf kept, a stable sort by
    t_near; blocks with no candidate cells and inactive blocks keep the
    defaults."""
    args = scene(5, 60000, 5, 'diagonal', 16, 64, zero_nb=True)
    assert bool((args['nb'][32:] == 0).all())   # the empty blocks' tail
    n0 = _trace.LAUNCHES['trace']
    out = _trace.trace(with_exit=with_exit, **args)
    assert _trace.LAUNCHES['trace'] == n0          # CPU: the plain version
    _assert_same(out, _brute_force(args, with_exit))
    cnt = out[3]
    assert int(cnt.max()) > args['kbuf']
    empty = args['block_ids'][args['nb'] == 0]
    assert len(empty) > 0 and bool((cnt[empty] == 0).all())
    inactive = torch.ones(args['num_blocks'], dtype=torch.bool)
    inactive[args['block_ids']] = False
    assert bool((out[2][inactive] == -1).all())
    assert bool((out[2][empty] == -1).all())


@pytest.mark.parametrize('with_exit', [True, False])
@pytest.mark.parametrize('case', CASES[4:])
def test_plain_version_matches_brute_force_with_holes(case, with_exit):
    """Rows with -1 in the middle, rows of -1 only and full rows, among the
    candidates of one scene; counts past kbuf where kbuf is 64."""
    args = scene(*case, zero_nb=True)
    kinds = _row_kinds(args)
    assert kinds['holes'] > 0 and kinds['empty'] > 0
    out = _trace.trace(with_exit=with_exit, **args)
    _assert_same(out, _brute_force(args, with_exit))
    assert int(out[3].sum()) > 0
    if case[3] == 'diagonal':
        assert kinds['full'] > 0
        assert (int(out[3].max()) > args['kbuf']) == (case[5] == 64)


@pytest.mark.parametrize('with_exit', [True, False])
@pytest.mark.parametrize('stage', _kernels.STAGES)
def test_plain_pidx_offset(stage, with_exit):
    """``pidx_offset`` moves every live pidx and nothing else: the offset
    result equals where(pidx >= 0, pidx + offset, -1) of the offset-0
    result, t_near, t_far and count bit for bit, at every stage."""
    args = scene(*CASES[4], zero_nb=True)
    base = _kernels.trace_staged(stage, with_exit=with_exit, **args)
    moved = _kernels.trace_staged(stage, with_exit=with_exit,
                                pidx_offset=OFFSET, **args)
    want = torch.where(base[2] >= 0, base[2] + OFFSET, -1)
    _assert_same(moved, (base[0], base[1], want, base[3]))
    assert bool((base[2] >= 0).any()) == (stage >= 4)
    if stage == 6:
        _assert_same(moved, _trace.trace(with_exit=with_exit,
                                         pidx_offset=OFFSET, **args))


def test_wrapper_mirrors_the_kernel_shape():
    """The wrapper's copy of the kernel's shape and of its shared-memory
    formula equals what the source compiles."""
    src = (Path(_trace.__file__).parents[2] / 'csrc' / 'spc_trace.cuh'
           ).read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))

    assert (_trace._THREADS, _trace._MAX_RT, _trace._UNIT, _trace._UNROLL) \
        == (const('THREADS'), const('MAX_RT'), const('UNIT'), const('UNROLL'))
    assert 'const size_t unit = (size_t)(UNIT + UNROLL) * sizeof(float4);' \
        in src
    assert 'const size_t sort = (size_t)kbuf * 4 * (with_exit ? 3 : 2);' in src
    warps = _trace._THREADS // 32
    assert _trace._smem_bytes(256, False) == warps * (256 + 4) * 16
    assert _trace._smem_bytes(1024, True) == warps * 1024 * 12
    assert _trace._smem_bytes(345, False) == warps * 4160     # the unit's
    assert _trace._smem_bytes(521, False) == warps * 4176     # 16-byte steps


@pytest.mark.parametrize('rt,kbuf', [(64, 64), (16, 32768)])
def test_wrapper_refuses_a_shape_before_it_launches(rt, kbuf):
    """More rays than a warp has lanes, or a k-buffer whose sort does not
    fit in shared memory, raises in the wrapper: no library is loaded."""
    args = scene(*CASES[0])
    args = dict(args, rays=torch.ones((1, rt, 6)), kbuf=kbuf,
                block_cells=args['block_cells'][:1], nb=args['nb'][:1],
                block_ids=args['block_ids'][:1])
    num_blocks = args.pop('num_blocks')
    out = _trace._outputs(num_blocks, rt, kbuf, 'cpu')
    with pytest.raises(ValueError, match='rays_per_tile'):
        _trace._launch(with_exit=True, out=out, **args)


@pytest.mark.parametrize('with_exit', [True, False])
def test_trace_into_given_outputs(with_exit):
    """``out``: K3 writes into the outputs it is given, as ``_outputs``
    makes them, and returns them; the result equals the allocating call's
    bit for bit.  The list ends in blocks with nb = 0, which the plain
    version skips."""
    args = scene(*CASES[4], zero_nb=True)
    assert bool((args['nb'][32:] == 0).all())
    want = _trace.trace(with_exit=with_exit, pidx_offset=OFFSET, **args)
    out = _trace._outputs(args['num_blocks'], args['rays'].shape[1],
                          args['kbuf'], 'cpu')
    got = _trace.trace(with_exit=with_exit, pidx_offset=OFFSET, out=out,
                       **args)
    assert all(g is o for g, o in zip(got, out))
    _assert_same(got, want)

@cuda
@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('with_exit', [True, False])
@pytest.mark.parametrize('zero_nb', [False, True])
@pytest.mark.parametrize('offset', [0, OFFSET])
def test_cuda_trace_matches_plain(case, with_exit, zero_nb, offset):
    args = scene(*case, device='cuda', zero_nb=zero_nb)
    n0 = _trace.LAUNCHES['trace']
    out_k = _trace.trace(with_exit=with_exit, pidx_offset=offset, **args)
    torch.cuda.synchronize()
    assert _trace.LAUNCHES['trace'] == n0 + 1
    out_p = _trace._trace_torch(with_exit=with_exit, pidx_offset=offset,
                                **args)
    _assert_same(out_k, out_p)
    again = _trace.trace(with_exit=with_exit, pidx_offset=offset, **args)
    _assert_same(out_k, again)                     # the same on every run
    cnt = out_k[3]
    assert int(cnt.sum()) > 0
    if case[3] == 'diagonal':
        assert int(cnt.max()) > 64
        assert (int(cnt.max()) > args['kbuf']) == (case[5] == 64)


@cuda
def test_cuda_trace_wide_rows_and_few_rays():
    """Rows wider than the kernel stages at once take several units; a
    block of fewer rays than a warp has lanes leaves lanes without a
    ray."""
    for cw, rt in ((64, 4), (1100, 16), (1100, 32)):
        args = scene(5, 60000, 5, 'diagonal', rt, 64, True, device='cuda')
        rows = args['cell_rows']
        wide = torch.full((rows.shape[0], 4, cw), -1, dtype=torch.int32,
                          device='cuda')
        at = torch.arange(64, device='cuda') * (cw // 64)   # spread the slots
        wide[:, :, at] = rows
        args['cell_rows'] = wide.contiguous()
        for with_exit in (True, False):
            _assert_same(
                _trace.trace(with_exit=with_exit, pidx_offset=3, **args),
                _trace._trace_torch(with_exit=with_exit, pidx_offset=3,
                                    **args))


@cuda
def test_cuda_wrapper_checks_inputs():
    args = scene(*CASES[0], device='cuda')
    with pytest.raises(ValueError, match='nb'):
        _trace.trace(with_exit=True, **dict(args, nb=args['nb'].long()))
    with pytest.raises(ValueError, match='rays'):
        _trace.trace(with_exit=True,
                     **dict(args, rays=args['rays'][:, :, :3].contiguous()))
    with pytest.raises(ValueError, match='rays_per_tile'):
        _trace.trace(with_exit=True, **dict(args, kbuf=32768))
    rays64 = torch.ones((1, 64, 6), device='cuda')
    with pytest.raises(ValueError, match='rays_per_tile'):
        _trace.trace(with_exit=True, **dict(
            args, rays=rays64, block_cells=args['block_cells'][:1],
            nb=args['nb'][:1], block_ids=args['block_ids'][:1]))


@cuda
@pytest.mark.parametrize('entry,named', [('trace', 'cell_rows'),
                                         ('cull', 'cs = -1')])
def test_cuda_entries_name_what_they_refuse(entry, named):
    """An input that only the C++ entry tests (cell rows without their
    4 x cw layout for K3, a negative super-tile cap for the culling) raises
    ValueError naming it, not the 2^31 limit."""
    args = scene(*CASES[0], device='cuda')
    table = sphere_table(6, 2, 'cuda')
    o = torch.zeros((64, 16, 3), device='cuda')
    with pytest.raises(ValueError, match=named) as refused:
        if entry == 'trace':
            _trace.trace(with_exit=True, **dict(
                args, cell_rows=args['cell_rows'][:, 0].contiguous()))
        else:
            raster._cull_candidates(table.blo, table.bhi, o, o, -1, 64)
    assert '2^31' not in str(refused.value)


# ---------------------------------------------------------------------------
# The culling kernel (``spc_cull_kernel``) against its plain version

def sphere_octree(level, cell_shift, device='cpu', seed=0, npts=200000):
    """A level-``level`` octree of points on the sphere of radius 0.45:
    (octree, point hierarchy, pyramid, exsum, cell table)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(npts, 3))
    u = 0.45 * u / np.linalg.norm(u, axis=1, keepdims=True)
    pts = torch.as_tensor(np.floor((u + 1.) / 2. * 2 ** level)).long()
    octree = unbatched_points_to_octree(pts, level).to(device)
    _, pyr, exsum = scan_octrees(octree, [octree.shape[0]])
    ph = generate_points(octree, pyr, exsum)
    table = build_cell_table(ph, pyr[0], level, cell_shift=cell_shift,
                             cell_width=8 ** cell_shift)
    return octree, ph, pyr[0], exsum, table


def sphere_table(level, cell_shift, device='cpu'):
    return sphere_octree(level, cell_shift, device)[-1]


def cull_rays(kind, rt, n_super, seed=0):
    """(origin, direction) float32 numpy arrays of ``n_super`` super-tiles
    of 64 blocks of ``rt`` rays: ``'camera'`` a camera grid in compact
    blocks; ``'axis'`` parallel rays along z, with +0 and -0 as the x and y
    components (and some blocks with a slanted y); ``'pinhole'`` rays from
    near the centre whose directions, in every block of two rays or more,
    take both signs on every axis."""
    n = n_super * 64 * rt
    rng = np.random.default_rng(seed)
    if kind == 'camera':
        side = int(np.ceil(np.sqrt(n)))
        o, d = camera_grid(side, extent=0.6)
        perm, _ = raster.grid_order(side, side, rt)
        return o[perm][:n], d[perm][:n]
    i = np.arange(n)
    if kind == 'axis':
        o = np.stack([rng.uniform(-0.7, 0.7, n), rng.uniform(-0.7, 0.7, n),
                      np.full(n, -2.)], -1)
        d = np.zeros((n, 3))
        d[:, 0] = np.where(i % 2, -0., 0.)
        d[:, 1] = np.where((i // rt) % 3 == 0, 0.05 * (i % 2), -0.)
        d[:, 2] = 1.
        return o.astype(np.float32), d.astype(np.float32)
    signs = np.array([[1, 1, 1], [-1, -1, -1], [1, -1, -1], [-1, 1, 1]])
    o = rng.uniform(-0.05, 0.05, (n, 3))
    d = signs[i % 4] * rng.uniform(0.1, 1., (n, 3))
    return o.astype(np.float32), d.astype(np.float32)


def cull_args(table, o, d, rt, device):
    o, d = raster._pad_rays(torch.as_tensor(o, device=device),
                            torch.as_tensor(d, device=device), rt)
    nB = o.shape[0] // rt
    return (table.blo, table.bhi, o.reshape(nB, rt, 3),
            d.reshape(nB, rt, 3))


def _meets(olo, ohi, dlo, dhi, lo, hi):
    """``_beam_chunk_test`` for one beam and one box, in numpy float32
    scalars, written as the slab-interval test it is."""
    inf = np.float32(np.inf)
    tlo, thi, feas = -inf, inf, True
    for a in range(3):
        r1, r2 = hi[a] - olo[a], lo[a] - ohi[a]
        lb_a = r1 / dlo[a] if dlo[a] < 0 else np.float32(0)
        ub_a = r1 / dlo[a] if dlo[a] > 0 else inf
        lb_b = r2 / dhi[a] if dhi[a] > 0 else np.float32(0)
        ub_b = r2 / dhi[a] if dhi[a] < 0 else inf
        feas = feas and (dlo[a] != 0 or r1 >= 0) and (dhi[a] != 0 or r2 <= 0)
        tlo, thi = max(tlo, lb_a, lb_b), min(thi, ub_a, ub_b)
    return feas and tlo <= thi and thi > 0


def _cull_brute_force(blo, bhi, o, d, cs, ck_max):
    """The culling's first stage as loops over (super-tile, cell) and
    (block, slot) in numpy float32."""
    blo, bhi, o, d = (x.numpy() for x in (blo, bhi, o, d))
    nB, Mc = o.shape[0], blo.shape[0] - 1
    n_b = np.zeros(nB, np.int64)
    blk_ids = np.full((nB, ck_max), Mc, np.int32)
    sat = False
    with np.errstate(over='ignore'):
        for s in range(nB // 64):
            so, sd = o[64 * s:64 * s + 64], d[64 * s:64 * s + 64]
            beam = (so.min((0, 1)), so.max((0, 1)), sd.min((0, 1)),
                    sd.max((0, 1)))
            cells = [c for c in range(Mc) if _meets(*beam, blo[c], bhi[c])]
            sat |= len(cells) > cs
            slots = (cells + [Mc] * cs)[:cs]
            for b in range(64 * s, 64 * s + 64):
                beam = (o[b].min(0), o[b].max(0), d[b].min(0), d[b].max(0))
                met = [c for c in slots if _meets(*beam, blo[c], bhi[c])]
                n_b[b] = len(met)
                blk_ids[b, :min(len(met), ck_max)] = met[:ck_max]
                sat |= len(met) > ck_max
    return n_b, blk_ids, sat


def _same_cull(out, want):
    n_b, blk_ids, sat = out
    assert n_b.dtype == torch.int64 and blk_ids.dtype == torch.int32
    assert sat.dtype == torch.bool and sat.shape == ()
    assert torch.equal(n_b.cpu(), torch.as_tensor(want[0]).cpu())
    assert torch.equal(blk_ids.cpu(), torch.as_tensor(want[1]).cpu())
    assert bool(sat) == bool(want[2])


@pytest.mark.parametrize('cs,ck_max,saturates', [
    (10 ** 4, 10 ** 4, 'none'), (24, 10 ** 4, 'super-tile'),
    (10 ** 4, 3, 'block')])
def test_cull_plain_matches_brute_force(cs, ck_max, saturates):
    """The plain culling against the loops, on camera blocks and on
    pinhole blocks whose direction boxes hold 0 on every axis: every cell
    and every padding slot (the dump row) meets those."""
    table = sphere_table(5, 1)
    Mc = table.blo.shape[0] - 1
    rt = 4
    cam = cull_rays('camera', rt, 2)
    pin = cull_rays('pinhole', rt, 1)
    o, d = (np.concatenate([a, b]) for a, b in zip(cam, pin))
    args = cull_args(table, o, d, rt, 'cpu')
    cs, ck_max = min(cs, Mc + 7), min(ck_max, Mc + 7)
    out = raster._cull_candidates_torch(*args, cs, ck_max)
    want = _cull_brute_force(*args, cs, ck_max)
    _same_cull(out, want)
    n_b, blk_ids = want[:2]
    assert (n_b[128:] == cs).all()      # every slot, padding included
    if saturates != 'super-tile':       # the list ends in 7 padding slots
        assert (blk_ids[128:] == np.minimum(np.arange(ck_max), Mc)).all()
    assert bool(want[2]) == (saturates != 'none')
    assert 0 < n_b[:128].max() < cs


def test_cull_cpu_takes_the_plain_path():
    """CPU tensors run the plain version: the launch count stays, for the
    culling alone and for a whole coherent trace."""
    *spc, table = sphere_octree(5, 1)
    args = cull_args(table, *cull_rays('camera', 4, 2), 4, 'cpu')
    n0 = raster.LAUNCHES['cull']
    _same_cull(raster._cull_candidates(*args, 32, 16),
               raster._cull_candidates_torch(*args, 32, 16))
    o, d = cull_rays('camera', 16, 2)
    hits = raster.unbatched_raytrace_coherent(
        spc[0], spc[1], spc[2], spc[3], o, d, table.level, cell_table=table)
    assert int(hits.count.sum()) > 0
    assert raster.LAUNCHES['cull'] == n0


def _order_blocks_nonzero(n_b, segments, ck_max, ne_cap):
    """The block order with ``nonzero``: a list of the non-empty blocks
    alone, (nA,) long, whose length the host reads from the card.  The
    same order, caps and flag as :func:`raster._order_blocks` over its
    first nA entries."""
    ne_ids = torch.nonzero(n_b > 0).squeeze(1)
    sat = ne_ids.shape[0] > ne_cap
    ne_ids = ne_ids[:ne_cap]
    nA = ne_ids.shape[0]
    n_ne = n_b[ne_ids]
    order = torch.argsort(-n_ne, stable=True)
    block_ids, n_sorted = ne_ids[order], n_ne[order]
    seg_cap = torch.empty_like(n_sorted)
    start = 0
    for cap, ckb in segments:
        stop = min(start + cap, nA) if cap else nA
        seg_cap[start:stop] = min(ckb, ck_max)
        sat = sat | bool((n_sorted[start:stop] > ckb).any())
        start = stop
    return block_ids, torch.minimum(n_sorted, seg_cap).to(torch.int32), sat


ORDER_SEGMENTS = [(16, 12), (32, 6), (None, 3)]


def _order_counts(case):
    """Candidate counts of 256 blocks for a case of
    :func:`test_order_blocks_matches_the_nonzero_order`, and its
    ``ne_cap``: 16 blocks of 7-12 candidates, 32 of 4-6, 60 of 1-3 and the
    rest empty, in a seeded order, so that each segment takes its group
    and no cap cuts; a case changes that."""
    rng = np.random.default_rng(7)
    n = np.concatenate([rng.integers(7, 13, 16), rng.integers(4, 7, 32),
                        rng.integers(1, 4, 60), np.zeros(148, np.int64)])
    ne_cap = 200
    if case == 'ties':                  # few distinct counts, many ties
        n = np.concatenate([np.full(16, 9), np.full(32, 5), np.full(60, 2),
                            np.zeros(148, np.int64)])
    elif case == 'over_ne_cap':         # 60 of 108 non-empty blocks kept
        n = np.where(n > 0, np.minimum(n, 3), 0)
        ne_cap = 60
    elif case == 'all_empty':
        n = np.zeros(256, np.int64)
    elif case.startswith('cut'):        # one more block over segment k's cap
        k = int(case[-1])
        n[-1] = ORDER_SEGMENTS[k][1] + 1
    n = rng.permutation(n)
    return torch.as_tensor(n, dtype=torch.int64), ne_cap


@pytest.mark.parametrize('case', ['unsaturated', 'ties', 'over_ne_cap',
                                  'all_empty', 'cut0', 'cut1', 'cut2'])
def test_order_blocks_matches_the_nonzero_order(case):
    """The block order in a list of ``ne_cap`` entries against the list of
    the non-empty blocks alone (``nonzero``): the first nA block ids and
    cell counts equal, nb 0 after them, every block at most once, and the
    same saturation flag (ne_cap cut, or a segment's cap)."""
    n_b, ne_cap = _order_counts(case)
    ck_max = ORDER_SEGMENTS[0][1]
    block_ids, nb, sat = raster._order_blocks(n_b, ORDER_SEGMENTS, ck_max,
                                              ne_cap)
    want_ids, want_nb, want_sat = _order_blocks_nonzero(
        n_b, ORDER_SEGMENTS, ck_max, ne_cap)
    nA = want_ids.shape[0]
    assert block_ids.dtype == torch.int64 and nb.dtype == torch.int32
    assert sat.dtype == torch.bool and sat.shape == ()
    assert block_ids.shape == nb.shape == (ne_cap,)
    assert torch.equal(block_ids[:nA], want_ids)
    assert torch.equal(nb[:nA], want_nb)
    assert bool((nb[nA:] == 0).all())
    assert torch.unique(block_ids).shape[0] == ne_cap
    assert bool(sat) == want_sat
    assert want_sat == (case == 'over_ne_cap' or case.startswith('cut'))
    assert nA == min(ne_cap, int((n_b > 0).sum()))
    if case == 'ties':                  # within a count, by block id
        for c in (9, 5, 2):
            ids = block_ids[:nA][n_b[block_ids[:nA]] == c]
            assert torch.equal(ids, torch.sort(ids).values)
    if case == 'all_empty':
        assert nA == 0 and torch.equal(block_ids, torch.arange(ne_cap))


def _cull_const(name):
    """A constant of ``csrc/spc_cull.cu`` (a sum of integers)."""
    src = (Path(raster.__file__).parents[2] / 'csrc' / 'spc_cull.cu'
           ).read_text()
    expr = re.search(rf'constexpr int {name} = ([\d +]+);', src).group(1)
    return sum(int(x) for x in expr.split('+'))


def test_cull_wrapper_mirrors_the_kernel_shape():
    assert _trace._MAX_RT == _cull_const('MAX_RT')
    assert _cull_const('MAX_SMEM') == _trace._MAX_SMEM
    assert _cull_const('LIST_BYTES') == 4 + 6 * 4   # an id, lo and hi


@pytest.mark.parametrize('rt,nB', [(64, 64), (33, 64), (16, 65)])
def test_cull_wrapper_refuses_a_shape_before_it_launches(rt, nB,
                                                         monkeypatch):
    """More rays per block than a warp has lanes, or blocks that do not
    make whole super-tiles, raise in the wrapper: no library is loaded and
    nothing is counted."""
    def load(name):
        raise AssertionError('the library was loaded')

    monkeypatch.setattr(_cuda, 'load_module', load)
    table = sphere_table(4, 1)
    o = torch.zeros((nB, rt, 3))
    n0 = raster.LAUNCHES['cull']
    with pytest.raises(ValueError, match='rays_per_tile'):
        raster._cull_candidates_cuda(table.blo, table.bhi, o, o, 8, 8)
    assert raster.LAUNCHES['cull'] == n0


def _global_cs():
    """The least list length that does not fit in the kernel's shared
    memory (the source's static shared memory is under 4 KB)."""
    return _cull_const('MAX_SMEM') // _cull_const('LIST_BYTES') + 1


CULL_CASES = {  # name: (level, cell shift, rays, rt, super-tiles, cs, ck_max)
    'bench': (8, 3, 'camera', 32, 4, 512, 192),
    'rt16': (8, 3, 'camera', 16, 4, 512, 192),
    'rt8': (8, 3, 'camera', 8, 4, 512, 128),
    'rt1': (8, 3, 'camera', 1, 16, 512, 128),
    'cs_is_mc': (8, 3, 'camera', 32, 4, 'Mc', 192),
    'global_list': (8, 0, 'camera', 32, 4, 'global', 192),
    'one_super_tile': (8, 3, 'camera', 32, 1, 512, 192),
    'saturated': (8, 3, 'camera', 32, 4, 64, 16),
    'signed_zeros': (8, 3, 'axis', 16, 4, 512, 192),
    'pinhole': (7, 3, 'pinhole', 32, 2, 'Mc+40', 96),
}


@cuda
@pytest.mark.parametrize('name', list(CULL_CASES))
def test_cuda_cull_matches_plain(name):
    """``spc_cull_kernel`` against the plain version on the card: n_b,
    blk_ids and sat equal, the same on every run, one launch a call."""
    level, shift, rays, rt, n_super, cs, ck_max = CULL_CASES[name]
    table = sphere_table(level, shift, 'cuda')
    Mc = table.blo.shape[0] - 1
    cs = {'Mc': Mc, 'Mc+40': Mc + 40, 'global': _global_cs()}.get(cs, cs)
    args = cull_args(table, *cull_rays(rays, rt, n_super), rt, 'cuda')
    assert args[2].shape[0] == 64 * n_super
    n0 = raster.LAUNCHES['cull']
    out = raster._cull_candidates(*args, cs, ck_max)
    torch.cuda.synchronize()
    assert raster.LAUNCHES['cull'] == n0 + 1
    _same_cull(out, raster._cull_candidates_torch(*args, cs, ck_max))
    _same_cull(raster._cull_candidates(*args, cs, ck_max), out)
    n_b = out[0].cpu()
    assert int(n_b.max()) > 0 and Mc % _cull_const('THREADS') != 0
    if name == 'global_list':            # the list in device memory
        assert Mc > cs > 8000
    if name == 'saturated':              # both caps cut
        assert bool(out[2]) and int(n_b.max()) > ck_max
        assert int(n_b.max()) <= cs
    if name == 'signed_zeros':
        d = args[3]
        assert bool((d[..., :2] == 0).all(-1).any())
        assert bool(torch.signbit(d[..., 0]).any())
        assert bool((~torch.signbit(d[..., 0])).any())
    if name == 'pinhole':                # every slot meets, the dump row too
        assert bool((n_b == cs).all()) and bool(out[2])
        row = torch.minimum(torch.arange(ck_max), torch.tensor(Mc))
        assert bool((out[1].cpu() == row).all())


@cuda
def test_cuda_cull_saturates_the_super_tile_alone():
    """A super-tile with more than cs candidates flags sat where no block
    has more than ck_max."""
    table = sphere_table(8, 3, 'cuda')
    args = cull_args(table, *cull_rays('camera', 32, 4), 32, 'cuda')
    out = raster._cull_candidates(*args, 16, 10 ** 4)
    _same_cull(out, raster._cull_candidates_torch(*args, 16, 10 ** 4))
    assert bool(out[2]) and int(out[0].max()) <= 16


@cuda
def test_cuda_cull_launches_once_a_frame(monkeypatch):
    """One coherent trace on the card launches the culling kernel once and
    K3 once; its hits equal those of the same trace with the plain culling
    on the card."""
    octree, ph, pyr, exsum, table = sphere_octree(8, 3, 'cuda')
    o, d = (torch.as_tensor(x, device='cuda')
            for x in camera_grid(256, extent=0.6))

    def frame():
        return raster.unbatched_raytrace_coherent(
            octree, ph, pyr, exsum, o, d, table.level, rays_per_tile=16,
            engine='mosaic', cell_table=table, grid_shape=(256, 256))
    n0, k0 = raster.LAUNCHES['cull'], _trace.LAUNCHES['trace']
    hits = frame()
    torch.cuda.synchronize()
    assert raster.LAUNCHES['cull'] == n0 + 1
    assert _trace.LAUNCHES['trace'] == k0 + 1
    assert int(hits.count.sum()) > 0 and not bool(hits.saturated)
    monkeypatch.setattr(raster, '_cull_candidates_cuda',
                        raster._cull_candidates_torch)
    _assert_same(tuple(hits), tuple(frame()))
    assert raster.LAUNCHES['cull'] == n0 + 1


@cuda
def test_cuda_frame_waits_for_nothing():
    """A frame with a prebuilt cell table and a host pyramid enqueues
    without one host wait (``set_sync_debug_mode('error')`` raises at the
    first), launches the culling kernel once and K3 once, and its hits
    equal those of the plain version on the CPU bit for bit."""
    o, d = camera_grid(256, extent=0.6)
    perm, _ = raster.grid_order(256, 256, 16)
    o, d = torch.as_tensor(o[perm]), torch.as_tensor(d[perm])

    def frame(device):
        octree, ph, pyr, exsum, table = sphere_octree(8, 3, device)
        assert pyr.device.type == 'cpu'
        o_d, d_d = o.to(device), d.to(device)
        return lambda: raster.unbatched_raytrace_coherent(
            octree, ph, pyr, exsum, o_d, d_d, table.level, rays_per_tile=16,
            engine='mosaic', cell_table=table)
    on_card = frame('cuda')
    on_card()                           # loads the modules
    torch.cuda.synchronize()
    n0, k0 = raster.LAUNCHES['cull'], _trace.LAUNCHES['trace']
    torch.cuda.set_sync_debug_mode('error')
    try:
        hits = on_card()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert raster.LAUNCHES['cull'] == n0 + 1
    assert _trace.LAUNCHES['trace'] == k0 + 1
    want = frame('cpu')()
    assert int(want.count.sum()) > 0 and not bool(want.saturated)
    _assert_same(tuple(hits), tuple(want))


@cuda
def test_cuda_cull_refuses_before_it_launches():
    table = sphere_table(6, 2, 'cuda')
    n0 = raster.LAUNCHES['cull']
    o = torch.zeros((64, 64, 3), device='cuda')
    with pytest.raises(ValueError, match='rays_per_tile'):
        raster._cull_candidates(table.blo, table.bhi, o, o, 64, 64)
    o = torch.zeros((96, 16, 3), device='cuda')
    with pytest.raises(ValueError, match='super-tiles'):
        raster._cull_candidates(table.blo, table.bhi, o, o, 64, 64)
    o = torch.zeros((64, 16, 3), device='cuda')
    with pytest.raises(ValueError, match='o: expected'):
        raster._cull_candidates(table.blo, table.bhi, o.double(), o, 64, 64)
    with pytest.raises(ValueError, match='bhi: expected'):
        raster._cull_candidates(table.blo, table.bhi.cpu(), o, o, 64, 64)
    with pytest.raises(ValueError, match='d: expected'):
        raster._cull_candidates(table.blo, table.bhi, o,
                                o.transpose(0, 1).contiguous().transpose(
                                    0, 1), 64, 64)
    assert raster.LAUNCHES['cull'] == n0
