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

from kaolin_tpu_torch.ops.spc import (generate_points, scan_octrees,
                                      unbatched_points_to_octree)
from kaolin_tpu_torch.render.spc import _trace
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
@pytest.mark.parametrize('stage', _trace.STAGES)
def test_plain_pidx_offset(stage, with_exit):
    """``pidx_offset`` moves every live pidx and nothing else: the offset
    result equals where(pidx >= 0, pidx + offset, -1) of the offset-0
    result, t_near, t_far and count bit for bit, at every stage."""
    args = scene(*CASES[4], zero_nb=True)
    base = _trace.trace_staged(stage, with_exit=with_exit, **args)
    moved = _trace.trace_staged(stage, with_exit=with_exit,
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
    src = (Path(_trace.__file__).parents[2] / 'csrc' / 'spc_trace.cu'
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
