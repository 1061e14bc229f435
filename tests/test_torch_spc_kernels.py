"""Kernel K3 (``spc_trace_kernel``) against its plain PyTorch version.

This file imports no JAX, so it also runs where only PyTorch is installed
(on the card: ``python -m pytest --noconftest tests/test_torch_spc_kernels.py``).
Tests marked ``cuda`` need a CUDA card and skip elsewhere.  The CPU tests
hold the plain version against a brute-force loop written in numpy.

Tolerance: exact.  count and pidx equal; t_near and t_far bitwise equal (the
kernel is built with ``-fmad=false`` and rounds each product and sum of the
slab test as PyTorch does; min/max are exact).
"""
import numpy as np
import pytest
import torch

from kaolin_tpu_torch.ops.spc import (generate_points, scan_octrees,
                                      unbatched_points_to_octree)
from kaolin_tpu_torch.render.spc import _trace
from kaolin_tpu_torch.render.spc.raster import build_cell_table, trace_inputs
from kaolin_tpu_torch.utils.testing import camera_grid

# evaluated when the test runs, not at import
cuda = pytest.mark.skipif('not torch.cuda.is_available()',
                          reason='needs a CUDA card (run on the H100)')


def _diagonal_grid(side):
    o, d = camera_grid(side, z=-2.5, spread=0.05, extent=0.3)
    o[:, :2] -= 2.5
    d = d + np.array([1., 1., 0.], np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def scene(level, npts, seed, rays, rt, knum, device='cpu', zero_nb=False):
    """K3's arguments for a random octree and a coherent ray set."""
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
    if zero_nb:
        args['nb'][::3] = 0
    return args


CASES = [  # level, points, seed, rays, rays per block, knum
    (4, 300, 1, 'camera', 16, 64),
    (6, 3000, 2, 'camera', 32, 64),
    (5, 60000, 5, 'diagonal', 16, 64),      # counts > 64 = kbuf
    (5, 60000, 5, 'diagonal', 32, 128),     # counts > 64, < kbuf
]


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


@cuda
@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('with_exit', [True, False])
@pytest.mark.parametrize('zero_nb', [False, True])
def test_cuda_trace_matches_plain(case, with_exit, zero_nb):
    args = scene(*case, device='cuda', zero_nb=zero_nb)
    n0 = _trace.LAUNCHES['trace']
    out_k = _trace.trace(with_exit=with_exit, **args)
    torch.cuda.synchronize()
    assert _trace.LAUNCHES['trace'] == n0 + 1
    out_p = _trace._trace_torch(with_exit=with_exit, **args)
    _assert_same(out_k, out_p)
    cnt = out_k[3]
    assert int(cnt.sum()) > 0
    if case[3] == 'diagonal':
        assert int(cnt.max()) > 64
        assert (int(cnt.max()) > args['kbuf']) == (case[5] == 64)


@cuda
def test_cuda_wrapper_checks_inputs():
    args = scene(*CASES[0], device='cuda')
    with pytest.raises(ValueError, match='nb'):
        _trace.trace(with_exit=True, **dict(args, nb=args['nb'].long()))
    with pytest.raises(ValueError, match='rays'):
        _trace.trace(with_exit=True,
                     **dict(args, rays=args['rays'][:, :, :3].contiguous()))
    with pytest.raises(ValueError, match='rays_per_tile'):
        _trace.trace(with_exit=True, **dict(args, kbuf=4096))
