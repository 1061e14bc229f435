"""The probe kernels (P1, P2: ``csrc/probes.cu``; P3: the stages of K3's
template ``csrc/spc_trace.cuh``, built there too) against their plain
PyTorch versions.

This file imports no JAX, so it also runs where only PyTorch is installed
(on the card: ``python -m pytest --noconftest
tests/test_torch_probe_kernels.py``).  Tests marked ``cuda`` need a CUDA
card and skip elsewhere.  The CPU tests hold the plain versions of K3's
stages against K3's plain version and a loop in numpy.

Tolerance: exact.  Every kernel sums in its plain version's order (and is
built with ``-fmad=false``), so floats are compared bit for bit.
"""
import numpy as np
import pytest
import torch

from kaolin_tpu_torch.probes import _kernels, kbisect, mosaic3, stages
from kaolin_tpu_torch.render.spc import _trace

from test_torch_spc_kernels import CASES, _assert_same, scene

# evaluated when the test runs, not at import
cuda = pytest.mark.skipif('not torch.cuda.is_available()',
                          reason='needs a CUDA card (run on the H100)')


def _last_cell_brute_force(args):
    """Stage 3 as a loop in numpy: the t_near of each ray's hits in its
    block's last candidate cell, in lane order, first kbuf."""
    rays, rows = args['rays'].numpy(), args['cell_rows'].numpy()
    kbuf, side = args['kbuf'], np.float32(2. * args['half'])
    tn_out = np.full((args['num_blocks'], rays.shape[1], kbuf), np.inf,
                     np.float32)
    for a in range(rays.shape[0]):
        nb = int(args['nb'][a])
        if nb == 0:
            continue
        g = rows[int(args['block_cells'][a, nb - 1])]
        lo = g[:3].T.astype(np.float32) * side - np.float32(1.)
        for r in range(rays.shape[1]):
            o, inv = rays[a, r, :3], rays[a, r, 3:]
            t0 = (lo - o) * inv
            t1 = t0 + side * inv
            tn = np.minimum(t0, t1).max(axis=1)
            tf = np.maximum(t0, t1).min(axis=1)
            hit = (tf > tn) & (tf > 0) & (tn > 0) & (g[3] >= 0)
            kept = tn[hit][:kbuf]
            tn_out[int(args['block_ids'][a]), r, :len(kept)] = kept
    return tn_out


@pytest.mark.parametrize('with_exit', [True, False])
def test_staged_plain_versions(with_exit):
    """Stages 5 and 6 are K3; stages 1-2 write only the count; stage 4 is
    K3's k-buffer before its stable sort; stage 3 holds the last cell's
    hits."""
    args = scene(5, 60000, 5, 'diagonal', 16, 64, zero_nb=True)
    k3 = _trace._trace_torch(with_exit=with_exit, **args)
    out = {s: _kernels.trace_staged(s, with_exit=with_exit, **args)
           for s in _kernels.STAGES}
    _assert_same(out[6], k3)
    _assert_same(out[5], k3)
    defaults = _trace._outputs(args['num_blocks'], args['rays'].shape[1],
                               args['kbuf'], 'cpu')
    for s in (1, 2):
        _assert_same(out[s], defaults[:3] + (k3[3],))
    tn4, order = torch.sort(out[4][0], dim=-1, stable=True)
    _assert_same((tn4, out[4][1].gather(-1, order),
                  out[4][2].gather(-1, order), out[4][3]), k3)
    _assert_same((out[3][0],), (_last_cell_brute_force(args),))
    _assert_same(out[3][1:], defaults[1:3] + (k3[3],))
    assert int(k3[3].max()) > args['kbuf']
    with pytest.raises(ValueError, match='stage'):
        _kernels.trace_staged(7, with_exit=with_exit, **args)


@cuda
@pytest.mark.parametrize('case', CASES)
@pytest.mark.parametrize('with_exit', [True, False])
@pytest.mark.parametrize('stage', _kernels.STAGES)
def test_cuda_trace_stage_matches_plain(case, with_exit, stage):
    args = scene(*case, device='cuda', zero_nb=True)
    n0 = _kernels.LAUNCHES[f'stage{stage}']
    out_k = _kernels.trace_staged(stage, with_exit=with_exit, **args)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[f'stage{stage}'] == n0 + 1
    out_p = _kernels._trace_staged_torch(stage, with_exit=with_exit, **args)
    _assert_same(out_k, out_p)
    if stage == 6:
        _assert_same(out_k, _trace.trace(with_exit=with_exit, **args))


@cuda
@pytest.mark.parametrize('scene_fn', [kbisect.probe_inputs,
                                      kbisect.hit_scene])
def test_cuda_trace_stages_probe_layout(scene_fn):
    args = kbisect.from_probe_layout(*scene_fn(), 'cuda')
    for with_exit in (True, False):
        kbisect.check_stages(args, with_exit)


@cuda
@pytest.mark.parametrize('name', mosaic3.KERNELS)
def test_cuda_p1_matches_plain(name):
    inp = mosaic3.inputs('cuda')
    inp['x'] = torch.randn(inp['x'].shape, device='cuda')
    n0 = _kernels.LAUNCHES[name]
    mosaic3.check(inp, (name,))
    assert _kernels.LAUNCHES[name] == n0 + 1
    if name in mosaic3.ROW_SUMS:
        staging = mosaic3.inputs('cuda', 300, (4, 192), 5000, 61)
        mosaic3.check(staging, (name,))


def _noisy(inp, seed=2):
    """``inp`` with seeded normal x and table rows (sums then show their
    order)."""
    rng = np.random.default_rng(seed)
    return dict(inp, **{k: torch.as_tensor(rng.standard_normal(
        tuple(inp[k].shape)).astype(np.float32), device=inp[k].device)
        for k in ('x', 'table')})


@cuda
@pytest.mark.parametrize('name', ['kA', 'kD'])
def test_cuda_redesigned_p1_counts(name):
    """kA and kD on random x and rows with every count 1..8, with all
    counts >= 6 (where kA is not x * n), and with counts outside 1..CK
    (0, negative, past CK: kD clamps to 0..CK as its plain version)."""
    inp = _noisy(mosaic3.inputs('cuda'))
    nb, ck = mosaic3.NB, mosaic3.CK
    rng = np.random.default_rng(5)
    for counts in (rng.permutation(np.arange(nb) % ck + 1),
                   rng.integers(6, ck + 1, nb),
                   rng.integers(-2, ck + 4, nb)):
        for cols in (2, 1, 3):          # column 0 read at nbs' own stride
            nbs = np.stack([counts, counts[::-1], counts + 1][:cols], 1)
            inp['nbs'] = torch.as_tensor(nbs.astype(np.int32), device='cuda')
            mosaic3.check(inp, (name,))
    if name == 'kA':
        inp['nbs'] = torch.full((nb, 2), 7, dtype=torch.int32, device='cuda')
        out = _kernels.kA(inp['nbs'], inp['x'])
        assert int((out != inp['x'] * 7).sum()) > out.numel() // 4


@cuda
def test_cuda_kA_large_shape():
    inp = mosaic3.large_inputs('cuda')
    n0 = _kernels.LAUNCHES['kA']
    mosaic3.check(inp, ('kA',))
    assert _kernels.LAUNCHES['kA'] == n0 + 1


@cuda
@pytest.mark.parametrize('noisy', [False, True])
def test_cuda_row_sums_staging_shape(noisy):
    """kB, kC, kD at K3's staging shape with the SPC cell's 15,561 table
    rows (the script's integer rows, then random ones)."""
    inp = mosaic3.inputs('cuda', mosaic3.STAGING['nb'],
                         mosaic3.STAGING['rows'], 15561,
                         mosaic3.STAGING['ck'])
    mosaic3.check(_noisy(inp) if noisy else inp, mosaic3.ROW_SUMS)


@cuda
@pytest.mark.parametrize('name', mosaic3.KERNELS)
def test_cuda_captured_launch_equals_eager(name):
    mosaic3.check_captured(_noisy(mosaic3.inputs('cuda')), (name,))


@cuda
def test_cuda_probe_launches_count_one_per_call():
    inp = mosaic3.inputs('cuda')
    for name in mosaic3.KERNELS:
        n0 = _kernels.LAUNCHES[name]
        for _ in range(3):
            mosaic3.call(name, inp)
        assert _kernels.LAUNCHES[name] == n0 + 3


@cuda
def test_cuda_p2_matches_plain():
    n0 = _kernels.LAUNCHES['dummy']
    for n in (1, 1000, 65536):
        stages.check_dummy(n, torch.device('cuda'))
    assert _kernels.LAUNCHES['dummy'] == n0 + 6


# (bags, row shape, table rows, CK) for kB (the TMA ring) and kC (kD's
# kernel with every count CK)
ROW_SHAPES = {
    'script': (mosaic3.NB, (mosaic3.R, mosaic3.C), mosaic3.M, mosaic3.CK),
    'staging': (mosaic3.STAGING['nb'], mosaic3.STAGING['rows'], 15561,
                mosaic3.STAGING['ck']),
    'ck 1': (300, (4, 192), 500, 1),
    'rows of 4 floats': (200, (1, 4), 50, 13),
    'rows of 20 floats': (200, (5, 4), 50, 40),
    'rows past one CTA': (100, (8, 256), 64, 9),     # 2 float4s a thread
    'widest rows': (50, (16, 256), 40, 70),          # MAXV x THREADS float4s
}


@cuda
@pytest.mark.parametrize('shape', list(ROW_SHAPES))
@pytest.mark.parametrize('name', ['kB', 'kC'])
def test_cuda_row_sums_shapes(name, shape):
    """kB and kC bit for bit against their plain versions on random rows:
    the script's and the staging shape, one row a bag, rows narrower than a
    warp, rows wider than one thread's float4 and the widest rows taken;
    one launch a call, and the captured launch equals the eager one."""
    nb, rows, m, ck = ROW_SHAPES[shape]
    inp = _noisy(mosaic3.inputs('cuda', nb, rows, m, ck))
    n0 = _kernels.LAUNCHES[name]
    mosaic3.check(inp, (name,))
    assert _kernels.LAUNCHES[name] == n0 + 1
    mosaic3.check_captured(inp, (name,))


@cuda
@pytest.mark.parametrize('name', mosaic3.SHIFTS)
def test_cuda_shift_large_shape(name):
    """kE..kH at the large shape (65,536 x 8 x 128), where they are timed
    against their bound."""
    mosaic3.check(mosaic3.large_inputs('cuda'), (name,))


@cuda
@pytest.mark.parametrize('nsteps, step', [
    (7, stages.STEP),           # fewer CTAs than one SM holds
    (5001, stages.STEP),        # not a multiple of the 132 SMs' CTAs
    (1001, (3, 4)),             # 12 floats a step: a part tile at the end
    (1, (1, 4))])
def test_cuda_p2_grid_edges(nsteps, step):
    """P2 against 2 x bit for bit where the CTAs do not fill the card or
    the last tile; the captured launch equals the eager one."""
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (nsteps,) + step).astype(np.float32), device='cuda')
    out = _kernels.dummy(x)
    assert torch.equal(out.view(torch.int32), (x * 2.).view(torch.int32))
    mosaic3.check_captured(dict(x=x), ('dummy',))


@cuda
def test_cuda_probe_wrappers_check_inputs():
    inp = mosaic3.inputs('cuda')
    with pytest.raises(ValueError, match='ids'):
        _kernels.kB(inp['ids'].long(), inp['table'], inp['x'])
    with pytest.raises(ValueError, match='nbs'):
        _kernels.kA(inp['nbs'][:3], inp['x'])
    with pytest.raises(ValueError, match='x'):
        _kernels.kE(inp['x'][..., :5])
    with pytest.raises(ValueError, match='nbs'):
        _kernels.kD(inp['nbs'].long(), inp['ids'], inp['table'], inp['x'])
    with pytest.raises(ValueError, match='table'):
        _kernels.kD(inp['nbs'], inp['ids'], inp['table'].double(), inp['x'])
    with pytest.raises(ValueError, match='multiple of 4'):
        _kernels.kA(inp['nbs'], torch.ones((mosaic3.NB, 3, 3),
                                           device='cuda'))
    with pytest.raises(ValueError, match='nbs'):
        _kernels.kA(inp['nbs'].cpu(), inp['x'])
    with pytest.raises(ValueError, match='nbs'):
        _kernels.kD(inp['nbs'][:, :0].contiguous(), inp['ids'],
                    inp['table'], inp['x'])
    wide = torch.ones((mosaic3.NB, 1, 4100), device='cuda')
    with pytest.raises(RuntimeError, match='row_sum'):  # > MAXV x CTA_THREADS
        _kernels.kB(inp['ids'], torch.ones((mosaic3.M, 1, 4100),
                                           device='cuda'), wide)


@cuda
@pytest.mark.parametrize('entry,named', [('row_sum', 'ids must be'),
                                         ('trace_stage', 'stage must be')])
def test_cuda_entries_name_what_they_refuse(entry, named):
    """An input that only the C++ entry tests (a bag of ids not (nb, 1, CK)
    for kB, a stage past K3's for P3) raises ValueError naming it, not the
    2^31 limit."""
    inp = mosaic3.inputs('cuda')
    with pytest.raises(ValueError, match=named) as refused:
        if entry == 'row_sum':
            ids = inp['ids']
            _kernels.kB(torch.cat([ids, ids], 1), inp['table'], inp['x'])
        else:
            args = scene(*CASES[0], device='cuda')
            out = _trace._outputs(args.pop('num_blocks'),
                                  args['rays'].shape[1], args['kbuf'],
                                  'cuda')
            _kernels._trace_staged_cuda(7, with_exit=True, out=out, **args)
    assert '2^31' not in str(refused.value)
