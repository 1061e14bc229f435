"""The probe kernels P1-P3 of the port against the JAX probe scripts.

The scripts (``scripts/probe_r5_mosaic3.py``, ``probe_r5_kbisect.py``) are
imported once, in a module fixture, with their output swallowed; their own
module-level attempts fail on the CPU and are caught by the scripts.  Their
kernels run here through ``pl.pallas_call(..., interpret=True)`` with the
scripts' own specs; ``probe_r5_stages.py`` loads a mesh file at import, so
its ``dummy_kernel`` (P2) is declared again below as the script has it.
The port's side runs the plain PyTorch versions (CPU tensors).

Tolerances:
* P1, P2: bit for bit (sums of integer table rows are exact in float32,
  the other probes add two floats; kA and kD also on random x and table
  rows, where the order of the additions shows);
* P3 stages 1-4: bit for bit (t_near, t_far, pidx, count), as K3 is against
  the JAX trace kernel;
* P3 stages 5-6: t_near and count bit for bit; (t_far, pidx) equal up to
  order within a run of equal t_near, because the TPU's bitonic sort is not
  stable (the port's sort is).

Stages 5 and 6 of the TPU kernel take ~3 s each in interpret mode at 8
blocks (NBS = 8 here, the script has 64).
"""
import contextlib
import functools
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from kaolin_tpu_torch.probes import _kernels, kbisect, mosaic3, stages
from kaolin_tpu_torch.render.spc._trace import STAGES, trace_staged
from kaolin_tpu_torch.utils import measure

SCRIPTS = Path(__file__).resolve().parents[1] / 'scripts'
NBS = 8


def _import_script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f'{name}.py')
    mod = importlib.util.module_from_spec(spec)
    with contextlib.redirect_stdout(io.StringIO()):
        spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope='module')
def scripts():
    return dict(mosaic3=_import_script('probe_r5_mosaic3'),
                kbisect=_import_script('probe_r5_kbisect'))


# ---------------------------------------------------------------------------
# P1

def _jax_p1(m, name, x, nbs=None, table=None):
    """The script's call2d for kernel ``name``, in interpret mode; ``nbs``
    and ``table`` (numpy) replace the script's own."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    NB, R, C, CK = m.NB, m.R, m.C, m.CK
    row = pl.BlockSpec((1, 1, CK), lambda b: (b, 0, 0),
                       memory_space=pltpu.VMEM)
    smem = pl.BlockSpec(memory_space=pltpu.SMEM)
    anyspace = pl.BlockSpec(memory_space=pltpu.ANY)
    slot = (pltpu.VMEM((R, C), jnp.float32), pltpu.SemaphoreType.DMA)
    nbs = m.nbs if nbs is None else jnp.asarray(nbs)
    table = m.table if table is None else jnp.asarray(table)
    extra = {
        'kA': ((nbs,), (smem,), ()),
        'kB': ((m.ids, table), (row, anyspace),
               (pltpu.VMEM((2, R, C), jnp.float32),
                pltpu.SemaphoreType.DMA((2,)))),
        'kC': ((m.ids, table), (row, anyspace), slot),
        'kD': ((nbs, m.ids, table), (smem, row, anyspace), slot),
    }.get(name, ((), (), ()))
    extra_in, extra_specs, scratch = extra
    out = pl.pallas_call(
        getattr(m, name), grid=(NB,),
        in_specs=list(extra_specs) + [
            pl.BlockSpec((1, R, C), lambda b: (b, 0, 0),
                         memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, R, C), lambda b: (b, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((NB, R, C), jnp.float32),
        scratch_shapes=list(scratch), interpret=True,
    )(*extra_in, jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize('x_kind', ['ones', 'random'])
@pytest.mark.parametrize('name', mosaic3.KERNELS)
def test_p1_matches_script(scripts, name, x_kind):
    m = scripts['mosaic3']
    inp = mosaic3.inputs('cpu')
    np.testing.assert_array_equal(inp['table'].numpy(), np.asarray(m.table))
    np.testing.assert_array_equal(inp['ids'].numpy(), np.asarray(m.ids))
    np.testing.assert_array_equal(inp['nbs'].numpy(), np.asarray(m.nbs))
    if x_kind == 'random':
        inp['x'] = torch.as_tensor(np.random.default_rng(2).standard_normal(
            (m.NB, m.R, m.C)).astype(np.float32))
    n0 = _kernels.LAUNCHES[name]
    out = mosaic3.call(name, inp)
    assert _kernels.LAUNCHES[name] == n0        # CPU: the plain version
    ref = _jax_p1(m, name, inp['x'].numpy())
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  ref.view(np.int32))


def _counts(kind, nb, ck):
    """(nb, 2) int32 counts: 'every' uses each of 1..ck in column 0 (a
    seeded permutation), 'ge6' draws 6..ck, where x * n and n repeated
    additions of x round differently."""
    rng = np.random.default_rng(5)
    if kind == 'every':
        col = rng.permutation(np.arange(nb) % ck + 1)
        return np.stack([col, col[::-1]], 1).astype(np.int32)
    return rng.integers(6, ck + 1, (nb, 2)).astype(np.int32)


@pytest.mark.parametrize('counts', ['every', 'ge6'])
@pytest.mark.parametrize('name', ['kA', 'kD'])
def test_p1_counts_match_script(scripts, name, counts):
    """kA and kD (the kernels redesigned for the card) against the script
    on seeded random x and table rows, with every count 1..8 in use, and
    with all counts >= 6: the sums stay in the script's order, bit for
    bit, and kA stays repeated addition (x * n differs there)."""
    m = scripts['mosaic3']
    rng = np.random.default_rng(2)
    x = rng.standard_normal((m.NB, m.R, m.C)).astype(np.float32)
    table = rng.standard_normal((m.M, m.R, m.C)).astype(np.float32)
    nbs = _counts(counts, m.NB, m.CK)
    if counts == 'every':
        assert set(nbs[:, 0]) == set(range(1, m.CK + 1))
    inp = dict(mosaic3.inputs('cpu'), x=torch.as_tensor(x),
               table=torch.as_tensor(table), nbs=torch.as_tensor(nbs))
    n0 = _kernels.LAUNCHES[name]
    out = mosaic3.call(name, inp).numpy()
    assert _kernels.LAUNCHES[name] == n0
    ref = _jax_p1(m, name, x, nbs=nbs, table=table)
    np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))
    if name == 'kA' and counts == 'ge6':
        product = x * nbs[:, 0, None, None].astype(np.float32)
        assert int((product != out).sum()) > out.size // 4


@pytest.mark.parametrize('table_kind', ['script', 'random'])
def test_kc_plain_route_matches_kb_and_script(scripts, table_kind):
    """kC runs on kD's kernel with every count CK: its plain version (kD's
    with counts CK) equals kB's plain version and the script's kC and kB
    in interpret mode, bit for bit, on the script's integer rows and on
    random rows (where the order of the sums shows)."""
    m = scripts['mosaic3']
    inp = mosaic3.inputs('cpu')
    table = None
    if table_kind == 'random':
        table = np.random.default_rng(6).standard_normal(
            (m.M, m.R, m.C)).astype(np.float32)
        inp['table'] = torch.as_tensor(table)
    args = mosaic3._args('kC', inp)
    kc = _kernels.PLAIN['kC'](*args).numpy().view(np.int32)
    kd = _kernels.PLAIN['kD'](torch.full((m.NB, 2), m.CK, dtype=torch.int32),
                              *args).numpy().view(np.int32)
    np.testing.assert_array_equal(kc, kd)
    np.testing.assert_array_equal(
        kc, _kernels.PLAIN['kB'](*args).numpy().view(np.int32))
    for name in ('kC', 'kB'):
        ref = _jax_p1(m, name, inp['x'].numpy(), table=table)
        np.testing.assert_array_equal(kc, ref.view(np.int32))


def test_ring_constants_match_source():
    """kB's ring and P2's tile as the probes report them (``_kernels``)
    are the constants ``csrc/probes.cu`` is built with."""
    from kaolin_tpu_torch import _cuda
    src = (_cuda.CSRC / 'probes.cu').read_text()
    for name in ('KB_SLOTS', 'KB_BARRIERS'):
        assert f'constexpr int {name} = {getattr(_kernels, name)};' in src
    assert 'constexpr int THREADS = 256;' in src
    assert 'constexpr int P2_TILE4 = THREADS;' in src
    assert _kernels.P2_TILE_BYTES == 256 * 16
    assert '#include "tma.cuh"' in src
    assert 'row_sum_kernel' not in src and 'cp.async.cg' not in src


def test_p2_designs_name_the_source_table():
    """The P2 design probe names each entry of its source's table, in
    order, and times nothing but the card."""
    from kaolin_tpu_torch.probes import p2_designs
    src = p2_designs.SOURCE.read_text()
    table = src[src.index('const Design kDesigns[] = {'):]
    table = table[:table.index('};')]
    assert table.count('\n    {') == len(p2_designs.DESIGNS)
    assert '#include "../csrc/tma.cuh"' in src
    with pytest.raises(RuntimeError, match='CUDA'):
        p2_designs.run('cpu')


@pytest.mark.parametrize('what, nbytes, bound', [
    ('P2 65536', 2 * 65536 * 4096, 0.16026),
    ('P2 262144', 2 * 262144 * 4096, 0.64104),
    ('shift large', 2 * mosaic3.LARGE_NB * 4096, 0.16026)])
def test_work_and_bound_from_shapes(what, nbytes, bound):
    """P2's and kE..kH's bytes (x read once, the output written once) and
    bound (bytes over 3.35 TB/s) from their shapes alone."""
    kind, n = what.split()
    if kind == 'P2':
        got, flops = stages.dummy_work(int(n))
        assert flops == int(n) * 1024
    else:
        got, flops = mosaic3.shift_work(mosaic3.LARGE_NB,
                                        (mosaic3.R, mosaic3.C))
        inp = mosaic3.inputs('cpu')
        for name in mosaic3.SHIFTS:     # the script shape through _work
            assert mosaic3._work(name, inp) == mosaic3.shift_work(
                mosaic3.NB, (mosaic3.R, mosaic3.C))
    assert got == nbytes
    ms, by = measure.bound_ms(got, flops)
    assert by == 'bytes' and ms == pytest.approx(bound, abs=5e-6)


def _wrapper_args(name):
    inp = mosaic3.inputs('cpu')
    inp['x'] = torch.as_tensor(np.random.default_rng(4).standard_normal(
        inp['x'].shape).astype(np.float32))
    return mosaic3._args(name, inp) if name != 'dummy' else (inp['x'],)


@pytest.mark.parametrize('name', mosaic3.KERNELS + ('dummy',))
def test_probe_wrappers_on_cpu_run_plain(monkeypatch, name):
    """A wrapper given CPU tensors runs its plain version and launches
    nothing: no C function is bound or called, no launch is counted."""
    class NoLaunch:
        def __getattr__(self, entry):
            raise AssertionError('a probe kernel was launched for CPU '
                                 'tensors')

    def no_bind():
        raise AssertionError('the probe kernels were built or loaded for '
                             'CPU tensors')

    monkeypatch.setattr(_kernels, '_ext', NoLaunch())
    monkeypatch.setattr(_kernels, '_bind', no_bind)
    args = _wrapper_args(name)
    before = dict(_kernels.LAUNCHES)
    out = getattr(_kernels, name)(*args)
    assert _kernels.LAUNCHES == before
    ref = _kernels.PLAIN[name](*args)
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  ref.numpy().view(np.int32))


@pytest.mark.parametrize('what', ['kA', 'kD', 'kA library', 'kD library'])
@pytest.mark.parametrize('timer', ['device_ms', 'replayed'])
def test_graph_timers_raise_without_cuda(monkeypatch, timer, what):
    """device_ms (and the capture check) time the card only: without CUDA
    they raise before calling the function, never timing the CPU."""
    name, *lib = what.split()
    inp = mosaic3.inputs('cpu')
    fn = (mosaic3._library(name, inp) if lib
          else (lambda: mosaic3.call(name, inp)))
    calls = []
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='is_available'):
        if timer == 'device_ms':
            measure.device_ms(lambda: calls.append(fn()), 5)
        else:
            measure.replayed(lambda: calls.append(fn()))
    assert calls == []


# ---------------------------------------------------------------------------
# P2

def dummy_kernel(x_ref, o_ref):                 # probe_r5_stages.py:166
    o_ref[0] = x_ref[0] * 2.


@pytest.mark.parametrize('seed', [None, 3])
def test_p2_dummy_matches_script(seed):
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    nsteps = 16
    x = stages.dummy_inputs(nsteps, 'cpu', seed)
    spec = pl.BlockSpec((1, 8, 128), lambda b: (b, 0, 0),
                        memory_space=pltpu.VMEM)
    ref = pl.pallas_call(
        dummy_kernel, grid=(nsteps,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((nsteps, 8, 128), jnp.float32),
        interpret=True)(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(
        _kernels.dummy(x).numpy().view(np.int32),
        np.asarray(ref).view(np.int32))


# ---------------------------------------------------------------------------
# P3

def _jax_staged(kb, stage, nb, rays, cells):
    """The script's run_stage at NBS = len(nb), in interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu
    RT, CW, KBUF, CKB = kb.RT, kb.CW, kb.KBUF, kb.CKB
    nbs = nb.shape[0]
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(nbs, CKB),
        in_specs=[
            pl.BlockSpec((1, RT, 8), lambda b, j, *_: (b, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, 8, CW),
                         lambda b, j, *_: (b * CKB + j, 0, 0, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=[pl.BlockSpec((1, RT, KBUF), lambda b, j, *_: (b, 0, 0),
                                memory_space=pltpu.VMEM)] * 3 + [
            pl.BlockSpec((1, RT, 1), lambda b, j, *_: (b, 0, 0),
                         memory_space=pltpu.VMEM)],
    )
    out = pl.pallas_call(
        functools.partial(kb.staged_kernel, stage=stage),
        grid_spec=grid_spec,
        out_shape=[jax.ShapeDtypeStruct((nbs, RT, KBUF), jnp.float32),
                   jax.ShapeDtypeStruct((nbs, RT, KBUF), jnp.float32),
                   jax.ShapeDtypeStruct((nbs, RT, KBUF), jnp.int32),
                   jax.ShapeDtypeStruct((nbs, RT, 1), jnp.int32)],
        interpret=True,
    )(jnp.asarray(nb), jnp.asarray(rays), jnp.asarray(cells))
    return [np.asarray(o) for o in out]


def _canonical(tn, tf, pi):
    """Each row's entries ordered by (t_near, pidx, t_far bits)."""
    order = np.lexsort((tf.view(np.int32), pi, tn), axis=-1)
    return [np.take_along_axis(a, order, -1) for a in (tn, tf, pi)]


SCENES = {'script': lambda: kbisect.probe_inputs(NBS),
          'hits': lambda: kbisect.hit_scene(NBS)}


@pytest.fixture(scope='module')
def p3_scenes():
    return {k: f() for k, f in SCENES.items()}


@pytest.mark.parametrize('scene', list(SCENES))
@pytest.mark.parametrize('stage', STAGES)
def test_p3_stage_matches_script(scripts, p3_scenes, stage, scene):
    nb, rays, cells = p3_scenes[scene]
    ref = _jax_staged(scripts['kbisect'], stage, nb, rays, cells)
    args = kbisect.from_probe_layout(nb, rays, cells, 'cpu')
    tn, tf, pi, cnt = (x.numpy() for x in trace_staged(
        stage, with_exit=True, **args))
    np.testing.assert_array_equal(cnt, ref[3][..., 0])
    np.testing.assert_array_equal(tn.view(np.int32), ref[0].view(np.int32))
    if stage >= 5:
        mine, theirs = _canonical(tn, tf, pi), _canonical(*ref[:3])
    else:
        mine, theirs = (tn, tf, pi), ref[:3]
    np.testing.assert_array_equal(mine[1].view(np.int32),
                                  theirs[1].view(np.int32))
    np.testing.assert_array_equal(mine[2], theirs[2])
    if scene == 'hits':
        assert int(cnt.max()) > kbisect.KBUF and int((cnt > 64).sum()) > 0
        assert int((cnt == 0).sum()) > 0
    else:
        assert int(cnt.sum()) == 0          # the script's rays hit nothing


# ---------------------------------------------------------------------------
# the probe entry points, on the CPU (plain versions, small sizes)

def test_mosaic3_run_cpu():
    res = mosaic3.run('cpu', table_rows=40)
    assert set(res['max_abs_err']) == set(mosaic3.KERNELS)
    assert all(v == 0. for v in res['max_abs_err'].values())
    assert res['script'] is None and res['staging'] is None  # not timed
    assert res['large'] is None


def test_stages_run_cpu():
    res = stages.run('cpu')
    assert res['trace'] is None                 # not timed on the CPU
    assert res['dummy'][16]['max_abs_err'] == 0.
    d = res['dummy'][16]
    for key in ('ms', 'device_ms', 'library_ms', 'library_device_ms',
                'plain_ms', 'ns_per_step', 'device_ns_per_step',
                'peak_gib'):
        assert key in d and d[key] is None      # no time from the CPU
    assert (d['bytes'], d['flops']) == stages.dummy_work(16)
    assert d['bound_by'] == 'bytes' and d['bound_ms'] > 0
    c = res['counts']
    assert 0 < c['active_blocks'] < c['blocks'] and c['hits'] > 0
    assert not c['saturated']


def test_kbisect_run_cpu():
    res = kbisect.run('cpu')
    assert res['scenes']['probe']['hits'] == 0
    assert res['scenes']['hits']['rays_over_kbuf'] > 0
    assert res['spc']['hits'] > 0 and 'stages' not in res
