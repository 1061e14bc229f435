"""The port's coherent-ray engines against the JAX package, on the CPU.

* the cell table: exactly equal;
* the port's ``'mosaic'`` engine (K3's plain version on the CPU) against the
  JAX ``'mosaic'`` engine in interpret mode on one scene (one call, 12 s)
  and on a table whose rows hold -1 anywhere (one more call);
* against the JAX ``'xla'`` engine (compiled) on random octrees, including
  a dense one whose rays hit more than 64 voxels, saturated and not;
* the port's ``'xla'`` engine against JAX's;
* saturation, miss-all and ``grid_shape`` cases as in ``test_spc_raster.py``,
  and the port's engine against the port's BFS (hit sets, grazing extras
  allowed).

Tolerance: exact (t_near, t_far, pidx, count and the saturation flag): both
packages evaluate the slab test with the same float32 operations, and a
comparison of the results found no rounding difference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.render.spc import raster as JRa
from kaolin_tpu_torch.render.spc import raster as TRa
from kaolin_tpu_torch.render.spc import unbatched_raytrace
from kaolin_tpu_torch.utils.testing import camera_grid

from tests.test_torch_spc_ops import build_both


def _trace_both(j, t, o, d, level, **kw):
    """JAX and port ``unbatched_raytrace_coherent`` on the same inputs; a
    ``cell_table`` kwarg is a (JAX, port) pair."""
    kw_j, kw_t = dict(kw), dict(kw)
    if 'cell_table' in kw:
        kw_j['cell_table'], kw_t['cell_table'] = kw['cell_table']
    jax_engine = kw_j.pop('jax_engine', kw_j.get('engine'))
    kw_t.pop('jax_engine', None)
    kw_j['engine'] = jax_engine
    hj = JRa.unbatched_raytrace_coherent(j[0], j[3], j[1], j[2], o, d, level,
                                         **kw_j)
    ht = TRa.unbatched_raytrace_coherent(t[0], t[3], t[1], t[2],
                                         torch.as_tensor(o),
                                         torch.as_tensor(d), level,
                                         device='cpu', **kw_t)
    return hj, ht


def assert_hits_equal(hj, ht, with_exit=True):
    for name in ('t_near', 't_far', 'pidx', 'count', 'saturated'):
        if name == 't_far' and not with_exit:
            continue
        np.testing.assert_array_equal(np.asarray(getattr(hj, name)),
                                      getattr(ht, name).numpy(), err_msg=name)


def random_scene(level, n, seed, lo=0, hi=None):
    rng = np.random.default_rng(seed)
    pts = rng.integers(lo, hi or 2 ** level, size=(n, 3))
    return build_both(pts, level)


def diagonal_grid(side, extent=0.3):
    """Coherent rays along the volume's diagonal (~3x the voxels of an
    axis-aligned ray)."""
    o, d = camera_grid(side, z=-2.5, spread=0.05, extent=extent)
    o[:, :2] -= 2.5
    d = d + np.array([1., 1., 0.], np.float32)
    return o, (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


@pytest.fixture(scope='module')
def interpret_scene():
    """The one interpret-mode call of the JAX kernel (level 4, 256 rays,
    edge rays missing everything, with exit depths)."""
    level = 4
    j, t = random_scene(level, 300, 14, lo=2, hi=2 ** level - 2)
    tables = (JRa.build_cell_table(j[3], j[1], level, cell_shift=2,
                                   cell_width=64),
              TRa.build_cell_table(t[3], t[1], level, cell_shift=2,
                                   cell_width=64))
    o, d = camera_grid(16, extent=1.2)
    hj, ht = _trace_both(j, t, o, d, level, rays_per_tile=16,
                         engine='mosaic', cell_table=tables,
                         segments=((None, 64),), knum=64, with_exit=True)
    return hj, ht, tables


@pytest.mark.parametrize('shift,width', [(2, 64), (3, 192), (1, 8), (2, 4)])
def test_cell_table_equal(shift, width):
    level = 5
    j, t = random_scene(level, 3000, 1)
    tj = JRa.build_cell_table(j[3], j[1], level, cell_shift=shift,
                              cell_width=width)
    tt = TRa.build_cell_table(t[3], t[1], level, cell_shift=shift,
                              cell_width=width)
    assert int(tj.overflow) == tt.overflow
    assert tt.overflow > 0 if width == 4 else tt.overflow == 0
    # with overflow the JAX table writes a dropped voxel into the dump row;
    # the port leaves it out
    np.testing.assert_array_equal(np.asarray(tj.rows)[:-1], tt.rows[:-1])
    np.testing.assert_array_equal(np.asarray(tj.blo), tt.blo)
    np.testing.assert_array_equal(np.asarray(tj.bhi), tt.bhi)
    assert (tj.level, tj.offset) == (tt.level, tt.offset)


def test_mosaic_vs_jax_mosaic_interpret(interpret_scene):
    hj, ht, tables = interpret_scene
    assert tables[1].overflow == 0
    assert int(ht.count.sum()) > 0 and (ht.count == 0).any()
    assert not bool(ht.saturated)
    assert_hits_equal(hj, ht)


def test_mosaic_vs_jax_mosaic_interpret_punched_rows():
    """Cell rows with -1 anywhere (holes in the middle, emptied rows) beside
    a row that is live to its last slot: the port's engine against the JAX
    kernel in interpret mode on the same table.  No two voxels of a row are
    equal here: among equal depths the JAX kernel's bitonic sort keeps no
    order, so tied hits are held against the plain version's stable order
    in ``test_torch_spc_kernels.py`` only."""
    level = 4
    rng = np.random.default_rng(15)
    cell = np.stack(np.meshgrid(*[np.arange(4, 8)] * 3, indexing='ij'),
                    -1).reshape(-1, 3)              # one cell, all 64 voxels
    j, t = build_both(np.concatenate(
        [rng.integers(0, 2 ** level, size=(1200, 3)), cell]), level)
    tj = JRa.build_cell_table(j[3], j[1], level, cell_shift=2, cell_width=64)
    tt = TRa.build_cell_table(t[3], t[1], level, cell_shift=2, cell_width=64)
    rows = tt.rows.numpy().copy()
    R, _, cw = rows.shape
    idx = np.arange(R)
    full = (rows[:, 3] >= 0).all(1)
    holes = (rng.random((R, cw)) < 0.25) & (idx % 3 == 1)[:, None]
    holes |= (idx % 7 == 3)[:, None]
    rows[:, 3][holes & ~full[:, None]] = -1
    live = rows[:-1, 3] >= 0
    last = (live * np.arange(1, cw + 1)).max(1)
    assert (live.sum(1) < last).any() and live.all(1).any()
    assert (~live.any(1) & (tt.rows[:-1, 3] >= 0).any(1).numpy()).any()
    tables = (tj._replace(rows=jnp.asarray(rows)),
              tt._replace(rows=torch.as_tensor(rows)))
    o, d = camera_grid(16)
    hj, ht = _trace_both(j, t, o, d, level, rays_per_tile=16,
                         engine='mosaic', cell_table=tables,
                         segments=((None, 64),), knum=64, with_exit=True)
    assert int(ht.count.sum()) > 0 and not bool(ht.saturated)
    assert_hits_equal(hj, ht)
    # voxels of the full row are among the hits, and punched ones are not
    hit = set(ht.pidx[ht.pidx >= 0].tolist())
    gone = set((tt.rows[:, 3].numpy()[holes & ~full[:, None]]
                + tt.offset).tolist()) - {tt.offset - 1}
    assert hit & set((rows[full, 3] + tt.offset).ravel().tolist())
    assert gone and not hit & gone


@pytest.mark.parametrize('grid_shape', [None, (24, 24)])
def test_mosaic_engine_gives_k3_the_level_offset(monkeypatch, grid_shape):
    """The ``'mosaic'`` engine hands the leaf level's offset to K3, which
    writes the final pidx: the hits equal K3's offset-0 result moved by a
    ``where`` pass, and every live pidx lies in the leaf level."""
    level = 4
    _, t = random_scene(level, 300, 16)
    o, d = camera_grid(24)
    off, V = int(t[1][1, level]), int(t[1][0, level])
    seen = []
    k3 = TRa._trace.trace

    def spy(**kw):
        seen.append(kw['pidx_offset'])
        return k3(**kw)

    def run():
        return TRa.unbatched_raytrace_coherent(
            t[0], t[3], t[1], t[2], torch.as_tensor(o), torch.as_tensor(d),
            level, rays_per_tile=16, engine='mosaic', device='cpu',
            grid_shape=grid_shape)

    monkeypatch.setattr(TRa._trace, 'trace', spy)
    hits = run()
    monkeypatch.setattr(TRa._trace, 'trace',
                        lambda **kw: k3(**dict(kw, pidx_offset=0)))
    base = run()
    assert seen == [off] and off > 0
    live = hits.pidx >= 0
    assert int(live.sum()) == int(hits.count.sum()) > 0
    assert bool(((hits.pidx[live] >= off) & (hits.pidx[live] < off + V)).all())
    assert torch.equal(hits.pidx,
                       torch.where(base.pidx >= 0, base.pidx + off, -1))
    for a, b in zip(hits, base):
        if a is not hits.pidx:
            assert torch.equal(a, b)


@pytest.mark.parametrize('trim', [True, False])
def test_hits_to_nuggets(interpret_scene, trim):
    hj, ht, _ = interpret_scene
    for a, b in zip(JRa.hits_to_nuggets(hj, trim=trim),
                    TRa.hits_to_nuggets(ht, trim=trim)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


SCENES = [  # level, points, seed, rays
    (4, 300, 16, 'camera'),
    (6, 400, 24, 'camera'),
    (5, 60000, 5, 'diagonal'),       # dense: up to 85 hits per ray
]


def _scene(level, n, seed, rays):
    j, t = random_scene(level, n, seed)
    o, d = camera_grid(24) if rays == 'camera' else diagonal_grid(16)
    return j, t, o, d


@pytest.mark.parametrize('scene', SCENES)
@pytest.mark.parametrize('knum', [64, 256])
def test_mosaic_vs_jax_xla(scene, knum):
    """The port's cell-table engine against the JAX morton-chunk engine.
    Both keep, per ray, the first knum hits in morton order and sort them;
    with knum = the k-buffer width (64, 256) even a saturated trace
    agrees."""
    level = scene[0]
    j, t, o, d = _scene(*scene)
    table = TRa.build_cell_table(t[3], t[1], level, cell_shift=2,
                                 cell_width=64)
    hj, ht = _trace_both(
        j, t, o, d, level, rays_per_tile=16, knum=knum, engine='mosaic',
        jax_engine='xla', max_tile_voxels=64 * 1024,
        cell_table=(None, table), segments=((None, 4096),),
        max_super_voxels=64 * 4096)
    assert_hits_equal(hj, ht)
    assert int(ht.count.max()) > 0
    if scene[3] == 'diagonal':
        assert int(ht.count.max()) > 64
        assert bool(ht.saturated) == (knum == 64)


@pytest.mark.parametrize('scene', SCENES[:2])
def test_xla_engine_vs_jax(scene):
    level = scene[0]
    j, t, o, d = _scene(*scene)
    hj, ht = _trace_both(j, t, o, d, level, rays_per_tile=16, knum=64,
                         engine='xla', max_tile_voxels=512)
    assert_hits_equal(hj, ht)


@pytest.mark.parametrize('engine', ['mosaic', 'xla'])
def test_saturation_flag(engine):
    level = 5
    rng = np.random.default_rng(3)
    j, t = build_both(rng.integers(0, 2 ** level, size=(2000, 3)), level)
    # incoherent rays: beams cover everything -> candidate caps overflow
    o = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kw = dict(rays_per_tile=32, max_tile_voxels=64, engine=engine,
              segments=((None, 4),))
    hj, ht = _trace_both(j, t, o, d, level, jax_engine='xla', **kw)
    assert bool(hj.saturated) and bool(ht.saturated)


@pytest.mark.parametrize('engine', ['mosaic', 'xla'])
def test_miss_all(engine):
    j, t = build_both(np.zeros((1, 3), np.int64), 3)
    o = np.full((32, 3), 3., np.float32)
    d = np.ones((32, 3), np.float32)
    hj, ht = _trace_both(j, t, o, d, 3, rays_per_tile=16, engine=engine,
                         jax_engine='xla')
    assert int(ht.count.sum()) == 0 and bool((ht.pidx == -1).all())
    assert not bool(ht.saturated)
    assert_hits_equal(hj, ht)


@pytest.mark.parametrize('engine', ['mosaic', 'xla'])
def test_grid_shape_block_tiling(engine):
    level = 4
    j, t = random_scene(level, 200, 7)
    o, d = camera_grid(16)
    kw = dict(rays_per_tile=16, max_tile_voxels=512, engine=engine,
              jax_engine='xla')
    _, rows = _trace_both(j, t, o, d, level, **kw)
    hj, blk = _trace_both(j, t, o, d, level, grid_shape=(16, 16), **kw)
    assert torch.equal(rows.count, blk.count)
    assert torch.equal(rows.t_near, blk.t_near)
    assert int(blk.count.sum()) > 0
    assert_hits_equal(hj, blk)


def test_mosaic_vs_port_bfs_axis_aligned():
    """Axis-aligned rays (two zero direction components), origins inside
    the volume: hit sets equal to the BFS's up to grazing extras, depths
    equal."""
    level = 3
    pts = np.stack(np.meshgrid(*[np.arange(8)] * 3, indexing='ij'),
                   -1).reshape(-1, 3)
    _, t = build_both(pts[(pts.sum(-1) % 3) == 0], level)
    side = 8
    ys, xs = np.meshgrid(np.linspace(-0.95, 0.95, side),
                         np.linspace(-0.95, 0.95, side), indexing='ij')
    o = torch.as_tensor(np.stack([xs.ravel(), ys.ravel(),
                                  np.full(side * side, -0.5)], -1),
                        dtype=torch.float32)
    d = torch.tensor([[0., 0., 1.]]).repeat(side * side, 1)
    r1, p1, d1 = unbatched_raytrace(t[0], t[3], t[1], t[2], o, d, level,
                                    with_exit=True, device='cpu')
    hits = TRa.unbatched_raytrace_coherent(t[0], t[3], t[1], t[2], o, d,
                                           level, rays_per_tile=16, knum=16,
                                           device='cpu',
                                           cell_table=TRa.build_cell_table(
                                               t[3], t[1], level,
                                               cell_shift=1, cell_width=8))
    assert not bool(hits.saturated)
    r2, p2, d2 = TRa.hits_to_nuggets(hits)
    a = {(int(r), int(p)): tuple(x) for r, p, x in zip(r1, p1, d1.tolist())}
    b = {(int(r), int(p)): tuple(x) for r, p, x in zip(r2, p2, d2.tolist())}
    assert len(a) > 0 and set(a) <= set(b)
    assert all(b[k][1] - b[k][0] < 1e-5 for k in set(b) - set(a))
    assert all(a[k] == b[k] for k in a)
