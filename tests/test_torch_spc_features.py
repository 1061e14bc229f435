"""The port's SPC features against the JAX package, on the CPU.

Corners, dense octrees, the octree query (with and without parents, float
and integer coords, coords outside the grid), ``to_dense``,
``feature_grids_to_spc``, the dual octree, the trinkets and the ``Spc``
constructors: exact.  Trilinear coefficients and interpolation: 1e-6;
their gradients with respect to the coords and the features: 1e-5 of
max|g|.  Levels 2-6, numpy-seeded inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.ops import spc as J
from kaolin_tpu.rep import Spc as JSpc
from kaolin_tpu_torch.ops import spc as T
from kaolin_tpu_torch.rep import Spc as TSpc

from tests.test_torch_spc_ops import build_both

LEVELS = [2, 4, 6]


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  b.numpy().astype(np.int64))


def _scene(level, seed, n=300):
    pts = np.random.default_rng(seed).integers(0, 2 ** level, (n, 3))
    return build_both(pts, level)


def test_points_to_corners():
    pts = np.random.default_rng(0).integers(0, 64, (50, 3)).astype(np.int16)
    _eq(J.points_to_corners(jnp.asarray(pts)),
        T.points_to_corners(torch.as_tensor(pts)))
    assert T.points_to_corners(torch.as_tensor(pts)).dtype == torch.int16


@pytest.mark.parametrize('level', [1, 3])
def test_create_dense_spc(level):
    oj, lj = J.create_dense_spc(level)
    ot, lt = T.create_dense_spc(level, device='cpu')
    _eq(oj, ot)
    _eq(lj, lt)


@pytest.mark.parametrize('level', LEVELS)
@pytest.mark.parametrize('with_parents', [False, True])
def test_unbatched_query(level, with_parents):
    (oj, _, ej, _), (ot, _, et, pht) = _scene(level, level + 30)
    rng = np.random.default_rng(level)
    r = 2 ** level
    ints = np.concatenate([
        pht[-40:].numpy().astype(np.int32),              # occupied voxels
        rng.integers(0, r, (200, 3)),                    # mostly empty
        rng.integers(-3, r + 3, (60, 3)),                # some outside
        np.array([[-1, 0, 0], [0, r, 0], [0, 0, r - 1]])]).astype(np.int32)
    floats = rng.uniform(-1.2, 1.2, (200, 3)).astype(np.float32)
    for q in (ints, floats):
        rj = J.unbatched_query(oj, ej, jnp.asarray(q), level,
                               with_parents=with_parents)
        rt = T.unbatched_query(ot, et, torch.as_tensor(q), level,
                               with_parents=with_parents)
        assert rt.dtype == torch.int32
        _eq(rj, rt)
    rt = T.unbatched_query(ot, et, torch.as_tensor(ints), level)
    assert (rt[:40] >= 0).all() and (rt[40:] < 0).any()


def test_unbatched_query_int16_coords():
    """The JAX package's conv casts its query coords to int16; the port
    queries int32 and int64 coords to the same indices."""
    (oj, _, ej, _), (ot, _, et, _) = _scene(5, 3, n=2000)
    q = np.random.default_rng(1).integers(-2, 34, (500, 3))
    rj = J.unbatched_query(oj, ej, jnp.asarray(q.astype(np.int16)), 5)
    for dtype in (torch.int32, torch.int64):
        _eq(rj, T.unbatched_query(ot, et, torch.as_tensor(q, dtype=dtype),
                                  5))


@pytest.mark.parametrize('level', LEVELS)
def test_make_dual_and_trinkets(level):
    (_, pyrj, _, phj), (_, pyrt, _, pht) = _scene(level, level + 40)
    dj, pdj = J.unbatched_make_dual(phj, pyrj)
    dt, pdt = T.unbatched_make_dual(pht, pyrt)
    _eq(dj, dt)
    _eq(pdj, pdt)
    assert dt.dtype == torch.int16
    tj, parj = J.unbatched_make_trinkets(phj, pyrj, dj, pdj)
    tt, part = T.unbatched_make_trinkets(pht, pyrt, dt, pdt)
    _eq(tj, tt)
    _eq(parj, part)
    # trinkets are level-local: every corner of a voxel is found in its own
    # level's dual slice
    lo, hi = int(pyrt[1, level]), int(pyrt[1, level + 1])
    dual_l = dt[int(pdt[1, level]):int(pdt[1, level + 1])].long()
    corners = T.points_to_corners(pht[lo:hi].long())
    assert torch.equal(dual_l[tt[lo:hi].long()], corners)


@pytest.mark.parametrize('level', [3, 5])
def test_to_dense(level):
    (_, pyrj, _, phj), (_, pyrt, _, pht) = _scene(level, level + 50)
    n = int(pyrt[0, level])
    feats = np.random.default_rng(2).normal(size=(n, 3)).astype(np.float32)
    dj = J.to_dense(phj, pyrj[None], jnp.asarray(feats), level)
    x = torch.tensor(feats, requires_grad=True)
    dt = T.to_dense(pht, pyrt[None], x, level)
    assert tuple(dt.shape) == (1, 3) + (2 ** level,) * 3
    np.testing.assert_array_equal(np.asarray(dj), dt.detach().numpy())
    g = np.random.default_rng(3).normal(size=dt.shape).astype(np.float32)
    gj = jax.grad(lambda f: jnp.sum(J.to_dense(phj, pyrj[None], f, level)
                                    * g))(jnp.asarray(feats))
    (dt * torch.as_tensor(g)).sum().backward()
    np.testing.assert_array_equal(np.asarray(gj), x.grad.numpy())


def _grids(seed, B=2, C=3, res=8):
    rng = np.random.default_rng(seed)
    grids = rng.normal(size=(B, C, res, res, res)).astype(np.float32)
    grids *= rng.random((B, 1, res, res, res)) < 0.3
    return grids


@pytest.mark.parametrize('masked', [False, True])
def test_feature_grids_to_spc(masked):
    grids = _grids(4)
    masks = (np.random.default_rng(5).random((2, 8, 8, 8)) < 0.2
             if masked else None)
    oj, lj, fj = J.feature_grids_to_spc(jnp.asarray(grids), masks)
    ot, lt, ft = T.feature_grids_to_spc(torch.as_tensor(grids), masks)
    _eq(oj, ot)
    _eq(lj, lt)
    np.testing.assert_array_equal(np.asarray(fj), ft.numpy())


def test_spc_from_features_and_to_dense():
    grids = _grids(6)
    sj = JSpc.from_features(jnp.asarray(grids))
    st = TSpc.from_features(torch.as_tensor(grids))
    _eq(sj.octrees, st.octrees)
    _eq(sj.lengths, st.lengths)
    np.testing.assert_array_equal(np.asarray(sj.features),
                                  st.features.numpy())
    dj, dt = sj.to_dense(), st.to_dense()
    np.testing.assert_array_equal(np.asarray(dj), dt.numpy())
    np.testing.assert_array_equal(dt.numpy(), grids)


@pytest.mark.parametrize('batch_size', [1, 3])
def test_spc_make_dense(batch_size):
    sj = JSpc.make_dense(3, batch_size)
    st = TSpc.make_dense(3, batch_size, device='cpu')
    _eq(sj.octrees, st.octrees)
    _eq(sj.lengths, st.lengths)
    _eq(sj.point_hierarchies, st.point_hierarchies)
    _eq(np.asarray(sj.pyramids), st.pyramids)


def _samples(level, seed, k=3):
    (_, pyrj, _, phj), (_, pyrt, _, pht) = _scene(level, seed)
    dj, pdj = J.unbatched_make_dual(phj, pyrj)
    tj, _ = J.unbatched_make_trinkets(phj, pyrj, dj, pdj)
    dt, pdt = T.unbatched_make_dual(pht, pyrt)
    tt, _ = T.unbatched_make_trinkets(pht, pyrt, dt, pdt)
    rng = np.random.default_rng(seed)
    lo, hi = int(pyrt[1, level]), int(pyrt[1, level + 1])
    pidx = rng.integers(lo, hi, 64).astype(np.int32)
    pidx[::7] = -1
    pts = pht[np.maximum(pidx, 0)].numpy().astype(np.float32)
    coords = ((pts[:, None] + rng.random((64, k, 3))) / 2 ** level * 2 - 1
              ).astype(np.float32)
    n_dual = int(pdt[0, level])
    feats = rng.normal(size=(n_dual, 5)).astype(np.float32)
    return (phj, tj, pht, tt, pidx, coords, feats)


def test_coords_to_trilinear_coeffs():
    level = 4
    phj, _, pht, _, pidx, coords, _ = _samples(level, 60)
    pts = pht[np.maximum(pidx, 0)][:, None]
    cj = J.coords_to_trilinear_coeffs(jnp.asarray(coords),
                                      jnp.asarray(pts.numpy()), level)
    ct = T.coords_to_trilinear_coeffs(torch.as_tensor(coords), pts, level)
    np.testing.assert_allclose(np.asarray(cj), ct.numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ct.sum(-1).numpy(), 1., atol=1e-5)
    with pytest.warns(DeprecationWarning):
        ct2 = T.coords_to_trilinear(torch.as_tensor(coords), pts, level)
    assert torch.equal(ct, ct2)


@pytest.mark.parametrize('level', [3, 5])
def test_unbatched_interpolate_trilinear(level):
    phj, tj, pht, tt, pidx, coords, feats = _samples(level, level + 70)

    def fj(c, f):
        return J.unbatched_interpolate_trilinear(c, jnp.asarray(pidx), phj,
                                                 tj, f, level)

    out_j = fj(jnp.asarray(coords), jnp.asarray(feats))
    c = torch.tensor(coords, requires_grad=True)
    f = torch.tensor(feats, requires_grad=True)
    out_t = T.unbatched_interpolate_trilinear(c, torch.as_tensor(pidx), pht,
                                              tt, f, level)
    np.testing.assert_allclose(np.asarray(out_j), out_t.detach().numpy(),
                               rtol=0, atol=1e-6)
    assert bool((out_t[torch.as_tensor(pidx) < 0] == 0).all())
    g = np.random.default_rng(level).normal(size=out_t.shape).astype(
        np.float32)
    gc_j, gf_j = jax.grad(lambda c_, f_: jnp.sum(fj(c_, f_) * g),
                          argnums=(0, 1))(jnp.asarray(coords),
                                          jnp.asarray(feats))
    (out_t * torch.as_tensor(g)).sum().backward()
    for a, b in ((gc_j, c.grad), (gf_j, f.grad)):
        a = np.asarray(a)
        np.testing.assert_allclose(a, b.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(a).max())
