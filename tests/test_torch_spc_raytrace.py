"""The port's BFS trace and pack ops against the JAX package, on the CPU.

BFS nuggets: ray ids, point ids and their ray-major, near-to-far order
exactly equal; depths within 1e-6 (the same float32 slab test: equal in
practice).  Pack ops: values within 1e-5 relative (segmented scans associate
the sums in another order), gradients of ``cumprod`` and
``exponential_integration`` against ``jax.grad`` within 1e-5 relative.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from kaolin_tpu.render import spc as JR
from kaolin_tpu_torch.render import spc as TR
from kaolin_tpu_torch.utils.testing import camera_grid

from tests.test_torch_spc_ops import build_both

DEPTH_ATOL = 1e-6
RTOL = 1e-5


def _dense_grid(level):
    n = 2 ** level
    return np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing='ij'),
                    -1).reshape(-1, 3)


def _rays(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == 'camera':
        return camera_grid(n)
    if kind == 'inside':            # origins inside the volume
        o = rng.uniform(-0.9, 0.9, (n, 3)).astype(np.float32)
    else:
        o = np.stack([rng.uniform(-0.9, 0.9, n), rng.uniform(-0.9, 0.9, n),
                      np.full(n, 2.)], -1).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[: n // 4, :2] = 0.            # axis-aligned rays
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d.astype(np.float32)


def _bfs_both(j, t, o, d, level, **kw):
    out_j = JR.unbatched_raytrace(j[0], j[3], j[1], j[2], o, d, level, **kw)
    out_t = TR.unbatched_raytrace(t[0], t[3], t[1], t[2], torch.as_tensor(o),
                                  torch.as_tensor(d), level, device='cpu',
                                  **kw)
    return out_j, out_t


def _assert_nuggets(out_j, out_t):
    np.testing.assert_array_equal(np.asarray(out_j[0]), out_t[0].numpy())
    np.testing.assert_array_equal(np.asarray(out_j[1]), out_t[1].numpy())
    np.testing.assert_allclose(np.asarray(out_j[2]), out_t[2].numpy(),
                               rtol=0, atol=DEPTH_ATOL)


@pytest.mark.parametrize('level,npts,rays', [
    (2, None, 'random'), (4, 300, 'camera'), (5, 2000, 'inside'),
    (6, 500, 'random'), (1, None, 'inside')])
def test_bfs_vs_jax(level, npts, rays):
    rng = np.random.default_rng(level)
    pts = (_dense_grid(level) if npts is None
           else rng.integers(0, 2 ** level, (npts, 3)))
    j, t = build_both(pts, level)
    o, d = _rays(rays, 16 if rays == 'camera' else 48, level)
    out_j, out_t = _bfs_both(j, t, o, d, level, with_exit=True)
    assert out_t[0].shape[0] > 0
    _assert_nuggets(out_j, out_t)


def test_bfs_chunks_coarse_band_and_level0():
    level = 3
    j, t = build_both(_dense_grid(level), level)
    o, d = _rays('random', 20, 3)
    full = _bfs_both(j, t, o, d, level, with_exit=True)
    _assert_nuggets(*full)
    for kw in (dict(chunk_rays=6), dict(max_nuggets=32 * 20,
                                        max_nuggets_coarse=16 * 20,
                                        coarse_levels=2, chunk_rays=8)):
        out_j, out_t = _bfs_both(j, t, o, d, level, with_exit=True, **kw)
        _assert_nuggets(out_j, out_t)
        _assert_nuggets(full[0], out_t)
    _assert_nuggets(*_bfs_both(j, t, o, d, 0))


def test_bfs_saturation_padding():
    level = 2
    j, t = build_both(_dense_grid(level), level)
    o = np.array([[-0.9, -0.9, 2.0], [0.1, 0.3, 2.0]], np.float32)
    d = np.array([[0., 0., -1.], [0., 0., -1.]], np.float32)
    kw = dict(trim=False, max_nuggets=5, return_info=True)
    out_j, out_t = _bfs_both(j, t, o, d, level, **kw)
    assert out_t[3].saturated and bool(out_j[3].saturated)
    assert out_t[3].count == int(out_j[3].count)
    _assert_nuggets(out_j[:3], out_t[:3])
    with pytest.warns(RuntimeWarning, match='saturated'):
        TR.unbatched_raytrace(t[0], t[3], t[1], t[2], torch.as_tensor(o),
                              torch.as_tensor(d), level, max_nuggets=5)
    with pytest.raises(ValueError, match='level'):
        TR.unbatched_raytrace(t[0], t[3], t[1], t[2], torch.as_tensor(o),
                              torch.as_tensor(d), 16)


def _packs(seed, n=23, dim=2, positive=False):
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.integers(0, 7, n))
    feats = (rng.uniform(0.2, 1.5, (n, dim)) if positive
             else rng.normal(size=(n, dim))).astype(np.float32)
    feats[5] = 0.                    # a zero inside a pack
    return ids.astype(np.int32), feats


def test_pack_ops_values():
    ids, feats = _packs(0)
    b_j = JR.mark_pack_boundaries(jnp.asarray(ids))
    b_t = TR.mark_pack_boundaries(torch.as_tensor(ids))
    np.testing.assert_array_equal(np.asarray(b_j), b_t.numpy())
    np.testing.assert_array_equal(np.asarray(JR.mark_first_hit(
        jnp.asarray(ids))), TR.mark_first_hit(torch.as_tensor(ids)).numpy())
    f_j, f_t = jnp.asarray(feats), torch.as_tensor(feats)
    np.testing.assert_allclose(np.asarray(JR.diff(f_j, b_j)),
                               TR.diff(f_t, b_t).numpy(), rtol=RTOL)
    np.testing.assert_allclose(np.asarray(JR.sum_reduce(f_j, b_j)),
                               TR.sum_reduce(f_t, b_t).numpy(), rtol=RTOL,
                               atol=1e-6)
    for exclusive in (False, True):
        for reverse in (False, True):
            for op in ('cumsum', 'cumprod'):
                a = getattr(JR, op)(f_j, b_j, exclusive=exclusive,
                                    reverse=reverse)
                b = getattr(TR, op)(f_t, b_t, exclusive=exclusive,
                                    reverse=reverse)
                np.testing.assert_allclose(np.asarray(a), b.numpy(),
                                           rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize('exclusive,reverse', [(False, False), (True, False),
                                               (False, True), (True, True)])
def test_cumprod_grad(exclusive, reverse):
    ids, feats = _packs(1)
    w = np.random.default_rng(2).normal(size=feats.shape).astype(np.float32)
    b = np.array(JR.mark_pack_boundaries(jnp.asarray(ids)))

    def f(x):
        return jnp.sum(JR.cumprod(x, jnp.asarray(b), exclusive=exclusive,
                                  reverse=reverse) * w)

    g_j = np.asarray(jax.grad(f)(jnp.asarray(feats)))
    x = torch.as_tensor(feats).requires_grad_()
    (TR.cumprod(x, torch.as_tensor(b), exclusive=exclusive, reverse=reverse)
     * torch.as_tensor(w)).sum().backward()
    assert torch.isfinite(x.grad).all()
    np.testing.assert_allclose(g_j, x.grad.numpy(), rtol=RTOL, atol=1e-6)


def test_exponential_integration_and_grad():
    ids, feats = _packs(3, dim=3)
    _, tau = _packs(4, dim=1, positive=True)
    b = np.array(JR.mark_pack_boundaries(jnp.asarray(ids)))
    w = np.random.default_rng(5).normal(size=(int(b.sum()), 3)).astype(
        np.float32)

    def f(x, t):
        out, trans = JR.exponential_integration(x, t, jnp.asarray(b))
        return jnp.sum(out * w) + jnp.sum(trans)

    g_j = jax.grad(f, argnums=(0, 1))(jnp.asarray(feats), jnp.asarray(tau))
    out_j, trans_j = JR.exponential_integration(
        jnp.asarray(feats), jnp.asarray(tau), jnp.asarray(b))
    x = torch.as_tensor(feats).requires_grad_()
    t = torch.as_tensor(tau).requires_grad_()
    out_t, trans_t = TR.exponential_integration(x, t, torch.as_tensor(b))
    np.testing.assert_allclose(np.asarray(out_j), out_t.detach().numpy(),
                               rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(np.asarray(trans_j), trans_t.detach().numpy(),
                               rtol=RTOL, atol=1e-6)
    ((out_t * torch.as_tensor(w)).sum() + trans_t.sum()).backward()
    for a, g in zip(g_j, (x.grad, t.grad)):
        np.testing.assert_allclose(np.asarray(a), g.numpy(), rtol=RTOL,
                                   atol=1e-6)
