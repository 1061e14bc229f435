"""Parity of the port's rasterizer and DIB-R renderer with kaolin_tpu.

The JAX side selects with the fused engine in interpret mode (as
``tests/test_fused_rasterizer.py`` does); the port's side with the plain
PyTorch version of its kernel.  Tolerances: face_idx exactly equal;
interpolated features and weights within 1e-5; the soft mask within 2e-5
(see ``test_torch_fused.py`` for why); gradients (same cotangent) within
1e-4 * max|g_jax|.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.render.mesh import dibr as dibr_j
from kaolin_tpu.render.mesh import rasterization as rast_j
from kaolin_tpu_torch.render.mesh import dibr as dibr_t
from kaolin_tpu_torch.render.mesh import rasterization as rast_t

SIZES = [(64, 64), (35, 31), (40, 200)]


def random_scene(seed, F=57, B=2, spread=0.3, C=4):
    rng = np.random.default_rng(seed)
    fvi = rng.uniform(-0.9, 0.9, (B, F, 3, 2)).astype(np.float32)
    cent = fvi.mean(axis=2, keepdims=True)
    fvi = (cent + (fvi - cent) * spread).astype(np.float32)
    fvz = rng.uniform(0.1, 2.0, (B, F, 3)).astype(np.float32)
    feats = rng.standard_normal((B, F, 3, C)).astype(np.float32)
    normals_z = rng.uniform(-0.3, 1., (B, F)).astype(np.float32)
    return fvz, fvi, feats, normals_z


def _assert_grads_close(g_j, g_t):
    for a, b in zip(g_j, g_t):
        a = np.asarray(a)
        assert np.abs(a).max() > 0
        np.testing.assert_allclose(np.asarray(b), a, rtol=0,
                                   atol=1e-4 * np.abs(a).max())


@pytest.mark.parametrize('hw', SIZES)
def test_pixel_coords(hw):
    H, W = hw
    xs_j, ys_j = rast_j.pixel_coords(H, W, 1000.)
    xs_t, ys_t = rast_t.pixel_coords(H, W, 1000., device='cpu')
    np.testing.assert_allclose(xs_t.numpy(), np.asarray(xs_j), rtol=1e-6)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), rtol=1e-6)


def test_bary_weights_gathered():
    rng = np.random.default_rng(0)
    fv = rng.uniform(-500, 500, (50, 3, 2)).astype(np.float32)
    fv[0] = [[0., 0.], [1., 1.], [2., 2.]]         # zero area: norm = 0
    fv[1] = fv[1, ::-1]                            # clockwise
    x0 = rng.uniform(-500, 500, 50).astype(np.float32)
    y0 = rng.uniform(-500, 500, 50).astype(np.float32)
    x0[0] = y0[0] = 0.
    cts = [rng.standard_normal(50).astype(np.float32) for _ in range(3)]
    out_j, vjp = jax.vjp(lambda f: rast_j._bary_weights_gathered(
        f, jnp.asarray(x0), jnp.asarray(y0), 1e-8), jnp.asarray(fv))
    f_t = torch.tensor(fv, requires_grad=True)
    out_t = rast_t._bary_weights_gathered(f_t, torch.as_tensor(x0),
                                          torch.as_tensor(y0), 1e-8)
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-5)
    (g_j,) = vjp(tuple(jnp.asarray(c) for c in cts))
    (g_t,) = torch.autograd.grad(out_t, [f_t],
                                 [torch.as_tensor(c) for c in cts])
    _assert_grads_close([g_j[1:]], [g_t[1:]])    # [0] divides by eps


@pytest.mark.parametrize('hw', SIZES)
def test_rasterize_fused(hw):
    H, W = hw
    fvz, fvi, feats, normals_z = random_scene(sum(hw))
    valid = normals_z >= 0.
    ct = np.random.default_rng(1).standard_normal((2, H, W, 4)).astype(
        np.float32)
    ct_w = np.random.default_rng(2).standard_normal((2, H, W, 3)).astype(
        np.float32)

    def run_j(fvi_, feats_):
        f, idx, w = rast_j.rasterize(H, W, jnp.asarray(fvz), fvi_, feats_,
                                     jnp.asarray(valid), backend='fused',
                                     with_weights=True)
        return (f, w), idx

    (f_j, w_j), vjp, idx_j = jax.vjp(run_j, jnp.asarray(fvi),
                                     jnp.asarray(feats), has_aux=True)
    fvi_t = torch.tensor(fvi, requires_grad=True)
    feats_t = torch.tensor(feats, requires_grad=True)
    f_t, idx_t, w_t = rast_t.rasterize(H, W, torch.as_tensor(fvz), fvi_t,
                                       feats_t, torch.as_tensor(valid),
                                       backend='fused', with_weights=True)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert (idx_t >= 0).any() and (idx_t < 0).any()
    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j),
                               rtol=0, atol=1e-5)
    g_j = vjp((jnp.asarray(ct), jnp.asarray(ct_w)))
    g_t = torch.autograd.grad((f_t, w_t), [fvi_t, feats_t],
                              (torch.as_tensor(ct), torch.as_tensor(ct_w)))
    _assert_grads_close(g_j, g_t)


def test_rasterize_feature_list_and_precomputed():
    H, W = 35, 31
    fvz, fvi, feats, _ = random_scene(7)
    split = [feats[..., :1], feats[..., 1:]]
    idx_j = rast_j.rasterize_selection(H, W, jnp.asarray(fvz),
                                       jnp.asarray(fvi), backend='fused')
    idx_t = rast_t.rasterize_selection(H, W, torch.as_tensor(fvz),
                                       torch.as_tensor(fvi))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    out_j, _ = rast_j.rasterize(H, W, jnp.asarray(fvz), jnp.asarray(fvi),
                                [jnp.asarray(f) for f in split],
                                precomputed_face_idx=idx_j)
    out_t, idx2 = rast_t.rasterize(H, W, torch.as_tensor(fvz),
                                   torch.as_tensor(fvi),
                                   [torch.as_tensor(f) for f in split],
                                   precomputed_face_idx=idx_t)
    assert idx2 is not idx_t and torch.equal(idx2, idx_t)
    assert isinstance(out_t, tuple) and len(out_t) == 2
    for a, b in zip(out_j, out_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize('backend', ['cuda', 'torch', 'pallas'])
def test_unported_backends_raise(backend):
    """Backend names are the JAX package's: 'jnp', 'fused' and 'auto'; any
    other raises the JAX package's ValueError."""
    fvz, fvi, feats, _ = random_scene(0, F=4, B=1)
    with pytest.raises(ValueError, match='valid choices'):
        rast_t.rasterize(8, 8, torch.as_tensor(fvz), torch.as_tensor(fvi),
                         torch.as_tensor(feats), backend=backend)
    with pytest.raises(ValueError, match='valid choices'):
        dibr_t.dibr_rasterization(8, 8, torch.as_tensor(fvz),
                                  torch.as_tensor(fvi),
                                  torch.as_tensor(feats),
                                  torch.ones(1, 4), rast_backend=backend)


@pytest.mark.parametrize('hw', [(64, 64), (40, 200)])
@pytest.mark.parametrize('sigmainv, boxlen', [(7000, 0.02), (70, 0.2)])
def test_dibr_rasterization_fused(hw, sigmainv, boxlen):
    H, W = hw
    fvz, fvi, feats, normals_z = random_scene(3)
    rng = np.random.default_rng(4)
    ct_f = rng.standard_normal((2, H, W, 4)).astype(np.float32)
    ct_m = rng.standard_normal((2, H, W)).astype(np.float32)

    def run_j(fvi_, feats_):
        f, m, idx = dibr_j.dibr_rasterization(
            H, W, jnp.asarray(fvz), fvi_, feats_, jnp.asarray(normals_z),
            sigmainv=sigmainv, boxlen=boxlen, rast_backend='fused')
        return (f, m), idx

    (f_j, m_j), vjp, idx_j = jax.vjp(run_j, jnp.asarray(fvi),
                                     jnp.asarray(feats), has_aux=True)
    fvi_t = torch.tensor(fvi, requires_grad=True)
    feats_t = torch.tensor(feats, requires_grad=True)
    f_t, m_t, idx_t = dibr_t.dibr_rasterization(
        H, W, torch.as_tensor(fvz), fvi_t, feats_t,
        torch.as_tensor(normals_z), sigmainv=sigmainv, boxlen=boxlen)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(m_t.detach().numpy(), np.asarray(m_j),
                               rtol=0, atol=2e-5)
    g_j = vjp((jnp.asarray(ct_f), jnp.asarray(ct_m)))
    g_t = torch.autograd.grad((f_t, m_t), [fvi_t, feats_t],
                              (torch.as_tensor(ct_f), torch.as_tensor(ct_m)))
    _assert_grads_close(g_j, g_t)
