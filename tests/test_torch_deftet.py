"""The port's DefTet sparse renderer against kaolin_tpu's.

Both engines (the default all-faces selection and the binned one,
``max_candidates`` set) and the naive dense reference, on the scenes of
``tests/test_deftet.py`` and on random scenes, JAX side on the CPU.
Tolerances: depth-sorted face_idx equal; features within 1e-5; gradients
with respect to the face inputs (vertices in image space, z, features)
within 1e-4 * max|g_jax| (below 1e-6 where the gradient is 0 in exact
arithmetic and both carry rounding noise).  ``pixel_coords`` carries no gradient in the
port (the JAX default engine passes one), so it is not compared.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.render.mesh import deftet as dt_j
from kaolin_tpu_torch.render.mesh import deftet as dt_t

# a gradient that is 0 in exact arithmetic (a face's constant feature, or
# z, which only selects and orders) comes out as rounding noise of ~1e-7
ZERO_GRAD = 1e-6


def two_layer_scene():
    fvi = np.array([[
        [[-0.5, -0.5], [0.5, -0.5], [0.0, 0.5]],
        [[-0.6, -0.6], [0.6, -0.6], [0.0, 0.6]],
    ]], np.float32)
    fvz = np.array([[[-1., -1., -1.], [-2., -2., -2.]]], np.float32)
    ff = np.array([[
        [[1., 0.], [1., 0.], [1., 0.]],
        [[0., 1.], [0., 1.], [0., 1.]],
    ]], np.float32)
    return fvi, fvz, ff


def random_scene(seed, B=2, F=120, P=70, half=0.2, D=3):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-0.8, 0.8, (B, F, 1, 2))
    fvi = (centers + rng.uniform(-half, half, (B, F, 3, 2))).astype(
        np.float32)
    fvz = (-rng.uniform(0.5, 3.0, (B, F, 1)).astype(np.float32)
           * np.ones((1, 1, 3), np.float32)
           + rng.uniform(-0.05, 0.05, (B, F, 3)).astype(np.float32))
    ff = rng.randn(B, F, 3, D).astype(np.float32)
    pixels = rng.uniform(-1., 1., (B, P, 2)).astype(np.float32)
    ranges = np.tile(np.array([[[-1e4, 0.]]], np.float32), (B, P, 1))
    return pixels, ranges, fvz, fvi, ff


def run_both(pixels, ranges, fvz, fvi, ff, naive=False, **kw):
    """Forward on both packages; returns (feats_j, idx_j, feats_t, idx_t,
    grads_j, grads_t) with gradients of sum(sin(feats)) w.r.t. (fvi, fvz,
    ff)."""
    fn_j = dt_j._naive_deftet_sparse_render if naive else \
        dt_j.deftet_sparse_render
    fn_t = dt_t._naive_deftet_sparse_render if naive else \
        dt_t.deftet_sparse_render
    is_list = isinstance(ff, list)

    def loss_j(fvi_, fvz_, ff_):
        feats, idx = fn_j(jnp.asarray(pixels), jnp.asarray(ranges), fvz_,
                          fvi_, ff_, **kw)
        flat = jnp.concatenate(feats, -1) if is_list else feats
        return jnp.sum(jnp.sin(flat)), (feats, idx)

    args_j = (jnp.asarray(fvi), jnp.asarray(fvz),
              [jnp.asarray(f) for f in ff] if is_list else jnp.asarray(ff))
    (_, (feats_j, idx_j)), g_j = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(*args_j)
    fvi_t = torch.tensor(fvi, requires_grad=True)
    fvz_t = torch.tensor(fvz, requires_grad=True)
    ff_t = ([torch.tensor(f, requires_grad=True) for f in ff] if is_list
            else torch.tensor(ff, requires_grad=True))
    feats_t, idx_t = fn_t(torch.as_tensor(pixels), torch.as_tensor(ranges),
                          fvz_t, fvi_t, ff_t, **kw)
    flat = torch.cat(list(feats_t), -1) if is_list else feats_t
    leaves = [fvi_t, fvz_t] + (ff_t if is_list else [ff_t])
    g_t = torch.autograd.grad(torch.sin(flat).sum(), leaves,
                              allow_unused=True)
    g_j = list(g_j[:2]) + (list(g_j[2]) if is_list else [g_j[2]])
    return feats_j, idx_j, feats_t, idx_t, g_j, g_t


def check(feats_j, idx_j, feats_t, idx_t, g_j, g_t, grads=True):
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    fj = feats_j if isinstance(feats_j, (list, tuple)) else [feats_j]
    ft = feats_t if isinstance(feats_t, (list, tuple)) else [feats_t]
    assert len(fj) == len(ft)
    for a, b in zip(fj, ft):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=0, atol=1e-5)
    if grads:
        moved = 0
        for a, b in zip(g_j, g_t):
            a = np.asarray(a)
            b = np.zeros_like(a) if b is None else b.numpy()
            scale = np.abs(a).max()
            if scale < ZERO_GRAD:   # zero but for rounding in both
                assert np.abs(b).max() < ZERO_GRAD
                continue
            moved += 1
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-4 * scale)
        assert moved >= 1


ENGINES = {'default': {}, 'binned': dict(max_candidates=64, pixel_chunk=8)}


@pytest.mark.parametrize('engine', list(ENGINES))
@pytest.mark.parametrize('knum', [4, 1])
def test_two_layers_and_truncation(engine, knum):
    fvi, fvz, ff = two_layer_scene()
    pixels = np.array([[[0., 0.], [0.9, 0.9], [0.05, 0.1]]], np.float32)
    ranges = np.array([[[-1e4, 0.]] * 3], np.float32)
    out = run_both(pixels, ranges, fvz, fvi, ff, knum=knum,
                   **ENGINES[engine])
    check(*out)
    want = [0, 1, -1, -1][:knum]
    np.testing.assert_array_equal(out[3].numpy()[0, 0], want)
    np.testing.assert_array_equal(out[3].numpy()[0, 1], [-1] * knum)


@pytest.mark.parametrize('engine', list(ENGINES))
def test_render_range_filter(engine):
    fvi, fvz, ff = two_layer_scene()
    pixels = np.array([[[0., 0.], [0.1, -0.2]]], np.float32)
    ranges = np.array([[[-1.5, 0.], [-3., -1.5]]], np.float32)
    out = run_both(pixels, ranges, fvz, fvi, ff, knum=4, **ENGINES[engine])
    check(*out)
    np.testing.assert_array_equal(out[3].numpy()[0],
                                  [[0, -1, -1, -1], [1, -1, -1, -1]])


@pytest.mark.parametrize('engine', list(ENGINES))
def test_feature_list(engine):
    fvi, fvz, ff = two_layer_scene()
    pixels = np.array([[[0., 0.], [0.2, 0.]]], np.float32)
    ranges = np.array([[[-1e4, 0.]] * 2], np.float32)
    out = run_both(pixels, ranges, fvz, fvi, [ff, ff * 2.], knum=2,
                   **ENGINES[engine])
    check(*out)
    np.testing.assert_allclose(out[2][1].detach().numpy(),
                               out[2][0].detach().numpy() * 2., atol=1e-6)


@pytest.mark.parametrize('engine', list(ENGINES))
@pytest.mark.parametrize('knum', [3, 16, 64])
def test_random_scene(engine, knum):
    pixels, ranges, fvz, fvi, ff = random_scene(11, half=0.4)
    kw = dict(ENGINES[engine], knum=knum)
    if engine == 'binned':
        kw.update(max_candidates=fvz.shape[1], pixel_chunk=32)
    out = run_both(pixels, ranges, fvz, fvi, ff, **kw)
    check(*out)
    hits = (out[3] >= 0).sum(-1)
    assert hits.max() == min(knum, 5) and (hits == 0).any()


@pytest.mark.parametrize('engine', list(ENGINES))
def test_valid_faces_and_ranges(engine):
    pixels, ranges, fvz, fvi, ff = random_scene(7, F=60, P=40, half=0.35,
                                                D=4)
    ranges = ranges.copy()
    ranges[:, ::3] = [-2., -0.8]
    B, F = fvz.shape[:2]
    mask = np.tile((np.arange(F) % 3 != 0)[None], (B, 1))
    kw = dict(ENGINES[engine], knum=8, valid_faces=mask)
    out = run_both(pixels, ranges, fvz, fvi, [ff, ff * -1.5], **kw)
    check(*out)
    fi = out[3].numpy()
    assert (fi >= 0).any() and (fi[fi >= 0] % 3 != 0).all()


def test_binned_cap_overflow():
    """An undersized cap drops the same face chunks in both packages."""
    pixels, ranges, fvz, fvi, ff = random_scene(3, F=400, P=300, half=0.3)
    kw = dict(knum=8, max_candidates=64, pixel_chunk=64)
    out = run_both(pixels, ranges, fvz, fvi, ff, **kw)
    check(*out)
    full = dt_t.deftet_sparse_render(
        torch.as_tensor(pixels), torch.as_tensor(ranges),
        torch.as_tensor(fvz), torch.as_tensor(fvi), torch.as_tensor(ff),
        knum=8)[1]
    assert not torch.equal(full, out[3]), 'the cap dropped some faces'


def test_naive_reference():
    pixels, ranges, fvz, fvi, ff = random_scene(7, F=60, P=40, half=0.35,
                                                D=4)
    out = run_both(pixels, ranges, fvz, fvi, ff, naive=True, knum=64)
    check(*out)
    feats_k, idx_k = dt_t.deftet_sparse_render(
        torch.as_tensor(pixels), torch.as_tensor(ranges),
        torch.as_tensor(fvz), torch.as_tensor(fvi), torch.as_tensor(ff),
        knum=64)
    assert torch.equal(idx_k, out[3])
    torch.testing.assert_close(feats_k, out[2].detach(), rtol=0, atol=1e-4)


def test_pixel_coords_get_no_gradient():
    pixels, ranges, fvz, fvi, ff = random_scene(5, B=1, F=30, P=20)
    pc = torch.tensor(pixels, requires_grad=True)
    for kw in ({}, dict(max_candidates=64)):
        feats, _ = dt_t.deftet_sparse_render(
            pc, torch.as_tensor(ranges), torch.as_tensor(fvz),
            torch.tensor(fvi, requires_grad=True), torch.as_tensor(ff),
            knum=8, **kw)
        assert feats.requires_grad
        (g,) = torch.autograd.grad(feats.sum(), [pc], allow_unused=True)
        assert g is None
