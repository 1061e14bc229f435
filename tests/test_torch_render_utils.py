"""Parity of the port's render utilities and mask_iou with kaolin_tpu.

Same numpy-seeded inputs through both packages.  Values within 1e-5,
gradients (same cotangent) within 1e-4 * max|g_jax|.  The texture tests
put uvs at and beyond the border, where the clamp and border padding
decide both the value and the gradient.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.metrics import render as metrics_j
from kaolin_tpu.render import camera as cam_j
from kaolin_tpu.render.mesh import utils as utils_j
from kaolin_tpu_torch.metrics import render as metrics_t
from kaolin_tpu_torch.render.mesh import utils as utils_t

RNG = np.random.default_rng(0)


def _f32(*shape, scale=1.):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _grads(fn_j, fn_t, args, ct):
    """(out_j, out_t, grads_j, grads_t) w.r.t. every arg, cotangent ct.

    An arg the torch graph does not reach (nearest sampling's uvs) gets a
    zero gradient, as JAX gives it.
    """
    out_j, vjp = jax.vjp(fn_j, *[jnp.asarray(a) for a in args])
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out_t = fn_t(*ts)
    g_t = torch.autograd.grad(out_t, ts, torch.as_tensor(ct),
                              allow_unused=True, materialize_grads=True)
    return (np.asarray(out_j), out_t.detach().numpy(),
            [np.asarray(g) for g in vjp(jnp.asarray(ct))],
            [g.numpy() for g in g_t])


def _assert_grads_close(g_j, g_t):
    for a, b in zip(g_j, g_t):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-30))


def _border_uvs(shape):
    """uvs in [-0.3, 1.3] with exact 0, 1, texel centres and edges."""
    uv = RNG.uniform(-0.3, 1.3, shape + (2,)).astype(np.float32)
    flat = uv.reshape(-1, 2)
    special = np.array([0., 1., -0.5, 1.5, 0.5, 1. / 32, 3. / 32, 1. / 16,
                        15. / 16, 31. / 32], np.float32)
    n = min(len(flat), len(special) ** 2)
    flat[:n] = np.stack(np.meshgrid(special, special), -1).reshape(-1, 2)[:n]
    return uv


@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
@pytest.mark.parametrize('lead', [(150,), (12, 10)])
def test_texture_mapping(mode, lead):
    B, C, TH, TW = 2, 3, 16, 8
    uv = _border_uvs((B,) + lead)
    tex = RNG.random((B, C, TH, TW), dtype=np.float32)
    ct = _f32(B, *lead, C)
    out_j, out_t, g_j, g_t = _grads(
        lambda u, t: utils_j.texture_mapping(u, t, mode=mode),
        lambda u, t: utils_t.texture_mapping(u, t, mode=mode), [uv, tex], ct)
    assert out_t.shape == (B,) + lead + (C,)
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-5)
    # The first texel centre (pixel coordinate exactly 0) is a kink of the
    # border-padded sample: both packages take the derivative from inside
    # the texture (taps 0 and 1, each corner clipped on its own).
    cuv = np.clip(uv, 0., 1.) * 2. - 1.
    x = (cuv[..., 0] + 1.) * TW / 2. - 0.5
    y = (-cuv[..., 1] + 1.) * TH / 2. - 0.5
    kink = np.stack([x == 0., y == 0.], axis=-1)
    assert kink.any()
    _assert_grads_close(g_j, g_t)
    outside = (uv < 0.) | (uv > 1.)
    assert outside.any()
    # clamped uvs carry no gradient in either package
    np.testing.assert_array_equal(g_t[0][outside], 0.)


def test_texture_mapping_rejects_mode():
    with pytest.raises(ValueError):
        utils_t.texture_mapping(torch.zeros(1, 4, 2), torch.zeros(1, 3, 4, 4),
                                mode='bicubic')


def test_spherical_harmonic_lighting():
    normals = _f32(2, 6, 5, 3)
    lights = _f32(2, 9)
    out_j, out_t, g_j, g_t = _grads(utils_j.spherical_harmonic_lighting,
                                    utils_t.spherical_harmonic_lighting,
                                    [normals, lights], _f32(2, 6, 5))
    np.testing.assert_allclose(out_t, out_j, rtol=1e-5, atol=1e-5)
    _assert_grads_close(g_j, g_t)


@pytest.mark.parametrize('use_transform', [False, True])
def test_prepare_vertices(use_transform):
    B, V = 2, 12
    verts = _f32(B, V, 3, scale=0.5)
    faces = np.stack([RNG.permutation(V)[:3] for _ in range(20)])
    proj = np.asarray(cam_j.generate_perspective_projection(0.8))
    if use_transform:
        mtx = np.asarray(cam_j.generate_transformation_matrix(
            jnp.array([[0., 0.3, 3.], [2., 1., 2.]]), jnp.zeros((2, 3)),
            jnp.array([[0., 1., 0.]] * 2)))
        kw_j = dict(camera_transform=jnp.asarray(mtx))
        kw_t = dict(camera_transform=torch.tensor(mtx))
    else:
        rot, trans = cam_j.generate_rotate_translate_matrices(
            jnp.array([[0., 0.3, 3.], [2., 1., 2.]]), jnp.zeros((2, 3)),
            jnp.array([[0., 1., 0.]] * 2))
        kw_j = dict(camera_rot=rot, camera_trans=trans)
        kw_t = dict(camera_rot=torch.tensor(np.asarray(rot)),
                    camera_trans=torch.tensor(np.asarray(trans)))
    cts = [_f32(B, 20, 3, 3), _f32(B, 20, 3, 2), _f32(B, 20, 3)]
    outs_j, vjp = jax.vjp(lambda v: utils_j.prepare_vertices(
        v, jnp.asarray(faces), jnp.asarray(proj), **kw_j), jnp.asarray(verts))
    v_t = torch.tensor(verts, requires_grad=True)
    outs_t = utils_t.prepare_vertices(v_t, torch.as_tensor(faces),
                                      torch.as_tensor(proj), **kw_t)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a),
                                   rtol=1e-5, atol=1e-5)
    (g_j,) = vjp(tuple(jnp.asarray(c) for c in cts))
    (g_t,) = torch.autograd.grad(outs_t, [v_t],
                                 [torch.as_tensor(c) for c in cts])
    _assert_grads_close([np.asarray(g_j)], [g_t.numpy()])


def test_prepare_vertices_requires_camera():
    with pytest.raises(ValueError):
        utils_t.prepare_vertices(torch.zeros(1, 3, 3),
                                 torch.zeros(1, 3, dtype=torch.long),
                                 torch.ones(3, 1))


def test_mask_iou():
    lhs = RNG.random((3, 7, 5), dtype=np.float32)
    rhs = (RNG.random((3, 7, 5)) > 0.5).astype(np.float32)
    out_j, out_t, g_j, g_t = _grads(metrics_j.mask_iou, metrics_t.mask_iou,
                                    [lhs, rhs], np.float32(1.))
    np.testing.assert_allclose(out_t, out_j, rtol=1e-6)
    _assert_grads_close(g_j, g_t)
    with pytest.raises(ValueError):
        metrics_t.mask_iou(torch.zeros(2, 3, 3), torch.zeros(2, 3, 4))
