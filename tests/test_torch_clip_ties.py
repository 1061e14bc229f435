"""Gradients at clip ties: the port against kaolin_tpu.

``jnp.clip``, ``jnp.maximum`` and ``jnp.minimum`` split the gradient at an
exact tie (0.5 to each side); ``torch.clamp`` passes all of it.  The port
clips through ``kaolin_tpu_torch._clip.clip`` wherever the JAX package
clips a value that carries a gradient.

The DIB-R step of ``test_torch_inverse_render.py`` with the first 8 texture
rows set to exactly 0: on those texels ``albedo = 0``, so ``images = 0``
sits on the lower edge of ``clip(images, 0, 1)``.  The selection is the
brute-force ``'jnp'`` one and the mask the hard one (``with_soft_mask=
False``): the clips sit between them and the image, and the soft mask's
kernels have tests of their own.  Loss within rtol 1e-5; vertex, texture
and SH gradients within 1e-4 * max|g_jax|.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.models import inverse_render as MJ
from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.utils.testing import uv_sphere

H = W = 64
VIEWS = 2


@pytest.fixture(scope='module')
def scene():
    sphere = uv_sphere(16, 9)
    rng = np.random.default_rng(0)
    verts = (sphere.vertices * 0.5 + 0.02 * rng.standard_normal(
        sphere.vertices.shape)).astype(np.float32)
    tex = rng.random((3, 16, 16), dtype=np.float32)
    tex[:, :8] = 0.                           # black texels: images == 0
    sh = np.zeros(9, np.float32)
    sh[0] = 3.
    sh[1:] = 0.3 * rng.standard_normal(8)
    return dict(
        verts=verts, tex=tex, sh=sh, faces=sphere.faces,
        face_uvs=sphere.uvs[sphere.face_uvs_idx],
        target_images=rng.random((VIEWS, H, W, 3), dtype=np.float32),
        target_masks=(rng.random((VIEWS, H, W)) > 0.5).astype(np.float32))


def test_render_loss_grads_at_black_texels(scene):
    params = MJ.InverseRenderParams(jnp.asarray(scene['verts']),
                                    jnp.asarray(scene['tex']),
                                    jnp.asarray(scene['sh']))
    views = MJ.make_views(VIEWS)
    faces = jnp.asarray(scene['faces'])
    face_uvs = jnp.asarray(scene['face_uvs'])
    kw = dict(backend='jnp', with_soft_mask=False)
    sel = MJ.compute_selection(params, views, faces, H, W, backend='jnp')
    loss_j, grads = jax.jit(jax.value_and_grad(lambda p: MJ.render_loss(
        p, views, faces, face_uvs, jnp.asarray(scene['target_images']),
        jnp.asarray(scene['target_masks']), H, W, selection=sel,
        **kw)))(params)
    fi = np.asarray(sel[0])

    p_t = MT.from_jax_params(scene['verts'], scene['tex'], scene['sh'],
                             device='cpu')
    v_t = MT.make_views(VIEWS, device='cpu')
    f_t = torch.as_tensor(scene['faces'])
    sel_t = MT.compute_selection(p_t, v_t, f_t, H, W, backend='jnp')
    np.testing.assert_array_equal(sel_t[0].numpy(), fi)
    with torch.no_grad():
        images = MT.render_views(p_t, v_t, f_t,
                                 torch.as_tensor(scene['face_uvs']), H, W,
                                 selection=sel_t, **kw)[0]
    # the scene puts covered pixels exactly on the tie
    assert ((images == 0.).all(-1) & (sel_t[0] >= 0)).sum() > 50
    loss = MT.render_loss(p_t, v_t, f_t, torch.as_tensor(scene['face_uvs']),
                          torch.as_tensor(scene['target_images']),
                          torch.as_tensor(scene['target_masks']), H, W,
                          selection=sel_t, **kw)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for name in ('vertices', 'texture_map', 'sh_coeffs'):
        g_j = np.asarray(getattr(grads, name))
        g_t = getattr(p_t, name).grad.numpy()
        assert np.abs(g_j).max() > 0, name
        np.testing.assert_allclose(g_t, g_j, rtol=0,
                                   atol=1e-4 * np.abs(g_j).max(),
                                   err_msg=name)


@pytest.mark.parametrize('lo, hi', [(0., 1.), (0., None), (None, 1.),
                                    (1e-4, None)])
def test_clip_matches_jnp_clip(lo, hi):
    x = np.array([-1., 0., 1e-4, 0.5, 1., 2.], np.float32)
    g_j = np.asarray(jax.grad(lambda v: jnp.sum(
        jnp.clip(v, lo, hi) * jnp.arange(1., 7.)))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    y = clip(xt, lo, hi)
    (y * torch.arange(1., 7.)).sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(),
                                  np.asarray(jnp.clip(jnp.asarray(x), lo,
                                                      hi)))
    np.testing.assert_array_equal(xt.grad.numpy(), g_j)
