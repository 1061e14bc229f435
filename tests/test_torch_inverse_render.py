"""The DIB-R inverse-rendering step of the port against kaolin_tpu's.

Both packages take the same numpy-seeded UV sphere, texture, SH
coefficients and targets.  The JAX side runs ``compute_selection
(backend='fused')`` + ``render_loss(selection=...)`` as
``test_model_selection_fused_path`` does (interpret mode on the CPU).

Tolerances: face_idx exactly equal; images within 1e-5; the soft mask
within 2e-5 (see ``test_torch_fused.py``); the loss within rtol 1e-5;
gradients w.r.t. vertices, texture and SH within 1e-4 * max|g_jax|.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.models import inverse_render as MJ
from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.render.mesh import FusedSelection
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
    sh = np.zeros(9, np.float32)
    sh[0] = 3.
    sh[1:] = 0.3 * rng.standard_normal(8)
    return dict(
        verts=verts, tex=tex, sh=sh, faces=sphere.faces,
        face_uvs=sphere.uvs[sphere.face_uvs_idx],
        target_images=rng.random((VIEWS, H, W, 3), dtype=np.float32),
        target_masks=(rng.random((VIEWS, H, W)) > 0.5).astype(np.float32))


@pytest.fixture(scope='module')
def jax_run(scene):
    params = MJ.InverseRenderParams(jnp.asarray(scene['verts']),
                                    jnp.asarray(scene['tex']),
                                    jnp.asarray(scene['sh']))
    views = MJ.make_views(VIEWS)
    faces = jnp.asarray(scene['faces'])
    face_uvs = jnp.asarray(scene['face_uvs'])
    fi, sel = MJ.compute_selection(params, views, faces, H, W,
                                   backend='fused')
    images, mask, _ = MJ.render_views(params, views, faces, face_uvs, H, W,
                                      selection=(fi, sel))
    loss, grads = jax.value_and_grad(lambda p: MJ.render_loss(
        p, views, faces, face_uvs, jnp.asarray(scene['target_images']),
        jnp.asarray(scene['target_masks']), H, W,
        selection=(fi, sel)))(params)
    return dict(face_idx=np.asarray(fi), prod=np.asarray(sel.prod),
                images=np.asarray(images), mask=np.asarray(mask),
                loss=float(loss),
                grads={k: np.asarray(getattr(grads, k))
                       for k in ('vertices', 'texture_map', 'sh_coeffs')})


def _torch_inputs(scene):
    return (MT.from_jax_params(scene['verts'], scene['tex'], scene['sh'],
                               device='cpu'),
            MT.make_views(VIEWS, device='cpu'), torch.as_tensor(scene['faces']),
            torch.as_tensor(scene['face_uvs']))


def test_uv_sphere():
    s = uv_sphere(16, 9)
    assert s.faces.shape == (2 * 16 * 8, 3)
    assert s.face_uvs_idx.shape == s.faces.shape
    assert len(uv_sphere(100, 51).faces) == 10000
    np.testing.assert_allclose(np.linalg.norm(s.vertices, axis=1), 1.,
                               rtol=1e-6)
    fv = s.vertices[s.faces]
    n = np.cross(fv[:, 1] - fv[:, 0], fv[:, 2] - fv[:, 0])
    assert (np.einsum('fi,fi->f', n, fv.mean(1)) > 0).all()    # outward
    # closed: every undirected edge is shared by exactly two faces
    e = np.sort(s.faces[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2), axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    assert (counts == 2).all()
    assert s.uvs.min() == 0. and s.uvs.max() == 1.


def test_make_views_and_init_params():
    v_j = MJ.make_views(4)
    v_t = MT.make_views(4, device='cpu')
    for a, b in zip(v_j, v_t):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)

    class Mesh:
        vertices = uv_sphere(8, 5).vertices * 3. + 1.
    p_j = MJ.init_params(Mesh, texture_res=8)
    p_t = MT.init_params(Mesh, texture_res=8,
                         generator=torch.Generator().manual_seed(3),
                         device='cpu')
    np.testing.assert_allclose(p_t.vertices.detach().numpy(),
                               np.asarray(p_j.vertices), atol=1e-6)
    np.testing.assert_array_equal(p_t.sh_coeffs.detach().numpy(),
                                  np.asarray(p_j.sh_coeffs))
    assert p_t.texture_map.shape == (3, 8, 8)
    assert {n for n, _ in p_t.named_parameters()} == {
        'vertices', 'texture_map', 'sh_coeffs'}


def test_compute_selection(scene, jax_run):
    params, views, faces, _ = _torch_inputs(scene)
    fi, sel = MT.compute_selection(params, views, faces, H, W)
    assert isinstance(sel, FusedSelection)
    assert not sel.vt.requires_grad
    np.testing.assert_array_equal(fi.numpy(), jax_run['face_idx'])
    assert (fi >= 0).any() and (fi < 0).any()
    np.testing.assert_allclose(sel.prod.numpy(), jax_run['prod'], rtol=0,
                               atol=2e-5)


def test_render_views(scene, jax_run):
    params, views, faces, face_uvs = _torch_inputs(scene)
    sel = MT.compute_selection(params, views, faces, H, W)
    images, mask, fi = MT.render_views(params, views, faces, face_uvs, H, W,
                                       selection=sel)
    np.testing.assert_array_equal(fi.numpy(), jax_run['face_idx'])
    np.testing.assert_allclose(images.detach().numpy(), jax_run['images'],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(mask.detach().numpy(), jax_run['mask'],
                               rtol=0, atol=2e-5)
    # without a selection it computes the same one itself
    images2, mask2, _ = MT.render_views(params, views, faces, face_uvs, H, W)
    assert torch.equal(images2, images) and torch.equal(mask2, mask)


def test_render_loss_and_grads(scene, jax_run):
    params, views, faces, face_uvs = _torch_inputs(scene)
    sel = MT.compute_selection(params, views, faces, H, W)
    loss = MT.render_loss(params, views, faces, face_uvs,
                          torch.as_tensor(scene['target_images']),
                          torch.as_tensor(scene['target_masks']), H, W,
                          selection=sel)
    loss.backward()
    np.testing.assert_allclose(loss.item(), jax_run['loss'], rtol=1e-5)
    for name, g_j in jax_run['grads'].items():
        g_t = getattr(params, name).grad.numpy()
        assert np.abs(g_j).max() > 0, name
        np.testing.assert_allclose(g_t, g_j, rtol=0,
                                   atol=1e-4 * np.abs(g_j).max(),
                                   err_msg=name)


def test_adam_steps_reduce_loss():
    """The trainer loop of examples/dibr_inverse_rendering.py, 4 steps."""
    s = uv_sphere(12, 7)
    faces = torch.as_tensor(s.faces)
    face_uvs = torch.as_tensor(s.uvs[s.face_uvs_idx])
    views = MT.make_views(2, device='cpu')

    class Mesh:
        vertices = s.vertices
    gt = MT.init_params(Mesh, texture_res=8,
                        generator=torch.Generator().manual_seed(7),
                        device='cpu')
    with torch.no_grad():
        target_images, target_masks, _ = MT.render_views(
            gt, views, faces, face_uvs, 32, 32)
    params = MT.init_params(Mesh, texture_res=8, device='cpu')
    with torch.no_grad():
        params.vertices += 0.05 * torch.as_tensor(
            np.random.default_rng(0).standard_normal(s.vertices.shape),
            dtype=torch.float32)
    start = params.vertices.detach().clone()
    opt = torch.optim.Adam(params.parameters(), lr=5e-3)
    losses = []
    for _ in range(4):
        sel = MT.compute_selection(params, views, faces, 32, 32)
        opt.zero_grad()
        loss = MT.render_loss(params, views, faces, face_uvs, target_images,
                              target_masks, 32, 32, selection=sel)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    assert not torch.equal(params.vertices.detach(), start)
