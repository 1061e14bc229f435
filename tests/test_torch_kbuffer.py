"""Parity of the port's brute-force ('jnp') DIB-R path with kaolin_tpu's.

The JAX side runs its ``'jnp'`` backend on the CPU (no Pallas kernel on
this path); the port's side its plain PyTorch counterpart.  Tolerances:
face_idx equal, except where XLA's CPU fma contraction moves a winning
edge function that lies within 1e-5 (relative) of 0, on at most 1e-3 of
the pixels; the soft mask's k-buffer exactly equal; the soft mask within
2e-5; features and weights within 1e-5; the loss within rtol 1e-5;
gradients (same cotangent) within 1e-4 * max|g_jax|.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.models import inverse_render as MJ
from kaolin_tpu.render.camera import legacy as cam_j
from kaolin_tpu.render.mesh import dibr as dibr_j
from kaolin_tpu.render.mesh import rasterization as rast_j
from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.render.camera import legacy as cam_t
from kaolin_tpu_torch.render.mesh import dibr as dibr_t
from kaolin_tpu_torch.render.mesh import rasterization as rast_t
from kaolin_tpu_torch.utils.testing import uv_sphere

H = W = 64
MULT = 1000.
FLIP_SHARE = 1e-3
EDGE_REL = 1e-5


def random_scene(seed, F=300, B=2, spread=0.3, C=4):
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


def _weights_at(fvi_scaled, fid, x0, y0):
    """Normalized barycentric weights of face ``fid`` at (x0, y0), float64."""
    a, b, c = fvi_scaled[fid].astype(np.float64) - [x0, y0]
    w = np.array([b[0] * c[1] - b[1] * c[0], c[0] * a[1] - c[1] * a[0],
                  a[0] * b[1] - a[1] * b[0]])
    return w / w.sum()


def _assert_face_idx_close(idx_t, idx_j, fvi, hw):
    """Equal but where a winning face's edge function is within EDGE_REL of
    0 (XLA's CPU fma contraction rounds it the other way)."""
    idx_t, idx_j = np.asarray(idx_t), np.asarray(idx_j)
    diff = np.argwhere(idx_t != idx_j)
    assert len(diff) <= FLIP_SHARE * idx_t.size, len(diff)
    Hh, Ww = hw
    xs = MULT / Ww * (2 * np.arange(Ww) + 1 - Ww)
    ys = MULT / Hh * (Hh - 2 * np.arange(Hh) - 1)
    for b, i, j in diff:
        for fid in (idx_t[b, i, j], idx_j[b, i, j]):
            if fid >= 0:
                w = _weights_at(fvi[b] * MULT, fid, xs[j], ys[i])
                assert np.abs(w).min() <= EDGE_REL, (b, i, j, w)


@pytest.mark.parametrize('hw', [(64, 64), (35, 31)])
@pytest.mark.parametrize('chunks', [(8192, 1024), (300, 50)])
def test_selection_jnp(hw, chunks):
    Hh, Ww = hw
    fvz, fvi, _, normals_z = random_scene(sum(hw))
    valid = normals_z >= 0.
    idx_j = rast_j.rasterize_selection(Hh, Ww, jnp.asarray(fvz),
                                       jnp.asarray(fvi), jnp.asarray(valid),
                                       backend='jnp')
    xs, ys = rast_t.pixel_coords(Hh, Ww, MULT, device='cpu')
    idx_t = torch.stack([rast_t._selection_jnp(
        torch.as_tensor(fvz[b]), torch.as_tensor(fvi[b]) * MULT,
        torch.as_tensor(valid[b]), xs, ys, Hh, Ww, 1e-8,
        pixel_chunk=chunks[0], face_chunk=chunks[1]) for b in range(2)])
    assert idx_t.dtype == torch.int32
    assert (idx_t >= 0).any() and (idx_t < 0).any()
    _assert_face_idx_close(idx_t, idx_j, fvi, hw)


def test_selection_jnp_z_tie_goes_to_lowest_id():
    """Two identical faces in different face chunks: the lower id wins
    whatever the chunk sizes, as in the JAX package."""
    fvz, fvi, _, _ = random_scene(5, F=40, B=1)
    fvi[0, 33], fvz[0, 33] = fvi[0, 2], fvz[0, 2]
    xs, ys = rast_t.pixel_coords(H, W, MULT, device='cpu')
    args = (torch.as_tensor(fvz[0]), torch.as_tensor(fvi[0]) * MULT,
            torch.ones(40, dtype=torch.bool), xs, ys, H, W, 1e-8)
    ref = rast_t._selection_jnp(*args)
    assert (ref == 2).any() and not (ref == 33).any()
    for pc, fc in ((64, 3), (1000, 33), (4096, 40)):
        assert torch.equal(rast_t._selection_jnp(
            *args, pixel_chunk=pc, face_chunk=fc), ref)
    idx_j = rast_j._selection_jnp(jnp.asarray(fvz[0]),
                                  jnp.asarray(fvi[0]) * MULT,
                                  jnp.ones(40, bool), jnp.asarray(xs.numpy()),
                                  jnp.asarray(ys.numpy()), H, W, 1e-8,
                                  face_chunk=32)
    _assert_face_idx_close(ref[None], np.asarray(idx_j)[None], fvi, (H, W))


@pytest.mark.parametrize('knum, F, boxlen', [(30, 300, 0.02), (8, 300, 0.2),
                                             (30, 12, 0.05)])
def test_soft_mask_select_equal(knum, F, boxlen):
    fvz, fvi, _, normals_z = random_scene(knum + F, F=F)
    idx = rast_j.rasterize_selection(H, W, jnp.asarray(fvz),
                                     jnp.asarray(fvi),
                                     jnp.asarray(normals_z >= 0.),
                                     backend='jnp')
    kb_j = dibr_j.dibr_soft_mask_select(jnp.asarray(fvi), idx,
                                        boxlen=boxlen, knum=knum)
    kb_t = dibr_t.dibr_soft_mask_select(torch.as_tensor(fvi),
                                        torch.as_tensor(np.array(idx)),
                                        boxlen=boxlen, knum=knum)
    assert kb_t.dtype == torch.int32 and kb_t.shape == (2, H, W, knum)
    np.testing.assert_array_equal(kb_t.numpy(), np.asarray(kb_j))
    assert (kb_t >= 0).any() and (kb_t < 0).any()
    if boxlen == 0.2:
        assert (kb_t >= 0).all(-1).any(), 'some pixel fills its k-buffer'


@pytest.mark.parametrize('sigmainv, boxlen, knum, F',
                         [(7000, 0.02, 30, 300), (70, 0.2, 8, 300),
                          (7000, 0.05, 30, 12)])
def test_soft_mask_and_custom_backward(sigmainv, boxlen, knum, F):
    """The k-buffer soft mask and its hand-derived backward against the
    JAX package's custom_vjp, on the same k-buffer and cotangent."""
    fvz, fvi, _, normals_z = random_scene(sigmainv + F, F=F)
    idx = np.asarray(rast_j.rasterize_selection(
        H, W, jnp.asarray(fvz), jnp.asarray(fvi),
        jnp.asarray(normals_z >= 0.), backend='jnp'))
    kb = np.asarray(dibr_j.dibr_soft_mask_select(
        jnp.asarray(fvi), jnp.asarray(idx), boxlen=boxlen, knum=knum))
    ct = np.random.default_rng(3).standard_normal((2, H, W)).astype(
        np.float32)
    m_j, vjp = jax.vjp(lambda f: dibr_j.dibr_soft_mask(
        f, jnp.asarray(idx), sigmainv, boxlen, knum, kbuf=jnp.asarray(kb)),
        jnp.asarray(fvi))
    fvi_t = torch.tensor(fvi, requires_grad=True)
    m_t = dibr_t.dibr_soft_mask(fvi_t, torch.as_tensor(idx), sigmainv,
                                boxlen, knum, kbuf=torch.as_tensor(kb))
    np.testing.assert_allclose(m_t.detach().numpy(), np.asarray(m_j),
                               rtol=0, atol=2e-5)
    assert ((m_t > 0) & (m_t < 1)).any()
    (g_t,) = torch.autograd.grad(m_t, [fvi_t], torch.as_tensor(ct))
    _assert_grads_close(vjp(jnp.asarray(ct)), [g_t])
    # kbuf=None selects the same k-buffer inside
    m_none = dibr_t.dibr_soft_mask(torch.as_tensor(fvi), torch.as_tensor(idx),
                                   sigmainv, boxlen, knum)
    assert torch.equal(m_none, m_t.detach())


def _plain_soft_mask64(fvi, idx, kb, sigmainv):
    """The k-buffer soft mask written plainly, for autograd in float64."""
    fvi_scaled = fvi * MULT
    xs, ys = rast_t.pixel_coords(H, W, MULT, dtype=torch.float64,
                                 device='cpu')
    fv, _ = dibr_t._soft_mask_gather(fvi_scaled, kb)
    d = dibr_t._face_min_sqdist(fv, xs[None, None, :, None],
                                ys[None, :, None, None], MULT)
    prob = torch.where(kb >= 0, torch.exp(-sigmainv / MULT ** 2 * d), 0.)
    return torch.where(idx < 0, 1. - torch.prod(1. - prob, -1), 1.)


def test_custom_backward_against_autograd_float64():
    """The hand-derived backward equals autograd of the plain forward in
    float64 (the min picks one branch almost everywhere, where it is
    smooth)."""
    fvz, fvi, _, normals_z = random_scene(11, F=60, B=1)
    idx = rast_t.rasterize_selection(H, W, torch.as_tensor(fvz),
                                     torch.as_tensor(fvi),
                                     torch.as_tensor(normals_z >= 0.),
                                     backend='jnp')
    kb = dibr_t.dibr_soft_mask_select(torch.as_tensor(fvi), idx, 0.1, 16)
    ct = torch.as_tensor(np.random.default_rng(4).standard_normal(
        (1, H, W)))
    fvi64 = torch.tensor(fvi, dtype=torch.float64, requires_grad=True)
    m = dibr_t.dibr_soft_mask(fvi64, idx, 700., 0.1, 16, kbuf=kb)
    (g,) = torch.autograd.grad(m, [fvi64], ct)
    fvi64b = torch.tensor(fvi, dtype=torch.float64, requires_grad=True)
    m_ref = _plain_soft_mask64(fvi64b, idx, kb, 700.)
    (g_ref,) = torch.autograd.grad(m_ref, [fvi64b], ct)
    torch.testing.assert_close(m.detach(), m_ref.detach(), rtol=0,
                               atol=1e-12)
    scale = g_ref.abs().max().item()
    assert scale > 0
    assert (g - g_ref).abs().max().item() <= 1e-8 * scale


def test_custom_backward_leaves_padded_slots_out():
    """Padded slots gather face 0 but add nothing to it: face 0 far away
    from every pixel gets a zero gradient."""
    fvz, fvi, _, _ = random_scene(12, F=20, B=1)
    fvi[0, 0] = [[5., 5.], [5.1, 5.], [5., 5.1]]
    idx = rast_t.rasterize_selection(H, W, torch.as_tensor(fvz),
                                     torch.as_tensor(fvi), backend='jnp')
    kb = dibr_t.dibr_soft_mask_select(torch.as_tensor(fvi), idx, 0.02, 30)
    assert (kb < 0).any() and not (kb == 0).any()
    fvi_t = torch.tensor(fvi, requires_grad=True)
    m = dibr_t.dibr_soft_mask(fvi_t, idx, kbuf=kb)
    (g,) = torch.autograd.grad(m.sum(), [fvi_t])
    assert g[0, 0].abs().max() == 0 and g.abs().max() > 0


@pytest.mark.parametrize('hw', [(64, 64), (40, 72)])
def test_rasterize_jnp(hw):
    Hh, Ww = hw
    fvz, fvi, feats, normals_z = random_scene(sum(hw) + 1)
    valid = normals_z >= 0.
    ct = np.random.default_rng(1).standard_normal((2, Hh, Ww, 4)).astype(
        np.float32)
    ct_w = np.random.default_rng(2).standard_normal((2, Hh, Ww, 3)).astype(
        np.float32)

    def run_j(fvi_, feats_):
        f, idx, w = rast_j.rasterize(Hh, Ww, jnp.asarray(fvz), fvi_, feats_,
                                     jnp.asarray(valid), backend='jnp',
                                     with_weights=True)
        return (f, w), idx

    (f_j, w_j), vjp, idx_j = jax.vjp(run_j, jnp.asarray(fvi),
                                     jnp.asarray(feats), has_aux=True)
    fvi_t = torch.tensor(fvi, requires_grad=True)
    feats_t = torch.tensor(feats, requires_grad=True)
    f_t, idx_t, w_t = rast_t.rasterize(Hh, Ww, torch.as_tensor(fvz), fvi_t,
                                       feats_t, torch.as_tensor(valid),
                                       backend='jnp', with_weights=True)
    _assert_face_idx_close(idx_t, idx_j, fvi, hw)
    same = torch.as_tensor(np.asarray(idx_j)) == idx_t
    np.testing.assert_allclose(f_t.detach().numpy()[same.numpy()],
                               np.asarray(f_j)[same.numpy()], rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(w_t.detach().numpy()[same.numpy()],
                               np.asarray(w_j)[same.numpy()], rtol=0,
                               atol=1e-5)
    if bool(same.all()):
        g_j = vjp((jnp.asarray(ct), jnp.asarray(ct_w)))
        g_t = torch.autograd.grad((f_t, w_t), [fvi_t, feats_t],
                                  (torch.as_tensor(ct),
                                   torch.as_tensor(ct_w)))
        _assert_grads_close(g_j, g_t)


def test_dibr_rasterization_jnp():
    fvz, fvi, feats, normals_z = random_scene(21)
    rng = np.random.default_rng(4)
    ct_f = rng.standard_normal((2, H, W, 4)).astype(np.float32)
    ct_m = rng.standard_normal((2, H, W)).astype(np.float32)

    def run_j(fvi_, feats_):
        f, m, idx = dibr_j.dibr_rasterization(
            H, W, jnp.asarray(fvz), fvi_, feats_, jnp.asarray(normals_z),
            sigmainv=700, boxlen=0.05, knum=16, rast_backend='jnp')
        return (f, m), idx

    (f_j, m_j), vjp, idx_j = jax.vjp(run_j, jnp.asarray(fvi),
                                     jnp.asarray(feats), has_aux=True)
    fvi_t = torch.tensor(fvi, requires_grad=True)
    feats_t = torch.tensor(feats, requires_grad=True)
    f_t, m_t, idx_t = dibr_t.dibr_rasterization(
        H, W, torch.as_tensor(fvz), fvi_t, feats_t,
        torch.as_tensor(normals_z), sigmainv=700, boxlen=0.05, knum=16,
        rast_backend='jnp')
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(f_t.detach().numpy(), np.asarray(f_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(m_t.detach().numpy(), np.asarray(m_j),
                               rtol=0, atol=2e-5)
    g_j = vjp((jnp.asarray(ct_f), jnp.asarray(ct_m)))
    g_t = torch.autograd.grad((f_t, m_t), [fvi_t, feats_t],
                              (torch.as_tensor(ct_f), torch.as_tensor(ct_m)))
    _assert_grads_close(g_j, g_t)


def test_backend_names():
    assert rast_t._resolve_backend('auto') == 'fused'
    assert rast_t._resolve_backend('jnp') == 'jnp'
    assert rast_t.fused_backend_supported(35, 31)
    assert rast_t.fused_backend_supported(1, 1) == \
        rast_j.fused_backend_supported(1, 1)


@pytest.mark.parametrize('B_pos', [1, 3])
def test_generate_transformation_matrix(B_pos):
    rng = np.random.default_rng(B_pos)
    pos = rng.uniform(-3, 3, (B_pos, 3)).astype(np.float32)
    at = rng.uniform(-0.5, 0.5, (3, 3)).astype(np.float32)[:B_pos]
    up = np.array([[0., 1., 0.]], np.float32)
    m_j = cam_j.generate_transformation_matrix(
        jnp.asarray(pos), jnp.asarray(at), jnp.asarray(up))
    m_t = cam_t.generate_transformation_matrix(
        torch.as_tensor(pos), torch.as_tensor(at), torch.as_tensor(up))
    assert m_t.shape == (B_pos, 4, 3)
    np.testing.assert_allclose(m_t.numpy(), np.asarray(m_j), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the trainer with backend='jnp'

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


@pytest.mark.parametrize('knum', [30, 4])
def test_render_loss_jnp(scene, knum):
    params = MJ.InverseRenderParams(jnp.asarray(scene['verts']),
                                    jnp.asarray(scene['tex']),
                                    jnp.asarray(scene['sh']))
    views = MJ.make_views(VIEWS)
    faces = jnp.asarray(scene['faces'])
    face_uvs = jnp.asarray(scene['face_uvs'])
    fi_j, kb_j = MJ.compute_selection(params, views, faces, H, W,
                                      backend='jnp', knum=knum)
    loss_j, grads_j = jax.value_and_grad(lambda p: MJ.render_loss(
        p, views, faces, face_uvs, jnp.asarray(scene['target_images']),
        jnp.asarray(scene['target_masks']), H, W, backend='jnp',
        selection=(fi_j, kb_j), knum=knum))(params)

    p_t = MT.from_jax_params(scene['verts'], scene['tex'], scene['sh'],
                             device='cpu')
    views_t = MT.make_views(VIEWS, device='cpu')
    faces_t = torch.as_tensor(scene['faces'])
    uvs_t = torch.as_tensor(scene['face_uvs'])
    fi_t, kb_t = MT.compute_selection(p_t, views_t, faces_t, H, W,
                                      backend='jnp', knum=knum)
    np.testing.assert_array_equal(fi_t.numpy(), np.asarray(fi_j))
    np.testing.assert_array_equal(kb_t.numpy(), np.asarray(kb_j))
    loss_t = MT.render_loss(p_t, views_t, faces_t, uvs_t,
                            torch.as_tensor(scene['target_images']),
                            torch.as_tensor(scene['target_masks']), H, W,
                            backend='jnp', selection=(fi_t, kb_t), knum=knum)
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    loss_t.backward()
    for name in ('vertices', 'texture_map', 'sh_coeffs'):
        _assert_grads_close([getattr(grads_j, name)],
                            [getattr(p_t, name).grad.numpy()])
    # the selection is computed inside when not given
    loss_none = MT.render_loss(p_t, views_t, faces_t, uvs_t,
                               torch.as_tensor(scene['target_images']),
                               torch.as_tensor(scene['target_masks']), H, W,
                               backend='jnp', knum=knum)
    assert loss_none.item() == loss_t.item()
