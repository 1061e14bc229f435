"""The DIB-R epilogue's gathers and hand-written backwards against the JAX
package's: ``_flat_corner_idx`` / ``_bilinear_sample`` (kernels E1 and E2
on the card) and ``gather_rows`` (its backward E3 on the card).

On the CPU the wrappers run the plain versions; the inputs are made with
numpy from a seed and go through both packages.  Values within 1e-5,
gradients (same cotangent) within 1e-4 * max|g_jax|: JAX's texture gradient
is an f32 one-hot matrix product, a sum in another order.  Where every
term is an integer or a half (the gather tests) the sums are exact in any
order and compared bit for bit.  The epilogue as a whole
(``_interpolate_selected_batched``, one combined gather of the
``(B*F, 6 + 3C)`` face table) and the whole ``render_loss`` gradients are
held to the JAX package for both backends.

Card-only cases (skipped without one): E1-E3 against their plain versions
on the card (E1 equal, E2 and E3 within 1e-5 * max|out| of the plain
version and of a float64 sum), two runs of E2 and E3 bit-equal, and the
long runs: a 2 x 2 texture (every texel holds ~Q taps) and every row on
one id.  The JAX package is imported by a fixture, so the card's cases
also run where it does not import (on the card:
``python -m pytest --noconftest tests/test_torch_epilogue.py``).
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.ops import _scatter
from kaolin_tpu_torch.ops import gather as GT
from kaolin_tpu_torch.render.mesh import _sample
from kaolin_tpu_torch.render.mesh import rasterization as RT
from kaolin_tpu_torch.render.mesh import utils as UT
from kaolin_tpu_torch.utils.testing import uv_sphere

# evaluated when the test runs, not at import
cuda = pytest.mark.skipif('not torch.cuda.is_available()',
                          reason='needs a CUDA card (run on the H100)')

GRAD_REL = 1e-4
CARD_REL = 1e-5


@pytest.fixture(scope='module')
def J():
    """The JAX package's side of the parity tests; they skip where it does
    not import."""
    jax = pytest.importorskip('jax')
    MJ = pytest.importorskip('kaolin_tpu.models.inverse_render')
    return SimpleNamespace(
        jax=jax, jnp=pytest.importorskip('jax.numpy'), MJ=MJ,
        GJ=pytest.importorskip('kaolin_tpu.ops.gather'),
        RJ=pytest.importorskip('kaolin_tpu.render.mesh.rasterization'),
        UJ=pytest.importorskip('kaolin_tpu.render.mesh.utils'))


def _close(b, a, rel=GRAD_REL, what=''):
    a, b = np.asarray(a), np.asarray(b)
    assert np.abs(a).max() > 0, what
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * np.abs(a).max(),
                               err_msg=what)


def _coords(rng, Q, H, W):
    """Pixel coords of uvs on 0 and 1, texel centres and edges, and beyond
    [0, 1] (the corners clip each on its own), then random."""
    special = np.array([-0.5, 0., 0.5, 1., 2., W - 1., W - 0.5, -3.,
                        W + 2.5, 1.25], np.float32)
    x = rng.uniform(-2., W + 1., Q).astype(np.float32)
    y = rng.uniform(-2., H + 1., Q).astype(np.float32)
    n = min(Q, len(special) ** 2)
    gx, gy = np.meshgrid(special, special * H / W)
    x[:n], y[:n] = gx.reshape(-1)[:n], gy.reshape(-1)[:n]
    return x, y


@pytest.mark.parametrize('B,H,W,P,C', [(1, 16, 8, 300, 3), (2, 8, 16, 150, 3),
                                       (3, 2, 2, 64, 2)])
def test_flat_corner_idx(J, B, H, W, P, C):
    x, y = _coords(np.random.default_rng(P), B * P, H, W)
    ids_j, wx_j, wy_j = J.UJ._flat_corner_idx(
        J.jnp.asarray(x), J.jnp.asarray(y), H, W, B, P)
    ids_t, wx_t, wy_t = UT._flat_corner_idx(torch.as_tensor(x),
                                            torch.as_tensor(y), H, W, B, P)
    for a, b in zip(ids_j, ids_t):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_array_equal(wx_t.numpy(), np.asarray(wx_j))
    np.testing.assert_array_equal(wy_t.numpy(), np.asarray(wy_j))


@pytest.mark.parametrize('B,H,W,P,C', [(1, 16, 8, 300, 3), (2, 8, 16, 150, 3),
                                       (3, 2, 2, 64, 2)])
def test_bilinear_sample_and_vjp(J, B, H, W, P, C):
    rng = np.random.default_rng(H * W + P)
    x, y = _coords(rng, B * P, H, W)
    tex = rng.random((B * H * W, C), dtype=np.float32)
    ct = rng.standard_normal((B * P, C)).astype(np.float32)
    hw = (H, W, B, P)
    out_j, vjp = J.jax.vjp(
        lambda t, a, b: J.UJ._bilinear_sample(t, a, b, hw),
        J.jnp.asarray(tex), J.jnp.asarray(x), J.jnp.asarray(y))
    ts = [torch.tensor(a, requires_grad=True) for a in (tex, x, y)]
    out_t = UT._bilinear_sample(*ts, hw)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-5)
    out_t.backward(torch.as_tensor(ct))
    for name, a, b in zip(('dT', 'dx', 'dy'), vjp(J.jnp.asarray(ct)), ts):
        _close(b.grad.numpy(), a, what=name)
    # x == 0 exactly: taps 0 and 1, so dx = g . (v1 - v0), not 0
    at0 = (x == 0.) & (y > 0.) & (y < H - 1.)
    assert at0.any() and (ts[1].grad.numpy()[at0] != 0.).all()


def test_bilinear_plain_versions(J):
    """The plain versions on their own: the forward equals the JAX
    forward's ops; the backward's dT is the tap-by-tap index_add_."""
    B, H, W, P, C = 2, 4, 6, 40, 3
    rng = np.random.default_rng(5)
    x, y = _coords(rng, B * P, H, W)
    tex = rng.random((B * H * W, C), dtype=np.float32)
    g = rng.standard_normal((B * P, C)).astype(np.float32)
    hw = (H, W, B, P)
    args = [torch.as_tensor(a) for a in (tex, x, y)]
    out = _sample._bilinear_forward_torch(*args, hw)
    np.testing.assert_allclose(
        out.numpy(), np.asarray(J.UJ._bilinear_sample(tex, x, y, hw)), rtol=0,
        atol=1e-6)
    dt, dx, dy = _sample._bilinear_backward_torch(*args, torch.as_tensor(g),
                                                  hw)
    (i00, i01, i10, i11), wx, wy = J.UJ._flat_corner_idx(x, y, H, W, B, P)
    wx, wy = np.asarray(wx, np.float64), np.asarray(wy, np.float64)
    ref = np.zeros((B * H * W, C))
    for i, w in ((i00, (1 - wx) * (1 - wy)), (i01, wx * (1 - wy)),
                 (i10, (1 - wx) * wy), (i11, wx * wy)):
        np.add.at(ref, np.asarray(i), g * w[:, None])
    _close(dt.numpy(), ref, rel=1e-6)
    assert dx.shape == dy.shape == (B * P,)
    # the wrappers take the plain versions for CPU tensors only
    assert torch.equal(_sample._bilinear_forward(*args, hw), out)
    meta = [a.to('meta') for a in args]
    with pytest.raises(ValueError, match='device meta'):
        _sample._bilinear_forward(*meta, hw)
    with pytest.raises(ValueError, match='device meta'):
        _sample._bilinear_backward(*meta, torch.zeros(B * P, C,
                                                      device='meta'), hw)


def test_texture_rows_contiguous(monkeypatch):
    """One view's texture rows are a strided view of its (C, H, W) map
    (the trainer expands it over the views); the kernels get contiguous
    rows, as on the card, where they refuse any other."""
    seen = []

    def plain(fn):
        def run(*args):
            seen.extend(a.is_contiguous() for a in args
                        if torch.is_tensor(a))
            return fn(*args)
        return run
    for name in ('_bilinear_forward_torch', '_bilinear_backward_torch'):
        monkeypatch.setattr(_sample, name, plain(getattr(_sample, name)))
    tex = torch.rand(3, 16, 8, requires_grad=True)
    uv = torch.rand(1, 40, 2, requires_grad=True)
    rows = tex[None].expand(1, 3, 16, 8).permute(0, 2, 3, 1).reshape(-1, 3)
    assert not rows.is_contiguous()
    UT.texture_mapping(uv, tex[None].expand(1, 3, 16, 8),
                       mode='bilinear').sum().backward()
    assert seen and all(seen)
    assert tex.grad.abs().sum() > 0 and uv.grad.abs().sum() > 0


def _gather_vjp(J, table, idx, cot):
    out_j, vjp = J.jax.vjp(lambda t: J.GJ.gather_rows(t, J.jnp.asarray(idx)),
                           J.jnp.asarray(table))
    t = torch.tensor(table, requires_grad=True)
    out_t = GT.gather_rows(t, torch.as_tensor(idx))
    out_t.backward(torch.as_tensor(cot))
    return (np.asarray(out_j), out_t.detach().numpy(),
            np.asarray(vjp(J.jnp.asarray(cot))[0]), t.grad.numpy())


@pytest.mark.parametrize('case', ['repeated', 'one_id', 'int64_ids'])
def test_gather_rows_vjp(J, case):
    """Repeated ids, every row on one id, int64 ids: values and the
    scatter-add gradient bit for bit (integer and half terms)."""
    rng = np.random.default_rng(len(case))
    N, D, P = 9, 7, 500
    table = (rng.integers(-8, 8, (N, D)) / 2.).astype(np.float32)
    cot = (rng.integers(-8, 8, (P, D)) / 2.).astype(np.float32)
    if case == 'one_id':
        idx = np.full(P, 4, np.int32)
    else:
        idx = rng.integers(0, N, P).astype(
            np.int64 if case == 'int64_ids' else np.int32)
    out_j, out_t, g_j, g_t = _gather_vjp(J, table, idx, cot)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(g_t, g_j)
    if case == 'one_id':
        assert (g_t[np.arange(N) != 4] == 0.).all()


def test_gather_rows_float_sums(J):
    """Random float terms on a few ids: the sums within 1e-5 of JAX's
    (another order); a row no id names gets 0; a 3-D table."""
    rng = np.random.default_rng(11)
    table = rng.standard_normal((6, 2, 3)).astype(np.float32)
    idx = rng.integers(0, 5, 4000).astype(np.int32)
    cot = rng.standard_normal((4000, 2, 3)).astype(np.float32)
    out_j, out_t, g_j, g_t = _gather_vjp(J, table, idx, cot)
    np.testing.assert_array_equal(out_t, out_j)
    _close(g_t, g_j, rel=1e-5)
    assert (g_t[5] == 0.).all()
    s = _scatter._scatter_rows_torch(torch.as_tensor(cot),
                                     torch.as_tensor(idx), 6)
    assert torch.equal(s, torch.as_tensor(g_t))
    with pytest.raises(ValueError, match='device meta'):
        _scatter._scatter_rows(torch.zeros(3, 2, device='meta'),
                               torch.zeros(3, dtype=torch.int32,
                                           device='meta'), 4)


def _epilogue_scene(seed, B=2, F=300, H=48, W=40, C=5):
    rng = np.random.default_rng(seed)
    cent = rng.uniform(-0.9, 0.9, (B, F, 1, 2))
    fvi = (cent + rng.uniform(-0.15, 0.15, (B, F, 3, 2))).astype(np.float32)
    feats = rng.standard_normal((B, F, 3, C)).astype(np.float32)
    face_idx = rng.integers(-1, F, (B, H, W)).astype(np.int32)
    face_idx[:, :H // 3] = -1             # a long background run per view
    return fvi, feats, face_idx


@pytest.mark.parametrize('seed', [0, 1])
def test_interpolate_selected_batched(J, seed):
    """One combined gather of the (B*F, 6 + 3C) table against the JAX
    package's: image features and weights, and their gradients to the
    image-space vertices and the features."""
    fvi, feats, face_idx = _epilogue_scene(seed)
    B, H, W = face_idx.shape
    mult, eps = 1000., 1e-8
    xs_j, ys_j = J.RJ.pixel_coords(H, W, mult)
    xs_t, ys_t = RT.pixel_coords(H, W, mult, device='cpu')
    rng = np.random.default_rng(seed + 7)
    ct_f = rng.standard_normal((B, H, W, feats.shape[-1])).astype(np.float32)
    ct_w = rng.standard_normal((B, H, W, 3)).astype(np.float32)

    def f_j(v, f):
        return J.RJ._interpolate_selected_batched(
            J.jnp.asarray(face_idx), v * mult, f, xs_j, ys_j, eps)
    (fe_j, w_j), vjp = J.jax.vjp(f_j, J.jnp.asarray(fvi), J.jnp.asarray(feats))
    v_t = torch.tensor(fvi, requires_grad=True)
    f_t = torch.tensor(feats, requires_grad=True)
    fe_t, w_t = RT._interpolate_selected_batched(
        torch.as_tensor(face_idx), v_t * mult, f_t, xs_t, ys_t, eps)
    np.testing.assert_allclose(fe_t.detach().numpy(), np.asarray(fe_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w_t.detach().numpy(), np.asarray(w_j),
                               rtol=1e-5, atol=1e-5)
    torch.autograd.backward([fe_t, w_t], [torch.as_tensor(ct_f),
                                          torch.as_tensor(ct_w)])
    g_v, g_f = vjp((J.jnp.asarray(ct_f), J.jnp.asarray(ct_w)))
    _close(v_t.grad.numpy(), g_v, what='vertices')
    _close(f_t.grad.numpy(), g_f, what='features')


@pytest.fixture(scope='module')
def dibr_scene():
    sphere = uv_sphere(16, 9)
    rng = np.random.default_rng(3)
    verts = (sphere.vertices * 0.5 + 0.02 * rng.standard_normal(
        sphere.vertices.shape)).astype(np.float32)
    sh = np.zeros(9, np.float32)
    sh[0] = 3.
    sh[1:] = 0.3 * rng.standard_normal(8)
    return dict(verts=verts, tex=rng.random((3, 16, 8), dtype=np.float32),
                sh=sh, faces=sphere.faces,
                face_uvs=sphere.uvs[sphere.face_uvs_idx],
                images=rng.random((2, 64, 64, 3), dtype=np.float32),
                masks=(rng.random((2, 64, 64)) > 0.5).astype(np.float32))


@pytest.mark.parametrize('backend', ['fused', 'jnp'])
def test_render_loss_grads(J, dibr_scene, backend):
    """The whole DIB-R loss at 64^2, 2 views, a 16 x 8 texture: the loss
    within rtol 1e-5 and the vertex, texture and SH gradients within
    1e-4 * max|g_jax| of the JAX package's (its selection in interpret
    mode for 'fused')."""
    s, H = dibr_scene, 64
    params = J.MJ.InverseRenderParams(*(J.jnp.asarray(s[k])
                                        for k in ('verts', 'tex', 'sh')))
    views_t = MT.make_views(2, device='cpu')
    views_j = J.MJ.CameraViews(*(J.jnp.asarray(v.numpy()) for v in views_t))
    faces, uvs = J.jnp.asarray(s['faces']), J.jnp.asarray(s['face_uvs'])
    sel = J.MJ.compute_selection(params, views_j, faces, H, H, backend=backend)
    loss_j, g_j = J.jax.value_and_grad(lambda p: J.MJ.render_loss(
        p, views_j, faces, uvs, J.jnp.asarray(s['images']),
        J.jnp.asarray(s['masks']), H, H, backend=backend,
        selection=sel))(params)
    model = MT.from_jax_params(s['verts'], s['tex'], s['sh'], device='cpu')
    faces_t, uvs_t = (torch.as_tensor(s[k]) for k in ('faces', 'face_uvs'))
    sel_t = MT.compute_selection(model, views_t, faces_t, H, H,
                                 backend=backend)
    np.testing.assert_array_equal(sel_t[0].numpy(), np.asarray(sel[0]))
    loss = MT.render_loss(model, views_t, faces_t, uvs_t,
                          torch.as_tensor(s['images']),
                          torch.as_tensor(s['masks']), H, H,
                          backend=backend, selection=sel_t)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_j), rtol=1e-5)
    for name in ('vertices', 'texture_map', 'sh_coeffs'):
        _close(getattr(model, name).grad.numpy(), getattr(g_j, name),
               what=name)


# ---------------------------------------------------------------------------
# card-only: the kernels against their plain versions, twice

def _card_sample(B, H, W, P, C, seed):
    rng = np.random.default_rng(seed)
    x, y = _coords(rng, B * P, H, W)
    return [torch.as_tensor(a, device='cuda') for a in (
        rng.random((B * H * W, C), dtype=np.float32), x, y,
        rng.standard_normal((B * P, C)).astype(np.float32))]


def _bits(t):
    return t.contiguous().view(torch.int32)


@cuda
@pytest.mark.parametrize('B,H,W,P,C', [(4, 256, 256, 65536, 3),
                                       (2, 2, 2, 100000, 3),
                                       (1, 16, 8, 999, 5)])
def test_cuda_bilinear_against_plain(B, H, W, P, C):
    tex, x, y, g = _card_sample(B, H, W, P, C, seed=B + W)
    hw = (H, W, B, P)
    before = dict(_sample.LAUNCHES)
    out = _sample._bilinear_forward_cuda(tex, x, y, hw)
    assert torch.equal(out, _sample._bilinear_forward_torch(tex, x, y, hw))
    runs = [_sample._bilinear_backward_cuda(tex, x, y, g, hw)
            for _ in range(2)]
    assert _sample.LAUNCHES['sample'] == before['sample'] + 1
    assert _sample.LAUNCHES['sample_bwd'] == before['sample_bwd'] + 2
    for a, b in zip(*runs):
        assert torch.equal(_bits(a), _bits(b))     # the same bits
    plain = _sample._bilinear_backward_torch(tex, x, y, g, hw)
    for name, k, p in zip(('dT', 'dx', 'dy'), runs[0], plain):
        scale = p.abs().max().item()
        assert scale > 0, name
        assert (k - p).abs().max().item() <= CARD_REL * scale, name
    # dT against a float64 sum: a 2 x 2 texture holds ~Q taps per texel
    ref = _sample._bilinear_backward_torch(tex.double(), x.double(),
                                           y.double(), g.double(), hw)[0]
    assert (runs[0][0].double() - ref).abs().max().item() <= \
        CARD_REL * ref.abs().max().item()


@cuda
@pytest.mark.parametrize('N,D,P,case', [(40000, 21, 1 << 20, 'dibr'),
                                        (7, 21, 300000, 'one_id'),
                                        (1000, 3, 5000, 'random')])
def test_cuda_scatter_against_plain(N, D, P, case):
    rng = np.random.default_rng(N)
    if case == 'one_id':
        idx = np.full(P, 3)
    elif case == 'dibr':     # ~57 % background, on row 0 of each view
        idx = rng.integers(0, N, P)
        view = np.arange(P) * 4 // P
        bg = rng.random(P) < 0.57
        idx[bg] = view[bg] * (N // 4)
    else:
        idx = rng.integers(0, N, P)
    g = torch.as_tensor(rng.standard_normal((P, D)).astype(np.float32),
                        device='cuda')
    idx = torch.as_tensor(idx.astype(np.int32), device='cuda')
    before = _scatter.LAUNCHES['scatter']
    runs = [_scatter._scatter_rows_cuda(g, idx, N) for _ in range(2)]
    assert _scatter.LAUNCHES['scatter'] == before + 2
    assert torch.equal(_bits(runs[0]), _bits(runs[1]))
    ref = _scatter._scatter_rows_torch(g.double(), idx, N)
    plain = _scatter._scatter_rows_torch(g, idx, N)
    scale = ref.abs().max().item()
    assert (runs[0].double() - ref).abs().max().item() <= CARD_REL * scale
    assert (plain.double() - ref).abs().max().item() <= 1e-3 * scale
    untouched = torch.ones(N, dtype=torch.bool, device='cuda')
    untouched[idx.long()] = False
    assert (runs[0][untouched] == 0.).all()


@cuda
def test_cuda_gather_rows_and_texture_mapping():
    """The autograd paths on the card: gather_rows' backward is E3 and
    texture_mapping's bilinear backward E2, against the CPU."""
    rng = np.random.default_rng(2)
    uv = rng.uniform(-0.2, 1.2, (2, 500, 2)).astype(np.float32)
    tex = rng.random((2, 3, 16, 8), dtype=np.float32)
    ct = rng.standard_normal((2, 500, 3)).astype(np.float32)
    grads = {}
    for dev in ('cpu', 'cuda'):
        ts = [torch.tensor(a, device=dev, requires_grad=True)
              for a in (uv, tex)]
        for mode in ('bilinear', 'nearest'):
            out = UT.texture_mapping(*ts, mode=mode)
            out.backward(torch.as_tensor(ct, device=dev))
        grads[dev] = [t.grad.cpu().numpy() for t in ts]
    for a, b in zip(grads['cpu'], grads['cuda']):
        _close(b, a, rel=CARD_REL)


@cuda
def test_cuda_wrappers_refuse_other_inputs():
    """The module route refuses what the kernels do not take, and the
    wrappers raise the precise error (no fallback to the plain versions)."""
    tex, x, y, g = _card_sample(1, 4, 4, 10, 3, seed=0)
    hw = (4, 4, 1, 10)
    with pytest.raises(ValueError, match='tex_rows.*torch.float64'):
        _sample._bilinear_forward_cuda(tex.double(), x, y, hw)
    with pytest.raises(ValueError, match='g:.*on cpu'):
        _sample._bilinear_backward_cuda(tex, x, y, g.cpu(), hw)
    idx = torch.zeros(10, dtype=torch.int32, device='cuda')
    with pytest.raises(ValueError, match='g:.*torch.float64'):
        _scatter._scatter_rows_cuda(g.double(), idx, 4)
