"""The DIB-R per-pixel chain as one autograd Function of hand-written
kernels (``render/mesh/_shade.py``, ``csrc/shade.cuh``) against its plain
version, the PyTorch composition ``render_views`` and ``render_loss``
computed before it.

On the CPU ``shade_loss`` is the plain version; the kernels' constants are
held against it.  (The plain version against the JAX package:
``test_torch_epilogue.py::test_render_loss_grads``.)

Card-only cases (skipped without one), the kernels against the plain
version on the card (where it runs E1-E3), at the 10k cell's shapes
(10,000 faces, 4 views of 512^2, a 256^2 texture) and at 64^2:

* the loss terms within rtol 1e-5: the L1 mean and the IoU sums over up to
  1M pixels are added by CTA and then in a fixed order, PyTorch's
  reductions in another (float32 rounding, ~1e-7 a term);
* the gradients of the corners, the normals, the texture, the SH, the soft
  mask and, through the whole step, the vertices within 1e-4 * max|g|:
  each is a sum over pixels taken in another order (E2 adds every view's
  taps of a texel in one sorted run where the plain version adds view by
  view; each pixel's three corners' normal gradients are added before E3
  adds the pixels; the SH by CTA), and the per-pixel chain's own sums (the
  SH bands, the channels) in another order; a rule broken at one pixel
  moves a gradient by far more;
* the albedo equal to E1's bit for bit: with the SH's DC term alone the
  lighting is one product in both versions, and with the plain version's
  images as targets every d albedo is 0 exactly where the images are
  equal; the texel coordinates handed to E2 equal those the plain version
  hands E1;
* black texels (the image on the lower edge of its clip) and clip ties;
* an all-background view and a fully covered view;
* two launches of the same inputs give the same bits;
* a replay of ``compiled_step`` equal to the eager step bit for bit, the
  launches counted once a replay; a capture of the Function's forward and
  backward under ``torch.cuda.set_sync_debug_mode('error')``;
* the entry's refusal naming the input.

The card's cases run where the JAX package does not import:
``python -m pytest --noconftest tests/test_torch_shade.py``.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kaolin_tpu_torch.metrics import render as RM
from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.render import camera as camera_fns
from kaolin_tpu_torch.render.mesh import _sample, _shade
from kaolin_tpu_torch.render.mesh import utils as UT
from kaolin_tpu_torch.utils.testing import uv_sphere

# evaluated when the test runs, not at import
cuda = pytest.mark.skipif('not torch.cuda.is_available()',
                          reason='needs a CUDA card (run on the H100)')

LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
LEAVES = ('fvi', 'fn', 'tex', 'sh', 'soft')
CELL10K = dict(sphere=(100, 51), height=512, views=4, texture_res=256)
SMALL = dict(sphere=(16, 9), height=64, views=2, texture_res=16)


def _views(eyes, ats, device):
    """CameraViews from eye and look-at points, make_views' projection."""
    eye = torch.tensor(eyes, dtype=torch.float32, device=device)
    at = torch.tensor(ats, dtype=torch.float32, device=device)
    up = torch.tensor([0., 1., 0.], device=device).expand(len(eyes), 3)
    rot, trans = camera_fns.generate_rotate_translate_matrices(eye, at, up)
    proj = camera_fns.generate_perspective_projection(np.pi / 4.,
                                                      device=device)
    return MT.CameraViews(rot, trans, proj)


def make_scene(device, sphere, height, views, texture_res, seed=0,
               sh_dc_only=False, black=False, camera_views=None):
    """A perturbed sphere, its selection and the Function's inputs as
    leaves (corners, normals, texture, SH, soft mask) with seeded
    targets."""
    s = uv_sphere(*sphere)
    rng = np.random.default_rng(seed)
    verts = (s.vertices * 0.5 + 0.01 * rng.standard_normal(
        s.vertices.shape)).astype(np.float32)
    tex = rng.random((3, texture_res, texture_res), dtype=np.float32)
    if black:
        tex[:, :texture_res // 2] = 0.
    sh = np.zeros(9, np.float32)
    sh[0] = 3.
    if not sh_dc_only:
        sh[1:] = 0.3 * rng.standard_normal(8)
    model = MT.from_jax_params(verts, tex, sh, device=device)
    v = camera_views or MT.make_views(views, device=device)
    faces = torch.as_tensor(s.faces, device=device)
    face_uvs = torch.as_tensor(s.uvs[s.face_uvs_idx], dtype=torch.float32,
                               device=device)
    H = height
    B = v.camera_rot.shape[0]
    sel = MT.compute_selection(model, v, faces, H, H)
    with torch.no_grad():
        _, fvi, fn = MT._prepare(model, v, faces)
        soft = MT._soft_mask(fvi, sel, True, MT._SIGMAINV, 30)

    def t(a):
        return torch.as_tensor(a, device=device)
    return dict(
        model=model, views=v, faces=faces, face_uvs=face_uvs, sel=sel,
        fid=sel[0], fvi=fvi.clone().requires_grad_(),
        fn=fn.clone().requires_grad_(),
        tex=model.texture_map.detach().clone().requires_grad_(),
        sh=model.sh_coeffs.detach().clone().requires_grad_(),
        soft=soft.clone().requires_grad_(),
        timg=t(rng.random((B, H, H, 3), dtype=np.float32)),
        tmask=t((rng.random((B, H, H)) > 0.5).astype(np.float32)))


def _terms(fn, sc):
    return fn(sc['fid'], sc['fvi'], sc['fn'], sc['face_uvs'], sc['tex'],
              sc['sh'], sc['soft'], sc['timg'], sc['tmask'])


def run(fn, sc):
    """The two loss terms of ``fn`` (shade_loss or its plain version) and
    the gradients of image_loss + 0.5 mask_loss to the leaves."""
    for k in LEAVES:
        sc[k].grad = None
    image_loss, mask_loss = _terms(fn, sc)
    (image_loss + 0.5 * mask_loss).backward()
    return ((image_loss.detach(), mask_loss.detach()),
            {k: sc[k].grad.clone() for k in LEAVES})


def _close(got, want, rel, what):
    scale = want.abs().max().item()
    assert scale > 0, what
    err = (got - want).abs().max().item()
    assert err <= rel * scale, f'{what}: max|d| {err:.3e} of {scale:.3e}'


def against_plain(sc):
    """The kernels against the plain version on the same inputs."""
    terms_k, grads_k = run(_shade.shade_loss, sc)
    terms_p, grads_p = run(_shade._shade_loss_torch, sc)
    for a, b, name in zip(terms_k, terms_p, ('image', 'mask')):
        assert abs(a.item() - b.item()) <= LOSS_RTOL * abs(b.item()), name
    for k in LEAVES:
        _close(grads_k[k], grads_p[k], GRAD_REL, k)
    return grads_k


# ---------------------------------------------------------------------------
# CPU

def test_cpu_shade_loss_is_the_plain_version():
    sc = make_scene('cpu', **SMALL)
    before = dict(_shade.LAUNCHES)
    terms, grads = run(_shade.shade_loss, sc)
    terms_p, grads_p = run(_shade._shade_loss_torch, sc)
    assert _shade.LAUNCHES == before
    for a, b in zip(terms, terms_p):
        assert torch.equal(a, b)
    for k in LEAVES:
        assert torch.equal(grads[k], grads_p[k]), k
    meta = {k: (v.to('meta') if torch.is_tensor(v) else v)
            for k, v in sc.items()}
    with pytest.raises(ValueError, match='device meta'):
        _terms(_shade.shade_loss, meta)


def test_cpu_render_loss_sums_the_terms():
    """render_loss is image_loss + mask_loss of render_views' images and
    soft mask."""
    sc = make_scene('cpu', **SMALL)
    H = SMALL['height']
    with torch.no_grad():
        loss = MT.render_loss(sc['model'], sc['views'], sc['faces'],
                              sc['face_uvs'], sc['timg'], sc['tmask'], H, H,
                              selection=sc['sel'])
        images, soft, fid = MT.render_views(
            sc['model'], sc['views'], sc['faces'], sc['face_uvs'], H, H,
            selection=sc['sel'])
        image_loss, mask_loss = _terms(_shade._shade_loss_torch, sc)
    assert torch.equal(fid, sc['fid'])
    assert torch.equal(soft, sc['soft'])
    assert torch.equal(torch.mean(torch.abs(images - sc['timg'])),
                       image_loss)
    assert torch.equal(loss, image_loss + mask_loss)


def test_kernel_constants_are_the_plain_versions():
    """The SH bands' and the IoU's constants in ``csrc/shade.cuh`` are the
    plain version's, as written."""
    src = (Path(_shade.__file__).parents[2] / 'csrc' /
           'shade.cuh').read_text()
    kernel = set(re.findall(r'constexpr float \w+ = \(float\)([0-9.e-]+);',
                            src))
    plain = set(re.findall(r'(\d\.\d{6,})', Path(UT.__file__).read_text()))
    assert kernel == plain | {'1e-10'}
    assert '1e-10' in Path(RM.__file__).read_text()


# ---------------------------------------------------------------------------
# card-only

@cuda
@pytest.mark.parametrize('shape', [CELL10K, SMALL], ids=['cell10k', '64'])
def test_cuda_shade_against_plain(monkeypatch, shape):
    sc = make_scene('cuda', **shape)
    before = dict(_shade.LAUNCHES)
    against_plain(sc)
    assert _shade.LAUNCHES == {k: v + 1 for k, v in before.items()}
    # the vertices, through the whole step
    H = shape['height']
    grads = {}
    for name, fn in (('kernels', _shade.shade_loss),
                     ('plain', _shade._shade_loss_torch)):
        model = MT.from_jax_params(*(p.detach().cpu().numpy() for p in (
            sc['model'].vertices, sc['tex'], sc['sh'])), device='cuda')
        with monkeypatch.context() as m:
            m.setattr(_shade, 'shade_loss', fn)
            MT.render_loss(model, sc['views'], sc['faces'], sc['face_uvs'],
                           sc['timg'], sc['tmask'], H, H,
                           selection=sc['sel']).backward()
        grads[name] = [p.grad for p in model.parameters()]
    for a, b, what in zip(grads['kernels'], grads['plain'],
                          ('vertices', 'texture', 'sh')):
        _close(a, b, GRAD_REL, what)


@cuda
def test_cuda_albedo_is_e1s(monkeypatch):
    sc = make_scene('cuda', **CELL10K, sh_dc_only=True)
    seen = []

    def recorded(tex_rows, x, y, hw):
        out = _sample._bilinear_forward_cuda(tex_rows, x, y, hw)
        seen.append((x, y, out))
        return out
    monkeypatch.setattr(_sample, '_bilinear_forward', recorded)
    with torch.no_grad():
        images = _shade.shade_images(sc['fid'], sc['fvi'], sc['fn'],
                                     sc['face_uvs'], sc['tex'], sc['sh'])
    (x, y, albedo), = seen
    assert (images[sc['fid'] >= 0] > 0.).any()
    assert (images < 1.).all()        # no upper clip hides a difference
    hw = tuple(sc['tex'].shape[1:])
    tex_rows = sc['tex'].detach().permute(1, 2, 0).reshape(-1, 3).contiguous()
    inputs = (sc['fid'], sc['fvi'].detach(), sc['fn'].detach(),
              sc['face_uvs'], tex_rows, sc['sh'].detach(),
              sc['soft'].detach(), images.contiguous(), sc['tmask'])
    _, _, iou = _shade._shade_forward_cuda(inputs, hw)
    one, zero = (torch.full((), v, device='cuda') for v in (1., 0.))
    d_albedo, tx, ty, *_ = _shade._shade_backward_cuda(
        inputs, iou, one, zero, hw)
    assert torch.equal(tx, x) and torch.equal(ty, y)
    assert (d_albedo == 0.).all()
    assert torch.equal(_sample._bilinear_forward_cuda(
        tex_rows, tx, ty, (*hw, 1, tx.shape[0])), albedo)


@cuda
def test_cuda_black_texels_and_clip_ties():
    sc = make_scene('cuda', **SMALL, black=True)
    with torch.no_grad():
        images = _shade.shade_images(sc['fid'], sc['fvi'], sc['fn'],
                                     sc['face_uvs'], sc['tex'], sc['sh'])
    assert ((images == 0.).all(-1) & (sc['fid'] >= 0)).sum() > 50
    against_plain(sc)


@cuda
def test_cuda_background_and_covered_views():
    # view 0 looks 45 degrees away from the sphere, outside its 22.5 degree
    # half field; view 1 sits 0.25 from its surface, inside its silhouette
    views = _views([[0., 0., 3.], [0., 0., 0.75]],
                   [[3., 0., 0.], [0., 0., 0.]], 'cuda')
    sc = make_scene('cuda', **SMALL, camera_views=views)
    assert (sc['fid'][0] < 0).all() and (sc['fid'][1] >= 0).all()
    against_plain(sc)


@cuda
def test_cuda_two_launches_bit_equal():
    sc = make_scene('cuda', **CELL10K)
    runs = [run(_shade.shade_loss, sc) for _ in range(2)]
    for a, b in zip(runs[0][0], runs[1][0]):
        assert torch.equal(a, b)
    for k in LEAVES:
        assert torch.equal(runs[0][1][k], runs[1][1][k]), k


@cuda
def test_cuda_replay_bit_equal_and_counted():
    sc = make_scene('cuda', **SMALL)
    H = SMALL['height']
    models = [MT.from_jax_params(*(p.detach().cpu().numpy() for p in (
        sc['model'].vertices, sc['tex'], sc['sh'])), device='cuda')
        for _ in range(2)]
    opts = [torch.optim.Adam(m.parameters(), lr=5e-3, capturable=True)
            for m in models]
    step = MT.compiled_step(models[0], sc['views'], sc['faces'],
                            sc['face_uvs'], sc['timg'], sc['tmask'], H, H,
                            opts[0])
    before = dict(_shade.LAUNCHES)
    loss = step(sc['views'], sc['timg'], sc['tmask'])
    assert _shade.LAUNCHES == {k: v + 1 for k, v in before.items()}
    sel = MT.compute_selection(models[1], sc['views'], sc['faces'], H, H)
    loss_e = MT.render_loss(models[1], sc['views'], sc['faces'],
                            sc['face_uvs'], sc['timg'], sc['tmask'], H, H,
                            selection=sel)
    loss_e.backward()
    assert torch.equal(loss, loss_e.detach())
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(a.grad, b.grad)


@cuda
def test_cuda_capture_waits_for_nothing():
    sc = make_scene('cuda', **SMALL)
    eager = run(_shade.shade_loss, sc)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    torch.cuda.set_sync_debug_mode('error')
    try:
        with torch.cuda.stream(side):
            run(_shade.shade_loss, sc)                  # warm-up
        torch.cuda.current_stream().wait_stream(side)
        for k in LEAVES:
            sc[k].grad = None
        with torch.cuda.graph(graph):
            terms = _terms(_shade.shade_loss, sc)
            (terms[0] + 0.5 * terms[1]).backward()
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for a, b in zip(terms, eager[0]):
        assert torch.equal(a, b)
    for k in LEAVES:
        assert torch.equal(sc[k].grad, eager[1][k]), k


@cuda
def test_cuda_shade_refuses_what_it_does_not_take():
    sc = make_scene('cuda', **SMALL)
    sc['fid'] = sc['fid'].long()
    with pytest.raises(ValueError, match='face_idx.*torch.int32'):
        _terms(_shade.shade_loss, sc)
    sc = make_scene('cuda', **SMALL)
    sc['tex'] = sc['tex'][:2]
    with pytest.raises(ValueError, match='tex_rows'):
        _terms(_shade.shade_loss, sc)
