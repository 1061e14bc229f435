"""DIB-R++ (``models/dibrpp.py``): shape, material and 32 SG lights fitted
through the DIB-R step.

On the CPU, at 32^2, 2 views, 256 faces and all 32 lights:

* the loss and each leaf's gradient against the plain reference
  (``models/dibrpp_reference.py``), which rasterizes, shades and reduces
  on its own; the tolerances and their reasons are beside the constants;
* the images and soft silhouettes against the reference's;
* :func:`~kaolin_tpu_torch.models.inverse_render.compiled_step` with
  ``loss_fn=dibrpp.render_loss`` equals three eager steps bit for bit (on
  one thread, as ``test_torch_compiled_step.py`` holds the SH step), every
  leaf in Adam's state;
* a step reads nothing back to the host (``test_torch_compiled_step.py``'s
  patching);
* under a profiler the SG forward's span ``dibr.sg`` lies in
  ``dibr.render`` and its backward's ``dibr.sg_backward`` in
  ``autograd.backward``.

On a card (skipped without one): three graph replays against three eager
steps (the first bit for bit, later losses within rtol 1e-4), and a
profiled replay that holds the two SG spans' marks.
"""

import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kaolin_tpu_torch.models import dibrpp as D
from kaolin_tpu_torch.models import dibrpp_reference as R
from kaolin_tpu_torch.models import inverse_render as IR
from kaolin_tpu_torch.ops import _scatter as SCT
from kaolin_tpu_torch.render.mesh import _fused as FT
from kaolin_tpu_torch.render.mesh import _sample as SAT
from kaolin_tpu_torch.utils.profiler import span
from test_torch_compiled_step import _HostReads, _one_thread

H = W = 32
VIEWS = 2
STEPS = 3
LR = 5e-3
# the loss: both sides sum the same per-pixel terms; the soft mask's product
# is taken in another order (1e-7) and the images agree to ~4e-7
LOSS_RTOL = 1e-5
# each leaf's gradient within this share of its largest entry: the two
# sides interpolate, normalise and sum in other orders, and the soft
# mask's gradient divides its product (1 - p + 1e-7) where the reference
# differentiates the product; measured <= 4.3e-6 (the lights' angles)
GRAD_REL = 1e-4
IMAGE_ATOL = 1e-5           # measured 4.2e-7
MASK_ATOL = 1e-6            # measured 6e-8
REPLAY_LOSS_RTOL = 1e-4     # test_torch_compiled_step.py's

cuda = pytest.mark.skipif('not torch.cuda.is_available()',
                          reason='needs a CUDA card (run on the H100)')


@pytest.fixture(scope='module')
def scene():
    """Numpy inputs: a perturbed half-size UV sphere, a material map with
    the ground truth's roughness range, 32 lights in path C's ranges,
    random targets."""
    from kaolin_tpu_torch.utils.testing import uv_sphere
    sphere = uv_sphere(16, 9)
    rng = np.random.default_rng(26)
    verts = (sphere.vertices * 0.5 + 0.02 * rng.standard_normal(
        sphere.vertices.shape)).astype(np.float32)
    material = rng.random((4, 16, 16), dtype=np.float32)
    material[3] = 0.2 + 0.4 * material[3]
    lights = [rng.uniform(0.5, 2., (D.LOBES, 3)),
              rng.uniform(0., 2. * math.pi, D.LOBES),
              rng.uniform(-1., 1.3, D.LOBES), rng.uniform(5., 30., D.LOBES)]
    views = [v.numpy() for v in IR.make_views(VIEWS, device='cpu')]
    return dict(
        params=[verts, material] + [x.astype(np.float32) for x in lights],
        views=views, faces=sphere.faces,
        face_uvs=sphere.uvs[sphere.face_uvs_idx],
        target_images=rng.random((VIEWS, H, W, 3), dtype=np.float32),
        target_masks=(rng.random((VIEWS, H, W)) > 0.5).astype(np.float32))


def _inputs(scene, device='cpu'):
    """(model, views, faces, face_uvs, target images, target masks), each a
    copy of the scene's arrays (the steps update the model in place)."""
    def t(a):
        return torch.tensor(a, device=device)
    return (D.DIBRPP(*(t(p) for p in scene['params'])),
            IR.CameraViews(*map(t, scene['views'])), t(scene['faces']),
            t(scene['face_uvs']), t(scene['target_images']),
            t(scene['target_masks']))


def _adam(model, device='cpu'):
    return torch.optim.Adam(model.parameters(), lr=LR,
                            capturable=torch.device(device).type == 'cuda')


def _eager_step(model, opt, views, faces, face_uvs, images, masks):
    sel = IR.compute_selection(model, views, faces, H, W, backend='fused')
    opt.zero_grad()
    loss = D.render_loss(model, views, faces, face_uvs, images, masks, H, W,
                         backend='fused', selection=sel)
    loss.backward()
    opt.step()
    return loss.detach()


def _record(model, loss):
    return dict(loss=loss.clone(),
                grads=[p.grad.clone() for p in model.parameters()],
                params=[p.detach().clone() for p in model.parameters()])


def test_loss_and_grads_against_reference(scene):
    model, views, faces, face_uvs, images, masks = _inputs(scene)
    loss = D.render_loss(model, views, faces, face_uvs, images, masks, H, W,
                         backend='fused')
    loss.backward()
    want, grads = R.loss_and_grads(
        [torch.tensor(p) for p in scene['params']], views, faces,
        face_uvs, images, masks, H, W)
    assert abs(loss.item() - want.item()) <= LOSS_RTOL * abs(want.item())
    for name, p, g in zip(D.DIBRPPParams._fields, model.parameters(),
                          grads):
        scale = g.abs().max().item()
        assert scale > 0, name
        assert (p.grad - g).abs().max().item() <= GRAD_REL * scale, name


def test_images_against_reference(scene):
    model, views, faces, face_uvs, _, _ = _inputs(scene)
    with torch.no_grad():
        images, soft, face_idx = D.render_views(model, views, faces,
                                                face_uvs, H, W,
                                                backend='fused')
        want_images, want_soft = R.render(
            [torch.tensor(p) for p in scene['params']], *views, faces,
            face_uvs, H, W)
    covered = (face_idx >= 0).float().mean().item()
    assert 0.1 < covered < 0.9
    assert (images - want_images).abs().max().item() <= IMAGE_ATOL
    assert (soft - want_soft).abs().max().item() <= MASK_ATOL


def test_compiled_step_equals_eager_steps(scene):
    with _one_thread():
        model, views, faces, face_uvs, images, masks = _inputs(scene)
        opt = _adam(model)
        step = IR.compiled_step(model, views, faces, face_uvs, images, masks,
                                H, W, opt, backend='fused',
                                loss_fn=D.render_loss)
        compiled = [_record(model, step(views, images, masks))
                    for _ in range(STEPS)]
        model_e, *_ = _inputs(scene)
        opt_e = _adam(model_e)
        eager = [_record(model_e, _eager_step(model_e, opt_e, views, faces,
                                              face_uvs, images, masks))
                 for _ in range(STEPS)]
    assert len(opt.state) == len(D.DIBRPPParams._fields)
    for c, e in zip(compiled, eager):
        assert torch.equal(c['loss'], e['loss'])
        for key in ('grads', 'params'):
            for a, b in zip(c[key], e[key]):
                assert torch.equal(a, b)
    assert compiled[-1]['loss'] < compiled[0]['loss']


def test_step_reads_nothing_back(scene, monkeypatch):
    model, views, faces, face_uvs, images, masks = _inputs(scene)
    opt = _adam(model)
    step = IR.compiled_step(model, views, faces, face_uvs, images, masks, H,
                            W, opt, backend='fused', loss_fn=D.render_loss)
    guard = _HostReads(monkeypatch)
    for mod, name in ((FT, '_fused_forward_torch'),
                      (FT, '_fused_backward_torch'),
                      (SAT, '_bilinear_forward_torch'),
                      (SAT, '_bilinear_backward_torch'),
                      (SCT, '_scatter_rows_torch')):
        monkeypatch.setattr(mod, name, guard.lifting(getattr(mod, name)))
    monkeypatch.setattr(opt, 'step', guard.lifting(opt.step))
    guard.seen.clear()
    loss = step(views, images, masks)
    assert guard.seen == []
    monkeypatch.undo()
    assert torch.isfinite(loss) and loss.shape == ()
    assert all(p.grad is not None and bool(torch.isfinite(p.grad).all())
               for p in model.parameters())


def test_sg_spans_nest_in_the_step(scene):
    model, views, faces, face_uvs, images, masks = _inputs(scene)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sel = IR.compute_selection(model, views, faces, H, W,
                                   backend='fused')
        loss = D.render_loss(model, views, faces, face_uvs, images, masks, H,
                             W, backend='fused', selection=sel)
        with span('autograd.backward', torch.device('cpu')):
            loss.backward()
    spans = {}
    for e in prof.events():
        spans.setdefault(e.name, []).append((e.time_range.start,
                                             e.time_range.end))
    (sg,), (sg_bwd,) = spans['dibr.sg'], spans['dibr.sg_backward']
    (render,), (backward,) = spans['dibr.render'], spans['autograd.backward']
    assert render[0] <= sg[0] and sg[1] <= render[1]
    assert backward[0] <= sg_bwd[0] and sg_bwd[1] <= backward[1]


def test_no_grad_shading_opens_no_function(scene):
    """Without gradients the shading runs the terms directly (no inner
    graph is built), with the same values."""
    model, views, faces, face_uvs, _, _ = _inputs(scene)
    with torch.no_grad():
        a = D.render_views(model, views, faces, face_uvs, H, W,
                           backend='fused')[0]
    b = D.render_views(model, views, faces, face_uvs, H, W,
                       backend='fused')[0]
    assert b.grad_fn is not None
    assert torch.equal(a, b.detach())


@cuda
def test_cuda_replay_against_eager(scene):
    model, views, faces, face_uvs, images, masks = _inputs(scene, 'cuda')
    model_e, *_ = _inputs(scene, 'cuda')
    opt, opt_e = _adam(model, 'cuda'), _adam(model_e, 'cuda')
    step = IR.compiled_step(model, views, faces, face_uvs, images, masks, H,
                            W, opt, backend='fused', loss_fn=D.render_loss)
    assert step.graph is not None
    for k in range(STEPS):
        loss = step(views, images, masks)
        loss_e = _eager_step(model_e, opt_e, views, faces, face_uvs, images,
                             masks)
        torch.cuda.synchronize()
        if k == 0:          # from the same parameters
            assert torch.equal(loss, loss_e)
            for p, p_e in zip(model.parameters(), model_e.parameters()):
                assert torch.equal(p.grad, p_e.grad)
        assert abs(loss.item() - loss_e.item()) <= \
            REPLAY_LOSS_RTOL * abs(loss_e.item())


@cuda
def test_cuda_replay_holds_the_sg_marks(scene):
    model, views, faces, face_uvs, images, masks = _inputs(scene, 'cuda')
    step = IR.compiled_step(model, views, faces, face_uvs, images, masks, H,
                            W, _adam(model, 'cuda'), backend='fused',
                            loss_fn=D.render_loss)
    step(views, images, masks)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(views, images, masks)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    for slug in ('dibr_sg', 'dibr_sg_backward', 'dibr_render',
                 'autograd_backward'):
        assert names.count(f'kt_span_begin_{slug}') == 1, slug
        assert names.count(f'kt_span_end_{slug}') == 1, slug
