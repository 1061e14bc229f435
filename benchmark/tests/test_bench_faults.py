"""Whole runs at small sizes with the timed path broken underneath: the
comparison has to come out as not correct, once for each fault the cell
can have.  The card check is skipped (the drivers run on the CPU)."""

import pytest
import torch

from conftest import drive, small_dibr, small_spc


def _not_correct(out):
    return not all(c.ok for c in out.checks)


@pytest.fixture
def inverse_render():
    from kaolin_tpu_torch.models import inverse_render
    return inverse_render


def test_dibr_state_unchanged(monkeypatch, inverse_render):
    """A step that returns its state unchanged."""
    real = inverse_render.compiled_step

    def frozen(model, *args, **kwargs):
        step = real(model, *args, **kwargs)

        def call(*a):
            keep = [p.detach().clone() for p in model.parameters()]
            loss = step(*a)
            with torch.no_grad():
                for p, k in zip(model.parameters(), keep):
                    p.copy_(k)
            return loss
        return call
    monkeypatch.setattr(inverse_render, 'compiled_step', frozen)
    assert _not_correct(drive(*small_dibr()))


def test_dibr_half_batch(monkeypatch, inverse_render):
    """Half of the batch left out, the mean taken over the rest."""
    M = inverse_render

    def half_loss(params, views, faces, face_uvs, target_images,
                  target_masks, height, width, backend='auto',
                  with_soft_mask=True, selection=None, knum=30):
        images, soft, _ = M.render_views(
            params, views, faces, face_uvs, height, width, backend=backend,
            with_soft_mask=with_soft_mask, selection=selection, knum=knum)
        n = images.shape[0] // 2
        return (torch.mean(torch.abs(images[:n] - target_images[:n]))
                + M.mask_iou(soft[:n], target_masks[:n]))
    monkeypatch.setattr(M, 'render_loss', half_loss)
    assert _not_correct(drive(*small_dibr()))


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient."""

    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.factor, None


@pytest.mark.parametrize('leaf', ['vertices', 'texture_map'])
@pytest.mark.parametrize('factor', [-1., 2.], ids=['negated', 'doubled'])
def test_dibr_gradient_altered(monkeypatch, inverse_render, leaf, factor):
    """The backward gives the vertices' or the texture's gradient the
    wrong sign or twice its size, inside the step."""
    M = inverse_render
    real = M.render_loss

    def loss(model, *args, **kwargs):
        params = model.as_params()
        params = params._replace(**{leaf: _ScaleGrad.apply(
            getattr(params, leaf), factor)})
        return real(params, *args, **kwargs)
    monkeypatch.setattr(M, 'render_loss', loss)
    assert _not_correct(drive(*small_dibr()))


@pytest.fixture
def raster():
    from kaolin_tpu_torch.render.spc import raster
    return raster


def _broken_trace(monkeypatch, raster, spoil):
    """The trace entry point, as the SPC driver imports it when it runs,
    with ``spoil`` applied to its hits."""
    real = raster.unbatched_raytrace_coherent

    def trace(*args, **kwargs):
        return spoil(real(*args, **kwargs))
    monkeypatch.setattr(raster, 'unbatched_raytrace_coherent', trace)


def test_spc_answer_altered(monkeypatch, raster):
    """Each ray's nearest hit names the next voxel where the trace produces
    it (the comparison samples rays: every answer is altered)."""
    def spoil(h):
        pidx = h.pidx.clone()
        pidx[:, 0] = torch.where(pidx[:, 0] >= 0, pidx[:, 0] + 1, -1)
        return h._replace(pidx=pidx)
    _broken_trace(monkeypatch, raster, spoil)
    assert _not_correct(drive(*small_spc()))


def test_spc_depth_altered(monkeypatch, raster):
    """Every hit's entry depth moved by one part in a million."""
    def spoil(h):
        return h._replace(t_near=h.t_near * (1 + 1e-6))
    _broken_trace(monkeypatch, raster, spoil)
    assert _not_correct(drive(*small_spc()))


def test_spc_half_batch(monkeypatch, raster):
    """Half of the rays left out: their hits never written."""
    def spoil(h):
        n = h.count.shape[0] // 2
        count, pidx, t = h.count.clone(), h.pidx.clone(), h.t_near.clone()
        count[n:], pidx[n:], t[n:] = 0, -1, float('inf')
        return h._replace(count=count, pidx=pidx, t_near=t)
    _broken_trace(monkeypatch, raster, spoil)
    assert _not_correct(drive(*small_spc()))
