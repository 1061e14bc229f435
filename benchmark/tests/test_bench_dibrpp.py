"""The DIB-R++ cell (``sg.lights.512x4``) at a small size on the CPU: the
driver's numbers against ``reference/dibrpp.py`` within the cell's limits;
the control and each fault planted in the reference over them (the faults
by ten times); each fault planted in the program under the driver over
them; the readers of the SG spans on a synthetic record; no JAX in a
process that imports the driver and the model."""

import copy
import subprocess
import sys

import pytest
import torch

from conftest import ROOT, SMALL_DIBR, drive, load
from benchmark import run
from benchmark.drivers import dibrpp
from benchmark.harness import trace

CELL = 'sg.lights.512x4'


def small():
    """(configuration, cell) of the DIB-R++ cell cut to a CPU test's
    size."""
    w = load('workloads', CELL)
    c = load('configs', w['config'])
    c['texture_res'] = 16
    w.update(copy.deepcopy(SMALL_DIBR))
    return c, w


def _over(values, limits, factor=1.):
    return [k for k, v in values.items() if v > factor * limits[k]]


def test_reference_matches_plain_path():
    config, w = small()
    out = drive(config, w)
    assert out.attempted > 0 and out.failed == 0
    for c in out.checks:
        assert c.ok, (c.name, c.value, c.limit)
    assert [c.name for c in out.checks] == list(w['limits'])
    assert out.values['dibr_mpix_s'] > 0 and out.values['setup_s'] > 0


def test_control_and_faults_fail():
    config, w = small()
    got = dibrpp.control(w, config, 2 ** 32 + 3, torch.device('cpu'))
    assert _over(got['control_bf16'], w['limits']), got['control_bf16']
    for name in dibrpp.FAULTS:
        assert _over(got[name], w['limits'], 10.), (name, got[name])


@pytest.fixture
def model():
    from kaolin_tpu_torch.models import dibrpp as D
    return D


def _shading(D, specular=True, lights=None):
    """``_sg_terms`` with the specular term left out or the first
    ``lights`` lights alone."""
    from kaolin_tpu_torch.render.lighting import sg

    def terms(normal, view, albedo, roughness, amplitude, azimuth,
              elevation, sharpness):
        keep = slice(lights)
        amp, az, el, sharp = (t[keep] for t in (amplitude, azimuth,
                                                elevation, sharpness))
        d = D.lobe_directions(az, el)
        out = sg.sg_diffuse_inner_product(amp, d, sharp, normal, albedo)
        if specular:
            out = out + sg.sg_warp_specular_term(amp, d, sharp, normal,
                                                 roughness, view,
                                                 D.SPEC_ALBEDO)
        return out
    return terms


class _NoRoughnessGrad(torch.autograd.Function):
    """The identity on the material map, whose backward zeroes the
    roughness channel's gradient."""

    @staticmethod
    def forward(ctx, material):
        return material.view_as(material)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        g[3] = 0.
        return g


def _half_batch(real):
    """``real`` (a ``render_loss``) over the first half of the step's
    views, the mean taken over them; the selection made again for them."""
    def loss(model, views, faces, face_uvs, target_images, target_masks,
             *args, selection=None, **kwargs):
        n = views.camera_rot.shape[0] // 2
        half = views._replace(camera_rot=views.camera_rot[:n],
                              camera_trans=views.camera_trans[:n])
        return real(model, half, faces, face_uvs, target_images[:n],
                    target_masks[:n], *args, **kwargs)
    return loss


@pytest.mark.parametrize('fault', ['no_specular', 'half_lights',
                                   'roughness_grad_zeroed', 'half_batch'])
def test_program_fault_fails(monkeypatch, model, fault):
    D = model
    if fault == 'no_specular':
        monkeypatch.setattr(D, '_sg_terms', _shading(D, specular=False))
    elif fault == 'half_lights':
        monkeypatch.setattr(D, '_sg_terms', _shading(D, lights=D.LOBES // 2))
    elif fault == 'half_batch':
        monkeypatch.setattr(D, 'render_loss', _half_batch(D.render_loss))
    else:
        real = D.render_loss

        def loss(model, *args, **kwargs):
            params = model.as_params()
            params = params._replace(
                material=_NoRoughnessGrad.apply(params.material))
            return real(params, *args, **kwargs)
        monkeypatch.setattr(D, 'render_loss', loss)
    out = drive(*small())
    assert not all(c.ok for c in out.checks)


SG_STEP = [
    ('kt_span_begin_dibr_render', 0., 1.),
    ('elementwise_kernel<project>', 2., 3.),
    ('kt_span_begin_dibr_sg', 6., 1.),
    ('elementwise_kernel<exp>', 8., 20.),
    ('kt_span_end_dibr_sg', 29., 1.),
    ('kt_span_end_dibr_render', 31., 1.),
    ('kt_span_begin_autograd_backward', 33., 1.),
    ('fused_backward_kernel', 35., 4.),
    ('kt_span_begin_dibr_sg_backward', 40., 1.),
    ('elementwise_kernel<mul>', 42., 30.),
    ('kt_span_end_dibr_sg_backward', 73., 1.),
    ('kt_span_end_autograd_backward', 75., 1.),
]


def test_sg_readers_on_a_synthetic_step():
    steps, period = 2, 100.
    ops = [(n, ts + k * period, dur) for k in range(steps)
           for n, ts, dur in SG_STEP]
    record = dict(ops=ops, host=[], units=steps,
                  window_s=steps * period * 1e-6,
                  window_us=(0., steps * period), busy_s=trace.union_s(ops))
    assert run.read_metric('sg_shade_ms.dibrpp', record) == \
        pytest.approx(0.020)
    assert run.read_metric('sg_backward_ms.dibrpp', record) == \
        pytest.approx(0.030)
    assert run.read_metric('backward_ms.dibr', record) == pytest.approx(0.004)
    plain = dict(record, ops=[o for o in ops if 'dibr_sg' not in o[0]])
    assert run.read_metric('sg_shade_ms.dibrpp', plain) is None
    assert run.read_metric('sg_backward_ms.dibrpp', plain) is None


def test_process_loads_no_jax():
    code = ('import sys; sys.path.insert(0, %r)\n'
            'from benchmark.drivers import dibrpp\n'
            'from benchmark.reference import dibrpp as ref\n'
            'from kaolin_tpu_torch.models import dibrpp as model\n'
            'from benchmark.harness import env\n'
            'print(env.forbidden_modules())\n' % str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'
