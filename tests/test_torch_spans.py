"""The port's spans (``utils/profiler.py::span``).

On the CPU:

* with no profiler recording, a span creates no ``record_function``: it
  costs flag checks;
* under a CPU ``torch.profiler`` the compiled step, ``render_loss``, a
  one-rank ``multi_view_grad`` and ``unbatched_raytrace_coherent`` (the
  ``'mosaic'`` engine on K3's plain version) open the spans of their
  phases, nested as the code nests them;
* losses, gradients and hits are equal bit for bit with and without the
  profiler, and spans on the CPU load no marks;
* the mark kernels of ``csrc/spans.cu`` are listed in the order of
  ``profiler.SPANS``.

Card-only cases (skipped without one): the first span on the card loads
the marks, with no profiler recording; the compiled step's graph holds
each span's two marks once per replay, begin before end, in phase order;
a profiled replay gives the bits of an unprofiled one; in a profiled SPC
frame every begin mark starts after its host span opened (host and card
on one clock).
"""
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.ops import spc as SPC
from kaolin_tpu_torch.parallel import make_mesh, multi_view_grad
from kaolin_tpu_torch.render.spc import raster as RA
from kaolin_tpu_torch.utils import profiler
from kaolin_tpu_torch.utils.testing import camera_grid, uv_sphere

H = W = 32
VIEWS = 2
LEVEL = 4
DIBR_STEP = ('dibr.select', 'dibr.render', 'autograd.backward',
             'optim.step')

# evaluated when the test runs, not at import
cuda = pytest.mark.skipif('not torch.cuda.is_available()',
                          reason='needs a CUDA card (run on the H100)')


def _scene(device='cpu'):
    """(model, views, faces, face_uvs, target images, target masks)."""
    sphere = uv_sphere(8, 5)
    rng = np.random.default_rng(0)
    verts = (sphere.vertices * 0.5 + 0.02 * rng.standard_normal(
        sphere.vertices.shape)).astype(np.float32)
    sh = np.zeros(9, np.float32)
    sh[0] = 3.

    def t(a):
        return torch.as_tensor(a, device=device)
    model = MT.from_jax_params(verts, rng.random((3, 8, 8), np.float32), sh,
                               device=device)
    views = MT.make_views(VIEWS, device=device)
    return (model, views, t(sphere.faces),
            t(sphere.uvs[sphere.face_uvs_idx]),
            t(rng.random((VIEWS, H, W, 3), np.float32)),
            t((rng.random((VIEWS, H, W)) > 0.5).astype(np.float32)))


def _adam(model):
    return torch.optim.Adam(model.parameters(), lr=5e-3,
                            capturable=model.vertices.is_cuda)


def _compiled(device='cpu'):
    model, views, faces, face_uvs, images, masks = _scene(device)
    step = MT.compiled_step(model, views, faces, face_uvs, images, masks, H,
                            W, _adam(model), backend='fused')
    return model, step, (views, images, masks)


def _spc(device='cpu'):
    """A level-4 octree and a 32 x 32 camera grid; ``frame()`` traces it
    with the ``'mosaic'`` engine."""
    pts = np.random.default_rng(3).integers(0, 2 ** LEVEL, (300, 3))
    octree = SPC.unbatched_points_to_octree(
        torch.as_tensor(pts.astype(np.int16)), LEVEL).to(device)
    _, pyr, exsum = SPC.scan_octrees(octree, [octree.shape[0]])
    ph = SPC.generate_points(octree, pyr, exsum)
    o, d = (torch.as_tensor(x, device=device) for x in camera_grid(32))
    table = RA.build_cell_table(ph, pyr[0], LEVEL, cell_shift=2,
                                cell_width=64)

    def frame():
        return RA.unbatched_raytrace_coherent(
            octree, ph, pyr[0], exsum, o, d, LEVEL, engine='mosaic',
            cell_table=table, device=device)
    return frame


def _spans(prof):
    """The profiler's host spans of ``profiler.SPANS``: (name, start,
    end) in start order."""
    out = [(e.name, e.time_range.start, e.time_range.end)
           for e in prof.events() if e.name in profiler.SPANS]
    return sorted(out, key=lambda s: s[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _cpu_profile(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def test_span_without_a_profiler_creates_no_record_function(monkeypatch):
    made = []
    real = torch.autograd.profiler.record_function

    def counting(name, *args, **kwargs):
        if name in profiler.SPANS:      # torch's optimizer opens its own
            made.append(name)
        return real(name, *args, **kwargs)
    monkeypatch.setattr(torch.autograd.profiler, 'record_function',
                        counting)
    for name in profiler.SPANS:
        with profiler.span(name, torch.device('cpu')) as s:
            assert s is None        # the shared context that does nothing
    _, step, inputs = _compiled()
    step(*inputs)
    _spc()()
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        with profiler.span('dibr.select', torch.device('cpu')):
            pass
    assert made == ['dibr.select']


def test_cpu_spans_load_no_marks(monkeypatch):
    loads = []
    monkeypatch.setattr(profiler, '_load_marks', loads.append)
    _, step, inputs = _compiled()
    step(*inputs)
    with profile(activities=[ProfilerActivity.CPU]):
        _spc()()
        _one_rank_grad(*_scene())
    assert loads == []


def test_unknown_span_raises():
    with pytest.raises(ValueError, match='no span'):
        profiler.span('dibr.forward')


def test_marks_in_the_order_of_spans():
    src = (Path(profiler.__file__).resolve().parents[1] / 'csrc'
           / 'spans.cu').read_text()
    block = re.search(r'#define KT_SPANS\(X\)(.*?)\n\n', src, re.S).group(1)
    slugs = re.findall(r'X\((\w+)\)', block)
    assert slugs == [n.replace('.', '_') for n in profiler.SPANS]


def test_compiled_step_spans_on_the_cpu():
    _, step, inputs = _compiled()
    _, spans = _cpu_profile(lambda: [step(*inputs) for _ in range(2)])
    assert [s[0] for s in spans] == list(DIBR_STEP) * 2
    for a, b in zip(spans, spans[1:]):
        assert a[2] <= b[1]             # one phase after the other


def test_render_loss_nests_its_selection():
    model, views, faces, face_uvs, images, masks = _scene()
    _, spans = _cpu_profile(lambda: MT.render_loss(
        model, views, faces, face_uvs, images, masks, H, W,
        backend='fused'))
    assert [s[0] for s in spans] == ['dibr.render', 'dibr.select']
    assert _inside(spans[1], spans[0])


def _one_rank_grad(model, views, faces, face_uvs, images, masks):
    mesh = make_mesh(device='cpu')
    fn = multi_view_grad(lambda p, v: MT.render_loss(
        p, v, faces, face_uvs, images, masks, H, W, backend='fused'), mesh)
    return fn(model.as_params(), views)


def test_multi_view_grad_spans():
    scene = _scene()
    _, spans = _cpu_profile(lambda: _one_rank_grad(*scene))
    assert [s[0] for s in spans] == ['dibr.render', 'dibr.select',
                                     'autograd.backward',
                                     'parallel.all_reduce']
    assert _inside(spans[1], spans[0])
    assert spans[0][2] <= spans[2][1] and spans[2][2] <= spans[3][1]


def test_spc_frame_spans():
    frame = _spc()
    _, spans = _cpu_profile(frame)
    names = [s[0] for s in spans]
    assert names == ['spc.frame', 'spc.cull', 'spc.order', 'spc.gather',
                     'spc.trace']
    for s in spans[1:]:
        assert _inside(s, spans[0])


def test_the_profiler_changes_no_bit():
    def fit():
        model, step, inputs = _compiled()
        losses = [step(*inputs) for _ in range(2)]
        return losses + [p.grad for p in model.parameters()] + [
            p.detach() for p in model.parameters()]
    quiet = fit()
    traced, _ = _cpu_profile(fit)
    grads = _one_rank_grad(*_scene())
    grads_traced, _ = _cpu_profile(lambda: _one_rank_grad(*_scene()))
    hits = _spc()()
    hits_traced, _ = _cpu_profile(_spc())
    for a, b in zip(quiet + [grads[0], *grads[1]] + list(hits),
                    traced + [grads_traced[0], *grads_traced[1]]
                    + list(hits_traced)):
        assert torch.equal(a, b)


def _card_trace(fn, tmp_path):
    """``fn()`` under a profiler of the host and the card: (its result, the
    chrome trace's complete events)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    path = tmp_path / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())['traceEvents']
              if e.get('ph') == 'X']
    return out, events


def _marks(events):
    """The mark kernels, (kind, slug, start us) in start order."""
    out = []
    for e in events:
        m = re.search(r'\bkt_span_(begin|end)_(\w+)', e.get('name', ''))
        if e.get('cat') == 'kernel' and m:
            out.append((m.group(1), m.group(2), float(e['ts'])))
    return sorted(out, key=lambda m: m[2])


@cuda
def test_cuda_graph_replays_its_marks(tmp_path):
    """Three profiled replays (the profiler may miss the card's first
    operations after it starts: the last two replays are read)."""
    _, step, inputs = _compiled('cuda')
    _, events = _card_trace(lambda: [step(*inputs) for _ in range(3)],
                            tmp_path)
    want = [(kind, name.replace('.', '_')) for name in DIBR_STEP
            for kind in ('begin', 'end')]
    marks = [m[:2] for m in _marks(events)]
    assert marks[-16:] == want * 2 and len(marks) <= 24


@cuda
def test_cuda_first_span_loads_the_marks():
    """Recording or not, so that a path's warm-up loads them before a
    capture or a traced block; with neither, the span does nothing."""
    device = torch.device('cuda', torch.cuda.current_device())
    with profiler.span('spc.frame', device) as s:
        assert s is None
    assert device.index in profiler._loaded


@cuda
def test_cuda_profiled_replay_changes_no_bit(tmp_path):
    runs = []
    for traced in (False, True):
        model, step, inputs = _compiled('cuda')
        step(*inputs)
        if traced:
            loss, _ = _card_trace(lambda: step(*inputs), tmp_path)
        else:
            loss = step(*inputs)
        torch.cuda.synchronize()
        runs.append([loss] + [p.grad.clone() for p in model.parameters()]
                    + [p.detach().clone() for p in model.parameters()])
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@cuda
def test_cuda_spc_marks_follow_their_host_spans(tmp_path):
    """Three profiled frames (the profiler may miss the card's first
    operations after it starts: the first frame is not read)."""
    frame = _spc('cuda')
    quiet = frame()
    runs, events = _card_trace(lambda: [frame() for _ in range(3)],
                               tmp_path)
    for hits in runs:
        for a, b in zip(quiet, hits):
            assert torch.equal(a, b)
    host = {}
    for e in events:
        if e.get('cat') == 'user_annotation' and e['name'] in profiler.SPANS:
            host.setdefault(e['name'].replace('.', '_'), []).append(
                float(e['ts']))
    begins = {}
    for kind, slug, ts in _marks(events):
        if kind == 'begin':
            begins.setdefault(slug, []).append(ts)
    assert set(host) == {'spc_frame', 'spc_cull', 'spc_order',
                         'spc_gather', 'spc_trace'}
    assert all(len(v) == 3 for v in host.values())
    for slug, opened in host.items():
        starts = begins[slug][-2:]
        assert len(starts) == 2
        for mark_ts, host_ts in zip(starts, sorted(opened)[1:]):
            assert mark_ts >= host_ts
