"""The span readers (``harness/spans.py`` and the ``program_span``
metrics) on synthetic records: self time with nesting, operations outside
every span charged to none, unpaired marks and a count of frames that is
not the block's read None, and the host's waits are the blocking runtime
calls inside a frame's span, whose idle time counts only gaps that open
inside such a call."""

import pytest

from benchmark import run
from benchmark.harness import spans, trace


def mark(kind, slug, ts):
    return (f'kt_span_{kind}_{slug}', ts, 1.)


# one DIB-R step on one stream: (name, start us, us)
STEP = [
    ('Memcpy HtoD (the feed)', 0., 2.),
    mark('begin', 'dibr_select', 3.),
    ('void cub::DeviceRadixSortOnesweepKernel<tiles>', 5., 4.),
    ('fused_forward_kernel', 10., 40.),
    mark('end', 'dibr_select', 51.),
    mark('begin', 'dibr_render', 53.),
    ('bilinear_forward_kernel', 55., 5.),
    ('void at::native::vectorized_elementwise_kernel<mul>', 61., 7.),
    mark('end', 'dibr_render', 69.),
    mark('begin', 'autograd_backward', 71.),
    ('fused_backward_kernel', 73., 6.),
    ('segment_pieces_kernel', 80., 3.),
    mark('end', 'autograd_backward', 84.),
    mark('begin', 'optim_step', 86.),
    ('void at::native::vectorized_elementwise_kernel<adam>', 88., 9.),
    mark('end', 'optim_step', 98.),
]
SELF_US = {'select_ms.dibr': 4 + 40, 'render_ms.dibr': 5 + 7,
           'backward_ms.dibr': 6 + 3, 'optimizer_ms.dibr': 9}


def dibr_record(steps=2, period=100., ops=STEP):
    ops = [(n, ts + k * period, dur) for k in range(steps)
           for n, ts, dur in ops]
    return dict(ops=ops, host=[], units=steps, window_s=steps * period * 1e-6,
                window_us=(0., steps * period), busy_s=trace.union_s(ops))


@pytest.mark.parametrize('name', sorted(SELF_US))
def test_dibr_phases(name):
    assert run.read_metric(name, dibr_record()) == pytest.approx(
        SELF_US[name] * 1e-3)


def test_self_time_leaves_out_nested_spans():
    """The eager step nests the selection in the render: each is charged
    only its own operations."""
    nested = [mark('begin', 'dibr_render', 0.),
              ('void at::native::elementwise_kernel<project>', 2., 3.),
              mark('begin', 'dibr_select', 6.),
              ('fused_forward_kernel', 8., 40.),
              mark('end', 'dibr_select', 49.),
              ('bilinear_forward_kernel', 51., 5.),
              mark('end', 'dibr_render', 57.)]
    rec = dibr_record(ops=nested)
    assert run.read_metric('render_ms.dibr', rec) == pytest.approx(8e-3)
    assert run.read_metric('select_ms.dibr', rec) == pytest.approx(40e-3)


def test_outside_every_span_charged_to_none():
    rec = dibr_record()
    charged, pairs = spans.device_self(rec)
    assert [o[0] for o in charged[None]] == ['Memcpy HtoD (the feed)'] * 2
    assert pairs == {'dibr_select': 2, 'dibr_render': 2,
                     'autograd_backward': 2, 'optim_step': 2}
    marks = sum(o[2] for o in rec['ops'] if spans.MARK.search(o[0]))
    parts = sum(o[2] for ops in charged.values() for o in ops)
    assert parts + marks == pytest.approx(sum(o[2] for o in rec['ops']))


@pytest.mark.parametrize('fault', ['unclosed', 'crossed', 'stray_end'])
def test_unpaired_marks_read_none(fault):
    ops = list(STEP)
    if fault == 'unclosed':
        ops.remove(mark('end', 'optim_step', 98.))
    elif fault == 'crossed':
        ops[4], ops[8] = mark('end', 'dibr_render', 51.), \
            mark('end', 'dibr_select', 69.)
    else:
        ops.append(mark('end', 'dibr_select', 99.))
    rec = dibr_record(ops=ops)
    assert spans.device_self(rec) is None
    for name in SELF_US:
        assert run.read_metric(name, rec) is None


def test_no_spans_read_none():
    """The parent of the spans' change: no marks, no host spans."""
    plain = dibr_record(ops=[o for o in STEP if not spans.MARK.search(o[0])])
    for name in list(SELF_US) + ['exchange_ms.multiview', 'cull_ms.spc',
                                 'fills_ms.spc', 'host_syncs.spc',
                                 'sync_idle_ms.spc']:
        assert run.read_metric(name, None) is None
        assert run.read_metric(name, plain) is None


# one SPC frame: device ops and host spans (name, start us, us)
FRAME_OPS = [
    mark('begin', 'spc_frame', 0.),
    mark('begin', 'spc_cull', 2.),
    ('void at::native::reduce_kernel<amin>', 4., 30.),
    mark('end', 'spc_cull', 35.),
    mark('begin', 'spc_order', 37.),
    ('void at::native::elementwise_kernel<gt>', 39., 2.),
    ('void cub::DeviceSelectSweepKernel<nonzero>', 41., 3.),
    # the host waits for nonzero's count: the card idles 44..60
    ('void cub::DeviceRadixSortOnesweepKernel<order>', 60., 4.),
    mark('end', 'spc_order', 65.),
    mark('begin', 'spc_gather', 67.),
    ('void at::native::index_elementwise_kernel<gather>', 69., 5.),
    mark('end', 'spc_gather', 75.),
    mark('begin', 'spc_trace', 77.),
    ('void at::native::vectorized_elementwise_kernel<fill>', 79., 6.),
    ('spc_trace_kernel', 86., 20.),
    mark('end', 'spc_trace', 107.),
    ('void at::native::elementwise_kernel<cut>', 109., 2.),
    mark('end', 'spc_frame', 112.),
    # the frame's caller: the card idles 113..130 while the host reads
]
FRAME_HOST = [('spc.frame', -1., 113.), ('spc.cull', 1., 33.),
              ('spc.order', 36., 26.), ('aten::nonzero', 40., 20.),
              ('cudaMemcpyAsync', 42., 1.),
              ('cudaStreamSynchronize', 43., 16.),
              ('spc.gather', 66., 8.), ('spc.trace', 76., 30.),
              ('cudaLaunchKernel', 79., 1.),
              ('cudaDeviceSynchronize', 113., 17.)]


def spc_record(frames=2, period=130., units=None):
    def shift(items):
        return [(n, ts + k * period, dur) for k in range(frames)
                for n, ts, dur in items]
    ops = shift(FRAME_OPS)
    return dict(ops=ops, host=shift(FRAME_HOST),
                units=frames if units is None else units,
                window_s=frames * period * 1e-6,
                window_us=(0., frames * period), busy_s=trace.union_s(ops))


@pytest.mark.parametrize('name, us', [
    ('cull_ms.spc', 30), ('order_ms.spc', 2 + 3 + 4),
    ('gather_ms.spc', 5), ('fills_ms.spc', 6), ('host_syncs.spc', None),
    ('sync_idle_ms.spc', 60 - 44)])
def test_spc_layers(name, us):
    got = run.read_metric(name, spc_record())
    if name == 'host_syncs.spc':
        assert got == 1.
    else:
        assert got == pytest.approx(us * 1e-3)


@pytest.mark.parametrize('name', ['cull_ms.spc', 'order_ms.spc',
                                  'gather_ms.spc', 'fills_ms.spc',
                                  'host_syncs.spc', 'sync_idle_ms.spc'])
def test_frame_count_mismatch_reads_none(name):
    assert run.read_metric(name, spc_record(units=3)) is None


def test_sync_idle_counts_only_gaps_opening_in_a_sync():
    """The caller's ``cudaDeviceSynchronize`` after the frame is neither
    a wait of the frame nor its idle time; a gap that opens in
    ``nonzero`` before its wait is not the wait's."""
    rec = spc_record(frames=1)
    gaps = spans.idle_gaps(rec)
    # the gap behind nonzero and the caller's after the frame, among others
    assert (44., 60.) in gaps and (113., 130.) in gaps
    assert spans.waits(rec, 'spc.frame') == [(43., 59.)]
    assert run.read_metric('sync_idle_ms.spc', rec) == pytest.approx(16e-3)
    rec['host'] = [('cudaStreamSynchronize', 45., 14.) if
                   h[0] == 'cudaStreamSynchronize' else h
                   for h in rec['host']]
    assert run.read_metric('host_syncs.spc', rec) == 1.
    assert run.read_metric('sync_idle_ms.spc', rec) == 0.
    rec['host'] = [h for h in rec['host'] if h[0] not in spans.SYNCS]
    assert run.read_metric('sync_idle_ms.spc', rec) == 0.
    assert run.read_metric('host_syncs.spc', rec) == 0.


@pytest.mark.parametrize('call', sorted(spans.SYNCS))
def test_each_blocking_call_counts_as_a_wait(call):
    rec = spc_record(frames=1)
    rec['host'] = [(call, *h[1:]) if h[0] == 'cudaStreamSynchronize' else h
                   for h in rec['host']]
    assert run.read_metric('host_syncs.spc', rec) == 1.
    assert run.read_metric('sync_idle_ms.spc', rec) == pytest.approx(16e-3)


@pytest.mark.card
def test_host_syncs_counts_what_the_sync_debug_mode_reports(card, tmp_path):
    """On the card: the waits ``host_syncs.spc`` counts in a traced block
    of SPC frames are those ``torch.cuda.set_sync_debug_mode('warn')``
    reports on the frame's path, per frame."""
    import warnings

    import numpy as np
    import torch
    from kaolin_tpu_torch.ops import spc as SPC
    from kaolin_tpu_torch.render.spc import raster as RA
    from kaolin_tpu_torch.utils.testing import camera_grid

    level, frames = 6, 3
    pts = np.random.default_rng(5).integers(0, 2 ** level, (3000, 3))
    octree = SPC.unbatched_points_to_octree(
        torch.as_tensor(pts.astype(np.int16)), level).to(card)
    _, pyr, exsum = SPC.scan_octrees(octree, [octree.shape[0]])
    ph = SPC.generate_points(octree, pyr, exsum)
    o, d = (torch.as_tensor(x, device=card) for x in camera_grid(128))
    table = RA.build_cell_table(ph, pyr[0], level, cell_shift=2,
                                cell_width=64)

    def block():
        for _ in range(frames):
            RA.unbatched_raytrace_coherent(
                octree, ph, pyr[0], exsum, o, d, level, engine='mosaic',
                cell_table=table, device=card)
    block()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter('always')
            block()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    reported = sum('synchronizing CUDA operation' in str(w.message)
                   for w in seen)
    assert reported >= frames
    record = trace.profiled(block, frames, tmp_path / 'trace.json',
                            torch.cuda.synchronize)
    assert run.read_metric('host_syncs.spc', record) == reported / frames
    assert run.read_metric('sync_idle_ms.spc', record) is not None
