"""The DIB-R readers split a step's device time by layer: a library sort
counts for the kernel it was launched for, and the layers add up to every
operation of the step."""

import pytest

from benchmark import run
from benchmark.harness import trace

# one step on one stream, as the profiler lists it: (name, start us, us)
STEP = [
    ('void cub::DeviceRadixSortOnesweepKernel<SelectionTiles>', 0., 3.),
    ('void at::native::elementwise_kernel<fill>', 4., 1.),
    ('void cub::DeviceRadixSortOnesweepKernel<SelectionInverse>', 6., 2.),
    ('fused_forward_kernel', 10., 40.),
    ('bilinear_forward_kernel', 52., 5.),
    ('void at::native::vectorized_elementwise_kernel<mul>', 58., 7.),
    ('fused_backward_units_kernel', 66., 4.),
    ('fused_backward_kernel', 71., 6.),
    ('fused_backward_sum_kernel', 78., 1.),
    ('bilinear_pixels_kernel', 80., 5.),
    ('void at::native::elementwise_kernel<arange>', 86., 1.),
    ('void cub::DeviceRadixSortHistogramKernel<E2>', 88., 2.),
    ('void cub::DeviceRadixSortOnesweepKernel<E2>', 91., 4.),
    ('segment_pieces_kernel', 96., 3.),
    ('segment_combine_kernel', 100., 1.),
    ('void cub::DeviceRadixSortOnesweepKernel<E3>', 102., 4.),
    ('segment_pieces_kernel', 107., 3.),
    ('segment_combine_kernel', 111., 1.),
    ('void at::native::vectorized_elementwise_kernel<adam>', 113., 9.),
]


def record(steps=2, period=130.):
    ops = [(n, ts + k * period, dur) for k in range(steps)
           for n, ts, dur in STEP]
    return dict(ops=ops, host=[], units=steps, window_s=steps * period * 1e-6,
                window_us=(0., steps * period), busy_s=trace.union_s(ops))


def test_sorts_count_for_the_kernel_they_were_launched_for():
    got = trace.launched_for(record(1)['ops'], ('RadixSort',),
                             ('fused_forward_kernel', 'segment_pieces_kernel'),
                             ('segment_pieces_kernel',))
    assert [o[0][-4:-1] for o in got] == ['<E2', '<E2', '<E3']


@pytest.mark.parametrize('name, us', [
    ('epilogue_kernels_ms.dibr', 5 + 5 + 2 + 4 + 3 + 1 + 4 + 3 + 1),
    ('k2_ms.dibr', 4 + 6 + 1),
    ('torch_ops_ms.dibr', 3 + 1 + 2 + 7 + 1 + 9),
])
def test_layers_of_the_step(name, us):
    assert run.read_metric(name, record()) == pytest.approx(us * 1e-3)


def test_layers_add_up_to_the_step():
    rec = record()
    total = sum(o[2] for o in rec['ops']) * 1e-3 / rec['units']
    k1 = 40e-3
    parts = sum(run.read_metric(n, rec) for n in (
        'epilogue_kernels_ms.dibr', 'k2_ms.dibr', 'torch_ops_ms.dibr'))
    assert parts + k1 == pytest.approx(total)
