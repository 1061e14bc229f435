"""What the port's measurements share: the card's peaks, the bound, two
timers, the card's name and the SPC cell's trace settings.

``chip_smoke.py`` times the main paths with these, and the probes
(:mod:`kaolin_tpu_torch.probes`) time their kernels with the same, so a
main-path time and a probe's time of the same kernel are comparable.

The two timers read different things.  :func:`time_ms` is the time per
call that a Python caller pays: CUDA events around back-to-back calls, so
where a call's host cost exceeds its device time it measures the host.
:func:`device_ms` is the device's time per call without the host: the calls
captured once in a CUDA graph and the graph's replay timed.
"""

import subprocess

import torch

__all__ = ['HBM_BYTES_PER_S', 'FP32_FLOP_PER_S', 'TRACE', 'time_ms',
           'device_ms', 'replayed', 'in_turns', 'bound_ms', 'card']

# H100 SXM published peaks (NVIDIA's data sheet, at the 700 W power limit):
# device memory and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# the coherent trace of BASELINE config #3 as bench.py:243 runs it: knum
# 256, no exit depths, 32 rays per tile, the non-saturating segment caps
TRACE = dict(knum=256, with_exit=False, rays_per_tile=32,
             max_super_voxels=512 * 192, max_active_blocks=8192,
             segments=((512, 192), (1536, 48), (4096, 16), (None, 4)))


def time_ms(fn, iters, warmup=1):
    """Mean device time of fn() over ``iters`` calls after warm-up (CUDA
    events on the current stream)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _captured(fn, iters, warmup):
    """(graph, last result): ``iters`` calls of fn() captured in one CUDA
    graph, after ``warmup`` eager calls on a side stream (the first call of a
    kernel loads its module, which a capture cannot)."""
    if not torch.cuda.is_available():
        raise RuntimeError('a CUDA graph times the CUDA card, and '
                           'torch.cuda.is_available() is False')
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            out = fn()
    return graph, out


def device_ms(fn, iters, warmup=1):
    """Mean device time of one fn() call, host cost left out: ``iters``
    calls captured in one CUDA graph (:func:`_captured`), one replay to warm
    up, then CUDA events around one replay.  fn() must be capturable (no
    host sync); raises without CUDA, never times the CPU."""
    graph, _ = _captured(fn, iters, warmup)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def replayed(fn, warmup=1):
    """fn()'s float tensor as one CUDA-graph replay computes it: fn captured
    once (after ``warmup`` eager calls), its output filled with NaN, the
    graph replayed, the output cloned; for checking that a captured launch
    equals an eager one."""
    graph, out = _captured(fn, 1, warmup)
    out.fill_(float('nan'))
    graph.replay()
    torch.cuda.synchronize()
    return out.clone()


def in_turns(timer, kernel, lib, iters):
    """(kernel ms, library ms or None) by ``timer`` (:func:`time_ms` or
    :func:`device_ms`), taken in turns (kernel, library, library, kernel)
    and each pair averaged, so a drift of the card or the host falls on
    both alike.  ``lib`` None: the kernel alone, once."""
    if lib is None:
        return timer(kernel, iters), None
    k0, l0, l1, k1 = (timer(f, iters) for f in (kernel, lib, lib, kernel))
    return (k0 + k1) / 2, (l0 + l1) / 2


def bound_ms(nbytes, flops):
    """The least time the card could take: (ms, 'bytes' or 'operations'),
    the larger of bytes over the device memory rate and float32
    operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def card():
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
