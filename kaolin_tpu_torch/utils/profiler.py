"""Profiling / micro-benchmark helpers.

Port of ``kaolin_tpu/utils/profiler.py``: a timer that waits for the
device's work, a micro-benchmark timed by CUDA events on the card (the
host clock on the CPU) and a ``torch.profiler`` trace context.
"""

import contextlib
import time

import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['Timer', 'benchmark', 'trace']


def _cuda_devices(out):
    """The CUDA devices of the tensors in ``out`` (nested lists, tuples,
    dicts)."""
    if torch.is_tensor(out):
        return {out.device} if out.is_cuda else set()
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in out))
    return set()


def _sync(out=None):
    """Wait for the card's work on ``out``'s tensors (every CUDA device's
    work when ``out`` holds none and CUDA has started)."""
    devices = _cuda_devices(out)
    if not devices and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        devices = {None}
    for dev in devices:
        torch.cuda.synchronize(dev)


class Timer:
    """Wall-clock timer context that waits for the device's work.

    Example::

        with Timer('render') as t:
            out = render(params)
            t.block(out)
        print(t.elapsed)
    """

    def __init__(self, name=''):
        self.name = name
        self.elapsed = None
        self._out = None

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def block(self, out):
        self._out = out
        return out

    def __exit__(self, *exc):
        _sync(self._out)
        self.elapsed = time.perf_counter() - self._t0
        return False


def benchmark(fn, *args, iters=10, warmup=2, device=None, **kwargs):
    """Time ``fn(*args, **kwargs)``: on the card with a pair of CUDA events
    around each call, on the CPU with the host clock.

    Args:
        device: where ``fn`` runs (default: the card, see
            :func:`~kaolin_tpu_torch._device.entry_device`).

    Returns:
        dict with mean / min seconds per iteration and the last output.
    """
    device = entry_device(device)
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    times = []
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        events = []
        for _ in range(iters):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            events.append((start, end))
        torch.cuda.synchronize(device)
        times = [a.elapsed_time(b) / 1e3 for a, b in events]
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            times.append(time.perf_counter() - t0)
    return {'mean_s': sum(times) / len(times), 'min_s': min(times),
            'iters': iters, 'out': out}


@contextlib.contextmanager
def trace(log_dir):
    """``torch.profiler`` trace context (CPU, and the card when there is
    one); writes a TensorBoard trace into ``log_dir`` and yields the
    profiler."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof
