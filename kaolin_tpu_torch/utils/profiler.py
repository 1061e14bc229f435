"""Profiling / micro-benchmark helpers.

Port of ``kaolin_tpu/utils/profiler.py``: a timer that waits for the
device's work, a micro-benchmark timed by CUDA events on the card (the
host clock on the CPU), a ``torch.profiler`` trace context, and the spans
the port opens where its work happens (:func:`span`).

An operator who wants to see where a fit's step or a trace's frame spends
its time wraps the loop in :func:`trace`::

    with profiler.trace('log/fit'):
        for k in range(20):
            step(views, images, masks)

The trace then shows, on the host's timeline, a user annotation for each
span of :data:`SPANS` the loop passed through (the DIB-R step's selection,
render and loss, backward and optimizer step; the SPC frame's culling,
block order, gathers and trace), with the runtime's calls inside them
(``cudaStreamSynchronize`` where the host waits for the card), and on the
card's timeline a pair of empty kernels ``kt_span_begin_<slug>`` /
``kt_span_end_<slug>`` (the span's name with ``.`` as ``_``) around each
span's device work.  Every device op between a begin mark and its end
mark, in stream order, belongs to that span, also in a CUDA graph's
replay, which no host span reaches: the compiled step's graph (``models/inverse_render.py::compiled_step``) holds its phases'
marks, so a trace of its replays shows them.
"""

import contextlib
import time

import torch
import torch.autograd.profiler as _autograd_profiler

from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch._device import entry_device

__all__ = ['Timer', 'benchmark', 'trace', 'span', 'SPANS']

# the spans, in the order of csrc/spans.cu's KT_SPANS list (a mark's id is
# its index here)
SPANS = ('dibr.select', 'dibr.render', 'autograd.backward', 'optim.step',
         'parallel.all_reduce', 'spc.frame', 'spc.cull', 'spc.order',
         'spc.gather', 'spc.trace')
_MARK_IDS = {name: k for k, name in enumerate(SPANS)}
_OFF = contextlib.nullcontext()


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


def span(name, device=None):
    """The span ``name`` (one of :data:`SPANS`) around the work of a
    ``with`` block, on ``device`` (a ``torch.device``; None: the host only).

    While a ``torch.profiler`` records, the span opens
    ``torch.profiler.record_function(name)``: a user annotation on the
    host's timeline.  On a CUDA ``device``, while a profiler records or
    the current stream is being captured into a CUDA graph, it also
    launches an empty kernel ``kt_span_begin_<slug>`` on the current
    stream at entry and ``kt_span_end_<slug>`` at exit (``<<<1, 1>>>``,
    from ``csrc/spans.cu``), so a graph captured through the span replays
    its marks on every replay.  The first span on a CUDA device builds and
    loads the marks there, recording or not: a path's warm-up passes
    through its spans, so neither a capture nor a traced block holds the
    load.  Otherwise a span costs flag checks and returns a context that
    does nothing.  The marks change no result: they read and write
    nothing.
    """
    if name not in _MARK_IDS:
        raise ValueError(f'no span {name!r}: the spans are {SPANS}')
    recording = _autograd_profiler._is_profiler_enabled
    index = None
    if device is not None and device.type == 'cuda':
        index = _index(device)
        if index not in _loaded:
            _load_marks(index)
        if not (recording or torch.cuda.is_current_stream_capturing()):
            index = None
    if not (recording or index is not None):
        return _OFF
    return _Span(name, recording, index)


class _Span:
    """What :func:`span` returns while it records or marks (on the CUDA
    device ``index``, where it is not None)."""

    __slots__ = ('_host', '_mark', '_index')

    def __init__(self, name, recording, index):
        self._host = None
        if recording:
            self._host = _autograd_profiler.record_function(name)
        self._mark = None if index is None else _MARK_IDS[name]
        self._index = index

    def __enter__(self):
        if self._host is not None:
            self._host.__enter__()
        if self._mark is not None:
            _cuda.load_module('spans').mark(
                self._mark, 0, _cuda.stream_getter()(self._index))
        return self

    def __exit__(self, *exc):
        if self._mark is not None:
            _cuda.load_module('spans').mark(
                self._mark, 1, _cuda.stream_getter()(self._index))
        if self._host is not None:
            self._host.__exit__(*exc)
        return False


_loaded = set()             # the CUDA devices whose marks are loaded


def _index(device):
    return torch.cuda.current_device() if device.index is None \
        else device.index


def _load_marks(index):
    """Build (once a checkout) and load the mark kernels on the CUDA
    device ``index``: a lazily loaded module would otherwise be loaded at
    its first launch, which may fall in a capture."""
    marks = _cuda.load_module('spans')
    with torch.cuda.device(index):
        marks.load()
    _loaded.add(index)
