"""The program's spans, read from a traced block's record.

The port opens a span where each phase of its work happens
(``kaolin_tpu_torch/utils/profiler.py::span``).  While the profiler
records, a span is a user annotation on the host's timeline, which
:func:`~benchmark.harness.trace.reduce_trace` keeps in ``record['host']``;
on the card it is a pair of empty kernels, ``kt_span_begin_<slug>`` and
``kt_span_end_<slug>`` (the span's name with ``.`` as ``_``), which it keeps
in ``record['ops']`` and which a CUDA graph replays.

:func:`device_self` walks the device operations in start order with a
stack of open marks and charges each operation that is not a mark to the
innermost open span (its self time); marks are charged to nobody, and
operations outside every span to ``None``.  :func:`host_spans` gives the
host spans of one name, :func:`waits` the host's blocking calls into the
CUDA runtime (``record['host']`` keeps the ``cuda_runtime`` events) inside
spans of one name.  Each reader of ``benchmark/metrics/`` that reads spans
returns None where the marks do not pair.
"""

import re

__all__ = ['MARK', 'SYNCS', 'slug', 'device_self', 'self_ms',
           'host_spans', 'inside', 'waits', 'idle_gaps']

MARK = re.compile(r'\bkt_span_(begin|end)_(\w+)')
# the runtime calls in which the host waits for the card: PyTorch's syncs
# (``.item()``, ``nonzero``, a copy to the host, ``synchronize``) end in
# one of them, and ``torch.cuda.set_sync_debug_mode`` reports each
SYNCS = frozenset(('cudaStreamSynchronize', 'cudaDeviceSynchronize',
                   'cudaEventSynchronize', 'cudaMemcpy'))


def slug(name):
    """The marks' name of the span ``name``."""
    return name.replace('.', '_')


def device_self(record):
    """({slug or None: [ops charged to that span]}, {slug: pairs of
    marks}) over ``record['ops']``, or None where a mark ends another span
    than the innermost open one, or a span is left open."""
    stack, charged, pairs = [], {}, {}
    for op in sorted(record['ops'], key=lambda o: o[1]):
        m = MARK.search(op[0])
        if m is None:
            charged.setdefault(stack[-1] if stack else None, []).append(op)
        elif m.group(1) == 'begin':
            stack.append(m.group(2))
        elif stack and stack[-1] == m.group(2):
            pairs[stack.pop()] = pairs.get(m.group(2), 0) + 1
        else:
            return None
    if stack:
        return None
    return charged, pairs


def self_ms(record, name, per=None, leave_out=()):
    """The self device time of the span ``name``, ms per unit: per
    ``record['units']``, or with ``per`` (a span's name) per pair of that
    span's marks, None unless they number ``record['units']``.  Operations
    whose name holds one of the regular expressions ``leave_out`` are not
    counted.  None without a record, where the marks do not pair, or where
    the span did not run."""
    if not record or not record.get('units'):
        return None
    walk = device_self(record)
    if walk is None:
        return None
    charged, pairs = walk
    units = record['units']
    if per is not None and pairs.get(slug(per)) != units:
        return None
    if not pairs.get(slug(name)):
        return None
    rx = [re.compile(p) for p in leave_out]
    us = sum(o[2] for o in charged.get(slug(name), [])
             if not any(r.search(o[0]) for r in rx))
    return us * 1e-3 / units


def host_spans(record, name):
    """The host spans named ``name``: (start us, end us), in start
    order."""
    return sorted((ts, ts + dur) for n, ts, dur in record['host']
                  if n == name)


def inside(span, outer):
    """Whether ``span`` lies within one of the spans ``outer``."""
    return any(a <= span[0] and span[1] <= b for a, b in outer)


def waits(record, name):
    """The host's waits for the card (runtime calls of :data:`SYNCS`)
    that lie within a host span ``name``: (start us, end us), in start
    order."""
    outer = host_spans(record, name)
    return sorted(w for w in ((ts, ts + dur) for n, ts, dur in record['host']
                              if n in SYNCS) if inside(w, outer))


def idle_gaps(record):
    """Every interval of the window in which no device operation ran, as
    (start us, end us)."""
    lo, hi = record['window_us']
    gaps, end = [], lo
    for _, ts, dur in sorted(record['ops'], key=lambda o: o[1]):
        if ts > end:
            gaps.append((end, ts))
        end = max(end, ts + dur)
    if hi > end:
        gaps.append((end, hi))
    return gaps
