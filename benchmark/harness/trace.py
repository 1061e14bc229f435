"""The traced block and the reduction of ``torch.profiler``'s chrome trace.

:func:`profiled` runs a block of steps under the profiler (CPU and CUDA
activities), inside a user annotation ``bench.window`` that the reduction
takes as the traced window, and returns the record the per-layer readers
read: every device operation (kernels, copies, fills) with its start and
length, the host events, the window's length, the device's busy time (the
union of the operations' intervals), the kernels by name and the longest
idle gaps, each labelled by the innermost host event open when it began.

The profiler's own cost per launch lies inside the window, so an idle
share read here is the idle share under the profiler.
"""

import json
import re
import time

__all__ = ['DEVICE_CATS', 'profiled', 'reduce_trace', 'union_s', 'by_name',
           'idle_gaps', 'select', 'launched_for', 'breakdown']

DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')
HOST_CATS = ('cpu_op', 'user_annotation', 'cuda_runtime', 'cuda_driver',
             'python_function')
WINDOW = 'bench.window'


def profiled(block, units, path, sync):
    """Run ``block()`` (``units`` steps or frames) under the profiler and
    reduce its trace, written to ``path`` and deleted after reading.
    ``sync()`` waits for the device.  Returns the record."""
    from torch.profiler import ProfilerActivity, profile, record_function
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            t0 = time.perf_counter()
            block()
            sync()
            host_s = time.perf_counter() - t0
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        events = json.loads(path.read_text())['traceEvents']
    finally:
        path.unlink(missing_ok=True)
    record = reduce_trace(events)
    record['units'] = units
    record['host_window_s'] = host_s
    return record


def reduce_trace(events):
    """The record of a chrome trace's events (see the module's doc)."""
    ops, host, window = [], [], None
    for e in events:
        if e.get('ph') != 'X' or 'dur' not in e:
            continue
        cat = e.get('cat', '')
        item = (e.get('name', ''), float(e['ts']), float(e['dur']))
        if cat in DEVICE_CATS:
            ops.append(item)
        elif cat in HOST_CATS:
            if e.get('name') == WINDOW and cat == 'user_annotation':
                window = item
            else:
                host.append(item)
    ops.sort(key=lambda x: x[1])
    if window is None:
        lo = min((o[1] for o in ops), default=0.)
        hi = max((o[1] + o[2] for o in ops), default=0.)
        window = (WINDOW, lo, hi - lo)
    return dict(ops=ops, host=host, window_s=window[2] * 1e-6,
                window_us=(window[1], window[1] + window[2]),
                busy_s=union_s(ops))


def union_s(ops):
    """Seconds in which at least one of ``ops`` ran."""
    busy, end = 0., float('-inf')
    for _, ts, dur in sorted(ops, key=lambda x: x[1]):
        busy += max(0., ts + dur - max(ts, end))
        end = max(end, ts + dur)
    return busy * 1e-6


def by_name(ops):
    """{name: seconds} over ``ops``."""
    out = {}
    for name, _, dur in ops:
        out[name] = out.get(name, 0.) + dur * 1e-6
    return out


def select(ops, patterns):
    """The ops whose name holds one of the regular expressions
    ``patterns``."""
    rx = [re.compile(p) for p in patterns]
    return [o for o in ops if any(r.search(o[0]) for r in rx)]


def launched_for(ops, patterns, markers, owner):
    """The ops whose name holds one of ``patterns`` (a library's kernels,
    such as a sort's, that several callers launch) that were launched for
    ``owner``: those whose next op in start order among the ops holding
    one of ``markers`` (hand-written kernels) holds one of ``owner``.
    On one stream that is the kernel the library's result was made for."""
    rx, mk, ow = ([re.compile(p) for p in ps]
                  for ps in (patterns, markers, owner))
    out, mine = [], False
    for op in sorted(ops, key=lambda x: x[1], reverse=True):
        if any(r.search(op[0]) for r in mk):
            mine = any(r.search(op[0]) for r in ow)
        elif mine and any(r.search(op[0]) for r in rx):
            out.append(op)
    return out[::-1]


def idle_gaps(record, top=10):
    """The ``top`` longest intervals of the window in which no device
    operation ran, as (label, seconds), longest first; the label is the
    innermost host event open at the gap's start ('host' where none is)."""
    lo, hi = record['window_us']
    gaps, end = [], lo
    for _, ts, dur in record['ops']:
        if ts > end:
            gaps.append((end, ts))
        end = max(end, ts + dur)
    if hi > end:
        gaps.append((end, hi))
    gaps.sort(key=lambda g: g[0] - g[1])
    host = sorted(record['host'], key=lambda x: x[1])
    out = []
    for a, b in gaps[:top]:
        label, best = 'host', None
        for name, ts, dur in host:
            if ts > a:
                break
            if ts + dur >= a and (best is None or dur < best):
                label, best = name, dur
        out.append((label, (b - a) * 1e-6))
    return out


def breakdown(record, top=10):
    """The ``breakdown`` of a result line: the device operations that took
    the most seconds over the traced window, and the longest idle gaps."""
    heavy = sorted(by_name(record['ops']).items(), key=lambda kv: -kv[1])
    return dict(device_ops=[[n, s] for n, s in heavy[:top]],
                idle_gaps=[[n, s] for n, s in idle_gaps(record, top)])
