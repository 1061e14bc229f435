"""The card's idle time behind the host's waits: the traced window's
intervals with no device operation that open while the host is inside a
blocking runtime call (``harness/spans.py::SYNCS``) of an ``spc.frame``
host span, ms per frame."""

from benchmark.harness.spans import host_spans, idle_gaps, waits


def read(record):
    if not record:
        return None
    frames = host_spans(record, 'spc.frame')
    if not frames or len(frames) != record['units']:
        return None
    syncs = waits(record, 'spc.frame')
    us = sum(b - a for a, b in idle_gaps(record)
             if any(s <= a <= e for s, e in syncs))
    return us * 1e-3 / len(frames)
