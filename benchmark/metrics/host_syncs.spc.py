"""The host's waits for the card in the SPC frame: the blocking runtime
calls (``harness/spans.py::SYNCS``) inside host spans ``spc.frame``, per
frame (a count)."""

from benchmark.harness.spans import host_spans, waits


def read(record):
    if not record:
        return None
    frames = host_spans(record, 'spc.frame')
    if not frames or len(frames) != record['units']:
        return None
    return len(waits(record, 'spc.frame')) / len(frames)
