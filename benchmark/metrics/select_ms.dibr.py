"""The selection (``models/inverse_render.py::compute_selection``: the
projection, the faces' tiles and their sorts, K1): the span
``dibr.select``'s self device time, ms per step."""

from benchmark.harness.spans import self_ms


def read(record):
    return self_ms(record, 'dibr.select')
