"""The forward render and the loss (``models/inverse_render.py::
render_loss``: the projection again, the epilogue's gathers and passes, E1,
the soft mask, L1 and IoU): the span ``dibr.render``'s self device time, ms
per step; on four cards it holds no selection, which is its own span."""

from benchmark.harness.spans import self_ms


def read(record):
    return self_ms(record, 'dibr.render')
