"""The block order (``render/spc/raster.py::_order_blocks``: the non-empty
blocks, their sort by candidate count, the segment caps): the span
``spc.order``'s self device time, ms per frame."""

from benchmark.harness.spans import self_ms


def read(record):
    return self_ms(record, 'spc.order', per='spc.frame')
