"""The gathers of K3's inputs (``render/spc/raster.py::_gather_inputs``):
the span ``spc.gather``'s self device time, ms per frame."""

from benchmark.harness.spans import self_ms


def read(record):
    return self_ms(record, 'spc.gather', per='spc.frame')
