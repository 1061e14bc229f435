"""The culling's first stage (``render/spc/raster.py::_cull_candidates``:
beam boxes, super-tile and block tests, the first candidates kept): the
span ``spc.cull``'s self device time, ms per frame."""

from benchmark.harness.spans import self_ms


def read(record):
    return self_ms(record, 'spc.cull', per='spc.frame')
