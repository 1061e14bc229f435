"""DIB-R++'s SG shading, forward (``models/dibrpp.py::sg_shading``: the
diffuse and specular terms of every light over every pixel, PyTorch ops):
the span ``dibr.sg``'s self device time, ms per step."""

from benchmark.harness.spans import self_ms


def read(record):
    return self_ms(record, 'dibr.sg')
