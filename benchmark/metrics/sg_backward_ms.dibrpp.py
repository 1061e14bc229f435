"""The backward of DIB-R++'s SG shading (autograd's, of the forward's
PyTorch ops, inside ``loss.backward()``): the span ``dibr.sg_backward``'s
self device time, ms per step."""

from benchmark.harness.spans import self_ms


def read(record):
    return self_ms(record, 'dibr.sg_backward')
