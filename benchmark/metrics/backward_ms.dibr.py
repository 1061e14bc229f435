"""Autograd's backward of the step (K2, E2, E3 and every PyTorch op of the
backward): the span ``autograd.backward``'s self device time, ms per step
(``loss.backward()`` in the compiled step, ``torch.autograd.grad`` in
``parallel/sharding.py::multi_view_grad``)."""

from benchmark.harness.spans import self_ms


def read(record):
    return self_ms(record, 'autograd.backward')
