"""The exchange of the multi-card step (``parallel/sharding.py::
multi_view_grad``: the loss and the gradients into one buffer, its
all-reduce, the views back): the span ``parallel.all_reduce``'s device
time, ms per step on rank 0, the wait for the slowest card included."""

from benchmark.harness.spans import self_ms


def read(record):
    return self_ms(record, 'parallel.all_reduce')
