"""Adam's update in the compiled step (``optimizer.step()``, captured in the
graph): the span ``optim.step``'s device time, ms per step."""

from benchmark.harness.spans import self_ms


def read(record):
    return self_ms(record, 'optim.step')
