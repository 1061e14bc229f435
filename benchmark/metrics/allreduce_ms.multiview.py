"""The gradient all-reduce of the multi-card DIB-R step
(``parallel/sharding.py::multi_view_grad``): NCCL's all-reduce kernels'
device ms per step on rank 0, the wait for the slowest card included."""

from benchmark.harness.trace import select

ALLREDUCE = (r'AllReduce',)


def read(record):
    if not record:
        return None
    ops = select(record['ops'], ALLREDUCE)
    if not ops:
        return None
    return sum(o[2] for o in ops) * 1e-3 / record['units']
