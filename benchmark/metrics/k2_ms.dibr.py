"""K2, the soft mask's backward (its three kernels): device ms per step."""

from benchmark.harness.trace import select

K2 = (r'\bfused_backward_units_kernel\b', r'\bfused_backward_kernel\b',
      r'\bfused_backward_sum_kernel\b')


def read(record):
    if not record:
        return None
    ops = select(record['ops'], K2)
    if not ops:
        return None
    return sum(o[2] for o in ops) * 1e-3 / record['units']
