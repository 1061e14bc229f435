"""K1's share of its roofline: the bound of one step's selection work
(``benchmark/harness/work.py::k1_work``, counted from the projected faces at
the traced block's start) over K1's device time per step."""

from benchmark.harness.peaks import share
from benchmark.harness.trace import select

K1 = (r'\bfused_forward_kernel\b',)


def read(record):
    if not record or 'k1_flops' not in record.get('work', {}):
        return None
    ops = select(record['ops'], K1)
    if not ops:
        return None
    seconds = sum(o[2] for o in ops) * 1e-6 / record['units']
    w = record['work']
    return share(w['k1_bytes'], w['k1_flops'], seconds)
