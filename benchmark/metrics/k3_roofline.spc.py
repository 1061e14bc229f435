"""K3's share of its roofline: the bound of one frame's trace work
(``benchmark/harness/work.py::k3_work``: slab tests of each ray against the
voxels of the cells it passes through, counted from the octree, the cell
grid and the rays) over K3's device time per frame."""

from benchmark.harness.peaks import share
from benchmark.harness.trace import select

K3 = (r'\bspc_trace_kernel\b',)


def read(record):
    if not record or 'k3_flops' not in record.get('work', {}):
        return None
    ops = select(record['ops'], K3)
    if not ops:
        return None
    seconds = sum(o[2] for o in ops) * 1e-6 / record['units']
    w = record['work']
    return share(w['k3_bytes'], w['k3_flops'], seconds)
