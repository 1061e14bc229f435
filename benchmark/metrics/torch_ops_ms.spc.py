"""Every device operation of the SPC frame but K3 (culling, block order,
gathers, the k-buffer fills, copies): device ms per frame."""

from benchmark.harness.trace import select

K3 = (r'\bspc_trace_kernel\b',)


def read(record):
    if not record or not record['ops']:
        return None
    k3 = sum(o[2] for o in select(record['ops'], K3))
    rest = sum(o[2] for o in record['ops']) - k3
    return rest * 1e-3 / record['units']
