"""The k-buffer's allocation and fills before K3 (``render/spc/_trace.py::
_outputs``): the span ``spc.trace``'s self device time less
``spc_trace_kernel``'s, ms per frame."""

from benchmark.harness.spans import self_ms

K3 = (r'\bspc_trace_kernel\b',)


def read(record):
    return self_ms(record, 'spc.trace', per='spc.frame', leave_out=K3)
