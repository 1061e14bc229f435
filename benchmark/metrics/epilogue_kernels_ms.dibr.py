"""The epilogue's hand-written kernels E1-E3 and the sorts they bin by:
device ms per step.  A sort is the library's and is named by it, so it
counts here only where the next hand-written kernel after it is E2's or
E3's ``segment_pieces_kernel``: the selection's sorts of the faces by
tile, which K1 follows, do not."""

from benchmark.harness.trace import launched_for, select

EPILOGUE = (r'\bbilinear_forward_kernel\b', r'\bbilinear_pixels_kernel\b',
            r'\bsegment_pieces_kernel\b', r'\bsegment_combine_kernel\b')
SORTS = (r'RadixSort', r'radixSort', r'bitonicSort', r'sort_postprocess')
HAND_WRITTEN = EPILOGUE + (
    r'\bfused_forward_kernel\b', r'\bfused_backward_units_kernel\b',
    r'\bfused_backward_kernel\b', r'\bfused_backward_sum_kernel\b')
BINNED_FOR = (r'\bsegment_pieces_kernel\b',)


def read(record):
    if not record:
        return None
    ops = select(record['ops'], EPILOGUE)
    if not ops:
        return None
    ops += launched_for(record['ops'], SORTS, HAND_WRITTEN, BINNED_FOR)
    return sum(o[2] for o in ops) * 1e-3 / record['units']
