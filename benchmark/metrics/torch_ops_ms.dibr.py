"""Every device operation of the DIB-R step that is not a hand-written
kernel: the selection's set-up (its sorts of the faces by tile among
them), the epilogue's PyTorch ops, the loss and Adam, copies and fills;
device ms per step.  K1, K2, E1-E3, the sorts that E2 and E3 bin by
(those that ``segment_pieces_kernel`` follows) and NCCL's kernels are
left out."""

from benchmark.harness.trace import launched_for, select

OWN = (r'\bfused_forward_kernel\b', r'\bfused_backward_units_kernel\b',
       r'\bfused_backward_kernel\b', r'\bfused_backward_sum_kernel\b',
       r'\bbilinear_forward_kernel\b', r'\bbilinear_pixels_kernel\b',
       r'\bsegment_pieces_kernel\b', r'\bsegment_combine_kernel\b')
SORTS = (r'RadixSort', r'radixSort', r'bitonicSort', r'sort_postprocess')
BINNED_FOR = (r'\bsegment_pieces_kernel\b',)
NCCL = (r'nccl',)


def read(record):
    if not record or not record['ops']:
        return None
    own = (select(record['ops'], OWN + NCCL)
           + launched_for(record['ops'], SORTS, OWN, BINNED_FOR))
    rest = sum(o[2] for o in record['ops']) - sum(o[2] for o in own)
    return rest * 1e-3 / record['units']
