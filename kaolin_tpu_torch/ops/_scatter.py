"""The row scatter-add of ``gather_rows``' backward (CUDA kernel E3).

Port of ``kaolin_tpu/ops/gather.py::_gather_rows_bwd``: ``zeros(N, D)
.at[idx].add(g)``.  On the card (``csrc/epilogue.cu``) the extension
module sorts the ids with PyTorch's stable sort, and
``segment_pieces_kernel`` and ``segment_combine_kernel`` add each row's
gradient rows in that order, with no atomics: every run gives the same
bits, and a long run of one id (the DIB-R step's background pixels, all on
one face row) is split over warps and its pieces added in a second pass.

:func:`_scatter_rows_torch` is the plain version (``index_add_``).  The
wrapper :func:`_scatter_rows` runs it for tensors on the CPU and the kernel
for tensors on a CUDA device; there is no fallback between the two.
``LAUNCHES`` counts launches: the wrapper adds one where it launches, and a
replayed CUDA graph adds what it holds
(``models/inverse_render.py::compiled_step``).
"""

import torch

__all__ = ['LAUNCHES']

LAUNCHES = {'scatter': 0}

_ext = _stream = None       # the extension module, the stream getter


def _bind():
    global _ext, _stream
    if _ext is None:
        from kaolin_tpu_torch import _cuda
        _stream = _cuda.stream_getter()
        _ext = _cuda.load_module('epilogue')
    return _ext


def _scatter_rows_torch(g, idx, num_rows):
    """E3's plain version: ``(num_rows, D...)`` zeros with each row ``g[p]``
    added onto row ``idx[p]``."""
    out = torch.zeros((num_rows,) + tuple(g.shape[1:]), dtype=g.dtype,
                      device=g.device)
    return out.index_add_(0, idx, g)


def _scatter_rows_cuda(g, idx, num_rows):
    """Launch E3; same contract as the plain version.  ``idx`` int32 or
    int64 (taken as int32)."""
    rows = g.reshape(g.shape[0], -1)
    idx32 = idx.to(torch.int32).contiguous()
    out = (_ext or _bind()).scatter_rows(rows, idx32, num_rows,
                                         _stream(g.get_device()))
    if out is None:
        from kaolin_tpu_torch.render.mesh._fused import _check
        P, D = rows.shape
        _check('g', rows, torch.float32, (P, D), g.device)
        _check('idx', idx32, torch.int32, (P,), g.device)
        raise ValueError(f'scatter_rows: {num_rows} rows of {D} columns '
                         'must hold fewer than 2^31 elements, and at least '
                         'one column')
    LAUNCHES['scatter'] += 1
    return out.reshape((num_rows,) + tuple(g.shape[1:]))


def _scatter_rows(g, idx, num_rows):
    """``zeros(num_rows, D...).index_add_(0, idx, g)``: CPU tensors run
    :func:`_scatter_rows_torch`, CUDA tensors launch E3."""
    if g.device.type == 'cpu':
        return _scatter_rows_torch(g, idx, num_rows)
    if g.device.type != 'cuda':
        raise ValueError(f'no row scatter for device {g.device}')
    return _scatter_rows_cuda(g, idx, num_rows)
