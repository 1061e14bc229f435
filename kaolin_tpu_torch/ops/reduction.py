"""Reductions over packed layouts.

Port of ``kaolin_tpu/ops/reduction.py``: one ``index_add_`` over the rows'
segment ids.
"""

import numpy as np
import torch

__all__ = ['packed_simple_sum']


def packed_simple_sum(tensor, numel_per_tensor):
    """Sum all elements of each sub-tensor in a packed tensor.

    Args:
        tensor: packed tensor ``(total_rows, last_dim)``.
        numel_per_tensor: (B,) host array of rows per sub-tensor.

    Returns:
        (B,) tensor of per-sub-tensor sums.
    """
    numel_per_tensor = np.asarray(numel_per_tensor, dtype=np.int64)
    num_segments = numel_per_tensor.shape[0]
    seg_ids = torch.as_tensor(
        np.repeat(np.arange(num_segments), numel_per_tensor),
        device=tensor.device)
    row_sums = torch.sum(tensor, dim=-1)
    return torch.zeros(num_segments, dtype=row_sums.dtype,
                       device=tensor.device).index_add(0, seg_ids, row_sums)
