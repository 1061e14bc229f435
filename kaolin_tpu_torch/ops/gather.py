"""Row gathers with batch dims folded into the row index.

Port of ``kaolin_tpu/ops/gather.py``.  The JAX package flattens batched
gathers into rank-2 row gathers and writes the backward scatter-add by
hand, because XLA on the TPU lowers both forms slowly.  In PyTorch the row
gather is ``index_select``, whose backward is that same scatter-add
(``index_add_``), so the port keeps the functions for their names and
semantics, not for speed.
"""

import torch

__all__ = ['gather_rows', 'flat_index']


def flat_index(batched_idx, num_rows):
    """Flatten per-batch row indices into indices of the (B*N, ...) table.

    Args:
        batched_idx: ``(B, ...)`` int tensor of per-batch row ids in [0, N).
        num_rows: N, rows per batch element.

    Returns:
        ``(B * prod(...),)`` int32 flat row ids.
    """
    B = batched_idx.shape[0]
    per = batched_idx.reshape(B, -1).to(torch.int32)
    off = torch.arange(B, dtype=torch.int32,
                       device=batched_idx.device)[:, None] * num_rows
    return (per + off).reshape(-1)


def gather_rows(table, idx):
    """Gather rows of a table: ``table[idx]``.

    Args:
        table: ``(N, D...)``.
        idx: ``(P,)`` int row ids in ``[0, N)``.

    Returns:
        ``(P, D...)``; the gradient to ``table`` is the scatter-add of the
        output's gradient onto the rows, none to ``idx``.
    """
    return table.index_select(0, idx.long())
