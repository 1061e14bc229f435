"""Row gathers with batch dims folded into the row index, and their
hand-written backward.

Port of ``kaolin_tpu/ops/gather.py``.  The JAX package flattens batched
gathers into rank-2 row gathers and writes the backward scatter-add by
hand as a ``custom_vjp``.  Here :func:`gather_rows` is a
``torch.autograd.Function`` of the same shape: its forward is the row
gather (``index_select``, as the JAX forward is XLA's plain
``table[idx]``), and its backward the scatter-add of the cotangent onto the
rows, which on the card is kernel E3 (:mod:`kaolin_tpu_torch.ops._scatter`):
no atomics, the same bits every run, and a time that does not follow the
longest run of one id.  On the CPU the backward is ``index_add_``.
"""

import torch

from kaolin_tpu_torch.ops import _scatter

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


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` with the scatter-add backward of E3."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _scatter._scatter_rows(g.contiguous(), idx, ctx.num_rows), None


def gather_rows(table, idx):
    """Gather rows of a table: ``table[idx]``.

    Args:
        table: ``(N, D...)``.
        idx: ``(P,)`` int32 or int64 row ids in ``[0, N)``.

    Returns:
        ``(P, D...)``; the gradient to ``table`` is the scatter-add of the
        output's gradient onto the rows (kernel E3 on the card), none to
        ``idx``.
    """
    return _GatherRows.apply(table, idx)
