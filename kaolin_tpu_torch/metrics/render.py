"""Rendering losses.

Port of ``kaolin_tpu/metrics/render.py``.
"""

import torch

__all__ = ['mask_iou']


def mask_iou(lhs_mask, rhs_mask):
    """IoU silhouette loss of two soft masks: ``1 - mean(IoU)``.

    Args:
        lhs_mask, rhs_mask: ``(B, H, W)``.

    Returns:
        scalar loss.
    """
    batch_size = lhs_mask.shape[0]
    if rhs_mask.shape != lhs_mask.shape:
        raise ValueError(f"mask shapes differ: {tuple(lhs_mask.shape)} vs "
                         f"{tuple(rhs_mask.shape)}")
    sil_mul = lhs_mask * rhs_mask
    sil_add = lhs_mask + rhs_mask
    iou_up = torch.sum(sil_mul.reshape(batch_size, -1), dim=1)
    iou_down = torch.sum((sil_add - sil_mul).reshape(batch_size, -1), dim=1)
    iou_neg = iou_up / (iou_down + 1e-10)
    return 1.0 - torch.mean(iou_neg)
