"""Voxelgrid metrics.

Port of ``kaolin_tpu/metrics/voxelgrid.py``.
"""

import torch

__all__ = ['iou']


def iou(pred, gt):
    """Intersection over union of binary voxelgrids.

    Args:
        pred, gt: ``(B, X, Y, Z)``.

    Returns:
        ``(B,)`` float32 IoU values.
    """
    if pred.shape != gt.shape:
        raise ValueError(
            f"Expected predicted voxelgrids and ground truth voxelgrids to "
            f"have the same shape, but got {tuple(pred.shape)} and "
            f"{tuple(gt.shape)}")
    pred = pred.bool()
    gt = gt.bool()
    intersection = torch.sum(pred & gt, dim=(1, 2, 3)).to(torch.float32)
    union = torch.sum(pred | gt, dim=(1, 2, 3)).to(torch.float32)
    return intersection / union
