"""Pointcloud metrics: sided distance, chamfer, f-score.

Port of ``kaolin_tpu/metrics/pointcloud.py``.  The closest point is chosen
by a chunked sweep of every ``(p1, p2)`` pair with the exact
``(ax - bx)^2 + (ay - by)^2 + (az - bz)^2`` (not ``|a|^2 + |b|^2 - 2 a.b``,
which moves distances and near-tie indices) and the first index of the
minimum; the sweep carries no gradient, and the distance is recomputed
differentiably on the chosen pairs.  The chunk size changes no result.
"""

import torch

__all__ = ['sided_distance', 'chamfer_distance', 'f_score']

# (B, chunk, P2) float32 temporaries of the sweep: about 6 live at once
_SWEEP_BYTES = 4 * 2 ** 30


def _chunk_rows(B, P2, chunk_size):
    if chunk_size is not None:
        return chunk_size
    return max(1, _SWEEP_BYTES // (6 * 4 * max(1, B * P2)))


def _sided_argmin(p1, p2, chunk_size):
    """(B, P1) index of the closest point of p2 for every point of p1."""
    B, P1 = p1.shape[:2]
    rows = _chunk_rows(B, p2.shape[1], chunk_size)
    bx, by, bz = (p2[:, None, :, k] for k in range(3))      # (B, 1, P2)
    out = []
    for lo in range(0, P1, rows):
        c = p1[:, lo:lo + rows]
        d = (c[..., 0:1] - bx) ** 2
        d = d + (c[..., 1:2] - by) ** 2
        d = d + (c[..., 2:3] - bz) ** 2                       # (B, c, P2)
        out.append(torch.argmin(d, dim=2))
    return torch.cat(out, dim=1)


def sided_distance(p1, p2, chunk_size=None):
    """For each point of p1, the squared distance to and the index of the
    closest point of p2.

    Args:
        p1: ``(B, P1, 3)``.
        p2: ``(B, P2, 3)``.
        chunk_size: rows of p1 per sweep step (default: temporaries of
            about 4 GiB).

    Returns:
        (dist ``(B, P1)``, idx ``(B, P1)`` int64), dist differentiable.
    """
    if p1.ndim != 3 or p2.ndim != 3:
        raise ValueError("p1 and p2 must be (B, N, 3)")
    with torch.no_grad():
        idx = _sided_argmin(p1.detach(), p2.detach(), chunk_size)
    closest = torch.gather(p2, 1, idx[..., None].expand(-1, -1, 3))
    dist = torch.sum((p1 - closest) ** 2, dim=-1)
    return dist, idx


def chamfer_distance(p1, p2, w1=1., w2=1., squared=True, chunk_size=None):
    """Chamfer distance between two batched pointclouds.

    Returns:
        ``(B,)`` distances.
    """
    sdist1 = sided_distance(p1, p2, chunk_size)[0]
    sdist2 = sided_distance(p2, p1, chunk_size)[0]
    if not squared:
        sdist1 = torch.sqrt(sdist1)
        sdist2 = torch.sqrt(sdist2)
    return w1 * torch.mean(sdist1, dim=-1) + w2 * torch.mean(sdist2, dim=-1)


def f_score(gt_points, pred_points, radius=0.01, eps=1e-8, chunk_size=None):
    """F-score of two point sets with a hit radius.

    Returns:
        ``(B,)`` f-scores.
    """
    pred_distances = torch.sqrt(
        sided_distance(gt_points, pred_points, chunk_size)[0])
    gt_distances = torch.sqrt(
        sided_distance(pred_points, gt_points, chunk_size)[0])
    dtype = pred_points.dtype
    fn = torch.sum(pred_distances > radius, dim=1).to(dtype)
    fp = torch.sum(gt_distances > radius, dim=1).to(dtype)
    tp = gt_distances.shape[1] - fp
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * (precision * recall) / (precision + recall + eps)
