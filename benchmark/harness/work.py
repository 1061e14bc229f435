"""The work a kernel's roofline is taken against, counted by plain code
from the cell's inputs, whatever kernel or culling does it.

K1 (the DIB-R selection: z-buffer winner and soft-mask product per pixel):
per view, the (pixel, front face) pairs inside the face's own box
(coverage; a pixel outside it is never covered) at ``K1_COVER_FLOPS``, and
the (pixel, face) pairs inside its box grown by ``boxlen`` (outside it the
face adds nothing to the product) at ``K1_MASK_FLOPS``; each face's
corners, z and flag read once (40 bytes), each pixel's face id and product
written once (8 bytes).  The float32 operation counts are those of
``kaolin_tpu_torch/csrc/dibr_fused.cu``, frozen here.

K3 (the SPC trace): for each ray, the voxels of every cell of the cell
grid (level ``level - cell_shift``) that the ray passes through, at
``K3_PAIR_FLOPS`` a slab test (``probes/kbisect.py::PAIR_FLOPS``); each
ray read once (24 bytes), each leaf voxel once (16 bytes: coordinates and
index), each ray's count (4 bytes) and each hit's depth and index (8
bytes) written once.
"""

import torch

__all__ = ['K1_COVER_FLOPS', 'K1_MASK_FLOPS', 'K3_PAIR_FLOPS',
           'pixels_in_boxes', 'k1_work', 'cell_counts', 'cell_pairs',
           'k3_work']

K1_COVER_FLOPS = 35
K1_MASK_FLOPS = 87
K3_PAIR_FLOPS = 18


def pixels_in_boxes(lo, hi, H, W):
    """Pixel centres ``x = (2 i + 1 - W) / W``, ``y = (H - 2 j - 1) / H``
    inside each box ``[lo, hi]`` (N, 2): (N,) int64."""
    lo, hi = lo.double(), hi.double()
    i0 = torch.ceil((lo[:, 0] * W + W - 1) / 2).clamp(0, W)
    i1 = torch.floor((hi[:, 0] * W + W - 1) / 2).clamp(-1, W - 1)
    j0 = torch.ceil((H - 1 - hi[:, 1] * H) / 2).clamp(0, H)
    j1 = torch.floor((H - 1 - lo[:, 1] * H) / 2).clamp(-1, H - 1)
    return ((i1 - i0 + 1).clamp(min=0) * (j1 - j0 + 1).clamp(min=0)).long()


def k1_work(fvi, front, H, W, boxlen):
    """(bytes, flops) of K1 over views: ``fvi`` (B, F, 3, 2) image-space
    corners in [-1, 1], ``front`` (B, F) bool."""
    B, F = fvi.shape[:2]
    lo, hi = fvi.amin(2).reshape(-1, 2), fvi.amax(2).reshape(-1, 2)
    own = pixels_in_boxes(lo, hi, H, W)[front.reshape(-1)].sum()
    grown = pixels_in_boxes(lo - boxlen, hi + boxlen, H, W).sum()
    flops = K1_COVER_FLOPS * int(own) + K1_MASK_FLOPS * int(grown)
    return B * (F * 40 + H * W * 8), flops


def cell_counts(leaf, level, cell_shift):
    """Voxels per cell of the level-``level - cell_shift`` grid: a dense
    (n, n, n) int64 tensor."""
    n = 1 << (level - cell_shift)
    c = leaf.to(torch.int64) >> cell_shift
    flat = (c[:, 0] * n + c[:, 1]) * n + c[:, 2]
    return torch.bincount(flat, minlength=n ** 3).reshape(n, n, n)


def cell_pairs(counts, origin, direction):
    """Sum over rays of the voxels in the cells each ray passes through
    (t > 0) in [-1, 1]^3, by a voxel walk (Amanatides and Woo) over the
    grid of ``counts`` (n, n, n): the cells whose box the slab test says the
    ray enters (exit > entry).  Rays (R, 3), float64 inside."""
    n = counts.shape[0]
    cs = 2.0 / n
    o, d = origin.double(), direction.double()
    d = torch.where(d.abs() < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)
    t0 = (-1. - o) / d
    t1 = (1. - o) / d
    t_in = torch.minimum(t0, t1).amax(1).clamp(min=0.)
    t_out = torch.maximum(t0, t1).amin(1)
    live = t_out > t_in
    o, d, t_in, t_out = o[live], d[live], t_in[live], t_out[live]
    p = o + d * t_in[:, None]
    cell = torch.floor((p + 1.) / cs).long().clamp(0, n - 1)
    step = torch.where(d > 0, 1, -1)
    edge = (cell + (step > 0).long()).double() * cs - 1.
    t_max = (edge - o) / d
    t_delta = cs / d.abs()
    flat = counts.reshape(-1)
    total = 0
    while cell.shape[0]:
        total += int(flat[(cell[:, 0] * n + cell[:, 1]) * n
                          + cell[:, 2]].sum())
        # every axis whose boundary comes first at once: a cell the ray
        # only touches along an edge or at a corner holds no segment of it
        t_next = t_max.amin(1)
        cross = t_max == t_next[:, None]
        cell = cell + step * cross
        t_max = t_max + t_delta * cross
        keep = ((t_next < t_out) & (cell >= 0).all(1) & (cell < n).all(1))
        cell, t_max, t_delta, step, t_out = (
            x[keep] for x in (cell, t_max, t_delta, step, t_out))
    return total


def k3_work(leaf, level, cell_shift, origin, direction, hits):
    """(bytes, flops) of K3 for one frame: ``leaf`` (V, 3) leaf voxels,
    rays (R, 3), ``hits`` the frame's total hit count."""
    pairs = cell_pairs(cell_counts(leaf, level, cell_shift), origin,
                       direction)
    R, V = origin.shape[0], leaf.shape[0]
    return R * 24 + V * 16 + R * 4 + int(hits) * 8, K3_PAIR_FLOPS * pairs
