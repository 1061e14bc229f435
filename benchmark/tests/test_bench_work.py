"""The roofline work counts against brute-force counts at small sizes."""

import math

import pytest
import torch

from benchmark.harness import scene, work


def brute_pixels(lo, hi, H, W):
    xs = (2 * torch.arange(W, dtype=torch.float64) + 1 - W) / W
    ys = (H - 2 * torch.arange(H, dtype=torch.float64) - 1) / H
    inx = (xs[None] >= lo[:, :1]) & (xs[None] <= hi[:, :1])
    iny = (ys[None] >= lo[:, 1:]) & (ys[None] <= hi[:, 1:])
    return inx.sum(1) * iny.sum(1)


@pytest.mark.parametrize('H,W', [(16, 16), (24, 40), (7, 5)])
def test_pixels_in_boxes(H, W):
    g = torch.Generator().manual_seed(H * W)
    a = torch.rand((500, 2), generator=g, dtype=torch.float64) * 2.6 - 1.3
    b = a + torch.rand((500, 2), generator=g, dtype=torch.float64) * 0.7
    assert torch.equal(work.pixels_in_boxes(a, b, H, W),
                       brute_pixels(a, b, H, W))


def test_k1_work_counts_pairs():
    g = torch.Generator().manual_seed(1)
    fvi = torch.rand((2, 30, 3, 2), generator=g) * 1.6 - 0.8
    front = torch.rand((2, 30), generator=g) > 0.5
    H, W, boxlen = 20, 28, 0.05
    nbytes, flops = work.k1_work(fvi, front, H, W, boxlen)
    lo, hi = fvi.amin(2).reshape(-1, 2).double(), fvi.amax(2).reshape(
        -1, 2).double()
    own = brute_pixels(lo, hi, H, W)[front.reshape(-1)].sum()
    grown = brute_pixels(lo - boxlen, hi + boxlen, H, W).sum()
    assert flops == 35 * int(own) + 87 * int(grown)
    assert nbytes == 2 * (30 * 40 + H * W * 8)


def brute_cell_pairs(counts, o, d):
    """Each ray against each cell's box by the slab test (t > 0)."""
    n = counts.shape[0]
    cs = 2. / n
    idx = torch.stack(torch.meshgrid(*[torch.arange(n)] * 3, indexing='ij'),
                      -1).reshape(-1, 3).double()
    lo = idx * cs - 1.
    total = 0
    for r in range(o.shape[0]):
        t0 = (lo - o[r]) / d[r]
        t1 = t0 + cs / d[r]
        tn = torch.minimum(t0, t1).amax(1)
        tf = torch.maximum(t0, t1).amin(1)
        hit = (tf > tn) & (tf > 0)
        total += int(counts.reshape(-1)[hit].sum())
    return total


@pytest.mark.parametrize('turn', [0., 0.3, math.pi / 4, 2.])
def test_cell_pairs_walk(turn):
    g = torch.Generator().manual_seed(5)
    leaf = torch.randint(0, 32, (3000, 3), generator=g)
    counts = work.cell_counts(leaf, 5, 2)                 # 8^3 cells
    assert int(counts.sum()) == 3000
    o, d = scene.camera_grid(6, z=-2.5, spread=0.2, extent=0.9)
    # off the grid's symmetry: a ray through a cell edge touches cells
    # that the slab test takes or leaves by rounding
    o = o + torch.rand(o.shape, generator=g, dtype=torch.float64).numpy() * 1e-3
    o, d = torch.as_tensor(scene.turn_y(o, turn)), torch.as_tensor(
        scene.turn_y(d, turn))
    assert work.cell_pairs(counts, o, d) == brute_cell_pairs(counts, o, d)


def test_k3_work_bytes():
    leaf = torch.randint(0, 16, (100, 3))
    o, d = scene.camera_grid(4)
    nbytes, flops = work.k3_work(leaf, 4, 1, torch.as_tensor(o),
                                 torch.as_tensor(d), hits=10)
    assert nbytes == 16 * 24 + 100 * 16 + 16 * 4 + 10 * 8
    assert flops % 18 == 0 and flops > 0
