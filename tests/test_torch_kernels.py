"""The port's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where only PyTorch is installed
(on the card: ``python -m pytest --noconftest tests/test_torch_kernels.py``).
Tests marked ``cuda`` need a CUDA card and skip elsewhere.

Tolerances (kernel vs plain version, same inputs, same card): face ids
exactly equal and prod within 1e-5 (the kernels round every product and
sum as the plain versions do, ``-fmad=false``; only the order of the
soft-mask product differs); backward rows within 1e-4 * max|rows| (the
per-face sums are taken in another order).  The edge scenes
(``dibr_edge_scene``: z ties, a face list longer than a staging batch,
``boxlen = 0``, image sides that are not multiples of 16, an empty screen)
and a gradient from one pixel hold the kernels' culling to the same limits.
"""
import numpy as np
import pytest
import torch

from kaolin_tpu_torch.render.mesh import _fused as FT
from kaolin_tpu_torch.utils.testing import (EDGE_SCENES, dibr_edge_scene,
                                            random_triangles)

SIZES = [(64, 64), (35, 31), (40, 200), (128, 300)]
MULT = 1000.

# evaluated when the test runs, not at import
cuda = pytest.mark.skipif('not torch.cuda.is_available()',
                          reason='needs a CUDA card (run on the H100)')


def random_scene(seed, F=300, B=2, device='cpu'):
    fvz, fvi = random_triangles(seed, F, B)
    return (torch.as_tensor(fvz, device=device),
            torch.as_tensor(fvi, device=device))


def _tiles(fvz, fvi, H, W):
    valid = torch.ones(fvz.shape[:2], dtype=torch.bool, device=fvz.device)
    vt, tr, ctr, cbb, _, _ = FT.build_face_tiles(fvz, fvi * MULT, valid, H,
                                                 W, MULT, 0.02 * MULT)
    return vt.contiguous(), tr, ctr, cbb.contiguous()


def test_plain_versions_honour_empty_ranges():
    """A tile with no chunk range stays empty; a chunk with no tile range
    gets zero rows — whatever the face table holds."""
    H, W = 35, 31
    fvz, fvi = random_scene(0, F=70)
    vt, tr, ctr, cbb = _tiles(fvz, fvi, H, W)
    fid, prod = FT._fused_forward_torch(vt, torch.zeros_like(tr), cbb, H, W,
                                        MULT, 1e-8, 7000., True)
    assert fid.shape == (2, H, W) and prod.shape == (2, H, W)
    assert torch.all(fid == -1) and torch.all(prod == 1.)
    g = torch.ones((2, H, W))
    rows = FT._fused_backward_torch(vt, torch.zeros_like(ctr), cbb, g, H, W,
                                    MULT, 7000.)
    assert rows.shape == (2, vt.shape[1] * FT.FC, 6)
    assert torch.all(rows == 0.)
    full = FT._fused_backward_torch(vt, ctr, cbb, g, H, W, MULT, 7000.)
    assert full.abs().max() > 0
    # padded faces (sorted ids >= F) never receive a gradient
    assert torch.all(full[:, 70:] == 0.)


@cuda
@pytest.mark.parametrize('hw', SIZES)
def test_cuda_forward_matches_plain(hw):
    H, W = hw
    fvz, fvi = random_scene(0, device='cuda')
    vt, tr, _, cbb = _tiles(fvz, fvi, H, W)
    n0 = FT.LAUNCHES['fwd']
    for with_softmask in (True, False):
        fid_k, prod_k = FT._fused_forward(vt, tr, cbb, H, W, MULT, 1e-8,
                                          7000., with_softmask)
        torch.cuda.synchronize()
        fid_p, prod_p = FT._fused_forward_torch(vt, tr, cbb, H, W, MULT,
                                                1e-8, 7000., with_softmask)
        assert torch.equal(fid_k, fid_p)
        assert (prod_k - prod_p).abs().max().item() <= 1e-5
    assert FT.LAUNCHES['fwd'] == n0 + 2
    assert (fid_k >= 0).any() and (fid_k < 0).any()


@cuda
@pytest.mark.parametrize('hw', SIZES)
def test_cuda_backward_matches_plain(hw):
    H, W = hw
    fvz, fvi = random_scene(1, device='cuda')
    sel = FT.fused_selection(fvz, fvi, height=H, width=W)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, H, W)).astype(np.float32), device='cuda')
    g_prod = torch.where(sel.face_idx < 0, g * sel.prod, 0.).contiguous()
    n0 = FT.LAUNCHES['bwd']
    k = FT._fused_backward(sel.vt, sel.chunk_tranges, sel.chunk_bbox, g_prod,
                           H, W, MULT, 7000.)
    torch.cuda.synchronize()
    assert FT.LAUNCHES['bwd'] == n0 + 1
    p = FT._fused_backward_torch(sel.vt, sel.chunk_tranges, sel.chunk_bbox,
                                 g_prod, H, W, MULT, 7000.)
    scale = p.abs().max().item()
    assert scale > 0
    assert (k - p).abs().max().item() <= 1e-4 * scale


@cuda
def test_cuda_kernels_long_chunk_ranges():
    """At 512^2 a chunk's tile range spans more than the 256 backward units
    one ranking pass of the backward kernel takes, and the forward
    kernel's sub-tiles walk long chunk ranges."""
    H = W = 512
    fvz, fvi = random_scene(4, F=200, device='cuda')
    sel = FT.fused_selection(fvz, fvi, height=H, width=W)
    _, _, TW = FT._tile_dims(*FT._padded_dims(H, W))
    ctr = sel.chunk_tranges
    units = (ctr[..., 1] - ctr[..., 0]).clamp(min=0) * (
        TW // FT._unit_width(TW))
    assert units.max().item() > 256
    vt, tr, _, cbb = _tiles(fvz, fvi, H, W)
    fid_k, prod_k = FT._fused_forward(vt, tr, cbb, H, W, MULT, 1e-8, 7000.,
                                      True)
    torch.cuda.synchronize()
    fid_p, prod_p = FT._fused_forward_torch(vt, tr, cbb, H, W, MULT, 1e-8,
                                            7000., True)
    assert torch.equal(fid_k, fid_p)
    assert (prod_k - prod_p).abs().max().item() <= 1e-5
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, H, W)).astype(np.float32), device='cuda')
    g_prod = torch.where(sel.face_idx < 0, g * sel.prod, 0.).contiguous()
    k, p = _backward_both(sel.vt, ctr, sel.chunk_bbox, g_prod, H, W)
    scale = p.abs().max().item()
    assert scale > 0 and (k - p).abs().max().item() <= 1e-4 * scale


@cuda
def test_cuda_softmask_grad_matches_cpu():
    """The autograd path on the card against the same path on the CPU."""
    H, W = 40, 200
    fvz, fvi = random_scene(2)
    out = []
    for dev in ('cpu', 'cuda'):
        x = fvi.to(dev).clone().requires_grad_()
        sel = FT.fused_selection(fvz.to(dev), x, height=H, width=W)
        mask = FT.softmask_fused(x * MULT, sel, (H, W, MULT, 7000.))
        (mask ** 2).sum().backward()
        out.append((sel.face_idx.cpu(), mask.detach().cpu(), x.grad.cpu()))
    (fi_c, m_c, g_c), (fi_k, m_k, g_k) = out
    assert (fi_c != fi_k).float().mean().item() <= 1e-3
    assert (m_c - m_k).abs().max().item() <= 2e-5
    assert (g_c - g_k).abs().max().item() <= 1e-3 * g_c.abs().max().item()


@cuda
def test_cuda_wrapper_checks_inputs():
    fvz, fvi = random_scene(0, B=1, device='cuda')
    vt, tr, ctr, cbb = _tiles(fvz, fvi, 32, 32)
    with pytest.raises(ValueError, match='tile_ranges'):
        FT._fused_forward(vt, tr.long(), cbb, 32, 32, MULT, 1e-8, 7000.,
                          True)
    with pytest.raises(ValueError, match='vt'):
        FT._fused_forward(vt.transpose(2, 3), tr, cbb, 32, 32, MULT, 1e-8,
                          7000., True)
    with pytest.raises(ValueError, match='g_prod'):
        FT._fused_backward(vt, ctr, cbb, torch.zeros((1, 32, 33),
                                                     device='cuda'),
                           32, 32, MULT, 7000.)


def _edge_tiles(name):
    fvz, fvi, H, W, boxlen = (torch.as_tensor(v, device='cuda')
                              if isinstance(v, np.ndarray) else v
                              for v in dibr_edge_scene(name))
    valid = torch.ones(fvz.shape[:2], dtype=torch.bool, device='cuda')
    vt, tr, ctr, cbb, _, _ = FT.build_face_tiles(
        fvz, fvi * MULT, valid, H, W, MULT, boxlen * MULT)
    return vt.contiguous(), tr, ctr, cbb.contiguous(), H, W


def _backward_both(vt, ctr, cbb, g_prod, H, W):
    k = FT._fused_backward(vt, ctr, cbb, g_prod, H, W, MULT, 7000.)
    torch.cuda.synchronize()
    return k, FT._fused_backward_torch(vt, ctr, cbb, g_prod, H, W, MULT,
                                       7000.)


@cuda
@pytest.mark.parametrize('name', EDGE_SCENES)
def test_cuda_forward_edge_scenes(name):
    vt, tr, _, cbb, H, W = _edge_tiles(name)
    fid_k, prod_k = FT._fused_forward(vt, tr, cbb, H, W, MULT, 1e-8, 7000.,
                                      True)
    torch.cuda.synchronize()
    fid_p, prod_p = FT._fused_forward_torch(vt, tr, cbb, H, W, MULT, 1e-8,
                                            7000., True)
    assert torch.equal(fid_k, fid_p)
    assert (prod_k - prod_p).abs().max().item() <= 1e-5
    lists = FT._cull_forward(vt, tr, cbb, H, W, MULT).sum(-1)
    if name == 'empty':
        assert torch.all(fid_k == -1) and torch.all(prod_k == 1.)
    else:
        assert (fid_k >= 0).any() and (prod_k < 1.).any()
    if name == 'cluster':              # more than two staging batches
        assert lists.max().item() > 300


@cuda
@pytest.mark.parametrize('name', EDGE_SCENES)
def test_cuda_backward_edge_scenes(name):
    vt, tr, ctr, cbb, H, W = _edge_tiles(name)
    fid, prod = FT._fused_forward_torch(vt, tr, cbb, H, W, MULT, 1e-8,
                                        7000., True)
    g = torch.as_tensor(np.random.default_rng(3).standard_normal(
        tuple(fid.shape)).astype(np.float32), device='cuda')
    g_prod = torch.where(fid < 0, g * prod, 0.).contiguous()
    k, p = _backward_both(vt, ctr, cbb, g_prod, H, W)
    scale = p.abs().max().item()
    assert (scale == 0.) == (name == 'empty')
    assert (k - p).abs().max().item() <= 1e-4 * scale
    # no atomics: a second run repeats the sums bit for bit
    again = FT._fused_backward(vt, ctr, cbb, g_prod, H, W, MULT, 7000.)
    assert torch.equal(k, again)


@cuda
def test_cuda_backward_single_pixel():
    """g * prod non-zero on one background pixel, inside the cluster: only
    faces whose enlarged bbox holds it get a gradient."""
    vt, tr, ctr, cbb, H, W = _edge_tiles('cluster')
    fid, prod = FT._fused_forward_torch(vt, tr, cbb, H, W, MULT, 1e-8,
                                        7000., True)
    ys, xs = torch.nonzero((fid[0] < 0) & (prod[0] < 1.), as_tuple=True)
    i = torch.argmin((ys - 40).abs() + (xs - 24).abs())
    y, x = int(ys[i]), int(xs[i])
    g_prod = torch.zeros_like(prod)
    g_prod[0, y, x] = prod[0, y, x]
    k, p = _backward_both(vt, ctr, cbb, g_prod, H, W)
    scale = p.abs().max().item()
    assert scale > 0 and (k - p).abs().max().item() <= 1e-4 * scale
    ax, bx, ay, by = FT._pixel_affine(H, W, MULT)
    x0, y0 = ax * x + bx, ay * y + by
    bb = vt[0].reshape(-1, FT._NCOL)[:, FT._BB:FT._BB + 4]
    holds = ((x0 >= bb[:, 0]) & (x0 < bb[:, 2]) & (y0 >= bb[:, 1])
             & (y0 < bb[:, 3]))
    got = (k[0] != 0.).any(-1)
    assert got.any() and not (got & ~holds).any()
    assert torch.all(k[1] == 0.)


def test_k1_clock_probe_patches_only_clock_reads():
    """The clock probe's anchors stand once each in K1's source, and its
    patched copy is that source with the clock reads and nothing else."""
    from kaolin_tpu_torch.probes import k1_clocks
    src = k1_clocks.patched_source()
    orig = (k1_clocks._cuda.CSRC / 'dibr_fused.cu').read_text()
    assert src.count('clock64()') == 2 and 'k1_clock_read' in src
    for part in (k1_clocks._RECORDS, k1_clocks._CLOCK0, k1_clocks._CLOCK1):
        assert src.count(part) == 1
        src = src.replace(part, '')
    assert src == orig
