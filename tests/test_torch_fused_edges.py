"""Parity of the port's fused DIB-R engine with kaolin_tpu's on edge scenes.

The scenes (``kaolin_tpu_torch.utils.testing.dibr_edge_scene``) probe what
the port's CUDA kernels must keep of the function: z ties between duplicate
faces (the lowest sorted id wins), one 16 x 16 block whose face list holds
more than 300 faces, ``boxlen = 0``, image sides that are not multiples of
16, and an empty screen.  The JAX side runs ``fused_selection(...,
interpret=True)`` and ``jax.grad`` through ``softmask_fused`` (interpret
mode on the CPU); the port's side runs the plain PyTorch versions of the
kernels (``device='cpu'``).  ``test_torch_kernels.py`` holds the CUDA
kernels against those plain versions on the same scenes on a card.

Tolerances: face_idx exactly equal; prod and the soft mask within 2e-5
(XLA's CPU backend contracts a*b+c into an fma in interpret mode), as in
``test_torch_fused.py``.  Vertex gradients: every face's row within 1e-3 *
max(max|g_jax|, 1) and at most 1 % of the rows beyond 1e-4 of it.  Where a
pixel's two smallest distance candidates differ only by rounding, the fma
sends its gradient to the other candidate; with a few hundred faces that
moves a row or two by up to ~1e-3 of the largest (8.3e-4 on 'ties', both
copies of one face).

The culling tests hold the kernels' culling rules (``_cull_forward``,
``_cull_backward``) to the function on the same scenes: every (face,
pixel) pair that can change a result lies in a block the kernels compute.
"""
import functools

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.render.mesh import _fused as FJ
from kaolin_tpu_torch.render.mesh import _fused as FT
from kaolin_tpu_torch.utils.testing import EDGE_SCENES, dibr_edge_scene

MULT = 1000.
SIGMAINV = 7000.


@functools.lru_cache(maxsize=None)
def _select_both(name):
    """Both selections of a scene; shared by the tests of one worker."""
    fvz, fvi, H, W, boxlen = dibr_edge_scene(name)
    sj = FJ.fused_selection(jnp.asarray(fvz), jnp.asarray(fvi), height=H,
                            width=W, boxlen=boxlen, interpret=True)
    st = FT.fused_selection(torch.as_tensor(fvz), torch.as_tensor(fvi),
                            height=H, width=W, boxlen=boxlen)
    return fvi, (H, W, MULT, SIGMAINV), sj, st


def _grads(fvi, config, sj, st, g):
    g_j = np.asarray(jax.grad(lambda x: jnp.sum(
        FJ.softmask_fused(x * MULT, sj, config) * g))(jnp.asarray(fvi)))
    x = torch.tensor(fvi, requires_grad=True)
    (FT.softmask_fused(x * MULT, st, config) * torch.as_tensor(g)).sum() \
        .backward()
    return g_j, x.grad.numpy()


def _assert_grads_close(g_t, g_j):
    scale = max(np.abs(g_j).max(), 1.)
    err = np.abs(g_t - g_j).reshape(-1, 6).max(-1) / scale
    assert err.max() <= 1e-3
    assert (err > 1e-4).mean() <= 0.01


@pytest.mark.parametrize('name', EDGE_SCENES)
def test_selection_matches_jax(name):
    _, _, sj, st = _select_both(name)
    fid = st.face_idx.numpy()
    np.testing.assert_array_equal(fid, np.asarray(sj.face_idx))
    np.testing.assert_allclose(st.prod.numpy(), np.asarray(sj.prod),
                               rtol=0, atol=2e-5)
    if name == 'empty':
        assert np.all(fid == -1) and torch.all(st.prod == 1.)
    else:
        assert (fid >= 0).any() and (st.prod < 1.).any()
    if name == 'ties':                 # every winner is a first copy
        assert fid.max() < 150


@pytest.mark.parametrize('name', EDGE_SCENES)
def test_softmask_grad_matches_jax(name):
    fvi, config, sj, st = _select_both(name)
    H, W = config[:2]
    g = np.random.default_rng(5).standard_normal((2, H, W)).astype(
        np.float32)
    g_j, g_t = _grads(fvi, config, sj, st, g)
    _assert_grads_close(g_t, g_j)
    assert (np.abs(g_j).max() == 0) == (name == 'empty')


def test_single_pixel_grad_matches_jax():
    """g * prod non-zero on one background pixel, inside the cluster."""
    fvi, config, sj, st = _select_both('cluster')
    H, W = config[:2]
    bg = ((st.face_idx[0] < 0) & (st.prod[0] < 1.)).numpy()
    ys, xs = np.nonzero(bg)
    k = np.argmin(np.abs(ys - 40) + np.abs(xs - 24))
    g = np.zeros((2, H, W), np.float32)
    g[0, ys[k], xs[k]] = 1.
    g_j, g_t = _grads(fvi, config, sj, st, g)
    rows = np.abs(g_t[0]).reshape(-1, 6).max(-1)
    assert (rows > 0).sum() > 1 and np.all(g_t[1] == 0.)
    _assert_grads_close(g_t, g_j)


def _tiles(name):
    fvz, fvi, H, W, boxlen = dibr_edge_scene(name)
    fvz, fvi = torch.as_tensor(fvz), torch.as_tensor(fvi) * MULT
    valid = torch.ones(fvz.shape[:2], dtype=torch.bool)
    vt, tr, ctr, cbb, _, _ = FT.build_face_tiles(fvz, fvi, valid, H, W,
                                                 MULT, boxlen * MULT)
    return vt.float(), tr, ctr, cbb.float(), H, W


def _pixels(H, W):
    """Pixel centres (hp*wp,) of the padded image, with their rows and
    columns."""
    hp, wp = FT._padded_dims(H, W)
    ax, bx, ay, by = FT._pixel_affine(H, W, MULT)
    row = torch.arange(hp).repeat_interleave(wp)
    col = torch.arange(wp).repeat(hp)
    return ax * col.float() + bx, ay * row.float() + by, row, col


def _contributes(vt, x0, y0, eps=1e-8):
    """(B, nC*FC, P) bool: the face covers the pixel (valid faces) or
    holds it in its enlarged bbox, where p > 0 can be."""
    f = vt.reshape(vt.shape[0], -1, FT._NCOL)[..., None]      # (B, F, 40, 1)

    def aff(c):
        return f[:, :, c] + f[:, :, c + 1] * x0 + f[:, :, c + 2] * y0

    nrm = aff(FT._NRM)
    s = nrm + torch.where(nrm >= 0., eps, -eps)
    cover = ((aff(FT._W0) * s >= 0.) & (aff(FT._W1) * s >= 0.)
             & (aff(FT._W2) * s >= 0.) & (f[:, :, FT._VALID] > 0.))
    box = ((x0 >= f[:, :, FT._BB]) & (x0 < f[:, :, FT._BB + 2])
           & (y0 >= f[:, :, FT._BB + 1]) & (y0 < f[:, :, FT._BB + 3]))
    return cover | box


@pytest.mark.parametrize('name', EDGE_SCENES)
def test_forward_lists_keep_every_contributing_face(name):
    vt, tr, _, cbb, H, W = _tiles(name)
    lists = FT._cull_forward(vt, tr, cbb, H, W, MULT)       # (B, nS, F)
    x0, y0, row, col = _pixels(H, W)
    need = _contributes(vt, x0, y0)                          # (B, F, P)
    nSJ = FT._padded_dims(H, W)[1] // FT._SUB
    s = (row // FT._SUB) * nSJ + col // FT._SUB
    assert torch.all(lists[:, s].transpose(1, 2) | ~need)
    n = lists.sum(-1)
    if name == 'cluster':              # more than two staging batches
        assert n.max() > 300
    if name == 'empty':
        assert n.max() == 0
    else:                              # and the lists do cull
        assert 0 < n.max() < vt.shape[1] * FT.FC


@pytest.mark.parametrize('name', EDGE_SCENES)
def test_backward_units_hold_every_gradient_pair(name):
    vt, _, ctr, cbb, H, W = _tiles(name)
    g = torch.as_tensor(np.random.default_rng(4).random((2, H, W)) < 0.3)
    g[..., W // 2:] = False            # units with g * prod = 0 on the right
    visited, computed, nonzero = FT._cull_backward(ctr, cbb, g.float(), H, W,
                                                   MULT)
    hp, wp = FT._padded_dims(H, W)
    _, nJ, TW = FT._tile_dims(hp, wp)
    sw = FT._unit_width(TW)
    x0, y0, row, col = _pixels(H, W)
    u = (((row // FT.PS) * nJ + col // TW) * (TW // sw)
         + (col % TW) // sw)
    gp = torch.zeros((2, hp, wp), dtype=torch.bool)
    gp[:, :H, :W] = g
    gp = gp.reshape(2, -1)
    f = vt.reshape(2, -1, FT._NCOL)[..., None]
    box = ((x0 >= f[:, :, FT._BB]) & (x0 < f[:, :, FT._BB + 2])
           & (y0 >= f[:, :, FT._BB + 1]) & (y0 < f[:, :, FT._BB + 3]))
    need = box & gp[:, None]                                 # (B, F, P)
    chunk = torch.arange(vt.shape[1]).repeat_interleave(FT.FC)
    assert torch.all(computed[:, chunk][:, :, u] | ~need)
    count = torch.zeros(nonzero.shape, dtype=torch.long).index_add_(
        1, u, gp.long())
    assert torch.equal(nonzero, count > 0)
    if name != 'empty':
        assert 0 < computed.sum() < visited.sum()
