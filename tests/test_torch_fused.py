"""Parity of the port's fused DIB-R engine with kaolin_tpu's.

The JAX side runs as ``tests/test_fused_rasterizer.py`` runs it on the CPU:
``fused_selection(..., interpret=True)`` and ``jax.grad`` through
``softmask_fused``.  The port's side runs the plain PyTorch versions of the
two kernels (CPU tensors).  ``test_torch_kernels.py`` holds the CUDA
kernels against those plain versions on a card.

Tolerances:
- ``build_face_tiles``: perm, inv_perm and the ranges equal; vt and the
  chunk bboxes within 1e-5 * multiplier.
- face_idx exactly equal.
- prod and the soft mask within 2e-5.  The interpreted Pallas kernel is
  compiled by XLA's CPU backend, which contracts a*b+c into fma; PyTorch's
  eager ops round each product.  With |C| ~ multiplier**2 the edge value
  ``A*x0 + B*y0 + C`` then differs by ~ulp(1e6) and p by up to ~1e-5
  (measured 5e-6..7.4e-6; both are ~1.8e-5 from a float64 evaluation).
- vertex gradients: |diff| <= 1e-4 * max(max|g_jax|, 1)
  (``test_fused_rasterizer.py:94-95``).
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.render.mesh import _fused as FJ
from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch.render.mesh import _fused as FT
from kaolin_tpu_torch.utils.testing import random_triangles

SIZES = [(64, 64), (35, 31), (40, 200)]
MULT = 1000.


def random_scene(seed, F=57, B=2, spread=0.3):
    return random_triangles(seed, F, B, spread)


def _select_both(fvz, fvi, valid, H, W, **kw):
    sj = FJ.fused_selection(jnp.asarray(fvz), jnp.asarray(fvi),
                            jnp.asarray(valid), height=H, width=W,
                            interpret=True, **kw)
    st = FT.fused_selection(torch.as_tensor(fvz), torch.as_tensor(fvi),
                            torch.as_tensor(valid), height=H, width=W, **kw)
    return sj, st


@pytest.mark.parametrize('hw', SIZES)
@pytest.mark.parametrize('F', [57, 200])
def test_build_face_tiles_matches_jax(hw, F):
    H, W = hw
    fvz, fvi = random_scene(F, F=F)
    valid = np.random.default_rng(1).random(fvz.shape[:2]) > 0.2
    fvs = fvi * MULT
    margin = 0.02 * MULT
    ref = jax.vmap(lambda z, i, v: FJ.build_face_tiles(
        z, i, v, H, W, MULT, margin))(
            jnp.asarray(fvz), jnp.asarray(fvs), jnp.asarray(valid))
    out = FT.build_face_tiles(torch.as_tensor(fvz), torch.as_tensor(fvs),
                              torch.as_tensor(valid), H, W, MULT, margin)
    vt_j, tr_j, ctr_j, cbb_j, perm_j, inv_j = (np.asarray(a) for a in ref)
    vt_t, tr_t, ctr_t, cbb_t, perm_t, inv_t = (a.numpy() for a in out)
    np.testing.assert_array_equal(perm_t, perm_j)
    np.testing.assert_array_equal(inv_t, inv_j)
    np.testing.assert_array_equal(tr_t, tr_j)
    np.testing.assert_array_equal(ctr_t, ctr_j)
    np.testing.assert_allclose(vt_t, vt_j, rtol=0, atol=1e-5 * MULT)
    np.testing.assert_allclose(cbb_t, cbb_j, rtol=0, atol=1e-5 * MULT)


@pytest.mark.parametrize('hw', SIZES)
def test_fused_selection_matches_jax(hw):
    H, W = hw
    fvz, fvi = random_scene(0)
    valid = np.ones(fvz.shape[:2], dtype=bool)
    sj, st = _select_both(fvz, fvi, valid, H, W)
    np.testing.assert_array_equal(st.face_idx.numpy(),
                                  np.asarray(sj.face_idx))
    assert st.face_idx.dtype == torch.int32
    np.testing.assert_allclose(st.prod.numpy(), np.asarray(sj.prod),
                               rtol=0, atol=2e-5)
    np.testing.assert_array_equal(st.inv_perm.numpy(),
                                  np.asarray(sj.inv_perm))


def test_fused_selection_valid_faces():
    H = W = 32
    fvz, fvi = random_scene(3, F=8, B=1, spread=1.0)
    valid = np.array([[True, False] * 4])
    sj, st = _select_both(fvz, fvi, valid, H, W)
    np.testing.assert_array_equal(st.face_idx.numpy(),
                                  np.asarray(sj.face_idx))
    assert not np.isin(st.face_idx.numpy(), [1, 3, 5, 7]).any()
    assert (st.face_idx.numpy() >= 0).any()


def test_fused_selection_without_softmask():
    H, W = 35, 31
    fvz, fvi = random_scene(4)
    valid = np.ones(fvz.shape[:2], dtype=bool)
    sj, st = _select_both(fvz, fvi, valid, H, W, with_softmask=False)
    np.testing.assert_array_equal(st.face_idx.numpy(),
                                  np.asarray(sj.face_idx))
    assert torch.all(st.prod == 1.)


@pytest.mark.parametrize('hw', SIZES)
def test_softmask_fused_matches_jax(hw):
    H, W = hw
    fvz, fvi = random_scene(1)
    valid = np.ones(fvz.shape[:2], dtype=bool)
    sj, st = _select_both(fvz, fvi, valid, H, W)
    config = (H, W, MULT, 7000.)

    def loss_j(fvi_):
        return jnp.sum(FJ.softmask_fused(fvi_ * MULT, sj, config) ** 2)

    mask_j = FJ.softmask_fused(jnp.asarray(fvi) * MULT, sj, config)
    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(fvi)))

    x = torch.tensor(fvi, requires_grad=True)
    mask_t = FT.softmask_fused(x * MULT, st, config)
    (mask_t ** 2).sum().backward()
    np.testing.assert_allclose(mask_t.detach().numpy(), np.asarray(mask_j),
                               rtol=0, atol=2e-5)
    scale = max(np.abs(g_j).max(), 1.)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(x.grad.numpy() / scale, g_j / scale,
                               rtol=0, atol=1e-4)


def test_softmask_fused_grad_random_cotangent():
    """Random signed cotangent: exercises every component of the rows."""
    H, W = 40, 40
    fvz, fvi = random_scene(2, F=23)
    valid = np.ones(fvz.shape[:2], dtype=bool)
    sj, st = _select_both(fvz, fvi, valid, H, W)
    config = (H, W, MULT, 7000.)
    g = np.random.default_rng(5).standard_normal((2, H, W)).astype(
        np.float32)
    g_j = np.asarray(jax.grad(lambda x: jnp.sum(
        FJ.softmask_fused(x * MULT, sj, config) * g))(jnp.asarray(fvi)))
    x = torch.tensor(fvi, requires_grad=True)
    (FT.softmask_fused(x * MULT, st, config) * torch.as_tensor(g)).sum() \
        .backward()
    scale = max(np.abs(g_j).max(), 1.)
    np.testing.assert_allclose(x.grad.numpy() / scale, g_j / scale,
                               rtol=0, atol=1e-4)


def test_tile_image_roundtrip():
    img = torch.arange(2 * 35 * 200, dtype=torch.float32).reshape(2, 35, 200)
    tiled = FT._tile_image(img, 35, 200)
    hp, wp = FT._padded_dims(35, 200)
    assert tiled.shape == (2, (hp // 8) * (wp // 128), 8 * 128)
    assert torch.equal(FT._untile(tiled, 35, 200), img)
    np.testing.assert_array_equal(
        tiled.numpy(),
        np.asarray(FJ._tile_image(jnp.asarray(img.numpy()), 35, 200))[:, :, 0])


def test_wrappers_refuse_other_devices():
    fvz, fvi = random_scene(0, B=1)
    st = FT.fused_selection(torch.as_tensor(fvz), torch.as_tensor(fvi),
                            height=16, width=16)
    T = FT._tile_dims(*FT._padded_dims(16, 16))
    ranges = torch.zeros((1, T[0] * T[1], 2), dtype=torch.int32)
    with pytest.raises(ValueError, match='meta'):
        FT._fused_forward(st.vt.to('meta'), ranges.to('meta'),
                          st.chunk_bbox.to('meta'), 16, 16, MULT, 1e-8,
                          7000., True)
    with pytest.raises(ValueError, match='meta'):
        FT._fused_backward(st.vt.to('meta'), st.chunk_tranges.to('meta'),
                           st.chunk_bbox.to('meta'),
                           torch.zeros((1, 16, 16), device='meta'), 16, 16,
                           MULT, 7000.)


def test_loader_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv('PATH', str(tmp_path))
    monkeypatch.setenv('CUDA_HOME', str(tmp_path))
    monkeypatch.delenv('CUDA_PATH', raising=False)
    monkeypatch.setattr(_cuda, 'BUILD_DIR', tmp_path / 'build')
    monkeypatch.setattr(_cuda, '_LIBS', {})
    with pytest.raises(RuntimeError, match='nvcc not found'):
        _cuda.load('dibr_fused')
    assert not (tmp_path / 'build').exists()


def test_cpu_path_launches_no_kernel():
    before = dict(FT.LAUNCHES)
    fvz, fvi = random_scene(0, B=1)
    x = torch.tensor(fvi, requires_grad=True)
    st = FT.fused_selection(torch.as_tensor(fvz), x, height=16, width=16)
    FT.softmask_fused(x * MULT, st, (16, 16, MULT, 7000.)).sum().backward()
    assert FT.LAUNCHES == before


def test_port_imports_no_jax():
    code = ('import sys, kaolin_tpu_torch, kaolin_tpu_torch.models; '
            'from kaolin_tpu_torch.render.mesh import _fused; '
            'from kaolin_tpu_torch.render.spc import _trace, raster; '
            'from kaolin_tpu_torch.ops.spc import device; '
            'from kaolin_tpu_torch.ops import conversions; '
            'from kaolin_tpu_torch import _cuda, rep; '
            'from kaolin_tpu_torch.utils import measure, testing; '
            'from kaolin_tpu_torch.probes import _kernels, kbisect, '
            'mosaic3, stages; '
            'from kaolin_tpu_torch import io; '
            'from kaolin_tpu_torch.io import obj, materials, utils; '
            'from kaolin_tpu_torch.rep import surface_mesh; '
            'from kaolin_tpu_torch.render.mesh import deftet; '
            'from kaolin_tpu_torch.ops.mesh import tetmesh; '
            'from kaolin_tpu_torch.metrics import tetmesh; '
            'from kaolin_tpu_torch.ops.conversions import tetmesh; '
            'from kaolin_tpu_torch import _clip; '
            'from kaolin_tpu_torch.render import lighting; '
            'from kaolin_tpu_torch.render.lighting import sg, sh; '
            'from kaolin_tpu_torch.ops import batch, coords, gcn, '
            'pointcloud, random, reduction, voxelgrid; '
            'from kaolin_tpu_torch.ops.mesh import check_sign, mesh, '
            'trianglemesh; '
            'from kaolin_tpu_torch.ops.conversions import _mcube, voxelgrid; '
            'from kaolin_tpu_torch.metrics import pointcloud, trianglemesh, '
            'voxelgrid; '
            'from kaolin_tpu_torch import _native, visualize; '
            'from kaolin_tpu_torch.io import off, usd; '
            'from kaolin_tpu_torch.io.usd import materials, mesh, pointcloud, '
            'usda, utils, voxelgrid; '
            'from kaolin_tpu_torch.ops.conversions import sdf; '
            'from kaolin_tpu_torch.visualize import timelapse; '
            'from kaolin_tpu_torch.utils import checkpoint, profiler; '
            'from kaolin_tpu_torch.io import dataset, modelnet, render, '
            'shapenet, shrec; '
            'from kaolin_tpu_torch.visualize import ipython; '
            'from kaolin_tpu_torch import experimental; '
            'from kaolin_tpu_torch.experimental import dash3d; '
            'from kaolin_tpu_torch.experimental.dash3d import run, util; '
            'from kaolin_tpu_torch.examples import camera_tour, '
            'dibr_inverse_rendering, dmtet_demo, sg_lighting_demo, '
            'spc_raytrace_demo; '
            'bad = [m for m in sys.modules '
            "if m == 'jax' or m.startswith(('jax.', 'kaolin_tpu.'))]; "
            'print(bad); sys.exit(1 if bad else 0)')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
