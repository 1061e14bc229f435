"""Pointcloud and voxelgrid metrics of the port against kaolin_tpu.

Same numpy-seeded inputs on both sides.  ``sided_distance`` and
``chamfer_distance``: distances within 1e-6, indices equal except where the
two nearest candidates lie within 1e-7 of each other; the distance's
gradient within 1e-5 * max|g|; the chunk size changes no result.
``f_score``, ``center_points`` (values, gradient) and ``iou`` within 1e-6.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.metrics import pointcloud as pc_j
from kaolin_tpu.metrics import voxelgrid as vg_j
from kaolin_tpu.ops import pointcloud as opc_j
from kaolin_tpu_torch.metrics import pointcloud as pc_t
from kaolin_tpu_torch.metrics import voxelgrid as vg_t
from kaolin_tpu_torch.ops import pointcloud as opc_t


def _clouds(seed, B=2, P1=300, P2=200):
    rng = np.random.default_rng(seed)
    p1 = rng.standard_normal((B, P1, 3)).astype(np.float32)
    p2 = rng.standard_normal((B, P2, 3)).astype(np.float32)
    p2[:, :10] = p1[:, :10]          # exact matches: distance 0
    return p1, p2


def _ties_ok(p1, p2, idx_a, idx_b):
    """Indices equal, or the two candidates equally near (within 1e-7)."""
    for b in range(p1.shape[0]):
        diff = np.nonzero(idx_a[b] != idx_b[b])[0]
        da = ((p1[b, diff] - p2[b, idx_a[b, diff]]) ** 2).sum(-1)
        db = ((p1[b, diff] - p2[b, idx_b[b, diff]]) ** 2).sum(-1)
        assert np.all(np.abs(da - db) <= 1e-7), (b, diff)


@pytest.fixture(scope='module')
def sided_ref():
    """The JAX package's distances, indices and the gradient of their
    weighted sum, once for every chunk size."""
    p1, p2 = _clouds(0)
    w = np.random.default_rng(1).standard_normal(p1.shape[:2]).astype(
        np.float32)
    (d_j, i_j), vjp = jax.vjp(pc_j.sided_distance, jnp.asarray(p1),
                              jnp.asarray(p2))
    g_j = vjp((jnp.asarray(w), np.zeros(i_j.shape, jax.dtypes.float0)))
    return p1, p2, w, d_j, i_j, g_j


@pytest.mark.parametrize('chunk', [None, 7, 4096])
def test_sided_distance(sided_ref, chunk):
    p1, p2, w, d_j, i_j, g_j = sided_ref
    t1 = torch.tensor(p1, requires_grad=True)
    t2 = torch.tensor(p2, requires_grad=True)
    d_t, i_t = pc_t.sided_distance(t1, t2, chunk_size=chunk)
    np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j),
                               rtol=0, atol=1e-6)
    _ties_ok(p1, p2, i_t.numpy(), np.asarray(i_j))
    assert (d_t.detach()[:, :10] == 0).all()
    (d_t * torch.as_tensor(w)).sum().backward()
    for g, gj in zip((t1.grad, t2.grad), g_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                                   atol=1e-5 * np.abs(gj).max())


def test_chamfer_and_f_score():
    p1, p2 = _clouds(2)
    c_j = pc_j.chamfer_distance(jnp.asarray(p1), jnp.asarray(p2), w1=0.5,
                                w2=2., squared=False)
    c_t = pc_t.chamfer_distance(torch.tensor(p1), torch.tensor(p2), w1=0.5,
                                w2=2., squared=False, chunk_size=64)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), rtol=1e-6)
    f_j = pc_j.f_score(jnp.asarray(p1), jnp.asarray(p2), radius=0.3)
    f_t = pc_t.f_score(torch.tensor(p1), torch.tensor(p2), radius=0.3)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), rtol=1e-6)
    assert 0 < f_t.min() and f_t.max() < 1
    # the docstring example of the JAX package
    assert pc_t.chamfer_distance(torch.tensor([[[0., 0., 0.], [1., 0., 0.]]]),
                                 torch.tensor([[[0., 0., 1.]]])).tolist() \
        == [2.5]


def test_center_points():
    rng = np.random.default_rng(3)
    p = (rng.standard_normal((2, 50, 3)) * [1., 2., 3.] + 4.).astype(
        np.float32)
    for normalize in (False, True):
        out_j, vjp = jax.vjp(lambda x: opc_j.center_points(x, normalize),
                             jnp.asarray(p))
        x = torch.tensor(p, requires_grad=True)
        out_t = opc_t.center_points(x, normalize)
        np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                                   rtol=0, atol=1e-6)
        w = np.random.default_rng(4).standard_normal(p.shape).astype(
            np.float32)
        (out_t * torch.as_tensor(w)).sum().backward()
        g_j = np.asarray(vjp(jnp.asarray(w))[0])
        np.testing.assert_allclose(x.grad.numpy(), g_j, rtol=0,
                                   atol=1e-5 * np.abs(g_j).max())
    with pytest.raises(ValueError):
        opc_t.center_points(torch.zeros(5, 3))


def test_iou():
    rng = np.random.default_rng(5)
    pred = rng.random((3, 6, 7, 8)) > 0.5
    gt = rng.random((3, 6, 7, 8)) > 0.4
    for a, b in ((pred, gt), (pred.astype(np.float32), gt.astype(np.int32))):
        np.testing.assert_allclose(
            vg_t.iou(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
            np.asarray(vg_j.iou(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    with pytest.raises(ValueError):
        vg_t.iou(torch.zeros(1, 2, 2, 2), torch.zeros(1, 2, 2, 3))
