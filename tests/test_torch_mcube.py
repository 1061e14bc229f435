"""Marching cubes of the port against kaolin_tpu.

Same grids on both sides (8^3-16^3: random binary grids, a solid sphere,
a smooth density with its iso level, an empty and a full grid): vertices
within 1e-6 and faces equal, the port counting on the device and the JAX
package padding to powers of two (its outputs' ``[:nv]``, ``[:nf]``); the
vertices' gradient with respect to the grid within 1e-5 * max|g|.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.ops.conversions import _mcube as mc_j
from kaolin_tpu.ops.conversions import voxelgrid as cv_j
from kaolin_tpu_torch.ops.conversions import _mcube as mc_t
from kaolin_tpu_torch.ops.conversions import voxelgrid as cv_t


def _grid(kind, dim):
    rng = np.random.default_rng(dim)
    c = (np.arange(dim) - (dim - 1) / 2.) / dim
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)
    if kind == 'random':
        return (rng.random((dim,) * 3) > 0.5).astype(np.float32)
    if kind == 'sphere':
        return (r < 0.4).astype(np.float32)
    if kind == 'density':
        return np.clip(1. - r / 0.4 + 0.1 * rng.standard_normal(r.shape),
                       0., 1.).astype(np.float32)
    if kind == 'empty':
        return np.zeros((dim,) * 3, np.float32)
    return np.ones((dim,) * 3, np.float32)


def test_tables():
    for name in ('_CORNERS', '_EDGES', '_TRI', '_NTRI', '_VORDER', '_NPART',
                 '_RANK', '_NB_DELTA', '_OWNED_SLOT'):
        np.testing.assert_array_equal(getattr(mc_t, name),
                                      getattr(mc_j, name))


@pytest.mark.parametrize('kind, dim', [('random', 8), ('sphere', 16),
                                       ('density', 12), ('empty', 8),
                                       ('full', 8)])
def test_voxelgrids_to_trianglemeshes(kind, dim):
    g = _grid(kind, dim)[None]
    iso = 0.4 if kind == 'density' else 0.5
    v_j, f_j = cv_j.voxelgrids_to_trianglemeshes(jnp.asarray(g), iso)
    v_t, f_t = cv_t.voxelgrids_to_trianglemeshes(torch.as_tensor(g), iso)
    assert f_t[0].dtype == torch.int32 and v_t[0].dtype == torch.float32
    np.testing.assert_array_equal(f_t[0].numpy(), np.asarray(f_j[0]))
    np.testing.assert_allclose(v_t[0].numpy(), np.asarray(v_j[0]), rtol=0,
                               atol=1e-6)
    assert (f_t[0].shape[0] > 0) == (kind not in ('empty',))


def test_gradient_and_capacity():
    g = np.pad(_grid('density', 10), 1)
    out_j, vjp = jax.vjp(lambda x: mc_j.unbatched_marching_cubes(
        x, 0.4, 1024, 2048)[0], jnp.asarray(g))
    x = torch.tensor(g, requires_grad=True)
    v, f, nv, nf = mc_t.unbatched_marching_cubes(x, 0.4)
    assert v.shape == (nv, 3) and f.shape == (nf, 3) and nv <= 1024
    w = np.zeros((1024, 3), np.float32)
    w[:nv] = np.random.default_rng(0).standard_normal((nv, 3))
    (v * torch.as_tensor(w[:nv])).sum().backward()
    g_j = np.asarray(vjp(jnp.asarray(w))[0])
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())
    # fixed capacities: zero rows past the counts, as the JAX package's
    v2, f2, _, _ = mc_t.unbatched_marching_cubes(x.detach(), 0.4, 1024, 2048)
    np.testing.assert_allclose(v2.numpy(), np.asarray(out_j), atol=1e-6)
    assert not f2[nf:].any() and torch.equal(f2[:nf], f)
