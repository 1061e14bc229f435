"""The port's tetmesh ops, losses and marching tetrahedra against
kaolin_tpu's, on a tet grid of a cube (``utils/testing.py::tet_grid``)
with a sphere's SDF and numpy-seeded jitter.

Tolerances: ``inverse_vertices_offset`` rtol 1e-4; ``subdivide_tetmesh``
topology equal, vertices and features within 1e-6; ``tetrahedron_volume``,
``equivolume`` and ``amips`` rtol 1e-5 (their gradients within 1e-4 *
max|g_jax|); ``marching_tetrahedra`` faces and tet ids equal, vertices
within 1e-6, the gradient to ``sdf`` and ``vertices`` within 1e-4 *
max|g_jax|.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.metrics import tetmesh as met_j
from kaolin_tpu.ops.conversions import tetmesh as conv_j
from kaolin_tpu.ops.mesh import tetmesh as ops_j
from kaolin_tpu_torch.metrics import tetmesh as met_t
from kaolin_tpu_torch.ops.conversions import tetmesh as conv_t
from kaolin_tpu_torch.ops.mesh import tetmesh as ops_t
from kaolin_tpu_torch.utils.testing import tet_grid


def grid(n=4, B=2, jitter=0.05, seed=0):
    v, tets = tet_grid(n)
    rng = np.random.default_rng(seed)
    verts = (v[None] + jitter / n * rng.standard_normal(
        (B,) + v.shape)).astype(np.float32)
    feats = rng.standard_normal((B, len(v), 2)).astype(np.float32)
    return verts, tets, feats


def _grads_close(a, b):
    a = np.asarray(a)
    scale = np.abs(a).max()
    assert scale > 0
    np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-4 * scale)


def test_inverse_vertices_offset():
    verts, tets, _ = grid()
    tv = verts[:, tets]
    inv_j = ops_j.inverse_vertices_offset(jnp.asarray(tv))
    inv_t = ops_t.inverse_vertices_offset(torch.as_tensor(tv))
    np.testing.assert_allclose(inv_t.numpy(), np.asarray(inv_j), rtol=1e-4,
                               atol=1e-4 * np.abs(np.asarray(inv_j)).max())
    with pytest.raises(ValueError):
        ops_t.inverse_vertices_offset(torch.zeros(1, 2, 3, 3))


@pytest.mark.parametrize('with_features', [False, True])
def test_subdivide_tetmesh(with_features):
    verts, tets, feats = grid(3)
    f = feats if with_features else None
    out_j = ops_j.subdivide_tetmesh(
        jnp.asarray(verts), tets, None if f is None else jnp.asarray(f))
    out_t = ops_t.subdivide_tetmesh(
        torch.as_tensor(verts), torch.as_tensor(tets),
        None if f is None else torch.as_tensor(f))
    assert len(out_t) == len(out_j) == (3 if with_features else 2)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    for k in [0] + ([2] if with_features else []):
        np.testing.assert_allclose(out_t[k].numpy(), np.asarray(out_j[k]),
                                   rtol=0, atol=1e-6)
    assert out_t[1].shape == (8 * len(tets), 4)
    assert out_t[0].device.type == 'cpu'


def _loss_inputs(B):
    """Deformed tets, every seventh inverted (two corners swapped), and a
    rest pose."""
    verts, tets, _ = grid(3, B=B, jitter=0.3, seed=2)
    rest, _, _ = grid(3, B=B, jitter=0.05, seed=3)
    flipped = tets.copy()
    flipped[::7] = flipped[::7][:, [0, 2, 1, 3]]
    return verts[:, flipped], rest[:, tets]


@pytest.mark.parametrize('name', ['tetrahedron_volume', 'equivolume',
                                  'equivolume_mean_pow2', 'amips'])
def test_losses(name):
    # equivolume without a given mean takes one mesh (both packages)
    tv, rest = _loss_inputs(1 if name == 'equivolume' else 2)

    def call(mod, tv_, rest_, inv_fn):
        if name == 'tetrahedron_volume':
            return mod.tetrahedron_volume(tv_)
        if name == 'equivolume':
            return mod.equivolume(tv_)
        if name == 'equivolume_mean_pow2':
            return mod.equivolume(tv_, tetrahedrons_mean=0.01, pow=2)
        return mod.amips(tv_, inv_fn(rest_))

    out_j, vjp = jax.vjp(lambda t: call(met_j, t, jnp.asarray(rest),
                                        ops_j.inverse_vertices_offset),
                         jnp.asarray(tv))
    tv_t = torch.tensor(tv, requires_grad=True)
    out_t = call(met_t, tv_t, torch.as_tensor(rest),
                 ops_t.inverse_vertices_offset)
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=1e-5)
    ct = np.random.default_rng(4).standard_normal(out_t.shape).astype(
        np.float32)
    (g_j,) = vjp(jnp.asarray(ct))
    (g_t,) = torch.autograd.grad(out_t, [tv_t], torch.as_tensor(ct))
    _grads_close(g_j, g_t)
    if name == 'amips':
        vol = met_t.tetrahedron_volume(tv_t.detach())
        assert (vol < 0).any() and (vol > 0).any(), 'both signs'


def sphere_sdf(verts, r=0.55):
    return (np.linalg.norm(verts, axis=-1) - r).astype(np.float32)


@pytest.mark.parametrize('return_tet_idx', [False, True])
def test_marching_tetrahedra(return_tet_idx):
    verts, tets, _ = grid(5)
    sdf = sphere_sdf(verts)
    sdf[1] = -sdf[1]                        # a different surface per batch

    v_t = torch.tensor(verts, requires_grad=True)
    s_t = torch.tensor(sdf, requires_grad=True)
    out_t = conv_t.marching_tetrahedra(v_t, torch.as_tensor(tets), s_t,
                                       return_tet_idx)
    out_j = conv_j.marching_tetrahedra(jnp.asarray(verts), tets,
                                       jnp.asarray(sdf), return_tet_idx)
    assert len(out_t) == len(out_j)
    for b in range(2):
        np.testing.assert_allclose(out_t[0][b].detach().numpy(),
                                   np.asarray(out_j[0][b]), rtol=0,
                                   atol=1e-6)
        for k in range(1, len(out_t)):
            np.testing.assert_array_equal(out_t[k][b].numpy(),
                                          np.asarray(out_j[k][b]))
        assert out_t[1][b].shape[0] > 100
    # the gradient of the extracted vertices to sdf and vertices
    cts = [np.random.default_rng(b).standard_normal(
        out_t[0][b].shape).astype(np.float32) for b in range(2)]

    def loss_j(v, s):
        vs = conv_j.marching_tetrahedra(v, tets, s)[0]
        return sum(jnp.sum(x * c) for x, c in zip(vs, cts))

    g_vj, g_sj = jax.grad(loss_j, argnums=(0, 1))(jnp.asarray(verts),
                                                  jnp.asarray(sdf))
    loss_t = sum((x * torch.as_tensor(c)).sum()
                 for x, c in zip(out_t[0], cts))
    g_vt, g_st = torch.autograd.grad(loss_t, [v_t, s_t])
    _grads_close(g_sj, g_st)
    _grads_close(g_vj, g_vt)


def test_marching_tetrahedra_device():
    verts, tets, _ = grid(2)
    sdf = sphere_sdf(verts)
    out = conv_t.marching_tetrahedra(verts, tets, sdf, device='cpu')
    assert out[0][0].device.type == 'cpu' and out[1][0].shape[0] > 0
    out = conv_t.marching_tetrahedra(torch.as_tensor(verts), tets,
                                     torch.as_tensor(sdf))
    assert out[1][0].device.type == 'cpu'
