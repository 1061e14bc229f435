"""Triangle-mesh metrics and mesh ops of the port against kaolin_tpu.

Same numpy-seeded inputs on both sides.  ``point_to_mesh_distance``:
distances within 1e-6, face index and ``dist_type`` equal except where two
faces lie within 1e-6 of the same distance; the gradient within 1e-5 *
max|g|.  ``average_edge_length`` and ``uniform_laplacian_smoothing`` (the
port's from the edge list, the JAX package's through the dense Laplacian)
within 1e-6, gradients within 1e-5 * max|g|.  ``adjacency_matrix`` and
``uniform_laplacian`` equal.  Loop subdivision with and without ``alpha``:
vertices within 1e-6, faces equal.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.metrics import trianglemesh as tm_j
from kaolin_tpu.ops.mesh import mesh as mesh_j
from kaolin_tpu.ops.mesh import trianglemesh as otm_j
from kaolin_tpu_torch.metrics import trianglemesh as tm_t
from kaolin_tpu_torch.ops.mesh import mesh as mesh_t
from kaolin_tpu_torch.ops.mesh import trianglemesh as otm_t
from kaolin_tpu_torch.utils.testing import uv_sphere


@pytest.fixture(scope='module')
def mesh():
    s = uv_sphere(12, 7)
    rng = np.random.default_rng(0)
    v = (s.vertices * 0.5 + 0.03 * rng.standard_normal(
        s.vertices.shape)).astype(np.float32)
    return np.stack([v, v * 1.2]), s.faces


def test_point_to_mesh_distance(mesh):
    verts, faces = mesh
    rng = np.random.default_rng(1)
    pts = (rng.standard_normal((2, 150, 3)) * 0.6).astype(np.float32)
    # half of them near the surface, the first five on a vertex
    pts[:, :70] = verts[:, :70] * rng.uniform(0.9, 1.1, (2, 70, 1))
    pts[:, :5] = verts[:, faces[:5, 0]]
    fv = verts[:, faces]
    w = (rng.standard_normal(pts.shape[:2])).astype(np.float32)

    @jax.jit
    def fwd_bwd(a, b, w):
        out, vjp = jax.vjp(tm_j.point_to_mesh_distance, a, b)
        return out, vjp((w, np.zeros(out[1].shape, jax.dtypes.float0),
                         np.zeros(out[2].shape, jax.dtypes.float0)))

    p = torch.tensor(pts, requires_grad=True)
    f = torch.tensor(fv, requires_grad=True)
    (d_j, i_j, t_j), _ = fwd_bwd(jnp.asarray(pts), jnp.asarray(fv),
                                 jnp.zeros(pts.shape[:2]))
    d_t, i_t, t_t = tm_t.point_to_mesh_distance(p, f, chunk_size=37)
    np.testing.assert_allclose(d_t.detach().numpy(), np.asarray(d_j),
                               rtol=0, atol=1e-6)
    # every (point, face) distance: a point is a tie
    # where its two nearest faces lie within 1e-6 of each other
    c_all, _ = tm_t._closest_point_on_tri(
        torch.as_tensor(pts)[:, :, None], *[torch.as_tensor(fv[:, None, :, k])
                                            for k in range(3)])
    d_all = np.sort(((c_all.numpy() - pts[:, :, None]) ** 2).sum(-1))
    tie = d_all[..., 1] - d_all[..., 0] <= 1e-6
    i_j, t_j = np.asarray(i_j), np.asarray(t_j)
    np.testing.assert_array_equal(i_t.numpy()[~tie], i_j[~tie])
    np.testing.assert_array_equal(t_t.numpy()[~tie], t_j[~tie])
    assert (~tie).mean() > 0.3 and set(np.unique(t_j)) > {0, 4}
    # the gradient goes to the chosen face: weigh the points off ties
    w = w * ~tie
    g_j = fwd_bwd(jnp.asarray(pts), jnp.asarray(fv), jnp.asarray(w))[1]
    (d_t * torch.as_tensor(w)).sum().backward()
    for g, gj in zip((p.grad, f.grad), g_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(g.numpy(), gj, rtol=0,
                                   atol=1e-5 * np.abs(gj).max())


def test_closest_point_types():
    """Every distance type on one triangle, against the JAX package."""
    tri = np.array([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.]], np.float32)
    pts = np.array([[.2, .2, 1.], [-1., -1., 0.], [2., -.5, .3],
                    [-.5, 2., 0.], [.5, -1., 0.], [1., 1., .5],
                    [-1., .5, -2.]], np.float32)
    c_j, t_j = tm_j._closest_point_on_tri(jnp.asarray(pts), *[
        jnp.asarray(tri[k]) for k in range(3)])
    c_t, t_t = tm_t._closest_point_on_tri(torch.tensor(pts), *[
        torch.tensor(tri[k]) for k in range(3)])
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=1e-6)
    np.testing.assert_array_equal(t_t.numpy(), np.asarray(t_j))
    assert sorted(t_t.tolist()) == [0, 1, 2, 3, 4, 5, 6]


def _grad_pair(fn_j, fn_t, x, faces):
    w = np.random.default_rng(2).standard_normal(
        np.shape(fn_j(jnp.asarray(x), faces))).astype(np.float32)
    out_j, vjp = jax.vjp(lambda a: fn_j(a, faces), jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out_t = fn_t(xt, torch.as_tensor(faces))
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=0, atol=1e-6)
    (out_t * torch.as_tensor(w)).sum().backward()
    g_j = np.asarray(vjp(jnp.asarray(w))[0])
    np.testing.assert_allclose(xt.grad.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())


def test_edge_length_and_smoothing(mesh):
    verts, faces = mesh
    _grad_pair(tm_j.average_edge_length, tm_t.average_edge_length, verts,
               faces)
    # an isolated vertex keeps L V = 0
    padded = np.concatenate([verts, np.ones((2, 1, 3), np.float32)], 1)
    _grad_pair(tm_j.uniform_laplacian_smoothing,
               tm_t.uniform_laplacian_smoothing, padded, faces)


def test_adjacency_and_laplacian(mesh):
    _, faces = mesh
    V = int(faces.max()) + 2                         # one isolated vertex
    a_j = mesh_j.adjacency_matrix(V, faces)
    a_t = mesh_t.adjacency_matrix(V, torch.as_tensor(faces))
    assert a_t.is_coalesced()
    np.testing.assert_array_equal(a_t.indices().t().numpy(),
                                  np.asarray(a_j.indices))
    np.testing.assert_array_equal(a_t.values().numpy(),
                                  np.asarray(a_j.data))
    dense_t = mesh_t.adjacency_matrix(V, faces, sparse=False, device='cpu')
    np.testing.assert_array_equal(
        dense_t.numpy(), np.asarray(mesh_j.adjacency_matrix(V, faces,
                                                            sparse=False)))
    np.testing.assert_array_equal(a_t.to_dense().numpy(), dense_t.numpy())
    np.testing.assert_array_equal(
        mesh_t.uniform_laplacian(V, faces, device='cpu').numpy(),
        np.asarray(mesh_j.uniform_laplacian(V, faces)))
    np.testing.assert_array_equal(
        mesh_t._unique_edges(torch.as_tensor(faces)).numpy(),
        mesh_j._unique_edges(faces))


@pytest.mark.parametrize('with_alpha', [False, True])
def test_subdivide_trianglemesh(mesh, with_alpha):
    verts, faces = mesh
    if not with_alpha:
        # without alpha the JAX package takes one mesh: its default alpha
        # has a batch of 1 (ROADMAP.md section 3)
        verts = verts[:1]
    # the sphere once; an open mesh (boundary edges, no isolated vertex)
    # twice, with alpha (carried to the second round)
    f = np.delete(faces, np.arange(40, 52), 0) if with_alpha else faces
    iterations = 2 if with_alpha else 1
    alpha = None
    if with_alpha:
        alpha = np.random.default_rng(3).uniform(
            0.1, 0.9, verts.shape[:2]).astype(np.float32)
    v_j, f_j = otm_j.subdivide_trianglemesh(
        jnp.asarray(verts), f, iterations,
        alpha=None if alpha is None else jnp.asarray(alpha))
    xt = torch.tensor(verts, requires_grad=True)
    v_t, f_t = otm_t.subdivide_trianglemesh(
        xt, torch.as_tensor(f), iterations,
        alpha=None if alpha is None else torch.as_tensor(alpha))
    np.testing.assert_array_equal(f_t.numpy(), np.asarray(f_j))
    np.testing.assert_allclose(v_t.detach().numpy(), np.asarray(v_j),
                               rtol=0, atol=1e-6)
    v_t.sum().backward()
    assert torch.isfinite(xt.grad).all() and xt.grad.abs().max() > 0


def test_subdivide_batched(mesh):
    """Two meshes with the default alpha: each as when subdivided alone."""
    verts, faces = mesh
    both, f2 = otm_t.subdivide_trianglemesh(torch.as_tensor(verts), faces, 1)
    for b in range(2):
        one, f1 = otm_t.subdivide_trianglemesh(
            torch.as_tensor(verts[b:b + 1]), faces, 1)
        assert torch.equal(f1, f2)
        np.testing.assert_allclose(both[b].numpy(), one[0].numpy(),
                                   atol=1e-6)
