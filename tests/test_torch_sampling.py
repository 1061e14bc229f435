"""Areas, sampling and path D, the DMTet chamfer fit, of the port against
kaolin_tpu.

Same numpy-seeded inputs on both sides.  Areas within 1e-6 (and their
gradient within 1e-5 * max|g|); ``_base_sample_points_selected_faces``
within 1e-6 with shared u, v.  ``sample_points`` draws from a
``torch.Generator`` where the JAX package takes a key, so its draws are
held to their law: a chi-square test of the face frequencies against the
areas (p > 1e-4), u and v in [0, 1), points on their faces, the same draws
on a second run with the same seed.  Path D at ``tet_grid(6)``: marching
tetrahedra -> the same sampled faces, u and v through
``_base_sample_points_selected_faces`` -> chamfer to an ellipsoid's points +
0.1 x the mean squared uniform-Laplacian displacement: loss within rtol
1e-5, the SDF gradient within 1e-4 * max|g|; 3 Adam steps lower the loss.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy import stats

from kaolin_tpu.metrics import pointcloud as pc_j
from kaolin_tpu.metrics import trianglemesh as tm_j
from kaolin_tpu.ops.conversions import tetmesh as tc_j
from kaolin_tpu.ops.mesh import trianglemesh as otm_j
from kaolin_tpu_torch.metrics import pointcloud as pc_t
from kaolin_tpu_torch.metrics import trianglemesh as tm_t
from kaolin_tpu_torch.ops.conversions import tetmesh as tc_t
from kaolin_tpu_torch.ops.mesh import trianglemesh as otm_t
from kaolin_tpu_torch.utils.testing import tet_grid, uv_sphere


@pytest.fixture(scope='module')
def mesh():
    s = uv_sphere(10, 6)
    rng = np.random.default_rng(0)
    v = (s.vertices * rng.uniform(0.5, 1.5, (len(s.vertices), 1))).astype(
        np.float32)
    return np.stack([v, v * [1., 2., 0.5]]).astype(np.float32), s.faces


def test_face_areas(mesh):
    verts, faces = mesh
    a_j, vjp = jax.vjp(jax.jit(lambda v: otm_j.face_areas(v, faces)),
                       jnp.asarray(verts))
    x = torch.tensor(verts, requires_grad=True)
    a_t = otm_t.face_areas(x, torch.as_tensor(faces))
    np.testing.assert_allclose(a_t.detach().numpy(), np.asarray(a_j),
                               rtol=0, atol=1e-6)
    w = np.random.default_rng(1).standard_normal(a_t.shape).astype(
        np.float32)
    (a_t * torch.as_tensor(w)).sum().backward()
    g_j = np.asarray(vjp(jnp.asarray(w))[0])
    np.testing.assert_allclose(x.grad.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())
    # packed: the two meshes one after the other
    V, F = verts.shape[1], len(faces)
    packed = verts.reshape(-1, 3)
    first = np.array([0, V, 2 * V])
    pf = np.concatenate([faces, faces])
    np.testing.assert_allclose(
        otm_t.packed_face_areas(torch.as_tensor(packed), first, pf,
                                [F, F]).numpy(),
        np.asarray(otm_j.packed_face_areas(jnp.asarray(packed), first, pf,
                                           [F, F])), rtol=0, atol=1e-6)


def test_sample_selected_faces(mesh):
    verts, faces = mesh
    rng = np.random.default_rng(2)
    fv = verts[0][faces[rng.integers(0, len(faces), 64)]]
    ff = rng.standard_normal((64, 3, 5)).astype(np.float32)
    u = np.sqrt(rng.random((64, 1))).astype(np.float32)
    v = rng.random((64, 1)).astype(np.float32)
    p_j, f_j = otm_j._base_sample_points_selected_faces(
        [jnp.asarray(fv[:, k]) for k in range(3)],
        [jnp.asarray(ff[:, k]) for k in range(3)], u=jnp.asarray(u),
        v=jnp.asarray(v))
    p_t, f_t = otm_t._base_sample_points_selected_faces(
        [torch.as_tensor(fv[:, k]) for k in range(3)],
        [torch.as_tensor(ff[:, k]) for k in range(3)], u=torch.as_tensor(u),
        v=torch.as_tensor(v))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), atol=1e-6)
    np.testing.assert_allclose(f_t.numpy(), np.asarray(f_j), atol=1e-6)


def test_sample_points_law(mesh):
    verts, faces = mesh
    x = torch.as_tensor(verts)
    n = 40_000
    gen = torch.Generator().manual_seed(3)
    feats = torch.as_tensor(verts)[:, torch.as_tensor(faces)]  # corners
    pts, ff, choice = otm_t.sample_points(x, faces, n, face_features=feats,
                                          generator=gen)
    assert pts.shape == (2, n, 3) and choice.shape == (2, n)
    # features interpolate like the points: corner positions as features
    np.testing.assert_allclose(ff.numpy(), pts.numpy(), atol=1e-6)
    areas = otm_t.face_areas(x, faces).numpy().astype(np.float64)
    for b in range(2):
        counts = np.bincount(choice[b].numpy(), minlength=len(faces))
        expected = areas[b] / areas[b].sum() * n
        assert stats.chisquare(counts, expected).pvalue > 1e-4
        # every point on its face: barycentrics in [0, 1]
        tri = verts[b][faces[choice[b].numpy()]].astype(np.float64)
        p = pts[b].numpy().astype(np.float64)
        e1, e2, d = tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], \
            p - tri[:, 0]
        g = np.stack([np.einsum('ij,ij->i', e1, e1),
                      np.einsum('ij,ij->i', e1, e2),
                      np.einsum('ij,ij->i', e2, e2)], -1)
        r = np.stack([np.einsum('ij,ij->i', d, e1),
                      np.einsum('ij,ij->i', d, e2)], -1)
        det = g[:, 0] * g[:, 2] - g[:, 1] ** 2
        s = (g[:, 2] * r[:, 0] - g[:, 1] * r[:, 1]) / det
        t = (g[:, 0] * r[:, 1] - g[:, 1] * r[:, 0]) / det
        assert (s > -1e-4).all() and (t > -1e-4).all() \
            and (s + t < 1 + 1e-4).all()
    again = otm_t.sample_points(x, faces, n,
                                generator=torch.Generator().manual_seed(3))
    assert torch.equal(again[0], pts) and torch.equal(again[1], choice)
    # the module generator, seeded
    from kaolin_tpu_torch.ops import random as rnd
    rnd.manual_seed(5)
    a = otm_t.sample_points(x, faces, 100)
    rnd.manual_seed(5)
    assert torch.equal(otm_t.sample_points(x, faces, 100)[0], a[0])


def test_packed_sample_points(mesh):
    verts, faces = mesh
    V, F = verts.shape[1], len(faces)
    packed = torch.as_tensor(verts.reshape(-1, 3))
    pts, choice = otm_t.packed_sample_points(
        packed, [0, V, 2 * V], torch.as_tensor(np.concatenate([faces,
                                                               faces])),
        [F, F], 500, generator=torch.Generator().manual_seed(4))
    assert pts.shape == (2, 500, 3) and int(choice.max()) < F
    for b in range(2):
        tri = verts[b][faces[choice[b].numpy()]]
        assert (pts[b].numpy() >= tri.min(1) - 1e-6).all()
        assert (pts[b].numpy() <= tri.max(1) + 1e-6).all()


# ---------------------------------------------------------------------------
# path D: DMTet chamfer fit at tet_grid(6)

SAMPLES = 400
TARGET = 600
LAP_W = 0.1


@pytest.fixture(scope='module')
def dmtet():
    v, tets = tet_grid(6, -0.5, 0.5)
    sdf = (np.linalg.norm(v, axis=-1) - 0.25).astype(np.float32)[None]
    e = uv_sphere(16, 9)
    ell = (e.vertices * [0.35, 0.25, 0.30]).astype(np.float32)[None]
    target, _ = otm_t.sample_points(torch.as_tensor(ell), e.faces, TARGET,
                                    generator=torch.Generator().manual_seed(6))
    return v[None], tets, sdf, target.numpy()


def _draws(num_faces, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, num_faces, SAMPLES),
            np.sqrt(rng.random((1, SAMPLES, 1))).astype(np.float32),
            rng.random((1, SAMPLES, 1)).astype(np.float32))


def _loss_t(v, tets, sdf, target, draws):
    verts, faces = tc_t.marching_tetrahedra(v, tets, sdf)
    vs, fs = verts[0][None], faces[0]
    choice, u, w = draws
    fv = vs[:, fs[torch.as_tensor(choice)]]
    pts, _ = otm_t._base_sample_points_selected_faces(
        (fv[:, :, 0], fv[:, :, 1], fv[:, :, 2]), u=torch.as_tensor(u),
        v=torch.as_tensor(w))
    lap = tm_t.uniform_laplacian_smoothing(vs, fs) - vs
    return (pc_t.chamfer_distance(pts, torch.as_tensor(target))[0]
            + LAP_W * (lap ** 2).sum(-1).mean())


def _loss_and_grad_j(v, tets, sdf, target, draws):
    """The JAX chain's loss and SDF gradient: marching tetrahedra op by op
    (its topology is host numpy), the rest as one jitted program."""
    faces = np.asarray(tc_j.marching_tetrahedra(v, tets, sdf)[1][0])
    verts, vjp = jax.vjp(lambda s: tc_j.marching_tetrahedra(
        v, tets, s)[0][0], sdf)
    choice, u, w = draws

    def rest(vs):
        vs = vs[None]
        fv = vs[:, faces[choice]]
        pts, _ = otm_j._base_sample_points_selected_faces(
            (fv[:, :, 0], fv[:, :, 1], fv[:, :, 2]), u=jnp.asarray(u),
            v=jnp.asarray(w))
        lap = tm_j.uniform_laplacian_smoothing(vs, faces) - vs
        return (pc_j.chamfer_distance(pts, jnp.asarray(target))[0]
                + LAP_W * (lap ** 2).sum(-1).mean())

    loss, g_v = jax.jit(jax.value_and_grad(rest))(verts)
    return loss, vjp(g_v)[0]


def test_path_d_dmtet_chamfer(dmtet):
    v, tets, sdf, target = dmtet
    num_faces = tc_t.marching_tetrahedra(v, tets, sdf, device='cpu')[1][0] \
        .shape[0]
    assert num_faces > 50
    draws = _draws(num_faces, 7)
    loss_j, g_j = _loss_and_grad_j(jnp.asarray(v), tets, jnp.asarray(sdf),
                                   target, draws)
    s_t = torch.tensor(sdf, requires_grad=True)
    loss_t = _loss_t(torch.as_tensor(v), tets, s_t, target, draws)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    g_j = np.asarray(g_j)
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(s_t.grad.numpy(), g_j, rtol=0,
                               atol=1e-4 * np.abs(g_j).max())
    # the fit with sample_points on the extracted surface: the loss falls
    opt = torch.optim.Adam([s_t], lr=1e-2)
    gen = torch.Generator().manual_seed(8)
    losses = []
    for _ in range(3):
        verts, faces = tc_t.marching_tetrahedra(torch.as_tensor(v), tets,
                                                s_t)
        pts, _ = otm_t.sample_points(verts[0][None], faces[0], SAMPLES,
                                     generator=gen)
        lap = tm_t.uniform_laplacian_smoothing(verts[0][None], faces[0]) \
            - verts[0][None]
        loss = (pc_t.chamfer_distance(pts, torch.as_tensor(target))[0]
                + LAP_W * (lap ** 2).sum(-1).mean())
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0]
