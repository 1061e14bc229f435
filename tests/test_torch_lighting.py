"""SH and SG lighting and the coordinate conversions of the port against
kaolin_tpu, and path C, SG light recovery, at 64^2.

Both packages take the same numpy-seeded inputs.  Forward values within
1e-6 relative (1e-6 of the largest value), gradients within 1e-5 *
max|g_jax|, also on inputs at clip ties (normals at right angles to the
view, zero albedo, a specular term at 0).  Path C: a UV sphere with black
texels, one pinhole camera at 64^2, rasterized (the port's fused engine on
its plain version, the JAX package's 'jnp' engine: face_idx equal), nearest
texture, SG diffuse + GGX specular over 8 lobes, masked MSE, gradients to
the lobes' amplitude, direction angles and sharpness.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import kaolin_tpu as kj
from kaolin_tpu.ops import coords as coords_j
from kaolin_tpu.render.lighting import sg as sg_j
from kaolin_tpu.render.lighting import sh as sh_j
from kaolin_tpu.render.mesh.utils import (
    spherical_harmonic_lighting as legacy_j)
import kaolin_tpu_torch as kt
from kaolin_tpu_torch.ops import coords as coords_t
from kaolin_tpu_torch.render.lighting import sg as sg_t
from kaolin_tpu_torch.render.lighting import sh as sh_t
from kaolin_tpu_torch.render.mesh.utils import (
    spherical_harmonic_lighting as legacy_t)
from kaolin_tpu_torch.utils.testing import uv_sphere

FWD_REL = 1e-6
GRAD_REL = 1e-5
# one shape throughout: the JAX package's op-by-op forward compiles each
# primitive once per shape
N = 24                      # points
S = 6                       # lobes


def _unit(rng, n):
    d = rng.standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(
        np.float32)


def _close(a, b, rel, what=''):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(np.abs(b).max(), 1e-30)
    np.testing.assert_allclose(a, b, rtol=0, atol=rel * scale, err_msg=what)


def _compare(fn_j, fn_t, args, grad_args=None, weights_seed=0):
    """Forward and the gradient of a weighted sum, JAX against the port
    (the JAX forward op by op, its gradient as one jitted program: XLA's
    fusion moves the forward by a few ulp)."""
    t_args = [torch.tensor(a, requires_grad=grad_args is None or i in
                           grad_args) for i, a in enumerate(args)]
    out_t = fn_t(*t_args)
    w = np.random.default_rng(weights_seed).standard_normal(
        tuple(out_t.shape)).astype(np.float32)
    idx = list(range(len(args))) if grad_args is None else list(grad_args)

    @jax.jit
    def fwd_bwd(*a):
        out, vjp = jax.vjp(fn_j, *a)
        return out, vjp(jnp.asarray(w))

    _, g_all = fwd_bwd(*[jnp.asarray(a) for a in args])
    out_j = fn_j(*[jnp.asarray(a) for a in args])
    g_j = [g_all[i] for i in idx]
    _close(out_t.detach().numpy(), out_j, FWD_REL, 'forward')
    (out_t * torch.as_tensor(w)).sum().backward()
    for k, i in enumerate(idx):
        g_t = t_args[i].grad
        g_t = np.zeros(args[i].shape) if g_t is None else g_t.numpy()
        _close(g_t, g_j[k], GRAD_REL, f'grad {i}')


def _lobes(rng, n):
    return (rng.uniform(0.2, 2., (n, 3)).astype(np.float32), _unit(rng, n),
            rng.uniform(2., 30., n).astype(np.float32))


def _points(rng, n, grazing=0.):
    """Normals, views and albedos with clip ties: view 0 at right angles to
    normal 0 (tilted past it by ``grazing``: at exactly 90 degrees the
    specular half vector is 0 / 0 in both packages), so ndl = ndv = 0 and
    the specular term is exactly 0; view 1 along normal 1 (ndl = ndv = ldh
    = 1), albedo 1 and 2 zero (a zero specular term, a black diffuse)."""
    normal = _unit(rng, n)
    view = _unit(rng, n)
    perp = np.cross(normal[0], [0., 0., 1.])
    view[0] = perp / np.linalg.norm(perp) - grazing * normal[0]
    view[0] /= np.linalg.norm(view[0])
    view[1] = normal[1]
    albedo = rng.random((n, 3)).astype(np.float32)
    albedo[1:3] = 0.
    return normal, view, albedo


def test_coords():
    rng = np.random.default_rng(0)
    az = rng.uniform(-3, 3, 50).astype(np.float32)
    el = rng.uniform(-1.5, 1.5, 50).astype(np.float32)
    r = rng.uniform(0.5, 2., 50).astype(np.float32)
    xyz_j = coords_j.spherical2cartesian(jnp.asarray(az), jnp.asarray(el),
                                         jnp.asarray(r))
    xyz_t = coords_t.spherical2cartesian(torch.tensor(az), torch.tensor(el),
                                         torch.tensor(r))
    for a, b in zip(xyz_t, xyz_j):
        _close(a.numpy(), b, FWD_REL)
    back_j = coords_j.cartesian2spherical(*xyz_j)
    back_t = coords_t.cartesian2spherical(*xyz_t)
    for a, b in zip(back_t, back_j):
        _close(a.numpy(), b, 1e-5)
    assert all(torch.equal(x, y) for x, y in zip(
        coords_t.spherical2cartesian(torch.tensor(az), torch.tensor(el)),
        coords_t.spherical2cartesian(torch.tensor(az), torch.tensor(el),
                                     1.)))


def test_sh9():
    rng = np.random.default_rng(1)
    n = _unit(rng, 64)
    lights = rng.standard_normal(9).astype(np.float32)
    albedo = rng.random((64, 3)).astype(np.float32)
    albedo[0] = 0.
    _compare(sh_j.project_onto_sh9, sh_t.project_onto_sh9, [n])
    _compare(sh_j.sh9_irradiance, sh_t.sh9_irradiance, [lights, n])
    _compare(sh_j.sh9_diffuse, sh_t.sh9_diffuse, [n[5], n, albedo])
    np.testing.assert_allclose(
        sh_t.project_onto_sh9([0., 0., 1.]).numpy(),
        np.asarray(sh_j.project_onto_sh9([0., 0., 1.])), rtol=1e-6)


# the legacy DIB-R lighting's band i is _LEGACY_SCALE[i] times band
# _LEGACY_BANDS[i] of project_onto_sh9: (1, x, z, y, xy, yz, z^2, xz,
# x^2 - y^2) with the signs dropped and the last two bands scaled by 1/sqrt(2)
_LEGACY_BANDS = [0, 3, 2, 1, 4, 5, 6, 7, 8]
_LEGACY_SCALE = np.asarray([1., -1., 1., -1., 1., -1., 1., -math.sqrt(0.5),
                            math.sqrt(0.5)], np.float32)


def test_one_sh9_basis():
    """The legacy DIB-R lighting is project_onto_sh9's basis, reordered and
    scaled: in the JAX package and in the port."""
    rng = np.random.default_rng(2)
    n = _unit(rng, 48).reshape(1, 6, 8, 3)
    lights = rng.standard_normal((1, 9)).astype(np.float32)
    via_j = np.asarray(sh_j.project_onto_sh9(jnp.asarray(n)))[
        ..., _LEGACY_BANDS] * _LEGACY_SCALE
    np.testing.assert_allclose(
        np.asarray(legacy_j(jnp.asarray(n), jnp.asarray(lights))),
        (via_j * lights.reshape(1, 1, 1, 9)).sum(-1), rtol=0, atol=1e-6)
    via_t = sh_t.project_onto_sh9(torch.from_numpy(n)).numpy()[
        ..., _LEGACY_BANDS] * _LEGACY_SCALE
    np.testing.assert_allclose(
        legacy_t(torch.from_numpy(n), torch.from_numpy(lights)).numpy(),
        (via_t * lights.reshape(1, 1, 1, 9)).sum(-1), rtol=0, atol=1e-6)
    _compare(legacy_j, legacy_t, [n, lights])


def test_sg_inner_products():
    rng = np.random.default_rng(3)
    lhs, rhs = _lobes(rng, N), _lobes(rng, S)
    _compare(sg_j.unbatched_sg_inner_product,
             sg_t.unbatched_sg_inner_product, [*lhs, *rhs])
    _compare(sg_j.unbatched_reduced_sg_inner_product,
             sg_t.unbatched_reduced_sg_inner_product, [*lhs, *rhs])
    amp, d, s = lhs
    _compare(sg_j.approximate_sg_integral, sg_t.approximate_sg_integral,
             [amp, s])
    for a, b in zip(sg_t.cosine_lobe_sg(torch.tensor(d)),
                    sg_j.cosine_lobe_sg(jnp.asarray(d))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sg_distribution_and_warp():
    rng = np.random.default_rng(4)
    normal, view, _ = _points(rng, N)
    rough = rng.uniform(0.1, 0.9, N).astype(np.float32)
    for k in range(3):
        _compare(lambda n, r: sg_j.sg_distribution_term(n, r)[k],
                 lambda n, r: sg_t.sg_distribution_term(n, r)[k],
                 [normal, rough])
    amp, _, s = _lobes(rng, N)
    for k in range(3):
        _compare(lambda a, d, s_, v: sg_j.sg_warp_distribution(
            a, d, s_, v)[k], lambda a, d, s_, v: sg_t.sg_warp_distribution(
            a, d, s_, v)[k], [amp, normal, s, view])
    ldh = np.concatenate([[0., 1.], rng.random(N - 2)]).astype(np.float32)
    _compare(sg_j.fresnel, sg_t.fresnel,
             [ldh[:, None], rng.random((N, 3)).astype(np.float32)])


def test_sg_specular_at_ties():
    rng = np.random.default_rng(5)
    normal, view, albedo = _points(rng, N, grazing=0.1)
    rough = rng.uniform(0.1, 0.9, N).astype(np.float32)
    lights = _lobes(rng, S)
    _compare(sg_j.sg_warp_specular_term, sg_t.sg_warp_specular_term,
             [*lights, normal, rough, view, albedo])


def test_sg_diffuse():
    rng = np.random.default_rng(6)
    normal, _, albedo = _points(rng, N)
    lights = _lobes(rng, S)
    for fj, ft in ((sg_j.sg_irradiance_fitted, sg_t.sg_irradiance_fitted),
                   (sg_j.sg_irradiance_inner_product,
                    sg_t.sg_irradiance_inner_product)):
        _compare(fj, ft, [*lights, normal])
    for fj, ft in ((sg_j.sg_diffuse_fitted, sg_t.sg_diffuse_fitted),
                   (sg_j.sg_diffuse_inner_product,
                    sg_t.sg_diffuse_inner_product)):
        _compare(fj, ft, [*lights, normal, albedo])


# ---------------------------------------------------------------------------
# path C: SG light recovery at 64^2

H = 64
LOBES = 8
ROUGHNESS = 0.3
SPEC = 0.04
EYE = np.array([[0.4, 0.9, 2.0]], np.float32)


@pytest.fixture(scope='module')
def scene():
    s = uv_sphere(16, 9)
    rng = np.random.default_rng(7)
    tex = rng.random((1, 3, 16, 16), dtype=np.float32)
    tex[:, :, :5] = 0.                        # black texels
    lobes = dict(amp=rng.uniform(0.5, 2., (LOBES, 3)),
                 az=rng.uniform(0., 2. * math.pi, LOBES),
                 el=rng.uniform(-1., 1.2, LOBES),
                 sharp=rng.uniform(5., 30., LOBES))
    return dict(verts=s.vertices[None], faces=s.faces,
                face_uvs=s.uvs[s.face_uvs_idx][None], tex=tex,
                lobes={k: v.astype(np.float32) for k, v in lobes.items()})


def _geometry_j(sc):
    cam = kj.render.camera.Camera.from_args(
        eye=jnp.asarray(EYE), at=jnp.zeros((1, 3)),
        up=jnp.asarray([[0., 1., 0.]]), fov=math.radians(70.), width=H,
        height=H)
    v = jnp.asarray(sc['verts'])
    faces = jnp.asarray(sc['faces'])
    vc = cam.extrinsics.transform(v)
    vi = cam.intrinsics.transform(vc)[..., :2]
    fvc = kj.ops.mesh.index_vertices_by_faces(vc, faces)
    fvi = kj.ops.mesh.index_vertices_by_faces(vi, faces)
    fw = kj.ops.mesh.index_vertices_by_faces(v, faces)
    (uv, nrm, pos), fid = jax.jit(lambda *a: kj.render.mesh.rasterize(
        H, H, *a, backend='jnp'))(fvc[..., -1], fvi, [
            jnp.asarray(sc['face_uvs']), fw, fw])
    return cam, uv, nrm, pos, fid


def _geometry_t(sc):
    cam = kt.render.camera.Camera.from_args(
        eye=torch.as_tensor(EYE), at=torch.zeros((1, 3)),
        up=torch.tensor([[0., 1., 0.]]), fov=math.radians(70.), width=H,
        height=H, device='cpu')
    v = torch.as_tensor(sc['verts'])
    faces = torch.as_tensor(sc['faces'])
    vc = cam.extrinsics.transform(v)
    vi = cam.intrinsics.transform(vc)[..., :2]
    fvc = kt.ops.mesh.index_vertices_by_faces(vc, faces)
    fvi = kt.ops.mesh.index_vertices_by_faces(vi, faces)
    fw = kt.ops.mesh.index_vertices_by_faces(v, faces)
    (uv, nrm, pos), fid = kt.render.mesh.rasterize(
        H, H, fvc[..., -1], fvi, [torch.as_tensor(sc['face_uvs']), fw, fw],
        backend='fused')
    return cam, uv, nrm, pos, fid


def _shade_j(sc, geo, amp, az, el, sharp):
    cam, uv, nrm, pos, fid = geo
    m = np.asarray(fid).reshape(-1) >= 0
    nrm = nrm.reshape(-1, 3)[m]
    nrm = nrm / jnp.maximum(jnp.linalg.norm(nrm, axis=-1, keepdims=True),
                            1e-12)
    view = jnp.asarray(EYE) - pos.reshape(-1, 3)[m]
    view = view / jnp.linalg.norm(view, axis=-1, keepdims=True)
    albedo = kj.render.mesh.texture_mapping(
        uv, jnp.asarray(sc['tex']), mode='nearest').reshape(-1, 3)[m]
    d = jnp.stack(coords_j.spherical2cartesian(az, el), axis=-1)
    n = nrm.shape[0]
    return (sg_j.sg_diffuse_inner_product(amp, d, sharp, nrm, albedo)
            + sg_j.sg_warp_specular_term(amp, d, sharp, nrm,
                                         jnp.full((n,), ROUGHNESS), view,
                                         jnp.full((n, 3), SPEC)))


def _shade_t(sc, geo, amp, az, el, sharp):
    cam, uv, nrm, pos, fid = geo
    m = fid.reshape(-1) >= 0
    nrm = nrm.reshape(-1, 3)[m]
    nrm = nrm / kt._clip.clip(torch.linalg.norm(nrm, dim=-1, keepdim=True),
                              1e-12)
    view = torch.as_tensor(EYE) - pos.reshape(-1, 3)[m]
    view = view / torch.linalg.norm(view, dim=-1, keepdim=True)
    albedo = kt.render.mesh.texture_mapping(
        uv, torch.as_tensor(sc['tex']), mode='nearest').reshape(-1, 3)[m]
    d = torch.stack(coords_t.spherical2cartesian(az, el), dim=-1)
    n = nrm.shape[0]
    return (sg_t.sg_diffuse_inner_product(amp, d, sharp, nrm, albedo)
            + sg_t.sg_warp_specular_term(amp, d, sharp, nrm,
                                         torch.full((n,), ROUGHNESS), view,
                                         torch.full((n, 3), SPEC)))


def test_path_c_sg_light_recovery(scene):
    geo_j = _geometry_j(scene)
    geo_t = _geometry_t(scene)
    fid = np.asarray(geo_j[4])
    np.testing.assert_array_equal(geo_t[4].numpy(), fid)
    assert 0.2 < (fid >= 0).mean() < 0.8
    gt = scene['lobes']
    start = {k: v * np.float32(0.8) + np.float32(0.1)
             for k, v in gt.items()}
    keys = ('amp', 'az', 'el', 'sharp')

    def loss_j(p, q):
        target = _shade_j(scene, geo_j, *q)
        return jnp.mean((_shade_j(scene, geo_j, *p) - target) ** 2), target

    (loss, target_j), grads = jax.jit(jax.value_and_grad(
        loss_j, has_aux=True))([jnp.asarray(start[k]) for k in keys],
                               [jnp.asarray(gt[k]) for k in keys])
    target_t = _shade_t(scene, geo_t, *[torch.as_tensor(gt[k])
                                       for k in keys])
    _close(target_t.numpy(), target_j, FWD_REL * 10, 'target image')
    params = [torch.tensor(start[k], requires_grad=True) for k in keys]
    loss_t = torch.mean((_shade_t(scene, geo_t, *params) - target_t) ** 2)
    loss_t.backward()
    np.testing.assert_allclose(loss_t.item(), float(loss), rtol=1e-5)
    for k, p, g in zip(keys, params, grads):
        assert np.abs(np.asarray(g)).max() > 0, k
        _close(p.grad.numpy(), g, GRAD_REL * 10, k)
    # the loss falls under Adam
    opt = torch.optim.Adam(params, lr=5e-2)
    losses = []
    for _ in range(5):
        opt.zero_grad()
        lt = torch.mean((_shade_t(scene, geo_t, *params) - target_t) ** 2)
        lt.backward()
        opt.step()
        losses.append(lt.item())
    assert losses[-1] < losses[0]
