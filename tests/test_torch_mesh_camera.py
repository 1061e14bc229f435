"""Parity of the port's mesh ops and legacy camera with kaolin_tpu.

Same numpy-seeded inputs through both packages; values within 1e-5
(atol + rtol for the camera's large coordinates), gradients (JAX ``vjp``
and torch autograd with the same cotangent) within
1e-4 * max|g_jax|.
"""
import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.ops import mesh as mesh_j
from kaolin_tpu.render.camera import legacy as cam_j
from kaolin_tpu_torch.ops import mesh as mesh_t
from kaolin_tpu_torch.render.camera import legacy as cam_t

RNG = np.random.default_rng(0)


def _f32(*shape, scale=1.):
    return (RNG.standard_normal(shape) * scale).astype(np.float32)


def _check_vjp(fn_j, fn_t, args, atol=1e-5, rtol=1e-5):
    """Values and gradients (w.r.t. every arg) of fn_j (jax) and fn_t
    (torch) on the same numpy args."""
    out_j, vjp = jax.vjp(fn_j, *[jnp.asarray(a) for a in args])
    ts = [torch.tensor(a, requires_grad=True) for a in args]
    out_t = fn_t(*ts)
    np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                               rtol=rtol, atol=atol)
    ct = _f32(*out_t.shape)
    g_j = vjp(jnp.asarray(ct))
    g_t = torch.autograd.grad(out_t, ts, torch.as_tensor(ct))
    for a, b in zip(g_j, g_t):
        a = np.asarray(a)
        np.testing.assert_allclose(b.numpy(), a, rtol=0,
                                   atol=1e-4 * max(np.abs(a).max(), 1e-30))


def test_index_vertices_by_faces():
    verts = _f32(2, 10, 4)
    faces = RNG.integers(0, 10, (7, 3))
    _check_vjp(lambda v: mesh_j.index_vertices_by_faces(v, jnp.asarray(faces)),
               lambda v: mesh_t.index_vertices_by_faces(
                   v, torch.as_tensor(faces)), [verts])
    with pytest.raises(ValueError):
        mesh_t.index_vertices_by_faces(torch.zeros(10, 3),
                                       torch.as_tensor(faces))


@pytest.mark.parametrize('unit', [False, True])
def test_face_normals(unit):
    fv = _f32(2, 9, 3, 3)
    _check_vjp(lambda x: mesh_j.face_normals(x, unit=unit),
               lambda x: mesh_t.face_normals(x, unit=unit), [fv])


def test_face_normals_degenerate_face():
    fv = _f32(1, 3, 3, 3)
    fv[0, 1] = fv[0, 1, 0]          # all three corners equal
    out_t = mesh_t.face_normals(torch.as_tensor(fv), unit=True).numpy()
    out_j = np.asarray(mesh_j.face_normals(jnp.asarray(fv), unit=True))
    np.testing.assert_allclose(out_t, out_j, atol=1e-6)
    np.testing.assert_array_equal(out_t[0, 1], 0.)


@pytest.mark.parametrize('trans_shape', [(3,), (3, 1)])
def test_rotate_translate_points(trans_shape):
    pts = _f32(3, 11, 3)
    rot = _f32(3, 3, 3)
    trans = _f32(3, *trans_shape)
    _check_vjp(cam_j.rotate_translate_points, cam_t.rotate_translate_points,
               [pts, rot, trans])


def test_generate_rotate_translate_matrices():
    eye = _f32(4, 3, scale=2.)
    at = _f32(4, 3, scale=0.1)
    up = np.broadcast_to(np.array([0., 1., 0.], np.float32), (4, 3)).copy()
    rot_j, tr_j = cam_j.generate_rotate_translate_matrices(
        jnp.asarray(eye), jnp.asarray(at), jnp.asarray(up))
    rot_t, tr_t = cam_t.generate_rotate_translate_matrices(
        torch.as_tensor(eye), torch.as_tensor(at), torch.as_tensor(up))
    np.testing.assert_allclose(rot_t.numpy(), np.asarray(rot_j), atol=1e-6)
    np.testing.assert_array_equal(tr_t.numpy(), np.asarray(tr_j))
    _check_vjp(lambda e: cam_j.generate_rotate_translate_matrices(
                   e, jnp.asarray(at), jnp.asarray(up))[0],
               lambda e: cam_t.generate_rotate_translate_matrices(
                   e, torch.as_tensor(at), torch.as_tensor(up))[0], [eye])


def test_perspective_camera():
    pts = _f32(2, 13, 3)
    pts[..., 2] = -2. - np.abs(pts[..., 2])     # in front of the camera
    proj = np.asarray(cam_j.generate_perspective_projection(0.9))
    _check_vjp(cam_j.perspective_camera, cam_t.perspective_camera,
               [pts, proj])


@pytest.mark.parametrize('fovy, ratio', [(math.pi / 4, 1.), (0.7, 1.5)])
def test_generate_perspective_projection(fovy, ratio):
    p_j = np.asarray(cam_j.generate_perspective_projection(fovy, ratio))
    p_t = cam_t.generate_perspective_projection(fovy, ratio, device='cpu')
    assert p_t.shape == (3, 1) and p_t.dtype == torch.float32
    np.testing.assert_array_equal(p_t.numpy(), p_j)
