"""The port's Camera API against the JAX package, on the CPU.

The cases of ``tests/test_camera.py`` but the pytree / jit one, each run
through both packages on the same inputs: view and projection matrices,
projections and rays within 1e-6 (float32 matrix products), the 6-DoF
backend's gradient against ``jax.grad`` within 1e-5 of max|g|.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.render import camera as J
from kaolin_tpu_torch.render import camera as T

ATOL = 1e-6


def make_cameras(num=1, backend=None, eye=(0., 0., 4.), size=64):
    kw = dict(fov=math.radians(45), width=size, height=size,
              backend=backend)
    e, a, u = (np.array([v] * num, np.float32)
               for v in (eye, (0., 0., 0.), (0., 1., 0.)))
    return (J.Camera.from_args(eye=jnp.asarray(e), at=jnp.asarray(a),
                               up=jnp.asarray(u), **kw),
            T.Camera.from_args(eye=e, at=a, up=u, device='cpu', **kw))


def close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=0,
                               atol=atol)


def test_lookat_view_matrix():
    cj, ct = make_cameras(eye=(0.3, 1.1, 3.7))
    close(cj.view_matrix(), ct.view_matrix())
    close(cj.inv_view_matrix(), ct.inv_view_matrix())
    close(cj.cam_pos(), ct.cam_pos())
    _, ct = make_cameras()
    vm = ct.view_matrix().numpy()
    np.testing.assert_allclose(vm[0, :3, :3], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(vm[0, :3, 3], [0, 0, -4], atol=1e-6)


def test_extrinsics_transform_and_inverse():
    cj, ct = make_cameras(eye=(0.3, 1.1, 3.7))
    pts = np.array([[[0., 0., 0.], [1., 2., 3.]]], np.float32)
    close(cj.extrinsics.transform(jnp.asarray(pts)),
          ct.extrinsics.transform(torch.as_tensor(pts)))
    inv, vm = ct.inv_view_matrix().numpy(), ct.view_matrix().numpy()
    np.testing.assert_allclose(inv[0] @ vm[0], np.eye(4), atol=1e-5)


def test_inv_transform_rays_roundtrip():
    cj, ct = make_cameras(eye=(0.3, 1.1, 3.7))
    orig = np.array([[[0.1, -0.2, 0.5]]], np.float32)
    direction = np.array([[[0., 0., -1.]]], np.float32)
    wj = cj.extrinsics.inv_transform_rays(jnp.asarray(orig),
                                          jnp.asarray(direction))
    wt = ct.extrinsics.inv_transform_rays(torch.as_tensor(orig),
                                          torch.as_tensor(direction))
    for a, b in zip(wj, wt):
        close(a, b)
    np.testing.assert_allclose(ct.extrinsics.transform(wt[0]).numpy(), orig,
                               atol=1e-5)


def test_projection_ndc_center():
    cj, ct = make_cameras(eye=(0.3, 1.1, 3.7))
    pts = np.array([[[0., 0., 0.], [0.5, 0., 0.], [0.2, -0.4, 0.3]]],
                   np.float32)
    ndc = ct.transform(torch.as_tensor(pts))
    close(cj.transform(jnp.asarray(pts)), ndc)
    np.testing.assert_allclose(ndc[0, 0, :2].numpy(), [0., 0.], atol=1e-6)
    close(cj.view_projection_matrix(), ct.view_projection_matrix(),
          atol=1e-5)


@pytest.mark.parametrize('ndc_range', [(-1., 1.), (0., 1.), (1., 0.)])
def test_projection_matrix_structure(ndc_range):
    ij = J.PinholeIntrinsics.from_fov(64, 48, math.radians(60), x0=1.5,
                                      y0=-2.)
    it = T.PinholeIntrinsics.from_fov(64, 48, math.radians(60), x0=1.5,
                                      y0=-2., device='cpu')
    ij.set_ndc_range(*ndc_range)
    it.set_ndc_range(*ndc_range)
    close(ij.perspective_matrix(), it.perspective_matrix())
    # the entries of order far / (far - near) round at 1e-5 relative
    close(ij.projection_matrix(), it.projection_matrix(), atol=1e-5)
    pts = np.array([[[0.3, -0.2, -2.], [1., 1., -5.]]], np.float32)
    close(ij.project(jnp.asarray(pts)), it.project(torch.as_tensor(pts)),
          atol=1e-5)
    depth = np.array([0.5, 2., 50.], np.float32)
    close(ij.normalize_depth(jnp.asarray(depth)),
          it.normalize_depth(torch.as_tensor(depth)))
    close(ij.viewport_matrix(), it.viewport_matrix())
    persp = it.perspective_matrix()[0].numpy()
    fx = float(it.focal_x[0])
    np.testing.assert_allclose(persp, [[fx, 0, -1.5, 0], [0, fx, 2., 0],
                                       [0, 0, 0, 1], [0, 0, 1, 0]],
                               atol=1e-5)


def test_fov_focal_roundtrip():
    ij = J.PinholeIntrinsics.from_fov(64, 32, math.radians(45))
    it = T.PinholeIntrinsics.from_fov(64, 32, math.radians(45),
                                      device='cpu')
    close(ij.params, it.params)
    close(ij.fov_x, it.fov_x, atol=1e-5)
    np.testing.assert_allclose(float(it.fov_y[0]), 45., rtol=1e-5)
    ij2 = J.PinholeIntrinsics.from_focal(64, 32, float(ij.focal_x[0]),
                                         float(ij.focal_y[0]))
    it2 = T.PinholeIntrinsics.from_focal(64, 32, float(it.focal_x[0]),
                                         float(it.focal_y[0]), device='cpu')
    ij2.zoom(5.)
    it2.zoom(5.)
    close(ij2.params, it2.params, atol=1e-4)
    np.testing.assert_allclose(float(it2.fov_y[0]), 40., rtol=1e-4)


def test_ortho_projection():
    ij = J.OrthographicIntrinsics.from_frustum(64, 48, fov_distance=1.5)
    it = T.OrthographicIntrinsics.from_frustum(64, 48, fov_distance=1.5,
                                               device='cpu')
    pts = np.array([[[0.5, 0.5, -1.], [-0.3, 0.2, -4.]]], np.float32)
    close(ij.transform(jnp.asarray(pts)), it.transform(torch.as_tensor(pts)))
    close(ij.projection_matrix(), it.projection_matrix())
    depth = np.array([0.5, 2., 50.], np.float32)
    close(ij.normalize_depth(jnp.asarray(depth)),
          it.normalize_depth(torch.as_tensor(depth)))
    ij.zoom(0.25)
    it.zoom(0.25)
    close(ij.params, it.params)
    it1 = T.OrthographicIntrinsics.from_frustum(64, 64, fov_distance=1.0,
                                                device='cpu')
    ndc = it1.transform(torch.tensor([[[0.5, 0.5, -1.]]]))
    np.testing.assert_allclose(ndc[0, 0, :2].numpy(), [0.5, 0.5], atol=1e-5)


def test_six_dof_backend_matches_se3():
    cj, ct = make_cameras(backend='matrix_se3', eye=(0.3, 1.1, 3.7))
    e6j = cj.extrinsics.switch_backend('matrix_6dof_rotation')
    e6t = ct.extrinsics.switch_backend('matrix_6dof_rotation')
    close(e6j.params, e6t.params)
    close(e6j.view_matrix(), e6t.view_matrix())
    np.testing.assert_allclose(e6t.view_matrix().numpy(),
                               ct.view_matrix().numpy(), atol=1e-5)
    assert T.available_backends() == J.available_backends()


def test_requires_grad_selects_6dof():
    kw = dict(eye=np.array([0., 1., 4.], np.float32), at=np.zeros(3),
              up=np.array([0., 1., 0.]))
    ej = J.CameraExtrinsics.from_lookat(requires_grad=True, **kw)
    et = T.CameraExtrinsics.from_lookat(requires_grad=True, device='cpu',
                                        **kw)
    assert et.backend_name == ej.backend_name == 'matrix_6dof_rotation'
    assert et.params.is_leaf and et.params.requires_grad
    close(ej.params, et.params)
    e2 = T.CameraExtrinsics.from_lookat(device='cpu', **kw)
    assert e2.backend_name == 'matrix_se3' and not e2.requires_grad
    np.testing.assert_allclose(et.view_matrix().detach().numpy(),
                               e2.view_matrix().numpy(), atol=1e-5)
    mask = et.gradient_mask('R')
    np.testing.assert_array_equal(np.asarray(ej.gradient_mask('R')),
                                  mask.numpy())
    np.testing.assert_array_equal(np.asarray(ej.gradient_mask('t')),
                                  et.gradient_mask('t').numpy())


@pytest.mark.parametrize('backend', ['matrix_se3', 'matrix_6dof_rotation'])
def test_translate_rotate_move(backend):
    cj, ct = make_cameras(backend=backend, eye=(0.3, 1.1, 3.7))
    pos0 = ct.cam_pos().numpy()[0, :, 0]
    for c, arr in ((cj, jnp.asarray), (ct, torch.tensor)):
        c.translate(arr([1., 0., 0.]))
    close(cj.view_matrix(), ct.view_matrix())
    pos1 = ct.cam_pos().numpy()[0, :, 0]
    np.testing.assert_allclose(pos1 - pos0, [1., 0., 0.], atol=1e-5)
    for c in (cj, ct):
        c.move_forward(1.)
        c.move_right(0.25)
        c.move_up(-0.5)
    close(cj.view_matrix(), ct.view_matrix(), atol=1e-5)
    for c in (cj, ct):
        c.rotate(yaw=0.3, pitch=-0.2, roll=0.1)
    close(cj.view_matrix(), ct.view_matrix(), atol=1e-5)
    for name in ('cam_right', 'cam_up', 'cam_forward'):
        close(getattr(cj, name)(), getattr(ct, name)(), atol=1e-5)
    R = ct.R.numpy()[0]
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-5)


def test_translate_keeps_the_leaf():
    """On params that require grad the motion ops write in place: the
    tensor an optimizer holds stays the camera's."""
    et = T.CameraExtrinsics.from_lookat([0., 1., 4.], [0., 0., 0.],
                                        [0., 1., 0.], requires_grad=True,
                                        device='cpu')
    params = et.params
    et.translate(torch.tensor([1., 0., 0.]))
    assert et.params is params and params.is_leaf
    np.testing.assert_allclose(et.cam_pos().detach().numpy()[0, :, 0],
                               [1., 1., 4.], atol=1e-5)


def test_change_coordinate_system_roundtrip():
    cj, ct = make_cameras(eye=(0.3, 1.1, 3.7))
    vm0 = ct.view_matrix().numpy().copy()
    cj.change_coordinate_system(J.blender_coords())
    ct.change_coordinate_system(T.blender_coords(device='cpu'))
    close(cj.view_matrix(), ct.view_matrix())
    close(cj.basis_change_matrix, ct.basis_change_matrix)
    assert not np.allclose(vm0, ct.view_matrix().numpy())
    ct.reset_coordinate_system()
    np.testing.assert_allclose(ct.view_matrix().numpy(), vm0, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(J.opengl_coords()),
                                  T.opengl_coords(device='cpu').numpy())


def test_camera_cat_and_getitem():
    cams = []
    for shift in (0., 1.):
        cj, ct = make_cameras(eye=(0.3, 1.1, 3.7))
        cj.translate(jnp.array([shift, 0., 0.]))
        ct.translate(torch.tensor([shift, 0., 0.]))
        cams.append((cj, ct))
    both_j = J.Camera.cat([c[0] for c in cams])
    both_t = T.Camera.cat([c[1] for c in cams])
    assert len(both_t) == 2
    close(both_j.view_matrix(), both_t.view_matrix())
    close(both_j.intrinsics.params, both_t.intrinsics.params)
    sub = both_t[1]
    np.testing.assert_allclose(sub.view_matrix().numpy(),
                               cams[1][1].view_matrix().numpy(), atol=1e-6)
    assert T.allclose(sub, cams[1][1]) and not T.allclose(sub, cams[0][1])
    assert [len(c) for c in both_t] == [1, 1]
    with pytest.raises(IndexError):
        both_t[2]


def test_camera_grad_through_6dof():
    kw = dict(eye=np.array([0., 0., 4.], np.float32), at=np.zeros(3),
              up=np.array([0., 1., 0.]), requires_grad=True)
    ej = J.CameraExtrinsics.from_lookat(**kw)
    ij = J.PinholeIntrinsics.from_fov(32, 32, math.radians(45))
    pts = np.array([[[0.3, 0.2, 0.1]]], np.float32)

    def loss(params):
        cam = J.Camera(J.CameraExtrinsics(params, 'matrix_6dof_rotation'),
                       ij)
        return jnp.sum(cam.transform(jnp.asarray(pts))[..., :2] ** 2)

    g_j = np.asarray(jax.grad(loss)(ej.params))
    et = T.CameraExtrinsics.from_lookat(device='cpu', **kw)
    it = T.PinholeIntrinsics.from_fov(32, 32, math.radians(45),
                                      device='cpu')
    ndc = T.Camera(et, it).transform(torch.as_tensor(pts))
    (ndc[..., :2] ** 2).sum().backward()
    g_t = et.params.grad.numpy()
    assert np.isfinite(g_t).all() and np.abs(g_t).sum() > 0
    np.testing.assert_allclose(g_t, g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())


def test_legacy_camera_path():
    rot, trans = T.generate_rotate_translate_matrices(
        torch.tensor([[0., 0., 4.]]), torch.zeros((1, 3)),
        torch.tensor([[0., 1., 0.]]))
    cam_pts = T.rotate_translate_points(
        torch.tensor([[[0., 0., 0.], [1., 0., 0.]]]), rot, trans)
    np.testing.assert_allclose(cam_pts[0, 0].numpy(), [0, 0, -4], atol=1e-6)
    proj = T.generate_perspective_projection(math.radians(45), device='cpu')
    im_pts = T.perspective_camera(cam_pts, proj)
    np.testing.assert_allclose(im_pts[0, 0].numpy(), [0, 0], atol=1e-6)


@pytest.mark.parametrize('lens', ['pinhole', 'ortho'])
def test_generate_rays(lens):
    if lens == 'pinhole':
        cj, ct = make_cameras(num=2, eye=(0.3, 1.1, 3.7))
    else:
        kw = dict(eye=np.array([[0.3, 1.1, 3.7]], np.float32),
                  at=np.zeros((1, 3), np.float32),
                  up=np.array([[0., 1., 0.]], np.float32),
                  fov_distance=1.5, width=48, height=32)
        cj = J.Camera.from_args(**kw)
        ct = T.Camera.from_args(device='cpu', **kw)
    for a, b in zip(cj.generate_rays(), ct.generate_rays()):
        close(a, b)
    _, ct = make_cameras()
    orig, d = ct.generate_rays()
    assert orig.shape == (1, 64 * 64, 3)
    assert float(d[0].reshape(64, 64, 3)[32, 32, 2]) < -0.9
    np.testing.assert_allclose(orig[0, 0].numpy(), [0, 0, 4], atol=1e-5)


def test_from_args_variants():
    vm = np.array(make_cameras(eye=(0.3, 1.1, 3.7))[0].view_matrix())
    pose = dict(cam_pos=np.array([0.3, 1.1, 3.7], np.float32),
                cam_dir=np.eye(3, dtype=np.float32))
    for kw in (dict(view_matrix=vm), pose):
        for intr in (dict(focal_x=40., y0=2.), dict(fov_distance=2.)):
            args = dict(kw, width=32, height=24, near=0.1, far=20., **intr)
            cj = J.Camera.from_args(**args)
            ct = T.Camera.from_args(device='cpu', **args)
            close(cj.view_matrix(), ct.view_matrix())
            close(cj.projection_matrix(), ct.projection_matrix(), atol=1e-5)
            assert ct.lens_type == cj.lens_type
    with pytest.raises(ValueError):
        T.Camera.from_args(width=4, height=4, device='cpu')
