"""The port's Jupyter visualizers against kaolin_tpu's, on the CPU.

The quaternion helpers to 1e-6 on seeded inputs; the cameras' view
matrices after the same event sequences (turntable drags, rotate, zoom;
first-person moves and look) to 1e-6; ``_draw``'s uint8 conversion of a
tensor image and its fps throttle; ``update_canvas``; ``show()`` without
the widget packages raises ImportError.
"""
import math
import sys

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaolin_tpu.render.camera import Camera as CameraJ
from kaolin_tpu.visualize import ipython as VJ
from kaolin_tpu_torch.render.camera import Camera as CameraT
from kaolin_tpu_torch.visualize import ipython as VT

ATOL = 1e-6
N = 16


class FakeCanvas:
    def __init__(self):
        self.images = []

    def put_image_data(self, img):
        self.images.append(np.asarray(img))


def _cams():
    kw = dict(fov=math.pi / 4., width=N, height=N)
    cam_t = CameraT.from_args(eye=torch.tensor([0.3, 0.4, 3.]),
                              at=torch.zeros(3),
                              up=torch.tensor([0., 1., 0.]), **kw)
    cam_j = CameraJ.from_args(eye=jnp.array([0.3, 0.4, 3.]),
                              at=jnp.zeros(3), up=jnp.array([0., 1., 0.]),
                              **kw)
    return cam_t, cam_j


def _render_t(camera):
    pos = camera.cam_pos().reshape(-1)[:3]
    return (pos.abs() / (pos.abs().max() + 1e-9)).expand(N, N, 3)


def _render_j(camera):
    pos = np.asarray(camera.cam_pos()).reshape(-1)[:3]
    return np.broadcast_to(np.abs(pos) / (np.abs(pos).max() + 1e-9),
                           (N, N, 3))


def _same_view(viz_t, viz_j):
    np.testing.assert_allclose(viz_t.camera.view_matrix().numpy(),
                               np.asarray(viz_j.camera.view_matrix()),
                               rtol=0, atol=ATOL)


def test_quaternion_helpers():
    rng = np.random.default_rng(0)
    axis = rng.normal(size=(5, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    pts = rng.normal(size=(5, 3))
    q1, q2 = rng.normal(size=(5, 4)), rng.normal(size=(5, 4))
    for name, args in (('make_quaternion_rotation', (0.7, axis)),
                       ('conjugate', (q1,)), ('mulqv', (q1, pts)),
                       ('mulqq', (q1, q2)),
                       ('rotate_around_axis', (pts, 0.7, axis)),
                       ('quat_from_axis_angle', (axis[0], 0.3)),
                       ('quat_mul', (q1[0], q2[0])),
                       ('quat_rotate', (q1[0], pts[0]))):
        out_t = getattr(VT, name)(*args)
        out_j = getattr(VJ, name)(*args)
        np.testing.assert_allclose(out_t, out_j, rtol=0, atol=ATOL,
                                   err_msg=name)
    # tensors are taken too
    np.testing.assert_allclose(
        VT.rotate_around_axis(torch.as_tensor(pts), 0.7,
                              torch.as_tensor(axis)),
        VJ.rotate_around_axis(pts, 0.7, axis), rtol=0, atol=ATOL)


def test_turntable_events_match():
    (cam_t, cam_j) = _cams()
    viz_t = VT.IpyTurntableVisualizer(N, N, cam_t, _render_t, max_fps=None)
    viz_j = VJ.IpyTurntableVisualizer(N, N, cam_j, _render_j, max_fps=None)
    for viz in (viz_t, viz_j):
        viz._handle_mouse_down(8, 8)
        viz._handle_mouse_move(12, 10)
        viz._handle_mouse_move(13, 4)
        viz._handle_mouse_up(13, 4)
        viz._handle_mouse_move(1, 1)           # not dragging: no motion
        viz.rotate(-3., 2.)
        viz.zoom(5000.)
    _same_view(viz_t, viz_j)
    np.testing.assert_allclose(viz_t.camera.fov_y.numpy(),
                               np.asarray(viz_j.camera.fov_y), atol=ATOL)
    d_t = np.linalg.norm(viz_t.camera.cam_pos().reshape(-1).numpy())
    np.testing.assert_allclose(d_t, np.linalg.norm([0.3, 0.4, 3.]),
                               rtol=1e-5)


def test_first_person_events_match():
    (cam_t, cam_j) = _cams()
    viz_t = VT.IpyFirstPersonVisualizer(N, N, cam_t, _render_t,
                                        max_fps=None)
    viz_j = VJ.IpyFirstPersonVisualizer(N, N, cam_j, _render_j,
                                        max_fps=None)
    for viz in (viz_t, viz_j):
        viz.move_forward(0.5)
        viz.move_right()
        viz.move_up(0.2)
        viz.look(3., -2.)
        viz._handle_mouse_down(8, 8)
        viz._handle_mouse_move(10, 9)
        viz._handle_mouse_up(10, 9)
    _same_view(viz_t, viz_j)


def test_draw_converts_and_throttles():
    cam_t, cam_j = _cams()
    viz_t = VT.IpyTurntableVisualizer(N, N, cam_t, _render_t, max_fps=None)
    viz_j = VJ.IpyTurntableVisualizer(N, N, cam_j, _render_j, max_fps=None)
    viz_t.canvas = FakeCanvas()
    img_t, img_j = viz_t._draw(viz_t.render), viz_j._draw(viz_j.render)
    assert img_t.dtype == np.uint8 and img_t.shape == (N, N, 3)
    np.testing.assert_array_equal(img_t, img_j)
    np.testing.assert_array_equal(viz_t.canvas.images[0], img_t)
    # a batched image (1, H, W, 3) draws its first image
    batched = VT.IpyTurntableVisualizer(
        N, N, cam_t, lambda c: _render_t(c)[None], max_fps=None)
    np.testing.assert_array_equal(batched._draw(batched.render), img_t)
    slow = VT.IpyTurntableVisualizer(N, N, _cams()[0], _render_t,
                                     max_fps=24.)
    assert slow._draw(slow.render) is not None
    assert slow._draw(slow.render) is None      # within 1 / 24 s


def test_update_canvas():
    for pkg, img in ((VT, torch.full((4, 4, 3), 0.5)),
                     (VJ, np.full((4, 4, 3), 0.5, np.float32))):
        canvas = FakeCanvas()
        pkg.update_canvas(canvas, img)
        assert canvas.images[0].dtype == np.uint8
        assert canvas.images[0][0, 0, 0] == 127


def test_show_needs_the_widgets(monkeypatch):
    monkeypatch.setitem(sys.modules, 'ipycanvas', None)   # import fails
    viz = VT.IpyTurntableVisualizer(N, N, _cams()[0], _render_t)
    with pytest.raises(ImportError, match='ipycanvas'):
        viz.show()
    assert viz._draw(viz.render).shape == (N, N, 3)   # no widget needed
