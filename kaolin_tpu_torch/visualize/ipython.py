"""Interactive Jupyter visualizers driving ``render(camera) -> image``.

Port of ``kaolin_tpu/visualize/ipython.py`` over the port's
:class:`~kaolin_tpu_torch.render.camera.Camera`.  The widget layer
(ipycanvas / ipywidgets) is optional and imported only by ``show()`` and
``_make_widgets()``: the camera-manipulation math (quaternions, turntable,
first-person controls) and ``_draw`` work without it.  ``render`` may
return a tensor on any device (or a numpy array); ``_draw`` copies the
image to the host once, as uint8.
"""

import math
import time

import numpy as np
import torch

from kaolin_tpu_torch.render.camera import CameraExtrinsics

__all__ = ['update_canvas', 'BaseIpyVisualizer', 'IpyTurntableVisualizer',
           'IpyFirstPersonVisualizer', 'make_quaternion_rotation',
           'conjugate', 'mulqv', 'mulqq', 'rotate_around_axis']


def _require_widgets():
    try:
        import ipycanvas  # noqa: F401
        import ipywidgets  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "Interactive visualizers need ipycanvas + ipywidgets "
            "(jupyter environment)") from e


def _host(x):
    """A host numpy array of an image or a camera quantity."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# -- quaternion helpers (numpy, float64) --------------------------------------

def quat_from_axis_angle(axis, angle):
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / np.linalg.norm(axis)
    half = angle / 2.
    return np.concatenate([np.array([np.cos(half)]), axis * np.sin(half)])


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def quat_rotate(q, v):
    qv = np.concatenate([[0.], np.asarray(v, dtype=np.float64)])
    q_conj = q * np.array([1., -1., -1., -1.])
    return quat_mul(quat_mul(q, qv), q_conj)[1:]


def make_quaternion_rotation(angle, vec):
    """Axis-angle rotation as a batched quaternion in (x, y, z, w) layout:
    vec is (batch, 3), returns (batch, 4)."""
    vec = _host(vec).astype(np.float64)
    half = angle / 2.
    s, c = np.sin(half), np.cos(half)
    return np.stack([vec[:, 0] * s, vec[:, 1] * s, vec[:, 2] * s,
                     np.full((vec.shape[0],), c)], axis=-1)


def conjugate(quat):
    """Conjugate of a batched (x, y, z, w) quaternion."""
    quat = _host(quat)
    return np.stack([-quat[:, 0], -quat[:, 1], -quat[:, 2], quat[:, 3]],
                    axis=-1)


def mulqv(q, v):
    """Product of a batched (x, y, z, w) quaternion with a 3D vector."""
    q, v = _host(q), _host(v)
    return np.stack([
        q[:, 3] * v[:, 0] + q[:, 1] * v[:, 2] - q[:, 2] * v[:, 1],
        q[:, 3] * v[:, 1] + q[:, 2] * v[:, 0] - q[:, 0] * v[:, 2],
        q[:, 3] * v[:, 2] + q[:, 0] * v[:, 1] - q[:, 1] * v[:, 0],
        -q[:, 0] * v[:, 0] - q[:, 1] * v[:, 1] - q[:, 2] * v[:, 2],
    ], axis=-1)


def mulqq(l, r):
    """Hamilton product of two batched (x, y, z, w) quaternions (the w
    component as the JAX package corrects it: ``l[:,2]*r[:,2]``)."""
    l, r = _host(l), _host(r)
    return np.stack([
        l[:, 0] * r[:, 3] + l[:, 3] * r[:, 0] + l[:, 1] * r[:, 2] - l[:, 2] * r[:, 1],
        l[:, 1] * r[:, 3] + l[:, 3] * r[:, 1] + l[:, 2] * r[:, 0] - l[:, 0] * r[:, 2],
        l[:, 2] * r[:, 3] + l[:, 3] * r[:, 2] + l[:, 0] * r[:, 1] - l[:, 1] * r[:, 0],
        l[:, 3] * r[:, 3] - l[:, 0] * r[:, 0] - l[:, 1] * r[:, 1] - l[:, 2] * r[:, 2],
    ], axis=-1)


def rotate_around_axis(point, angle, axis):
    """Rotate batched points around batched axes by ``angle``."""
    rot_q = make_quaternion_rotation(angle, axis)
    return mulqq(mulqv(rot_q, _host(point)), conjugate(rot_q))[:, :-1]


def _to_uint8(image):
    img = _host(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0., 1.) * 255).astype(np.uint8)
    return img


def update_canvas(canvas, image):
    """Put an image (tensor on any device, or array) on an ipycanvas
    Canvas."""
    canvas.put_image_data(_to_uint8(image))


class BaseIpyVisualizer:
    """Canvas + event-loop base; subclasses map events to camera motion."""

    def __init__(self, height, width, camera, render, fast_render=None,
                 max_fps=24., world_up_axis=1, **kwargs):
        self.height = height
        self.width = width
        self.camera = camera
        self.render = render
        self.fast_render = fast_render if fast_render is not None else render
        self.max_fps = max_fps
        self.world_up_axis = world_up_axis
        self._last_draw = 0.
        self.canvas = None
        self.out = None

    def _make_widgets(self):
        _require_widgets()
        import ipycanvas
        import ipywidgets
        self.canvas = ipycanvas.Canvas(height=self.height, width=self.width)
        self.out = ipywidgets.Output()
        self.canvas.on_mouse_down(self._handle_mouse_down)
        self.canvas.on_mouse_up(self._handle_mouse_up)
        self.canvas.on_mouse_move(self._handle_mouse_move)
        self._draw(self.render)

    def _draw(self, render_fn):
        """Render and put the image on the canvas (fps-throttled: returns
        None when called within 1 / max_fps of the last draw)."""
        now = time.time()
        if self.max_fps and now - self._last_draw < 1. / self.max_fps:
            return
        self._last_draw = now
        img = render_fn(self.camera)
        if img.ndim == 4:
            img = img[0]
        img = _to_uint8(img)
        if self.canvas is not None:
            self.canvas.put_image_data(img)
        return img

    def show(self):
        _require_widgets()
        import ipywidgets
        if self.canvas is None:
            self._make_widgets()
        from IPython.display import display
        display(ipywidgets.VBox([self.canvas, self.out]))

    # subclasses implement these
    def _handle_mouse_down(self, x, y):
        pass

    def _handle_mouse_up(self, x, y):
        pass

    def _handle_mouse_move(self, x, y):
        pass


class IpyTurntableVisualizer(BaseIpyVisualizer):
    """Orbit ("turntable") camera visualizer."""

    def __init__(self, height, width, camera, render, fast_render=None,
                 max_fps=24., world_up_axis=1, focus_at=None,
                 zoom_sensitivity=1e-3, mouse_sensitivity=1.5, **kwargs):
        super().__init__(height, width, camera, render, fast_render,
                         max_fps, world_up_axis, **kwargs)
        if focus_at is None:
            focus_at = np.zeros(3)
        self.focus_at = _host(focus_at).astype(np.float32)
        self.zoom_sensitivity = zoom_sensitivity
        self.mouse_sensitivity = mouse_sensitivity
        self._dragging = False
        self._last_xy = None

    def rotate(self, dx, dy):
        """Orbit the camera around the focus point."""
        cam_pos = _host(self.camera.cam_pos())[0, :, 0]
        rel = cam_pos - self.focus_at
        azimuth = -dx * self.mouse_sensitivity * math.pi / self.width
        elevation = -dy * self.mouse_sensitivity * math.pi / self.height
        up = np.zeros(3)
        up[self.world_up_axis] = 1.
        right = _host(self.camera.cam_right())[0, :, 0]
        q = quat_mul(quat_from_axis_angle(up, azimuth),
                     quat_from_axis_angle(right, elevation))
        new_rel = quat_rotate(q, rel)
        new_pos = self.focus_at + new_rel
        dev = self.camera.device

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        ext = CameraExtrinsics.from_lookat(eye=t(new_pos),
                                           at=t(self.focus_at), up=t(up))
        self.camera.extrinsics.update(ext.view_matrix())

    def zoom(self, amount):
        self.camera.zoom(amount * self.zoom_sensitivity)

    def _handle_mouse_down(self, x, y):
        self._dragging = True
        self._last_xy = (x, y)

    def _handle_mouse_up(self, x, y):
        self._dragging = False
        self._draw(self.render)

    def _handle_mouse_move(self, x, y):
        if not self._dragging:
            return
        lx, ly = self._last_xy
        self._last_xy = (x, y)
        self.rotate(x - lx, y - ly)
        self._draw(self.fast_render)


class IpyFirstPersonVisualizer(BaseIpyVisualizer):
    """WASD/mouse first-person camera visualizer."""

    def __init__(self, height, width, camera, render, fast_render=None,
                 max_fps=24., world_up=None, move_sensitivity=0.05,
                 mouse_sensitivity=1.5, **kwargs):
        super().__init__(height, width, camera, render, fast_render,
                         max_fps, **kwargs)
        self.move_sensitivity = move_sensitivity
        self.mouse_sensitivity = mouse_sensitivity
        self._dragging = False
        self._last_xy = None

    def move_forward(self, amount=None):
        self.camera.move_forward(amount or self.move_sensitivity)

    def move_right(self, amount=None):
        self.camera.move_right(amount or self.move_sensitivity)

    def move_up(self, amount=None):
        self.camera.move_up(amount or self.move_sensitivity)

    def look(self, dx, dy):
        yaw = -dx * self.mouse_sensitivity * math.pi / self.width
        pitch = -dy * self.mouse_sensitivity * math.pi / self.height
        self.camera.rotate(yaw=yaw, pitch=pitch)

    def _handle_mouse_down(self, x, y):
        self._dragging = True
        self._last_xy = (x, y)

    def _handle_mouse_up(self, x, y):
        self._dragging = False
        self._draw(self.render)

    def _handle_mouse_move(self, x, y):
        if not self._dragging:
            return
        lx, ly = self._last_xy
        self._last_xy = (x, y)
        self.look(x - lx, y - ly)
        self._draw(self.fast_render)
