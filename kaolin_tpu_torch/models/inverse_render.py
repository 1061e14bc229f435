"""Flagship model: DIB-R textured inverse rendering.

Port of ``kaolin_tpu/models/inverse_render.py``: optimizable parameters
(vertex positions, UV texture, SH lighting) in an ``nn.Module`` plus the
render step.  A training step is :func:`compute_selection` (the
non-differentiable selection, under ``no_grad``: the fused engine's, or
with ``backend='jnp'`` the brute-force z-buffer and the soft mask's
k-buffer) followed by :func:`render_loss` (on the card the per-pixel chain
from the face rows to the loss terms is one autograd Function of
hand-written kernels, :mod:`~kaolin_tpu_torch.render.mesh._shade`),
``backward()`` and the optimizer's step.  :func:`compiled_step` makes that
step one CUDA graph on the card, as the JAX package's callers jit theirs.
"""

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.render import camera as camera_fns
from kaolin_tpu_torch.render import mesh as mesh_render
from kaolin_tpu_torch.ops import _scatter
from kaolin_tpu_torch.render.mesh import _fused, _sample, _shade
from kaolin_tpu_torch.render.mesh.rasterization import _resolve_backend
from kaolin_tpu_torch.utils.profiler import span

__all__ = ['InverseRender', 'InverseRenderParams', 'CameraViews',
           'make_views', 'render_views', 'render_loss', 'init_params',
           'compute_selection', 'from_jax_params', 'compiled_step']

# the soft mask's sharpness where the caller gives none
_SIGMAINV = 7000.
# eager steps before a capture: PyTorch's whole-network capture recipe
_WARMUP = 3
# the launch counts of the kernels a step runs: K1 and K2, E1 and E2, E3,
# the shading's forward and backward
_COUNTS = (_fused.LAUNCHES, _sample.LAUNCHES, _scatter.LAUNCHES,
           _shade.LAUNCHES)


class InverseRenderParams(NamedTuple):
    """The model's parameters as the JAX package's NamedTuple (the same
    fields in the same order): the state a checkpoint holds."""
    vertices: torch.Tensor       # (V, 3)
    texture_map: torch.Tensor    # (3, TH, TW)
    sh_coeffs: torch.Tensor      # (9,)


class InverseRender(nn.Module):
    """Optimizable parameters of the inverse-rendering model."""

    def __init__(self, vertices, texture_map, sh_coeffs):
        super().__init__()
        self.vertices = nn.Parameter(vertices)          # (V, 3)
        self.texture_map = nn.Parameter(texture_map)    # (3, TH, TW)
        self.sh_coeffs = nn.Parameter(sh_coeffs)        # (9,)

    def as_params(self):
        """The parameters as an :class:`InverseRenderParams` (the
        module's own tensors, not copies)."""
        return InverseRenderParams(self.vertices, self.texture_map,
                                   self.sh_coeffs)

    def load_params(self, params):
        """Copy an :class:`InverseRenderParams` into the parameters."""
        with torch.no_grad():
            for name, value in zip(params._fields, params):
                getattr(self, name).copy_(value)


class CameraViews(NamedTuple):
    """Per-view camera data (leading axis = views)."""
    camera_rot: torch.Tensor     # (B, 3, 3)
    camera_trans: torch.Tensor   # (B, 3)
    camera_proj: torch.Tensor    # (3, 1) shared


def init_params(mesh, texture_res=256, generator=None, device=None):
    """Init params from a mesh with ``.vertices`` (normalized into
    [-0.5, 0.5]^3) and a uniform random texture drawn from ``generator``
    (default: a CPU generator seeded with 0), on ``device`` (default: the
    device of ``mesh.vertices`` when it is a tensor, else the card, see
    :func:`~kaolin_tpu_torch._device.entry_device`)."""
    device = entry_device(device, mesh.vertices)
    v = torch.as_tensor(mesh.vertices, dtype=torch.float32, device=device)
    vmin = v.amin(dim=0, keepdim=True)
    vmax = v.amax(dim=0, keepdim=True)
    v = (v - (vmin + vmax) / 2.) / (vmax - vmin).max()
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    texture = torch.rand((3, texture_res, texture_res), generator=generator,
                         dtype=torch.float32, device=generator.device)
    sh = torch.zeros((9,), dtype=torch.float32, device=device)
    sh[0] = 3.0
    return InverseRender(v, texture.to(device), sh)


def from_jax_params(vertices, texture_map, sh_coeffs, device=None):
    """The port's model from the JAX package's parameters (numpy arrays),
    on ``device`` (default: the card)."""
    device = entry_device(device)

    def t(a):
        return torch.as_tensor(np.array(a, dtype=np.float32), device=device)
    return InverseRender(t(vertices), t(texture_map), t(sh_coeffs))


def make_views(num_views, distance=2.0, fovy=math.pi / 4., elevation=0.4,
               device=None):
    """Build a turntable of camera views around the origin, on ``device``
    (default: the card)."""
    device = entry_device(device)
    azimuth = np.linspace(0, 2 * np.pi, num_views, endpoint=False)
    eye = np.stack([np.sin(azimuth) * np.cos(elevation),
                    np.full_like(azimuth, np.sin(elevation)),
                    np.cos(azimuth) * np.cos(elevation)],
                   axis=-1) * distance
    eye = torch.as_tensor(eye, dtype=torch.float32, device=device)
    at = torch.zeros((num_views, 3), dtype=torch.float32, device=device)
    up = torch.tensor([0., 1., 0.], device=device).expand(num_views, 3)
    rot, trans = camera_fns.generate_rotate_translate_matrices(eye, at, up)
    proj = camera_fns.generate_perspective_projection(fovy, device=device)
    return CameraViews(rot, trans, proj)


def _prepare(params, views, faces):
    """Camera transform + projection + face indexing (differentiable)."""
    B = views.camera_rot.shape[0]
    vertices = params.vertices[None].expand(B, -1, -1)
    return mesh_render.prepare_vertices(
        vertices, faces, views.camera_proj,
        camera_rot=views.camera_rot, camera_trans=views.camera_trans)


def compute_selection(params, views, faces, height, width, backend='auto',
                      boxlen=0.02, knum=30, sigmainv=_SIGMAINV):
    """Run the non-differentiable selection passes (z-buffer + soft mask)
    on detached geometry.

    Returns:
        (face_idx (B, H, W), aux), accepted by :func:`render_views` /
        :func:`render_loss` as ``selection``.  ``aux`` is the soft mask's
        selection state: a :class:`~kaolin_tpu_torch.render.mesh.FusedSelection`
        for ``'fused'`` (``knum`` unused: the fused product is uncapped), or
        the (B, H, W, knum) k-buffer for ``'jnp'``.
    """
    backend = _resolve_backend(backend)
    with span('dibr.select', params.vertices.device), torch.no_grad():
        face_vertices_camera, face_vertices_image, face_normals = \
            _prepare(params, views, faces)
        if backend == 'fused':
            sel = mesh_render.fused_selection(
                face_vertices_camera[..., 2], face_vertices_image,
                face_normals[..., 2] >= 0., height, width,
                boxlen=boxlen, sigmainv=sigmainv)
            return sel.face_idx, sel
        face_idx = mesh_render.rasterize_selection(
            height, width, face_vertices_camera[..., 2], face_vertices_image,
            valid_faces=face_normals[..., 2] >= 0., backend=backend)
        kbuf = mesh_render.dibr_soft_mask_select(
            face_vertices_image, face_idx, boxlen=boxlen, knum=knum)
    return face_idx, kbuf


def _soft_mask(face_vertices_image, selection, with_soft_mask, sigmainv,
               knum):
    """The soft silhouette mask of the selection (the hard one without
    ``with_soft_mask``)."""
    if with_soft_mask:
        return mesh_render.dibr_soft_mask(
            face_vertices_image, selection[0], sigmainv=sigmainv, knum=knum,
            kbuf=selection[1])
    return (selection[0] >= 0).to(face_vertices_image.dtype)


def render_views(params, views, faces, face_uvs, height, width,
                 backend='auto', sigmainv=_SIGMAINV, with_soft_mask=True,
                 selection=None, knum=30):
    """Render all views: textured DIB-R + SH lighting.

    prepare_vertices -> rasterize(uvs, normals) -> texture_mapping +
    spherical_harmonic_lighting (:func:`~kaolin_tpu_torch.render.mesh.
    _shade.shade_images`, plain PyTorch) -> soft mask.

    Args:
        params: model parameters (``.vertices``, ``.texture_map``,
            ``.sh_coeffs``).
        views: camera batch (B views).
        faces: (F, 3) int tensor.
        face_uvs: (F, 3, 2) per-face-corner uvs.
        height, width: image size.
        selection: the output of :func:`compute_selection` for these
            parameters; computed here when None.

    Returns:
        (images (B, H, W, 3), soft_mask (B, H, W), face_idx (B, H, W)).
    """
    if selection is None:
        selection = compute_selection(params, views, faces, height, width,
                                      backend, sigmainv=sigmainv, knum=knum)
    _, face_vertices_image, face_normals = _prepare(params, views, faces)
    images = _shade.shade_images(selection[0], face_vertices_image,
                                 face_normals, face_uvs, params.texture_map,
                                 params.sh_coeffs)
    soft_mask = _soft_mask(face_vertices_image, selection, with_soft_mask,
                           sigmainv, knum)
    return images, soft_mask, selection[0]


def render_loss(params, views, faces, face_uvs, target_images, target_masks,
                height, width, backend='auto', with_soft_mask=True,
                selection=None, knum=30):
    """Image L1 + silhouette IoU loss of :func:`render_views`' images and
    soft mask, which are not materialised on the card: there the chain
    from the face rows to the two terms is
    :func:`~kaolin_tpu_torch.render.mesh._shade.shade_loss`'s kernels, on
    the CPU its plain composition."""
    with span('dibr.render', params.vertices.device):
        if selection is None:
            selection = compute_selection(params, views, faces, height,
                                          width, backend, knum=knum)
        _, face_vertices_image, face_normals = _prepare(params, views, faces)
        soft_mask = _soft_mask(face_vertices_image, selection,
                               with_soft_mask, _SIGMAINV, knum)
        image_loss, mask_loss = _shade.shade_loss(
            selection[0], face_vertices_image, face_normals, face_uvs,
            params.texture_map, params.sh_coeffs, soft_mask, target_images,
            target_masks)
        return image_loss + mask_loss


def compiled_step(model, views, faces, face_uvs, target_images, target_masks,
                  height, width, optimizer, backend='auto', knum=30,
                  loss_fn=None):
    """One whole training step as one program: :func:`compute_selection`
    -> :func:`render_loss` -> ``backward()`` -> ``optimizer.step()``, the
    port's counterpart of the JAX callers'
    ``jax.jit(jax.value_and_grad(render_loss))`` and optax update.

    ``loss_fn`` (default :func:`render_loss`, this module's when the step
    is built) is the step's loss: a function with :func:`render_loss`'s
    arguments that takes ``model`` as its parameters, such as another
    model's (``models/dibrpp.py::render_loss``, whose model adds material
    and light leaves).  Whatever it is, the selection is
    :func:`compute_selection` of ``model.vertices``, and every parameter
    of ``model`` is a leaf of the backward and the optimizer's update.

    Returns a callable ``step(views, target_images, target_masks)`` that
    takes one step of ``model`` toward the targets seen from ``views`` and
    returns the loss as a tensor on the model's device (the loss of the
    parameters before the update; ``model``'s gradients are the step's
    after it).  Like a jitted function it is bound to the shapes, types
    and devices of the ``views`` and targets it was built with, and raises
    on others; ``faces`` and ``face_uvs`` are read in place.  Its
    ``selection`` is the last step's selection (:func:`compute_selection`)
    and its ``graph`` the CUDA graph it replays (None on the CPU).

    On a CUDA model the step is captured once in a CUDA graph (PyTorch's
    whole-network recipe) and each call replays it: the inputs are copied
    into the graph's own, and nothing is read back to the host.  The
    optimizer must be built with ``capturable=True`` (its update is in the
    graph), and a capture that fails raises: there is no eager fallback.
    The graph reads and writes the parameters and the optimizer's state in
    place, so a call raises once either was replaced (for example by
    ``load_state_dict``: load before building, or copy into the state).
    Each replay adds the graph's kernel launches to the kernels' counts
    (``LAUNCHES`` of ``_fused``, ``_sample``, ``ops/_scatter`` and
    ``_shade``).  The
    graph is captured through the step's spans (``dibr.select``,
    ``dibr.render``, ``autograd.backward``, ``optim.step``; see
    :func:`~kaolin_tpu_torch.utils.profiler.span`; a DIB-R++ loss adds
    ``dibr.sg`` and ``dibr.sg_backward``), so every replay runs their 8
    (12) empty mark kernels, and a profiler's trace of the replays shows
    the phases on the card's timeline.

    On a CPU model each call runs the same step eagerly.  On either
    device, building takes ``_WARMUP`` eager steps and then puts the
    parameters and the optimizer's state back as they were.
    """
    return _CompiledStep(model, views, faces, face_uvs, target_images,
                         target_masks, height, width, optimizer,
                         _resolve_backend(backend), knum, loss_fn)


def _signature(tensors):
    return [(tuple(t.shape), t.dtype, t.device) for t in tensors]


@contextlib.contextmanager
def _state_kept(params, optimizer):
    """Within the block, steps may change ``params`` and the optimizer's
    state; after it both hold what they held before, in the same tensors.
    State that the block created is zeroed, which for Adam (whose state is
    tensors only) is a fresh state."""
    saved = [p.detach().clone() for p in params]
    state = {p: {k: v.clone() for k, v in optimizer.state[p].items()}
             for p in params if p in optimizer.state}
    yield
    with torch.no_grad():
        for p, v in zip(params, saved):
            p.copy_(v)
        for p in params:
            for k, v in optimizer.state.get(p, {}).items():
                if k in state.get(p, {}):
                    v.copy_(state[p][k])
                else:
                    v.zero_()


class _CompiledStep:
    """What :func:`compiled_step` returns."""

    def __init__(self, model, views, faces, face_uvs, target_images,
                 target_masks, height, width, optimizer, backend, knum,
                 loss_fn):
        self.model, self.optimizer = model, optimizer
        self._args = (faces, face_uvs, height, width, backend, knum)
        self._loss_fn = loss_fn or render_loss
        self._params = list(model.parameters())
        inputs = (*views, target_images, target_masks)
        self._signature = _signature(inputs)
        self.selection = self.graph = None
        side = None         # the warm-up's stream (None: the CPU's)
        if model.vertices.is_cuda:
            if not all(g.get('capturable') for g in optimizer.param_groups):
                raise ValueError(
                    'compiled_step captures the optimizer\'s update in a '
                    'CUDA graph: build the optimizer with capturable=True')
            # the graph's inputs, which each call copies into
            inputs = tuple(t.clone() for t in inputs)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), _state_kept(self._params, optimizer):
            for _ in range(_WARMUP):
                self._eager(inputs)
        if side is None:
            return
        torch.cuda.current_stream().wait_stream(side)
        for p in self._params:
            p.grad = None
        counts = [dict(c) for c in _COUNTS]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self._loss, self.selection = self._run(inputs)
        # a capture launches nothing: its launches are the replays'
        self._launches = [{k: c[k] - n for k, n in was.items()}
                          for c, was in zip(_COUNTS, counts)]
        for c, was in zip(_COUNTS, counts):
            c.update(was)
        self._inputs = inputs
        self._grads = [p.grad for p in self._params]
        self._bound = self._bindings()

    def _run(self, inputs):
        """selection -> loss -> backward -> optimizer step on ``inputs``
        (the views' three tensors, the target images and masks)."""
        faces, face_uvs, height, width, backend, knum = self._args
        views = CameraViews(*inputs[:3])
        sel = compute_selection(self.model, views, faces, height, width,
                                backend, knum=knum)
        loss = self._loss_fn(self.model, views, faces, face_uvs, inputs[3],
                             inputs[4], height, width, backend=backend,
                             selection=sel, knum=knum)
        device = self.model.vertices.device
        with span('autograd.backward', device):
            loss.backward()
        with span('optim.step', device):
            self.optimizer.step()
        return loss.detach(), sel

    def _eager(self, inputs):
        for p in self._params:
            p.grad = None
        loss, self.selection = self._run(inputs)
        return loss

    def _bindings(self):
        """Where the parameters and the optimizer's state tensors are."""
        return [(p.data_ptr(), *((k, v.data_ptr()) for k, v in sorted(
            self.optimizer.state.get(p, {}).items()))) for p in self._params]

    def __call__(self, views, target_images, target_masks):
        inputs = (*views, target_images, target_masks)
        if _signature(inputs) != self._signature:
            raise ValueError(
                f'compiled_step was built for views and targets '
                f'{self._signature}, got {_signature(inputs)}')
        if self.graph is None:
            return self._eager(inputs)
        if self._bindings() != self._bound:
            raise RuntimeError(
                'compiled_step: the parameters or the optimizer\'s state '
                'were replaced after the step was captured (load a state '
                'before building the step, or copy into it in place)')
        for dst, src in zip(self._inputs, inputs):
            dst.copy_(src)
        self.graph.replay()
        for c, launched in zip(_COUNTS, self._launches):
            for k, n in launched.items():
                c[k] += n
        for p, g in zip(self._params, self._grads):
            p.grad = g
        return self._loss.clone()
