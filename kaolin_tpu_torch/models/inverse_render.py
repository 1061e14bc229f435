"""Flagship model: DIB-R textured inverse rendering.

Port of ``kaolin_tpu/models/inverse_render.py``: optimizable parameters
(vertex positions, UV texture, SH lighting) in an ``nn.Module`` plus the
render step.  A training step is :func:`compute_selection` (the
non-differentiable selection, under ``no_grad``: the fused engine's, or
with ``backend='jnp'`` the brute-force z-buffer and the soft mask's
k-buffer) followed by :func:`render_loss` and ``backward()``.
"""

import math
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.metrics.render import mask_iou
from kaolin_tpu_torch.render import camera as camera_fns
from kaolin_tpu_torch.render import mesh as mesh_render
from kaolin_tpu_torch.render.mesh.rasterization import _resolve_backend

__all__ = ['InverseRender', 'CameraViews', 'make_views', 'render_views',
           'render_loss', 'init_params', 'compute_selection',
           'from_jax_params']


class InverseRender(nn.Module):
    """Optimizable parameters of the inverse-rendering model."""

    def __init__(self, vertices, texture_map, sh_coeffs):
        super().__init__()
        self.vertices = nn.Parameter(vertices)          # (V, 3)
        self.texture_map = nn.Parameter(texture_map)    # (3, TH, TW)
        self.sh_coeffs = nn.Parameter(sh_coeffs)        # (9,)


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
                      boxlen=0.02, knum=30, sigmainv=7000.):
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
    with torch.no_grad():
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


def render_views(params, views, faces, face_uvs, height, width,
                 backend='auto', sigmainv=7000., with_soft_mask=True,
                 selection=None, knum=30):
    """Render all views: textured DIB-R + SH lighting.

    prepare_vertices -> rasterize(uvs, normals) -> texture_mapping +
    spherical_harmonic_lighting -> soft mask.

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
    B = views.camera_rot.shape[0]
    face_vertices_camera, face_vertices_image, face_normals = \
        _prepare(params, views, faces)
    face_uvs_b = face_uvs[None].expand((B,) + tuple(face_uvs.shape))
    face_normals_corner = face_normals[:, :, None, :].expand(
        tuple(face_normals.shape[:2]) + (3, 3))
    (uv_map, normal_map), face_idx = mesh_render.rasterize(
        height, width, face_vertices_camera[..., 2],
        face_vertices_image, [face_uvs_b, face_normals_corner],
        valid_faces=face_normals[..., 2] >= 0., backend=backend,
        precomputed_face_idx=selection[0])
    texture = params.texture_map[None].expand(
        (B,) + tuple(params.texture_map.shape))
    albedo = mesh_render.texture_mapping(uv_map, texture, mode='bilinear')
    lighting = mesh_render.spherical_harmonic_lighting(
        normal_map, params.sh_coeffs[None].expand(B, 9))
    images = albedo * clip(lighting, 0.)[..., None]
    images = clip(images, 0., 1.)
    images = torch.where((face_idx >= 0)[..., None], images, 0.)
    if with_soft_mask:
        soft_mask = mesh_render.dibr_soft_mask(
            face_vertices_image, face_idx, sigmainv=sigmainv, knum=knum,
            kbuf=selection[1])
    else:
        soft_mask = (face_idx >= 0).to(images.dtype)
    return images, soft_mask, face_idx


def render_loss(params, views, faces, face_uvs, target_images, target_masks,
                height, width, backend='auto', with_soft_mask=True,
                selection=None, knum=30):
    """Image L1 + silhouette IoU loss."""
    images, soft_mask, _ = render_views(
        params, views, faces, face_uvs, height, width, backend=backend,
        with_soft_mask=with_soft_mask, selection=selection, knum=knum)
    image_loss = torch.mean(torch.abs(images - target_images))
    mask_loss = mask_iou(soft_mask, target_masks)
    return image_loss + mask_loss
