"""The DIB-R per-pixel chain, face rows to loss terms, and its backward
(CUDA kernels in ``csrc/shade.cuh``).

From each pixel's selected face to the image L1 and silhouette IoU terms of
``models/inverse_render.py::render_loss``: the face's barycentric weights at
the pixel (``rasterization.py::_interpolate_selected_batched``), its
interpolated uv and normal, ``texture_mapping``'s clip, flip and bilinear
sample (E1's taps), SH9 lighting (``spherical_harmonic_lighting``), the
clips, the background mask, ``mean |image - target|`` and
``metrics/render.py::mask_iou`` of the soft mask.  The JAX package leaves
this chain (``kaolin_tpu/models/inverse_render.py:112-170``) to XLA, which
fuses it; the port runs it on the card as :class:`_ShadeLoss`, a
``torch.autograd.Function`` whose forward is ``shade_forward_kernel`` and a
fixed-order sum of its CTAs' partial sums, and whose backward recomputes the
chain in ``shade_backward_kernel`` and hands d albedo to E2
(:mod:`._sample`, the one texture read in place, every view's pixels as one
batch) and each pixel's 9 face-row gradients to E3
(:mod:`kaolin_tpu_torch.ops._scatter`).  The forward saves no per-pixel
temporaries.  The soft mask comes in as an input: its selection (K1) and
backward (K2) stay :func:`~kaolin_tpu_torch.render.mesh.dibr_soft_mask`'s.

:func:`shade_images` is the plain PyTorch composition of the images and
:func:`_shade_loss_torch` that of the loss terms: the CPU path and the
kernels' oracle.  :func:`shade_loss` runs the plain version for tensors on
the CPU and the kernels for tensors on a CUDA device; there is no fallback
between the two.  ``LAUNCHES`` counts launches: the wrappers add one where
they launch, and a replayed CUDA graph adds what it holds
(``models/inverse_render.py::compiled_step``).
"""

import torch

from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch.metrics.render import mask_iou
from kaolin_tpu_torch.ops import _scatter
from kaolin_tpu_torch.render.mesh import _sample
from kaolin_tpu_torch.render.mesh.rasterization import (
    _interpolate_selected_batched, pixel_coords)
from kaolin_tpu_torch.render.mesh.utils import (
    spherical_harmonic_lighting, texture_mapping)

__all__ = ['LAUNCHES', 'shade_images', 'shade_loss']

LAUNCHES = {'shade': 0, 'shade_bwd': 0}

# rasterize's coordinate scale and barycentric epsilon, which render_views
# and render_loss take
MULTIPLIER = 1000
EPS = 1e-8


def shade_images(face_idx, face_vertices_image, face_normals, face_uvs,
                 texture_map, sh_coeffs):
    """The textured, SH-lit DIB-R images of the selected faces (plain
    PyTorch, differentiable).

    Args:
        face_idx: (B, H, W) int winning face per pixel, -1 for background.
        face_vertices_image: (B, F, 3, 2) image-plane corners in [-1, 1].
        face_normals: (B, F, 3) face normals, every corner's normal.
        face_uvs: (F, 3, 2) corner uvs.
        texture_map: (3, TH, TW); sh_coeffs: (9,).

    Returns:
        (B, H, W, 3) images, 0 on the background.
    """
    B, F = face_vertices_image.shape[:2]
    H, W = face_idx.shape[1:]
    features = torch.cat(
        [face_uvs[None].expand((B,) + tuple(face_uvs.shape)),
         face_normals[:, :, None, :].expand(B, F, 3, 3)], dim=-1)
    xs, ys = pixel_coords(H, W, MULTIPLIER, dtype=face_vertices_image.dtype,
                          device=face_vertices_image.device)
    feats, _ = _interpolate_selected_batched(
        face_idx.detach(), face_vertices_image * MULTIPLIER, features, xs, ys,
        EPS)
    uv_map, normal_map = feats[..., 0:2], feats[..., 2:5]
    texture = texture_map[None].expand((B,) + tuple(texture_map.shape))
    albedo = texture_mapping(uv_map, texture, mode='bilinear')
    lighting = spherical_harmonic_lighting(normal_map,
                                           sh_coeffs[None].expand(B, 9))
    images = albedo * clip(lighting, 0.)[..., None]
    images = clip(images, 0., 1.)
    return torch.where((face_idx >= 0)[..., None], images, 0.)


def _shade_loss_torch(face_idx, face_vertices_image, face_normals, face_uvs,
                      texture_map, sh_coeffs, soft_mask, target_images,
                      target_masks):
    """The plain version: (``mean |image - target|``, ``mask_iou(soft_mask,
    target_masks)``), differentiable by autograd."""
    images = shade_images(face_idx, face_vertices_image, face_normals,
                          face_uvs, texture_map, sh_coeffs)
    return (torch.mean(torch.abs(images - target_images)),
            mask_iou(soft_mask, target_masks))


def _shade_forward_cuda(inputs, hw):
    """Launch the forward on ``inputs`` (the nine tensors of
    :class:`_ShadeLoss`, the texture as (TH * TW, 3) rows, ``hw`` = (TH,
    TW)): (image_loss, mask_loss, iou (B, 2): each view's IoU numerator and
    denominator)."""
    out = _cuda.load_module('epilogue').shade(
        *inputs, *hw, float(MULTIPLIER), EPS,
        _cuda.stream_getter()(inputs[0].get_device()))
    LAUNCHES['shade'] += 1
    return out


def _shade_backward_cuda(inputs, iou, g_image, g_mask, hw):
    """Launch the backward: (d albedo (Q, 3), texel x, y (Q,), face-row
    gradients (Q, 9), their rows (Q,) int32, d soft mask (B, H, W), d SH
    (9,)), Q = B * H * W; the rows' first 6 columns are the scaled
    corners', the last 3 the normal's."""
    out = _cuda.load_module('epilogue').shade_backward(
        *inputs, iou, g_image, g_mask, *hw, float(MULTIPLIER), EPS,
        _cuda.stream_getter()(inputs[0].get_device()))
    LAUNCHES['shade_bwd'] += 1
    return out


class _ShadeLoss(torch.autograd.Function):
    """The kernels' loss terms; gradients to the corners, the normals, the
    texture, the SH coefficients and the soft mask."""

    @staticmethod
    def forward(ctx, face_idx, face_vertices_image, face_normals, face_uvs,
                texture_map, sh_coeffs, soft_mask, target_images,
                target_masks):
        hw = tuple(texture_map.shape[1:])
        tex_rows = texture_map.permute(1, 2, 0).reshape(
            -1, texture_map.shape[0]).contiguous()
        inputs = tuple(t.contiguous() for t in (
            face_idx, face_vertices_image, face_normals, face_uvs, tex_rows,
            sh_coeffs, soft_mask, target_images, target_masks))
        image_loss, mask_loss, iou = _shade_forward_cuda(inputs, hw)
        ctx.save_for_backward(*inputs, iou)
        ctx.hw = hw
        return image_loss, mask_loss

    @staticmethod
    def backward(ctx, g_image, g_mask):
        *inputs, iou = ctx.saved_tensors
        hw = ctx.hw
        d_albedo, x, y, rows, ids, d_soft, d_sh = _shade_backward_cuda(
            inputs, iou, g_image.contiguous(), g_mask.contiguous(), hw)
        B, F = inputs[1].shape[:2]
        d_fvi = d_fn = d_tex = None
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            d_rows = _scatter._scatter_rows_cuda(rows, ids, B * F)
            d_fvi = (d_rows[:, :6] * MULTIPLIER).reshape(B, F, 3, 2)
            d_fn = d_rows[:, 6:].reshape(B, F, 3)
        if ctx.needs_input_grad[4]:
            # E2 with every view's pixels as one batch of the one texture
            dt = _sample._bilinear_backward_cuda(
                inputs[4], x, y, d_albedo, (*hw, 1, x.shape[0]))[0]
            d_tex = dt.reshape(*hw, 3).permute(2, 0, 1).contiguous()
        return None, d_fvi, d_fn, None, d_tex, d_sh, d_soft, None, None


def shade_loss(face_idx, face_vertices_image, face_normals, face_uvs,
               texture_map, sh_coeffs, soft_mask, target_images, target_masks):
    """The DIB-R loss terms (``mean |image - target|``, ``mask_iou``) of the
    images :func:`shade_images` makes and of ``soft_mask``: CPU tensors run
    the plain version, CUDA tensors the kernels (``face_idx`` int32, a
    3-channel texture).

    Args:
        as :func:`shade_images`; soft_mask: (B, H, W); target_images:
        (B, H, W, 3); target_masks: (B, H, W).

    Returns:
        (image_loss, mask_loss), 0-dim tensors.
    """
    device = face_vertices_image.device
    if device.type == 'cpu':
        return _shade_loss_torch(face_idx, face_vertices_image, face_normals,
                                 face_uvs, texture_map, sh_coeffs, soft_mask,
                                 target_images, target_masks)
    if device.type != 'cuda':
        raise ValueError(f'no DIB-R shading for device {device}')
    return _ShadeLoss.apply(face_idx.detach(), face_vertices_image,
                            face_normals, face_uvs, texture_map, sh_coeffs,
                            soft_mask, target_images, target_masks)
