"""Render utilities: texture mapping, SH lighting (legacy), vertex prep.

Port of ``kaolin_tpu/render/mesh/utils.py``.  Texture sampling follows the
JAX package: the batch folded into flat rows of a channels-last texture
table, nearest sampling through :func:`~kaolin_tpu_torch.ops.gather.
gather_rows` and bilinear sampling through :func:`_bilinear_sample`, whose
forward and hand-written backward are the kernels E1 and E2 on the card
(:mod:`._sample`).
"""

import torch
import torch.nn.functional as F

from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch.ops import mesh as _mesh_ops
from kaolin_tpu_torch.ops.gather import gather_rows
from kaolin_tpu_torch.render import camera as _camera
from kaolin_tpu_torch.render.mesh import _sample
from kaolin_tpu_torch.render.mesh._sample import _flat_corner_idx  # noqa

__all__ = ['texture_mapping', 'spherical_harmonic_lighting',
           'prepare_vertices']


class _BilinearSample(torch.autograd.Function):
    """E1 forward, E2 backward (dT, dx, dy); no gradient to ``hw``."""

    @staticmethod
    def forward(ctx, tex_rows, x, y, hw):
        # the kernels take contiguous rows; a one-view texture's rows are a
        # strided view of its (C, H, W) map
        tex_rows, x, y = (t.contiguous() for t in (tex_rows, x, y))
        ctx.hw = hw
        ctx.save_for_backward(tex_rows, x, y)
        return _sample._bilinear_forward(tex_rows, x, y, hw)

    @staticmethod
    def backward(ctx, g):
        tex_rows, x, y = ctx.saved_tensors
        dt, dx, dy = _sample._bilinear_backward(tex_rows, x, y,
                                                g.contiguous(), ctx.hw)
        return dt, dx, dy, None


def _bilinear_sample(tex_rows, x, y, hw):
    """Bilinear sample of a channels-last texture table.

    tex_rows: (B*H*W, C); x, y: (B*P,) pixel coords (border-padded via
    index clipping, each corner on its own; align_corners=False
    unnormalization done by caller).  ``hw`` = (H, W, B, P).

    The backward is hand-written, as the JAX package's: dT by a sum over
    each texel's taps in a fixed order (no atomics on the card), dx and dy
    through the lerp weights.  At a texel centre x = 0 the taps are texels
    0 and 1, so dx = v1 - v0 (the derivative from inside the texture).
    """
    return _BilinearSample.apply(tex_rows, x, y, hw)


def texture_mapping(texture_coordinates, texture_maps, mode='nearest'):
    """Sample texture maps at (OpenGL-convention) uv coordinates.

    uvs are clamped to [0, 1], y is flipped (OpenGL bottom-up -> image
    top-down), then sampled with border padding and align_corners=False.

    Args:
        texture_coordinates: ``(B, h, w, 2)`` or ``(B, N, 2)`` uvs in [0,1].
        texture_maps: ``(B, C, h', w')``.
        mode: 'nearest' or 'bilinear'.

    Returns:
        ``(B, h, w, C)`` or ``(B, N, C)`` sampled features.
    """
    batch_size = texture_coordinates.shape[0]
    num_channels = texture_maps.shape[1]
    TH, TW = texture_maps.shape[2:]
    lead_shape = tuple(texture_coordinates.shape[1:-1])
    uv = texture_coordinates.reshape(batch_size, -1, 2)
    P = uv.shape[1]
    uv = clip(uv, 0., 1.)
    uv = uv * 2. - 1.
    cx = uv[..., 0].reshape(-1)
    cy = -uv[..., 1].reshape(-1)  # flip y
    # unnormalize (align_corners=False); the batch folded into flat row ids
    x = (cx + 1.) * TW / 2. - 0.5
    y = (cy + 1.) * TH / 2. - 0.5
    tex_rows = texture_maps.permute(0, 2, 3, 1).reshape(
        batch_size * TH * TW, num_channels)
    if mode == 'nearest':
        # floor(x + 0.5), as the JAX package rounds
        xi = torch.clamp(torch.floor(x + 0.5).to(torch.int32), 0, TW - 1)
        yi = torch.clamp(torch.floor(y + 0.5).to(torch.int32), 0, TH - 1)
        boff = torch.arange(batch_size, dtype=torch.int32,
                            device=x.device).repeat_interleave(P) * (TH * TW)
        out = gather_rows(tex_rows, boff + yi * TW + xi)
    elif mode == 'bilinear':
        out = _bilinear_sample(tex_rows, x, y, (TH, TW, batch_size, P))
    else:
        raise ValueError(f"unsupported mode {mode!r}")
    return out.reshape((batch_size,) + lead_shape + (num_channels,))


def spherical_harmonic_lighting(imnormal, lights):
    """Per-pixel SH9 lighting effect.

    Args:
        imnormal: ``(B, H, W, 3)`` per-pixel normals.
        lights: ``(B, 9)`` SH coefficients.

    Returns:
        ``(B, H, W)`` lighting effect.
    """
    x = imnormal[..., 0]
    y = imnormal[..., 1]
    z = imnormal[..., 2]
    bands = torch.stack([
        0.28209479177 * torch.ones_like(x),
        0.4886025119 * x,
        0.4886025119 * z,
        0.4886025119 * y,
        1.09254843059 * (x * y),
        1.09254843059 * (y * z),
        0.94617469575 * (z * z) - 0.31539156525,
        0.77254840404 * (x * z),
        0.38627420202 * (x * x - y * y)], dim=-1)
    return torch.sum(bands * lights.reshape(-1, 1, 1, 9), dim=-1)


def prepare_vertices(vertices, faces, camera_proj, camera_rot=None,
                     camera_trans=None, camera_transform=None):
    """Transform + project vertices, index by faces, compute face normals.

    Returns:
        (face_vertices_camera ``(B, F, 3, 3)``,
         face_vertices_image ``(B, F, 3, 2)``,
         face_normals ``(B, F, 3)``).
    """
    if camera_transform is None:
        if camera_trans is None or camera_rot is None:
            raise ValueError(
                "camera_transform or camera_trans and camera_rot must be "
                "defined")
        vertices_camera = _camera.rotate_translate_points(
            vertices, camera_rot, camera_trans)
    else:
        if camera_trans is not None or camera_rot is not None:
            raise ValueError(
                "camera_trans and camera_rot must be None when "
                "camera_transform is defined")
        padded = F.pad(vertices, (0, 1), value=1.)
        vertices_camera = padded @ camera_transform
    vertices_image = _camera.perspective_camera(vertices_camera, camera_proj)
    face_vertices_camera = _mesh_ops.index_vertices_by_faces(
        vertices_camera, faces)
    face_vertices_image = _mesh_ops.index_vertices_by_faces(
        vertices_image, faces)
    face_normals = _mesh_ops.face_normals(face_vertices_camera, unit=True)
    return face_vertices_camera, face_vertices_image, face_normals
