"""Render utilities: texture mapping, SH lighting (legacy), vertex prep.

Port of ``kaolin_tpu/render/mesh/utils.py``.  The TPU package samples
textures with hand-written flat-row gathers and an MXU texture gradient;
here bilinear sampling is ``grid_sample`` with its own backward, and
nearest sampling is plain advanced indexing.
"""

import torch
import torch.nn.functional as F

from kaolin_tpu_torch.render import camera as _camera
from kaolin_tpu_torch.ops import mesh as _mesh_ops

__all__ = ['texture_mapping', 'spherical_harmonic_lighting',
           'prepare_vertices']


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
    uv = torch.clamp(uv, 0., 1.)
    uv = uv * 2. - 1.
    cx = uv[..., 0]
    cy = -uv[..., 1]  # flip y
    if mode == 'bilinear':
        grid = torch.stack([cx, cy], dim=-1)[:, None]      # (B, 1, P, 2)
        out = F.grid_sample(texture_maps, grid, mode='bilinear',
                            padding_mode='border', align_corners=False)
        out = out[:, :, 0].transpose(1, 2)                  # (B, P, C)
    elif mode == 'nearest':
        # floor(x + 0.5), as the JAX package rounds (grid_sample's nearest
        # rounds half to even)
        x = (cx + 1.) * TW / 2. - 0.5
        y = (cy + 1.) * TH / 2. - 0.5
        xi = torch.clamp(torch.floor(x + 0.5).long(), 0, TW - 1)
        yi = torch.clamp(torch.floor(y + 0.5).long(), 0, TH - 1)
        bidx = torch.arange(batch_size, device=uv.device)[:, None]
        out = texture_maps.permute(0, 2, 3, 1)[bidx, yi, xi]  # (B, P, C)
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
