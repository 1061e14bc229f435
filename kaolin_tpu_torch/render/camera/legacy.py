"""Legacy functional camera API (used by the DIB-R pipeline).

Port of ``kaolin_tpu/render/camera/legacy.py``.
"""

from math import tan

import torch

from kaolin_tpu_torch._device import entry_device

__all__ = [
    'rotate_translate_points',
    'generate_rotate_translate_matrices',
    'generate_transformation_matrix',
    'perspective_camera',
    'generate_perspective_projection',
]


def rotate_translate_points(points, camera_rot, camera_trans):
    """``P_new = R @ (P_old - T)``.

    Args:
        points: ``(B, N, 3)``.
        camera_rot: ``(B, 3, 3)``.
        camera_trans: ``(B, 3)`` or ``(B, 3, 1)``.

    Returns:
        ``(B, N, 3)``.
    """
    translated = points - camera_trans.reshape(-1, 1, 3)
    return torch.matmul(translated, camera_rot.transpose(1, 2))


def generate_rotate_translate_matrices(camera_position, look_at,
                                       camera_up_direction):
    """Camera rotation + translation for ``P_cam = R @ (P_world - T)``.

    Returns:
        (rot ``(B, 3, 3)``, trans ``(B, 3)``).
    """
    camz = look_at - camera_position
    camz = camz / (torch.linalg.norm(camz, dim=1, keepdim=True) + 1e-10)
    B = max(camz.shape[0], camera_up_direction.shape[0])
    camz = camz.expand(B, 3)
    up = camera_up_direction.expand(B, 3)
    camx = torch.linalg.cross(camz, up, dim=1)
    camx = camx / (torch.linalg.norm(camx, dim=1, keepdim=True) + 1e-10)
    camy = torch.linalg.cross(camx, camz, dim=1)
    camy = camy / (torch.linalg.norm(camy, dim=1, keepdim=True) + 1e-10)
    mtx = torch.stack([camx, camy, -camz], dim=1)
    return mtx, camera_position


def generate_transformation_matrix(camera_position, look_at,
                                   camera_up_direction):
    """(B, 4, 3) matrix for ``P_cam = [P_world | 1] @ M``."""
    z_axis = camera_position - look_at
    z_axis = z_axis / torch.linalg.norm(z_axis, dim=1, keepdim=True)
    B = max(z_axis.shape[0], camera_up_direction.shape[0])
    z_axis = z_axis.expand(B, 3)
    up = camera_up_direction.expand(B, 3)
    x_axis = torch.linalg.cross(up, z_axis, dim=1)
    x_axis = x_axis / torch.linalg.norm(x_axis, dim=1, keepdim=True)
    y_axis = torch.linalg.cross(z_axis, x_axis, dim=1)
    rot_part = torch.stack([x_axis, y_axis, z_axis], dim=2)
    trans_part = camera_position[:, None] @ rot_part
    return torch.cat([rot_part, -trans_part], dim=1)


def perspective_camera(points, camera_proj):
    """Project camera-space 3D points to 2D image coords (divide by ``-z``).

    Args:
        points: ``(B, N, 3)`` camera-space points.
        camera_proj: ``(3, 1)`` projection vector (z entry -1).

    Returns:
        ``(B, N, 2)``.
    """
    projected = points * camera_proj.reshape(-1, 1, 3)
    return projected[:, :, :2] / projected[:, :, 2:3]


def generate_perspective_projection(fovyangle, ratio=1.0,
                                    dtype=torch.float32, device=None):
    """(3, 1) perspective projection vector for :func:`perspective_camera`,
    on ``device`` (default: the card)."""
    tanfov = tan(fovyangle / 2.0)
    return torch.tensor([[1.0 / (ratio * tanfov)], [1.0 / tanfov], [-1]],
                        dtype=dtype, device=entry_device(device))
