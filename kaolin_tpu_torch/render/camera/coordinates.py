"""Common coordinate-system basis-change matrices.

Port of ``kaolin_tpu/render/camera/coordinates.py``.  The default world
coordinates are right handed, y up, z pointing out of the screen.
"""

import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['blender_coords', 'opengl_coords']


def blender_coords(device=None):
    """Blender world coords (right handed, z up) as a 3x3 int64 basis
    change, on ``device`` (default: the card)."""
    return torch.tensor([[1, 0, 0], [0, 0, 1], [0, -1, 0]],
                        device=entry_device(device))


def opengl_coords(device=None):
    """OpenGL world coords (right handed, y up: the default) as a 3x3
    int64 basis change, on ``device`` (default: the card)."""
    return torch.eye(3, dtype=torch.int64, device=entry_device(device))
