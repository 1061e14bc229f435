"""OFF mesh importer.

Port of ``kaolin_tpu/io/off.py``: host-side parsing in Python, as in the
JAX package; the arrays go to the card unless asked for another device.
"""

from collections import namedtuple

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['import_mesh', 'return_type']

return_type = namedtuple('return_type', ['vertices', 'faces', 'face_colors'])


def _is_void(data):
    return len(data) == 0 or data[0].startswith('#')


def import_mesh(path, with_face_colors=False, device=None):
    """Load an OFF file as a single mesh (handles the ModelNet40 "OFFn m"
    header quirk).

    Args:
        path: path to the .off file.
        with_face_colors: also read the faces' colours.
        device: where the tensors go (default: the card, see
            :func:`~kaolin_tpu_torch._device.entry_device`).

    Returns:
        namedtuple of (vertices (V, 3) float32, faces (F, fsize) int64,
        face_colors (F, 3) int64 or None).
    """
    device = entry_device(device)
    vertices = []
    with open(path, 'r', encoding='utf-8') as f:
        num_vertices = num_faces = None
        for line in f:
            data = line.split()
            if _is_void(data):
                continue
            if data[0].startswith('OFF'):
                if len(data[0][3:]) > 0:  # "OFF123 456" (ModelNet40 quirk)
                    num_vertices = int(data[0][3:])
                    num_faces = int(data[1])
                    break
                elif len(data) > 1:
                    num_vertices = int(data[1])
                    num_faces = int(data[2])
                    break
                continue
            num_vertices = int(data[0])
            num_faces = int(data[1])
            break
        for line in f:
            data = line.split()
            if _is_void(data):
                continue
            vertices.append([float(d) for d in data[:3]])
            if len(vertices) == num_vertices:
                break
        faces = []
        face_colors = [] if with_face_colors else None
        for line in f:
            data = line.split()
            if _is_void(data):
                continue
            fsize = int(data[0])
            faces.append([int(d) for d in data[1:1 + fsize]])
            if with_face_colors:
                face_colors.append([int(d)
                                    for d in data[1 + fsize:4 + fsize]])
            if len(faces) == num_faces:
                break

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype=dtype), device=device)

    vertices = t(vertices, np.float32)
    faces = t(faces, np.int64)
    if with_face_colors:
        face_colors = t(face_colors, np.int64)
    return return_type(vertices, faces, face_colors)
