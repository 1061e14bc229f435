"""Import synthetic sensor views (Omniverse Kaolin App data generator).

Port of ``kaolin_tpu/io/render.py``.  PNGs are read through PIL, imported
only when a PNG is read; ``.npy`` sensors and the metadata JSON need
numpy alone.
"""

import json
import math
import os

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.render.camera.legacy import (
    generate_perspective_projection)

__all__ = ['import_synthetic_view']


def import_synthetic_view(root_dir, idx, rgb=True, depth_linear=False,
                          semantic=False, instance=False, normals=False,
                          bbox_2d_tight=False, bbox_2d_loose=False,
                          device=None):
    """Import one view of synthetic sensor data (RGB / depth / semantic /
    instance / normals + camera metadata json), as the JAX package's
    ``import_synthetic_view``, with every tensor on ``device`` (default:
    the card, see :func:`~kaolin_tpu_torch._device.entry_device`).

    Returns:
        dict of selected sensors (None where the file is absent) plus
        'metadata' (cam_transform (4, 3), asset_transforms, cam_proj
        (3, 1), clipping_range).
    """
    device = entry_device(device)
    output = {}

    def _import_npy(cat):
        path = os.path.join(root_dir, f'{idx}_{cat}.npy')
        output[cat] = (torch.as_tensor(np.load(path), device=device)
                       if os.path.exists(path) else None)

    def _import_png(cat):
        path = os.path.join(root_dir, f'{idx}_{cat}.png')
        if os.path.exists(path):
            from PIL import Image
            arr = np.array(Image.open(path))[:, :, :3]
            output[cat] = torch.as_tensor(
                arr.astype(np.float32) / 255., device=device)
        else:
            output[cat] = None

    if rgb:
        _import_png('rgb')
    if depth_linear:
        _import_npy('depth_linear')
    if semantic:
        _import_npy('semantic')
    if instance:
        _import_npy('instance')
    if normals:
        _import_png('normals')

    with open(os.path.join(root_dir, f'{idx}_metadata.json'), 'r') as f:
        fmetadata = json.load(f)
    asset_transforms = torch.as_tensor(
        np.asarray(fmetadata['asset_transforms'][0][1], dtype=np.float32),
        device=device)
    cam_transform = torch.as_tensor(
        np.asarray(fmetadata['camera_properties']['tf_mat'],
                   dtype=np.float32), device=device)
    aspect_ratio = (fmetadata['camera_properties']['resolution']['width'] /
                    fmetadata['camera_properties']['resolution']['height'])
    focal_length = fmetadata['camera_properties']['focal_length']
    horizontal_aperture = \
        fmetadata['camera_properties']['horizontal_aperture']
    fov = 2 * math.atan(horizontal_aperture / (2 * focal_length))
    output['metadata'] = {
        'cam_transform': cam_transform[:, :3],
        'asset_transforms': asset_transforms,
        'cam_proj': generate_perspective_projection(fov, aspect_ratio,
                                                    device=device),
        'clipping_range': fmetadata['camera_properties']['clipping_range'],
    }
    if bbox_2d_tight:
        output['bbox_2d_tight'] = fmetadata['bbox_2d_tight']
    if bbox_2d_loose:
        output['bbox_2d_loose'] = fmetadata['bbox_2d_loose']
    return output
