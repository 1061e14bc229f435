"""USD material export/import (UsdPreviewSurface-style attributes).

Port of ``kaolin_tpu/io/usd/materials.py``, on the self-contained USDA
codec.  Textures are written as PNG files next to the stage and read back
as ``(C, H, W)`` float32 tensors on the card unless asked for another
device.
"""

import os

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.io.usd.mesh import (_check_text_usd, _np, _open_stage,
                                          create_stage)

__all__ = ['export_material', 'import_material']

_VALUE_ATTRS = [
    'diffuse_color', 'roughness_value', 'metallic_value', 'clearcoat_value',
    'clearcoat_roughness_value', 'opacity_value', 'opacity_threshold',
    'ior_value', 'specular_color', 'displacement_value',
]
_TEXTURE_ATTRS = [
    'diffuse_texture', 'roughness_texture', 'metallic_texture',
    'clearcoat_texture', 'clearcoat_roughness_texture', 'opacity_texture',
    'ior_texture', 'specular_texture', 'normals_texture',
    'displacement_texture',
]


def export_material(material, file_path, scene_path='/World/Looks/material_0',
                    bound_prims=None, time=None, texture_dir='',
                    texture_file_prefix=''):
    """Write a PBRMaterial to a USD(A) Material prim; textures are saved as
    PNG files next to the stage."""
    _check_text_usd(file_path)
    stage = (_open_stage(file_path) if os.path.exists(file_path)
             else create_stage(file_path))
    prim = stage.define_prim(scene_path, 'Material')
    prim.attrs['info:id'] = 'UsdPreviewSurface'
    prim.attrs['material_name'] = getattr(material, 'material_name', '')
    prim.attrs['is_specular_workflow'] = bool(
        getattr(material, 'is_specular_workflow', False))
    for name in _VALUE_ATTRS:
        val = getattr(material, name, None)
        if val is None:
            continue
        arr = _np(val, np.float32)
        prim.attrs[name] = (float(arr) if arr.ndim == 0
                            else arr.reshape(-1))
    base_dir = os.path.dirname(os.path.abspath(file_path))
    tex_dir = os.path.join(base_dir, texture_dir) if texture_dir else base_dir
    os.makedirs(tex_dir, exist_ok=True)
    for name in _TEXTURE_ATTRS:
        tex = getattr(material, name, None)
        if tex is None:
            continue
        from PIL import Image
        arr = _np(tex)
        if arr.ndim == 3:  # (C, H, W) -> (H, W, C)
            arr = np.moveaxis(arr, 0, -1)
        img = np.clip(arr * 255., 0, 255).astype(np.uint8)
        if img.shape[-1] == 1:
            img = img[..., 0]
        fname = f'{texture_file_prefix}{name}.png'
        Image.fromarray(img).save(os.path.join(tex_dir, fname))
        rel = os.path.join(texture_dir, fname) if texture_dir else fname
        prim.attrs[f'{name}_file'] = rel
    stage.save(file_path)
    return stage


def import_material(file_path, scene_path, texture_path=None, time=None,
                    device=None):
    """Read a Material prim back into a PBRMaterial, its textures on
    ``device`` (default: the card)."""
    from kaolin_tpu_torch.io.materials import PBRMaterial
    device = entry_device(device)
    stage = _open_stage(file_path)
    prim = stage.get_prim(scene_path)
    if prim is None or prim.type_name != 'Material':
        raise ValueError(f'no Material prim at {scene_path!r}')
    kwargs = {}
    for name in _VALUE_ATTRS:
        if name in prim.attrs:
            arr = np.asarray(prim.attrs[name], dtype=np.float32)
            kwargs[name] = (tuple(arr.tolist()) if arr.ndim else float(arr))
    mat = PBRMaterial(
        material_name=str(prim.attrs.get('material_name', '')),
        is_specular_workflow=bool(prim.attrs.get('is_specular_workflow',
                                                 False)),
        **kwargs)
    base_dir = texture_path or os.path.dirname(os.path.abspath(file_path))
    for name in _TEXTURE_ATTRS:
        key = f'{name}_file'
        if key in prim.attrs:
            from PIL import Image
            img = np.asarray(Image.open(
                os.path.join(base_dir, str(prim.attrs[key]))))
            arr = img.astype(np.float32) / 255.
            if arr.ndim == 2:
                arr = arr[None]
            else:
                arr = np.moveaxis(arr, -1, 0)
            setattr(mat, name, torch.as_tensor(np.ascontiguousarray(arr),
                                               device=device))
    return mat
