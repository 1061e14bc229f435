"""OBJ/MTL mesh importer.

Port of ``kaolin_tpu/io/obj.py``; returns a
:class:`kaolin_tpu_torch.rep.SurfaceMesh` of tensors on the card unless
asked for another device.  Without materials the file goes through the
native tokenizer (:func:`kaolin_tpu_torch._native.parse_obj`, the JAX
package's ``csrc/obj_parser.cpp``), which rounds each decimal once,
straight to float32, and a given ``heterogeneous_mesh_handler`` then also
triangulates a mesh of quads.  With materials the parse is Python and
numpy, as in the JAX package.
"""

import os
import warnings

import numpy as np
import torch

from kaolin_tpu_torch import _native
from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.io.materials import (
    MaterialFileError, MaterialLoadError, MaterialNotFoundError, PBRMaterial,
    process_materials_and_assignments)
from kaolin_tpu_torch.io.utils import (
    NonHomogeneousMeshError, mesh_handler_naive_triangulate)
from kaolin_tpu_torch.rep.surface_mesh import SurfaceMesh

__all__ = [
    'ignore_error_handler',
    'skip_error_handler',
    'create_missing_materials_error_handler',
    'default_error_handler',
    'import_mesh',
    'load_mtl',
]


def ignore_error_handler(error, **kwargs):
    """Simply ignore errors."""
    pass


def skip_error_handler(error, **kwargs):
    """Raise a warning and skip."""
    warnings.warn(str(error) + ' - skipping', UserWarning)


def create_missing_materials_error_handler(error, **kwargs):
    """On missing material, return a default material dict so assignments
    are kept."""
    if isinstance(error, MaterialNotFoundError):
        warnings.warn(str(error) + ' - creating default material',
                      UserWarning)
        return {'Kd': np.full((3,), 0.5, dtype=np.float32)}
    skip_error_handler(error, **kwargs)


def default_error_handler(error, **kwargs):
    """Raise the error."""
    raise error


def flatten_feature(feature):
    """Flatten a list of per-face features into a single list."""
    if feature is None or len(feature) == 0:
        return None
    return [item for sublist in feature for item in sublist]


def _parse(path, error_handler):
    """One pass over the OBJ text: vertices, uvs, normals, per-face index
    lists, materials (``mtllib``) and ``usemtl`` face ranges."""
    vertices, uvs, normals = [], [], []
    faces, face_uvs_idx, face_normals_idx, counts = [], [], [], []
    mtl_materials = {}
    assignments = {}
    active = [None, 0]                  # material, first face of its range

    def close_range():
        if active[0] is not None and len(counts) > active[1]:
            assignments.setdefault(active[0], []).append(
                [active[1], len(counts)])
        active[1] = len(counts)

    with open(path, 'r', encoding='utf-8', errors='replace') as f:
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            key = tokens[0]
            if key == 'v':
                vertices.append([float(x) for x in tokens[1:4]])
            elif key == 'vt':
                uvs.append([float(x) for x in tokens[1:3]])
            elif key == 'vn':
                normals.append([float(x) for x in tokens[1:4]])
            elif key == 'f':
                counts.append(len(tokens) - 1)
                fidx, fuv, fn = [], [], []
                for corner in tokens[1:]:
                    parts = corner.split('/')
                    fidx.append(int(parts[0]))
                    if len(parts) > 1 and parts[1] != '':
                        fuv.append(int(parts[1]))
                    if len(parts) > 2 and parts[2] != '':
                        fn.append(int(parts[2]))
                faces.append(fidx)
                if fuv:
                    face_uvs_idx.append(fuv)
                if fn:
                    face_normals_idx.append(fn)
            elif key == 'usemtl':
                close_range()
                active[0] = ' '.join(tokens[1:])
            elif key == 'mtllib':
                mats = load_mtl(os.path.join(os.path.dirname(path),
                                             ' '.join(tokens[1:])),
                                error_handler)
                if mats:
                    mtl_materials.update(mats)
    close_range()
    return (vertices, uvs, normals, faces, face_uvs_idx, face_normals_idx,
            counts, mtl_materials, assignments)


def import_mesh(path, with_materials=False, with_normals=False,
                error_handler=None, heterogeneous_mesh_handler=None,
                triangulate=False, raw_materials=True, device=None):
    r"""Load an obj file as a single unbatched :class:`SurfaceMesh`.

    Args:
        path: path to the .obj file.
        with_materials: load .mtl materials and material_assignments.
        with_normals: load vertex normals.
        error_handler: handles material errors
            (default :func:`default_error_handler`: raise).
        heterogeneous_mesh_handler: handles non-triangular meshes
            (default: raise :class:`NonHomogeneousMeshError`).
        triangulate: fan-triangulate any polygon faces.
        raw_materials: if True materials are dicts of mtl values; else
            converted to :class:`PBRMaterial`.
        device: where the tensors go (default: the card, see
            :func:`~kaolin_tpu_torch._device.entry_device`).

    Returns:
        unbatched :class:`SurfaceMesh`, or None when the handler skips
        the mesh.
    """
    device = entry_device(device)
    if error_handler is None:
        error_handler = default_error_handler
    if heterogeneous_mesh_handler is None and triangulate:
        heterogeneous_mesh_handler = mesh_handler_naive_triangulate
    if not with_materials:
        return _mesh_from_native(_native.parse_obj(path), with_normals,
                                 heterogeneous_mesh_handler, path, device)

    (vertices, uvs, normals, faces, face_uvs_idx, face_normals_idx, counts,
     mtl_materials, assignments) = _parse(path, error_handler)
    vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)
    counts = np.asarray(counts, dtype=np.int64)
    uvs = np.asarray(uvs, dtype=np.float32).reshape(-1, 2) if uvs else None
    normals = (np.asarray(normals, dtype=np.float32).reshape(-1, 3)
               if normals else None)

    def fix_idx(flat, count):
        arr = np.asarray(flat, dtype=np.int64)
        return np.where(arr < 0, arr + count, arr - 1)

    feats = {'faces': fix_idx(flatten_feature(faces), len(vertices))}
    if face_uvs_idx:
        feats['face_uvs_idx'] = fix_idx(flatten_feature(face_uvs_idx),
                                        0 if uvs is None else len(uvs))
    if face_normals_idx and with_normals:
        feats['face_normals_idx'] = fix_idx(
            flatten_feature(face_normals_idx),
            0 if normals is None else len(normals))

    heterogeneous = counts.size > 0 and not (counts == counts[0]).all()
    if heterogeneous or (triangulate and counts.size > 0
                         and not (counts == 3).all()):
        if heterogeneous_mesh_handler is None:
            raise NonHomogeneousMeshError(
                f"Mesh at {path} is non-homogeneous and no "
                f"heterogeneous_mesh_handler was provided")
        ranges = ({k: np.asarray(v) for k, v in assignments.items()}
                  if assignments else None)
        result = heterogeneous_mesh_handler(vertices, counts,
                                            *feats.values(),
                                            face_assignments=ranges)
        if result is None:
            return None
        vertices = result[0]
        feats = {k: np.asarray(v).reshape(-1, 3)
                 for k, v in zip(feats, result[2:2 + len(feats)])}
        if ranges is not None:
            assignments = dict(result[-1])
    else:
        size = int(counts[0]) if counts.size else 3
        feats = {k: v.reshape(-1, size) for k, v in feats.items()}
        assignments = {k: np.asarray(v) for k, v in assignments.items()}

    materials, material_assignments = process_materials_and_assignments(
        mtl_materials, assignments, error_handler, feats['faces'].shape[0],
        error_context_str=path)
    if not raw_materials:
        materials = [_mtl_to_pbr(m, device) for m in materials]

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    kwargs = dict(vertices=t(vertices), faces=t(feats['faces']))
    if uvs is not None:
        kwargs['uvs'] = t(uvs)
    if 'face_uvs_idx' in feats:
        kwargs['face_uvs_idx'] = t(feats['face_uvs_idx'])
    if with_normals and normals is not None:
        kwargs['normals'] = t(normals)
        if 'face_normals_idx' in feats:
            kwargs['face_normals_idx'] = t(feats['face_normals_idx'])
    kwargs['material_assignments'] = t(material_assignments)
    return SurfaceMesh(materials=materials, batching=SurfaceMesh.Batching.NONE,
                       strict_checks=False, **kwargs)


def _mesh_from_native(parsed, with_normals, heterogeneous_mesh_handler, path,
                      device):
    """A SurfaceMesh on ``device`` from the native tokenizer's raw output,
    as the JAX package's ``_mesh_from_native`` assembles it: a given handler
    is called (without face assignments) on any non-triangle mesh."""
    vertices = parsed['vertices']
    uvs = parsed['uvs'] if parsed['uvs'].size else None
    normals = parsed['normals'] if parsed['normals'].size else None
    counts = parsed['face_counts']

    def fix(flat, count):
        return np.where(flat < 0, flat + count, flat - 1)

    feats = {'faces': fix(parsed['face_v'], len(vertices))}
    if uvs is not None and (parsed['face_vt'] != 0).any():
        feats['face_uvs_idx'] = fix(parsed['face_vt'], len(uvs))
    if (with_normals and normals is not None
            and (parsed['face_vn'] != 0).any()):
        feats['face_normals_idx'] = fix(parsed['face_vn'], len(normals))

    heterogeneous = counts.size > 0 and not (counts == counts[0]).all()
    if heterogeneous or (counts.size and counts[0] != 3
                         and heterogeneous_mesh_handler is not None):
        if heterogeneous_mesh_handler is None:
            raise NonHomogeneousMeshError(
                f"Mesh at {path} is non-homogeneous and no "
                f"heterogeneous_mesh_handler was provided")
        result = heterogeneous_mesh_handler(vertices, counts, *feats.values())
        if result is None:
            return None
        vertices, counts = result[0], result[1]
        feats = {k: np.asarray(v).reshape(-1)
                 for k, v in zip(feats, result[2:2 + len(feats)])}
    size = int(counts[0]) if counts.size else 3

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    kwargs = dict(vertices=t(vertices),
                  faces=t(feats['faces'].reshape(-1, size)))
    if uvs is not None:
        kwargs['uvs'] = t(uvs)
        if 'face_uvs_idx' in feats:
            kwargs['face_uvs_idx'] = t(feats['face_uvs_idx'].reshape(-1, size))
    if with_normals and normals is not None:
        kwargs['normals'] = t(normals)
        if 'face_normals_idx' in feats:
            kwargs['face_normals_idx'] = t(
                feats['face_normals_idx'].reshape(-1, size))
    return SurfaceMesh(batching=SurfaceMesh.Batching.NONE,
                       strict_checks=False, **kwargs)


def _mtl_to_pbr(mtl, device):
    """Convert a raw mtl dict to a PBRMaterial (textures on ``device``)."""
    if not isinstance(mtl, dict):
        return mtl
    kwargs = {}
    if 'Kd' in mtl:
        kwargs['diffuse_color'] = tuple(np.asarray(mtl['Kd']).tolist())
    if 'map_Kd' in mtl:
        tex = np.asarray(mtl['map_Kd']).astype(np.float32) / 255.
        kwargs['diffuse_texture'] = torch.as_tensor(
            tex, device=device).permute(2, 0, 1)
    return PBRMaterial(material_name=mtl.get('material_name', ''), **kwargs)


def load_mtl(mtl_path, error_handler=None):
    """Load a .mtl material library.

    Supports Kd / Ka / Ks values and map_Kd / map_Ka / map_Ks textures
    (loaded as uint8 HWC numpy arrays).

    Returns:
        dict of material name -> dict of properties.
    """
    if error_handler is None:
        error_handler = default_error_handler
    mtl_data = {}
    root_dir = os.path.dirname(mtl_path)

    try:
        f = open(mtl_path, 'r', encoding='utf-8', errors='replace')
    except Exception as e:
        error_handler(MaterialFileError(
            f"Failed to load material at path {mtl_path!r}:\n{e}"))
        return mtl_data
    with f:
        material_name = ''
        for line in f:
            tokens = line.split()
            if not tokens:
                continue
            key = tokens[0]
            if key == 'newmtl':
                material_name = ' '.join(tokens[1:])
                mtl_data[material_name] = {'material_name': material_name}
            elif material_name == '':
                continue
            elif key in ('map_Kd', 'map_Ka', 'map_Ks'):
                texture_path = os.path.join(root_dir, ' '.join(tokens[1:]))
                try:
                    from PIL import Image
                    img = np.asarray(Image.open(texture_path).convert('RGB'))
                    mtl_data[material_name][key] = img
                except Exception as e:
                    error_handler(MaterialLoadError(
                        f"Failed to load texture {texture_path!r} for "
                        f"material {material_name!r}:\n{e}"),
                        material_name=material_name)
            elif key in ('Kd', 'Ka', 'Ks'):
                mtl_data[material_name][key] = np.asarray(
                    [float(x) for x in tokens[1:4]], dtype=np.float32)
    return mtl_data
