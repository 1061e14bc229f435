"""USD mesh import/export.

Port of ``kaolin_tpu/io/usd/mesh.py`` on the self-contained USDA codec
(:mod:`kaolin_tpu_torch.io.usd.usda`).  Writers take tensors on any device
(or numpy arrays) and write the same text as the JAX package for the same
values; importers return :class:`~kaolin_tpu_torch.rep.SurfaceMesh` of
tensors on the card unless asked for another device.  Binary
``.usd/.usdc`` files require ``usd-core`` (raises a clear error when
absent).
"""

import os
import re

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.io.usd.usda import UsdaStage, TimeSampled
from kaolin_tpu_torch.io.utils import NonHomogeneousMeshError, \
    mesh_handler_naive_triangulate
from kaolin_tpu_torch.rep.surface_mesh import SurfaceMesh

__all__ = [
    'import_mesh', 'import_meshes', 'add_mesh', 'export_mesh',
    'export_meshes', 'create_stage', 'get_scene_paths',
    'get_raw_mesh_prim_geometry', 'get_mesh_prim_materials',
    'get_uvmap_primvar', 'get_face_uvs_idx', 'get_face_normals',
]


def _np(x, dtype=None):
    """A host numpy copy of a tensor (any device) or array-like."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=dtype)


def _check_text_usd(path):
    if path.endswith(('.usd', '.usdc')):
        try:
            import pxr  # noqa: F401
        except ImportError:
            raise ImportError(
                "Binary .usd/.usdc files require the optional usd-core "
                "package; export/import .usda (ASCII) instead, which is "
                "natively supported.")


def create_stage(file_path, up_axis='Y'):
    """Create a new USD stage."""
    stage = UsdaStage()
    stage.metadata['upAxis'] = up_axis
    stage._file_path = file_path
    return stage


def _open_stage(file_path):
    _check_text_usd(file_path)
    if os.path.exists(file_path):
        stage = UsdaStage.load(file_path)
    else:
        stage = UsdaStage()
    stage._file_path = file_path
    return stage


def _stage(file_path_or_stage):
    return (file_path_or_stage if isinstance(file_path_or_stage, UsdaStage)
            else _open_stage(file_path_or_stage))


def _setter(prim, time):
    """set_attr(name, value): a plain value, or a time sample at ``time``."""
    def set_attr(name, value):
        if time is None:
            prim.attrs[name] = value
        else:
            if not isinstance(prim.attrs.get(name), TimeSampled):
                prim.attrs[name] = TimeSampled()
            prim.attrs[name][float(time)] = value
    return set_attr


def _sample(v, time):
    """The value of an attribute at ``time``: the exact sample when there
    is one, else the first sample."""
    if isinstance(v, TimeSampled):
        key = (float(time) if time is not None and float(time) in v
               else sorted(v.keys())[0])
        return v[key]
    return v


def get_scene_paths(file_path_or_stage, scene_path_regex=None,
                    prim_types=None):
    """List prim paths in a USD file."""
    stage = _stage(file_path_or_stage)
    if isinstance(prim_types, str):
        prim_types = [prim_types]
    out = []
    for prim in stage.prims():
        if prim_types is not None and prim.type_name not in prim_types:
            continue
        if scene_path_regex is not None and not re.search(
                scene_path_regex, prim.path):
            continue
        out.append(prim.path)
    return out


def add_mesh(stage, scene_path, vertices=None, faces=None, uvs=None,
             face_uvs_idx=None, face_normals=None, time=None):
    """Add (or time-sample) a mesh prim on a stage."""
    prim = stage.define_prim(scene_path, 'Mesh')
    set_attr = _setter(prim, time)
    if faces is not None:
        faces_np = _np(faces)
        set_attr('faceVertexCounts',
                 np.full((faces_np.shape[0],), faces_np.shape[1],
                         dtype=np.int64))
        set_attr('faceVertexIndices', faces_np.reshape(-1))
    if vertices is not None:
        set_attr('points', _np(vertices, np.float32))
    if uvs is not None:
        set_attr('primvars:st', _np(uvs, np.float32))
    if face_uvs_idx is not None:
        set_attr('primvars:st:indices', _np(face_uvs_idx).reshape(-1))
    if face_normals is not None:
        set_attr('normals', _np(face_normals, np.float32).reshape(-1, 3))
    return prim


def export_mesh(file_path, scene_path='/World/Meshes/mesh_0', vertices=None,
                faces=None, uvs=None, face_uvs_idx=None, face_normals=None,
                up_axis='Y', time=None, **kwargs):
    """Export a single mesh to USD(A)."""
    return export_meshes(file_path, [scene_path],
                         [vertices], [faces],
                         uvs=[uvs], face_uvs_idx=[face_uvs_idx],
                         face_normals=[face_normals], up_axis=up_axis,
                         times=None if time is None else [time])


def export_meshes(file_path, scene_paths=None, vertices=None, faces=None,
                  uvs=None, face_uvs_idx=None, face_normals=None,
                  up_axis='Y', times=None):
    """Export multiple meshes to one USD(A) file (added to the file's
    stage when it exists)."""
    _check_text_usd(file_path)
    if os.path.exists(file_path):
        stage = _open_stage(file_path)
    else:
        stage = create_stage(file_path, up_axis)
    n = len(vertices)
    if scene_paths is None:
        scene_paths = [f'/World/Meshes/mesh_{i}' for i in range(n)]

    def get(lst, i):
        return None if lst is None else lst[i]

    for i, sp in enumerate(scene_paths):
        add_mesh(stage, sp, get(vertices, i), get(faces, i), get(uvs, i),
                 get(face_uvs_idx, i), get(face_normals, i),
                 time=None if times is None else times[i])
    stage.save(file_path)
    return stage


def _prim_to_mesh(prim, time, triangulate, heterogeneous_mesh_handler,
                  device):
    def get_attr(name):
        v = prim.attrs.get(name)
        if isinstance(v, TimeSampled):
            if time is not None and float(time) in v:
                return v[float(time)]
            key = sorted(v.keys())[0] if time is None else min(
                v.keys(), key=lambda t: abs(t - float(time)))
            return v[key]
        return v

    def t(a):
        return torch.as_tensor(np.asarray(a), device=device)

    pts = get_attr('points')
    counts = get_attr('faceVertexCounts')
    indices = get_attr('faceVertexIndices')
    uvs = get_attr('primvars:st')
    uv_idx = get_attr('primvars:st:indices')
    vertices = (np.asarray(pts, dtype=np.float32) if pts is not None
                else np.zeros((0, 3), np.float32))
    if counts is None or indices is None:
        return SurfaceMesh(vertices=t(vertices),
                           faces=torch.zeros((0, 3), dtype=torch.int64,
                                             device=device),
                           strict_checks=False)
    counts = np.asarray(counts, dtype=np.int64)
    indices = np.asarray(indices, dtype=np.int64)
    handler = heterogeneous_mesh_handler
    if triangulate and handler is None:
        handler = mesh_handler_naive_triangulate
    if counts.size and not (counts == counts[0]).all() or \
            (triangulate and counts.size and counts[0] != 3):
        if handler is None:
            raise NonHomogeneousMeshError(
                f'mesh at {prim.path} is non-homogeneous')
        features = [indices]
        if uv_idx is not None:
            features.append(np.asarray(uv_idx, dtype=np.int64))
        result = handler(vertices, counts, *features)
        if result is None:
            return None
        vertices, counts = result[0], result[1]
        indices = result[2]
        if uv_idx is not None:
            uv_idx = result[3]
    fsize = int(counts[0]) if counts.size else 3
    faces = np.asarray(indices).reshape(-1, fsize)
    kwargs = {}
    if uvs is not None:
        kwargs['uvs'] = t(np.asarray(uvs, np.float32))
        if uv_idx is not None:
            kwargs['face_uvs_idx'] = t(np.asarray(uv_idx).reshape(
                faces.shape))
    return SurfaceMesh(vertices=t(vertices), faces=t(faces),
                       strict_checks=False, **kwargs)


def import_mesh(file_path_or_stage, scene_path=None, time=None,
                triangulate=False, heterogeneous_mesh_handler=None,
                device=None, **kwargs):
    """Import a single mesh from a USD(A) file onto ``device`` (default:
    the card, see :func:`~kaolin_tpu_torch._device.entry_device`)."""
    meshes = import_meshes(file_path_or_stage,
                           None if scene_path is None else [scene_path],
                           time=time, triangulate=triangulate,
                           heterogeneous_mesh_handler=(
                               heterogeneous_mesh_handler),
                           device=device)
    return meshes[0]


def import_meshes(file_path_or_stage, scene_paths=None, time=None,
                  triangulate=False, heterogeneous_mesh_handler=None,
                  device=None, **kwargs):
    """Import all (or selected) meshes from a USD(A) file onto ``device``
    (default: the card)."""
    device = entry_device(device)
    stage = _stage(file_path_or_stage)
    if scene_paths is None:
        scene_paths = get_scene_paths(stage, prim_types='Mesh')
    out = []
    for sp in scene_paths:
        prim = stage.get_prim(sp)
        if prim is None:
            raise ValueError(f'scene path {sp!r} not found')
        mesh = _prim_to_mesh(prim, time, triangulate,
                             heterogeneous_mesh_handler, device)
        if mesh is not None:
            out.append(mesh)
    return out


def get_raw_mesh_prim_geometry(prim, time=None, with_normals=False,
                               with_uvs=False):
    """Raw geometry attributes of a Mesh prim as numpy arrays."""
    def get(name, dtype=None):
        v = _sample(prim.attrs.get(name), time)
        return None if v is None else np.asarray(v, dtype=dtype)

    out = {
        'vertices': get('points', np.float32),
        'face_vertex_counts': get('faceVertexCounts'),
        'face_vertex_indices': get('faceVertexIndices'),
    }
    if with_normals:
        out['normals'] = get('normals', np.float32)
    if with_uvs:
        out['uvs'] = {'values': get('primvars:st', np.float32),
                      'indices': get('primvars:st:indices')}
    return out


def get_mesh_prim_materials(prim, file_path=None, time=None, device=None):
    """Materials bound on a Mesh prim (name -> PBRMaterial, textures on
    ``device``, default: the card).

    With the USDA subset a binding is a 'material:binding' attribute that
    holds the Material prim's path.  A binding that cannot be read raises
    (the JAX package returns no material then).
    """
    binding = prim.attrs.get('material:binding')
    if binding is None or file_path is None:
        return {}
    from kaolin_tpu_torch.io.usd.materials import import_material
    return {str(binding): import_material(file_path, str(binding),
                                          time=time, device=device)}


def get_uvmap_primvar(mesh_prim):
    """The UV ('st') primvar data of a Mesh prim: a dict ``{'values',
    'indices', 'interpolation'}`` (in place of a pxr Primvar object)."""
    uv = mesh_prim.attrs.get('primvars:st')
    idx = mesh_prim.attrs.get('primvars:st:indices')
    interp = mesh_prim.attrs.get('primvars:st:interpolation',
                                 'faceVarying')
    return {
        'values': np.asarray(uv, np.float32) if uv is not None else None,
        'indices': np.asarray(idx) if idx is not None else None,
        'interpolation': interp,
    }


def get_face_uvs_idx(faces, face_sizes, uvs, uv_idx, uv_interpolation,
                     **kwargs):
    """Resolve per-face-vertex UV indices for a USD interpolation mode."""
    if uv_interpolation in ('vertex', 'varying'):
        if uv_idx is None:
            if uvs is None:
                raise ValueError('Neither uvs nor uv_idx are set')
            uv_idx = np.arange(len(uvs))
        return np.asarray(uv_idx)[np.asarray(faces)]
    elif uv_interpolation == 'faceVarying':
        if uv_idx is None:
            uv_idx = np.arange(int(np.sum(face_sizes)))
        return np.asarray(uv_idx)
    raise NotImplementedError(
        f'Interpolation type {uv_interpolation} is not supported')


def get_face_normals(normals, normals_interpolation, **kwargs):
    """Resolve face normals for a USD interpolation mode."""
    if normals_interpolation == 'faceVarying':
        return normals
    raise NotImplementedError(
        f'Interpolation type {normals_interpolation} is not supported')
