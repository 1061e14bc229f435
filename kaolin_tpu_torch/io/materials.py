"""Material model: PBR (USD Preview Surface style) materials.

Port of ``kaolin_tpu/io/materials.py``: the error classes,
:class:`PBRMaterial` (values, textures, and its USD writer and reader over
:mod:`kaolin_tpu_torch.io.usd.materials`), :class:`MaterialManager` (the
registry of material readers) and :func:`process_materials_and_assignments`.
"""

import inspect
import os
import warnings

import numpy as np

__all__ = [
    'MaterialError', 'MaterialNotSupportedError', 'MaterialLoadError',
    'MaterialWriteError', 'MaterialFileError', 'MaterialNotFoundError',
    'Material', 'PBRMaterial', 'MaterialManager',
    'process_materials_and_assignments',
]


class MaterialError(Exception):
    pass


class MaterialNotSupportedError(MaterialError):
    pass


class MaterialLoadError(MaterialError):
    pass


class MaterialWriteError(MaterialError):
    pass


class MaterialFileError(MaterialError):
    pass


class MaterialNotFoundError(MaterialError):
    pass


class Material:
    """Abstract material base."""

    def __init__(self, name):
        self.material_name = name


_PBR_VALUE_DEFAULTS = {
    'diffuse_color': (0.5, 0.5, 0.5),
    'roughness_value': 0.5,
    'metallic_value': 0.0,
    'clearcoat_value': 0.0,
    'clearcoat_roughness_value': 0.01,
    'opacity_value': 1.0,
    'opacity_threshold': 0.0,
    'ior_value': 1.5,
    'specular_color': (0.0, 0.0, 0.0),
    'displacement_value': 0.0,
}
_PBR_TEXTURES = [
    'diffuse_texture', 'roughness_texture', 'metallic_texture',
    'clearcoat_texture', 'clearcoat_roughness_texture', 'opacity_texture',
    'ior_texture', 'specular_texture', 'normals_texture',
    'displacement_texture',
]
_PBR_COLORSPACES = [
    'diffuse_colorspace', 'roughness_colorspace', 'metallic_colorspace',
    'clearcoat_colorspace', 'clearcoat_roughness_colorspace',
    'opacity_colorspace', 'ior_colorspace', 'specular_colorspace',
    'normals_colorspace', 'displacement_colorspace',
]


class PBRMaterial(Material):
    """USD-Preview-Surface-style PBR material.

    Value parameters default as in the JAX package; textures are
    ``(C, H, W)`` tensors.
    """

    def __init__(self, material_name='', is_specular_workflow=False,
                 **kwargs):
        super().__init__(material_name)
        self.is_specular_workflow = is_specular_workflow
        for name, default in _PBR_VALUE_DEFAULTS.items():
            setattr(self, name, kwargs.pop(name, default))
        for name in _PBR_TEXTURES:
            setattr(self, name, kwargs.pop(name, None))
        for name in _PBR_COLORSPACES:
            setattr(self, name, kwargs.pop(name, 'auto'))
        self.shaders = {}
        if kwargs:
            raise TypeError(
                f"unexpected PBRMaterial parameters: {sorted(kwargs)}")

    def write_to_usd(self, file_path, scene_path, bound_prims=None,
                     time=None, texture_dir='', texture_file_prefix='',
                     shader='UsdPreviewSurface'):
        """Write this material as a Material prim of a USD(A) file."""
        from kaolin_tpu_torch.io.usd import materials as usd_materials
        return usd_materials.export_material(
            self, file_path, scene_path, bound_prims=bound_prims, time=time,
            texture_dir=texture_dir, texture_file_prefix=texture_file_prefix)

    def read_from_usd(self, file_path, scene_path, texture_path=None,
                      time=None, device=None):
        """The material of a Material prim of a USD(A) file (a new
        PBRMaterial, textures on ``device``, default: the card)."""
        from kaolin_tpu_torch.io.usd import materials as usd_materials
        return usd_materials.import_material(
            file_path, scene_path, texture_path=texture_path, time=time,
            device=device)

    def __repr__(self):
        set_textures = [t for t in _PBR_TEXTURES
                        if getattr(self, t) is not None]
        return (f"PBRMaterial(material_name={self.material_name!r}, "
                f"diffuse_color={self.diffuse_color}, "
                f"textures={set_textures})")


def process_materials_and_assignments(materials_dict,
                                      material_assignments_dict,
                                      error_handler, num_faces,
                                      error_context_str=''):
    """Convert raw materials + per-material face assignments into a sorted
    material list and a per-face material index array.

    Args:
        materials_dict: name -> material (dict or Material).
        material_assignments_dict: name -> (K,) face indices or (K, 2)
            [start, end) ranges.
        error_handler: handler for missing materials; may return a dummy
            material dict to keep assignments.
        num_faces: total number of faces.
        error_context_str: extra context for error messages.

    Returns:
        (materials list, (num_faces,) int16 numpy material index array,
        -1 = none).
    """
    def _try_to_set_name(generated_material, material_name):
        if isinstance(generated_material, dict):
            generated_material['material_name'] = material_name
        elif generated_material is not None:
            try:
                generated_material.material_name = material_name
            except Exception as e:
                warnings.warn(f'Could not set material_name: {e}')

    # material referenced but not found -> handler may generate a dummy
    for mat_name in list(material_assignments_dict.keys()):
        if mat_name not in materials_dict:
            dummy = error_handler(
                MaterialNotFoundError(
                    f"'Material {mat_name} not found, but referenced "
                    f"{error_context_str}"),
                material_name=mat_name)
            if dummy is not None:
                _try_to_set_name(dummy, mat_name)
                materials_dict[mat_name] = dummy
            else:
                del material_assignments_dict[mat_name]

    material_names = sorted(materials_dict.keys())
    materials = [materials_dict[name] for name in material_names]
    material_assignments = np.full((num_faces,), -1, dtype=np.int16)
    for name, values in material_assignments_dict.items():
        mat_idx = material_names.index(name)
        values = np.asarray(values)
        if values.ndim == 2:
            assert values.shape[1] == 2, \
                f'Unexpected shape {values.shape} for face assignments'
            for start, end in values:
                material_assignments[int(start):int(end)] = mat_idx
        else:
            material_assignments[values] = mat_idx
    return materials, material_assignments


class MaterialManager:
    """Registry mapping shader names to material reader functions.

    USD import functions use it to pick a reader for a material's shader
    id; :meth:`read_from_file` reads ``UsdPreviewSurface`` materials through
    :func:`kaolin_tpu_torch.io.usd.materials.import_material`.

    Example:
        >>> dummy_reader = lambda params, texture_path, time: Material('x')
        >>> MaterialManager.register_usd_reader('MyCustomPBR', dummy_reader)
    """
    _usd_readers = {}
    _obj_reader = None

    @classmethod
    def register_usd_reader(cls, shader_name, reader_fn):
        """Register ``reader_fn(params, texture_path, time)`` for a
        shader."""
        if shader_name in cls._usd_readers:
            warnings.warn(f'Shader {shader_name} is already registered. '
                          'Overwriting previous definition.')
        if not callable(reader_fn):
            raise MaterialLoadError(
                'The supplied `reader_fn` must be a callable function.')
        if len(inspect.signature(reader_fn).parameters) != 3:
            raise ValueError(
                'Error encountered when validating supplied `reader_fn`. '
                'Ensure that the function takes 3 arguments: parameters '
                '(dict), texture_path (string) and time (float)')
        cls._usd_readers[shader_name] = reader_fn

    @classmethod
    def register_obj_reader(cls, reader_fn):
        """Register a reader used for ``.obj`` material files."""
        if not callable(reader_fn):
            raise MaterialLoadError(
                'The supplied `reader_fn` must be a callable function.')
        cls._obj_reader = reader_fn

    @classmethod
    def read_from_file(cls, file_path, scene_path=None, texture_path=None,
                       time=None, device=None):
        """Read a material from a USD(A) file (textures on ``device``,
        default: the card) or, through the registered reader, an OBJ
        file."""
        ext = os.path.splitext(file_path)[1]
        if ext in ('.usd', '.usda', '.usdc'):
            if scene_path is None:
                raise MaterialLoadError(
                    f'The scene_path `{scene_path}` provided is invalid.')
            if texture_path is None:
                texture_file_path = os.path.dirname(file_path)
            elif not os.path.isabs(texture_path):
                texture_file_path = os.path.join(
                    os.path.dirname(file_path), texture_path)
            else:
                texture_file_path = texture_path
            from kaolin_tpu_torch.io.usd import materials as usd_materials
            return usd_materials.import_material(
                file_path, scene_path, texture_path=texture_file_path,
                time=time, device=device)
        elif ext == '.obj':
            if cls._obj_reader is not None:
                return cls._obj_reader(file_path)
            raise MaterialNotSupportedError(
                'No registered .obj material reader found.')
        raise MaterialNotSupportedError(
            f'Unsupported material file extension {ext!r}')
