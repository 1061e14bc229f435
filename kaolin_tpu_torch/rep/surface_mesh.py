"""SurfaceMesh: an easy-to-use mesh container with attribute auto-compute.

Port of ``kaolin_tpu/rep/surface_mesh.py``: a plain class (no pytree
registration) over tensors with three batching strategies and the same
attribute auto-compute graph:

* ``face_vertices``   <- (faces, vertices)
* ``face_normals``    <- (normals, face_normals_idx) or (vertices, faces)
* ``vertex_normals``  <- (faces, face_normals)
* ``face_uvs``        <- (uvs, face_uvs_idx)
"""

import enum
from typing import List, Optional, Sequence

import torch

from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch.ops.mesh.mesh import (compute_vertex_normals,
                                            index_vertices_by_faces)
from kaolin_tpu_torch.ops.mesh.trianglemesh import face_normals

__all__ = ['SurfaceMesh']


class Batching(str, enum.Enum):
    """Batching strategies."""
    NONE = 'none'     # unbatched, e.g. vertices (V, 3)
    FIXED = 'fixed'   # batched with fixed topology, e.g. vertices (B, V, 3)
    LIST = 'list'     # list of variable topology meshes


# attributes stored as arrays; order defines flatten order
_TENSOR_ATTRIBUTES = [
    'vertices', 'normals', 'uvs', 'faces', 'face_normals_idx',
    'face_uvs_idx', 'material_assignments', 'face_vertices', 'face_normals',
    'vertex_normals', 'face_uvs',
]
# attributes that are shared (not batched) under FIXED batching
_FIXED_TOPOLOGY_ATTRIBUTES = {'faces', 'face_normals_idx', 'face_uvs_idx',
                              'material_assignments'}


class SurfaceMesh:
    """Container for (batches of) triangle/polygon meshes.

    Any of the attributes can be passed at construction; derived attributes
    (``face_vertices``, ``face_normals``, ``vertex_normals``, ``face_uvs``)
    are computed on access when possible (set ``allow_auto_compute=False``
    to disable).
    """

    Batching = Batching
    __slots__ = ['_attrs', 'batching', 'allow_auto_compute',
                 'unset_attributes_return_none', 'materials']

    def __init__(self, vertices=None, faces=None, normals=None,
                 face_normals_idx=None, uvs=None, face_uvs_idx=None,
                 face_vertices=None, face_normals=None, vertex_normals=None,
                 face_uvs=None, material_assignments=None, materials=None,
                 batching=Batching.NONE, allow_auto_compute=True,
                 unset_attributes_return_none=True, strict_checks=True):
        object.__setattr__(self, '_attrs', {})
        object.__setattr__(self, 'batching', Batching(batching))
        object.__setattr__(self, 'allow_auto_compute', allow_auto_compute)
        object.__setattr__(self, 'unset_attributes_return_none',
                           unset_attributes_return_none)
        object.__setattr__(self, 'materials', materials)
        args = dict(vertices=vertices, faces=faces, normals=normals,
                    face_normals_idx=face_normals_idx, uvs=uvs,
                    face_uvs_idx=face_uvs_idx, face_vertices=face_vertices,
                    face_normals=face_normals, vertex_normals=vertex_normals,
                    face_uvs=face_uvs,
                    material_assignments=material_assignments)
        for k, v in args.items():
            if v is not None:
                self._attrs[k] = v
        if strict_checks:
            self.check_sanity()

    # -- sanity ------------------------------------------------------------
    def check_sanity(self):
        """Lightweight shape sanity checks for the current batching."""
        v = self._attrs.get('vertices')
        f = self._attrs.get('faces')
        if v is None or f is None or isinstance(v, (list, tuple)):
            return True
        if self.batching == Batching.NONE and hasattr(v, 'ndim') \
                and v.ndim != 2:
            raise ValueError(
                f"vertices must be (V, 3) for batching NONE, got "
                f"{v.shape}")
        if self.batching == Batching.FIXED and hasattr(v, 'ndim') \
                and v.ndim != 3:
            raise ValueError(
                f"vertices must be (B, V, 3) for batching FIXED, got "
                f"{v.shape}")
        return True

    # -- attribute access --------------------------------------------------
    def __getattr__(self, name):
        if name in ('_attrs', 'batching', 'allow_auto_compute',
                    'unset_attributes_return_none', 'materials'):
            raise AttributeError(name)
        attrs = object.__getattribute__(self, '_attrs')
        if name in attrs:
            return attrs[name]
        if name in _TENSOR_ATTRIBUTES:
            if object.__getattribute__(self, 'allow_auto_compute'):
                computed = self._try_compute(name)
                if computed is not None:
                    attrs[name] = computed
                    return computed
            if object.__getattribute__(self,
                                       'unset_attributes_return_none'):
                return None
            raise AttributeError(f"SurfaceMesh has no attribute {name!r}")
        raise AttributeError(f"SurfaceMesh has no attribute {name!r}")

    def __setattr__(self, name, value):
        if name in _TENSOR_ATTRIBUTES:
            if value is None:
                self._attrs.pop(name, None)
            else:
                self._attrs[name] = value
        elif name in self.__slots__:
            object.__setattr__(self, name, value)
        else:
            raise AttributeError(f"cannot set attribute {name!r}")

    def has_attribute(self, name):
        return name in self._attrs

    def has_or_can_compute_attribute(self, name):
        return self.has_attribute(name) or \
            (self.allow_auto_compute and self.probably_can_compute_attribute(name))

    def probably_can_compute_attribute(self, name):
        deps = {
            'face_vertices': [('faces', 'vertices')],
            'face_normals': [('normals', 'face_normals_idx'),
                             ('vertices', 'faces')],
            'vertex_normals': [('faces', 'face_normals')],
            'face_uvs': [('uvs', 'face_uvs_idx')],
        }.get(name, [])

        def available(d):
            if d in self._attrs:
                return True
            if d in ('face_normals', 'face_vertices'):
                return self.probably_can_compute_attribute(d)
            return False

        return any(all(available(d) for d in combo) for combo in deps)

    def get_attributes(self, only_tensors=False):
        keys = list(self._attrs.keys())
        if not only_tensors:
            if self.materials is not None:
                keys.append('materials')
        return keys

    # -- auto-compute ------------------------------------------------------
    def _apply(self, fn, *attr_values):
        """Apply fn over batching: direct for NONE/FIXED, map for LIST."""
        if self.batching == Batching.LIST:
            return [fn(*vals) for vals in zip(*attr_values)]
        return fn(*attr_values)

    def _try_compute(self, name):
        a = self._attrs
        try:
            if name == 'face_vertices':
                if 'faces' in a and 'vertices' in a:
                    return self._compute_face_attr('vertices', 'faces')
            elif name == 'face_normals':
                if 'normals' in a and 'face_normals_idx' in a:
                    return self._compute_face_attr('normals',
                                                   'face_normals_idx')
                fv = self.face_vertices
                if fv is not None:
                    def fn(fv_):
                        batched = fv_ if fv_.ndim == 4 else fv_[None]
                        n = face_normals(batched, unit=True)
                        n = n[:, :, None, :].expand(batched.shape)
                        return n if fv_.ndim == 4 else n[0]
                    return self._apply(fn, fv)
            elif name == 'vertex_normals':
                fn_attr = self.face_normals
                if fn_attr is not None and 'faces' in a:
                    faces = a['faces']

                    def fn(face_normals_, faces_):
                        batched = (face_normals_ if face_normals_.ndim == 4
                                   else face_normals_[None])
                        vn = compute_vertex_normals(
                            faces_, batched,
                            num_vertices=self._num_vertices())
                        vn = vn / clip(torch.linalg.norm(
                            vn, dim=-1, keepdim=True), 1e-12)
                        return (vn if face_normals_.ndim == 4 else vn[0])
                    if self.batching == Batching.LIST:
                        return [fn(f_, fa_) for f_, fa_ in
                                zip(fn_attr, faces)]
                    return fn(fn_attr, faces)
            elif name == 'face_uvs':
                if 'uvs' in a and 'face_uvs_idx' in a:
                    return self._compute_face_attr('uvs', 'face_uvs_idx')
        except Exception:
            return None
        return None

    def _num_vertices(self):
        v = self._attrs['vertices']
        if self.batching == Batching.LIST:
            return None
        return v.shape[-2]

    def _compute_face_attr(self, value_name, idx_name):
        values = self._attrs[value_name]
        idx = self._attrs[idx_name]

        def fn(v, i):
            if v.ndim == 3:  # batched values, shared idx
                return index_vertices_by_faces(v, i)
            return v[i.long()]
        if self.batching == Batching.LIST:
            return [fn(v, i) for v, i in zip(values, idx)]
        if self.batching == Batching.FIXED and values.ndim == 3:
            return index_vertices_by_faces(values, idx)
        return fn(values, idx)

    # -- batching conversions ----------------------------------------------
    def to_batched(self):
        """Convert NONE -> FIXED batching (in place), unsqueezing
        non-topology attributes."""
        if self.batching == Batching.FIXED:
            return self
        if self.batching != Batching.NONE:
            raise ValueError(
                "to_batched only supports NONE -> FIXED conversion")
        for k in list(self._attrs.keys()):
            if k not in _FIXED_TOPOLOGY_ATTRIBUTES:
                self._attrs[k] = self._attrs[k][None]
        object.__setattr__(self, 'batching', Batching.FIXED)
        return self

    @classmethod
    def cat(cls, meshes: Sequence['SurfaceMesh'], fixed_topology=True,
            skip_errors=False):
        """Concatenate meshes into FIXED (same topology) or LIST batching."""
        meshes = [m if m.batching == Batching.NONE else m for m in meshes]
        keys = set(meshes[0]._attrs.keys())
        for m in meshes[1:]:
            keys &= set(m._attrs.keys())
        out = {}
        if fixed_topology:
            for k in keys:
                if k in _FIXED_TOPOLOGY_ATTRIBUTES:
                    out[k] = meshes[0]._attrs[k]
                else:
                    vals = []
                    for m in meshes:
                        v = m._attrs[k]
                        vals.append(v if m.batching == Batching.FIXED
                                    else v[None])
                    out[k] = torch.cat(vals, dim=0)
            return cls(batching=Batching.FIXED, strict_checks=False, **out)
        else:
            for k in keys:
                vals = []
                for m in meshes:
                    v = m._attrs[k]
                    if m.batching == Batching.LIST:
                        vals.extend(v)
                    elif m.batching == Batching.FIXED:
                        vals.extend(list(v))
                    else:
                        vals.append(v)
                out[k] = vals
            return cls(batching=Batching.LIST, strict_checks=False, **out)

    def getattr_batched(self, name, batching=None):
        """Get an attribute converted to another batching strategy."""
        val = getattr(self, name)
        if val is None or batching is None or batching == self.batching:
            return val
        return self.convert_attribute_batching(
            val, self.batching, batching,
            is_tensor=name not in _FIXED_TOPOLOGY_ATTRIBUTES)

    @staticmethod
    def convert_attribute_batching(attr, from_batching, to_batching,
                                   is_tensor=True):
        """Convert a single attribute between batching strategies."""
        from_batching = Batching(from_batching)
        to_batching = Batching(to_batching)
        if from_batching == to_batching:
            return attr
        if not is_tensor:
            return attr
        if from_batching == Batching.NONE and to_batching == Batching.FIXED:
            return attr[None]
        if from_batching == Batching.NONE and to_batching == Batching.LIST:
            return [attr]
        if from_batching == Batching.FIXED and to_batching == Batching.LIST:
            return list(attr)
        if from_batching == Batching.FIXED and to_batching == Batching.NONE:
            if attr.shape[0] != 1:
                raise ValueError("cannot unbatch a batch of size > 1")
            return attr[0]
        if from_batching == Batching.LIST and to_batching == Batching.FIXED:
            return torch.stack(attr, dim=0)
        if from_batching == Batching.LIST and to_batching == Batching.NONE:
            if len(attr) != 1:
                raise ValueError("cannot unbatch a list of size > 1")
            return attr[0]
        raise ValueError(
            f"unsupported conversion {from_batching} -> {to_batching}")

    # -- convenience -------------------------------------------------------
    def float_tensors_to(self, dtype):
        """Cast all floating attributes to dtype (in place)."""
        for k, v in self._attrs.items():
            if isinstance(v, list):
                if v and v[0].is_floating_point():
                    self._attrs[k] = [x.to(dtype) for x in v]
            elif v.is_floating_point():
                self._attrs[k] = v.to(dtype)
        return self

    def describe_attribute(self, name):
        v = self._attrs.get(name)
        if v is None:
            return f"{name:>20}: unset"
        if isinstance(v, list):
            return f"{name:>20}: list of {len(v)}"
        return f"{name:>20}: {list(v.shape)} ({v.dtype}, {v.device})"

    def __len__(self):
        if self.batching == Batching.NONE:
            return 1
        if self.batching == Batching.LIST:
            return len(self._attrs['vertices'])
        return self._attrs['vertices'].shape[0]

    def __repr__(self):
        lines = [f"SurfaceMesh object with batching strategy "
                 f"{self.batching.name}"]
        for k in _TENSOR_ATTRIBUTES:
            if k in self._attrs:
                lines.append(self.describe_attribute(k))
        if self.materials is not None:
            lines.append(f"{'materials':>20}: list of "
                         f"{len(self.materials)}")
        computable = {
            'face_vertices': '(faces, vertices)',
            'face_normals': '(normals, face_normals_idx) or '
                            '(vertices, faces)',
            'vertex_normals': '(faces, face_normals)',
            'face_uvs': '(uvs, face_uvs_idx)',
        }
        for k, src in computable.items():
            if k not in self._attrs:
                lines.append(
                    f"{k:>20}: if possible, computed on access from: {src}")
        return '\n'.join(lines)

