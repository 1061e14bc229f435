"""I/O helpers: heterogeneous mesh handlers.

Port of ``kaolin_tpu/io/utils.py``.  Host-side numpy, as in the JAX
package: the handlers run on the parsed index lists before any tensor is
made.
"""

import warnings

import numpy as np

__all__ = [
    'NonHomogeneousMeshError',
    'heterogeneous_mesh_handler_skip',
    'heterogeneous_mesh_handler_naive_homogenize',
    'mesh_handler_naive_triangulate',
]


class NonHomogeneousMeshError(Exception):
    """Raised when expecting a homogeneous mesh but a heterogeneous mesh
    is encountered."""

    __slots__ = ['message']

    def __init__(self, message):
        self.message = message


def heterogeneous_mesh_handler_skip(*args, **kwargs):
    """Skip heterogeneous meshes (return None)."""
    return None


def heterogeneous_mesh_handler_naive_homogenize(*args, **kwargs):
    """Deprecated alias of :func:`mesh_handler_naive_triangulate`."""
    warnings.warn(
        "heterogeneous_mesh_handler_naive_homogenize is deprecated, please "
        "use kaolin_tpu_torch.io.utils.mesh_handler_naive_triangulate "
        "instead", DeprecationWarning, stacklevel=2)
    return mesh_handler_naive_triangulate(*args, **kwargs)


def mesh_handler_naive_triangulate(vertices, face_vertex_counts, *features,
                                   face_assignments=None):
    """Fan-triangulate polygonal faces of varying vertex counts.

    Args:
        vertices: (N, 3) array (passed through unchanged).
        face_vertex_counts: (M,) vertex count per face.
        features: flat per-face-vertex features (e.g. vertex / uv indices)
            each of shape (sum(face_vertex_counts),).
        face_assignments: optional dict of name -> (K,) face indices or
            (K, 2) [start, end) ranges, remapped to triangulated indices.

    Returns:
        (vertices, new_face_vertex_counts, *new_features[, new_assignments])
    """
    counts = [int(c) for c in np.asarray(face_vertex_counts).tolist()]

    def fan(attr):
        attr = list(attr)
        out, idx = [], 0
        for count in counts:
            face = attr[idx:idx + count]
            idx += count
            out += [[face[0], face[k], face[k + 1]]
                    for k in range(1, count - 1)]
        return np.asarray(out)

    new_attrs = [None if a is None else fan(a) for a in features]
    new_ids, num_faces = [], 0
    for count in counts:
        n = max(count - 2, 0)
        new_ids.append(list(range(num_faces, num_faces + n)))
        num_faces += n
    new_counts = np.full((num_faces,), 3, dtype=np.int64)
    if face_assignments is None:
        return tuple([vertices, new_counts] + new_attrs)

    new_assignments = {}
    for k, v in face_assignments.items():
        v = np.asarray(v)
        if v.ndim == 1:
            new_idx = np.asarray(
                [i for old in v for i in new_ids[int(old)]], dtype=np.int64)
        else:
            assert v.ndim == 2 and v.shape[1] == 2, \
                'Expects shape (K,) or (K, 2) for face_assignments'
            new_idx = np.zeros_like(v)
            for row in range(v.shape[0]):
                new_idx[row, 0] = new_ids[int(v[row, 0])][0]
                new_idx[row, 1] = new_ids[int(v[row, 1]) - 1][-1] + 1
        new_assignments[k] = new_idx
    return tuple([vertices, new_counts] + new_attrs + [new_assignments])
