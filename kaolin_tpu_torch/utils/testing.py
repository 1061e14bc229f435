"""Tensor checkers and test scaffolding.

The checkers, printers and ``with_seed`` are the port of
``kaolin_tpu/utils/testing.py``: the same signatures and messages, on
torch tensors (dtype names print as torch's, ``torch.float32`` for
``float32``).

The scaffolding is shared by the tests and ``chip_smoke.py``.  The
repository holds no mesh file, so the DIB-R step and the SPC pipeline run
on a procedural UV sphere whose output both packages can take; the OBJ
importer reads that sphere written as OBJ + MTL text
(:func:`write_sphere_obj`), and the tetmesh ops run on a tet grid of a cube
(:func:`tet_grid`).
"""

import functools
import itertools
import json
import logging
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from kaolin_tpu_torch.ops import random as _random

__all__ = ['UVSphere', 'uv_sphere', 'random_triangles', 'camera_grid',
           'EDGE_SCENES', 'dibr_edge_scene', 'punch_cell_rows',
           'write_sphere_obj', 'tet_grid', 'deformed_sphere',
           'write_shapenet_v2', 'write_modelnet', 'write_shrec16',
           'write_synthetic_view', 'mesh_arrays', 'CountedDataset',
           'BOOL_DTYPES', 'INT_DTYPES', 'FLOAT_DTYPES', 'NUM_DTYPES',
           'ALL_DTYPES', 'with_seed', 'check_tensor', 'check_packed_tensor',
           'check_padded_tensor', 'check_spc_octrees', 'tensor_info',
           'contained_allclose', 'contained_equal', 'check_allclose',
           'check_tensor_attribute_shapes', 'print_dict_attributes',
           'print_namedtuple_attributes']

BOOL_DTYPES = [torch.bool]
INT_DTYPES = [torch.uint8, torch.int16, torch.int32]
FLOAT_DTYPES = [torch.float16, torch.bfloat16, torch.float32]
NUM_DTYPES = INT_DTYPES + FLOAT_DTYPES
ALL_DTYPES = NUM_DTYPES + BOOL_DTYPES


def random_triangles(seed, F, B=2, spread=0.3):
    """Random small triangles for the fused-engine tests, numpy-seeded.

    Returns (face_vertices_z (B, F, 3) in [0.1, 2], face_vertices_image
    (B, F, 3, 2) in [-0.9, 0.9]), float32; ``spread`` shrinks each triangle
    towards its centroid.
    """
    rng = np.random.default_rng(seed)
    fvi = rng.uniform(-0.9, 0.9, (B, F, 3, 2)).astype(np.float32)
    cent = fvi.mean(axis=2, keepdims=True)
    fvi = (cent + (fvi - cent) * spread).astype(np.float32)
    fvz = rng.uniform(0.1, 2.0, (B, F, 3)).astype(np.float32)
    return fvz, fvi


EDGE_SCENES = ('ties', 'cluster', 'margin0', 'odd_100x72', 'odd_130x257',
               'empty')


def dibr_edge_scene(name, B=2):
    """Scenes that probe the fused DIB-R kernels' culling and tie rules.

    Returns (face_vertices_z (B, F, 3), face_vertices_image (B, F, 3, 2),
    height, width, boxlen), numpy float32 and numbers:

    - ``'ties'``: 150 random triangles, each twice: every covered pixel is
      a z tie, which the lower sorted id (the first copy) wins;
    - ``'cluster'``: 320 small triangles around one point of a 16 x 16
      pixel block, among 80 random ones, so that one block's face list
      holds more than 300 faces;
    - ``'margin0'``: random triangles with ``boxlen = 0``: the enlarged
      bbox is the triangle's own;
    - ``'odd_100x72'``, ``'odd_130x257'``: image sides that are not
      multiples of 16;
    - ``'empty'``: every triangle off screen.
    """
    rng = np.random.default_rng(EDGE_SCENES.index(name) + 11)
    height = width = 64
    boxlen = 0.02
    if name == 'ties':
        fvz, fvi = random_triangles(5, 150, B)
        fvz, fvi = np.concatenate([fvz] * 2, 1), np.concatenate([fvi] * 2, 1)
    elif name == 'cluster':
        fvz, fvi = random_triangles(6, 80, B)
        # pixel centre of column 24, row 40 at 64 x 64: inside the block
        # of columns 16-31, rows 32-47
        centre = np.array([-1. + 49. / 64., 1. - 81. / 64.], np.float32)
        small = centre + rng.uniform(-0.04, 0.04, (B, 320, 3, 2))
        fvi = np.concatenate([fvi, small.astype(np.float32)], 1)
        fvz = np.concatenate([fvz, rng.uniform(0.1, 2., (B, 320, 3))
                              .astype(np.float32)], 1)
    elif name == 'margin0':
        fvz, fvi = random_triangles(7, 200, B)
        boxlen = 0.
    elif name.startswith('odd_'):
        height, width = (int(v) for v in name[4:].split('x'))
        fvz, fvi = random_triangles(8, 200, B)
    elif name == 'empty':
        fvz, fvi = random_triangles(9, 100, B)
        fvi = fvi + np.float32(2.5)
    else:
        raise ValueError(f'unknown scene {name!r}; one of {EDGE_SCENES}')
    return fvz, fvi, height, width, boxlen


class UVSphere(NamedTuple):
    vertices: np.ndarray       # (V, 3) float32, unit radius
    faces: np.ndarray          # (F, 3) int64, counter-clockwise from outside
    uvs: np.ndarray            # (U, 2) float32 in [0, 1]
    face_uvs_idx: np.ndarray   # (F, 3) int64 rows of ``uvs``


def uv_sphere(n_lon, n_lat):
    """Unit UV sphere with ``2 * n_lon * (n_lat - 1)`` triangles.

    ``n_lon`` segments around the y axis, ``n_lat`` rings from pole to pole.
    Vertices are shared (one per pole); the uv grid has a seam column, so
    ``uvs`` has ``(n_lon + 1) * (n_lat + 1)`` rows with v = 1 at the north
    pole (OpenGL convention).  ``uv_sphere(100, 51)`` has 10,000 faces.
    """
    if n_lon < 3 or n_lat < 2:
        raise ValueError(f'need n_lon >= 3 and n_lat >= 2, got '
                         f'{n_lon}, {n_lat}')
    theta = np.pi * np.arange(1, n_lat) / n_lat            # ring latitudes
    phi = 2 * np.pi * np.arange(n_lon) / n_lon
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.sin(phi),
                     np.broadcast_to(ct, (n_lat - 1, n_lon)),
                     st * np.cos(phi)], axis=-1).reshape(-1, 3)
    vertices = np.concatenate([[[0., 1., 0.]], ring, [[0., -1., 0.]]])
    north, south = 0, len(vertices) - 1

    def vid(r, k):                                         # ring r, column k
        return 1 + r * n_lon + k % n_lon

    def uid(r, k):                                         # uv row r, column k
        return r * (n_lon + 1) + k

    faces, fuv = [], []
    for k in range(n_lon):
        faces.append([north, vid(0, k), vid(0, k + 1)])
        fuv.append([uid(0, k), uid(1, k), uid(1, k + 1)])
        for r in range(n_lat - 2):
            a, b = vid(r, k), vid(r, k + 1)
            c, d = vid(r + 1, k), vid(r + 1, k + 1)
            ua, ub = uid(r + 1, k), uid(r + 1, k + 1)
            uc, ud = uid(r + 2, k), uid(r + 2, k + 1)
            faces += [[a, c, d], [a, d, b]]
            fuv += [[ua, uc, ud], [ua, ud, ub]]
        faces.append([vid(n_lat - 2, k), south, vid(n_lat - 2, k + 1)])
        fuv.append([uid(n_lat - 1, k), uid(n_lat, k), uid(n_lat - 1, k + 1)])
    u, v = np.meshgrid(np.arange(n_lon + 1) / n_lon,
                       1. - np.arange(n_lat + 1) / n_lat)
    uvs = np.stack([u, v], axis=-1).reshape(-1, 2)
    return UVSphere(vertices.astype(np.float32), np.asarray(faces, np.int64),
                    uvs.astype(np.float32), np.asarray(fuv, np.int64))


def camera_grid(side, z=-2.5, spread=0.1, extent=0.9):
    """A ``side`` x ``side`` grid of camera rays (row-major, y slowest):
    origins on [-extent, extent]^2 at depth ``z``, unit directions
    ``(spread * x, spread * y, 1)``.  Returns float32 (origin, direction),
    each (side^2, 3)."""
    ys, xs = np.meshgrid(np.linspace(-extent, extent, side),
                         np.linspace(-extent, extent, side), indexing='ij')
    o = np.stack([xs.ravel(), ys.ravel(), np.full(side * side, z)], -1)
    d = np.stack([xs.ravel() * spread, ys.ravel() * spread,
                  np.ones(side * side)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def punch_cell_rows(rows, seed, share=0.25):
    """A copy of cell-table rows (R, 4, cw) int32 with voxels taken out and
    put in, for the trace kernel's tests.  In every third row a random
    ``share`` of the slots loses its voxel (leaf index -1, holes anywhere in
    the row; the coordinates stay in place); every seventh row loses all of
    them; in every fifth row that holds a voxel each free slot gets a copy
    of the row's first voxel under a leaf index of its own (R * cw + its
    place), so the row is full and a ray that hits the voxel hits it again
    at an equal depth.  The other rows stay as they are."""
    rng = np.random.default_rng(seed)
    rows = np.array(rows, copy=True)
    R, _, cw = rows.shape
    idx = np.arange(R)
    fill = (idx % 5 == 2)[:, None] & (rows[:, 3, :1] >= 0) & (rows[:, 3] < 0)
    filled = np.where(fill[:, None], rows[:, :, :1], rows)
    filled[:, 3] = np.where(fill, R * cw + np.arange(R * cw).reshape(R, cw),
                            rows[:, 3])
    holes = (rng.random((R, cw)) < share) & (idx % 3 == 1)[:, None]
    holes |= (idx % 7 == 3)[:, None]
    filled[:, 3][holes] = -1
    return filled


def write_sphere_obj(directory, sphere, material='sphere_mat',
                     kd=(0.8, 0.6, 0.4)):
    """Write ``sphere`` (a :class:`UVSphere`) as ``sphere.obj`` with its uvs
    and a one-material ``sphere.mtl`` into ``directory``; returns the OBJ
    path.  Coordinates are written with 9 significant digits, which float32
    reads back exactly."""
    with open(os.path.join(directory, 'sphere.mtl'), 'w') as f:
        f.write(f'newmtl {material}\nKd {kd[0]} {kd[1]} {kd[2]}\n')
    lines = ['mtllib sphere.mtl']
    lines += [f'v {x:.9g} {y:.9g} {z:.9g}' for x, y, z in sphere.vertices]
    lines += [f'vt {u:.9g} {v:.9g}' for u, v in sphere.uvs]
    lines.append(f'usemtl {material}')
    lines += ['f ' + ' '.join(f'{a + 1}/{b + 1}' for a, b in zip(f, t))
              for f, t in zip(sphere.faces, sphere.face_uvs_idx)]
    path = os.path.join(directory, 'sphere.obj')
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


def tet_grid(n, lo=-1., hi=1.):
    """A tet mesh of the cube [lo, hi]^3: an n^3 grid of cells, each cut
    into 6 tets around its main diagonal (a conforming mesh), every tet
    positively oriented.  Returns (vertices (V, 3) float32, tets (6 n^3, 4)
    int64)."""
    ax = np.linspace(lo, hi, n + 1)
    vertices = np.stack(np.meshgrid(ax, ax, ax, indexing='ij'),
                        -1).reshape(-1, 3).astype(np.float32)
    cells = np.stack(np.meshgrid(*[np.arange(n)] * 3, indexing='ij'),
                     -1).reshape(-1, 3)

    def vid(c):
        return (c[:, 0] * (n + 1) + c[:, 1]) * (n + 1) + c[:, 2]

    tets = []
    for order in itertools.permutations(range(3)):
        path = [cells.copy()]
        for axis in order:          # walk from corner 000 to 111
            step = path[-1].copy()
            step[:, axis] += 1
            path.append(step)
        tets.append(np.stack([vid(c) for c in path], -1))
    tets = np.concatenate(tets)
    v = vertices[tets].astype(np.float64)
    vol = np.einsum('ij,ij->i', v[:, 1] - v[:, 0],
                    np.cross(v[:, 2] - v[:, 0], v[:, 3] - v[:, 0]))
    tets[vol < 0] = tets[vol < 0][:, [0, 2, 1, 3]]
    return vertices, tets.astype(np.int64)



# -- corpora in the dataset layouts, synthetic views ---------------------------

def deformed_sphere(seed, sphere=(20, 11), radius=0.5, amplitude=0.08):
    """A :class:`UVSphere` of ``radius`` whose radius varies by a seeded
    low-frequency field: ``1 + amplitude * sin(w . p + phase)`` with
    ``|w|`` in [1.5, 3], so that models made from different seeds differ."""
    s = uv_sphere(*sphere)
    rng = np.random.default_rng(seed)
    w = rng.normal(size=3)
    w *= rng.uniform(1.5, 3.) / np.linalg.norm(w)
    r = 1. + amplitude * np.sin(s.vertices.astype(np.float64) @ w
                                + rng.uniform(0., 2. * np.pi))
    v = (s.vertices * (radius * r)[:, None]).astype(np.float32)
    return s._replace(vertices=v)


def _write_obj(path, sphere):
    """``sphere`` as OBJ + MTL, the OBJ at ``path``."""
    directory = os.path.dirname(path)
    os.makedirs(directory, exist_ok=True)
    os.replace(write_sphere_obj(directory, sphere), path)


def write_shapenet_v2(root, synsets, models, sphere=(20, 11), seed=0):
    """A ShapeNetCore V2 tree: ``root/{synset}/{model:04d}/models/
    model_normalized.obj`` (+ its MTL) for each synset and each of
    ``models`` models, each a :func:`deformed_sphere` of its own seed.
    Returns {(synset, model): UVSphere}."""
    out = {}
    for i, syn in enumerate(synsets):
        for m in range(models):
            s = deformed_sphere(seed + i * models + m, sphere)
            _write_obj(os.path.join(root, syn, f'{m:04d}', 'models',
                                    'model_normalized.obj'), s)
            out[(syn, m)] = s
    return out


def write_modelnet(root, categories, models, sphere=(20, 11), seed=100):
    """A ModelNet tree: ``root/{category}/train/{category}_{m:04d}.off``.
    Returns {(category, model): UVSphere}."""
    out = {}
    for i, cat in enumerate(categories):
        directory = os.path.join(root, cat, 'train')
        os.makedirs(directory, exist_ok=True)
        for m in range(models):
            s = deformed_sphere(seed + i * models + m, sphere)
            lines = ['OFF', f'{len(s.vertices)} {len(s.faces)} 0']
            lines += [f'{x:.9g} {y:.9g} {z:.9g}' for x, y, z in s.vertices]
            lines += [f'3 {a} {b} {c}' for a, b, c in s.faces]
            with open(os.path.join(directory, f'{cat}_{m:04d}.off'),
                      'w') as f:
                f.write('\n'.join(lines) + '\n')
            out[(cat, m)] = s
    return out


def write_shrec16(root, synsets, models, sphere=(20, 11), seed=200):
    """A SHREC16 tree: ``root/train/{synset}/{m:06d}.obj`` (+ MTL).
    Returns {(synset, model): UVSphere}."""
    out = {}
    for i, syn in enumerate(synsets):
        for m in range(models):
            s = deformed_sphere(seed + i * models + m, sphere)
            _write_obj(os.path.join(root, 'train', syn, f'{m:06d}.obj'), s)
            out[(syn, m)] = s
    return out


def write_synthetic_view(directory, idx, camera_rot, camera_trans, fovy,
                         resolution, semantic=None, depth_linear=None,
                         focal_length=24., clipping_range=(0.01, 100.)):
    """One view in the Omniverse synthetic-data layout that
    ``import_synthetic_view`` reads: ``{idx}_semantic.npy``,
    ``{idx}_depth_linear.npy`` (where given) and ``{idx}_metadata.json``.

    ``tf_mat`` holds the camera's rotation in rows 0-2 and its translation
    (the position of ``rotate_translate_points``) in row 3, columns 0-2;
    ``horizontal_aperture`` is ``2 * focal_length * tan(fovy / 2)``, so the
    importer's ``cam_proj`` is the projection of ``fovy``.
    """
    os.makedirs(directory, exist_ok=True)
    if semantic is not None:
        np.save(os.path.join(directory, f'{idx}_semantic.npy'),
                _np(semantic))
    if depth_linear is not None:
        np.save(os.path.join(directory, f'{idx}_depth_linear.npy'),
                _np(depth_linear))
    tf = np.eye(4)
    tf[:3, :3] = _np(camera_rot)
    tf[3, :3] = _np(camera_trans).reshape(3)
    height, width = resolution
    meta = {
        'camera_properties': {
            'tf_mat': tf.tolist(),
            'resolution': {'width': int(width), 'height': int(height)},
            'focal_length': float(focal_length),
            'horizontal_aperture': float(2. * focal_length
                                         * np.tan(fovy / 2.)),
            'clipping_range': list(clipping_range),
        },
        'asset_transforms': [['/World/model', np.eye(4).tolist()]],
    }
    with open(os.path.join(directory, f'{idx}_metadata.json'), 'w') as f:
        json.dump(meta, f)


def mesh_arrays(item):
    """Preprocessing transform of a mesh dataset's item: the mesh's
    ``vertices``, ``faces`` and ``face_uvs`` (module level, so that a
    ``spawn`` worker can unpickle it)."""
    mesh = item['mesh']
    return {'vertices': mesh.vertices, 'faces': mesh.faces,
            'face_uvs': mesh.uvs[mesh.face_uvs_idx]}


class CountedDataset(torch.utils.data.Dataset):
    """A dataset that writes one file into ``log_dir`` per item it is asked
    for, in whatever process asks: ``calls(log_dir)`` counts them."""

    def __init__(self, dataset, log_dir):
        self.dataset = dataset
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        with open(os.path.join(self.log_dir,
                               f'{os.getpid()}-{index}-{time.time_ns()}'),
                  'w'):
            pass
        return self.dataset[index]

    @staticmethod
    def calls(log_dir):
        return len(os.listdir(log_dir))

# -- checkers and printers ----------------------------------------------------

def _np(x):
    """A host numpy array of ``x`` (bfloat16 tensors as float32)."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def with_seed(seed=0, random_seed=None, numpy_seed=None):
    """Decorator fixing the module RNG seed (:mod:`kaolin_tpu_torch.ops.
    random`'s generator, python's and numpy's) around a test function; the
    states are restored after it."""
    def decorator(func):
        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            state = _random.get_state()
            _random.manual_seed(seed, random_seed, numpy_seed)
            try:
                return func(*args, **kwargs)
            finally:
                _random.set_state(*state)
        return wrapper
    return decorator


def check_tensor(tensor, shape=None, dtype=None, throw=True):
    """Check a tensor's shape (None entries = wildcard) and dtype."""
    if shape is not None:
        if len(shape) != tensor.ndim:
            if throw:
                raise ValueError(
                    f"tensor is of rank {tensor.ndim} but expected {len(shape)}")
            return False
        for i, (s, exp) in enumerate(zip(tensor.shape, shape)):
            if exp is not None and s != exp:
                if throw:
                    raise ValueError(
                        f"tensor shape {tuple(tensor.shape)} does not match "
                        f"expected {tuple(shape)} at dim {i}")
                return False
    if dtype is not None:
        if tensor.dtype != dtype:
            if throw:
                raise TypeError(
                    f"tensor dtype {tensor.dtype} != expected {dtype}")
            return False
    return True


def check_packed_tensor(tensor, total_numel=None, last_dim=None, dtype=None,
                        throw=True):
    """Check a packed tensor ``(total_numel, last_dim)``."""
    return check_tensor(tensor, shape=(total_numel, last_dim), dtype=dtype,
                        throw=throw)


def check_padded_tensor(tensor, padding_value=None, shape_per_tensor=None,
                        batch_size=None, max_shape=None, last_dim=None,
                        dtype=None, throw=True):
    """Check a padded tensor and (optionally) its padding values."""
    shape = None
    if batch_size is not None or max_shape is not None or last_dim is not None:
        if max_shape is None:
            shape = None
        else:
            shape = (batch_size,) + tuple(max_shape) + (last_dim,)
    if shape is not None and not check_tensor(tensor, shape=shape, dtype=dtype,
                                              throw=throw):
        return False
    if shape is None and dtype is not None and not check_tensor(
            tensor, dtype=dtype, throw=throw):
        return False
    if padding_value is not None and shape_per_tensor is not None:
        arr = _np(tensor)
        shape_per_tensor = _np(shape_per_tensor)
        for i in range(shape_per_tensor.shape[0]):
            sub = arr[i]
            mask = np.zeros(sub.shape[:-1], dtype=bool)
            mask[tuple(slice(0, int(s)) for s in shape_per_tensor[i])] = True
            if not np.all(sub[~mask] == padding_value):
                if throw:
                    raise ValueError(
                        f"padding of sub-tensor {i} is not {padding_value}")
                return False
    return True


def check_spc_octrees(octrees, lengths, batch_size=None, level=None,
                      throw=True):
    """Validate a packed batch of SPC octrees (uint8 bytes).

    Walks each octree breadth-first from its root byte, checking that the
    number of bytes matches the popcount-derived node counts and that each
    octree reaches the expected ``level``.
    """
    if octrees.dtype != torch.uint8:
        if throw:
            raise TypeError(f"octrees must be uint8, got {octrees.dtype}")
        return False
    octrees = _np(octrees)
    lengths = _np(lengths)
    if batch_size is not None and lengths.shape[0] != batch_size:
        if throw:
            raise ValueError(
                f"expected batch_size {batch_size}, got {lengths.shape[0]}")
        return False
    if octrees.shape[0] != lengths.sum():
        if throw:
            raise ValueError(
                f"octrees has {octrees.shape[0]} bytes but lengths sum to "
                f"{lengths.sum()}")
        return False
    start = 0
    for b, length in enumerate(lengths):
        octree = octrees[start:start + int(length)]
        cursor, num_nodes, cur_level = 0, 1, 0
        while cursor < octree.shape[0]:
            nodes = octree[cursor:cursor + num_nodes]
            cursor += num_nodes
            num_nodes = int(np.unpackbits(nodes).sum())
            cur_level += 1
        if cursor != octree.shape[0]:
            if throw:
                raise ValueError(f"octree {b} is malformed")
            return False
        if level is not None and cur_level != level:
            if throw:
                raise ValueError(
                    f"octree {b} has level {cur_level}, expected {level}")
            return False
        start += int(length)
    return True


def tensor_info(t, name='', print_stats=False, detailed=False):
    """One-line human-readable summary of a tensor."""
    if t is None:
        return f"{name}: None"
    info = f"{name}: {tuple(t.shape)} ({t.dtype})"
    if print_stats or detailed:
        arr = _np(t)
        if arr.size > 0 and np.issubdtype(arr.dtype, np.number):
            info += (f" min={arr.min():.4g} max={arr.max():.4g}"
                     f" mean={arr.astype(np.float64).mean():.4g}")
    if detailed:
        arr = _np(t)
        info += f" numel={arr.size}"
    return info


def contained_allclose(left, right, rtol=1e-5, atol=1e-8):
    """Recursively compare containers of tensors / scalars / strings,
    floating values with allclose."""
    if type(left) is not type(right) and not (
            isinstance(left, (int, float)) and isinstance(right, (int, float))):
        if not (hasattr(left, 'shape') and hasattr(right, 'shape')):
            return False
    if isinstance(left, dict):
        if left.keys() != right.keys():
            return False
        return all(contained_allclose(left[k], right[k], rtol, atol)
                   for k in left)
    if isinstance(left, (list, tuple)):
        if len(left) != len(right):
            return False
        return all(contained_allclose(l, r, rtol, atol)
                   for l, r in zip(left, right))
    if isinstance(left, str) or left is None:
        return left == right
    if hasattr(left, 'shape') or isinstance(left, (int, float, bool)):
        left_arr, right_arr = _np(left), _np(right)
        if left_arr.shape != right_arr.shape:
            return False
        if np.issubdtype(left_arr.dtype, np.floating):
            return bool(np.allclose(left_arr, right_arr, rtol=rtol, atol=atol))
        return bool(np.array_equal(left_arr, right_arr))
    return left == right


def check_allclose(tensor, other, rtol=1e-5, atol=1e-8, equal_nan=False):
    """assert_allclose with a readable diff message."""
    tensor = _np(tensor)
    other = _np(other)
    if not np.allclose(tensor, other, rtol=rtol, atol=atol,
                       equal_nan=equal_nan):
        diff = np.abs(tensor.astype(np.float64) - other.astype(np.float64))
        close = np.isclose(tensor, other, rtol=rtol, atol=atol,
                           equal_nan=equal_nan)
        raise ValueError(
            f"Tensors are not close: max abs diff {diff.max()}, "
            f"{int((~close).sum())}/{close.size} mismatched elements")


def contained_equal(elem, other, approximate=False, rtol=1e-5, atol=1e-8):
    """Recursive exact (or allclose) comparison of containers of tensors:
    dicts, (named)tuples, lists, slotted objects, tensors and scalars."""
    if type(elem) is not type(other) and not (
            isinstance(elem, (int, float, bool))
            and isinstance(other, (int, float, bool))):
        if not (hasattr(elem, 'shape') and hasattr(other, 'shape')):
            return False
    if isinstance(elem, dict):
        if elem.keys() != other.keys():
            return False
        return all(contained_equal(elem[k], other[k], approximate, rtol, atol)
                   for k in elem)
    if isinstance(elem, tuple) and hasattr(elem, '_fields'):  # namedtuple
        if set(elem._fields) != set(other._fields):
            return False
        return all(contained_equal(getattr(elem, f), getattr(other, f),
                                   approximate, rtol, atol)
                   for f in elem._fields)
    if isinstance(elem, (list, tuple)):
        if len(elem) != len(other):
            return False
        return all(contained_equal(a, b, approximate, rtol, atol)
                   for a, b in zip(elem, other))
    if isinstance(elem, str) or elem is None:
        return elem == other
    if hasattr(elem, 'shape') or isinstance(elem, (int, float, bool)):
        a, b = _np(elem), _np(other)
        if a.shape != b.shape:
            return False
        if approximate and np.issubdtype(a.dtype, np.floating):
            return bool(np.allclose(a, b, rtol=rtol, atol=atol))
        return bool(np.array_equal(a, b))
    if hasattr(elem, '__slots__'):
        return contained_equal(
            {k: getattr(elem, k) for k in elem.__slots__ if hasattr(elem, k)},
            {k: getattr(other, k) for k in other.__slots__ if hasattr(other, k)},
            approximate, rtol, atol)
    return elem == other


def check_tensor_attribute_shapes(container, throw=True, **attribute_info):
    """Check shapes of named attributes (or dict keys) of ``container``."""
    success = True
    for k, shape in attribute_info.items():
        val = container[k] if isinstance(container, dict) \
            else getattr(container, k)
        if not check_tensor(val, shape=shape, throw=False):
            success = False
            message = (f'Attribute {k} has shape {tuple(val.shape)} '
                       f'(expected {shape})')
            if throw:
                raise ValueError(message)
            logging.error(message)
    return success


def print_dict_attributes(in_dict, name='', prefix='', **tensor_info_kwargs):
    """Print a summary line per dict entry (tensor_info for tensors)."""
    if len(name) > 0:
        print(f'\nAttributes of {name}:')
    for k, v in in_dict.items():
        recurse = False
        if hasattr(v, 'shape') and hasattr(v, 'dtype'):
            tinfo = tensor_info(v, **tensor_info_kwargs)
        elif isinstance(v, (str, int, float)):
            tinfo = v
        elif isinstance(v, dict):
            tinfo = f'{type(v)} of length {len(v)}'
            recurse = True
        elif isinstance(v, (list, tuple)):
            tinfo = f'{type(v)} of length {len(v)}'
        else:
            tinfo = type(v)
        print(f'   {prefix}{k}: {tinfo}')
        if recurse:
            print_dict_attributes(v, prefix='  ', **tensor_info_kwargs)


def print_namedtuple_attributes(ntuple, name='', prefix='',
                                **tensor_info_kwargs):
    """Same as :func:`print_dict_attributes` for a namedtuple."""
    print_dict_attributes(ntuple._asdict(), name=name, prefix=prefix,
                          **tensor_info_kwargs)
