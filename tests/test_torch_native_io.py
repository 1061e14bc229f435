"""The port's native host layer against kaolin_tpu's.

The port builds its own copies of ``csrc/*.cpp`` (held equal here) with the
JAX package's flags; the JAX side is asserted to have loaded its native
library, so it takes its native paths and not its silent fallbacks.  Exact
equality everywhere: the OBJ tokenizer's arrays bit for bit (also for
decimals near the midpoint of two float32 values, which a parse through
float64 rounds twice), the OBJ and OFF importers, and
``check_sign(use_hash=True)``, whose strict edge rule differs from the
vectorised path's on points whose xy lie on a face edge's projection.
"""
import fcntl
import importlib
import os
import subprocess
from decimal import Decimal, localcontext
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaolin_tpu.io import obj as obj_j
from kaolin_tpu.io import off as off_j
from kaolin_tpu.io import utils as utils_j
from kaolin_tpu_torch import _native
from kaolin_tpu_torch.io import obj as obj_t
from kaolin_tpu_torch.io import off as off_t
from kaolin_tpu_torch.io.utils import mesh_handler_naive_triangulate
from kaolin_tpu_torch.utils.testing import uv_sphere, write_sphere_obj

# the packages' ``ops.mesh`` export the function under the module's name
check_sign_j = importlib.import_module('kaolin_tpu.ops.mesh.check_sign')
check_sign_t = importlib.import_module('kaolin_tpu_torch.ops.mesh.check_sign')

ROOT = Path(__file__).resolve().parents[1]


def jax_native():
    """kaolin_tpu's ``_native`` with its library loaded.  The library is
    built once, under a file lock, into a temporary name and moved into
    place, so that no test worker loads a half-written file."""
    from kaolin_tpu import _native as nat
    lock = ROOT / 'build' / 'kaolin_tpu_native.lock'
    lock.parent.mkdir(parents=True, exist_ok=True)
    with open(lock, 'w') as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        if not os.path.exists(nat._LIB_PATH):
            tmp = f'libkaolin_tpu_native.{os.getpid()}.tmp.so'
            subprocess.run(['make', '-C', nat._CSRC_DIR, f'TARGET={tmp}'],
                           check=True, capture_output=True)
            os.replace(os.path.join(nat._CSRC_DIR, tmp), nat._LIB_PATH)
        assert nat.get_lib() is not None
    return nat


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize('name', _native.SOURCES)
def test_sources_are_copies(name):
    assert (ROOT / 'kaolin_tpu_torch' / 'csrc' / name).read_bytes() == \
        (ROOT / 'csrc' / name).read_bytes()


@pytest.mark.parametrize('cxx', ['no-such-compiler', 'false'])
def test_failed_build_raises(tmp_path, monkeypatch, cxx):
    monkeypatch.setattr(_native, 'BUILD_DIR', tmp_path)
    monkeypatch.setattr(_native, '_lib', None)
    monkeypatch.setenv('CXX', cxx)
    with pytest.raises(RuntimeError, match='g\\+\\+'):
        _native.get_lib()
    with pytest.raises(RuntimeError):
        obj_t.import_mesh(str(tmp_path / 'x.obj'), device='cpu')


def _write(path, text):
    path.write_text(text)
    return str(path)


def _obj_cases(tmp_path):
    """OBJ texts: the sphere (v/vt), quads with normals and negative
    indices, and a mesh of triangles and quads."""
    s = uv_sphere(20, 11)
    sphere = write_sphere_obj(str(tmp_path), s)
    quads = _write(tmp_path / 'quads.obj', '\n'.join(
        ['# quads', 'v 0 0 0', 'v 1 0 0', 'v 1 1 0', 'v 0 1 0',
         'v 0 0 1', 'v 1 0 1', 'vn 0 0 1', 'vn 0 0 -1', 'vt 0 0',
         'vt 1 0', 'vt 1 1', 'vt 0 1',
         'f 1/1/1 2/2/1 3/3/1 4/4/1', 'f -6/-4/-2 -5/-3/-2 -1/-2/-1 -2/-1/-1',
         '']))
    mixed = _write(tmp_path / 'mixed.obj', '\n'.join(
        ['v 0 0 0', 'v 1 0 0', 'v 1 1 0', 'v 0 1 0', 'v 2 0 0',
         'f 1 2 3 4', 'f 2 5 3', '']))
    return dict(sphere=sphere, quads=quads, mixed=mixed)


def test_parse_obj_equal(tmp_path):
    nat = jax_native()
    for name, path in _obj_cases(tmp_path).items():
        a, b = _native.parse_obj(path), nat.parse_obj(path)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]),
                                          err_msg=f'{name}: {k}')
    with pytest.raises(IOError):
        _native.parse_obj(str(tmp_path / 'missing.obj'))


def _near_midpoints(n, seed):
    """Decimals within a quarter float64 ulp of the midpoint of two
    adjacent float32 values, above or below it: float64 reads each as the
    midpoint, and float32 then breaks the tie to even, half of the time on
    the wrong side."""
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-2., 2., n).astype(np.float32)
    hi = np.nextafter(lo, np.float32(np.inf))
    mid = (lo.astype(np.float64) + hi.astype(np.float64)) / 2
    out = []
    with localcontext() as ctx:
        ctx.prec = 200
        for m, sign in zip(mid, rng.choice([-1, 1], n)):
            quarter_ulp = Decimal(float(np.spacing(m))) / 4
            out.append(format(Decimal(float(m)) + sign * quarter_ulp, 'f'))
    return out


def test_double_rounding(tmp_path):
    """1 + 2^-24 + 2^-55 lies just above the midpoint of 1 and the next
    float32: read once it is 1.0000001, through float64 it is 1.0."""
    with localcontext() as ctx:
        ctx.prec = 200
        first = format(Decimal(1) + Decimal(2) ** -24 + Decimal(2) ** -55,
                       'f')
    decimals = [first] + _near_midpoints(599, 0)
    coords = np.asarray(decimals).reshape(-1, 3)
    path = _write(tmp_path / 'mid.obj', '\n'.join(
        [f'v {x} {y} {z}' for x, y, z in coords] + ['f 1 2 3', '']))
    v_j = np.asarray(obj_j.import_mesh(path).vertices)
    assert jax_native() is not None
    v_t = obj_t.import_mesh(path, device='cpu').vertices.numpy()
    assert v_t[0, 0] == np.nextafter(np.float32(1), np.float32(2))
    np.testing.assert_array_equal(_bits(v_t), _bits(v_j))
    # the decimals are near midpoints: a parse through float64 misses some
    twice = np.asarray([float(d) for d in decimals],
                       np.float64).astype(np.float32).reshape(-1, 3)
    assert (_bits(twice) != _bits(v_j)).sum() > 100


@pytest.mark.parametrize('case', ['sphere', 'quads', 'mixed'])
@pytest.mark.parametrize('handler', [None, 'triangulate', 'skip'])
@pytest.mark.parametrize('with_normals', [False, True])
def test_import_mesh_native_equal(tmp_path, case, handler, with_normals):
    jax_native()
    path = _obj_cases(tmp_path)[case]
    kw = dict(with_normals=with_normals)
    if handler == 'triangulate':
        kw_j = dict(kw, heterogeneous_mesh_handler=(
            utils_j.mesh_handler_naive_triangulate))
        kw_t = dict(kw, heterogeneous_mesh_handler=(
            mesh_handler_naive_triangulate))
    elif handler == 'skip':
        kw_j = dict(kw, heterogeneous_mesh_handler=lambda *a, **k: None)
        kw_t = kw_j
    else:
        kw_j = kw_t = kw
    try:
        m_j = obj_j.import_mesh(path, **kw_j)
    except Exception as e:          # the JAX importer raises: so must we
        with pytest.raises(Exception) as info:
            obj_t.import_mesh(path, device='cpu', **kw_t)
        assert type(info.value).__name__ == type(e).__name__
        return
    m_t = obj_t.import_mesh(path, device='cpu', **kw_t)
    if m_j is None:
        assert m_t is None
        return
    for name in ('vertices', 'faces', 'uvs', 'face_uvs_idx', 'normals',
                 'face_normals_idx'):
        a, b = getattr(m_j, name), getattr(m_t, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert b.device.type == 'cpu'
            np.testing.assert_array_equal(_bits(b.numpy()),
                                          _bits(np.asarray(a)),
                                          err_msg=name)


@pytest.mark.parametrize('with_face_colors', [False, True])
@pytest.mark.parametrize('header', ['OFF\n5 3 0', 'OFF5 3', '# c\n5 3 0'])
def test_off_equal(tmp_path, with_face_colors, header):
    text = '\n'.join([header, '0 0 0', '1 0 0.5', '1 1 0', '0 1 0',
                      '# comment', '0.25 0.125 1',
                      '3 0 1 2 255 0 0', '3 0 2 3 0 255 0',
                      '3 1 2 4 0 0 255', ''])
    path = _write(tmp_path / 'm.off', text)
    a = off_j.import_mesh(path, with_face_colors=with_face_colors)
    b = off_t.import_mesh(path, with_face_colors=with_face_colors,
                          device='cpu')
    np.testing.assert_array_equal(_bits(b.vertices.numpy()),
                                  _bits(np.asarray(a.vertices)))
    np.testing.assert_array_equal(b.faces.numpy(), np.asarray(a.faces))
    assert b.faces.dtype == torch.int64
    if with_face_colors:
        np.testing.assert_array_equal(b.face_colors.numpy(),
                                      np.asarray(a.face_colors))
    else:
        assert a.face_colors is None and b.face_colors is None


def box_mesh(n=4, half=0.5):
    """A closed box [-half, half]^3, each side an n x n grid of quads cut
    into two triangles each; every coordinate is a multiple of 2 half / n,
    so the edges' xy projections lie on exact lines."""
    ax = np.linspace(-half, half, n + 1)
    verts, faces = [], []
    for axis in range(3):
        for side in (-half, half):
            base = len(verts)
            for i in ax:
                for j in ax:
                    p = [0., 0., 0.]
                    p[axis] = side
                    p[(axis + 1) % 3], p[(axis + 2) % 3] = i, j
                    verts.append(p)
            for i in range(n):
                for j in range(n):
                    a = base + i * (n + 1) + j
                    b, c, d = a + n + 1, a + 1, a + n + 2
                    tri = [[a, b, d], [a, d, c]]
                    if side < 0:
                        tri = [t[::-1] for t in tri]
                    faces += tri
    verts = np.asarray(verts, np.float32)
    # weld the shared edges' vertices
    uniq, inv = np.unique(verts, axis=0, return_inverse=True)
    return uniq.astype(np.float32), inv.reshape(-1)[np.asarray(faces)]


def _hash_scenes():
    rng = np.random.default_rng(3)
    s = uv_sphere(20, 11)
    sv = (s.vertices * 0.45).astype(np.float32)
    sphere_pts = rng.uniform(-0.6, 0.6, (2, 3000, 3)).astype(np.float32)
    sphere_v = np.stack([sv, (sv * [1.1, 0.9, 1.] + 0.03).astype(
        np.float32)])
    bv, bf = box_mesh()
    grid = np.linspace(-0.5, 0.5, 5).astype(np.float32)
    box_pts = rng.uniform(-0.7, 0.7, (1, 4000, 3)).astype(np.float32)
    # xy on the grid's lines (edges), on its nodes (vertices) and on the
    # quads' diagonals x - y = const
    box_pts[0, :1000, 0] = rng.choice(grid, 1000)
    box_pts[0, 1000:2000, 1] = rng.choice(grid, 1000)
    box_pts[0, 2000:2500, :2] = rng.choice(grid, (500, 2))
    box_pts[0, 2500:3000, 1] = (box_pts[0, 2500:3000, 0]
                                - rng.choice(grid, 500)).astype(np.float32)
    box_pts[0, :, 2] = np.where(np.abs(np.abs(box_pts[0, :, 2]) - 0.5) < 1e-3,
                                0.25, box_pts[0, :, 2])
    return dict(sphere=(sphere_v, s.faces, sphere_pts),
                box=(bv[None], bf, box_pts))


@pytest.mark.parametrize('resolution', [512, 7])
@pytest.mark.parametrize('case', ['sphere', 'box'])
def test_check_sign_hash_equal(case, resolution):
    jax_native()
    verts, faces, pts = _hash_scenes()[case]
    in_j = np.asarray(check_sign_j.check_sign(
        jnp.asarray(verts), faces, jnp.asarray(pts), use_hash=True,
        hash_resolution=resolution))
    in_t = check_sign_t.check_sign(torch.as_tensor(verts),
                                   torch.as_tensor(faces),
                                   torch.as_tensor(pts), use_hash=True,
                                   hash_resolution=resolution)
    assert in_t.dtype == torch.bool and in_t.shape == pts.shape[:2]
    np.testing.assert_array_equal(in_t.numpy(), in_j)
    # numpy inputs with a device asked for
    np.testing.assert_array_equal(check_sign_t.check_sign(
        verts, faces, pts, use_hash=True, hash_resolution=resolution,
        device='cpu').numpy(), in_j)
    if case == 'box':
        # the strict rule differs from the vectorised one on the edges
        vec = check_sign_t.check_sign(torch.as_tensor(verts),
                                      torch.as_tensor(faces),
                                      torch.as_tensor(pts)).numpy()
        assert (vec != in_j).any()
        inside = (np.abs(pts[0]) < 0.5).all(-1)
        off_lines = slice(3000, None)
        np.testing.assert_array_equal(in_j[0, off_lines], inside[off_lines])


def test_check_sign_hash_chunked(monkeypatch):
    """The device test taken a few hundred pairs at a time gives the same
    flags."""
    jax_native()
    verts, faces, pts = _hash_scenes()['sphere']
    args = (torch.as_tensor(verts), torch.as_tensor(faces),
            torch.as_tensor(pts))
    whole = check_sign_t.check_sign(*args, use_hash=True)
    monkeypatch.setattr(check_sign_t, '_CHUNK_PAIRS', 333)
    assert torch.equal(check_sign_t.check_sign(*args, use_hash=True), whole)
