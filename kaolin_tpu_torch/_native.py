"""The port's native host layer: the triangle hash, MISE and the OBJ
tokenizer (``csrc/triangle_hash.cpp``, ``mise.cpp``, ``obj_parser.cpp``).

Port of ``kaolin_tpu/_native.py``.  The three C++ sources are copies of the
JAX package's ``csrc/`` (a test holds them equal).  At first use they are
built with ``g++`` and the JAX package's Makefile flags into one shared
library in ``build/kaolin_tpu_torch/`` at the root of the checkout, keyed
by a hash of the sources and the flags, and opened with ``ctypes``.  The
flags are those of the JAX build, so both packages hash, refine and parse
with the same machine code paths (float64 hash boxes, ``strtof``).

There is no fallback: when ``g++`` cannot be found or the build fails,
:func:`get_lib` raises with the compiler's output, and every consumer
(``io.obj.import_mesh``, ``check_sign(use_hash=True)``,
``sdf_to_voxelgrids``) raises with it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

from kaolin_tpu_torch._cuda import BUILD_DIR

__all__ = ['get_lib', 'TriangleHash', 'Mise', 'parse_obj', 'SOURCES',
           'CXX_FLAGS']

CSRC = Path(__file__).resolve().parent / 'csrc'
SOURCES = ('triangle_hash.cpp', 'mise.cpp', 'obj_parser.cpp')
# csrc/Makefile's CXXFLAGS: other flags could change the hash's float64 boxes
CXX_FLAGS = ('-O3', '-fPIC', '-std=c++17', '-Wall', '-shared')

_lib = None
_LOCK = threading.Lock()


def _build():
    code = b''.join(name.encode() + (CSRC / name).read_bytes()
                    for name in SOURCES)
    digest = hashlib.sha256(code + ' '.join(CXX_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f'libkaolin_tpu_torch_native_{digest[:16]}.so'
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get('CXX', 'g++'))
    if cxx is None:
        raise RuntimeError(
            'g++ not found on PATH: the native host layer of kaolin_tpu_torch '
            '(csrc/triangle_hash.cpp, mise.cpp, obj_parser.cpp) is built from '
            'source at first use and there is no fallback')
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, '-o', tmp, *(str(CSRC / s) for s in SOURCES)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'g++ failed to build the native host layer '
                               f'({", ".join(SOURCES)}):\n'
                               f'{proc.stdout}{proc.stderr}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def get_lib():
    """The ``ctypes.CDLL`` of the native host layer, built on first use;
    raises when it cannot be built."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.th_create.restype = vp
        lib.th_create.argtypes = [vp, i64, ctypes.c_int]
        lib.th_destroy.argtypes = [vp]
        lib.th_query_count.restype = i64
        lib.th_query_count.argtypes = [vp, vp, i64]
        lib.th_query.argtypes = [vp, vp, i64, vp, vp]
        lib.mise_create.restype = vp
        lib.mise_create.argtypes = [i64, i64]
        lib.mise_destroy.argtypes = [vp]
        lib.mise_num_query.restype = i64
        lib.mise_num_query.argtypes = [vp]
        lib.mise_get_query.argtypes = [vp, vp]
        lib.mise_update.argtypes = [vp, vp]
        lib.mise_refine.restype = i64
        lib.mise_refine.argtypes = [vp]
        lib.mise_to_dense.argtypes = [vp, vp]
        lib.obj_parse.restype = vp
        lib.obj_parse.argtypes = [ctypes.c_char_p]
        lib.obj_destroy.argtypes = [vp]
        lib.obj_counts.argtypes = [vp, vp]
        lib.obj_copy.argtypes = [vp] + [vp] * 7
        _lib = lib
        return lib


def _ptr(arr):
    return arr.ctypes.data_as(ctypes.c_void_p)


class TriangleHash:
    """2D spatial hash over triangles, for point-in-triangle candidates.

    Args:
        triangles: ``(F, 3, 2)`` xy of the triangles (taken as float64).
        resolution: cells per side of the hash grid.
    """

    def __init__(self, triangles, resolution=128):
        self._lib = get_lib()
        self._tris = np.ascontiguousarray(triangles, dtype=np.float64)
        if self._tris.ndim != 3 or self._tris.shape[1:] != (3, 2):
            raise ValueError(f'triangles must be (F, 3, 2), got '
                             f'{self._tris.shape}')
        self._h = self._lib.th_create(_ptr(self._tris), self._tris.shape[0],
                                      int(resolution))

    def query(self, points):
        """Candidate (point_idx, tri_idx) int64 pairs for ``(P, 2)``
        points (taken as float64)."""
        pts = np.ascontiguousarray(points, dtype=np.float64)
        n = self._lib.th_query_count(self._h, _ptr(pts), pts.shape[0])
        pidx = np.empty(n, dtype=np.int64)
        tidx = np.empty(n, dtype=np.int32)
        self._lib.th_query(self._h, _ptr(pts), pts.shape[0], _ptr(pidx),
                           _ptr(tidx))
        return pidx, tidx.astype(np.int64)

    def __del__(self):
        if getattr(self, '_h', None):
            self._lib.th_destroy(self._h)
            self._h = None


class Mise:
    """MISE octree refinement of an occupancy grid.

    Usage::

        m = Mise(init_res, upsampling_steps)
        while True:
            pts = m.query()            # (N, 3) int coords, [0, R]
            if pts.shape[0] == 0 and not m.refine():
                break
            if pts.shape[0]:
                m.update(occupancy_at(pts))
        grid = m.to_dense()            # (R+1, R+1, R+1) uint8
    """

    def __init__(self, init_res, upsampling_steps):
        self._lib = get_lib()
        self.final_resolution = init_res * (2 ** upsampling_steps)
        self._h = self._lib.mise_create(int(init_res), int(upsampling_steps))

    def query(self):
        """The ``(N, 3)`` int64 grid points to evaluate next."""
        n = self._lib.mise_num_query(self._h)
        out = np.empty((n, 3), dtype=np.int64)
        if n:
            self._lib.mise_get_query(self._h, _ptr(out))
        return out

    def update(self, occupancies):
        """Occupancy (0 or 1) of the points of the last :meth:`query`."""
        occ = np.ascontiguousarray(occupancies, dtype=np.uint8)
        self._lib.mise_update(self._h, _ptr(occ))

    def refine(self):
        """Double the resolution; 0 once the final one is reached."""
        return int(self._lib.mise_refine(self._h))

    def to_dense(self):
        """The ``(R+1, R+1, R+1)`` uint8 grid (points never evaluated are
        0)."""
        side = self.final_resolution + 1
        out = np.empty((side, side, side), dtype=np.uint8)
        self._lib.mise_to_dense(self._h, _ptr(out))
        return out

    def __del__(self):
        if getattr(self, '_h', None):
            self._lib.mise_destroy(self._h)
            self._h = None


def parse_obj(path):
    """Native OBJ tokenization: each decimal rounds once, straight to
    float32 (``strtof``).

    Returns:
        dict with vertices (V, 3) f32, uvs (T, 2) f32, normals (N, 3) f32,
        face_counts (F,) i64, and flat raw (1-based, 0 = absent) indices
        face_v / face_vt / face_vn.

    Raises:
        IOError: the file cannot be read.
    """
    lib = get_lib()
    h = lib.obj_parse(os.fsencode(path))
    if not h:
        raise IOError(f'failed to open {path!r}')
    try:
        counts = np.empty(5, dtype=np.int64)
        lib.obj_counts(h, _ptr(counts))
        nv, nt, nn, nf, nfv = (int(c) for c in counts)
        vertices = np.empty((nv, 3), dtype=np.float32)
        uvs = np.empty((nt, 2), dtype=np.float32)
        normals = np.empty((nn, 3), dtype=np.float32)
        face_counts = np.empty(nf, dtype=np.int64)
        face_v = np.empty(nfv, dtype=np.int64)
        face_vt = np.empty(nfv, dtype=np.int64)
        face_vn = np.empty(nfv, dtype=np.int64)
        lib.obj_copy(h, _ptr(vertices), _ptr(uvs), _ptr(normals),
                     _ptr(face_counts), _ptr(face_v), _ptr(face_vt),
                     _ptr(face_vn))
        return {'vertices': vertices, 'uvs': uvs, 'normals': normals,
                'face_counts': face_counts, 'face_v': face_v,
                'face_vt': face_vt, 'face_vn': face_vn}
    finally:
        lib.obj_destroy(h)
