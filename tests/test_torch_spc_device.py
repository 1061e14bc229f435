"""Mesh -> SPC builders of the port against the JAX package, on the CPU.

The device builder (float32) and the host builder (numpy float64) of both
packages on the octahedron of ``test_spc_device.py``, on a small UV sphere
and on a tiny triangle at level 12.  Octree bytes and points: exact
everywhere.  face_idx: exact on the octahedron and the triangle, and
between the two packages' builders of the same precision.  On the sphere the
float32 and float64 builders pick another first triangle for 84 of its 968
level-5 voxels (in both packages): voxels that an edge of the lower-id
triangle only grazes, so that the two precisions round the SAT differently;
the test bounds that count and checks that each such triangle passes the
float64 SAT with the voxel grown by 1e-5 and fails it with the voxel shrunk
by 1e-5.  bary: within 1e-5 where face_idx agrees (the JAX device builder
evaluates it in float32, the port's in float64).
"""
import numpy as np
import pytest
import torch

from kaolin_tpu.ops.conversions.trianglemesh import (
    unbatched_mesh_to_spc as jax_host, unbatched_mesh_to_spc_device as
    jax_device)
from kaolin_tpu.ops.spc.spc import scan_octrees as jax_scan
from kaolin_tpu.ops.spc.spc import generate_points as jax_points
from kaolin_tpu.render.spc.raytrace import unbatched_raytrace as jax_bfs
from kaolin_tpu_torch.ops.conversions.trianglemesh import (
    _tri_aabb_sat, unbatched_mesh_to_spc, unbatched_mesh_to_spc_device)
from kaolin_tpu_torch.ops.spc import generate_points, scan_octrees
from kaolin_tpu_torch.ops.spc.device import mesh_to_spc_device
from kaolin_tpu_torch.render.spc import unbatched_raytrace
from kaolin_tpu_torch.utils.testing import uv_sphere

BARY_ATOL = 1e-5


def _octa_mesh():
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float32) * 0.7
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    return verts[faces]


def _sphere_mesh():
    s = uv_sphere(24, 13)
    return (s.vertices * 0.45)[s.faces]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _builds(fv, level, cap=2 ** 16):
    """(port device, port host, JAX device, JAX host), each (octree,
    points, face_idx, bary) as numpy."""
    out = [unbatched_mesh_to_spc_device(torch.as_tensor(fv), level, cap=cap),
           unbatched_mesh_to_spc(fv.astype(np.float64), level),
           jax_device(fv, level, cap=cap),
           jax_host(fv.astype(np.float64), level)]
    return [[_np(x).astype(np.float64) if i == 3 else
             _np(x).astype(np.int64) for i, x in enumerate(b)] for b in out]


@pytest.mark.parametrize('level', [3, 5])
def test_octahedron_exact(level):
    builds = _builds(_octa_mesh(), level)
    ref = builds[3]
    for b in builds[:3]:
        for i in range(3):
            np.testing.assert_array_equal(b[i], ref[i])
        np.testing.assert_allclose(b[3], ref[3], atol=BARY_ATOL)


def test_tiny_triangle_level12():
    fv = np.array([[[0.01, 0.0, 0.0], [0.0, 0.012, 0.0],
                    [0.0, 0.0, 0.009]]], np.float32)
    builds = _builds(fv, 12, cap=2 ** 14)
    ref = builds[3]
    for b in builds[:3]:
        for i in range(3):
            np.testing.assert_array_equal(b[i], ref[i])
        np.testing.assert_allclose(b[3], ref[3], atol=1e-3)


def test_sphere():
    fv = _sphere_mesh()
    level = 5
    dev, host, jdev, jhost = _builds(fv, level)
    for b in (dev, host, jdev):
        np.testing.assert_array_equal(b[0], jhost[0])
        np.testing.assert_array_equal(b[1], jhost[1])
    np.testing.assert_array_equal(host[2], jhost[2])
    np.testing.assert_array_equal(dev[2], jdev[2])
    diff = dev[2] != host[2]
    assert diff.sum() == 84 and len(diff) == 968
    vox = host[1][diff]
    lower = np.minimum(dev[2], host[2])[diff]
    grown = _tri_aabb_sat(fv.astype(np.float64)[lower], vox, level, 1e-5)
    shrunk = _tri_aabb_sat(fv.astype(np.float64)[lower], vox, level, -1e-5)
    assert grown.all() and not shrunk.any()
    same = ~diff
    np.testing.assert_allclose(dev[3][same], host[3][same], atol=BARY_ATOL)


def test_cap():
    fv = torch.as_tensor(_sphere_mesh())
    level = 5
    big = mesh_to_spc_device(fv, level, cap=2 ** 16)
    small = mesh_to_spc_device(fv, level, cap=2 ** 13)
    assert big[6] == small[6] == 968
    for a, b in zip(big[:6], small[:6]):
        if torch.is_tensor(a) and a.shape[0] == 2 ** 16:
            a = a[:2 ** 13]                     # padded to cap: same prefix
        if torch.is_tensor(a) and a.shape[0] == level * 2 ** 16:
            continue                            # per-level blocks of cap
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
    cut = mesh_to_spc_device(fv, level, cap=fv.shape[0])
    assert cut[6] < 968                         # proposals dropped silently
    with pytest.raises(ValueError, match='cap'):
        mesh_to_spc_device(fv, level, cap=fv.shape[0] - 1)


def test_device_octree_raytraceable():
    """Device-built octree -> scan -> points -> BFS, against JAX."""
    level = 4
    fv = _octa_mesh()
    octree, _, _, _ = unbatched_mesh_to_spc_device(torch.as_tensor(fv), level,
                                                   cap=2 ** 12)
    max_level, pyramids, exsum = scan_octrees(octree, [octree.shape[0]])
    assert max_level == level
    ph = generate_points(octree, pyramids, exsum)
    octree_j = jax_device(fv, level, cap=2 ** 12)[0]
    _, pyr_j, ex_j = jax_scan(octree_j, np.array([octree_j.shape[0]]))
    ph_j = jax_points(octree_j, pyr_j, ex_j)
    n = 64
    origin = np.zeros((n, 3), np.float32)
    origin[:, 2] = -2.5
    origin[:, 0] = np.linspace(-0.6, 0.6, n)
    direction = np.zeros((n, 3), np.float32)
    direction[:, 2] = 1.
    out = unbatched_raytrace(octree, ph, pyramids[0], exsum,
                             torch.as_tensor(origin),
                             torch.as_tensor(direction), level)
    ref = jax_bfs(octree_j, ph_j, pyr_j[0], ex_j, origin, direction, level)
    assert out[0].shape[0] > 0
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
