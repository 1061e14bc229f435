"""The port's voxelizations against the JAX package, on the CPU.

``pointclouds_to_voxelgrids`` (given and default normalization, points
off the grid), ``unbatched_pointcloud_to_spc`` (octree exact, averaged
features within 1e-6: the port sums on the device in another order),
``_unbatched_subdivide_vertices`` and ``trianglemeshes_to_voxelgrids``
(exact: the same float32 arithmetic on both sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.ops import conversions as J
from kaolin_tpu.ops.mesh.trianglemesh import (
    _unbatched_subdivide_vertices as subdivide_j)
from kaolin_tpu_torch.ops import conversions as T
from kaolin_tpu_torch.ops.mesh.trianglemesh import (
    _unbatched_subdivide_vertices as subdivide_t)
from kaolin_tpu_torch.utils.testing import uv_sphere


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize('resolution', [3, 8, 17])
def test_pointclouds_to_voxelgrids(resolution):
    rng = np.random.default_rng(resolution)
    pts = rng.normal(size=(2, 300, 3)).astype(np.float32)
    _eq(J.pointclouds_to_voxelgrids(jnp.asarray(pts), resolution),
        T.pointclouds_to_voxelgrids(torch.as_tensor(pts), resolution))
    # a given box that leaves points off the grid
    origin = np.full((2, 3), -1., np.float32)
    scale = np.array([2., 1.5], np.float32)
    vj = J.pointclouds_to_voxelgrids(jnp.asarray(pts), resolution,
                                     jnp.asarray(origin), jnp.asarray(scale))
    vt = T.pointclouds_to_voxelgrids(torch.as_tensor(pts), resolution,
                                     torch.as_tensor(origin),
                                     torch.as_tensor(scale))
    _eq(vj, vt)
    assert 0 < int(vt.sum()) < 600


def test_pointclouds_to_voxelgrids_doctest():
    vg = T.pointclouds_to_voxelgrids(
        torch.tensor([[[0., 0., 0.], [1., 1., 1.], [2., 2., 2.]]]), 3)
    expected = np.zeros((3, 3, 3))
    expected[0, 0, 0] = expected[1, 1, 1] = expected[2, 2, 2] = 1.
    np.testing.assert_array_equal(vg[0].numpy(), expected)
    with pytest.raises(TypeError):
        T.pointclouds_to_voxelgrids(torch.zeros((1, 2, 3)), 3.)


@pytest.mark.parametrize('level', [2, 3, 5])
def test_unbatched_pointcloud_to_spc(level):
    rng = np.random.default_rng(level)
    pts = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    feats = rng.normal(size=(400, 4)).astype(np.float32)
    sj = J.unbatched_pointcloud_to_spc(jnp.asarray(pts), level,
                                       jnp.asarray(feats))
    st = T.unbatched_pointcloud_to_spc(torch.as_tensor(pts), level,
                                       torch.as_tensor(feats))
    _eq(sj.octrees, st.octrees)
    _eq(sj.lengths, st.lengths)
    assert st.max_level == level
    np.testing.assert_allclose(st.features.numpy(), np.asarray(sj.features),
                               rtol=0, atol=1e-6)
    assert st.features.shape == (int(st.pyramids[0, 0, level]), 4)
    assert T.unbatched_pointcloud_to_spc(torch.as_tensor(pts),
                                         level).features is None


@pytest.mark.parametrize('resolution', [4, 16])
def test_subdivide_vertices(resolution):
    s = uv_sphere(12, 7)
    v = ((s.vertices + 1.) / 2.).astype(np.float32)
    _eq(subdivide_j(jnp.asarray(v), s.faces, resolution),
        subdivide_t(torch.as_tensor(v), s.faces, resolution))


@pytest.mark.parametrize('resolution', [3, 16, 32])
def test_trianglemeshes_to_voxelgrids(resolution):
    s = uv_sphere(16, 9)
    rng = np.random.default_rng(resolution)
    verts = np.stack([s.vertices, s.vertices * 0.7 + rng.uniform(
        -0.2, 0.2, 3)]).astype(np.float32)
    vj = J.trianglemeshes_to_voxelgrids(jnp.asarray(verts), s.faces,
                                        resolution)
    vt = T.trianglemeshes_to_voxelgrids(torch.as_tensor(verts), s.faces,
                                        resolution)
    _eq(vj, vt)
    assert vt.shape == (2,) + (resolution,) * 3 and int(vt.sum()) > 0
    origin = np.full((2, 3), -1., np.float32)
    scale = np.full((2,), 2., np.float32)
    _eq(J.trianglemeshes_to_voxelgrids(jnp.asarray(verts), s.faces,
                                       resolution, jnp.asarray(origin),
                                       jnp.asarray(scale)),
        T.trianglemeshes_to_voxelgrids(torch.as_tensor(verts), s.faces,
                                       resolution, torch.as_tensor(origin),
                                       torch.as_tensor(scale)))


def test_trianglemeshes_to_voxelgrids_doctest():
    vg = T.trianglemeshes_to_voxelgrids(
        torch.tensor([[[0., 0., 0.], [1., 0., 0.], [0., 0., 1.]]]),
        np.array([[0, 1, 2]]), 3)
    expected = np.zeros((3, 3, 3))
    expected[0, 0, :] = 1.
    expected[1, 0, 0] = expected[1, 0, 1] = 1.
    expected[2, 0, 0] = 1.
    np.testing.assert_array_equal(vg[0].numpy(), expected)
