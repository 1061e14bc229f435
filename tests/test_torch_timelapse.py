"""``Timelapse`` / ``TimelapseParser`` of the port against kaolin_tpu's.

The same meshes, point clouds and voxel grids logged at the same
iterations by both packages give log directories that are equal file by
file; the parsers index them alike and read the same timestamps.
"""
import filecmp
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaolin_tpu.visualize import timelapse as tl_j
from kaolin_tpu_torch.io import usd as usd_t
from kaolin_tpu_torch.visualize import Timelapse, TimelapseParser
from kaolin_tpu_torch.utils.testing import uv_sphere

ITERATIONS = (0, 5, 10)


def log_both(tmp_path):
    """The same logs by both packages into ``tmp_path/j`` and ``/t``."""
    s = uv_sphere(20, 11)
    rng = np.random.default_rng(8)
    logs = {}
    for side, arr in (('j', jnp.asarray), ('t', torch.as_tensor)):
        t = (tl_j.Timelapse if side == 'j' else Timelapse)(
            str(tmp_path / side))
        for it in ITERATIONS:
            r = np.random.default_rng(it)
            v = (s.vertices + 0.01 * r.standard_normal(
                s.vertices.shape)).astype(np.float32)
            pts = r.standard_normal((2, 300, 3)).astype(np.float32)
            col = r.random((300, 3), dtype=np.float32)
            grid = r.random((8, 8, 8)) > 0.6
            t.add_mesh_batch(iteration=it, category='fit',
                             vertices_list=[arr(v), arr(v * 2)],
                             faces_list=[arr(s.faces)] * 2,
                             uvs_list=[arr(s.uvs.astype(np.float32))] * 2,
                             face_uvs_idx_list=[arr(s.face_uvs_idx)] * 2)
            t.add_pointcloud_batch(iteration=it, category='samples',
                                   pointcloud_list=[arr(p) for p in pts],
                                   colors_list=[arr(col), arr(col)])
            t.add_voxelgrid_batch(iteration=it, category='fit/vox',
                                  voxelgrid_list=[arr(grid)])
        logs[side] = t
    return rng


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_log_directories_equal(tmp_path):
    log_both(tmp_path)
    files = _files(tmp_path / 'j')
    assert files == _files(tmp_path / 't') and len(files) == 5
    match, mismatch, errors = filecmp.cmpfiles(tmp_path / 'j', tmp_path / 't',
                                               files, shallow=False)
    assert match == files and not mismatch and not errors


@pytest.mark.parametrize('kind,category,n', [('mesh', 'fit', 2),
                                             ('pointcloud', 'samples', 2),
                                             ('voxelgrid', 'fit/vox', 1)])
def test_parser_equal(tmp_path, kind, category, n):
    log_both(tmp_path)
    p_j = tl_j.TimelapseParser(str(tmp_path / 't'))
    p_t = TimelapseParser(str(tmp_path / 't'))
    assert p_t.dir_info == p_j.dir_info
    assert len(p_t.dir_info[kind]) == n
    for i in range(n):
        assert p_t.get_timestamps(kind, category, i) == \
            p_j.get_timestamps(kind, category, i) == [0., 5., 10.]
    assert p_t.get_file_path(kind, category, n) is None
    assert p_t.get_timestamps(kind, 'nope', 0) == []
    assert p_t.num_mesh_items() == p_j.num_mesh_items() == 2
    assert p_t.num_pointcloud_categories() == 1
    assert p_t.num_voxelgrid_items() == 1


def test_read_back_bits(tmp_path):
    log_both(tmp_path)
    s = uv_sphere(20, 11)
    v = (s.vertices + 0.01 * np.random.default_rng(10).standard_normal(
        s.vertices.shape)).astype(np.float32)
    path = TimelapseParser(str(tmp_path / 't')).get_file_path('mesh', 'fit', 1)
    m = usd_t.import_mesh(path, '/mesh_1', time=10, device='cpu')
    np.testing.assert_array_equal(m.vertices.numpy().view(np.uint32),
                                  (v * 2).view(np.uint32))
    np.testing.assert_array_equal(m.faces.numpy(), s.faces)
