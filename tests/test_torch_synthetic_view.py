"""``import_synthetic_view`` of the port against kaolin_tpu's, on the CPU.

Views in the Omniverse synthetic-data layout written with PIL and numpy:
rgb and normals PNGs (RGBA, the importers drop alpha), linear depth,
semantic and instance maps, and metadata with both 2D boxes.  Images and
maps exact, ``cam_proj`` to 1e-6, the rest of the metadata equal; the
camera helper ``write_synthetic_view`` read back by both packages.
"""
import json
import math

import numpy as np
import pytest
import torch
from PIL import Image

from kaolin_tpu.io.render import import_synthetic_view as import_j
from kaolin_tpu_torch.io.render import import_synthetic_view as import_t
from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.utils.testing import write_synthetic_view

H, W = 24, 40
PROJ_ATOL = 1e-6
FLAGS = dict(rgb=True, depth_linear=True, semantic=True, instance=True,
             normals=True, bbox_2d_tight=True, bbox_2d_loose=True)


def _write_view(root, idx, seed):
    rng = np.random.default_rng(seed)
    for cat in ('rgb', 'normals'):
        img = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
        Image.fromarray(img, 'RGBA').save(root / f'{idx}_{cat}.png')
    np.save(root / f'{idx}_depth_linear.npy',
            rng.random((H, W)).astype(np.float32))
    np.save(root / f'{idx}_semantic.npy',
            rng.integers(0, 4, (H, W)).astype(np.uint32))
    np.save(root / f'{idx}_instance.npy',
            rng.integers(0, 9, (H, W)).astype(np.int32))
    tf = np.eye(4)
    tf[:3, :3] = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    tf[3, :3] = rng.normal(size=3)
    meta = {'camera_properties': {
        'tf_mat': tf.tolist(), 'resolution': {'width': W, 'height': H},
        'focal_length': 24. + seed, 'horizontal_aperture': 20.955,
        'clipping_range': [0.01, 1000.]},
        'asset_transforms': [['/World/a', rng.normal(size=(4, 4)).tolist()]],
        'bbox_2d_tight': [[1, 2, 3, 10, 12]],
        'bbox_2d_loose': [[1, 1, 2, 11, 13]]}
    (root / f'{idx}_metadata.json').write_text(json.dumps(meta))


def _same(out_j, out_t):
    assert sorted(out_j) == sorted(out_t)
    for k in out_j:
        if k == 'metadata':
            continue
        if out_j[k] is None or isinstance(out_j[k], list):
            assert out_j[k] == out_t[k], k
            continue
        assert out_t[k].device.type == 'cpu'
        np.testing.assert_array_equal(np.asarray(out_j[k]),
                                      out_t[k].numpy(), k)
    mj, mt = out_j['metadata'], out_t['metadata']
    for k in ('cam_transform', 'asset_transforms'):
        np.testing.assert_array_equal(np.asarray(mj[k]), mt[k].numpy(), k)
    np.testing.assert_allclose(mt['cam_proj'].numpy(),
                               np.asarray(mj['cam_proj']), rtol=0,
                               atol=PROJ_ATOL)
    assert mj['clipping_range'] == mt['clipping_range']


@pytest.mark.parametrize('flags', [FLAGS, dict(rgb=False, semantic=True)])
def test_import_synthetic_view(tmp_path, flags):
    for idx in range(2):
        _write_view(tmp_path, idx, idx)
    for idx in range(2):
        _same(import_j(str(tmp_path), idx, **flags),
              import_t(str(tmp_path), idx, **flags, device='cpu'))


def test_missing_sensors_are_none(tmp_path):
    _write_view(tmp_path, 0, 0)
    for cat in ('rgb.png', 'instance.npy'):
        (tmp_path / f'0_{cat}').unlink()
    out_t = import_t(str(tmp_path), 0, **FLAGS, device='cpu')
    assert out_t['rgb'] is None and out_t['instance'] is None
    _same(import_j(str(tmp_path), 0, **FLAGS), out_t)


def test_written_cameras_read_back(tmp_path):
    """``write_synthetic_view``'s metadata gives back the cameras that made
    the view, in both packages."""
    fovy = math.pi / 4.
    views = MT.make_views(3, fovy=fovy, device='cpu')
    sil = torch.zeros((H, H), dtype=torch.int32)
    sil[3:9, 4:11] = 1
    for i in range(3):
        write_synthetic_view(str(tmp_path), i, views.camera_rot[i],
                             views.camera_trans[i], fovy, (H, H),
                             semantic=sil, depth_linear=sil.float() * 1.5)
    for i in range(3):
        out_t = import_t(str(tmp_path), i, rgb=False, depth_linear=True,
                         semantic=True, device='cpu')
        out_j = import_j(str(tmp_path), i, rgb=False, depth_linear=True,
                         semantic=True)
        _same(out_j, out_t)
        tf = out_t['metadata']['cam_transform']
        assert torch.equal(tf[:3], views.camera_rot[i])
        assert torch.equal(tf[3], views.camera_trans[i])
        assert torch.equal(out_t['semantic'], sil)
        torch.testing.assert_close(out_t['metadata']['cam_proj'],
                                   views.camera_proj, rtol=0,
                                   atol=PROJ_ATOL)
