"""Path G at small size on the CPU, the port against kaolin_tpu.

The slice of ``chip_smoke.py``'s phase 23 at 64^2, 2 views and
``uv_sphere(20, 11)`` models: a ShapeNetV2 tree -> ``ShapeNetV2`` ->
``ProcessedDataset`` -> ``CachedDataset`` in both packages (the same
arrays) -> each model's silhouette and linear depth rendered by the port
(``'jnp'``) and written as synthetic views -> ``import_synthetic_view`` in
both packages -> ``CameraViews`` from the metadata -> one
silhouette-plus-depth step (DIB-R soft mask and ``mask_iou``, L1 of the
interpolated depth where both cover) from a radius-0.45 sphere, with the
``'jnp'`` pair on both sides.

Limits: the arrays and views exact, the cameras equal (``cam_proj`` to
1e-6); the loss within 1e-5 relative, the vertex gradient within 1e-4 of
its largest entry (the same float32 arithmetic, summed in other orders).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.io import dataset as dj
from kaolin_tpu.io import shapenet as snj
from kaolin_tpu.io.render import import_synthetic_view as import_j
from kaolin_tpu.metrics.render import mask_iou as mask_iou_j
from kaolin_tpu.models import inverse_render as MJ
from kaolin_tpu.render.mesh import (dibr_rasterization as dibr_j,
                                    prepare_vertices as prepare_j)
from kaolin_tpu_torch.io import dataset as dt
from kaolin_tpu_torch.io import shapenet as snt
from kaolin_tpu_torch.io.render import import_synthetic_view as import_t
from kaolin_tpu_torch.metrics.render import mask_iou as mask_iou_t
from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.render.mesh import (dibr_rasterization as dibr_t,
                                          prepare_vertices as prepare_t)
from kaolin_tpu_torch.utils.testing import (mesh_arrays, uv_sphere,
                                            write_shapenet_v2,
                                            write_synthetic_view)

H = 64
VIEWS = 2
SPHERE = (20, 11)
FOVY = math.pi / 4.
FIT_RADIUS = 0.45
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4
PROJ_ATOL = 1e-6

pytestmark = pytest.mark.filterwarnings('ignore::DeprecationWarning')


def _arrays_j(item):
    mesh = item['mesh']
    return {'vertices': mesh.vertices, 'faces': mesh.faces,
            'face_uvs': np.asarray(mesh.uvs)[np.asarray(mesh.face_uvs_idx)]}


def render_t(vertices, views, faces):
    """The port's depth, soft mask and face ids, as chip_smoke's path G."""
    B = views.camera_rot.shape[0]
    fvc, fvi, fn = prepare_t(vertices[None].expand(B, -1, -1), faces,
                             views.camera_proj, camera_rot=views.camera_rot,
                             camera_trans=views.camera_trans)
    depth, soft, fid = dibr_t(H, H, fvc[..., 2], fvi, -fvc[..., 2:3],
                              fn[..., 2], rast_backend='jnp')
    return depth[..., 0], soft, fid


def loss_t(vertices, views, faces, sil, depth):
    d, soft, fid = render_t(vertices, views, faces)
    both = (fid >= 0) & (sil > 0)
    l1 = (torch.where(both, (d - depth).abs(), 0.).sum()
          / both.sum().clamp(min=1))
    return mask_iou_t(soft, sil.float()) + l1


def loss_j(vertices, views, faces, sil, depth):
    B = views.camera_rot.shape[0]
    fvc, fvi, fn = prepare_j(
        jnp.broadcast_to(vertices[None], (B,) + vertices.shape), faces,
        views.camera_proj, camera_rot=views.camera_rot,
        camera_trans=views.camera_trans)
    d, soft, fid = dibr_j(H, H, fvc[..., 2], fvi, -fvc[..., 2:3],
                          fn[..., 2], rast_backend='jnp')
    both = (fid >= 0) & (sil > 0)
    l1 = (jnp.where(both, jnp.abs(d[..., 0] - depth), 0.).sum()
          / jnp.maximum(both.sum(), 1))
    return mask_iou_j(soft, sil.astype(jnp.float32)) + l1


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('path_g')
    write_shapenet_v2(str(tmp / 'shapenet'), ('02691156', '03001627'), 3,
                      SPHERE)
    kw = dict(root=str(tmp / 'shapenet'), train=True, split=0.67)
    cache_t = dt.CachedDataset(
        dt.ProcessedDataset(snt.ShapeNetV2(**kw, device='cpu'), mesh_arrays),
        str(tmp / 'cache_t'), save_on_disk=True, device='cpu')
    cache_j = dj.CachedDataset(
        dj.ProcessedDataset(snj.ShapeNetV2(**kw), _arrays_j),
        str(tmp / 'cache_j'), save_on_disk=True)
    model = cache_t[0]
    views = MT.make_views(VIEWS, fovy=FOVY, device='cpu')
    with torch.no_grad():
        depth, _, fid = render_t(model['vertices'], views, model['faces'])
    sil = (fid >= 0).to(torch.int32)
    depth = torch.where(fid >= 0, depth, 0.)
    for i in range(VIEWS):
        write_synthetic_view(str(tmp / 'views'), i, views.camera_rot[i],
                             views.camera_trans[i], FOVY, (H, H),
                             semantic=sil[i], depth_linear=depth[i])
    kw = dict(rgb=False, depth_linear=True, semantic=True)
    back_t = [import_t(str(tmp / 'views'), i, **kw, device='cpu')
              for i in range(VIEWS)]
    back_j = [import_j(str(tmp / 'views'), i, **kw) for i in range(VIEWS)]
    return dict(cache_t=cache_t, cache_j=cache_j, views=views, sil=sil,
                depth=depth, back_t=back_t, back_j=back_j)


def test_datasets_agree(chain):
    ct, cj = chain['cache_t'], chain['cache_j']
    assert len(ct) == len(cj) == 4
    for i in range(4):
        for k in ('vertices', 'faces', 'face_uvs'):
            np.testing.assert_array_equal(ct[i][k].numpy(),
                                          np.asarray(cj[i][k]), k)


def _cameras_t(back):
    md = [b['metadata'] for b in back]
    return MT.CameraViews(torch.stack([m['cam_transform'][:3] for m in md]),
                          torch.stack([m['cam_transform'][3] for m in md]),
                          md[0]['cam_proj'])


def _cameras_j(back):
    md = [b['metadata'] for b in back]
    return MJ.CameraViews(jnp.stack([m['cam_transform'][:3] for m in md]),
                          jnp.stack([m['cam_transform'][3] for m in md]),
                          md[0]['cam_proj'])


def test_views_and_cameras(chain):
    cams_t, cams_j = _cameras_t(chain['back_t']), _cameras_j(chain['back_j'])
    views = chain['views']
    assert torch.equal(cams_t.camera_rot, views.camera_rot)
    assert torch.equal(cams_t.camera_trans, views.camera_trans)
    for a, b in zip(cams_t, cams_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=PROJ_ATOL)
    for i, (bt, bj) in enumerate(zip(chain['back_t'], chain['back_j'])):
        for k in ('semantic', 'depth_linear'):
            np.testing.assert_array_equal(bt[k].numpy(), np.asarray(bj[k]))
        assert torch.equal(bt['semantic'], chain['sil'][i])
        assert torch.equal(bt['depth_linear'], chain['depth'][i])


def test_silhouette_depth_step(chain):
    s = uv_sphere(*SPHERE)
    v0 = (s.vertices * FIT_RADIUS).astype(np.float32)
    faces = np.asarray(chain['cache_t'][0]['faces'])
    np.testing.assert_array_equal(faces, s.faces)
    sil_t = torch.stack([b['semantic'] for b in chain['back_t']])
    depth_t = torch.stack([b['depth_linear'] for b in chain['back_t']])
    v = torch.as_tensor(v0).requires_grad_()
    loss = loss_t(v, _cameras_t(chain['back_t']), torch.as_tensor(faces),
                  sil_t, depth_t)
    loss.backward()
    sil_j = jnp.stack([b['semantic'] for b in chain['back_j']])
    depth_j = jnp.stack([b['depth_linear'] for b in chain['back_j']])
    cams_j = _cameras_j(chain['back_j'])
    lj, gj = jax.jit(jax.value_and_grad(loss_j))(jnp.asarray(v0), cams_j,
                                                jnp.asarray(faces), sil_j,
                                                depth_j)
    assert 0. < float(lj) < 1.
    assert abs(loss.item() - float(lj)) <= LOSS_RTOL * abs(float(lj))
    gj = np.asarray(gj)
    scale = np.abs(gj).max()
    assert scale > 0
    np.testing.assert_allclose(v.grad.numpy(), gj, rtol=0,
                               atol=GRAD_REL * scale)
