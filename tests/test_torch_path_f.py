"""Path F at small size on the CPU, the port against kaolin_tpu.

The DIB-R fit of ``examples/dibr_inverse_rendering.py`` with ``--logdir``:
64^2, one view, ``backend='jnp'`` on both sides, Adam at lr 5e-3 for 3
steps from the same perturbed start toward the same targets, a Timelapse
of the mesh and of a point cloud (shared numpy draws on the faces) at the
start of every step, a checkpoint after step 1 that is loaded back and
resumed through ``compiled_step`` built on the loaded state (its build's
warm-up steps put that state back bit for bit); then a MISE extraction
(``init_res=8``, 2 steps) of the fitted mesh with
``check_sign(use_hash=True)`` as the occupancy.

Limits: the fitted vertices within 2e-5 of the JAX loop's (Adam at lr 5e-3
moves them by up to 1.5e-2; the two sides' gradients agree to 1e-4 of
their largest, ``test_torch_kbuffer.py``; measured 2.1e-6); the Timelapse
files hold the same prims, attributes, indices and timestamps, the points
of the first sample bit for bit and of later samples within 4e-5; the resumed
step equal to the step from the state in memory bit for bit (the CPU sums
in a fixed order); the MISE grids of the same fitted vertices equal.
"""
import copy
import importlib
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from kaolin_tpu.models import inverse_render as MJ
from kaolin_tpu.ops.conversions import sdf as sdf_j
from kaolin_tpu.visualize import timelapse as tl_j
from kaolin_tpu_torch.io.usd import usda
from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.ops.conversions import sdf_to_voxelgrids
from kaolin_tpu_torch.ops.mesh.check_sign import check_sign
from kaolin_tpu_torch.utils import checkpoint as ckpt
from kaolin_tpu_torch.utils.testing import uv_sphere
from kaolin_tpu_torch.visualize import Timelapse, TimelapseParser
from tests.test_torch_native_io import jax_native

check_sign_j = importlib.import_module('kaolin_tpu.ops.mesh.check_sign')

H = 64
VIEWS = 1
STEPS = 3
LR = 5e-3
KNUM = 30
POINTS = 500
SAVE_AFTER = 1               # then one more step: STEPS == SAVE_AFTER + 2
VERT_ATOL = 2e-5            # measured 2.1e-6 after 3 steps
MISE = dict(init_res=8, upsampling_steps=2, bbox_dim=1.1)


def _scene():
    s = uv_sphere(20, 11)
    rng = np.random.default_rng(0)
    v = s.vertices.astype(np.float32)
    v = (v - (v.min(0) + v.max(0)) / 2) / (v.max(0) - v.min(0)).max()
    tex = rng.random((3, 16, 16), dtype=np.float32)
    sh = np.zeros(9, np.float32)
    sh[0] = 3.
    start = (v + 0.05 * rng.standard_normal(v.shape)).astype(np.float32)
    draws = dict(face=rng.integers(0, s.faces.shape[0], POINTS),
                 u=rng.random(POINTS, dtype=np.float32),
                 v=rng.random(POINTS, dtype=np.float32))
    return dict(gt=v.astype(np.float32), start=start, tex=tex, sh=sh,
                faces=s.faces, face_uvs=s.uvs[s.face_uvs_idx].astype(
                    np.float32), uvs=s.uvs.astype(np.float32),
                face_uvs_idx=s.face_uvs_idx, draws=draws)


def _points(verts, faces, d):
    """Points on the faces from shared draws (the same formula on both
    sides; numpy)."""
    v0, v1, v2 = (np.asarray(verts)[faces[d['face'], k]] for k in range(3))
    su = np.sqrt(d['u'])[:, None]
    return ((1 - su) * v0 + su * (1 - d['v'][:, None]) * v1
            + su * d['v'][:, None] * v2).astype(np.float32)


def _log(tl, it, verts, sc):
    tl.add_mesh_batch(iteration=it, category='fit', vertices_list=[verts],
                      faces_list=[sc['faces']], uvs_list=[sc['uvs']],
                      face_uvs_idx_list=[sc['face_uvs_idx']])
    tl.add_pointcloud_batch(iteration=it, category='fit', pointcloud_list=[
        _points(verts, sc['faces'], sc['draws'])])


def run_jax(sc, logdir):
    views = MJ.make_views(VIEWS)
    faces, face_uvs = jnp.asarray(sc['faces']), jnp.asarray(sc['face_uvs'])
    gt = MJ.InverseRenderParams(*map(jnp.asarray, (sc['gt'], sc['tex'],
                                                   sc['sh'])))
    images, masks, _ = MJ.render_views(gt, views, faces, face_uvs, H, H,
                                       backend='jnp', knum=KNUM)
    params = gt._replace(vertices=jnp.asarray(sc['start']))
    opt = optax.adam(LR)
    state = opt.init(params)
    grad = jax.jit(jax.value_and_grad(lambda p, sel: MJ.render_loss(
        p, views, faces, face_uvs, images, masks, H, H, backend='jnp',
        selection=sel, knum=KNUM)))
    tl = tl_j.Timelapse(logdir)
    losses = []
    for step in range(STEPS):
        _log(tl, step, np.asarray(params.vertices), sc)
        sel = MJ.compute_selection(params, views, faces, H, H,
                                   backend='jnp', knum=KNUM)
        loss, g = grad(params, sel)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
        losses.append(float(loss))
    return (np.array(images), np.array(masks), np.array(params.vertices),
            losses)


def _torch_step(model, opt, views, sc, images, masks):
    faces = torch.as_tensor(sc['faces'])
    face_uvs = torch.as_tensor(sc['face_uvs'])
    sel = MT.compute_selection(model, views, faces, H, H, backend='jnp',
                               knum=KNUM)
    opt.zero_grad()
    loss = MT.render_loss(model, views, faces, face_uvs, images, masks, H,
                          H, backend='jnp', selection=sel, knum=KNUM)
    loss.backward()
    opt.step()
    return loss.item()


def run_torch(sc, images, masks, logdir, ckdir):
    views = MT.make_views(VIEWS, device='cpu')
    images, masks = torch.as_tensor(images), torch.as_tensor(masks)
    model = MT.from_jax_params(sc['start'], sc['tex'], sc['sh'],
                               device='cpu')
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    tl = Timelapse(logdir)
    losses = []
    resumed = None
    for step in range(STEPS):
        _log(tl, step, model.vertices.detach(), sc)
        losses.append(_torch_step(model, opt, views, sc, images, masks))
        if step == SAVE_AFTER:
            state = {'params': model.as_params(), 'opt': opt.state_dict(),
                     'step': step}
            ckpt.save(ckdir, state, step=step)
            ckpt.save_npz(os.path.join(ckdir, 'params.npz'),
                          model.as_params())
            back = ckpt.load(ckdir, like=state)
            npz = ckpt.load_npz(os.path.join(ckdir, 'params.npz'),
                                device='cpu')
            twin = MT.from_jax_params(sc['start'], sc['tex'], sc['sh'],
                                      device='cpu')
            twin.load_params(back['params'])
            twin_opt = torch.optim.Adam(twin.parameters(), lr=1.)
            twin_opt.load_state_dict(back['opt'])
            # the state's tensors are the live ones, and the twin's
            # optimizer steps on the loaded ones: keep copies
            resumed = dict(state=copy.deepcopy(state),
                           back=copy.deepcopy(back), npz=npz, twin=twin,
                           twin_opt=twin_opt)
            step_fn = MT.compiled_step(
                twin, views, torch.as_tensor(sc['faces']),
                torch.as_tensor(sc['face_uvs']), images, masks, H, H,
                twin_opt, backend='jnp', knum=KNUM)
            resumed['built'] = copy.deepcopy(twin_opt.state_dict())
            resumed['built_params'] = copy.deepcopy(twin.as_params())
            step_fn(views, images, masks)
    return model, losses, resumed


@pytest.fixture(scope='module')
def path_f(tmp_path_factory):
    jax_native()
    root = tmp_path_factory.mktemp('path_f')
    sc = _scene()
    images, masks, v_j, losses_j = run_jax(sc, str(root / 'tl_j'))
    model, losses_t, resumed = run_torch(sc, images, masks,
                                         str(root / 'tl_t'),
                                         str(root / 'ckpt'))
    return dict(sc=sc, root=root, v_j=v_j, losses_j=losses_j, model=model,
                losses_t=losses_t, resumed=resumed)


def test_fit_against_jax(path_f):
    v_t = path_f['model'].vertices.detach().numpy()
    np.testing.assert_allclose(path_f['losses_t'], path_f['losses_j'],
                               rtol=1e-5)
    assert path_f['losses_t'][-1] < path_f['losses_t'][0]
    moved = np.abs(v_t - path_f['sc']['start']).max()
    assert moved > 10 * VERT_ATOL
    np.testing.assert_allclose(v_t, path_f['v_j'], rtol=0, atol=VERT_ATOL)


def test_checkpoint_and_resume(path_f):
    r = path_f['resumed']
    for a, b in zip(r['state']['params'], r['back']['params']):
        assert torch.equal(a.detach(), b)
    for a, b in zip(r['state']['params'], r['npz']):
        assert torch.equal(a.detach(), b)
    st, bk = r['state']['opt']['state'], r['back']['opt']['state']
    built = r['built']['state']
    for i in st:
        for k in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(st[i][k], bk[i][k])
            # the compiled step's state, after its build, is the loaded one
            assert torch.equal(built[i][k], bk[i][k])
    assert built[0]['step'].item() == SAVE_AFTER + 1
    for a, b in zip(r['built_params'], r['back']['params']):
        assert torch.equal(a.detach(), b)
    # the loop took one step after the save (STEPS == SAVE_AFTER + 2), the
    # twin one step from the restored state
    for a, b in zip(path_f['model'].parameters(), r['twin'].parameters()):
        assert torch.equal(a, b)


def _attrs(path):
    stage = usda.UsdaStage.load(path)
    return {(p.path, k): v for p in stage.prims() for k, v in p.attrs.items()}


def test_timelapse_files(path_f):
    root = path_f['root']
    p_j = TimelapseParser(str(root / 'tl_j'))
    p_t = TimelapseParser(str(root / 'tl_t'))
    for kind in ('mesh', 'pointcloud'):
        assert [(b['category'], b['id']) for b in p_t.dir_info[kind]] == \
            [(b['category'], b['id']) for b in p_j.dir_info[kind]] == \
            [('fit', 0)]
        assert p_t.get_timestamps(kind, 'fit', 0) == \
            p_j.get_timestamps(kind, 'fit', 0) == [0., 1., 2.]
        a = _attrs(p_j.get_file_path(kind, 'fit', 0))
        b = _attrs(p_t.get_file_path(kind, 'fit', 0))
        assert a.keys() == b.keys()
        for key in a:
            for t in a[key]:
                x, y = np.asarray(a[key][t]), np.asarray(b[key][t])
                if key[1] == 'points' and t > 0:
                    np.testing.assert_allclose(y, x, rtol=0,
                                               atol=2 * VERT_ATOL)
                else:
                    np.testing.assert_array_equal(y, x, err_msg=str(key))


def test_mise_of_the_fit(path_f):
    """The fitted mesh's MISE grid through the hash path: the port's equal
    to the JAX package's on the same vertices."""
    v = path_f['model'].vertices.detach()
    faces = path_f['sc']['faces']

    def occ_t(x):
        counts.append(x.shape[0])
        return 1. - 2. * check_sign(v[None], torch.as_tensor(faces), x[None],
                                    use_hash=True)[0].float()

    def occ_j(x):
        inside = check_sign_j.check_sign(jnp.asarray(v.numpy())[None], faces,
                                         x[None], use_hash=True)[0]
        return 1. - 2. * inside.astype(jnp.float32)

    counts = []
    grid_t = sdf_to_voxelgrids([occ_t], device='cpu', **MISE)[0]
    grid_j = np.asarray(sdf_j.sdf_to_voxelgrids([occ_j], **MISE))[0]
    np.testing.assert_array_equal(grid_t.numpy(), grid_j)
    assert len(counts) == 3 and 0 < grid_j.sum() < grid_j.size
