"""The port's multi-GPU layer (``kaolin_tpu_torch/parallel``) against the
JAX package's, on the CPU.

The JAX side runs in this process on the 8 virtual CPU devices of
``tests/conftest.py``; the port's side in 4 spawned gloo ranks on the CPU
(``parallel/dryrun.py::run``, one spawn for the module), on the same numpy
inputs: a ``uv_sphere(16, 9)`` (256 faces) at 32^2, 4 views, knum 8.

Tolerances: the selection exactly equal; the loss within rtol 1e-5 and the
gradients within rtol 1e-4, atol 1e-5, as ``tests/test_parallel.py`` holds
the JAX sharded functions to the one-device ones.  Across the ranks of one
run, loss and gradients are equal bit for bit (one all-reduce gives every
rank the same sum).

JAX is imported inside the fixture, which skips its tests where the JAX
package does not import (JAX or flax not installed), so that the card's tests (``cuda``-marked; on the card:
``python -m pytest --noconftest tests/test_torch_parallel.py``) run there.
"""
import numpy as np
import pytest
import torch

from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.parallel import (distributed as D, make_mesh,
                                       multi_view_grad, replicate,
                                       shard_views)
from kaolin_tpu_torch.parallel import dryrun as DR
from kaolin_tpu_torch.parallel.sharding import Mesh
from kaolin_tpu_torch.render.mesh import rasterize_selection

H = 32
VIEWS = 4
RANKS = 4
KNUM = 8
TILE_MESHES = ((2, 2), (1, 4), (4, 1))
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5

# evaluated when the test runs, not at import
cuda = pytest.mark.skipif('not torch.cuda.is_available()',
                          reason='needs a CUDA card (run on the H100)')


@pytest.fixture(scope='module')
def scene():
    return DR.make_scene(H, VIEWS, texture_res=8, sphere=(16, 9),
                         backend='jnp', knum=KNUM, device='cpu')


@pytest.fixture(scope='module')
def ranks(scene):
    """[rank] = (tile_checks, sharded_step) results of one 4-rank spawn."""
    return DR.run(RANKS, [
        (DR.tile_checks, dict(scene=scene, height=H, knum=KNUM,
                              meshes=TILE_MESHES, selection_mesh=(2, 2))),
        (DR.sharded_step, dict(scene=scene, height=H, backend='jnp',
                               knum=KNUM))], timeout=300, device='cpu')


@pytest.fixture(scope='module')
def jax_side(scene):
    """The JAX package's sharded functions on the same inputs."""
    jax = pytest.importorskip('jax')
    # the JAX package needs flax as well, which a machine with JAX may lack
    MJ = pytest.importorskip('kaolin_tpu.models.inverse_render')
    import jax.numpy as jnp
    from kaolin_tpu.parallel import (make_mesh as jmesh,
                                     multi_view_grad as jmvg,
                                     replicate as jrep, shard_views as jshard)
    from kaolin_tpu.parallel.tile import (tile_sharded_render_loss,
                                          tile_sharded_selection)
    if len(jax.devices()) < RANKS:
        pytest.skip(f'needs {RANKS} virtual devices')
    a = {k: jnp.asarray(v) for k, v in scene.items()}
    params = MJ.InverseRenderParams(a['vertices'], a['texture_map'],
                                    a['sh_coeffs'])
    views = MJ.CameraViews(a['camera_rot'], a['camera_trans'],
                           a['camera_proj'])
    mesh2d = jmesh((2, 2), ('data', 'tile'))

    def single(p):
        return MJ.render_loss(p, views, a['faces'], a['face_uvs'],
                              a['target_images'], a['target_masks'], H, H,
                              backend='jnp', knum=KNUM)

    def tiled(p):
        return tile_sharded_render_loss(
            mesh2d, p, views, a['faces'], a['face_uvs'], a['target_images'],
            a['target_masks'], H, H, knum=KNUM)

    def loss_fn(p, vb):
        rot, trans, t_img, t_mask = vb
        v = MJ.CameraViews(rot, trans, a['camera_proj'])
        return MJ.render_loss(p, v, a['faces'], a['face_uvs'], t_img, t_mask,
                              H, H, backend='jnp',
                              knum=KNUM) * (rot.shape[0] / VIEWS)

    mesh = jmesh((RANKS,), ('data',))
    vb = tuple(a[k] for k in DR.VIEW_FIELDS)
    step = jax.jit(jmvg(loss_fn, mesh))(jrep(mesh, params), jshard(mesh, vb))

    @jax.jit
    def selection(p):
        fvc, fvi, fn = jax.lax.stop_gradient(MJ._prepare(p, views,
                                                         a['faces']))
        return tile_sharded_selection(mesh2d, fvc[..., 2], fvi,
                                      fn[..., 2] >= 0., H, H)

    # jitted: op by op, the sharded loss takes minutes to dispatch
    out = dict(single=jax.jit(jax.value_and_grad(single))(params),
               tiled=jax.jit(jax.value_and_grad(tiled))(params),
               step=step, selection=selection(params))
    return jax.tree_util.tree_map(np.asarray, out)


def _close(loss, grads, ref_loss, ref_grads):
    np.testing.assert_allclose(loss, float(ref_loss), rtol=LOSS_RTOL)
    for g, r in zip(grads, ref_grads):
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g, np.asarray(r), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def _equal_over_ranks(results):
    loss, grads = results[0]
    for other_loss, other_grads in results[1:]:
        assert other_loss == loss
        for a, b in zip(grads, other_grads):
            np.testing.assert_array_equal(a, b)


def test_make_mesh_one_process():
    """Without a process group: one rank, collectives are the identity."""
    mesh = make_mesh(device='cpu')
    assert dict(mesh.shape) == {'data': 1}
    assert list(mesh.shape) == ['data']
    mesh2d = make_mesh((1, 1), ('data', 'tile'), device='cpu')
    assert dict(mesh2d.shape) == {'data': 1, 'tile': 1}
    assert mesh2d.axis_index('tile') == 0
    with pytest.raises(ValueError, match='needs 2 ranks'):
        make_mesh((2,), device='cpu')
    with pytest.raises(ValueError, match='needs 4 ranks'):
        make_mesh((2, 2), ('data', 'tile'), device='cpu')
    with pytest.raises(ValueError):
        make_mesh((1,), ('data', 'tile'), device='cpu')
    x = torch.arange(4.)
    assert torch.equal(mesh.all_reduce(x.clone()), x)
    assert D.process_index() == 0 and D.process_count() == 1
    assert not D.is_initialized()


def test_multi_view_grad_one_process():
    """A one-rank mesh: value and gradients are local autograd's, the tree
    kept."""
    mesh = make_mesh(device='cpu')
    rng = np.random.default_rng(0)
    p = MT.InverseRenderParams(*(torch.tensor(
        rng.standard_normal(s).astype(np.float32), requires_grad=True)
        for s in ((5, 3), (2, 3), (3,))))
    views = shard_views(mesh, rng.standard_normal((8, 3)).astype(np.float32))

    def loss_fn(q, v):
        return ((v @ q.vertices.T) ** 2).sum() + (q.texture_map.sum()
                                                 * q.sh_coeffs).sum()

    loss, grads = multi_view_grad(loss_fn, mesh)(replicate(mesh, p), views)
    ref = loss_fn(p, views)
    ref_grads = torch.autograd.grad(ref, list(p))
    assert isinstance(grads, MT.InverseRenderParams)
    assert loss.item() == ref.item()
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


@pytest.mark.parametrize('kind', ['numpy', 'tensor'])
def test_shard_views_copies_only_the_shard(kind):
    """A rank's shard lies in storage of its own, of the shard's size, and
    does not change with the source: the global batch is not kept."""
    mesh = Mesh(np.arange(RANKS), ('data',), torch.device('cpu'))
    x = np.arange(8 * 3 * 5, dtype=np.float32).reshape(8, 3, 5)
    src = torch.from_numpy(x.copy()) if kind == 'tensor' else x.copy()
    part = shard_views(mesh, (src,))[0]
    np.testing.assert_array_equal(part.numpy(), x[:2])
    assert part.untyped_storage().nbytes() == x[:2].nbytes
    src[:] = -1
    np.testing.assert_array_equal(part.numpy(), x[:2])


def test_mesh_shapes_over_ranks(ranks):
    for r, (tile, _) in enumerate(ranks):
        assert tile['shapes'] == {
            (2, 2): {'data': 2, 'tile': 2}, (1, 4): {'data': 1, 'tile': 4},
            (4, 1): {'data': 4, 'tile': 1}}, r


def test_tile_sharded_selection_equals_jax(ranks, jax_side, scene):
    """(2 x 2) mesh: every rank holds the whole image, equal to the JAX
    sharded selection and to the port's one-process 'jnp' selection."""
    model = MT.from_jax_params(*(scene[k] for k in DR.PARAMS), device='cpu')
    views = MT.CameraViews(*(torch.as_tensor(scene[k]) for k in (
        'camera_rot', 'camera_trans', 'camera_proj')))
    fvc, fvi, fn = MT._prepare(model, views, torch.as_tensor(scene['faces']))
    ref = rasterize_selection(H, H, fvc[..., 2].detach(), fvi.detach(),
                              valid_faces=fn[..., 2] >= 0., backend='jnp')
    assert (ref >= 0).any() and (ref < 0).any()
    for tile, _ in ranks:
        np.testing.assert_array_equal(tile['selection'],
                                      jax_side['selection'])
        np.testing.assert_array_equal(tile['selection'], ref.numpy())


@pytest.mark.parametrize('shape', TILE_MESHES)
def test_tile_sharded_render_loss_matches_jax(ranks, jax_side, scene, shape):
    """Loss and gradients of the row-sharded 'jnp' loss: equal over the
    ranks, and close to the JAX sharded loss on a (2 x 2) mesh and to the
    one-process render_loss of both packages."""
    results = [tile['loss'][shape] for tile, _ in ranks]
    _equal_over_ranks(results)
    loss, grads = results[0]
    tiled_loss, tiled_grads = jax_side['tiled']
    single_loss, single_grads = jax_side['single']
    _close(loss, grads, tiled_loss, tiled_grads)
    _close(loss, grads, single_loss, single_grads)
    _close(loss, grads, *DR.one_process_step(scene, H, backend='jnp',
                                             knum=KNUM, device='cpu'))


def test_sharded_step_matches_jax(ranks, jax_side, scene):
    """multi_view_grad of the 'jnp' trainer loss over 4 ranks: equal over
    the ranks, close to the JAX multi_view_grad on 4 devices and to the
    port's one-process step; Adam moved every parameter."""
    steps = [step for _, step in ranks]
    _equal_over_ranks([(s['loss'], s['grads']) for s in steps])
    assert len({s['gnorm'] for s in steps}) == 1
    loss, grads = steps[0]['loss'], steps[0]['grads']
    _close(loss, grads, *jax_side['step'])
    _close(loss, grads, *DR.one_process_step(scene, H, backend='jnp',
                                             knum=KNUM, device='cpu'))
    assert all(all(s['moved']) for s in steps)
    assert all(s['launches'] == {'fwd': 0, 'bwd': 0} for s in steps)
    # each rank holds its shard of the views, not the global batch
    shard = sum(scene[k].nbytes for k in DR.VIEW_FIELDS) // RANKS
    assert all(s['view_bytes'] == shard for s in steps)


@cuda
def test_nccl_world_size_one_fused_step_on_card(tmp_path):
    """World size 1 on NCCL in this process: multi_view_grad over the fused
    trainer loss (K1 and K2 launched) against the one-process step at
    64^2, 2 views."""
    from kaolin_tpu_torch.render.mesh import _fused
    import torch.distributed as dist
    dev = D.initialize('file://' + str(tmp_path / 'store'), 1, 0,
                       backend='nccl')
    try:
        scene = DR.make_scene(64, 2, device=dev)
        ref_loss, ref_grads = DR.one_process_step(scene, 64, device=dev)
        mesh = D.make_global_mesh()
        views = shard_views(mesh, tuple(scene[k] for k in DR.VIEW_FIELDS))
        model = MT.from_jax_params(*(scene[k] for k in DR.PARAMS),
                                   device=dev)
        before = dict(_fused.LAUNCHES)
        loss, grads = multi_view_grad(DR.view_loss(scene, 64, dev),
                                      mesh)(model.as_params(), views)
        assert _fused.LAUNCHES['fwd'] > before['fwd']
        assert _fused.LAUNCHES['bwd'] > before['bwd']
        np.testing.assert_allclose(loss.item(), ref_loss, rtol=1e-5)
        for g, r in zip(grads, ref_grads):
            np.testing.assert_allclose(g.cpu().numpy(), r, rtol=0,
                                       atol=1e-4 * np.abs(r).max())
    finally:
        dist.destroy_process_group()


def test_dryrun_entry_point(capsys):
    """``python -m kaolin_tpu_torch.parallel.dryrun``: 2 spawned ranks, one
    sharded Adam step of the fused trainer (the kernels' plain versions on
    the CPU), the same loss and gradient norm on both, equal to the
    one-process step's."""
    out = DR.main(['--ranks', '2', '--height', '16', '--device', 'cpu',
                   '--timeout', '120'])
    printed = capsys.readouterr().out
    assert 'rank 0: loss' in printed and 'rank 1: loss' in printed
    assert out[0]['loss'] == out[1]['loss']
    assert out[0]['gnorm'] == out[1]['gnorm']
    scene = DR.make_scene(16, 4, device='cpu')
    _close(out[0]['loss'], out[0]['grads'],
           *DR.one_process_step(scene, 16, device='cpu'))


def test_run_raises_with_the_failing_rank_output():
    """A rank whose job raises makes the call raise, with its traceback;
    the other rank is killed."""
    with pytest.raises(RuntimeError, match=r"rank \d failed(.|\n)*KeyError"):
        DR.run(2, [(DR.sharded_step, dict(scene={}, height=16))],
               timeout=120, device='cpu')


def test_run_hard_cap_kills_every_rank():
    """The cap covers start-up: ranks that cannot finish in time are killed
    and the call raises."""
    with pytest.raises(RuntimeError, match='did not finish within the cap'):
        DR.run(2, [(DR.sharded_step, dict(scene={}, height=16))],
               timeout=0.5, device='cpu')
