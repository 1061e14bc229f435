"""The compiled DIB-R training step (``models/inverse_render.py::
compiled_step``) and the kernels' extension-module route.

On the CPU the compiled step runs the step eagerly, after the warm-up
steps that building it takes and whose changes it puts back:

* three steps of it equal three eager ``compute_selection`` ->
  ``render_loss`` -> ``backward`` -> Adam steps bit for bit (parameters,
  gradients, losses and Adam's state), both on one CPU thread: with
  several, the CPU's gradient sums are not always taken in the same order
  (one of 12 identical eager runs differed by 4.7e-10), on one they are;
* they match three steps of the JAX package's
  ``jax.value_and_grad(render_loss)`` + ``optax.adam`` from the same
  numpy-seeded parameters (fused backend, the JAX side in interpret mode)
  within the tolerances of ``test_torch_inverse_render.py::
  test_render_loss_and_grads``: each step's loss within rtol 1e-5 of the
  JAX loop's and step 0's gradients within 1e-4 * max|g_jax|; after each
  step the parameters within 2e-5 of the JAX loop's
  (``test_torch_path_f.py``'s limit at the same Adam rate).  The two
  sides are handed the same cameras.  Gradients of later steps are held
  through the parameters they move: at pixels where a face's p is near 1
  the product-division rule ``g * prod / (1 - p + 1e-7)`` enlarges the
  soft-mask product's difference (2e-5: interpret mode contracts to
  fused multiply-adds, the port rounds each product), and 2 of 390 vertex
  gradients of step 2 differ by 1.9e-4 of max|g|, at the same parameters
  as at the JAX loop's;
* one step runs with the host reads that would sync the card patched to
  raise (``item``, ``bool``/``int``/``float``/``index``, ``tolist``,
  ``numpy``, ``nonzero``, ``argwhere``, ``masked_select``, ``unique``,
  single-argument ``where`` and boolean-mask indexing), except inside the
  kernels' plain versions and the optimizer's step, which the card does
  not run: it runs K1, K2, E1-E3 and Adam's capturable form, which read
  nothing;
* a call with other shapes, types or devices raises.

Card-only cases (skipped without one): a replay against the eager step
from the same parameters at ``chip_smoke.py`` phase 4's limits (face ids,
soft-mask product, loss and gradients bit for bit,
three steps' losses within rtol 1e-4), two replays counting two launches
of each of K1, K2 and E1-E3, a state loaded after the capture refused, an
optimizer that is not capturable refused, and the module-route wrappers'
messages on a wrong type or device.
"""
import contextlib
import copy
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.ops import _scatter as SCT
from kaolin_tpu_torch.render.mesh import _fused as FT
from kaolin_tpu_torch.render.mesh import _sample as SAT

H = W = 64
VIEWS = 2
STEPS = 3
LR = 5e-3
LOSS_RTOL = 1e-5            # test_render_loss_and_grads
GRAD_REL = 1e-4
PARAM_ATOL = 2e-5           # test_torch_path_f.py's VERT_ATOL
REPLAY_GRAD_REL = 0.        # chip_smoke.py phase 4: bit-equal
REPLAY_LOSS_RTOL = 1e-4     # chip_smoke.py STEP0_LOSS_RTOL

# evaluated when the test runs, not at import
cuda = pytest.mark.skipif('not torch.cuda.is_available()',
                          reason='needs a CUDA card (run on the H100)')


@pytest.fixture(scope='module')
def scene():
    from kaolin_tpu_torch.utils.testing import uv_sphere
    sphere = uv_sphere(16, 9)
    rng = np.random.default_rng(0)
    verts = (sphere.vertices * 0.5 + 0.02 * rng.standard_normal(
        sphere.vertices.shape)).astype(np.float32)
    sh = np.zeros(9, np.float32)
    sh[0] = 3.
    sh[1:] = 0.3 * rng.standard_normal(8)
    # the port's cameras, handed to both sides (the two packages' view
    # matrices differ in the last bit)
    views = [v.numpy() for v in MT.make_views(VIEWS, device='cpu')]
    return dict(
        views=views,
        verts=verts, tex=rng.random((3, 16, 16), dtype=np.float32), sh=sh,
        faces=sphere.faces, face_uvs=sphere.uvs[sphere.face_uvs_idx],
        target_images=rng.random((VIEWS, H, W, 3), dtype=np.float32),
        target_masks=(rng.random((VIEWS, H, W)) > 0.5).astype(np.float32))


def _inputs(scene, device='cpu'):
    """(model, views, faces, face_uvs, target images, target masks)."""
    def t(a):
        return torch.as_tensor(a, device=device)
    return (MT.from_jax_params(scene['verts'], scene['tex'], scene['sh'],
                               device=device),
            MT.CameraViews(*map(t, scene['views'])), t(scene['faces']),
            t(scene['face_uvs']), t(scene['target_images']),
            t(scene['target_masks']))


def _adam(model, device='cpu'):
    return torch.optim.Adam(model.parameters(), lr=LR,
                            capturable=torch.device(device).type == 'cuda')


def _eager_step(model, opt, views, faces, face_uvs, images, masks):
    """The step as the examples took it before compiled_step."""
    sel = MT.compute_selection(model, views, faces, H, W, backend='fused')
    opt.zero_grad()
    loss = MT.render_loss(model, views, faces, face_uvs, images, masks, H,
                          W, backend='fused', selection=sel)
    loss.backward()
    opt.step()
    return loss.detach(), sel


def _record(model, loss):
    return dict(loss=loss.clone(),
                grads=[p.grad.clone() for p in model.parameters()],
                params=[p.detach().clone() for p in model.parameters()])


@contextlib.contextmanager
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def torch_runs(scene):
    """STEPS steps of the compiled step and of the eager step, each from
    the scene's parameters with its own Adam, on one thread."""
    with _one_thread():
        return _torch_runs(scene)


def _torch_runs(scene):
    model, views, faces, face_uvs, images, masks = _inputs(scene)
    opt = _adam(model)
    step = MT.compiled_step(model, views, faces, face_uvs, images, masks, H,
                            W, opt, backend='fused')
    compiled = [_record(model, step(views, images, masks))
                for _ in range(STEPS)]
    compiled_state = opt.state_dict()['state']
    model_e, *_ = _inputs(scene)
    opt_e = _adam(model_e)
    eager = [_record(model_e, _eager_step(model_e, opt_e, views, faces,
                                          face_uvs, images, masks)[0])
             for _ in range(STEPS)]
    return dict(compiled=compiled, eager=eager, state=compiled_state,
                eager_state=opt_e.state_dict()['state'])


@pytest.fixture(scope='module')
def jax_run(scene):
    """The JAX loop: each step's loss and gradients, and the parameters
    after it.  (JAX is imported here: the file's card tests also run where
    the JAX package does not import.)"""
    jax = pytest.importorskip('jax')
    jnp = pytest.importorskip('jax.numpy')
    optax = pytest.importorskip('optax')
    MJ = pytest.importorskip('kaolin_tpu.models.inverse_render')
    views = MJ.CameraViews(*map(jnp.asarray, scene['views']))
    faces = jnp.asarray(scene['faces'])
    face_uvs = jnp.asarray(scene['face_uvs'])
    grad_fn = jax.value_and_grad(lambda p, sel: MJ.render_loss(
        p, views, faces, face_uvs, jnp.asarray(scene['target_images']),
        jnp.asarray(scene['target_masks']), H, W, backend='fused',
        selection=sel))
    params = MJ.InverseRenderParams(jnp.asarray(scene['verts']),
                                    jnp.asarray(scene['tex']),
                                    jnp.asarray(scene['sh']))
    tx = optax.adam(LR)
    state = tx.init(params)
    steps = []
    for _ in range(STEPS):
        sel = MJ.compute_selection(params, views, faces, H, W,
                                   backend='fused')
        loss, grads = grad_fn(params, sel)
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
        steps.append(dict(loss=float(loss),
                          grads=[np.asarray(g) for g in grads],
                          params=[np.asarray(p) for p in params]))
    return steps


def test_compiled_step_equals_eager_steps(torch_runs):
    for c, e in zip(torch_runs['compiled'], torch_runs['eager']):
        assert torch.equal(c['loss'], e['loss'])
        for a, b in zip(c['grads'] + c['params'], e['grads'] + e['params']):
            assert torch.equal(a, b)
    losses = [c['loss'].item() for c in torch_runs['compiled']]
    assert losses[-1] < losses[0]
    s_c, s_e = torch_runs['state'], torch_runs['eager_state']
    assert s_c.keys() == s_e.keys()
    for i in s_c:
        assert s_c[i]['step'].item() == STEPS
        for k in ('step', 'exp_avg', 'exp_avg_sq'):
            assert torch.equal(s_c[i][k], s_e[i][k])


def test_compiled_step_against_jax(torch_runs, jax_run):
    for k, (c, j) in enumerate(zip(torch_runs['compiled'], jax_run)):
        np.testing.assert_allclose(c['loss'].item(), j['loss'],
                                   rtol=LOSS_RTOL, err_msg=f'step {k}')
        for p_t, p_j in zip(c['params'], j['params']):
            np.testing.assert_allclose(p_t.numpy(), p_j, rtol=0,
                                       atol=PARAM_ATOL, err_msg=f'step {k}')
    step0, step0_j = torch_runs['compiled'][0], jax_run[0]
    for name, g_t, g_j in zip(('vertices', 'texture_map', 'sh_coeffs'),
                              step0['grads'], step0_j['grads']):
        assert np.abs(g_j).max() > 0, name
        np.testing.assert_allclose(g_t.numpy(), g_j, rtol=0,
                                   atol=GRAD_REL * np.abs(g_j).max(),
                                   err_msg=name)


class _HostReads:
    """Patches the tensor reads that would wait for the card to raise,
    except while ``lifted``."""

    METHODS = ('item', '__bool__', '__int__', '__float__', '__index__',
               'tolist', 'numpy', 'nonzero', 'argwhere', 'masked_select',
               'unique')
    FUNCTIONS = ('nonzero', 'argwhere', 'masked_select', 'unique')

    def __init__(self, monkeypatch):
        self.lifted = 0
        self.seen = []
        for name in self.METHODS:
            monkeypatch.setattr(torch.Tensor, name,
                                self._refusing(name, getattr(torch.Tensor,
                                                             name)))
        for name in self.FUNCTIONS:
            monkeypatch.setattr(torch, name,
                                self._refusing(f'torch.{name}',
                                               getattr(torch, name)))
        where = torch.where

        def where_checked(*args, **kwargs):
            if len(args) + len(kwargs) == 1:
                self._refuse('torch.where(condition)')
            return where(*args, **kwargs)
        monkeypatch.setattr(torch, 'where', where_checked)
        for name in ('__getitem__', '__setitem__'):
            monkeypatch.setattr(torch.Tensor, name,
                                self._indexing(getattr(torch.Tensor, name)))

    def _refuse(self, what):
        if not self.lifted:
            self.seen.append(what)
            raise AssertionError(f'a host read in the step: {what}')

    def _refusing(self, what, fn):
        def run(*args, **kwargs):
            self._refuse(what)
            return fn(*args, **kwargs)
        return run

    def _indexing(self, fn):
        def run(x, index, *rest):
            idx = index if isinstance(index, tuple) else (index,)
            if any(torch.is_tensor(i) and i.dtype == torch.bool
                   for i in idx):
                self._refuse('boolean-mask indexing')
            return fn(x, index, *rest)
        return run

    def lifting(self, fn):
        def run(*args, **kwargs):
            self.lifted += 1
            try:
                return fn(*args, **kwargs)
            finally:
                self.lifted -= 1
        return run


@pytest.mark.parametrize('backend', ['fused', 'jnp'])
def test_step_reads_nothing_back(scene, monkeypatch, backend):
    model, views, faces, face_uvs, images, masks = _inputs(scene)
    opt = _adam(model)
    step = MT.compiled_step(model, views, faces, face_uvs, images, masks, H,
                            W, opt, backend=backend)
    guard = _HostReads(monkeypatch)
    for mod, name in ((FT, '_fused_forward_torch'),
                      (FT, '_fused_backward_torch'),
                      (SAT, '_bilinear_forward_torch'),
                      (SAT, '_bilinear_backward_torch'),
                      (SCT, '_scatter_rows_torch')):
        monkeypatch.setattr(mod, name, guard.lifting(getattr(mod, name)))
    monkeypatch.setattr(opt, 'step', guard.lifting(opt.step))
    with pytest.raises(AssertionError, match='host read'):
        torch.zeros(3).sum().item()          # the guard is on
    guard.seen.clear()
    loss = step(views, images, masks)
    assert guard.seen == []
    monkeypatch.undo()
    assert torch.isfinite(loss) and loss.shape == ()
    assert all(p.grad is not None for p in model.parameters())


@pytest.mark.parametrize('change', ['height', 'views', 'dtype'])
def test_other_shapes_raise(scene, change):
    model, views, faces, face_uvs, images, masks = _inputs(scene)
    step = MT.compiled_step(model, views, faces, face_uvs, images, masks, H,
                            W, _adam(model), backend='fused')
    if change == 'height':
        images, masks = images[:, :-1], masks[:, :-1]
    elif change == 'views':
        views = MT.CameraViews(views.camera_rot[:1], views.camera_trans[:1],
                               views.camera_proj)
        images, masks = images[:1], masks[:1]
    else:
        masks = masks.double()
    with pytest.raises(ValueError, match='built for'):
        step(views, images, masks)


def test_module_mirrors_the_face_table():
    """The extension module's copy of the face table's shape equals the
    wrapper's."""
    src = (Path(FT.__file__).parents[2] / 'csrc' /
           'dibr_fused_module.cpp').read_text()

    def const(name):
        return int(re.search(rf'constexpr int64_t {name} = (\d+);',
                             src).group(1))
    assert (const('FC'), const('NCOL')) == (FT.FC, FT._NCOL)


@cuda
def test_cuda_replay_against_eager(scene):
    model, views, faces, face_uvs, images, masks = _inputs(scene, 'cuda')
    model_e, *_ = _inputs(scene, 'cuda')
    opt, opt_e = _adam(model, 'cuda'), _adam(model_e, 'cuda')
    step = MT.compiled_step(model, views, faces, face_uvs, images, masks, H,
                            W, opt, backend='fused')
    for k in range(STEPS):
        loss = step(views, images, masks)
        loss_e, sel_e = _eager_step(model_e, opt_e, views, faces, face_uvs,
                                    images, masks)
        torch.cuda.synchronize()
        if k == 0:       # from the same parameters
            assert torch.equal(loss, loss_e)
            assert torch.equal(step.selection[0], sel_e[0])
            assert torch.equal(step.selection[1].prod, sel_e[1].prod)
            for p, p_e in zip(model.parameters(), model_e.parameters()):
                scale = p_e.grad.abs().max().item()
                assert (p.grad - p_e.grad).abs().max().item() <= \
                    REPLAY_GRAD_REL * scale
        assert abs(loss.item() - loss_e.item()) <= \
            REPLAY_LOSS_RTOL * abs(loss_e.item())


@cuda
def test_cuda_replays_count_launches(scene):
    model, views, faces, face_uvs, images, masks = _inputs(scene, 'cuda')
    step = MT.compiled_step(model, views, faces, face_uvs, images, masks, H,
                            W, _adam(model, 'cuda'), backend='fused')
    counts = (FT.LAUNCHES, SAT.LAUNCHES, SCT.LAUNCHES)
    before = [dict(c) for c in counts]
    step(views, images, masks)
    step(views, images, masks)
    torch.cuda.synchronize()
    assert [{k: c[k] - b[k] for k in b} for c, b in zip(counts, before)] == \
        [{'fwd': 2, 'bwd': 2}, {'sample': 2, 'sample_bwd': 2},
         {'scatter': 2}]


@cuda
def test_cuda_state_replaced_after_capture_raises(scene):
    model, views, faces, face_uvs, images, masks = _inputs(scene, 'cuda')
    opt = _adam(model, 'cuda')
    step = MT.compiled_step(model, views, faces, face_uvs, images, masks, H,
                            W, opt, backend='fused')
    step(views, images, masks)
    opt.load_state_dict(copy.deepcopy(opt.state_dict()))   # new tensors
    with pytest.raises(RuntimeError, match='replaced'):
        step(views, images, masks)


@cuda
def test_cuda_optimizer_must_be_capturable(scene):
    model, views, faces, face_uvs, images, masks = _inputs(scene, 'cuda')
    with pytest.raises(ValueError, match='capturable'):
        MT.compiled_step(model, views, faces, face_uvs, images, masks, H, W,
                         torch.optim.Adam(model.parameters(), lr=LR),
                         backend='fused')


@cuda
def test_cuda_module_route_messages(scene):
    model, views, faces, *_ = _inputs(scene, 'cuda')
    with torch.no_grad():
        fvc, fvi, fn = MT._prepare(model, views, faces)
        vt, tr, ctr, cbb, _, _ = FT.build_face_tiles(
            fvc[..., 2], fvi * 1000., fn[..., 2] >= 0., H, W, 1000., 20.)
    vt, cbb = vt.float().contiguous(), cbb.float().contiguous()
    args = (H, W, 1000., 1e-8, 7000., True)
    with pytest.raises(ValueError, match='tile_ranges.*torch.int64'):
        FT._fused_forward_cuda(vt, tr.long(), cbb, *args)
    with pytest.raises(ValueError, match='chunk_bbox.*on cpu'):
        FT._fused_forward_cuda(vt, tr, cbb.cpu(), *args)
    g = torch.zeros((VIEWS, H, W), device='cuda')
    with pytest.raises(ValueError, match='g_prod.*torch.float64'):
        FT._fused_backward_cuda(vt, ctr, cbb, g.double(), H, W, 1000., 7000.)
    with pytest.raises(ValueError, match='chunk_tranges.*on cpu'):
        FT._fused_backward_cuda(vt, ctr.cpu(), cbb, g, H, W, 1000., 7000.)
