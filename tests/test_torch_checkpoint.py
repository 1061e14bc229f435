"""Training-state checkpoints of the port (``utils/checkpoint.py``) and the
profiler helpers.

Round trips of ``{params, Adam state_dict, step}`` through :func:`save` /
:func:`load` and :func:`save_npz` / :func:`load_npz` are bit-equal, and a
step from the restored state equals a step from the state in memory.
``save_npz`` writes the same leaves, under the same names and in the same
order, as the JAX package's ``save_npz`` of the same
``InverseRenderParams``.
"""
import json
import os

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaolin_tpu.models import inverse_render as MJ
from kaolin_tpu.utils import checkpoint as ckpt_j
from kaolin_tpu_torch.models import inverse_render as MT
from kaolin_tpu_torch.utils import checkpoint as ckpt
from kaolin_tpu_torch.utils import profiler


def _values():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((12, 3)).astype(np.float32),
            rng.random((3, 8, 8), dtype=np.float32),
            rng.standard_normal(9).astype(np.float32))


def _model_and_opt(steps=2):
    model = MT.from_jax_params(*_values(), device='cpu')
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    for k in range(steps):
        _step(model, opt, k)
    return model, opt


def _step(model, opt, k):
    opt.zero_grad()
    loss = sum(((p - 0.1 * (k + 1)) ** 2).sum() for p in model.parameters())
    loss.backward()
    opt.step()


def _state(model, opt, step=2):
    return {'params': model.as_params(), 'opt': opt.state_dict(),
            'step': step, 'note': None}


def _assert_bit_equal(a, b):
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype and \
            a.shape == b.shape
        assert torch.equal(a.detach().cpu(), b.detach().cpu())
    elif isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _assert_bit_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_bit_equal(x, y)
    else:
        assert a == b and type(a) is type(b)


def test_save_load_round_trip(tmp_path):
    model, opt = _model_and_opt()
    state = _state(model, opt)
    path = ckpt.save(str(tmp_path), state, step=10)
    assert os.path.basename(path) == 'step_0000000010'
    back = ckpt.load(str(tmp_path), like=state)
    _assert_bit_equal(state, back)
    assert isinstance(back['params'], MT.InverseRenderParams)
    assert back['opt']['state'][0]['step'].item() == 2.
    # the file is readable without unpickling any class
    data = torch.load(os.path.join(path, 'state.pt'), weights_only=True)
    assert isinstance(json.loads(data['structure']), list)


def test_resume_step_equal(tmp_path):
    model, opt = _model_and_opt()
    ckpt.save(str(tmp_path), _state(model, opt), step=2)
    model2, opt2 = _model_and_opt(steps=1)    # a state of the same structure
    back = ckpt.load(str(tmp_path), like=_state(model2, opt2))
    model2.load_params(back['params'])
    opt2.load_state_dict(back['opt'])
    _step(model, opt, 2)
    _step(model2, opt2, 2)
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


def test_load_onto_like_dtypes(tmp_path):
    model, opt = _model_and_opt()
    ckpt.save(str(tmp_path), model.as_params(), step=1)
    like = MT.InverseRenderParams(*(p.detach().double()
                                    for p in model.parameters()))
    back = ckpt.load(str(tmp_path), like=like)
    assert all(x.dtype == torch.float64 for x in back)
    assert torch.equal(back.vertices, model.vertices.detach().double())


def test_latest_step_and_errors(tmp_path):
    model, opt = _model_and_opt()
    params = model.as_params()
    ckpt.save(str(tmp_path), params, step=1)
    ckpt.save(str(tmp_path), params, step=7)
    assert ckpt.latest_step(str(tmp_path)) == 7
    assert ckpt.latest_step(str(tmp_path / 'nope')) is None
    with pytest.raises(FileNotFoundError):
        ckpt.load(str(tmp_path / 'empty'), params)
    with pytest.raises(FileExistsError):
        ckpt.save(str(tmp_path), params, step=7, overwrite=False)
    with pytest.raises(ValueError):
        ckpt.load(str(tmp_path), like={'params': params})
    with pytest.raises(TypeError):
        ckpt.save(str(tmp_path), {'x': object()})


def test_npz_round_trip(tmp_path):
    model, opt = _model_and_opt()
    state = _state(model, opt)
    path = ckpt.save_npz(str(tmp_path / 'state.npz'), state)
    back = ckpt.load_npz(path, device='cpu')
    _assert_bit_equal(state, back)
    opt2 = torch.optim.Adam(MT.from_jax_params(*_values(), device='cpu')
                            .parameters(), lr=1.)
    opt2.load_state_dict(back['opt'])
    assert opt2.param_groups[0]['lr'] == 5e-3


def test_npz_leaves_equal_jax(tmp_path):
    vals = _values()
    a = ckpt_j.save_npz(str(tmp_path / 'j.npz'),
                        MJ.InverseRenderParams(*map(jnp.asarray, vals)))
    b = ckpt.save_npz(str(tmp_path / 't.npz'),
                      MT.InverseRenderParams(*map(torch.as_tensor, vals)))
    with np.load(a) as fa, np.load(b) as fb:
        leaves_a = [k for k in fa.files if k.startswith('leaf_')]
        leaves_b = [k for k in fb.files if k.startswith('leaf_')]
        assert leaves_a == leaves_b == ['leaf_0', 'leaf_1', 'leaf_2']
        for k in leaves_a:
            assert fa[k].dtype == fb[k].dtype
            np.testing.assert_array_equal(fa[k], fb[k])
    assert isinstance(ckpt.load_npz(b, device='cpu'), MT.InverseRenderParams)


def test_profiler_smoke(tmp_path):
    x = torch.ones(64, 64)
    with profiler.Timer('mm') as t:
        t.block(x @ x)
    assert t.elapsed >= 0.
    r = profiler.benchmark(lambda a: a @ a, x, iters=3, warmup=1,
                           device='cpu')
    assert r['iters'] == 3 and 0 <= r['min_s'] <= r['mean_s']
    assert torch.equal(r['out'], x @ x)
    with profiler.trace(str(tmp_path / 'trace')):
        (x @ x).sum()
    assert os.listdir(tmp_path / 'trace')
