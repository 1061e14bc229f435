"""Multi-process execution of the port: 2 CPU processes on gloo.

The port's counterpart of ``tests/test_multihost.py``: each process joins
the group through ``parallel.distributed.initialize`` (a ``file://`` store
in ``tmp_path``: no port is picked in advance, so runs side by side do not
collide), feeds its host-local shard (``host_local_array``), and the loss
and gradients summed by ``multi_view_grad`` must be equal on both
processes, equal to the one-process numpy value and to the JAX package's
``multi_view_grad`` on 8 virtual devices (loss rtol 1e-5, gradients rtol
1e-4, atol 1e-5, as ``tests/test_parallel.py``).

The world-size factor: an all-reduce inside autograd that every rank
back-propagates from its own copy of the summed loss returns the gradient
times the world size.  The processes compute that too, to show what the
checks above would catch, and the port's in-graph sum
(``tile._SumOverRanks``, identity backward) whose per-rank gradients sum to
the true one.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2

_WORKER = r"""
import json, os, sys
import numpy as np
sys.path.insert(0, os.environ['KAOLIN_REPO'])
import torch
torch.set_num_threads(1)
from kaolin_tpu_torch.parallel import distributed as D
from kaolin_tpu_torch.parallel import multi_view_grad, shard_views
from kaolin_tpu_torch.parallel.tile import _SumOverRanks

pid = int(os.environ['PROC_ID'])
world = int(os.environ['WORLD'])
assert not D.is_initialized()
dev = D.initialize(os.environ['STORE'], num_processes=world, process_id=pid,
                   device='cpu')
D.initialize(os.environ['STORE'], num_processes=world, process_id=pid,
             device='cpu')          # idempotent
assert D.process_count() == world and D.process_index() == pid
mesh = D.make_global_mesh(device=dev)
assert dict(mesh.shape) == {'data': world}
grid = D.make_global_mesh(('host', 'device'), (world, -1), device=dev)
assert dict(grid.shape) == {'host': world, 'device': 1}

# a deterministic global batch: every process can build all of it, and
# feeds only its own slice
rng = np.random.RandomState(0)
xs_global = rng.randn(8 * world, 8).astype(np.float32)
w0 = rng.randn(8, 4).astype(np.float32)
xs = D.host_local_array(mesh, xs_global.reshape(world, -1, 8)[pid])
assert torch.equal(xs, shard_views(mesh, xs_global))
w = torch.tensor(w0, requires_grad=True)


def loss_fn(params, views):
    return torch.sum((views @ params) ** 2) / (8 * world)


loss, grads = multi_view_grad(loss_fn, mesh)(w, xs)
import torch.distributed.nn.functional as dnn
naive = torch.autograd.grad(dnn.all_reduce(loss_fn(w, xs)), w)[0]
summed = _SumOverRanks.apply(loss_fn(w, xs).reshape(1), mesh, 'data')
assert torch.equal(summed, loss.reshape(1))
local = torch.autograd.grad(summed.sum(), w)[0]
out = {'pid': pid, 'loss': loss.item(),
       'gnorm': float(torch.linalg.norm(grads)),
       'grads': grads.tolist(),
       'naive': mesh.all_reduce(naive.clone()).tolist(),
       'summed': mesh.all_reduce(local.clone()).tolist()}
torch.distributed.destroy_process_group()
print('RESULT ' + json.dumps(out), flush=True)
"""


@pytest.fixture(scope='module')
def results(tmp_path_factory):
    store = tmp_path_factory.mktemp('store') / 'store'
    env = dict(os.environ, KAOLIN_REPO=REPO, STORE=f'file://{store}',
               WORLD=str(WORLD))
    procs = [subprocess.Popen(
        [sys.executable, '-c', _WORKER], env=dict(env, PROC_ID=str(pid)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(WORLD)]
    out = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, f'worker failed:\n{stdout}\n{stderr}'
            for line in stdout.splitlines():
                if line.startswith('RESULT '):
                    r = json.loads(line[len('RESULT '):])
                    out[r['pid']] = r
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert set(out) == set(range(WORLD))
    return out


def _one_process():
    rng = np.random.RandomState(0)
    xs = rng.randn(8 * WORLD, 8).astype(np.float64)
    w = rng.randn(8, 4).astype(np.float64)
    return (float(np.sum((xs @ w) ** 2) / (8 * WORLD)),
            2. * xs.T @ (xs @ w) / (8 * WORLD))


def test_two_process_sum_matches_single(results):
    """Both processes hold the same summed loss and gradients, equal to the
    one-process value."""
    assert results[0]['loss'] == results[1]['loss']
    assert results[0]['gnorm'] == results[1]['gnorm']
    assert results[0]['grads'] == results[1]['grads']
    loss, grad = _one_process()
    assert results[0]['loss'] == pytest.approx(loss, rel=1e-5)
    np.testing.assert_allclose(results[0]['grads'], grad, rtol=1e-4,
                               atol=1e-5)
    assert results[0]['gnorm'] == pytest.approx(np.linalg.norm(grad),
                                                rel=1e-5)


def test_two_process_sum_matches_jax(results):
    """The JAX package's multi_view_grad on 8 virtual devices, same batch."""
    import jax
    import jax.numpy as jnp
    from kaolin_tpu.parallel import make_mesh, multi_view_grad
    from kaolin_tpu.parallel import replicate, shard_views
    if len(jax.devices()) < 8:
        pytest.skip('needs 8 virtual devices')
    rng = np.random.RandomState(0)
    xs = rng.randn(8 * WORLD, 8).astype(np.float32)
    w = rng.randn(8, 4).astype(np.float32)

    def loss_fn(params, views):
        return jnp.sum((views @ params) ** 2) / (8 * WORLD)

    mesh = make_mesh((8,), ('data',))
    loss, grads = multi_view_grad(loss_fn, mesh)(
        replicate(mesh, jnp.asarray(w)), shard_views(mesh, jnp.asarray(xs)))
    np.testing.assert_allclose(results[0]['loss'], float(loss), rtol=1e-5)
    np.testing.assert_allclose(results[0]['grads'], np.asarray(grads),
                               rtol=1e-4, atol=1e-5)


def test_world_size_factor(results):
    """Per-rank gradients summed over the ranks: through an all-reduce
    inside autograd, back-propagated by every rank, they give the gradient
    times the world size; through the port's sums, once."""
    _, grad = _one_process()
    for r in results.values():
        np.testing.assert_allclose(r['naive'], WORLD * grad, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(r['summed'], grad, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(r['grads'], grad, rtol=1e-4, atol=1e-5)
