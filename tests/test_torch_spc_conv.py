"""The port's sparse convolutions against the JAX package, on the CPU.

``conv3d`` and ``conv_transpose3d`` at jump 0, 1 and 2, the 1x1 path and a
batch of two octrees; outputs and the gradients with respect to the input,
the weight and the bias within 1e-5 of their max (the port sums taps and
channels in another order than the JAX einsum).  ``Conv3d`` and
``ConvTranspose3d`` load the JAX modules' flax parameters through
``from_jax_params``.  Levels <= 5, channels <= 8, numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kaolin_tpu.ops import spc as J
from kaolin_tpu_torch.ops import spc as T

REL = 1e-5


def kernel_vectors(lo, hi):
    """All offsets in [lo, hi)^3, x slowest."""
    r = np.arange(lo, hi)
    return np.stack(np.meshgrid(r, r, r, indexing='ij'),
                    -1).reshape(-1, 3).astype(np.int16)


def batch(level, seeds, n=400):
    """Octrees of random points at ``level`` (one per seed), packed: the
    (JAX, port) scan products (octrees, pyramids, exsum, hierarchies)."""
    octrees = [np.asarray(J.unbatched_points_to_octree(
        np.random.default_rng(s).integers(0, 2 ** level, (n, 3)), level))
        for s in seeds]
    packed = np.concatenate(octrees)
    lengths = np.array([len(o) for o in octrees], np.int32)
    _, pyr, ex = J.scan_octrees(packed, lengths)
    ph = J.generate_points(packed, pyr, ex)
    packed_t = torch.as_tensor(packed)
    _, pyr_t, ex_t = T.scan_octrees(packed_t, lengths)
    ph_t = T.generate_points(packed_t, pyr_t, ex_t)
    return (jnp.asarray(packed), pyr, ex, ph), (packed_t, pyr_t, ex_t, ph_t)


def close(a, b):
    a = np.asarray(a)
    scale = np.abs(a).max()
    assert scale > 0
    np.testing.assert_allclose(b.detach().numpy(), a, rtol=0,
                               atol=REL * scale)


def run_both(fn_j, fn_t, j, t, level, cin, cout, kv, jump, seed,
             bias=True):
    """Output and gradients (input, weight, bias) of both packages under a
    random linear loss."""
    rng = np.random.default_rng(seed)
    n = int(np.asarray(j[1])[:, 0, level].sum())
    x = rng.normal(size=(n, cin)).astype(np.float32)
    w = rng.normal(size=(len(kv), cin, cout)).astype(np.float32)
    b = rng.normal(size=(cout,)).astype(np.float32) if bias else None

    def loss_j(x_, w_, b_):
        out, lv = fn_j(j[0], j[3], level, j[1], j[2], x_, w_, kv, jump, b_)
        return out, lv

    out_j, lv_j = loss_j(jnp.asarray(x), jnp.asarray(w),
                         None if b is None else jnp.asarray(b))
    g = rng.normal(size=out_j.shape).astype(np.float32)
    args = [jnp.asarray(x), jnp.asarray(w)] + ([jnp.asarray(b)] if bias
                                               else [])
    grads_j = jax.grad(lambda *a: jnp.sum(loss_j(
        a[0], a[1], a[2] if bias else None)[0] * g),
        argnums=tuple(range(len(args))))(*args)
    ts = [torch.tensor(a, requires_grad=True) for a in
          ([x, w] + ([b] if bias else []))]
    out_t, lv_t = fn_t(t[0], t[3], level, t[1], t[2], ts[0], ts[1], kv, jump,
                       ts[2] if bias else None)
    (out_t * torch.as_tensor(g)).sum().backward()
    assert lv_t == lv_j
    close(out_j, out_t)
    for a, tt in zip(grads_j, ts):
        close(a, tt.grad)
    return out_t


@pytest.mark.parametrize('jump,kv', [(0, (-1, 2)), (1, (0, 2)), (2, (0, 4)),
                                     (1, (-1, 2))])
def test_conv3d(jump, kv):
    level = 4
    j, t = batch(level, [1])
    out = run_both(J.conv3d, T.conv3d, j, t, level, 5, 7,
                   kernel_vectors(*kv), jump, seed=jump)
    assert out.shape[0] == int(t[1][0, 0, level - jump])


@pytest.mark.parametrize('jump,kv', [(0, (-1, 2)), (1, (0, 2)), (2, (0, 4)),
                                     (1, (-1, 2))])
def test_conv_transpose3d(jump, kv):
    level = 5 - jump
    j, t = batch(5, [2])
    out = run_both(J.conv_transpose3d, T.conv_transpose3d, j, t, level, 6,
                   4, kernel_vectors(*kv), jump, seed=10 + jump,
                   bias=jump != 2)
    assert out.shape[0] == int(t[1][0, 0, level + jump])


@pytest.mark.parametrize('fn', ['conv3d', 'conv_transpose3d'])
def test_one_by_one(fn):
    j, t = batch(3, [3])
    run_both(getattr(J, fn), getattr(T, fn), j, t, 3, 3, 8,
             np.array([[0, 0, 0]], np.int16), 0, seed=4)


@pytest.mark.parametrize('fn,level,jump', [('conv3d', 4, 0),
                                           ('conv3d', 4, 1),
                                           ('conv_transpose3d', 3, 1)])
def test_batch_of_two_octrees(fn, level, jump):
    j, t = batch(4, [5, 6])
    kv = kernel_vectors(-1, 2) if jump == 0 else kernel_vectors(0, 2)
    run_both(getattr(J, fn), getattr(T, fn), j, t, level, 4, 5, kv, jump,
             seed=7)


@pytest.mark.parametrize('name,level,jump,use_bias', [
    ('Conv3d', 4, 0, True), ('Conv3d', 4, 1, False),
    ('ConvTranspose3d', 3, 1, True)])
def test_modules_from_jax_params(name, level, jump, use_bias):
    j, t = batch(4, [8])
    kv = kernel_vectors(-1, 2) if jump == 0 else kernel_vectors(0, 2)
    mj = getattr(J, name)(in_channels=4, out_channels=6,
                          kernel_vectors=tuple(map(tuple, kv.tolist())),
                          jump=jump, use_bias=use_bias)
    n = int(np.asarray(j[1])[0, 0, level])
    x = np.random.default_rng(9).normal(size=(n, 4)).astype(np.float32)
    variables = mj.init(jax.random.PRNGKey(0), j[0], j[3], level, j[1],
                        j[2], jnp.asarray(x))
    if use_bias:      # the flax initializer sets the bias to 0
        variables = jax.tree_util.tree_map(lambda a: a + 0.1, variables)
    out_j, lv_j = mj.apply(variables, j[0], j[3], level, j[1], j[2],
                           jnp.asarray(x))
    mt = getattr(T, name)(4, 6, kv, jump=jump, use_bias=use_bias,
                          generator=torch.Generator().manual_seed(0),
                          device='cpu')
    mt.load_state_dict(T.from_jax_params(
        jax.tree_util.tree_map(np.asarray, variables), device='cpu'))
    out_t, lv_t = mt(t[0], t[3], level, t[1], t[2], torch.as_tensor(x))
    assert lv_t == lv_j
    close(out_j, out_t)


def test_module_init():
    """The weights start from the generator: N(0, 1) * sqrt(2 / (Cin K)),
    the bias from 0."""
    kv = kernel_vectors(-1, 2)
    a, b = (T.Conv3d(8, 16, kv, generator=torch.Generator().manual_seed(3),
                     device='cpu') for _ in range(2))
    assert torch.equal(a.weight, b.weight) and a.weight.shape == (27, 8, 16)
    assert torch.equal(a.bias, torch.zeros(16))
    std = float(a.weight.detach().std()) / np.sqrt(2. / (8 * 27))
    assert 0.9 < std < 1.1
    assert T.ConvTranspose3d(8, 16, kv, use_bias=False,
                             device='cpu').bias is None
