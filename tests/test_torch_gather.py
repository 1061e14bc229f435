"""``ops/gather.py`` of the port against the JAX package's, on the CPU.

``flat_index`` exactly equal; ``gather_rows`` value and gradient (the
scatter-add of the cotangent onto the rows, repeated ids summed) exactly
equal to ``jax.grad`` through the JAX custom_vjp: every output element is
one row value, and each gradient row a sum of the same float32 cotangent
values; the test's values are integers and halves, so the sum is exact in
any order.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.ops import gather as GJ
from kaolin_tpu_torch.ops import gather as GT


@pytest.mark.parametrize('B,N,shape', [(1, 5, (7,)), (3, 6, (4, 5)),
                                       (4, 9, (2, 3, 2))])
def test_flat_index(B, N, shape):
    idx = np.random.default_rng(B).integers(0, N, (B,) + shape)
    ref = np.asarray(GJ.flat_index(jnp.asarray(idx, jnp.int32), N))
    out = GT.flat_index(torch.as_tensor(idx), N)
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize('B,N,D,P', [(1, 8, 3, 20), (3, 5, 4, 16)])
def test_gather_rows_value_and_grad(B, N, D, P):
    """Batched ids (B > 1) folded by flat_index, each row gathered several
    times (P > N)."""
    rng = np.random.default_rng(N)
    table = (rng.integers(-8, 8, (B * N, D)) / 2.).astype(np.float32)
    idx = rng.integers(0, N, (B, P))
    assert len(np.unique(idx)) < idx.size          # repeated ids
    cot = (rng.integers(-8, 8, (B * P, D)) / 2.).astype(np.float32)
    flat_j = GJ.flat_index(jnp.asarray(idx, jnp.int32), N)
    out_j, vjp = jax.vjp(lambda t: GJ.gather_rows(t, flat_j),
                         jnp.asarray(table))
    (grad_j,) = vjp(jnp.asarray(cot))

    t = torch.tensor(table, requires_grad=True)
    flat_t = GT.flat_index(torch.as_tensor(idx), N)
    out_t = GT.gather_rows(t, flat_t)
    out_t.backward(torch.as_tensor(cot))
    np.testing.assert_array_equal(out_t.detach().numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(grad_j))
    assert not flat_t.requires_grad
