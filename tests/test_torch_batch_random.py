"""Batch layouts, packed reductions, the random generators and the graph
convolution of the port against kaolin_tpu.

Batch utilities and ``packed_simple_sum`` equal the JAX package's on the
same inputs (``tile_to_packed``'s gradient too).  The generators draw from
a ``torch.Generator`` (no common stream with JAX keys): shapes, ranges,
the same draws under one seed, and octrees the port's SPC checks accept.
``GraphConv`` with the JAX module's flax parameters: outputs within 1e-5
(sparse and dense adjacency, normalized or not); ``normalize_adj`` and
``sparse_bmm`` within 1e-6.
"""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from kaolin_tpu.ops import batch as b_j
from kaolin_tpu.ops import gcn as gcn_j
from kaolin_tpu.ops import reduction as r_j
from kaolin_tpu.ops.mesh import mesh as mesh_j
from kaolin_tpu_torch.ops import batch as b_t
from kaolin_tpu_torch.ops import gcn as gcn_t
from kaolin_tpu_torch.ops import random as rnd
from kaolin_tpu_torch.ops import reduction as r_t
from kaolin_tpu_torch.ops.mesh import mesh as mesh_t
from kaolin_tpu_torch.ops.spc import scan_octrees
from kaolin_tpu_torch.utils.testing import uv_sphere


def _ragged(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((n, m, 3)).astype(np.float32)
            for n, m in ((2, 3), (4, 1), (1, 5))]


def test_packed_and_padded():
    lst = _ragged(0)
    packed_t, shapes_t = b_t.list_to_packed([torch.as_tensor(x)
                                             for x in lst])
    packed_j, shapes_j = b_j.list_to_packed([jnp.asarray(x) for x in lst])
    np.testing.assert_array_equal(packed_t.numpy(), np.asarray(packed_j))
    np.testing.assert_array_equal(shapes_t, shapes_j)
    numel = b_t.total_numel(shapes_t)
    first = b_t.get_first_idx(numel)
    np.testing.assert_array_equal(first, b_j.get_first_idx(numel))
    for a, b in zip(b_t.packed_to_list(packed_t, shapes_t, first), lst):
        np.testing.assert_array_equal(a.numpy(), b)
    for max_shape in (None, (5, -1)):
        pad_t = b_t.packed_to_padded(packed_t, shapes_t, first, -1.,
                                     max_shape)
        pad_j = b_j.packed_to_padded(packed_j, shapes_j, first, -1.,
                                     max_shape)
        np.testing.assert_array_equal(pad_t.numpy(), np.asarray(pad_j))
        np.testing.assert_array_equal(
            b_t.padded_to_packed(pad_t, shapes_t).numpy(), packed_t.numpy())
    with pytest.raises(ValueError):
        b_t.fill_max_shape(shapes_t, (1, -1))
    with pytest.raises(ValueError):
        b_t.list_to_packed([torch.zeros(2, 3), torch.zeros(2, 4)])
    np.testing.assert_array_equal(
        b_t.list_to_padded([torch.ones(1, 2, dtype=torch.int64),
                            torch.ones(3, 2, dtype=torch.int64)], 7)[0]
        .numpy(), np.asarray(b_j.list_to_padded(
            [jnp.ones((1, 2), jnp.int32), jnp.ones((3, 2), jnp.int32)],
            7)[0]))


def test_tile_and_packed_sum():
    numel = np.array([3, 0, 5, 2])
    vals = np.array([1., 2., 3., 4.], np.float32)
    x = torch.tensor(vals, requires_grad=True)
    tiled = b_t.tile_to_packed(x, numel)
    np.testing.assert_array_equal(tiled.detach().numpy(),
                                  np.asarray(b_j.tile_to_packed(vals, numel)))
    w = np.arange(10, dtype=np.float32)[:, None]
    (tiled * torch.as_tensor(w)).sum().backward()
    g_j = jax.grad(lambda v: jnp.sum(b_j.tile_to_packed(v, numel) * w))(
        jnp.asarray(vals))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(g_j))
    packed = np.random.default_rng(1).standard_normal((10, 3)).astype(
        np.float32)
    np.testing.assert_allclose(
        r_t.packed_simple_sum(torch.as_tensor(packed), numel).numpy(),
        np.asarray(r_j.packed_simple_sum(jnp.asarray(packed), numel)),
        rtol=1e-6, atol=1e-6)


def test_random_generators():
    gen = torch.Generator().manual_seed(0)
    shapes = rnd.random_shape_per_tensor(50, [2, 1], [4, 3], generator=gen)
    assert shapes.dtype == np.int64 and shapes.shape == (50, 2)
    assert shapes.min(0).tolist() == [2, 1] and \
        shapes.max(0).tolist() == [4, 3]
    f = rnd.random_tensor(-1., 2., (1000,), device='cpu',
                          generator=torch.Generator().manual_seed(1))
    assert f.dtype == torch.float32 and -1 <= f.min() and f.max() < 2
    assert torch.equal(f, rnd.random_tensor(
        -1., 2., (1000,), device='cpu',
        generator=torch.Generator().manual_seed(1)))
    i = rnd.random_tensor(3, 5, (1000,), dtype=torch.int32, device='cpu')
    assert set(i.unique().tolist()) == {3, 4, 5}
    assert rnd.random_tensor(0, 1, (10,), dtype=torch.bool,
                             device='cpu').dtype == torch.bool
    az, el = rnd.sample_spherical_coords((2000,), elevation_low=-0.5,
                                         device='cpu')
    assert 0 <= az.min() and az.max() < 2 * np.pi
    assert -0.5 <= el.min() and el.max() <= np.pi / 2
    # uniform on the sphere: sin(elevation) uniform
    assert abs(torch.sin(el).mean().item()
               - (np.sin(-0.5) + 1.) / 2.) < 0.05
    rnd.manual_seed(4)
    state = rnd.get_state()
    a = rnd.random_tensor(0., 1., (5,), device='cpu')
    rnd.set_state(*state)
    assert torch.equal(a, rnd.random_tensor(0., 1., (5,), device='cpu'))


def test_random_spc_octrees():
    octrees, lengths = rnd.random_spc_octrees(
        3, 4, device='cpu', generator=torch.Generator().manual_seed(2))
    assert octrees.dtype == torch.uint8 and lengths.dtype == np.int32
    assert int(lengths.sum()) == octrees.shape[0] and (octrees > 0).all()
    # valid octrees: each level's node count is the previous level's bits
    _, pyramids, exsum = scan_octrees(octrees, lengths)
    assert pyramids.shape[:2] == (3, 2)
    assert (pyramids[:, 0, 0] == 1).all()
    off = 0
    for b, n in enumerate(lengths.tolist()):
        o = octrees[off:off + n].numpy()
        nodes = pyramids[b, 0, :4].tolist()
        assert sum(nodes) == n
        assert pyramids[b, 0, 4] == np.unpackbits(o[-nodes[-1]:]).sum()
        off += n


def test_graph_conv():
    s = uv_sphere(6, 4)
    V = len(s.vertices)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, V, 5)).astype(np.float32)
    adj_j = mesh_j.adjacency_matrix(V, s.faces)
    adj_t = mesh_t.adjacency_matrix(V, torch.as_tensor(s.faces))
    np.testing.assert_allclose(
        gcn_t.normalize_adj(adj_t).to_dense().numpy(),
        gcn_j.normalize_adj(adj_j).todense(), atol=1e-6)
    np.testing.assert_allclose(
        gcn_t.normalize_adj(adj_t.to_dense()).numpy(),
        np.asarray(gcn_j.normalize_adj(adj_j.todense())), atol=1e-6)
    np.testing.assert_allclose(
        gcn_t.sparse_bmm(adj_t, torch.as_tensor(x)).numpy(),
        np.asarray(gcn_j.sparse_bmm(adj_j, jnp.asarray(x))), atol=1e-5)
    # (self layer, sparse adjacency, normalized)
    for self_layer, sparse, norm in ((True, True, True),
                                     (False, False, False)):
        layer_j = gcn_j.GraphConv(7, self_layer=self_layer)
        params = layer_j.init(jax.random.key(0), jnp.asarray(x), adj_j)
        layer_t = gcn_t.GraphConv(5, 7, self_layer=self_layer, device='cpu')
        layer_t.load_state_dict(gcn_t.from_jax_params(
            jax.tree_util.tree_map(np.asarray, params), device='cpu'))
        out_j = layer_j.apply(params, jnp.asarray(x),
                              adj_j if sparse else adj_j.todense(), norm)
        out_t = layer_t(torch.as_tensor(x),
                        adj_t if sparse else adj_t.to_dense(), norm)
        np.testing.assert_allclose(out_t.detach().numpy(), np.asarray(out_j),
                                   atol=1e-5)
