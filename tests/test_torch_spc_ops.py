"""Parity of the port's SPC ops with the JAX package, on the CPU.

uint8 helpers, quantization, morton codes, octree construction (host and
device builders), ``scan_octrees``, ``generate_points``, the ``Spc``
container and the ray generators, on numpy-seeded inputs at levels 2-7 and
at level 12 (codes past 30 bits: the JAX package's two-word range).
Tolerance: exact, except the ray generators (float32 matrix products,
1e-6).  Dtypes may differ (the port keeps int64 where JAX has int32);
values are compared.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kaolin_tpu.ops import spc as J
from kaolin_tpu.ops.spc import device as JD
from kaolin_tpu.render import spc as JR
from kaolin_tpu.rep import Spc as JSpc
from kaolin_tpu_torch.ops import spc as T
from kaolin_tpu_torch.ops.spc import device as TD
from kaolin_tpu_torch.ops.spc.points import unbatched_points_to_octree_np
from kaolin_tpu_torch.render import spc as TR
from kaolin_tpu_torch.rep import Spc as TSpc

LEVELS = [2, 3, 4, 5, 6, 12]


def build_both(points, level):
    """The same octree through both packages: ((octree, pyramid, exsum,
    point_hierarchy) of JAX, the same of the port)."""
    pts = np.asarray(points, np.int16)
    octree = J.unbatched_points_to_octree(pts, level)
    _, pyr, ex = J.scan_octrees(octree, np.array([len(octree)]))
    ph = J.generate_points(octree, pyr, ex)
    octree_t = T.unbatched_points_to_octree(torch.as_tensor(pts), level)
    _, pyr_t, ex_t = T.scan_octrees(octree_t, [len(octree_t)])
    ph_t = T.generate_points(octree_t, pyr_t, ex_t)
    return (octree, np.asarray(pyr)[0], ex, ph), (octree_t, pyr_t[0], ex_t,
                                                  ph_t)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a).astype(np.int64),
                                  b.numpy().astype(np.int64))


def test_uint8_ops():
    x = np.random.default_rng(0).integers(0, 256, (7, 5)).astype(np.uint8)
    bits = T.uint8_to_bits(torch.as_tensor(x))
    _eq(J.uint8_to_bits(jnp.asarray(x)), bits)
    _eq(J.bits_to_uint8(J.uint8_to_bits(jnp.asarray(x))),
        T.bits_to_uint8(bits))
    _eq(J.uint8_bits_sum(jnp.asarray(x)), T.uint8_bits_sum(torch.as_tensor(x)))


@pytest.mark.parametrize('level', LEVELS)
def test_quantize_and_morton(level):
    rng = np.random.default_rng(level)
    x = rng.uniform(-1.1, 1.1, (300, 3)).astype(np.float32)
    q = T.quantize_points(torch.as_tensor(x), level)
    _eq(J.quantize_points(jnp.asarray(x), level), q)
    pts = rng.integers(0, 2 ** level, (500, 3))
    m = T.points_to_morton(torch.as_tensor(pts))
    _eq(J.points_to_morton(pts).astype(np.int64), m)
    _eq(J.morton_to_points(J.points_to_morton(pts)), T.morton_to_points(m))
    hi, lo = JD.morton2_i32(jnp.asarray(pts, jnp.int32))
    hi_t, lo_t = TD.morton2_i32(torch.as_tensor(pts))
    _eq(hi, hi_t)
    _eq(lo, lo_t)
    if level <= 10:
        _eq(JD.morton_i32(jnp.asarray(pts, jnp.int32)),
            TD.morton_i32(torch.as_tensor(pts)))


@pytest.mark.parametrize('level', LEVELS)
def test_octree_scan_and_points(level):
    rng = np.random.default_rng(level + 10)
    pts = rng.integers(0, 2 ** level, (400, 3))
    (octree, pyr, ex, ph), (octree_t, pyr_t, ex_t, ph_t) = build_both(
        pts, level)
    _eq(octree, octree_t)
    np.testing.assert_array_equal(
        unbatched_points_to_octree_np(pts, level), octree_t.numpy())
    _eq(pyr, pyr_t)
    _eq(ex, ex_t)
    _eq(ph, ph_t)
    assert ph_t.dtype == torch.int16
    for lvl in (0, level // 2, level):
        _eq(J.unbatched_get_level_points(ph, pyr, lvl),
            T.unbatched_get_level_points(ph_t, pyr_t, lvl))


def test_scan_octrees_batched():
    rng = np.random.default_rng(5)
    octs = [np.array(J.unbatched_points_to_octree(
        rng.integers(0, 2 ** lvl, (60, 3)), lvl)) for lvl in (3, 5)]
    lengths = np.array([len(o) for o in octs])
    packed = np.concatenate(octs)
    ml, pyr, ex = J.scan_octrees(packed, lengths)
    ml_t, pyr_t, ex_t = T.scan_octrees(torch.as_tensor(packed), lengths)
    assert ml == ml_t == 5
    _eq(pyr, pyr_t)
    _eq(ex, ex_t)
    _eq(J.generate_points(packed, pyr, ex),
        T.generate_points(torch.as_tensor(packed), pyr_t, ex_t))
    spc = TSpc.from_list([torch.as_tensor(o) for o in octs])
    ref = JSpc.from_list(octs)
    assert spc.max_level == ref.max_level and len(spc) == 2
    assert set(spc.to_dict()) == TSpc.KEYS
    _eq(ref.pyramids, spc.pyramids)
    _eq(ref.point_hierarchies, spc.point_hierarchies)
    _eq(ref.num_points(3), spc.num_points(3))


@pytest.mark.parametrize('level', [2, 4, 7, 12])
def test_points_to_octree_device(level):
    rng = np.random.default_rng(level)
    n, cap = 500, 1024
    pts = rng.integers(0, 2 ** level, (n, 3))
    padded = np.zeros((cap, 3), np.int32)
    padded[:n] = pts
    valid = np.zeros(cap, bool)
    valid[:n] = True
    oj, cj, nj, mj, lj = JD.points_to_octree_device(
        jnp.asarray(padded), jnp.asarray(valid), level, cap=cap)
    ot, ct, nt, mt, lt = TD.points_to_octree_device(
        torch.as_tensor(padded), torch.as_tensor(valid), level, cap=cap)
    _eq(oj, ot)
    _eq(cj, ct)
    assert int(nj) == nt and int(lj) == lt
    mj = np.asarray(mj).astype(np.int64)
    np.testing.assert_array_equal((mj[:, 0] << 30) | mj[:, 1], mt.numpy())
    packed, total = TD.pack_octree_device(ot, ct, cap)
    assert total == nt
    _eq(J.unbatched_points_to_octree(pts, level), packed[:total])


def test_ray_generators():
    tf = np.random.default_rng(2).normal(size=(4, 4)).astype(np.float32)
    for args in ((4, 4), (6, 3), (3, 6)):          # py = i // height quirk
        oj, dj = JR.generate_primary_rays(*args, jnp.asarray(tf))
        ot, dt = TR.generate_primary_rays(*args, torch.as_tensor(tf))
        np.testing.assert_allclose(np.asarray(oj), ot.numpy(), atol=1e-6)
        np.testing.assert_allclose(np.asarray(dj), dt.numpy(), atol=1e-6)
    rng = np.random.default_rng(3)
    ro = rng.normal(size=(40, 3)).astype(np.float32)
    rd = rng.normal(size=(40, 3)).astype(np.float32)
    rd[::7] = [1., 0., 0.]                         # grazing: filtered
    light = np.array([0.2, 0.1, 4.], np.float32)
    plane = np.array([0., 0.3, 1., 0.1], np.float32)
    out_j = JR.generate_shadow_rays(ro, rd, light, plane)
    out_t = TR.generate_shadow_rays(*(torch.as_tensor(a)
                                      for a in (ro, rd, light, plane)))
    assert 0 < out_t[2].shape[0] < 40
    _eq(out_j[2], out_t[2])
    for a, b in zip(out_j[:2], out_t[:2]):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-6)
