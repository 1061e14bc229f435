"""Voxelgrid ops and the voxelgrid -> mesh conversions of the port against
kaolin_tpu.

Same numpy-seeded grids on both sides (binary grids at 6^3-16^3, a solid
sphere, an empty and a full grid): ``downsample``, ``extract_surface``
(wide, thin), ``fill``, ``extract_odms``, ``project_odms`` (without a grid and 1
vote, with one and 3 votes) equal; ``voxelgrids_to_cubic_meshes`` (triangles and
quads) and ``voxelgrids_to_trianglemeshes_mt`` with equal vertices (1e-6)
and faces.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaolin_tpu.ops import voxelgrid as vg_j
from kaolin_tpu.ops.conversions import voxelgrid as cv_j
from kaolin_tpu_torch.ops import voxelgrid as vg_t
from kaolin_tpu_torch.ops.conversions import voxelgrid as cv_t


def _grids(seed, dim=8, B=2):
    rng = np.random.default_rng(seed)
    g = rng.random((B, dim, dim, dim)) > 0.55
    c = (np.arange(dim) - (dim - 1) / 2.) / dim
    r = np.sqrt(c[:, None, None] ** 2 + c[None, :, None] ** 2
                + c[None, None, :] ** 2)
    g[0] = r < 0.35                                   # a solid sphere
    return g


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a.cpu()), np.asarray(b))


def test_downsample_and_surface():
    g = _grids(0, 12)
    for scale in (2, (2, 3, 4), (1, 1, 1)):
        _eq(vg_t.downsample(torch.as_tensor(g), scale),
            vg_j.downsample(jnp.asarray(g), scale))
    rng = np.random.default_rng(1)
    dens = rng.random((1, 8, 8, 8)).astype(np.float32)
    np.testing.assert_allclose(
        vg_t.downsample(torch.as_tensor(dens), 2).numpy(),
        np.asarray(vg_j.downsample(jnp.asarray(dens), 2)), atol=1e-6)
    for mode in ('wide', 'thin'):
        _eq(vg_t.extract_surface(torch.as_tensor(g), mode),
            vg_j.extract_surface(jnp.asarray(g), mode))
    with pytest.raises(ValueError):
        vg_t.downsample(torch.as_tensor(g), (2, 2))
    with pytest.raises(ValueError):
        vg_t.extract_surface(torch.as_tensor(g), 'bad')


def test_fill():
    g = _grids(2, 10)
    shell = vg_t.extract_surface(torch.as_tensor(g))
    out = vg_t.fill(shell)
    assert out.dtype == torch.bool and out.device.type == 'cpu'
    _eq(out, vg_j.fill(jnp.asarray(np.asarray(shell))))
    assert torch.equal(out[0], torch.as_tensor(g[0]))    # the solid sphere


def test_odms():
    g = _grids(3, 9)
    odms_t = vg_t.extract_odms(torch.as_tensor(g))
    odms_j = vg_j.extract_odms(jnp.asarray(g))
    assert odms_t.dtype == torch.int32
    _eq(odms_t, odms_j)
    _eq(vg_t.project_odms(odms_t), vg_j.project_odms(odms_j))
    _eq(vg_t.project_odms(odms_t, torch.as_tensor(g), 3),
        vg_j.project_odms(odms_j, jnp.asarray(g), 3))


@pytest.mark.parametrize('is_trimesh', [True, False])
def test_cubic_meshes(is_trimesh):
    g = _grids(4, 6, B=3)
    g[2] = False                                       # an empty grid
    v_t, f_t = cv_t.voxelgrids_to_cubic_meshes(torch.as_tensor(g),
                                               is_trimesh)
    v_j, f_j = cv_j.voxelgrids_to_cubic_meshes(jnp.asarray(g), is_trimesh)
    for a, b in zip(v_t, v_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    for a, b in zip(f_t, f_j):
        _eq(a, b)
    assert f_t[0].shape[1] == (3 if is_trimesh else 4)
    assert v_t[2].shape == (0, 3)


def test_trianglemeshes_mt():
    g = _grids(5, 6)
    v_t, f_t = cv_t.voxelgrids_to_trianglemeshes_mt(torch.as_tensor(g))
    v_j, f_j = cv_j.voxelgrids_to_trianglemeshes_mt(jnp.asarray(g))
    for a, b, c, d in zip(v_t, v_j, f_t, f_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        _eq(c, d)
