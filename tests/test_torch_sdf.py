"""``sdf_to_voxelgrids`` of the port against kaolin_tpu's native MISE path.

Both packages drive the same MISE octree (``csrc/mise.cpp``, the port its
own build of it); the JAX side is asserted to have loaded its native
library, so it does not take its numpy fallback.  The SDFs are analytic
(a sphere, a box) and computed in numpy on both sides, so the grids must
be equal exactly, as must the query points handed to the SDF.
"""
import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaolin_tpu.ops.conversions import sdf as sdf_j
from kaolin_tpu_torch.ops.conversions import sdf as sdf_t
from tests.test_torch_native_io import jax_native


def sphere_sdf(x):
    return np.sqrt((x.astype(np.float64) ** 2).sum(-1)) - 0.3


def box_sdf(x):
    q = np.abs(x.astype(np.float64) - [0.05, -0.02, 0.]) - [0.3, 0.2, 0.25]
    outside = np.linalg.norm(np.maximum(q, 0.), axis=-1)
    return outside + np.minimum(q.max(-1), 0.)


SDFS = dict(sphere=sphere_sdf, box=box_sdf)


def _on_jax(fn, log):
    def call(x):
        x = np.asarray(x)
        log.append(x)
        return jnp.asarray(fn(x).astype(np.float32))
    return call


def _on_torch(fn, log):
    def call(x):
        assert torch.is_tensor(x) and x.dtype == torch.float32
        assert x.device.type == 'cpu' and x.ndim == 2 and x.shape[1] == 3
        log.append(x.numpy())
        return torch.as_tensor(fn(x.numpy()).astype(np.float32))
    return call


@pytest.mark.parametrize('init_res,steps', [(8, 2), (4, 3), (16, 1),
                                            (32, 0)])
@pytest.mark.parametrize('box', [(0., 1.), ((0.1, -0.05, 0.), 1.2)])
def test_sdf_to_voxelgrids_equal(init_res, steps, box):
    jax_native()
    center, dim = box
    log_j, log_t = [], []
    fns = list(SDFS.values())
    grid_j = np.asarray(sdf_j.sdf_to_voxelgrids(
        [_on_jax(f, log_j) for f in fns], center, dim, init_res, steps))
    grid_t = sdf_t.sdf_to_voxelgrids(
        [_on_torch(f, log_t) for f in fns], center, dim, init_res, steps,
        device='cpu')
    side = init_res * 2 ** steps + 1
    assert grid_t.shape == (2, side, side, side)
    assert grid_t.dtype == torch.float32 and grid_t.device.type == 'cpu'
    np.testing.assert_array_equal(grid_t.numpy(), grid_j)
    assert len(log_t) == len(log_j)
    for a, b in zip(log_t, log_j):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert 0 < grid_j.sum() < grid_j.size


def test_grid_is_the_sdf_sign():
    """Away from the surface the MISE grid is the SDF's sign on the dense
    grid."""
    grid = sdf_t.sdf_to_voxelgrids(
        [lambda x: torch.as_tensor(sphere_sdf(x.numpy()))], init_res=8,
        upsampling_steps=2, device='cpu')[0].numpy()
    lin = np.linspace(-0.5, 0.5, 33)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing='ij'), -1)
    d = sphere_sdf(pts)
    far = np.abs(d) > 2. / 32
    np.testing.assert_array_equal(grid[far], (d <= 0)[far])


def test_sdf_errors():
    with pytest.raises(TypeError):
        sdf_t.sdf_to_voxelgrids(sphere_sdf, device='cpu')
    with pytest.raises(TypeError):
        sdf_t.sdf_to_voxelgrids([1], device='cpu')
