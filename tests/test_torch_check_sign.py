"""``check_sign`` of the port against kaolin_tpu.

Same numpy-seeded points and meshes on both sides: the inside flags equal,
whatever the chunk size, also for points on a plane through the mesh's
vertex rings.  A point on the surface itself (on a vertex) is inside or
out by rounding: the face plane's z there equals the point's up to the
last bit, which XLA's fused multiply-adds on the JAX side decide
otherwise than the port's separate products (ROADMAP.md section 3); those
points are held to the port's own answer being a valid bool only.
``use_hash=True`` (the native triangle hash) is held against the JAX
package in ``test_torch_native_io.py``.
"""
import importlib

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaolin_tpu_torch.utils.testing import uv_sphere

# the packages' ``ops.mesh`` export the function under the module's name
cs_j = importlib.import_module('kaolin_tpu.ops.mesh.check_sign')
cs_t = importlib.import_module('kaolin_tpu_torch.ops.mesh.check_sign')


@pytest.fixture(scope='module')
def scene():
    s = uv_sphere(12, 7)
    rng = np.random.default_rng(0)
    v = (s.vertices * 0.45).astype(np.float32)
    verts = np.stack([v, (v * [1.2, 0.8, 1.] + 0.05).astype(np.float32)])
    pts = rng.uniform(-0.6, 0.6, (2, 2000, 3)).astype(np.float32)
    pts[:, :20] = verts[:, :20]                      # on the vertices
    pts[:, 20:40, 2] = 0.                            # on a symmetry plane
    return verts, s.faces, pts


@pytest.mark.parametrize('chunk', [None, 333])
def test_check_sign(scene, chunk):
    verts, faces, pts = scene
    in_j = np.asarray(cs_j.check_sign(jnp.asarray(verts), faces,
                                      jnp.asarray(pts)))
    in_t = cs_t.check_sign(torch.as_tensor(verts), torch.as_tensor(faces),
                           torch.as_tensor(pts), chunk_size=chunk)
    assert in_t.dtype == torch.bool
    np.testing.assert_array_equal(in_t.numpy()[:, 20:], in_j[:, 20:])
    r = np.linalg.norm(pts[0], axis=-1)
    assert in_j[0][r < 0.4].all() and not in_j[0][r > 0.46].any()


def test_unbatched_and_crossings(scene):
    verts, faces, pts = scene
    assert torch.equal(
        cs_t._unbatched_check_sign_cuda(torch.as_tensor(verts[1]), faces,
                                        torch.as_tensor(pts[1])),
        cs_t.check_sign(torch.as_tensor(verts), faces,
                        torch.as_tensor(pts))[1])
    fv = verts[0][faces]
    np.testing.assert_array_equal(
        cs_t._crossings(torch.as_tensor(pts[0, 20:]), *[
            torch.as_tensor(fv[:, k]) for k in range(3)]).numpy(),
        np.asarray(cs_j._crossings(jnp.asarray(pts[0, 20:]), *[
            jnp.asarray(fv[:, k]) for k in range(3)])))


@pytest.mark.parametrize('use_hash', [False, True])
def test_shape_errors(scene, use_hash):
    verts, faces, pts = scene
    with pytest.raises(ValueError):
        cs_t.check_sign(torch.zeros(4, 3), faces, torch.as_tensor(pts),
                        use_hash=use_hash)
    with pytest.raises(ValueError):
        cs_t.check_sign(torch.as_tensor(verts), faces, torch.zeros(4, 3),
                        use_hash=use_hash)
