"""The slice on the CPU: a pinhole ``Camera``'s rays traced through the
octree, features interpolated at the hits and integrated into an image,
an L1 loss and its gradient to the corner features, in both packages.

The port traces with the ``'mosaic'`` engine (K3's plain version on the
CPU), the JAX package with its ``'xla'`` engine, on a sphere's level-5
octree seen from a generic eye (no two hits of a ray at one depth, so both
orders agree).  The nuggets' ray and point ids are equal, their depths
within 1e-5 relative (the two packages' view matrices, and so the ray
origins, differ in the last bit); the image and the gradient to the
features within 1e-5 of their max.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import torch

from kaolin_tpu.ops import spc as JS
from kaolin_tpu.render import camera as JC
from kaolin_tpu.render import spc as JR
from kaolin_tpu_torch.ops import spc as TS
from kaolin_tpu_torch.ops.conversions import unbatched_mesh_to_spc
from kaolin_tpu_torch.render import camera as TC
from kaolin_tpu_torch.render import spc as TR
from kaolin_tpu_torch.utils.testing import uv_sphere

from tests.test_torch_spc_ops import build_both

LEVEL = 5
SIDE = 64
EYE = np.array([0.824, 0.524, 1.138], np.float32)    # 1.5 from the center
TRACE = dict(rays_per_tile=16, knum=64, with_exit=True,
             grid_shape=(SIDE, SIDE))


def scene():
    s = uv_sphere(24, 13)
    points = unbatched_mesh_to_spc((s.vertices * 0.45)[s.faces], LEVEL)[1]
    j, t = build_both(points.numpy(), LEVEL)
    rng = np.random.default_rng(7)
    n_dual = int(TS.unbatched_make_dual(t[3], t[1])[1][0, LEVEL])
    feats, target = (np.concatenate([rng.random((n_dual, 3)),
                                     rng.uniform(0.5, 1.5, (n_dual, 1)),
                                     rng.normal(size=(n_dual, 2))], -1)
                     .astype(np.float32) for _ in range(2))
    return j, t, feats, target


def shade(ops, o, d, ridx, pidx, depths, ph, trinkets, feats, where,
          num_rays):
    """Sample each nugget at its mid depth, interpolate, integrate and
    place each ray's colour in the image (``ops`` = one package's
    functions, ``where`` its scatter)."""
    interp, mark, integrate = ops
    mid = o[ridx] + d[ridx] * ((depths[:, 0] + depths[:, 1]) / 2)[:, None]
    samples = interp(mid[:, None], pidx, ph, trinkets, feats, LEVEL)[:, 0]
    first = mark(ridx)
    colour, _ = integrate(samples[:, :3], samples[:, 3:4], first)
    return where(num_rays, ridx[first], colour)


def jax_render(j, feats):
    cam = JC.Camera.from_args(eye=jnp.asarray(EYE), at=jnp.zeros(3),
                              up=jnp.array([0., 1., 0.]),
                              fov=math.radians(45), width=SIDE, height=SIDE)
    o, d = (x[0] for x in cam.generate_rays())
    hits = JR.unbatched_raytrace_coherent(j[0], j[3], j[1], j[2], o, d,
                                          LEVEL, engine='xla',
                                          max_tile_voxels=64 * 1024, **TRACE)
    ridx, pidx, depths = JR.hits_to_nuggets(hits)
    dual, pdual = JS.unbatched_make_dual(j[3], j[1])
    trinkets, _ = JS.unbatched_make_trinkets(j[3], j[1], dual, pdual)

    def image(f):
        return shade((JS.unbatched_interpolate_trilinear,
                      JR.mark_pack_boundaries, JR.exponential_integration),
                     o, d, ridx, pidx, depths, j[3], trinkets, f,
                     lambda n, i, c: jnp.zeros((n, 3)).at[i].set(c),
                     o.shape[0])
    return (ridx, pidx, depths), image


def torch_render(t, feats):
    cam = TC.Camera.from_args(eye=EYE, at=np.zeros(3), up=[0., 1., 0.],
                              fov=math.radians(45), width=SIDE, height=SIDE,
                              device='cpu')
    o, d = (x[0] for x in cam.generate_rays())
    table = TR.build_cell_table(t[3], t[1], LEVEL, cell_shift=2,
                                cell_width=64)
    hits = TR.unbatched_raytrace_coherent(
        t[0], t[3], t[1], t[2], o, d, LEVEL, engine='mosaic',
        cell_table=table, segments=((None, 4096),),
        max_super_voxels=64 * 4096, **TRACE)
    assert table.overflow == 0 and not bool(hits.saturated)
    ridx, pidx, depths = TR.hits_to_nuggets(hits)
    dual, pdual = TS.unbatched_make_dual(t[3], t[1])
    trinkets, _ = TS.unbatched_make_trinkets(t[3], t[1], dual, pdual)
    image = shade((TS.unbatched_interpolate_trilinear,
                   TR.mark_pack_boundaries, TR.exponential_integration),
                  o, d, ridx, pidx, depths, t[3], trinkets, feats,
                  lambda n, i, c: torch.zeros((n, 3)).index_put(
                      (i.long(),), c), o.shape[0])
    return (ridx, pidx, depths), image


def test_camera_trace_interpolate_integrate():
    j, t, feats, target = scene()
    nug_j, image_j = jax_render(j, feats)
    f = torch.tensor(feats, requires_grad=True)
    nug_t, img_t = torch_render(t, f)
    for a, b in zip(nug_j[:2], nug_t[:2]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_allclose(nug_t[2].numpy(), np.asarray(nug_j[2]),
                               rtol=1e-5, atol=0)
    hit_share = np.unique(np.asarray(nug_j[0])).shape[0] / SIDE ** 2
    assert 0.3 < hit_share < 0.7          # the sphere fills the view
    img_j = image_j(jnp.asarray(feats))
    scale = np.abs(np.asarray(img_j)).max()
    np.testing.assert_allclose(img_t.detach().numpy(), np.asarray(img_j),
                               rtol=0, atol=1e-5 * scale)

    tgt_j = image_j(jnp.asarray(target))
    g_j = np.asarray(jax.grad(lambda x: jnp.mean(jnp.abs(
        image_j(x) - tgt_j)))(jnp.asarray(feats)))
    _, tgt_t = torch_render(t, torch.as_tensor(target))
    (img_t - tgt_t).abs().mean().backward()
    assert np.abs(g_j).max() > 0
    np.testing.assert_allclose(f.grad.numpy(), g_j, rtol=0,
                               atol=1e-5 * np.abs(g_j).max())
