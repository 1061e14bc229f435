"""SPC pipeline demo: mesh -> octree -> ray trace -> volume integrate
(NGLOD-style; BASELINE config #3).

Usage::

    python -m kaolin_tpu_torch.examples.spc_raytrace_demo --level 6 \\
        --rays 10000 [--device cpu]

The octree is built on the device (``unbatched_mesh_to_spc_device``) and
the rays, an image of orthographic rays, go through the coherent trace
(``unbatched_raytrace_coherent(engine='mosaic')``: the trace kernel on the
card).  Without ``--mesh`` the mesh is a generated UV sphere written as OBJ
and read back.
"""

import argparse
import time

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.examples.dibr_inverse_rendering import load_mesh
from kaolin_tpu_torch.ops import spc as spc_ops
from kaolin_tpu_torch.ops.conversions import unbatched_mesh_to_spc_device
from kaolin_tpu_torch.render import spc as spc_render
from kaolin_tpu_torch.render.spc.raster import (hits_to_nuggets,
                                                unbatched_raytrace_coherent)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--mesh', default=None,
                        help='OBJ file (default: a generated UV sphere)')
    parser.add_argument('--level', type=int, default=6)
    parser.add_argument('--rays', type=int, default=10000)
    parser.add_argument('--device', default=None,
                        help='where to run (default: the CUDA card)')
    args = parser.parse_args(argv)
    device = entry_device(args.device)

    mesh = load_mesh(args.mesh, 'cpu')
    v = mesh.vertices.numpy()
    v = (v - (v.min(0) + v.max(0)) / 2.) / np.abs(v).max() * 0.9
    fv = torch.as_tensor(v[mesh.faces.numpy()], device=device)

    t0 = time.time()
    octree, points, _, _ = unbatched_mesh_to_spc_device(fv, args.level)
    print(f'mesh_to_spc level {args.level}: '
          f'{points.shape[0]} voxels '
          f'({time.time() - t0:.2f}s)')

    max_level, pyramids, exsum = spc_ops.scan_octrees(
        octree, [octree.shape[0]])
    ph = spc_ops.generate_points(octree, pyramids, exsum)

    # orthographic rays looking down -z, an n x n image
    n = int(np.sqrt(args.rays))
    lin = np.linspace(-0.95, 0.95, n, dtype=np.float32)
    gx, gy = np.meshgrid(lin, lin)
    origin = torch.as_tensor(
        np.stack([gx, gy, np.full_like(gx, 2.)], -1).reshape(-1, 3),
        device=device)
    direction = torch.tensor([0., 0., -1.], device=device).expand(
        origin.shape).contiguous()

    t0 = time.time()
    hits = unbatched_raytrace_coherent(
        octree, ph, pyramids[0], exsum, origin, direction, args.level,
        engine='mosaic', grid_shape=(n, n))
    ridx, pidx, depth = hits_to_nuggets(hits)
    nuggets = ridx.shape[0]
    dt = time.time() - t0
    print(f'raytrace: {nuggets} intersections for {origin.shape[0]} rays '
          f'({dt:.2f}s incl. compile)')

    # volume integration over the packs
    boundaries = spc_render.mark_pack_boundaries(ridx)
    tau = torch.full((nuggets, 1), 0.4, device=device)
    feats = ph[pidx.long()].float() / (2 ** args.level)
    integrated, transmittance = spc_render.exponential_integration(
        feats, tau, boundaries)
    print(f'integrated features for {integrated.shape[0]} hit rays; '
          f'mean transmittance {float(transmittance.mean()):.4f}')
    return integrated


if __name__ == '__main__':
    main()
