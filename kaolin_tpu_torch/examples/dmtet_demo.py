"""DMTet-style demo: optimize an SDF on a tet grid so marching tetrahedra
reconstructs a target sphere (BASELINE config #4 neighborhood: tet losses +
differentiable iso-surface).

Usage::

    python -m kaolin_tpu_torch.examples.dmtet_demo --res 8 --steps 30 \\
        [--device cpu]
"""

import argparse

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.metrics.pointcloud import chamfer_distance
from kaolin_tpu_torch.ops.conversions import marching_tetrahedra


def tet_grid(res):
    """Regular tetrahedral grid covering [-0.5, 0.5]^3."""
    lin = np.linspace(-0.5, 0.5, res + 1, dtype=np.float32)
    pts = np.stack(np.meshgrid(lin, lin, lin, indexing='ij'),
                   axis=-1).reshape(-1, 3)

    def vid(x, y, z):
        return (x * (res + 1) + y) * (res + 1) + z

    cube_tets = np.array([
        [0, 1, 3, 7], [0, 3, 2, 7], [0, 2, 6, 7],
        [0, 6, 4, 7], [0, 4, 5, 7], [0, 5, 1, 7]])
    corners = np.array([[(j >> 2) & 1, (j >> 1) & 1, j & 1]
                        for j in range(8)])
    tets = []
    for x in range(res):
        for y in range(res):
            for z in range(res):
                ids = [vid(x + c[0], y + c[1], z + c[2]) for c in corners]
                for t in cube_tets:
                    tets.append([ids[i] for i in t])
    return pts, np.asarray(tets)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--res', type=int, default=5)
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--lr', type=float, default=1e-2)
    parser.add_argument('--device', default=None,
                        help='where to run (default: the CUDA card)')
    args = parser.parse_args(argv)
    device = entry_device(args.device)

    pts_np, tets = tet_grid(args.res)
    vertices = torch.as_tensor(pts_np, device=device)[None]
    tets = torch.as_tensor(tets, device=device)

    # target: points on a sphere of radius 0.35
    rng = np.random.default_rng(0)
    d = rng.normal(size=(2048, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    target = torch.as_tensor((d * 0.35).astype(np.float32),
                             device=device)[None]

    sdf = torch.as_tensor((np.linalg.norm(pts_np, axis=1) - 0.25)
                          .astype(np.float32), device=device)[None]
    sdf.requires_grad_()                                   # wrong radius
    optimizer = torch.optim.Adam([sdf], lr=args.lr)

    for step in range(args.steps):
        optimizer.zero_grad()
        verts, _ = marching_tetrahedra(vertices, tets, sdf)
        if verts[0].shape[0] == 0:
            # no surface: a constant loss, a zero gradient (Adam still
            # counts the step)
            loss = torch.tensor(1.0)
            sdf.grad = torch.zeros_like(sdf)
        else:
            loss = chamfer_distance(verts[0][None], target)[0]
            loss.backward()
        optimizer.step()
        if step % 5 == 0 or step == args.steps - 1:
            print(f'step {step:3d}  chamfer {loss.item():.6f}')
    print('done')
    return sdf.detach()


if __name__ == '__main__':
    main()
