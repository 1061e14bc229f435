"""DIB-R inverse rendering: fit vertices + texture + lighting to target
views (kaolin's dibr_tutorial workload, BASELINE configs #1/#2).

Usage::

    python -m kaolin_tpu_torch.examples.dibr_inverse_rendering \\
        --height 64 --steps 20 [--device cpu]

Without ``--mesh`` the mesh is a generated UV sphere (``uv_sphere(40,
21)``, 1,600 faces) written as OBJ + MTL into a temporary directory and
read back through the OBJ importer.
"""

import argparse
import tempfile
import time

import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.io import obj
from kaolin_tpu_torch.models import inverse_render as M
from kaolin_tpu_torch.utils.testing import uv_sphere, write_sphere_obj

DEFAULT_SPHERE = (40, 21)


def load_mesh(path, device):
    """``path`` through the OBJ importer; a generated sphere when None."""
    if path is not None:
        return obj.import_mesh(path, triangulate=True, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        return obj.import_mesh(write_sphere_obj(tmp, uv_sphere(
            *DEFAULT_SPHERE)), triangulate=True, device=device)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--mesh', default=None,
                        help='OBJ file (default: a generated UV sphere)')
    parser.add_argument('--height', type=int, default=64)
    parser.add_argument('--width', type=int, default=64)
    parser.add_argument('--num-views', type=int, default=4)
    parser.add_argument('--steps', type=int, default=20)
    parser.add_argument('--lr', type=float, default=5e-3)
    parser.add_argument('--backend', default='auto',
                        help="'fused' (the kernels), 'jnp' (brute force) "
                             "or 'auto' (= 'fused')")
    parser.add_argument('--logdir', default=None,
                        help='write Timelapse USD checkpoints here')
    parser.add_argument('--device', default=None,
                        help='where to run (default: the CUDA card)')
    args = parser.parse_args(argv)
    device = entry_device(args.device)

    mesh = load_mesh(args.mesh, device)
    faces = mesh.faces
    face_uvs = (mesh.uvs[mesh.face_uvs_idx] if mesh.uvs is not None
                else torch.zeros((faces.shape[0], 3, 2), device=device))
    views = M.make_views(args.num_views, device=device)

    # ground truth = the original mesh with a fixed texture
    gt_params = M.init_params(mesh, texture_res=64,
                              generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        target_images, target_masks, _ = M.render_views(
            gt_params, views, faces, face_uvs, args.height, args.width,
            backend=args.backend)

    # start from a perturbed mesh
    params = M.init_params(mesh, texture_res=64)
    noise = torch.randn(tuple(params.vertices.shape),
                        generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        params.vertices += 0.05 * noise.to(device)
    optimizer = torch.optim.Adam(params.parameters(), lr=args.lr)

    timelapse = None
    if args.logdir:
        from kaolin_tpu_torch.visualize import Timelapse
        timelapse = Timelapse(args.logdir)

    for step in range(args.steps):
        t0 = time.time()
        sel = M.compute_selection(params, views, faces, args.height,
                                  args.width, backend=args.backend)
        optimizer.zero_grad()
        loss = M.render_loss(params, views, faces, face_uvs, target_images,
                             target_masks, args.height, args.width,
                             backend=args.backend, selection=sel)
        loss.backward()
        optimizer.step()
        print(f'step {step:3d}  loss {loss.item():.5f}  '
              f'({time.time() - t0:.2f}s)')
        if timelapse is not None and step % 5 == 0:
            timelapse.add_mesh_batch(
                iteration=step, category='fitted',
                vertices_list=[params.vertices.detach()],
                faces_list=[faces])
    print('done')
    return params.vertices.detach()


if __name__ == '__main__':
    main()
