"""Camera API tour: every construction path, motion op and projection of
the differentiable Camera (kaolin's camera tutorials -- camera_init,
camera_movement, camera_properties -- as one script).

Usage::

    python -m kaolin_tpu_torch.examples.camera_tour [--device cpu]
"""

import argparse
import math

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.render.camera import (Camera, CameraExtrinsics,
                                            CameraFOV, blender_coords)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--device', default=None,
                        help='where to run (default: the CUDA card)')
    args = parser.parse_args(argv)
    device = entry_device(args.device)

    def t(*x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    # -- construction: lookat + fov ------------------------------------
    cam = Camera.from_args(eye=t(4., 4., 4.), at=t(0., 0., 0.),
                           up=t(0., 1., 0.), fov=30 * math.pi / 180,
                           width=256, height=256)
    print('lookat camera:', len(cam), 'view matrix det',
          f'{float(torch.linalg.det(cam.view_matrix()[0, :3, :3])):.3f}')

    # -- construction: focal / view matrix / camera pose ---------------
    cam_focal = Camera.from_args(eye=t(0., 0., 3.), at=t(0., 0., 0.),
                                 up=t(0., 1., 0.), focal_x=500., width=256,
                                 height=256)
    print('focal camera fov_x:',
          f'{float(cam_focal.fov(CameraFOV.HORIZONTAL)[0]):.1f} deg')

    ext = CameraExtrinsics.from_view_matrix(cam.view_matrix())
    print('from_view_matrix round-trip close:',
          bool(torch.allclose(ext.view_matrix(), cam.view_matrix(),
                              atol=1e-5)))

    # -- orthographic ---------------------------------------------------
    ortho = Camera.from_args(eye=t(0., 0., 3.), at=t(0., 0., 0.),
                             up=t(0., 1., 0.), width=256, height=256,
                             fov_distance=2.0)
    print('ortho intrinsics:', type(ortho.intrinsics).__name__)

    # -- projection -----------------------------------------------------
    points = torch.as_tensor(np.random.default_rng(0).normal(
        size=(16, 3)).astype(np.float32), device=device)
    ndc = cam.transform(points)
    depth = cam.extrinsics.transform(points)[..., 2]
    print('projected', tuple(ndc.shape), 'mean depth',
          f'{float(depth.mean()):.3f}')

    # -- motion ---------------------------------------------------------
    before = cam.cam_pos().reshape(-1).cpu().numpy()
    cam.move_forward(0.5)
    cam.rotate(yaw=0.1, pitch=0.05, roll=0.)
    after = cam.cam_pos().reshape(-1).cpu().numpy()
    print('moved camera by', f'{np.linalg.norm(after - before):.3f}')

    # -- coordinate-system change (blender convention) ------------------
    cam_b = Camera.from_args(eye=t(4., 4., 4.), at=t(0., 0., 0.),
                             up=t(0., 1., 0.), fov=30 * math.pi / 180,
                             width=256, height=256)
    cam_b.extrinsics.change_coordinate_system(blender_coords(device=device))
    print('blender-coords view differs:', not bool(torch.allclose(
        cam_b.view_matrix(), cam.view_matrix())))

    # -- batched cameras + cat ------------------------------------------
    pair = Camera.cat([cam_focal, cam_focal])
    print('cat batch size:', len(pair))

    # -- differentiable pose (6-DoF backend) ----------------------------
    e0 = CameraExtrinsics.from_lookat(eye=t(0., 0., 3.), at=t(0., 0., 0.),
                                      up=t(0., 1., 0.),
                                      backend='matrix_6dof_rotation')
    params = e0.parameters().detach().clone().requires_grad_()
    e = CameraExtrinsics(params, backend_name='matrix_6dof_rotation')
    torch.sum(e.transform(points) ** 2).backward()
    g = params.grad
    print('pose gradient norm:', f'{float(torch.linalg.norm(g)):.3f}')
    print('done')
    return g


if __name__ == '__main__':
    main()
