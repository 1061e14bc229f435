"""Spherical-gaussian lighting demo: render a textured mesh through the
full pipeline (Camera.from_args -> rasterize -> texture_mapping -> SG
diffuse), then recover the light amplitudes from the image by gradient
descent (the DIB-R++ use case).

Usage::

    python -m kaolin_tpu_torch.examples.sg_lighting_demo --size 64 \\
        --steps 10 [--device cpu]

``--mesh`` takes an OBJ with uvs; its normals and its first material's
``map_Kd`` are used where it has them.  Without ``--mesh`` the mesh is a
generated UV sphere written as OBJ + MTL and read back: its normals are
the vertex normals of its faces, its texture a checker of the material's
``Kd``.
"""

import argparse
import math
import tempfile

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.io import obj
from kaolin_tpu_torch.ops.coords import spherical2cartesian
from kaolin_tpu_torch.ops.mesh import (compute_vertex_normals, face_normals,
                                       index_vertices_by_faces)
from kaolin_tpu_torch.render.camera import Camera
from kaolin_tpu_torch.render.lighting import sg_diffuse_inner_product
from kaolin_tpu_torch.render.mesh import rasterize, texture_mapping
from kaolin_tpu_torch.utils.testing import uv_sphere, write_sphere_obj

DEFAULT_SPHERE = (40, 21)
CHECKER = 8         # texels per checker square of the default texture


def _load(path, device):
    kw = dict(with_materials=True, with_normals=True, device=device)
    if path is not None:
        return obj.import_mesh(path, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        return obj.import_mesh(write_sphere_obj(tmp, uv_sphere(
            *DEFAULT_SPHERE)), **kw)


def _texture(material, device):
    """(1, 3, H, W) in [0, 1]: the material's map_Kd, else a 64^2 checker
    of its Kd and white."""
    if 'map_Kd' in material:
        tex = torch.as_tensor(np.asarray(material['map_Kd']),
                              dtype=torch.float32, device=device)
        return tex.permute(2, 0, 1)[None] / 255.
    kd = np.asarray(material.get('Kd', (0.8, 0.8, 0.8)), np.float32)
    ij = np.indices((64, 64)) // CHECKER
    check = ((ij[0] + ij[1]) % 2 == 0)[..., None]
    tex = np.where(check, kd, np.float32(1.)).astype(np.float32)
    return torch.as_tensor(tex, device=device).permute(2, 0, 1)[None]


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--mesh', default=None,
                        help='OBJ file (default: a generated UV sphere)')
    parser.add_argument('--size', type=int, default=64)
    parser.add_argument('--steps', type=int, default=10)
    parser.add_argument('--lr', type=float, default=5e-2)
    parser.add_argument('--device', default=None,
                        help='where to run (default: the CUDA card)')
    args = parser.parse_args(argv)
    device = entry_device(args.device)

    mesh = _load(args.mesh, device)
    vertices = mesh.vertices[None]
    v_max = vertices.amax(dim=1, keepdim=True)
    v_min = vertices.amin(dim=1, keepdim=True)
    vertices = (vertices - v_min) / (v_max - v_min) - 0.5
    faces = mesh.faces
    if mesh.normals is not None:
        normals = mesh.normals[None]
        normals_idx = mesh.face_normals_idx
    else:
        fn = face_normals(index_vertices_by_faces(vertices, faces),
                          unit=True)
        normals = compute_vertex_normals(
            faces, fn[:, :, None].expand(-1, -1, 3, -1),
            num_vertices=vertices.shape[1])
        normals_idx = faces
    face_nrm = index_vertices_by_faces(normals, normals_idx)
    uvs = mesh.uvs[None]
    face_uvs = index_vertices_by_faces(uvs, mesh.face_uvs_idx)
    texture = _texture(mesh.materials[0], device)

    def t(*x):
        return torch.tensor(x, dtype=torch.float32, device=device)

    cam = Camera.from_args(eye=t(0., -0.6, 0.8), at=t(0., 0., 0.),
                           up=t(0., 1., 0.), fov=70. * 2. * math.pi / 360,
                           width=args.size, height=args.size)
    vc = cam.extrinsics.transform(vertices)
    vn = cam.intrinsics.transform(vc)
    fvc = index_vertices_by_faces(vc, faces)
    fvi = index_vertices_by_faces(vn[..., :2], faces)

    (uv_map, nrm_map), face_idx = rasterize(
        args.size, args.size, fvc[..., -1], fvi, [face_uvs, face_nrm])
    mask = face_idx != -1
    nrm = nrm_map / torch.clamp(
        torch.linalg.norm(nrm_map, dim=-1, keepdim=True), min=1e-12)
    albedo = texture_mapping(uv_map, texture, mode='nearest')
    albedo = torch.clamp(albedo * mask[..., None], 0., 1.)

    def shade(amplitude, direction, sharpness):
        eff = sg_diffuse_inner_product(
            amplitude, direction, sharpness, nrm.reshape(-1, 3),
            albedo.reshape(-1, 3)).reshape(albedo.shape)
        return torch.where(mask[..., None], eff, 0.)

    # ground-truth lighting -> target image
    gt_dirs = torch.stack(spherical2cartesian(
        t(0., math.pi / 2.), t(0., 0.)), dim=-1)
    gt_amp = torch.tensor([[5., 2., 2.], [5., 10., 5.]], device=device)
    gt_sharp = t(6., 20.)
    with torch.no_grad():
        target = shade(gt_amp, gt_dirs, gt_sharp)
    print(f'target image mean {float(target.mean()):.4f}')

    # recover amplitudes from the image (directions/sharpness known)
    params = torch.ones_like(gt_amp).requires_grad_()
    opt = torch.optim.Adam([params], lr=args.lr)
    for i in range(args.steps):
        opt.zero_grad()
        loss = torch.mean((shade(params, gt_dirs, gt_sharp) - target) ** 2)
        loss.backward()
        opt.step()
        if i % max(1, args.steps // 5) == 0:
            print(f'step {i}: loss {loss.item():.6f}')
    err = float((params.detach() - gt_amp).abs().mean())
    print(f'final amplitude error {err:.4f}')
    print('done')
    return params.detach()


if __name__ == '__main__':
    main()
