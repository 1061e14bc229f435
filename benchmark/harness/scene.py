"""The scenes the cells are made of, from the cell's parameters and the
seed; both the program and the reference are handed what these make.

The repository holds no mesh file, so every cell runs on a procedural UV
sphere (a stand-in for the published ``fox.obj``).  The arithmetic is
that of ``kaolin_tpu_torch/utils/testing.py::uv_sphere`` and
``camera_grid``, ``models/inverse_render.py::make_views`` and
``init_params``' normalisation, copied so that no later change of the
program changes the inputs.
"""

import math

import numpy as np
import torch

__all__ = ['uv_sphere', 'normalized', 'turntable_views', 'camera_grid',
           'block_order', 'turn_y', 'schedule', 'generator']


def uv_sphere(n_lon, n_lat):
    """Unit UV sphere with ``2 * n_lon * (n_lat - 1)`` triangles: (vertices
    (V, 3) float32, faces (F, 3) int64, face_uvs (F, 3, 2) float32), numpy.
    ``n_lon`` segments around the y axis, ``n_lat`` rings from pole to
    pole, a seam column in the uv grid, v = 1 at the north pole."""
    theta = np.pi * np.arange(1, n_lat) / n_lat
    phi = 2 * np.pi * np.arange(n_lon) / n_lon
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.sin(phi),
                     np.broadcast_to(ct, (n_lat - 1, n_lon)),
                     st * np.cos(phi)], axis=-1).reshape(-1, 3)
    vertices = np.concatenate([[[0., 1., 0.]], ring, [[0., -1., 0.]]])
    north, south = 0, len(vertices) - 1

    def vid(r, k):
        return 1 + r * n_lon + k % n_lon

    def uid(r, k):
        return r * (n_lon + 1) + k

    faces, fuv = [], []
    for k in range(n_lon):
        faces.append([north, vid(0, k), vid(0, k + 1)])
        fuv.append([uid(0, k), uid(1, k), uid(1, k + 1)])
        for r in range(n_lat - 2):
            a, b = vid(r, k), vid(r, k + 1)
            c, d = vid(r + 1, k), vid(r + 1, k + 1)
            ua, ub = uid(r + 1, k), uid(r + 1, k + 1)
            uc, ud = uid(r + 2, k), uid(r + 2, k + 1)
            faces += [[a, c, d], [a, d, b]]
            fuv += [[ua, uc, ud], [ua, ud, ub]]
        faces.append([vid(n_lat - 2, k), south, vid(n_lat - 2, k + 1)])
        fuv.append([uid(n_lat - 1, k), uid(n_lat, k), uid(n_lat - 1, k + 1)])
    u, v = np.meshgrid(np.arange(n_lon + 1) / n_lon,
                       1. - np.arange(n_lat + 1) / n_lat)
    uvs = np.stack([u, v], axis=-1).reshape(-1, 2).astype(np.float32)
    faces = np.asarray(faces, np.int64)
    return (vertices.astype(np.float32), faces,
            uvs[np.asarray(fuv, np.int64)])


def normalized(vertices):
    """Vertices centred on their bbox and scaled into [-0.5, 0.5]^3."""
    vmin = vertices.amin(dim=0, keepdim=True)
    vmax = vertices.amax(dim=0, keepdim=True)
    return (vertices - (vmin + vmax) / 2.) / (vmax - vmin).max()


def turntable_views(num_views, distance, fovy, elevation, device):
    """(rot (B, 3, 3), trans (B, 3), proj (3, 1)) float32 of a turntable of
    cameras looking at the origin: ``P_cam = R @ (P - T)``, image =
    ``(x, y) * proj[:2] / -z``."""
    azimuth = np.linspace(0, 2 * np.pi, num_views, endpoint=False)
    eye = np.stack([np.sin(azimuth) * np.cos(elevation),
                    np.full_like(azimuth, np.sin(elevation)),
                    np.cos(azimuth) * np.cos(elevation)], axis=-1) * distance
    eye = torch.as_tensor(eye, dtype=torch.float32, device=device)
    up = torch.tensor([0., 1., 0.], device=device).expand(num_views, 3)
    camz = -eye
    camz = camz / (torch.linalg.norm(camz, dim=1, keepdim=True) + 1e-10)
    camx = torch.linalg.cross(camz, up, dim=1)
    camx = camx / (torch.linalg.norm(camx, dim=1, keepdim=True) + 1e-10)
    camy = torch.linalg.cross(camx, camz, dim=1)
    camy = camy / (torch.linalg.norm(camy, dim=1, keepdim=True) + 1e-10)
    rot = torch.stack([camx, camy, -camz], dim=1)
    tanfov = math.tan(fovy / 2.)
    proj = torch.tensor([[1. / tanfov], [1. / tanfov], [-1.]],
                        dtype=torch.float32, device=device)
    return rot, eye, proj


def camera_grid(side, z=-2.5, spread=0.1, extent=0.9):
    """A ``side`` x ``side`` grid of rays (row-major, y slowest): origins on
    [-extent, extent]^2 at depth ``z``, unit directions ``(spread * x,
    spread * y, 1)``; float64 numpy (origin, direction)."""
    ys, xs = np.meshgrid(np.linspace(-extent, extent, side),
                         np.linspace(-extent, extent, side), indexing='ij')
    o = np.stack([xs.ravel(), ys.ravel(), np.full(side * side, z)], -1)
    d = np.stack([xs.ravel() * spread, ys.ravel() * spread,
                  np.ones(side * side)], -1)
    return o, d / np.linalg.norm(d, axis=-1, keepdims=True)


def block_order(height, width, bh, bw):
    """Row-major pixel ids grouped into (bh, bw) blocks, blocks row-major."""
    idx = np.arange(height * width).reshape(height, width)
    blocks = idx.reshape(height // bh, bh, width // bw, bw).transpose(
        0, 2, 1, 3)
    return blocks.reshape(-1)


def turn_y(points, angle):
    """``points`` (N, 3) float64 turned by ``angle`` about the y axis."""
    c, s = math.cos(angle), math.sin(angle)
    rot = np.array([[c, 0., s], [0., 1., 0.], [-s, 0., c]])
    return points @ rot.T


def generator(seed, device):
    """A generator on ``device`` seeded with ``seed`` (any whole number,
    taken modulo 2**64: seeds need not fit in 32 bits)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 64))


def schedule(seed, pool, per_unit, rounds):
    """The order in which a cell visits its pool: ``rounds`` permutations of
    ``range(pool)``, drawn from ``seed`` on the CPU, cut into units of
    ``per_unit`` (``pool`` a multiple of it).  Every seed visits the same
    pool the same number of times, in another order.  Returns
    (rounds * pool // per_unit, per_unit) int64."""
    g = generator(seed, 'cpu')
    perms = torch.stack([torch.randperm(pool, generator=g)
                         for _ in range(rounds)])
    return perms.reshape(-1, per_unit)
