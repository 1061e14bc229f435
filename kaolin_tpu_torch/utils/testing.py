"""Test scaffolding shared by the tests and ``chip_smoke.py`` (numpy only).

The repository holds no mesh file, so the DIB-R step and the SPC pipeline
run on a procedural UV sphere whose output both packages can take.
"""

from typing import NamedTuple

import numpy as np

__all__ = ['UVSphere', 'uv_sphere', 'random_triangles', 'camera_grid',
           'EDGE_SCENES', 'dibr_edge_scene', 'punch_cell_rows']


def random_triangles(seed, F, B=2, spread=0.3):
    """Random small triangles for the fused-engine tests, numpy-seeded.

    Returns (face_vertices_z (B, F, 3) in [0.1, 2], face_vertices_image
    (B, F, 3, 2) in [-0.9, 0.9]), float32; ``spread`` shrinks each triangle
    towards its centroid.
    """
    rng = np.random.default_rng(seed)
    fvi = rng.uniform(-0.9, 0.9, (B, F, 3, 2)).astype(np.float32)
    cent = fvi.mean(axis=2, keepdims=True)
    fvi = (cent + (fvi - cent) * spread).astype(np.float32)
    fvz = rng.uniform(0.1, 2.0, (B, F, 3)).astype(np.float32)
    return fvz, fvi


EDGE_SCENES = ('ties', 'cluster', 'margin0', 'odd_100x72', 'odd_130x257',
               'empty')


def dibr_edge_scene(name, B=2):
    """Scenes that probe the fused DIB-R kernels' culling and tie rules.

    Returns (face_vertices_z (B, F, 3), face_vertices_image (B, F, 3, 2),
    height, width, boxlen), numpy float32 and numbers:

    - ``'ties'``: 150 random triangles, each twice: every covered pixel is
      a z tie, which the lower sorted id (the first copy) wins;
    - ``'cluster'``: 320 small triangles around one point of a 16 x 16
      pixel block, among 80 random ones, so that one block's face list
      holds more than 300 faces;
    - ``'margin0'``: random triangles with ``boxlen = 0``: the enlarged
      bbox is the triangle's own;
    - ``'odd_100x72'``, ``'odd_130x257'``: image sides that are not
      multiples of 16;
    - ``'empty'``: every triangle off screen.
    """
    rng = np.random.default_rng(EDGE_SCENES.index(name) + 11)
    height = width = 64
    boxlen = 0.02
    if name == 'ties':
        fvz, fvi = random_triangles(5, 150, B)
        fvz, fvi = np.concatenate([fvz] * 2, 1), np.concatenate([fvi] * 2, 1)
    elif name == 'cluster':
        fvz, fvi = random_triangles(6, 80, B)
        # pixel centre of column 24, row 40 at 64 x 64: inside the block
        # of columns 16-31, rows 32-47
        centre = np.array([-1. + 49. / 64., 1. - 81. / 64.], np.float32)
        small = centre + rng.uniform(-0.04, 0.04, (B, 320, 3, 2))
        fvi = np.concatenate([fvi, small.astype(np.float32)], 1)
        fvz = np.concatenate([fvz, rng.uniform(0.1, 2., (B, 320, 3))
                              .astype(np.float32)], 1)
    elif name == 'margin0':
        fvz, fvi = random_triangles(7, 200, B)
        boxlen = 0.
    elif name.startswith('odd_'):
        height, width = (int(v) for v in name[4:].split('x'))
        fvz, fvi = random_triangles(8, 200, B)
    elif name == 'empty':
        fvz, fvi = random_triangles(9, 100, B)
        fvi = fvi + np.float32(2.5)
    else:
        raise ValueError(f'unknown scene {name!r}; one of {EDGE_SCENES}')
    return fvz, fvi, height, width, boxlen


class UVSphere(NamedTuple):
    vertices: np.ndarray       # (V, 3) float32, unit radius
    faces: np.ndarray          # (F, 3) int64, counter-clockwise from outside
    uvs: np.ndarray            # (U, 2) float32 in [0, 1]
    face_uvs_idx: np.ndarray   # (F, 3) int64 rows of ``uvs``


def uv_sphere(n_lon, n_lat):
    """Unit UV sphere with ``2 * n_lon * (n_lat - 1)`` triangles.

    ``n_lon`` segments around the y axis, ``n_lat`` rings from pole to pole.
    Vertices are shared (one per pole); the uv grid has a seam column, so
    ``uvs`` has ``(n_lon + 1) * (n_lat + 1)`` rows with v = 1 at the north
    pole (OpenGL convention).  ``uv_sphere(100, 51)`` has 10,000 faces.
    """
    if n_lon < 3 or n_lat < 2:
        raise ValueError(f'need n_lon >= 3 and n_lat >= 2, got '
                         f'{n_lon}, {n_lat}')
    theta = np.pi * np.arange(1, n_lat) / n_lat            # ring latitudes
    phi = 2 * np.pi * np.arange(n_lon) / n_lon
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.sin(phi),
                     np.broadcast_to(ct, (n_lat - 1, n_lon)),
                     st * np.cos(phi)], axis=-1).reshape(-1, 3)
    vertices = np.concatenate([[[0., 1., 0.]], ring, [[0., -1., 0.]]])
    north, south = 0, len(vertices) - 1

    def vid(r, k):                                         # ring r, column k
        return 1 + r * n_lon + k % n_lon

    def uid(r, k):                                         # uv row r, column k
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
    uvs = np.stack([u, v], axis=-1).reshape(-1, 2)
    return UVSphere(vertices.astype(np.float32), np.asarray(faces, np.int64),
                    uvs.astype(np.float32), np.asarray(fuv, np.int64))


def camera_grid(side, z=-2.5, spread=0.1, extent=0.9):
    """A ``side`` x ``side`` grid of camera rays (row-major, y slowest):
    origins on [-extent, extent]^2 at depth ``z``, unit directions
    ``(spread * x, spread * y, 1)``.  Returns float32 (origin, direction),
    each (side^2, 3)."""
    ys, xs = np.meshgrid(np.linspace(-extent, extent, side),
                         np.linspace(-extent, extent, side), indexing='ij')
    o = np.stack([xs.ravel(), ys.ravel(), np.full(side * side, z)], -1)
    d = np.stack([xs.ravel() * spread, ys.ravel() * spread,
                  np.ones(side * side)], -1)
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def punch_cell_rows(rows, seed, share=0.25):
    """A copy of cell-table rows (R, 4, cw) int32 with voxels taken out and
    put in, for the trace kernel's tests.  In every third row a random
    ``share`` of the slots loses its voxel (leaf index -1, holes anywhere in
    the row; the coordinates stay in place); every seventh row loses all of
    them; in every fifth row that holds a voxel each free slot gets a copy
    of the row's first voxel under a leaf index of its own (R * cw + its
    place), so the row is full and a ray that hits the voxel hits it again
    at an equal depth.  The other rows stay as they are."""
    rng = np.random.default_rng(seed)
    rows = np.array(rows, copy=True)
    R, _, cw = rows.shape
    idx = np.arange(R)
    fill = (idx % 5 == 2)[:, None] & (rows[:, 3, :1] >= 0) & (rows[:, 3] < 0)
    filled = np.where(fill[:, None], rows[:, :, :1], rows)
    filled[:, 3] = np.where(fill, R * cw + np.arange(R * cw).reshape(R, cw),
                            rows[:, 3])
    holes = (rng.random((R, cw)) < share) & (idx % 3 == 1)[:, None]
    holes |= (idx % 7 == 3)[:, None]
    filled[:, 3][holes] = -1
    return filled
