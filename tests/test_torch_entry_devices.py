"""The port's entry points run on the card unless the caller asks.

With no ``device`` and numpy inputs each entry point returns CUDA tensors
when a card is available and raises otherwise (no silent CPU path);
``device='cpu'`` runs on the CPU; tensor inputs keep their device.  Whether
there is a card is decided inside each test.
"""
import tempfile

import numpy as np
import pytest
import torch

from kaolin_tpu_torch.io.obj import import_mesh
from kaolin_tpu_torch.models import inverse_render as M
from kaolin_tpu_torch.ops.conversions.tetmesh import marching_tetrahedra
from kaolin_tpu_torch.ops.mesh.tetmesh import subdivide_tetmesh
from kaolin_tpu_torch.ops.conversions.trianglemesh import (
    unbatched_mesh_to_spc_device)
from kaolin_tpu_torch.ops.spc import (generate_points, morton_to_points,
                                      points_to_morton, scan_octrees,
                                      unbatched_points_to_octree)
from kaolin_tpu_torch.ops.conversions import (pointclouds_to_voxelgrids,
                                              trianglemeshes_to_voxelgrids,
                                              unbatched_pointcloud_to_spc)
from kaolin_tpu_torch.ops.spc import (Conv3d, ConvTranspose3d,
                                      create_dense_spc, feature_grids_to_spc,
                                      from_jax_params, points_to_corners,
                                      unbatched_make_dual,
                                      unbatched_make_trinkets,
                                      unbatched_query)
from kaolin_tpu_torch.render.camera import (Camera, CameraExtrinsics,
                                            OrthographicIntrinsics,
                                            PinholeIntrinsics,
                                            blender_coords,
                                            generate_perspective_projection,
                                            opengl_coords)
from kaolin_tpu_torch.render.mesh.rasterization import pixel_coords
from kaolin_tpu_torch.render.spc import (generate_primary_rays,
                                         generate_shadow_rays,
                                         unbatched_raytrace)
from kaolin_tpu_torch.render.spc.raster import unbatched_raytrace_coherent
from kaolin_tpu_torch.rep import Spc
from kaolin_tpu_torch.utils.testing import (camera_grid, tet_grid,
                                            uv_sphere, write_sphere_obj)
from kaolin_tpu_torch.ops import gcn, random as rnd, voxelgrid
from kaolin_tpu_torch.ops.conversions import voxelgrid as vg_conv
from kaolin_tpu_torch.ops.mesh import (adjacency_matrix, sample_points,
                                       uniform_laplacian)
from kaolin_tpu_torch.io import off, usd
from kaolin_tpu_torch.io import obj as obj_io
from kaolin_tpu_torch.ops.conversions import sdf_to_voxelgrids
from kaolin_tpu_torch.ops.mesh.check_sign import check_sign
from kaolin_tpu_torch.utils import checkpoint, profiler
from kaolin_tpu_torch.io import dataset, modelnet, shapenet, shrec
from kaolin_tpu_torch.io.render import import_synthetic_view
from kaolin_tpu_torch.utils.testing import (write_modelnet, write_shapenet_v2,
                                            write_shrec16, write_synthetic_view)
from kaolin_tpu_torch.parallel import make_mesh
from kaolin_tpu_torch.parallel.distributed import make_global_mesh

LEVEL = 3


def _on_mesh(mesh):
    return mesh.broadcast(torch.ones(1, device=mesh.device))


class _Mesh:
    vertices = uv_sphere(8, 5).vertices


def _spc_numpy():
    """A small octree and rays, all numpy."""
    s = uv_sphere(8, 5)
    fv = (s.vertices * 0.5)[s.faces]
    octree = unbatched_mesh_to_spc_device(fv, LEVEL, device='cpu')[0]
    _, pyr, exsum = scan_octrees(octree, [octree.shape[0]])
    ph = generate_points(octree, pyr, exsum)
    o, d = camera_grid(8)
    return (octree.numpy(), ph.numpy(), pyr[0].numpy(), exsum.numpy(), o,
            d, fv)


def _coherent(device=None):
    octree, ph, pyr, exsum, o, d, _ = _spc_numpy()
    return unbatched_raytrace_coherent(octree, ph, pyr, exsum, o, d, LEVEL,
                                       engine='mosaic', knum=16,
                                       device=device).t_near


def _bfs(device=None):
    octree, ph, pyr, exsum, o, d, _ = _spc_numpy()
    return unbatched_raytrace(octree, ph, pyr, exsum, o, d, LEVEL,
                              device=device)[0]


def _import_mesh(device=None):
    with tempfile.TemporaryDirectory() as tmp:
        path = write_sphere_obj(tmp, uv_sphere(8, 5))
        return import_mesh(path, with_materials=True,
                           device=device).face_uvs


def _usd(write, read):
    """``write(path)`` a .usda file, then ``read(path)`` it back."""
    with tempfile.TemporaryDirectory() as tmp:
        path = f'{tmp}/x.usda'
        write(path)
        return read(path)


def _off(device=None):
    with tempfile.TemporaryDirectory() as tmp:
        with open(f'{tmp}/x.off', 'w') as f:
            f.write('OFF\n3 1 0\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n')
        return off.import_mesh(f'{tmp}/x.off', device=device).vertices


def _obj_native(device=None):
    with tempfile.TemporaryDirectory() as tmp:
        path = write_sphere_obj(tmp, uv_sphere(8, 5))
        return obj_io.import_mesh(path, device=device).vertices


def _npz(device=None):
    with tempfile.TemporaryDirectory() as tmp:
        path = checkpoint.save_npz(f'{tmp}/x.npz', {'a': torch.ones(2)})
        return checkpoint.load_npz(path, device=device)['a']


def _tets(device=None):
    v, t = tet_grid(2)
    return v[None], t, np.linalg.norm(v, axis=-1)[None] - 0.5


def _dual(device=None):
    _, ph, pyr, _, _, _, _ = _spc_numpy()
    return unbatched_make_dual(ph, pyr, device=device)


def _trinkets(device=None):
    _, ph, pyr, _, _, _, _ = _spc_numpy()
    dual, pyr_dual = unbatched_make_dual(ph, pyr, device='cpu')
    return unbatched_make_trinkets(ph, pyr, dual.numpy(), pyr_dual,
                                   device=device)[0]


def _query(device=None):
    octree, ph, _, exsum, _, _, _ = _spc_numpy()
    return unbatched_query(octree, exsum, ph[-5:], LEVEL, device=device)


def _tree(write, cls, device, **kw):
    """A one-model tree written by ``write``, loaded by ``cls``: the
    first item's vertices."""
    with tempfile.TemporaryDirectory() as tmp:
        write(tmp, ['02691156'], 1, (8, 5))
        return cls(tmp, device=device, **kw)[0]['mesh'].vertices


def _cached(device=None):
    with tempfile.TemporaryDirectory() as tmp:
        cache = dataset.CachedDataset([{'a': np.ones(3, np.float32)}], tmp,
                                      save_on_disk=True, device=device)
        return cache[0]['a']


def _synthetic_view(device=None):
    with tempfile.TemporaryDirectory() as tmp:
        write_synthetic_view(tmp, 0, np.eye(3), np.zeros(3), 0.8, (4, 4),
                             semantic=np.ones((4, 4), np.int32))
        return import_synthetic_view(tmp, 0, rgb=False, semantic=True,
                                     device=device)['semantic']


def _example(name, argv):
    def run(device=None):
        from importlib import import_module
        mod = import_module(f'kaolin_tpu_torch.examples.{name}')
        extra = [] if device is None else ['--device', str(device)]
        return mod.main(argv + extra)
    return run


_LOOKAT = dict(eye=np.array([0., 1., 3.]), at=np.zeros(3),
               up=np.array([0., 1., 0.]))
_GRID = np.zeros((1, 2, 4, 4, 4), np.float32)
_GRID[0, :, 1, 2, 3] = 1.


ENTRY = {
    'import_mesh': _import_mesh,
    'marching_tetrahedra': lambda device=None: marching_tetrahedra(
        *_tets(), device=device)[0][0],
    'subdivide_tetmesh': lambda device=None: subdivide_tetmesh(
        *_tets()[:2], device=device)[1],
    'init_params': lambda device=None: M.init_params(
        _Mesh, texture_res=4, device=device).vertices,
    'from_jax_params': lambda device=None: M.from_jax_params(
        np.zeros((3, 3)), np.zeros((3, 2, 2)), np.zeros(9),
        device=device).texture_map,
    'make_views': lambda device=None: M.make_views(
        2, device=device).camera_rot,
    'unbatched_mesh_to_spc_device': lambda device=None:
        unbatched_mesh_to_spc_device(_spc_numpy()[-1], LEVEL,
                                     device=device)[0],
    'unbatched_raytrace_coherent': _coherent,
    'unbatched_raytrace': _bfs,
    'generate_primary_rays': lambda device=None: generate_primary_rays(
        4, 4, np.eye(4), device=device)[1],
    'generate_shadow_rays': lambda device=None: generate_shadow_rays(
        np.zeros((2, 3)), np.array([[0., 0., 1.], [0., 1., 1.]]),
        np.array([0., 2., 2.]), np.array([0., 0., 1., -1.]),
        device=device)[1],
    'generate_perspective_projection': lambda device=None:
        generate_perspective_projection(0.8, device=device),
    'pixel_coords': lambda device=None: pixel_coords(4, 4, 1000.,
                                                     device=device)[0],
    'points_to_morton': lambda device=None: points_to_morton(
        np.array([[1, 2, 3]]), device=device),
    'morton_to_points': lambda device=None: morton_to_points(
        np.array([53]), device=device),
    'unbatched_points_to_octree': lambda device=None:
        unbatched_points_to_octree(np.array([[1, 2, 3]]), 2, device=device),
    'Spc': lambda device=None: Spc(np.array([1, 1], np.uint8), [2],
                                   device=device).octrees,
    'Spc.from_list': lambda device=None: Spc.from_list(
        [np.array([1, 1], np.uint8)], device=device).octrees,
    'Spc.make_dense': lambda device=None: Spc.make_dense(
        2, device=device).octrees,
    'Spc.from_features': lambda device=None: Spc.from_features(
        _GRID, device=device).features,
    'points_to_corners': lambda device=None: points_to_corners(
        np.array([[1, 2, 3]]), device=device),
    'create_dense_spc': lambda device=None: create_dense_spc(
        2, device=device)[0],
    'unbatched_query': _query,
    'feature_grids_to_spc': lambda device=None: feature_grids_to_spc(
        _GRID, device=device)[0],
    'unbatched_make_dual': lambda device=None: _dual(device)[0],
    'unbatched_make_trinkets': _trinkets,
    'Conv3d': lambda device=None: Conv3d(2, 3, np.zeros((1, 3)),
                                         device=device).weight,
    'ConvTranspose3d': lambda device=None: ConvTranspose3d(
        2, 3, np.zeros((1, 3)), device=device).weight,
    'from_jax_params': lambda device=None: from_jax_params(
        {'weight': np.ones((1, 2, 3))}, device=device)['weight'],
    'pointclouds_to_voxelgrids': lambda device=None:
        pointclouds_to_voxelgrids(np.random.default_rng(0).random(
            (1, 10, 3)), 4, device=device),
    'unbatched_pointcloud_to_spc': lambda device=None:
        unbatched_pointcloud_to_spc(np.zeros((2, 3)), 2,
                                    device=device).octrees,
    'trianglemeshes_to_voxelgrids': lambda device=None:
        trianglemeshes_to_voxelgrids(_Mesh.vertices[None], uv_sphere(8, 5)
                                     .faces, 4, device=device),
    'blender_coords': lambda device=None: blender_coords(device=device),
    'opengl_coords': lambda device=None: opengl_coords(device=device),
    'CameraExtrinsics.from_lookat': lambda device=None:
        CameraExtrinsics.from_lookat(**_LOOKAT, device=device).params,
    'CameraExtrinsics.from_camera_pose': lambda device=None:
        CameraExtrinsics.from_camera_pose(np.zeros(3), np.eye(3),
                                          device=device).params,
    'CameraExtrinsics.from_view_matrix': lambda device=None:
        CameraExtrinsics.from_view_matrix(np.eye(4), device=device).params,
    'PinholeIntrinsics.from_fov': lambda device=None:
        PinholeIntrinsics.from_fov(4, 4, 0.8, device=device).params,
    'PinholeIntrinsics.from_focal': lambda device=None:
        PinholeIntrinsics.from_focal(4, 4, 3., device=device).params,
    'OrthographicIntrinsics.from_frustum': lambda device=None:
        OrthographicIntrinsics.from_frustum(4, 4, device=device).params,
    'Camera.from_args': lambda device=None: Camera.from_args(
        **_LOOKAT, fov=0.8, width=4, height=4,
        device=device).generate_rays()[1],
    # slice 8
    'random_tensor': lambda device=None: rnd.random_tensor(
        0., 1., (3,), device=device),
    'random_spc_octrees': lambda device=None: rnd.random_spc_octrees(
        1, 2, device=device)[0],
    'sample_spherical_coords': lambda device=None:
        rnd.sample_spherical_coords((3,), device=device)[0],
    'sample_points': lambda device=None: sample_points(
        _Mesh.vertices[None], uv_sphere(8, 5).faces, 10,
        generator=torch.Generator().manual_seed(0), device=device)[0],
    'adjacency_matrix': lambda device=None: adjacency_matrix(
        4, np.array([[0, 1, 2], [1, 3, 2]]), device=device),
    'uniform_laplacian': lambda device=None: uniform_laplacian(
        4, np.array([[0, 1, 2], [1, 3, 2]]), device=device),
    'fill': lambda device=None: voxelgrid.fill(_GRID[:, 0], device=device),
    'voxelgrids_to_cubic_meshes': lambda device=None:
        vg_conv.voxelgrids_to_cubic_meshes(_GRID[:, 0], device=device)[0][0],
    'voxelgrids_to_trianglemeshes': lambda device=None:
        vg_conv.voxelgrids_to_trianglemeshes(_GRID[:, 0],
                                             device=device)[0][0],
    'voxelgrids_to_trianglemeshes_mt': lambda device=None:
        vg_conv.voxelgrids_to_trianglemeshes_mt(_GRID[:, 0],
                                                device=device)[0][0],
    'GraphConv': lambda device=None: gcn.GraphConv(
        2, 3, device=device).linear.weight,
    'gcn.from_jax_params': lambda device=None: gcn.from_jax_params(
        {'linear': {'kernel': np.ones((2, 3))}},
        device=device)['linear.weight'],
    # slice 9
    'import_mesh (native)': _obj_native,
    'off.import_mesh': _off,
    'usd.import_mesh': lambda device=None: _usd(
        lambda p: usd.export_mesh(p, vertices=np.eye(3), faces=[[0, 1, 2]]),
        lambda p: usd.import_mesh(p, device=device).vertices),
    'usd.import_pointcloud': lambda device=None: _usd(
        lambda p: usd.export_pointcloud(p, np.eye(3)),
        lambda p: usd.import_pointcloud(
            p, '/World/PointClouds/pointcloud_0', device=device).points),
    'usd.import_voxelgrid': lambda device=None: _usd(
        lambda p: usd.export_voxelgrid(p, _GRID[0, 0]),
        lambda p: usd.import_voxelgrid(
            p, '/World/VoxelGrids/voxelgrid_0', device=device)),
    'sdf_to_voxelgrids': lambda device=None: sdf_to_voxelgrids(
        [lambda x: x.norm(dim=-1) - 0.3], init_res=4, device=device),
    'check_sign(use_hash=True)': lambda device=None: check_sign(
        _Mesh.vertices[None], uv_sphere(8, 5).faces,
        np.zeros((1, 4, 3), np.float32), use_hash=True, device=device),
    'load_npz': _npz,
    # slice 10
    'import_synthetic_view': _synthetic_view,
    'ShapeNetV2': lambda device=None: _tree(write_shapenet_v2,
                                            shapenet.ShapeNetV2, device,
                                            split=1.),
    'ModelNet': lambda device=None: _tree(
        lambda root, cats, n, sphere: write_modelnet(root, ['chair'], n,
                                                     sphere),
        modelnet.ModelNet, device),
    'SHREC16': lambda device=None: _tree(write_shrec16, shrec.SHREC16,
                                         device),
    'CachedDataset': _cached,
    'examples.camera_tour': _example('camera_tour', []),
    'examples.dibr_inverse_rendering': _example(
        'dibr_inverse_rendering', ['--height', '16', '--width', '16',
                                   '--num-views', '1', '--steps', '1']),
    'examples.dmtet_demo': _example('dmtet_demo', ['--res', '3', '--steps',
                                                   '1']),
    'examples.spc_raytrace_demo': _example('spc_raytrace_demo',
                                           ['--level', '3', '--rays', '64']),
    'examples.sg_lighting_demo': _example('sg_lighting_demo',
                                          ['--size', '16', '--steps', '1']),
    # slice 13: a mesh's device, through its (identity) broadcast
    'make_mesh': lambda device=None: _on_mesh(make_mesh(device=device)),
    'make_global_mesh': lambda device=None: _on_mesh(
        make_global_mesh(device=device)),
}


@pytest.mark.parametrize('name', list(ENTRY))
def test_default_device_is_the_card(name):
    if torch.cuda.is_available():
        assert ENTRY[name]().device.type == 'cuda'
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ENTRY[name]()


@pytest.mark.parametrize('name', list(ENTRY))
def test_cpu_on_request(name):
    out = ENTRY[name](device='cpu')
    assert out.device.type == 'cpu' and out.numel() > 0


def test_tensor_inputs_keep_their_device():
    octree, ph, pyr, exsum, o, d, fv = _spc_numpy()
    t = [torch.as_tensor(x) for x in (octree, ph, exsum, o, d, fv)]
    assert unbatched_mesh_to_spc_device(t[5], LEVEL)[0].device.type == 'cpu'
    hits = unbatched_raytrace_coherent(t[0], t[1], pyr, t[2], t[3], t[4],
                                       LEVEL, engine='mosaic', knum=16)
    assert hits.t_near.device.type == 'cpu' and int(hits.count.sum()) > 0
    ridx = unbatched_raytrace(t[0], t[1], pyr, t[2], t[3], t[4], LEVEL)[0]
    assert ridx.device.type == 'cpu' and ridx.numel() > 0


def test_slice9_tensor_inputs_keep_their_device():
    s = uv_sphere(8, 5)
    inside = check_sign(torch.as_tensor(s.vertices[None] * 0.4), s.faces,
                        torch.full((1, 3, 3), 0.01), use_hash=True)
    assert inside.device.type == 'cpu' and bool(inside.all())
    r = profiler.benchmark(lambda: torch.ones(2), iters=2, device='cpu')
    assert r['out'].device.type == 'cpu'
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            profiler.benchmark(lambda: torch.ones(2), iters=2)


def test_slice8_tensor_inputs_keep_their_device():
    s = uv_sphere(8, 5)
    v = torch.as_tensor(s.vertices[None] * 0.4)
    pts, choice = sample_points(v, s.faces, 20)
    assert pts.device.type == 'cpu' and choice.device.type == 'cpu'
    grid = torch.as_tensor(_GRID[:, 0])
    assert voxelgrid.fill(grid).device.type == 'cpu'
    assert vg_conv.voxelgrids_to_trianglemeshes(grid)[0][0].device.type \
        == 'cpu'
    assert adjacency_matrix(4, torch.tensor([[0, 1, 2]])).device.type \
        == 'cpu'
