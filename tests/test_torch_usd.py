"""USD (USDA) I/O of the port against kaolin_tpu's.

For the same mesh, point cloud, voxel grid and material the two packages
write byte-identical ``.usda`` files (and texture PNGs), and each package
reads the other's files back to the values written, bit for bit.  The
writers take tensors; the readers return tensors on the device asked for.
"""
import filecmp

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaolin_tpu.io import materials as mat_j
from kaolin_tpu.io import usd as usd_j
from kaolin_tpu_torch.io import materials as mat_t
from kaolin_tpu_torch.io import usd as usd_t
from kaolin_tpu_torch.io.usd import usda as usda_t
from kaolin_tpu_torch.utils.testing import uv_sphere


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _mesh(seed=0):
    s = uv_sphere(20, 11)
    rng = np.random.default_rng(seed)
    v = (s.vertices + 0.01 * rng.standard_normal(s.vertices.shape)).astype(
        np.float32)
    normals = rng.standard_normal((s.faces.shape[0], 3, 3)).astype(np.float32)
    return dict(vertices=v, faces=s.faces, uvs=s.uvs.astype(np.float32),
                face_uvs_idx=s.face_uvs_idx, face_normals=normals)


def _torch(d):
    return {k: torch.as_tensor(v) for k, v in d.items()}


def _jax(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


@pytest.mark.parametrize('time', [None, 3])
def test_mesh_files_equal(tmp_path, time):
    m = _mesh()
    a, b = str(tmp_path / 'j.usda'), str(tmp_path / 't.usda')
    usd_j.export_mesh(a, '/World/m', time=time, **_jax(m))
    usd_t.export_mesh(b, '/World/m', time=time, **_torch(m))
    assert filecmp.cmp(a, b, shallow=False)
    # a second mesh (and time sample) added to the existing files
    m2 = _mesh(1)
    t2 = None if time is None else 7
    usd_j.export_meshes(a, ['/World/n'], [jnp.asarray(m2['vertices'])],
                        [jnp.asarray(m2['faces'])], times=None if t2 is None
                        else [t2])
    usd_t.export_meshes(b, ['/World/n'], [torch.as_tensor(m2['vertices'])],
                        [torch.as_tensor(m2['faces'])],
                        times=None if t2 is None else [t2])
    assert filecmp.cmp(a, b, shallow=False)
    assert usd_t.get_scene_paths(b, prim_types='Mesh') == \
        usd_j.get_scene_paths(a, prim_types='Mesh') == ['/World/m', '/World/n']
    assert usd_t.get_authored_time_samples(b) == \
        usd_j.get_authored_time_samples(a)
    # each package reads the other's file
    for path in (a, b):
        mt = usd_t.import_mesh(path, '/World/m', time=time, device='cpu')
        mj = usd_j.import_mesh(path, '/World/m', time=time)
        for name in ('vertices', 'faces', 'uvs', 'face_uvs_idx'):
            np.testing.assert_array_equal(_bits(getattr(mt, name).numpy()),
                                          _bits(m[name]), err_msg=name)
            np.testing.assert_array_equal(_bits(np.asarray(getattr(mj,
                                                                   name))),
                                          _bits(m[name]), err_msg=name)
        raw = usd_t.get_raw_mesh_prim_geometry(
            usd_t.open_stage(path).get_prim('/World/m'), time=time,
            with_normals=True, with_uvs=True)
        np.testing.assert_array_equal(_bits(raw['normals']),
                                      _bits(m['face_normals'].reshape(-1, 3)))
        np.testing.assert_array_equal(raw['uvs']['indices'],
                                      m['face_uvs_idx'].reshape(-1))
    meshes = usd_t.import_meshes(b, device='cpu')
    assert len(meshes) == 2
    np.testing.assert_array_equal(meshes[1].faces.numpy(), m2['faces'])


def test_mesh_quads_and_handlers(tmp_path):
    quads = np.array([[0, 1, 2, 3], [1, 4, 5, 2]])
    v = np.random.default_rng(2).random((6, 3)).astype(np.float32)
    path = str(tmp_path / 'q.usda')
    usd_t.export_mesh(path, vertices=torch.as_tensor(v),
                      faces=torch.as_tensor(quads))
    m = usd_t.import_mesh(path, device='cpu')
    np.testing.assert_array_equal(m.faces.numpy(), quads)
    tri_t = usd_t.import_mesh(path, triangulate=True, device='cpu')
    tri_j = usd_j.import_mesh(path, triangulate=True)
    np.testing.assert_array_equal(tri_t.faces.numpy(),
                                  np.asarray(tri_j.faces))
    assert tri_t.faces.shape == (4, 3)
    with pytest.raises(ValueError):
        usd_t.import_mesh(path, '/nowhere', device='cpu')


@pytest.mark.parametrize('colors', [False, True])
def test_pointcloud_files_equal(tmp_path, colors):
    rng = np.random.default_rng(4)
    pts = rng.standard_normal((500, 3)).astype(np.float32)
    col = rng.random((500, 3), dtype=np.float32) if colors else None
    a, b = str(tmp_path / 'j.usda'), str(tmp_path / 't.usda')
    for t in (0, 5):
        usd_j.export_pointcloud(a, jnp.asarray(pts + t), '/World/pc',
                                colors=None if col is None
                                else jnp.asarray(col), time=t)
        usd_t.export_pointcloud(b, torch.as_tensor(pts + t), '/World/pc',
                                colors=None if col is None
                                else torch.as_tensor(col), time=t)
    assert filecmp.cmp(a, b, shallow=False)
    for path in (a, b):
        p_t = usd_t.import_pointcloud(path, '/World/pc', time=5,
                                      device='cpu')
        p_j = usd_j.import_pointcloud(path, '/World/pc', time=5)
        np.testing.assert_array_equal(_bits(p_t.points.numpy()),
                                      _bits(pts + 5))
        np.testing.assert_array_equal(_bits(np.asarray(p_j.points)),
                                      _bits(pts + 5))
        if colors:
            np.testing.assert_array_equal(_bits(p_t.colors.numpy()),
                                          _bits(col))
        else:
            assert p_t.colors is None
    assert usd_t.get_pointcloud_scene_paths(b) == ['/World/pc']
    stage = usd_t.open_stage(b)
    brackets_j = usd_j.get_pointcloud_bracketing_time_samples(
        usd_j.open_stage(a), '/World/pc', 2.)
    assert usd_t.get_pointcloud_bracketing_time_samples(
        stage, '/World/pc', 2.) == brackets_j == (0., 5.)


def test_voxelgrid_files_equal(tmp_path):
    grid = np.random.default_rng(5).random((9, 9, 9)) > 0.7
    a, b = str(tmp_path / 'j.usda'), str(tmp_path / 't.usda')
    usd_j.export_voxelgrid(a, jnp.asarray(grid), time=2)
    usd_t.export_voxelgrid(b, torch.as_tensor(grid).float(), time=2)
    assert filecmp.cmp(a, b, shallow=False)
    for path in (a, b):
        g = usd_t.import_voxelgrid(path, '/World/VoxelGrids/voxelgrid_0',
                                   device='cpu')
        assert g.dtype == torch.bool
        np.testing.assert_array_equal(g.numpy(), grid)
        np.testing.assert_array_equal(np.asarray(usd_j.import_voxelgrid(
            path, '/World/VoxelGrids/voxelgrid_0')), grid)
    assert len(usd_t.import_voxelgrids(b, device='cpu')) == 1


def test_material_files_equal(tmp_path):
    rng = np.random.default_rng(6)
    tex = rng.random((3, 8, 8), dtype=np.float32)
    rough = rng.random((1, 8, 8), dtype=np.float32)
    kw = dict(material_name='m0', diffuse_color=(0.2, 0.4, 0.6),
              roughness_value=0.3, is_specular_workflow=True)
    m_j = mat_j.PBRMaterial(diffuse_texture=tex, roughness_texture=rough,
                            **kw)
    m_t = mat_t.PBRMaterial(diffuse_texture=torch.as_tensor(tex),
                            roughness_texture=torch.as_tensor(rough), **kw)
    (tmp_path / 'j').mkdir()
    (tmp_path / 't').mkdir()
    a, b = str(tmp_path / 'j' / 'x.usda'), str(tmp_path / 't' / 'x.usda')
    m_j.write_to_usd(a, '/World/Looks/m0', texture_dir='tex')
    m_t.write_to_usd(b, '/World/Looks/m0', texture_dir='tex')
    cmp = filecmp.dircmp(tmp_path / 'j', tmp_path / 't')
    assert not cmp.diff_files and not cmp.left_only and not cmp.right_only
    assert filecmp.cmpfiles(tmp_path / 'j' / 'tex', tmp_path / 't' / 'tex',
                            ['diffuse_texture.png',
                             'roughness_texture.png'], shallow=False)[0] \
        == ['diffuse_texture.png', 'roughness_texture.png']
    for path in (a, b):
        r_t = mat_t.PBRMaterial().read_from_usd(path, '/World/Looks/m0',
                                                device='cpu')
        r_j = mat_j.PBRMaterial().read_from_usd(path, '/World/Looks/m0')
        r_m = mat_t.MaterialManager.read_from_file(
            path, '/World/Looks/m0', device='cpu')
        for r in (r_t, r_m):
            assert r.material_name == r_j.material_name == 'm0'
            assert r.is_specular_workflow and r.diffuse_color == \
                r_j.diffuse_color
            assert r.roughness_value == r_j.roughness_value
            np.testing.assert_array_equal(r.diffuse_texture.numpy(),
                                          np.asarray(r_j.diffuse_texture))
            np.testing.assert_array_equal(r.roughness_texture.numpy(),
                                          np.asarray(r_j.roughness_texture))
    with pytest.raises(mat_t.MaterialNotSupportedError):
        mat_t.MaterialManager.read_from_file(str(tmp_path / 'x.obj'))
    with pytest.raises(mat_t.MaterialLoadError):
        mat_t.MaterialManager.read_from_file(a)
    with pytest.raises(ValueError):
        mat_t.MaterialManager.register_usd_reader('x', lambda a, b: None)


def test_mesh_prim_materials(tmp_path):
    path = str(tmp_path / 'x.usda')
    mat_t.PBRMaterial(material_name='m1').write_to_usd(path,
                                                       '/World/Looks/m1')
    usd_t.export_mesh(path, '/World/mesh', **_torch(_mesh()))
    stage = usd_t.open_stage(path)
    stage.get_prim('/World/mesh').attrs['material:binding'] = \
        '/World/Looks/m1'
    stage.save(path)
    prim = usd_t.open_stage(path).get_prim('/World/mesh')
    got = usd_t.get_mesh_prim_materials(prim, path, device='cpu')
    assert list(got) == ['/World/Looks/m1']
    assert got['/World/Looks/m1'].material_name == 'm1'


def test_usda_text_round_trip():
    texts = []
    for mod in (usda_t, usd_j):
        stage = mod.UsdaStage()
        prim = stage.define_prim('/World/a', 'Mesh')
        prim.attrs['points'] = np.float32([[0.1, 0.2, 0.3]])
        prim.attrs['primvars:st:indices'] = np.arange(4)
        prim.attrs['n'] = 3
        prim.attrs['name'] = 'x'
        texts.append(stage.dumps())
    assert texts[0] == texts[1]
    assert usda_t.parse_usda(texts[0]).dumps() == \
        usd_j.parse_usda(texts[0]).dumps() == texts[0]
    with pytest.raises(ValueError):
        usda_t.parse_usda('def Mesh "a" {}')


TRICKY = '''#usda 1.0
(
    metersPerUnit = 1
    upAxis = "Y"
)

# a comment
def Xform "World" (
    kind = "component"
)
{
    def Mesh "m"
    {
        point3f[] points = [(0.1, -2.5e-05, 3), (1e+20, -0.0, 7.25)]
        int[] faceVertexIndices = [0, 1, -2, +3, 4,]
        float[] mixed = [1, 2.5, -0, 3e2]
        float[] empty = []
        int3[] rows = [(1, 2, 3), (4, 5, 6)]
        float2[] rowsmixed = [(1, 2.5), (-0, 4)]
        float2[] rowstrail = [(1.5, 2.5,), (3.5, 4.5,),]
        string[] names = ["a", "b,c"]
        float[] special = [inf, -inf, 1.5]
        int[] huge = [123456789012345678901234, 1]
        bool flag = true
        string s = "x [1, 2] y"
        float f = 0.5
        int[] counts.timeSamples = {
            0: [3, 3],
            2.5: [4],
        }
        float3[] n = [(1, 2, 3)] (
            interpolation = "faceVarying"
        )
    }
}
'''


def _same_value(a, b):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray) and isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape, (a, b)
        if a.dtype.kind == 'f':
            np.testing.assert_array_equal(a.view(np.uint64),
                                          b.view(np.uint64))
        else:
            np.testing.assert_array_equal(a, b)
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _same_value(a[k], b[k])
    else:
        assert type(a) is type(b) and a == b


@pytest.mark.parametrize('text', ['tricky', 'mesh', 'pointcloud'])
def test_reader_values_equal_jax(tmp_path, text):
    """The port's reader (arrays of numbers in one step) gives the JAX
    reader's values, dtypes and shapes, bit for bit, -0.0 included."""
    if text == 'tricky':
        doc = TRICKY
    else:
        path = str(tmp_path / 'x.usda')
        for t in (0, 1):
            if text == 'mesh':
                usd_t.export_mesh(path, time=t, **_torch(_mesh(t)))
            else:
                usd_t.export_pointcloud(path, torch.as_tensor(
                    _mesh(t)['vertices']), time=t)
        doc = open(path).read()
    a, b = usda_t.parse_usda(doc), usd_j.parse_usda(doc)
    prims_a, prims_b = list(a.prims()), list(b.prims())
    assert [(p.path, p.type_name) for p in prims_a] == \
        [(p.path, p.type_name) for p in prims_b]
    for pa, pb in zip(prims_a, prims_b):
        assert list(pa.attrs) == list(pb.attrs)
        for k in pa.attrs:
            _same_value(pa.attrs[k], pb.attrs[k])
    assert a.dumps() == b.dumps()


def test_reader_ragged_rows_raise_as_jax():
    doc = '#usda 1.0\ndef Mesh "m"\n{\n    float2[] x = [(1, 2), (3)]\n}\n'
    with pytest.raises(ValueError):
        usd_j.parse_usda(doc)
    with pytest.raises(ValueError):
        usda_t.parse_usda(doc)
