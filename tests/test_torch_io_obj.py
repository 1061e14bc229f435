"""The port's OBJ/MTL importer and SurfaceMesh against kaolin_tpu's.

Each test writes its own OBJ/MTL text (and a PNG texture) into
``tmp_path`` and imports it with both packages.  Arrays are held exactly
equal; material dicts and assignments equal; the same errors raised.  The
JAX importer takes its native fast path when no materials are asked for
(``csrc/obj_parser.cpp``), its Python parse otherwise; the port's one
Python parse gives what either gives.
"""
import warnings

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from kaolin_tpu.io import materials as mat_j
from kaolin_tpu.io import obj as obj_j
from kaolin_tpu.io import utils as utils_j
from kaolin_tpu.rep import SurfaceMesh as SMJ
from kaolin_tpu_torch.io import materials as mat_t
from kaolin_tpu_torch.io import obj as obj_t
from kaolin_tpu_torch.io import utils as utils_t
from kaolin_tpu_torch.rep import SurfaceMesh as SMT
from kaolin_tpu_torch.utils.testing import uv_sphere

ATTRS = ('vertices', 'faces', 'uvs', 'face_uvs_idx', 'normals',
         'face_normals_idx', 'material_assignments')


def write_obj(path, vertices, faces, uvs=None, face_uvs_idx=None,
              normals=None, face_normals_idx=None, mtllib=None,
              usemtl=()):
    """OBJ text; ``usemtl`` lists (first face, material name)."""
    lines = [] if mtllib is None else [f'mtllib {mtllib}']
    lines += ['v ' + ' '.join(f'{c:.6f}' for c in v) for v in vertices]
    if uvs is not None:
        lines += ['vt ' + ' '.join(f'{c:.6f}' for c in t) for t in uvs]
    if normals is not None:
        lines += ['vn ' + ' '.join(f'{c:.6f}' for c in n) for n in normals]
    starts = dict(usemtl)
    for i, f in enumerate(faces):
        if i in starts:
            lines.append(f'usemtl {starts[i]}')
        corners = []
        for k, v in enumerate(f):
            c = str(v + 1)
            if face_uvs_idx is not None or face_normals_idx is not None:
                c += '/' + ('' if face_uvs_idx is None
                            else str(face_uvs_idx[i][k] + 1))
            if face_normals_idx is not None:
                c += '/' + str(face_normals_idx[i][k] + 1)
            corners.append(c)
        lines.append('f ' + ' '.join(corners))
    path.write_text('\n'.join(lines) + '\n')
    return str(path)


def write_mtl(path, texture=None):
    lines = ['newmtl red', 'Kd 0.800000 0.100000 0.200000',
             'Ka 0.1 0.1 0.1', '', 'newmtl blue',
             'Kd 0.100000 0.200000 0.900000', 'Ks 0.5 0.5 0.5']
    if texture is not None:
        lines.append(f'map_Kd {texture}')
    path.write_text('\n'.join(lines) + '\n')


def quad_grid(n=4):
    """An n x n grid of quads in the z = 0 plane with uvs and one normal."""
    ij = np.stack(np.meshgrid(np.arange(n + 1), np.arange(n + 1),
                              indexing='ij'), -1).reshape(-1, 2)
    vertices = np.concatenate([ij / n - 0.5, np.zeros((len(ij), 1))], 1)
    faces = [[i * (n + 1) + j, (i + 1) * (n + 1) + j,
              (i + 1) * (n + 1) + j + 1, i * (n + 1) + j + 1]
             for i in range(n) for j in range(n)]
    return vertices, faces, ij / n


def assert_same_mesh(m_t, m_j):
    assert m_t is not None and m_j is not None
    for name in ATTRS:
        assert m_t.has_attribute(name) == m_j.has_attribute(name), name
        if m_j.has_attribute(name):
            a, b = np.asarray(getattr(m_j, name)), getattr(m_t, name)
            assert b.device.type == 'cpu'
            assert b.shape == a.shape, name
            np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    assert (m_t.materials is None) == (m_j.materials is None)
    if m_j.materials is not None:
        assert len(m_t.materials) == len(m_j.materials)
        for a, b in zip(m_j.materials, m_t.materials):
            if isinstance(a, dict):
                assert sorted(a) == sorted(b)
                for k in a:
                    np.testing.assert_array_equal(np.asarray(b[k]),
                                                  np.asarray(a[k]))
            else:
                assert a.material_name == b.material_name
                assert a.diffuse_color == b.diffuse_color
                for tex in ('diffuse_texture', 'specular_texture'):
                    ta, tb = getattr(a, tex), getattr(b, tex)
                    assert (ta is None) == (tb is None)
                    if ta is not None:
                        np.testing.assert_array_equal(tb.numpy(),
                                                      np.asarray(ta))


def import_both(path, **kw):
    with warnings.catch_warnings(record=True) as w_j:
        warnings.simplefilter('always')
        m_j = obj_j.import_mesh(path, **{k: v[0] if isinstance(v, tuple)
                                         else v for k, v in kw.items()})
    with warnings.catch_warnings(record=True) as w_t:
        warnings.simplefilter('always')
        m_t = obj_t.import_mesh(path, device='cpu', **{
            k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()})
    assert [str(w.message) for w in w_t] == [str(w.message) for w in w_j]
    return m_t, m_j


@pytest.fixture
def sphere_obj(tmp_path):
    s = uv_sphere(12, 7)
    normals = s.vertices / np.linalg.norm(s.vertices, axis=1,
                                          keepdims=True)
    write_mtl(tmp_path / 'sphere.mtl')
    F = len(s.faces)
    return write_obj(tmp_path / 'sphere.obj', s.vertices, s.faces, s.uvs,
                     s.face_uvs_idx, normals, s.faces, mtllib='sphere.mtl',
                     usemtl=[(0, 'red'), (F // 3, 'blue'), (F // 2, 'red')])


@pytest.mark.parametrize('with_normals', [False, True])
@pytest.mark.parametrize('with_materials', [False, True])
def test_triangles_uvs_normals_materials(sphere_obj, with_normals,
                                         with_materials):
    m_t, m_j = import_both(sphere_obj, with_normals=with_normals,
                           with_materials=with_materials)
    assert_same_mesh(m_t, m_j)
    s = uv_sphere(12, 7)
    np.testing.assert_array_equal(m_t.faces.numpy(), s.faces)
    np.testing.assert_array_equal(m_t.face_uvs_idx.numpy(), s.face_uvs_idx)
    if with_materials:
        ma = m_t.material_assignments.numpy()
        F = len(s.faces)
        assert [m['material_name'] for m in m_t.materials] == ['blue', 'red']
        assert (ma[:F // 3] == 1).all() and (ma[F // 3:F // 2] == 0).all()
        assert (ma[F // 2:] == 1).all()


@pytest.mark.parametrize('how', ['triangulate', 'handler', 'both', 'none'])
@pytest.mark.parametrize('with_materials', [False, True])
def test_quads(tmp_path, how, with_materials):
    v, f, uv = quad_grid()
    write_mtl(tmp_path / 'q.mtl')
    path = write_obj(tmp_path / 'q.obj', v, f, uv, f, mtllib='q.mtl',
                     usemtl=[(0, 'blue'), (5, 'red')])
    kw = dict(with_materials=with_materials,
              triangulate=how in ('triangulate', 'both'))
    if how in ('handler', 'both'):
        kw['heterogeneous_mesh_handler'] = (
            utils_j.mesh_handler_naive_triangulate,
            utils_t.mesh_handler_naive_triangulate)
    m_t, m_j = import_both(path, **kw)
    assert_same_mesh(m_t, m_j)
    tri = how != 'none' and not (how == 'handler' and with_materials)
    assert m_t.faces.shape == ((32, 3) if tri else (16, 4))


@pytest.mark.parametrize('with_materials', [False, True])
def test_heterogeneous(tmp_path, with_materials):
    v, f, uv = quad_grid(3)
    f = f[:4] + [[a, b, c] for a, b, c, _ in f[4:]] + [f[0] + [f[1][1]]]
    write_mtl(tmp_path / 'h.mtl')
    path = write_obj(tmp_path / 'h.obj', v, f, uv, f, mtllib='h.mtl',
                     usemtl=[(0, 'red'), (3, 'blue'), (7, 'red')])
    with pytest.raises(utils_j.NonHomogeneousMeshError):
        obj_j.import_mesh(path, with_materials=with_materials)
    with pytest.raises(utils_t.NonHomogeneousMeshError):
        obj_t.import_mesh(path, with_materials=with_materials, device='cpu')
    m_t, m_j = import_both(path, with_materials=with_materials,
                           triangulate=True)
    assert_same_mesh(m_t, m_j)
    assert m_t.faces.shape[-1] == 3
    m_t, m_j = import_both(path, with_materials=with_materials,
                           heterogeneous_mesh_handler=(
                               utils_j.heterogeneous_mesh_handler_skip,
                               utils_t.heterogeneous_mesh_handler_skip))
    assert m_t is None and m_j is None


@pytest.mark.parametrize('handler', ['default', 'skip', 'ignore', 'create'])
def test_missing_mtl(tmp_path, handler):
    s = uv_sphere(6, 4)
    path = write_obj(tmp_path / 'm.obj', s.vertices, s.faces, s.uvs,
                     s.face_uvs_idx, mtllib='absent.mtl',
                     usemtl=[(0, 'red'), (10, 'blue')])
    if handler == 'default':
        with pytest.raises(mat_j.MaterialFileError):
            obj_j.import_mesh(path, with_materials=True)
        with pytest.raises(mat_t.MaterialFileError):
            obj_t.import_mesh(path, with_materials=True, device='cpu')
        return
    name = {'skip': 'skip_error_handler', 'ignore': 'ignore_error_handler',
            'create': 'create_missing_materials_error_handler'}[handler]
    m_t, m_j = import_both(path, with_materials=True, error_handler=(
        getattr(obj_j, name), getattr(obj_t, name)))
    assert_same_mesh(m_t, m_j)
    created = handler == 'create'
    assert len(m_t.materials) == (2 if created else 0)
    assert (m_t.material_assignments.numpy() >= 0).all() == created


def test_texture_and_pbr(tmp_path):
    from PIL import Image
    rng = np.random.default_rng(0)
    Image.fromarray(rng.integers(0, 256, (5, 7, 3), dtype=np.uint8)).save(
        tmp_path / 'tex.png')
    write_mtl(tmp_path / 't.mtl', texture='tex.png')
    s = uv_sphere(6, 4)
    path = write_obj(tmp_path / 't.obj', s.vertices, s.faces, s.uvs,
                     s.face_uvs_idx, mtllib='t.mtl', usemtl=[(0, 'blue')])
    m_t, m_j = import_both(path, with_materials=True)
    assert_same_mesh(m_t, m_j)
    assert m_t.materials[0]['map_Kd'].shape == (5, 7, 3)
    m_t, m_j = import_both(path, with_materials=True, raw_materials=False)
    assert_same_mesh(m_t, m_j)
    assert isinstance(m_t.materials[0], mat_t.PBRMaterial)
    assert m_t.materials[0].diffuse_texture.shape == (3, 5, 7)
    assert repr(m_t.materials[0]) == repr(m_j.materials[0])
    # a texture that is not there: the default handler raises
    write_mtl(tmp_path / 't.mtl', texture='absent.png')
    with pytest.raises(mat_j.MaterialLoadError):
        obj_j.import_mesh(path, with_materials=True)
    with pytest.raises(mat_t.MaterialLoadError):
        obj_t.import_mesh(path, with_materials=True, device='cpu')


def test_negative_indices(tmp_path):
    path = tmp_path / 'neg.obj'
    path.write_text('v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\n'
                    'vt 0 0\nvt 1 0\nvt 0 1\n'
                    'f -4/-3 -3/-2 -2/-1\nf 2/1 4/2 3/3\n')
    m_t, m_j = import_both(str(path))
    assert_same_mesh(m_t, m_j)


@pytest.mark.parametrize('with_assign', [False, True])
def test_naive_triangulate(with_assign):
    counts = np.array([3, 4, 5, 3])
    flat = np.arange(counts.sum())
    kw = {}
    if with_assign:
        kw = dict(face_assignments={'a': np.array([[0, 2]]),
                                    'b': np.array([1, 3])})
    out_j = utils_j.mesh_handler_naive_triangulate(None, counts, flat,
                                                   flat * 2, **kw)
    out_t = utils_t.mesh_handler_naive_triangulate(None, counts, flat,
                                                   flat * 2, **kw)
    assert len(out_t) == len(out_j)
    for a, b in zip(out_j[1:1 + 3], out_t[1:1 + 3]):
        np.testing.assert_array_equal(b, a)
    if with_assign:
        for k in ('a', 'b'):
            np.testing.assert_array_equal(out_t[-1][k], out_j[-1][k])


# ---------------------------------------------------------------------------
# SurfaceMesh

def _meshes():
    v = np.array([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.], [0., 0., 1.]],
                 np.float32)
    f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]])
    uvs = np.array([[0., 0.], [1., 0.], [0., 1.]], np.float32)
    fu = np.array([[0, 1, 2]] * 4)
    m_j = SMJ(vertices=jnp.asarray(v), faces=jnp.asarray(f),
              uvs=jnp.asarray(uvs), face_uvs_idx=jnp.asarray(fu))
    m_t = SMT(vertices=torch.as_tensor(v), faces=torch.as_tensor(f),
              uvs=torch.as_tensor(uvs), face_uvs_idx=torch.as_tensor(fu))
    return m_t, m_j


@pytest.mark.parametrize('name', ['face_vertices', 'face_normals',
                                  'vertex_normals', 'face_uvs'])
@pytest.mark.parametrize('batched', [False, True])
def test_surface_mesh_auto_compute(name, batched):
    m_t, m_j = _meshes()
    if batched:
        m_t.to_batched()
        m_j.to_batched()
    assert not m_t.has_attribute(name)
    assert m_t.probably_can_compute_attribute(name)
    a, b = np.asarray(getattr(m_j, name)), getattr(m_t, name)
    assert m_t.has_attribute(name)
    np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7)


def test_surface_mesh_authored_normals_and_repr():
    v = torch.tensor([[0., 0., 0.], [1., 0., 0.], [0., 1., 0.]])
    m = SMT(vertices=v, faces=torch.tensor([[0, 1, 2]]),
            normals=torch.tensor([[1., 0., 0.], [0., 1., 0.]]),
            face_normals_idx=torch.tensor([[0, 0, 1]]))
    assert torch.equal(m.face_normals[0],
                       torch.tensor([[1., 0., 0.], [1., 0., 0.],
                                     [0., 1., 0.]]))
    assert 'batching strategy NONE' in repr(m)
    assert m.uvs is None and m.face_uvs is None
    m.float_tensors_to(torch.float64)
    assert m.vertices.dtype == torch.float64
    assert m.faces.dtype == torch.int64
    assert m.get_attributes(only_tensors=True) == list(m._attrs)
    with pytest.raises(ValueError):
        SMT(vertices=torch.zeros(1, 3, 3), faces=torch.zeros(1, 3))
    m.uvs = None
    with pytest.raises(AttributeError):
        m.not_an_attribute = 1


def test_surface_mesh_batching():
    m_t, m_j = _meshes()
    for fixed in (True, False):
        both_t = SMT.cat([m_t, SMT(vertices=m_t.vertices * 2.,
                                   faces=m_t.faces)], fixed_topology=fixed)
        both_j = SMJ.cat([m_j, SMJ(vertices=m_j.vertices * 2.,
                                   faces=m_j.faces)], fixed_topology=fixed)
        assert both_t.batching == both_j.batching and len(both_t) == 2
        for a, b in zip(both_j.vertices, both_t.vertices):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    x = torch.ones(5, 3)
    B = SMT.Batching
    assert SMT.convert_attribute_batching(x, B.NONE, B.FIXED).shape == \
        (1, 5, 3)
    assert SMT.convert_attribute_batching(x[None], B.FIXED, B.NONE).shape \
        == (5, 3)
    assert SMT.convert_attribute_batching([x, x], B.LIST, B.FIXED).shape \
        == (2, 5, 3)
    assert len(SMT.convert_attribute_batching(x[None], B.FIXED, B.LIST)) \
        == 1
    assert m_t.getattr_batched('vertices', B.FIXED).shape == (1, 4, 3)
    assert m_t.getattr_batched('faces', B.FIXED).shape == (4, 3)
