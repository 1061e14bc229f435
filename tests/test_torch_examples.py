"""The port's examples (``kaolin_tpu_torch/examples``) on the CPU.

Each runs as a subprocess with ``--device cpu`` and the tiny flags of
``tests/test_examples.py`` and prints the JAX script's final line.  Each
is held against its JAX counterpart (``examples/*.py``, run in-process on
the same mesh):

- camera_tour, spc_raytrace_demo: the same printed lines (timings aside);
- dmtet_demo, sg_lighting_demo (a textured OBJ with normals; the port
  rasterizes through K1's plain version, the JAX script with ``'jnp'``):
  the printed values within 1e-3 relative (Adam's first steps
  divide by the gradient's size, so ulp-level differences of the two
  sides' gradients show in the printed digits: measured 6e-5);
- dibr_inverse_rendering (``--backend jnp``): the fitted vertices within
  2e-5 of the JAX loop's from the same start (the script's own draws come
  from ``jax.random``; the loop is the script's).
"""
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from kaolin_tpu_torch.utils.testing import uv_sphere

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VALUE_RTOL = 1e-3
VERT_ATOL = 2e-5

SMALL = {
    'dibr_inverse_rendering': (['--height', '32', '--width', '32',
                                '--num-views', '2', '--steps', '3'], 'done'),
    'dmtet_demo': (['--res', '4', '--steps', '2'], 'done'),
    'spc_raytrace_demo': (['--level', '4', '--rays', '256'],
                          'integrated features'),
    'sg_lighting_demo': (['--size', '32', '--steps', '3'], 'done'),
    'camera_tour': ([], 'done'),
}


@pytest.mark.parametrize('name', list(SMALL))
def test_example_subprocess(name, tmp_path):
    argv, last = SMALL[name]
    if name == 'dibr_inverse_rendering':
        argv = argv + ['--logdir', str(tmp_path / 'timelapse')]
    proc = subprocess.run(
        [sys.executable, '-m', f'kaolin_tpu_torch.examples.{name}', *argv,
         '--device', 'cpu'], capture_output=True, text=True, timeout=300,
        cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert last in proc.stdout.strip().splitlines()[-1]
    if name == 'camera_tour':
        assert 'round-trip close: True' in proc.stdout
    if name == 'dibr_inverse_rendering':
        assert list((tmp_path / 'timelapse' / 'fitted').glob('*.usda'))


def _jax_example(name, argv):
    """Run ``examples/{name}.py``'s main() in this process; its stdout."""
    spec = importlib.util.spec_from_file_location(
        f'_jax_example_{name}', os.path.join(REPO, 'examples', f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = io.StringIO()
    old = sys.argv
    sys.argv = [name] + argv
    try:
        with contextlib.redirect_stdout(out):
            mod.main()
    finally:
        sys.argv = old
    return out.getvalue()


def _port_example(name, argv):
    mod = importlib.import_module(f'kaolin_tpu_torch.examples.{name}')
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = mod.main(argv + ['--device', 'cpu'])
    return out.getvalue(), result


def _lines(text):
    """Printed lines without timings."""
    return [re.sub(r'\(\d+\.\d+s[^)]*\)', '', l).strip()
            for l in text.strip().splitlines()]


def _values(text):
    return [float(x) for x in re.findall(r'-?\d+\.\d+', '\n'.join(
        _lines(text)))]


@pytest.fixture(scope='module')
def sphere_obj(tmp_path_factory):
    """A uv_sphere OBJ with normals and a map_Kd texture (both importers
    read it)."""
    d = tmp_path_factory.mktemp('mesh')
    s = uv_sphere(24, 13)
    n = s.vertices / np.linalg.norm(s.vertices, axis=1, keepdims=True)
    tex = np.random.default_rng(3).integers(0, 256, (32, 32, 3),
                                            dtype=np.uint8)
    Image.fromarray(tex).save(d / 'tex.png')
    (d / 'm.mtl').write_text('newmtl mat\nKd 0.8 0.6 0.4\nmap_Kd tex.png\n')
    lines = ['mtllib m.mtl']
    lines += [f'v {x:.9g} {y:.9g} {z:.9g}' for x, y, z in s.vertices]
    lines += [f'vt {u:.9g} {v:.9g}' for u, v in s.uvs]
    lines += [f'vn {x:.9g} {y:.9g} {z:.9g}' for x, y, z in n]
    lines.append('usemtl mat')
    lines += ['f ' + ' '.join(f'{a + 1}/{b + 1}/{a + 1}' for a, b in
                              zip(f, t))
              for f, t in zip(s.faces, s.face_uvs_idx)]
    (d / 'm.obj').write_text('\n'.join(lines) + '\n')
    return str(d / 'm.obj')


def test_camera_tour_against_jax():
    out_t, g = _port_example('camera_tour', [])
    assert _lines(out_t) == _lines(_jax_example('camera_tour', []))
    assert g.shape[-1] > 0


def test_spc_demo_against_jax(sphere_obj):
    argv = ['--mesh', sphere_obj, '--level', '4', '--rays', '400']
    out_t, _ = _port_example('spc_raytrace_demo', argv)
    assert _lines(out_t) == _lines(_jax_example('spc_raytrace_demo', argv))


@pytest.mark.parametrize('name,argv', [
    ('dmtet_demo', ['--res', '4', '--steps', '6']),
    ('sg_lighting_demo', ['--size', '32', '--steps', '5']),
])
def test_printed_values_against_jax(name, argv, sphere_obj):
    extra = ['--mesh', sphere_obj] if name == 'sg_lighting_demo' else []
    out_t, _ = _port_example(name, argv + extra)
    out_j = _jax_example(name, argv + extra)
    v_t, v_j = _values(out_t), _values(out_j)
    assert len(v_t) == len(v_j) >= 2
    np.testing.assert_allclose(v_t, v_j, rtol=VALUE_RTOL)


def test_dibr_against_jax_loop():
    import jax
    import jax.numpy as jnp
    import optax
    from kaolin_tpu.models import inverse_render as MJ
    from kaolin_tpu_torch.examples.dibr_inverse_rendering import load_mesh
    from kaolin_tpu_torch.models import inverse_render as MT

    H, views_n, steps, lr = 32, 2, 3, 5e-3
    argv = ['--height', str(H), '--width', str(H), '--num-views',
            str(views_n), '--steps', str(steps), '--backend', 'jnp']
    _, v_t = _port_example('dibr_inverse_rendering', argv)

    # the example's start, drawn as it draws it
    mesh = load_mesh(None, 'cpu')
    gt = MT.init_params(mesh, texture_res=64,
                        generator=torch.Generator().manual_seed(7))
    start = MT.init_params(mesh, texture_res=64)
    noise = torch.randn(tuple(start.vertices.shape),
                        generator=torch.Generator().manual_seed(0))
    np_ = lambda t: np.asarray(t.detach().numpy())   # noqa: E731
    faces = jnp.asarray(np_(mesh.faces))
    face_uvs = jnp.asarray(np_(mesh.uvs[mesh.face_uvs_idx]))
    views = MJ.make_views(views_n)
    gt_j = MJ.InverseRenderParams(*(jnp.asarray(np_(p)) for p in (
        gt.vertices, gt.texture_map, gt.sh_coeffs)))
    images, masks, _ = MJ.render_views(gt_j, views, faces, face_uvs, H, H,
                                       backend='jnp')
    params = MJ.InverseRenderParams(
        jnp.asarray(np_(start.vertices + 0.05 * noise)),
        jnp.asarray(np_(start.texture_map)), jnp.asarray(np_(
            start.sh_coeffs)))
    opt = optax.adam(lr)
    state = opt.init(params)
    grad = jax.jit(jax.value_and_grad(lambda p, sel: MJ.render_loss(
        p, views, faces, face_uvs, images, masks, H, H, backend='jnp',
        selection=sel)))
    for _ in range(steps):
        sel = MJ.compute_selection(params, views, faces, H, H,
                                   backend='jnp')
        _, g = grad(params, sel)
        updates, state = opt.update(g, state, params)
        params = optax.apply_updates(params, updates)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(params.vertices),
                               rtol=0, atol=VERT_ATOL)
