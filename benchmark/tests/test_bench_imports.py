"""The import check, by whole top-level name: the harness loads neither JAX
nor the JAX package, and the reference loads nothing of the program."""

import ast
import subprocess
import sys

import pytest

from conftest import ROOT
from benchmark.harness import env

REFERENCE = sorted((ROOT / 'benchmark' / 'reference').glob('*.py'))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def test_names_compared_whole():
    assert env.forbidden_modules(['kaolin_tpu_torch', 'kaolin_tpu_torch.ops',
                                  'jaxtyping', 'numpy']) == []
    assert env.forbidden_modules(['kaolin_tpu.ops', 'jax.numpy', 'flax',
                                  'jaxlib.xla']) == ['flax', 'jax', 'jaxlib',
                                                     'kaolin_tpu']


@pytest.mark.parametrize('path', REFERENCE, ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    found = top_level_imports(path)
    assert not found & {'kaolin_tpu_torch', 'kaolin_tpu', 'jax', 'jaxlib',
                        'flax'}, found
    assert found <= {'torch', 'numpy', 'math', 'benchmark'}, found


def test_harness_process_loads_no_jax():
    """Every module a run imports, drivers and the program's entry points
    with them, in a fresh process: no JAX, no JAX package."""
    code = (
        'import sys; sys.path.insert(0, %r)\n'
        'import benchmark.run, benchmark.tools.readings\n'
        'from benchmark.drivers import dibr, multiview, spc\n'
        'from kaolin_tpu_torch.models import inverse_render\n'
        'from kaolin_tpu_torch.parallel import distributed, sharding\n'
        'from kaolin_tpu_torch.render.spc import raster\n'
        'from kaolin_tpu_torch.ops.conversions import trianglemesh\n'
        'from benchmark.harness import env\n'
        'print(env.forbidden_modules())\n' % str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == '[]'
