"""The port's measurement and build helpers on the CPU.

* ``utils/measure.py::in_turns`` with fake timers: the calls go kernel,
  library, library, kernel and each pair is averaged;
* ``_cuda.build_key``: the name of a build changes with a source, with a
  header the sources include (``#include "..."``, transitively) and with
  the flags, so an edit to a header alone cannot reuse a stale library; a
  header no source includes leaves it alone, so an edit to one kernel's
  header rebuilds that kernel's libraries and no others.

Exact: the averages are of fixed numbers, the keys are hashes.
"""
import shutil

import pytest

from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch.utils import measure


def _fake_timer(times):
    """A timer that logs (fn's name, iters) and returns the next of
    ``times``."""
    calls = []
    it = iter(times)

    def timer(fn, iters):
        calls.append((fn.__name__, iters))
        return next(it)
    return timer, calls


def kernel():
    pass


def library():
    pass


def test_in_turns_order_and_averages():
    timer, calls = _fake_timer([1., 10., 30., 3.])
    k, lib = measure.in_turns(timer, kernel, library, 7)
    assert calls == [('kernel', 7), ('library', 7), ('library', 7),
                     ('kernel', 7)]
    assert (k, lib) == (2., 20.)


def test_in_turns_without_library():
    timer, calls = _fake_timer([4.])
    assert measure.in_turns(timer, kernel, None, 3) == (4., None)
    assert calls == [('kernel', 3)]


def _csrc(tmp_path):
    """a.cu includes ring.cuh, which includes bits.cuh (not beside it: on
    the include path, or nowhere); a_module.cpp includes ext.h."""
    csrc = tmp_path / 'csrc'
    csrc.mkdir()
    (csrc / 'a.cu').write_text('#include "ring.cuh"\nint f() { return 1; }\n')
    (csrc / 'a_module.cpp').write_text('#include "ext.h"\nint g();\n')
    (csrc / 'ring.cuh').write_text(
        '#pragma once\n#include "bits.cuh"\nconstexpr int S = 4;\n')
    (csrc / 'ext.h').write_text('#pragma once\n')
    return csrc


@pytest.mark.parametrize('edit', ['header', 'new header', 'module header',
                                  'source', 'flags', 'libs'])
def test_build_key_changes_with_what_is_built(tmp_path, edit):
    csrc = _csrc(tmp_path)
    args = (['a.cu', 'a_module.cpp'], _cuda.NVCC_FLAGS, ('-lc10',))
    before = _cuda.build_key(*args, csrc=csrc)
    assert _cuda.build_key(*args, csrc=csrc) == before     # deterministic
    if edit == 'header':
        (csrc / 'ring.cuh').write_text(
            '#pragma once\n#include "bits.cuh"\nconstexpr int S = 8;\n')
    elif edit == 'new header':      # an include now found beside ring.cuh
        (csrc / 'bits.cuh').write_text('#pragma once\n')
    elif edit == 'module header':
        (csrc / 'ext.h').write_text('#pragma once\nint h();\n')
    elif edit == 'source':
        (csrc / 'a.cu').write_text('#include "ring.cuh"\nint f() { return 2; }\n')
    elif edit == 'flags':
        args = (args[0], args[1] + ('-lineinfo',), args[2])
    else:
        args = args[:2] + (('-lc10', '-ltorch'),)
    after = _cuda.build_key(*args, csrc=csrc)
    assert len(after) == 16 and after != before


def test_build_key_ignores_other_files(tmp_path):
    """Files that no build reads (a .cpp not among the sources, notes)
    leave the key alone."""
    csrc = _csrc(tmp_path)
    before = _cuda.build_key(['a.cu'], _cuda.NVCC_FLAGS, csrc=csrc)
    (csrc / 'a_module.cpp').write_text('int h();\n')
    (csrc / 'notes.txt').write_text('x\n')
    assert _cuda.build_key(['a.cu'], _cuda.NVCC_FLAGS, csrc=csrc) == before
    assert (_cuda.CSRC / 'tma.cuh').exists()
    assert (_cuda.CSRC / 'ext.h').exists()


def test_build_key_ignores_a_header_no_source_includes(tmp_path):
    csrc = _csrc(tmp_path)
    args = (['a.cu', 'a_module.cpp'], _cuda.NVCC_FLAGS)
    before = _cuda.build_key(*args, csrc=csrc)
    (csrc / 'other.cuh').write_text('#pragma once\nconstexpr int T = 1;\n')
    assert _cuda.build_key(*args, csrc=csrc) == before


def _package_keys(csrc):
    """{build: key} of every build of the package's sources in ``csrc``:
    ``<name>_module`` (``<name>.cu`` + ``<name>_module.cpp``) and the
    ctypes library ``<name>`` (``<name>.cu``)."""
    keys = {}
    for cu in sorted(csrc.glob('*.cu')):
        keys[cu.stem] = _cuda.build_key([cu.name], _cuda.NVCC_FLAGS,
                                        csrc=csrc)
        if (csrc / f'{cu.stem}_module.cpp').exists():
            keys[f'{cu.stem}_module'] = _cuda.build_key(
                [cu.name, f'{cu.stem}_module.cpp'], _cuda.NVCC_FLAGS,
                csrc=csrc)
    return keys


@pytest.mark.parametrize('header,rebuilt', [
    ('spc_trace.cuh', {'spc_trace', 'spc_trace_module', 'probes',
                       'probes_module'}),
    ('tma.cuh', {'probes', 'probes_module'}),
    ('spc_trace_entry.h', {'spc_trace_module', 'probes_module'}),
    ('ext.h', {'dibr_fused_module', 'epilogue_module', 'probes_module',
               'spans_module', 'spc_cull_module', 'spc_trace_module'}),
    ('bilinear.cuh', {'epilogue', 'epilogue_module'}),
    ('shade.cuh', {'epilogue', 'epilogue_module'}),
    ('shade.h', {'epilogue', 'epilogue_module'})])
def test_package_header_keys_only_its_includers(tmp_path, header, rebuilt):
    """An edit to one of the package's headers changes the keys of exactly
    the builds that include it: K3's template those of K3 and the probes
    (P3), the copy engine's helpers the probes' only, E1's taps and the
    DIB-R shading the epilogue's."""
    csrc = tmp_path / 'csrc'
    shutil.copytree(_cuda.CSRC, csrc)
    before = _package_keys(csrc)
    with open(csrc / header, 'a') as f:
        f.write('// edited\n')
    after = _package_keys(csrc)
    assert {b for b in before if after[b] != before[b]} == rebuilt
