"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface.  :func:`build` compiles
sources with ``nvcc`` for Hopper (``sm_90a``) into ``build/kaolin_tpu_torch/``
at the root of the checkout, keyed by a hash of the sources, the headers
they include and the flags (:func:`build_key`); :func:`load` opens
``csrc/<name>.cu``'s library with ``ctypes``.  Nothing there includes
PyTorch's headers, so a build takes seconds, not minutes.

:func:`load_module` builds ``csrc/<name>.cu`` with ``csrc/<name>_module.cpp``,
Python entry points that include only PyTorch's tensor and Python-binding
headers (seconds more, not the minutes of ``torch/extension.h``), and
imports the result as an extension module: a launch then costs the host
what a PyTorch op costs; an entry point raises ``ValueError`` naming the
input it refuses.  :func:`stream_getter` gives the current stream as an
integer.

There is no fallback: when ``nvcc`` cannot be found or the build fails,
:func:`build`, :func:`load` and :func:`load_module` raise.
"""

import ctypes
import hashlib
import importlib.util
import os
import re
import shutil
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ['find_nvcc', 'build_key', 'build', 'load', 'load_module',
           'stream_getter', 'BUILD_LOG']

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / 'build' / 'kaolin_tpu_torch'
# -fmad=false: no a*b+c contraction, so the kernels round each product and
# sum as the plain PyTorch versions do (parity up to summation order)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-fmad=false',
              '-Xptxas=-v')

BUILD_LOG = {}          # name -> nvcc output (registers, shared memory)
_LIBS = {}
_MODULES = {}
_LOCKS = {}             # name -> lock: different sources build in parallel
_LOCK = threading.Lock()
_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)


def find_nvcc():
    """Path of ``nvcc`` on ``PATH`` or under ``$CUDA_HOME/bin``; raises."""
    cuda_home = (os.environ.get('CUDA_HOME') or os.environ.get('CUDA_PATH')
                 or '/usr/local/cuda')
    search = os.pathsep.join([os.environ.get('PATH', ''),
                              os.path.join(cuda_home, 'bin')])
    nvcc = shutil.which('nvcc', path=search)
    if nvcc is None:
        raise RuntimeError(
            'nvcc not found on PATH or in $CUDA_HOME/bin: the CUDA kernels '
            'of kaolin_tpu_torch are built from source at first use and '
            'there is no fallback for CUDA tensors')
    return nvcc


def _module_flags():
    """(nvcc flags, libraries) for Python entry points over PyTorch's
    tensors: the interpreter's and PyTorch's headers, PyTorch's C++ ABI;
    its libraries, found at run time through the rpath."""
    root = Path(torch.__file__).resolve().parent
    lib = root / 'lib'
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    return (('-I' + sysconfig.get_paths()['include'],
             '-I' + str(root / 'include'), f'-D_GLIBCXX_USE_CXX11_ABI={abi}',
             f'-Xlinker=-rpath,{lib}'),
            ('-L' + str(lib), '-lc10', '-ltorch', '-ltorch_cpu',
             '-ltorch_python'))


def build_key(sources, flags, libs=(), csrc=CSRC):
    """The 16 hex digits that name a build: a hash of the ``sources`` (paths
    relative to ``csrc``, or absolute), of every file they include with
    ``#include "..."`` that exists beside the including file, transitively
    (each by name and bytes, so an edit to a header alone builds anew), and
    of the flags and libraries."""
    h = hashlib.sha256()
    todo, seen = [csrc / s for s in sources], set()
    while todo:
        path = todo.pop(0).resolve()
        if path in seen:
            continue
        seen.add(path)
        data = path.read_bytes()
        h.update(path.name.encode() + b'\0' + data + b'\0')
        todo += [path.parent / m.decode() for m in _INCLUDE.findall(data)
                 if (path.parent / m.decode()).is_file()]
    h.update(' '.join(tuple(flags) + tuple(libs)).encode())
    return h.hexdigest()[:16]


def build(name, sources, flags, libs=()):
    """``build/kaolin_tpu_torch/lib<name>_<key>.so`` from ``sources`` (paths
    relative to ``csrc/``, or absolute) by one nvcc call with ``flags``
    (``libs`` after the sources, where the linker looks for them), unless
    already built (:func:`build_key`); nvcc's output goes to
    ``BUILD_LOG[name]``."""
    srcs = [CSRC / s for s in sources]
    out = BUILD_DIR / f'lib{name}_{build_key(sources, flags, libs)}.so'
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *flags, '-o', tmp, *map(str, srcs),
                               *libs], capture_output=True, text=True)
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed to build '
                               f'{", ".join(map(str, sources))}:\n'
                               f'{BUILD_LOG[name]}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _lock(name):
    with _LOCK:
        return _LOCKS.setdefault(name, threading.Lock())


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first use.

    Thread-safe; calls for different sources build them in parallel.
    """
    with _lock(name):
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(build(name, [f'{name}.cu'],
                                                NVCC_FLAGS)))
        return _LIBS[name]


def load_module(name):
    """The extension module ``name``: ``csrc/<name>.cu`` and
    ``csrc/<name>_module.cpp`` (which defines ``PyInit_<name>``), built on
    first use into ``lib<name>_module_<hash>.so`` and imported.  Its entry
    points take tensors and do a PyTorch op's host work in C++.

    Thread-safe; once loaded, a dict lookup without a lock, so the kernel
    wrappers call it at every launch.  The module is not put in
    ``sys.modules``.
    """
    module = _MODULES.get(name)
    if module is not None:
        return module
    with _lock(f'{name}_module'):
        if name not in _MODULES:
            flags, libs = _module_flags()
            path = build(f'{name}_module',
                         [f'{name}.cu', f'{name}_module.cpp'],
                         NVCC_FLAGS + flags, libs)
            spec = importlib.util.spec_from_file_location(name, path)
            module = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(module)
            _MODULES[name] = module
        return _MODULES[name]


def stream_getter():
    """A function of a CUDA device index that gives PyTorch's current stream
    there as an ``int`` handle (the capture stream under
    ``torch.cuda.graph``): ``torch._C._cuda_getCurrentRawStream``, the call
    Triton's launcher makes, where this torch has it, else
    ``torch.cuda.current_stream(index).cuda_stream``."""
    raw = getattr(torch._C, '_cuda_getCurrentRawStream', None)
    if raw is not None:
        return raw
    return lambda index: torch.cuda.current_stream(index).cuda_stream
