"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface.  :func:`load` compiles
it with ``nvcc`` for Hopper (``sm_90a``) into ``build/kaolin_tpu_torch/``
at the root of the checkout, keyed by a hash of the sources, every header
of ``csrc/`` (``*.cuh`` and ``*.h``, which the sources include) and the
flags (:func:`build_key`), and opens the shared library with ``ctypes``.
Nothing there includes PyTorch's headers, so a build takes seconds, not
minutes.

:func:`load_module` builds ``csrc/<name>.cu`` with ``csrc/<name>_module.cpp``,
Python entry points that include only PyTorch's tensor and Python-binding
headers (seconds more, not the minutes of ``torch/extension.h``), and
imports the result as an extension module: a launch then costs the host
what a PyTorch op costs.  :func:`stream_getter` gives the current stream
as an integer.

There is no fallback: when ``nvcc`` cannot be found or the build fails,
:func:`load` and :func:`load_module` raise.
"""

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
import threading
from pathlib import Path

import torch

__all__ = ['find_nvcc', 'build_key', 'load', 'load_module', 'stream_getter',
           'BUILD_LOG']

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
    """The 16 hex digits that name a build: a hash of the ``sources`` (in
    ``csrc``), of every header ``csrc/*.cuh`` and ``csrc/*.h`` (by name and
    bytes, so an edit to a header alone builds anew) and of the flags and
    libraries."""
    h = hashlib.sha256()
    headers = sorted([*csrc.glob('*.cuh'), *csrc.glob('*.h')])
    for path in [csrc / s for s in sources] + headers:
        h.update(path.name.encode() + b'\0' + path.read_bytes() + b'\0')
    h.update(' '.join(tuple(flags) + tuple(libs)).encode())
    return h.hexdigest()[:16]


def _build(name, sources, flags, libs=()):
    """``build/kaolin_tpu_torch/lib<name>_<key>.so`` from ``sources`` (in
    ``csrc/``) by one nvcc call with ``flags`` (``libs`` after the sources,
    where the linker looks for them), unless already built
    (:func:`build_key`)."""
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
                               f'{", ".join(sources)}:\n{BUILD_LOG[name]}')
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
            _LIBS[name] = ctypes.CDLL(str(_build(name, [f'{name}.cu'],
                                                 NVCC_FLAGS)))
        return _LIBS[name]


def load_module(name):
    """The extension module ``name``: ``csrc/<name>.cu`` and
    ``csrc/<name>_module.cpp`` (which defines ``PyInit_<name>``), built on
    first use into ``lib<name>_module_<hash>.so`` and imported.  Its entry
    points take tensors and do a PyTorch op's host work in C++.

    Thread-safe; the module is not put in ``sys.modules``.
    """
    with _lock(f'{name}_module'):
        if name not in _MODULES:
            flags, libs = _module_flags()
            path = _build(f'{name}_module',
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
