"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` exposes a plain C interface.  :func:`load` compiles
it with ``nvcc`` for Hopper (``sm_90a``) into ``build/kaolin_tpu_torch/``
at the root of the checkout, keyed by a hash of the source and the flags,
and opens the shared library with ``ctypes``.  Nothing here includes
PyTorch's headers, so a build takes seconds, not minutes.

There is no fallback: when ``nvcc`` cannot be found or the build fails,
:func:`load` raises.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

__all__ = ['find_nvcc', 'load', 'BUILD_LOG']

CSRC = Path(__file__).resolve().parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / 'build' / 'kaolin_tpu_torch'
# -fmad=false: no a*b+c contraction, so the kernels round each product and
# sum as the plain PyTorch versions do (parity up to summation order)
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-fmad=false',
              '-Xptxas=-v')

BUILD_LOG = {}          # name -> nvcc output (registers, shared memory)
_LIBS = {}
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


def _build(name):
    src = CSRC / f'{name}.cu'
    code = src.read_bytes()
    digest = hashlib.sha256(code + ' '.join(NVCC_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f'lib{name}_{digest[:16]}.so'
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, '-o', tmp, str(src)],
                              capture_output=True, text=True)
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed to build {src.name}:\n'
                               f'{BUILD_LOG[name]}')
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def load(name):
    """The ``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_build(name)))
        return _LIBS[name]
