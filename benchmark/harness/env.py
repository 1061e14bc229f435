"""The run's environment: where caches go, which cards there are, and what
may not be loaded.

Every build and kernel cache of the program lies at a fixed path inside
the checkout (``build/``): the port builds its extensions into
``build/kaolin_tpu_torch/`` itself, and :func:`pin_caches` points Triton's
and PyTorch's extension caches at ``build/benchmark/``.  Nothing is written
to a fixed path outside the checkout; what the run needs besides goes
under ``TMPDIR``.
"""

import os
import subprocess
import sys
from pathlib import Path

__all__ = ['ROOT', 'CACHE', 'FORBIDDEN', 'NoCard', 'pin_caches',
           'forbidden_modules', 'require_cards', 'card_info']

ROOT = Path(__file__).resolve().parents[2]          # the checkout
CACHE = ROOT / 'build' / 'benchmark'
# the JAX package and what it runs on: compared by whole top-level name
# (the port's own name begins with the JAX package's)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'kaolin_tpu')


class NoCard(RuntimeError):
    """The cards a cell asks for are not there; the run prints no result."""


def pin_caches():
    """Point every kernel cache at a fixed directory inside the checkout.
    Call before torch is imported."""
    os.environ['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE / 'torch_extensions')
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules(modules=None):
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``), sorted."""
    names = {m.split('.')[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def require_cards(n):
    """Raise :class:`NoCard` unless CUDA has at least ``n`` cards.  There is
    no fallback to the CPU."""
    import torch
    if not torch.cuda.is_available():
        raise NoCard('torch.cuda.is_available() is False: the benchmark '
                     'measures CUDA cards and does not run on the CPU')
    found = torch.cuda.device_count()
    if found < n:
        raise NoCard(f'the cell asks for {n} cards, torch.cuda.device_count()'
                     f' is {found}')


def card_info():
    """``nvidia-smi``'s name and power limit of each card, one string each
    (empty where nvidia-smi cannot be run): the peaks a share is taken
    against assume the full power limit."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.stdout.splitlines() if line.strip()]
