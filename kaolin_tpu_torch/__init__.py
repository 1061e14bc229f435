"""kaolin_tpu_torch — the PyTorch + CUDA port of ``kaolin_tpu``.

The JAX package ``kaolin_tpu`` is the reference; this package mirrors its
module tree and names so every port file has exactly one counterpart.  It
imports ``torch`` and never ``jax``.

Compute path: plain PyTorch with autograd, plus hand-written CUDA C++
kernels for Hopper (``csrc/``) where the JAX package had a Pallas kernel.
Each kernel keeps a plain PyTorch version of the same function beside its
wrapper: the wrapper runs that version for tensors on the CPU, and launches
the kernel (or raises) for tensors on a CUDA device.

Ported so far: slice 1, the DIB-R inverse-rendering step
(:mod:`kaolin_tpu_torch.models.inverse_render`) and everything it calls;
slice 2, the SPC pipeline from a triangle mesh to a level-L octree
(:mod:`kaolin_tpu_torch.ops.spc`, :mod:`kaolin_tpu_torch.ops.conversions`,
:mod:`kaolin_tpu_torch.rep`) and its coherent and BFS ray traces
(:mod:`kaolin_tpu_torch.render.spc`).
"""

__version__ = "0.1.0"

from kaolin_tpu_torch import metrics  # noqa: F401
from kaolin_tpu_torch import ops  # noqa: F401
from kaolin_tpu_torch import render  # noqa: F401
from kaolin_tpu_torch import rep  # noqa: F401
from kaolin_tpu_torch import utils  # noqa: F401
