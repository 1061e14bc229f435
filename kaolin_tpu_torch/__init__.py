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
(:mod:`kaolin_tpu_torch.render.spc`); slice 6, the brute-force ('jnp')
DIB-R backend with the k-buffer soft mask, the OBJ importer
(:mod:`kaolin_tpu_torch.io`) and :class:`~kaolin_tpu_torch.rep.SurfaceMesh`,
the DefTet renderer (:mod:`kaolin_tpu_torch.render.mesh.deftet`) and the
tetmesh ops, losses and marching tetrahedra; slice 7, the rest of the SPC
ops (query, dense grids, dual, trinkets, trilinear interpolation), the
sparse convolutions (:mod:`kaolin_tpu_torch.ops.spc.convolution`), the
pointcloud and mesh voxel grids and the Camera API
(:mod:`kaolin_tpu_torch.render.camera`); slice 8, lighting, the mesh and
point-cloud metrics, sampling, ``check_sign``, the voxel-grid ops and
marching cubes; slice 9, the native host layer
(:mod:`kaolin_tpu_torch._native`: the triangle hash, MISE and the OBJ
tokenizer, C++ built with ``g++`` at first use), USD I/O
(:mod:`kaolin_tpu_torch.io.usd`), OFF, ``sdf_to_voxelgrids``,
:class:`~kaolin_tpu_torch.visualize.Timelapse` and training-state
checkpoints (:mod:`kaolin_tpu_torch.utils.checkpoint`); slice 10, the
datasets (:mod:`kaolin_tpu_torch.io.dataset`, ShapeNet, ModelNet,
SHREC16), synthetic-view import (:mod:`kaolin_tpu_torch.io.render`), the
tensor checkers of :mod:`kaolin_tpu_torch.utils.testing`, the Jupyter
visualizers (:mod:`kaolin_tpu_torch.visualize.ipython`), the dash3d viewer
(:mod:`kaolin_tpu_torch.experimental.dash3d`) and the examples
(:mod:`kaolin_tpu_torch.examples`).
"""

__version__ = "0.1.0"

from kaolin_tpu_torch import io  # noqa: F401
from kaolin_tpu_torch import metrics  # noqa: F401
from kaolin_tpu_torch import ops  # noqa: F401
from kaolin_tpu_torch import render  # noqa: F401
from kaolin_tpu_torch import rep  # noqa: F401
from kaolin_tpu_torch import utils  # noqa: F401
from kaolin_tpu_torch import visualize  # noqa: F401
