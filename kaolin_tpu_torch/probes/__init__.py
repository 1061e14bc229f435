"""Probes of kernel K3 and of the card: the port of the TPU probe scripts.

The JAX package's ``scripts/probe_r5_*.py`` asked, on the TPU, what Mosaic
could compile for the trace kernel K3, what each stage of it and of the
coherent trace costs, and what one grid step costs.  Each module here asks
the same of the CUDA port, with the scripts' names and inputs:

* :mod:`.mosaic3` (``probe_r5_mosaic3.py``, P1): kernels kA..kH, loops with
  a bound read at run time, table rows staged in shared memory by the copy
  engine or loaded into registers (also at K3's staging shape), lane and
  row shifts;
* :mod:`.stages` (``probe_r5_stages.py``, P2): an elementwise kernel over
  (8, 128) steps beside ``torch.mul``, and the coherent trace of the SPC
  cell by stage (culling candidates, block order, input gathers, the whole
  trace, output fills);
* :mod:`.kbisect` (``probe_r5_kbisect.py``, P3): K3 cut at six stages
  (:func:`~kaolin_tpu_torch.render.spc._trace.trace_staged`), on the
  script's inputs, a scene with hits and the SPC cell.

:mod:`.k1_clocks` has no TPU counterpart: it reads the per-CTA clocks of
the forward kernel K1 at the DIB-R cell from an instrumented copy of its
source, on the card only.  :mod:`.p2_designs` times the designs of P2
that the port weighed against its kernel and ``torch.mul``, on the card
only.

Each has ``run(device)``: it checks every kernel against its plain version
and, on CUDA, returns device times (CUDA events, mean after warm-up; P1's
and P2's also without the host, from a CUDA graph) with each function's
bound, from :mod:`kaolin_tpu_torch.utils.measure` as
``chip_smoke.py`` takes them.  On the CPU it runs the plain versions at a
small size and times nothing.  ``python -m kaolin_tpu_torch.probes.<name>``
runs it on the card and prints one JSON object.
"""

import json

import numpy as np
import torch

from kaolin_tpu_torch.ops.conversions.trianglemesh import (
    unbatched_mesh_to_spc_device)
from kaolin_tpu_torch.ops.spc import generate_points, scan_octrees
from kaolin_tpu_torch.render.spc.raster import _block_order, build_cell_table
from kaolin_tpu_torch.utils.measure import card
from kaolin_tpu_torch.utils.testing import camera_grid, uv_sphere

__all__ = ['SPC_CELL', 'spc_cell', 'same_bits', 'max_abs_err', 'seeded',
           'main']

# the SPC cell of chip_smoke.py (BASELINE config #3 on the sphere), traced
# with utils.measure.TRACE
SPC_CELL = dict(sphere=(100, 51), radius=0.45, level=10, side=1024,
                cell_shift=3, cell_width=192)


def spc_cell(device, level=SPC_CELL['level'], side=SPC_CELL['side'],
             sphere=SPC_CELL['sphere']):
    """The SPC cell: ``uv_sphere`` scaled to radius 0.45 -> device octree at
    ``level`` -> points -> cell table; ``camera_grid(side)`` rays in 4 x 4
    pixel blocks.  Returns dict(octree, ph, pyramid, exsum, table, o, d)."""
    s = uv_sphere(*sphere)
    fv = (s.vertices * SPC_CELL['radius'])[s.faces]
    octree = unbatched_mesh_to_spc_device(fv, level, cap=2 ** 22,
                                          device=device)[0]
    _, pyramids, exsum = scan_octrees(octree, [octree.shape[0]])
    ph = generate_points(octree, pyramids, exsum)
    table = build_cell_table(ph, pyramids[0], level,
                             cell_shift=min(SPC_CELL['cell_shift'], level),
                             cell_width=SPC_CELL['cell_width'])
    o, d = camera_grid(side)
    perm, _ = _block_order(side, side, 4, 4)
    return dict(octree=octree, ph=ph, pyramid=pyramids[0], exsum=exsum,
                table=table, o=torch.as_tensor(o[perm], device=device),
                d=torch.as_tensor(d[perm], device=device))


def _bits(x):
    return x.contiguous().view(torch.int32) if x.is_floating_point() else x


def same_bits(a, b):
    """Tensors, or sequences of tensors, equal bit for bit."""
    if torch.is_tensor(a):
        a, b = (a,), (b,)
    return all(x.shape == y.shape and torch.equal(_bits(x), _bits(y))
               for x, y in zip(a, b))


def max_abs_err(a, b):
    """max |a - b| over the entries finite in both (0 for none)."""
    a, b = a.double(), b.double()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return (a - b)[fin].abs().max().item() if fin.any() else 0.


def seeded(shape, seed, device):
    """A float32 standard normal tensor from a numpy seed."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.as_tensor(x, device=device)


def main(run):
    """Command line of a probe module: run it on the card, print the card
    and one JSON object of results."""
    if not torch.cuda.is_available():
        raise SystemExit('the probes measure the CUDA card, and '
                         'torch.cuda.is_available() is False')
    print(card())
    print(json.dumps(run('cuda')))
