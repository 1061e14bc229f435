"""SDF -> voxelgrid conversion (MISE multiresolution extraction).

Port of ``kaolin_tpu/ops/conversions/sdf.py``, its native path: the MISE
octree (:class:`kaolin_tpu_torch._native.Mise`, the JAX package's
``csrc/mise.cpp``) runs on the host by design, and only the SDF
evaluations go to the entry device, one tensor per batch of query points.
There is no other refinement: the JAX package's numpy refinement is its
fallback when the native library is missing, and this package raises
instead.
"""

import numpy as np
import torch

from kaolin_tpu_torch import _native
from kaolin_tpu_torch._device import entry_device

__all__ = ['sdf_to_voxelgrids']


def _eval_sdf(sdf_fn, pts_np, bbox_center, bbox_dim, device):
    """sdf_fn at the normalised grid points ``pts_np`` (float64, [0, 1]),
    mapped into the box in float64 on the host and cast to float32."""
    coords = (pts_np - 0.5) * bbox_dim + bbox_center
    vals = sdf_fn(torch.as_tensor(coords.astype(np.float32), device=device))
    return torch.as_tensor(vals).detach().cpu().numpy()


def _unbatched_sdf_to_voxelgrid(sdf_fn, bbox_center, bbox_dim, init_res,
                                upsampling_steps, device):
    m = _native.Mise(init_res, upsampling_steps)
    while True:
        pts = m.query()
        if pts.shape[0] == 0:
            if not m.refine():
                break
            continue
        vals = _eval_sdf(sdf_fn, pts / m.final_resolution, bbox_center,
                         bbox_dim, device)
        m.update((vals <= 0).astype(np.uint8))
    return m.to_dense().astype(np.float32)


def sdf_to_voxelgrids(sdf, bbox_center=0., bbox_dim=1., init_res=32,
                      upsampling_steps=0, device=None):
    """Convert SDF callables to binary voxelgrids of resolution
    ``init_res * 2**upsampling_steps + 1``.

    Args:
        sdf: list of callables mapping an (N, 3) float32 tensor of
            coordinates on ``device`` to (N,) sdf values.
        bbox_center / bbox_dim: bounding box of the surface.
        init_res: initial grid resolution.
        upsampling_steps: number of refinement doublings.
        device: where the query points go and the grids are returned
            (default: the card, see
            :func:`~kaolin_tpu_torch._device.entry_device`).

    Returns:
        ``(B, R, R, R)`` float32 grids with R = init_res * 2**steps + 1;
        value 1 where sdf <= 0.
    """
    if not isinstance(sdf, list):
        raise TypeError(f"Expected sdf to be list but got {type(sdf)}.")
    for i, s in enumerate(sdf):
        if not callable(s):
            raise TypeError(f"Expected sdf[{i}] to be callable.")
    device = entry_device(device)
    out = [_unbatched_sdf_to_voxelgrid(s, bbox_center, bbox_dim, init_res,
                                       upsampling_steps, device) for s in sdf]
    return torch.as_tensor(np.stack(out), device=device)
