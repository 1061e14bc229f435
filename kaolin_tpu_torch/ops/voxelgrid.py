"""Voxelgrid ops: downsample, surface extraction, fill, ODMs.

Port of ``kaolin_tpu/ops/voxelgrid.py``.  Pooling is ``avg_pool3d`` summing
with zero padding (``divisor_override=1``), then one division by the
window's size, as the JAX package's ``reduce_window`` sum; ``fill`` is
host scipy (a flood fill), as in the JAX package, and returns on the
input's device.
"""

import numpy as np
import torch
import torch.nn.functional as F

from kaolin_tpu_torch._device import entry_device

__all__ = ['downsample', 'extract_surface', 'fill', 'extract_odms',
           'project_odms']


def _avg_pool3d(x, kernel, stride=None, padding=0):
    """Mean pooling over the last 3 dims of (B, X, Y, Z), zeros outside."""
    if isinstance(kernel, int):
        kernel = (kernel,) * 3
    if stride is None:
        stride = kernel
    elif isinstance(stride, int):
        stride = (stride,) * 3
    if isinstance(padding, int):
        padding = (padding,) * 3
    summed = F.avg_pool3d(x[:, None], tuple(kernel), tuple(stride),
                          tuple(padding), divisor_override=1)[:, 0]
    return summed / float(np.prod(kernel))


def downsample(voxelgrids, scale):
    """Downsample voxelgrids by average pooling (not thresholded)."""
    if voxelgrids.ndim != 4:
        raise ValueError(
            f"Expected voxelgrids to have 4 dimensions but got "
            f"{voxelgrids.ndim}")
    if isinstance(scale, (list, tuple)):
        if len(scale) != 3:
            raise ValueError(
                f"Expected scale to have 3 dimensions but got {len(scale)}")
        for i, s in enumerate(scale):
            if s < 1:
                raise ValueError(
                    f"Downsample ratio must be at least 1 along every "
                    f"dimension but got {s} at index {i}")
            if s > voxelgrids.shape[i + 1]:
                raise ValueError(
                    f"Downsample ratio must be less than voxelgrids shape "
                    f"of {voxelgrids.shape[i + 1]} at index {i}, but got "
                    f"{s}")
    return _avg_pool3d(voxelgrids.to(torch.float32), scale)


def extract_surface(voxelgrids, mode="wide"):
    """Remove internal voxels, keeping only the surface shell."""
    if voxelgrids.ndim != 4:
        raise ValueError(
            f"Expected voxelgrids to have 4 dimensions but got "
            f"{voxelgrids.ndim}")
    occ = voxelgrids.bool()
    x = voxelgrids.to(torch.float32)
    if mode == "wide":
        pooled = _avg_pool3d(x, (3, 3, 3), stride=1, padding=1)
        return (pooled < 1) & occ
    elif mode == "thin":
        px = _avg_pool3d(x, (3, 1, 1), stride=1, padding=(1, 0, 0))
        py = _avg_pool3d(x, (1, 3, 1), stride=1, padding=(0, 1, 0))
        pz = _avg_pool3d(x, (1, 1, 3), stride=1, padding=(0, 0, 1))
        return ((px < 1) | (py < 1) | (pz < 1)) & occ
    raise ValueError(f'mode "{mode}" is not supported.')


def fill(voxelgrids, device=None):
    """Fill internal holes (a host flood fill; not differentiable).

    Returns:
        ``(B, X, Y, Z)`` bool on ``device`` (default: the device of a
        tensor ``voxelgrids``, else the card).
    """
    if voxelgrids.ndim != 4:
        raise ValueError(
            f"Expected voxelgrids to have 4 dimensions but got "
            f"{voxelgrids.ndim}")
    device = entry_device(device, voxelgrids)
    from scipy import ndimage
    arr = np.asarray(torch.as_tensor(voxelgrids).cpu()).astype(bool)
    out = np.stack([ndimage.binary_fill_holes(a) for a in arr])
    return torch.as_tensor(out, device=device)


def extract_odms(voxelgrids):
    """The 6 orthographic depth maps of binary voxelgrids.

    Face order: z_neg, z_pos, y_neg, y_pos, x_neg, x_pos.

    Returns:
        ``(N, 6, dim, dim)`` int32 depths.
    """
    occ = voxelgrids.bool()
    dim = occ.shape[-1]
    dev = occ.device
    mult = torch.arange(1, dim + 1, device=dev)
    rev = torch.arange(dim, 0, -1, device=dev)
    full = torch.stack([mult, rev])  # (2, dim)

    z_vals = (occ[:, None] * full.reshape(1, 2, 1, 1, dim)).amax(dim=4)
    y_vals = (occ[:, None] * full.reshape(1, 2, 1, dim, 1)).amax(dim=3)
    x_vals = (occ[:, None] * full.reshape(1, 2, dim, 1, 1)).amax(dim=2)
    return (dim - torch.cat([z_vals, y_vals, x_vals], dim=1)).to(
        torch.int32)


def project_odms(odms, voxelgrids=None, votes=1):
    """Carve voxelgrids with orthographic depth maps: a voxel survives if
    fewer than ``votes`` of the six ODMs mark it empty."""
    if odms.shape[1] != 6:
        raise ValueError(
            f"Expected odms' second dimension to be 6, but got "
            f"{odms.shape[1]}")
    batch_size = odms.shape[0]
    dim = odms.shape[-1]
    dev = odms.device
    if voxelgrids is None:
        voxelgrids = torch.ones((batch_size, dim, dim, dim),
                                dtype=torch.bool, device=dev)
    else:
        if voxelgrids.shape[0] != batch_size:
            raise ValueError(
                f"Expected voxelgrids and odms' batch size to be the same, "
                f"but got {batch_size} for odms and {voxelgrids.shape[0]}")
        for i in voxelgrids.shape[1:]:
            if i != dim:
                raise ValueError(
                    f"Expected voxelgrids and odms' dimension size to be "
                    f"the same, but got {dim} for odms and {i} for "
                    f"voxelgrid")
    od = odms.reshape(batch_size, 3, 2, dim, dim).clone()
    od[:, :, 0] = dim - od[:, :, 0]
    od = od.reshape(batch_size, 6, dim, dim)
    base = torch.arange(dim, device=dev)

    def count(shape, o, lower):
        b = base.reshape(shape)
        return (b >= o if lower else b < o).to(torch.int32)

    total = (count((1, 1, 1, dim), od[:, 0][..., None], True)
             + count((1, 1, 1, dim), od[:, 1][..., None], False)
             + count((1, 1, dim, 1), od[:, 2][..., None, :], True)
             + count((1, 1, dim, 1), od[:, 3][..., None, :], False)
             + count((1, dim, 1, 1), od[:, 4][:, None], True)
             + count((1, dim, 1, 1), od[:, 5][:, None], False))
    return (voxelgrids.to(torch.int32) * votes - total) > 0
