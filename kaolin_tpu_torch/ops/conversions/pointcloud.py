"""Pointcloud conversions: voxel grids and SPC.

Port of ``kaolin_tpu/ops/conversions/pointcloud.py``.  The JAX package builds
the SPC's features on the host with ``np.add.at``; here they are summed on
the points' device with ``index_add_``, in another order.
"""

import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.ops.spc.points import (points_to_morton,
                                             quantize_points,
                                             unbatched_points_to_octree)
from kaolin_tpu_torch.rep.spc import Spc

__all__ = ['pointclouds_to_voxelgrids', 'unbatched_pointcloud_to_spc']


def _base_points_to_voxelgrids(points, resolution):
    """(B, N, 3) points in [0, 1] -> (B, r, r, r) occupancy of the voxels
    at ``round(p * (r - 1))``; points outside the grid set nothing."""
    B = points.shape[0]
    r = resolution
    idx = torch.round(points * (r - 1)).to(torch.int64)
    in_range = ((idx >= 0) & (idx <= r - 1)).all(-1)
    idx = torch.clamp(idx, 0, r - 1)
    b = torch.arange(B, device=points.device)[:, None]
    flat = (((b * r + idx[..., 0]) * r + idx[..., 1]) * r + idx[..., 2])
    vg = points.new_zeros(B * r ** 3).scatter_reduce(
        0, flat.reshape(-1), in_range.reshape(-1).to(points.dtype), 'amax')
    return vg.reshape(B, r, r, r)


def pointclouds_to_voxelgrids(pointclouds, resolution, origin=None,
                              scale=None, return_sparse=False, device=None):
    """Voxelize (B, N, 3) pointclouds into (B, r, r, r) occupancy grids.

    ``origin`` (B, 3) and ``scale`` (B,) normalize the points to [0, 1]
    (default: the bounding box's minimum and its largest extent).
    ``return_sparse`` is accepted and the grid is dense, as in the JAX
    package.  Runs on ``device`` (default: the device of a tensor input,
    the card for a numpy one).
    """
    del return_sparse
    if not isinstance(resolution, int):
        raise TypeError(f"Expected resolution to be int "
                        f"but got {type(resolution)}.")
    pointclouds = torch.as_tensor(pointclouds,
                                  device=entry_device(device, pointclouds))
    if origin is None:
        origin = pointclouds.amin(dim=1)
    if scale is None:
        scale = (pointclouds.amax(dim=1) - origin).amax(dim=1)
    origin = torch.as_tensor(origin, device=pointclouds.device)
    scale = torch.as_tensor(scale, device=pointclouds.device)
    pointclouds = (pointclouds - origin[:, None]) / scale.reshape(-1, 1, 1)
    return _base_points_to_voxelgrids(pointclouds, resolution)


def unbatched_pointcloud_to_spc(pointcloud, level, features=None,
                                device=None):
    """A pointcloud in [-1, 1] to a :class:`~kaolin_tpu_torch.rep.Spc` of
    ``level``, on ``device`` (default: the device of a tensor input, the
    card for a numpy one).  The features of points that land in one voxel
    are averaged into that voxel's row (voxels in morton order)."""
    pointcloud = torch.as_tensor(pointcloud,
                                 device=entry_device(device, pointcloud))
    qpts = quantize_points(pointcloud, level)
    uniq, inv = torch.unique(points_to_morton(qpts), return_inverse=True)
    octree = unbatched_points_to_octree(qpts, level)
    out_features = None
    if features is not None:
        feats = torch.as_tensor(features, device=pointcloud.device)
        n = uniq.shape[0]
        sums = feats.new_zeros((n, feats.shape[-1])).index_add_(0, inv,
                                                                feats)
        counts = torch.bincount(inv, minlength=n)
        out_features = sums / counts[:, None].to(feats.dtype)
    return Spc(octrees=octree, lengths=[octree.shape[0]],
               features=out_features)
