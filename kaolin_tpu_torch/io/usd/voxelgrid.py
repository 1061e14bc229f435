"""USD voxelgrid import/export (stored as PointInstancer-style occupancy).

Port of ``kaolin_tpu/io/usd/voxelgrid.py``: a voxelgrid is stored as the
integer coordinates of its occupied voxels plus the grid resolution.
Writers take tensors on any device; importers return bool tensors on the
card unless asked for another device.
"""

import os

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.io.usd.mesh import (_check_text_usd, _np, _open_stage,
                                          _sample, _setter, _stage,
                                          create_stage, get_scene_paths)

__all__ = ['import_voxelgrid', 'import_voxelgrids', 'add_voxelgrid',
           'export_voxelgrid', 'export_voxelgrids']


def add_voxelgrid(stage, voxelgrid, scene_path, time=None):
    """Add a voxelgrid prim to a stage."""
    prim = stage.define_prim(scene_path, 'PointInstancer')
    occ = _np(voxelgrid).astype(bool)
    coords = np.stack(np.nonzero(occ), axis=-1).astype(np.int64)
    _setter(prim, time)('positions', coords)
    prim.attrs['gridResolution'] = int(occ.shape[0])
    return prim


def export_voxelgrid(file_path, voxelgrid,
                     scene_path='/World/VoxelGrids/voxelgrid_0', time=None):
    """Export one voxelgrid to USD(A)."""
    return export_voxelgrids(file_path, [voxelgrid], [scene_path],
                             times=None if time is None else [time])


def export_voxelgrids(file_path, voxelgrids, scene_paths=None, times=None):
    """Export voxelgrids to one USD(A) file (added to the file's stage
    when it exists)."""
    _check_text_usd(file_path)
    stage = (_open_stage(file_path) if os.path.exists(file_path)
             else create_stage(file_path))
    if scene_paths is None:
        scene_paths = [f'/World/VoxelGrids/voxelgrid_{i}'
                       for i in range(len(voxelgrids))]
    for i, (vg, sp) in enumerate(zip(voxelgrids, scene_paths)):
        add_voxelgrid(stage, vg, sp,
                      time=None if times is None else times[i])
    stage.save(file_path)
    return stage


def import_voxelgrid(file_path_or_stage, scene_path, time=None, device=None):
    """Import one voxelgrid onto ``device`` (default: the card)."""
    return import_voxelgrids(file_path_or_stage, [scene_path], time=time,
                             device=device)[0]


def import_voxelgrids(file_path_or_stage, scene_paths=None, time=None,
                      device=None):
    """Import all (or selected) voxelgrids as ``(R, R, R)`` bool tensors
    on ``device`` (default: the card)."""
    device = entry_device(device)
    stage = _stage(file_path_or_stage)
    if scene_paths is None:
        scene_paths = get_scene_paths(stage, prim_types='PointInstancer')
    out = []
    for sp in scene_paths:
        prim = stage.get_prim(sp)
        if prim is None:
            raise ValueError(f'scene path {sp!r} not found')
        res = int(prim.attrs.get('gridResolution', 0))
        coords = np.asarray(_sample(prim.attrs.get('positions'), time),
                            dtype=np.int64).reshape(-1, 3)
        if res == 0:
            res = int(coords.max()) + 1 if coords.size else 1
        grid = np.zeros((res, res, res), dtype=bool)
        grid[coords[:, 0], coords[:, 1], coords[:, 2]] = True
        out.append(torch.as_tensor(grid, device=device))
    return out
