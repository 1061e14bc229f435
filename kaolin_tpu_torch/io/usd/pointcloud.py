"""USD pointcloud import/export (as UsdGeom Points prims).

Port of ``kaolin_tpu/io/usd/pointcloud.py``.  Writers take tensors on any
device; importers return tensors on the card unless asked for another
device.
"""

import os
from collections import namedtuple

import numpy as np
import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.io.usd.usda import TimeSampled
from kaolin_tpu_torch.io.usd.mesh import (_check_text_usd, _np, _open_stage,
                                          _sample, _setter, _stage,
                                          create_stage, get_scene_paths)

__all__ = ['import_pointcloud', 'import_pointclouds', 'add_pointcloud',
           'export_pointcloud', 'export_pointclouds',
           'get_pointcloud_scene_paths',
           'get_pointcloud_bracketing_time_samples']


def add_pointcloud(stage, points, scene_path, colors=None, time=None,
                   points_type='point_instancer'):
    """Add a pointcloud prim (Points) to a stage."""
    prim = stage.define_prim(scene_path, 'Points')
    set_attr = _setter(prim, time)
    set_attr('points', _np(points, np.float32))
    if colors is not None:
        set_attr('primvars:displayColor', _np(colors, np.float32))
    return prim


def export_pointcloud(file_path, pointcloud,
                      scene_path='/World/PointClouds/pointcloud_0',
                      colors=None, time=None, points_type='point_instancer'):
    """Export one pointcloud to USD(A)."""
    return export_pointclouds(file_path, [pointcloud], [scene_path],
                              colors=None if colors is None else [colors],
                              times=None if time is None else [time])


def export_pointclouds(file_path, pointclouds, scene_paths=None, colors=None,
                       times=None, points_type='point_instancer'):
    """Export pointclouds to one USD(A) file (added to the file's stage
    when it exists)."""
    _check_text_usd(file_path)
    stage = (_open_stage(file_path) if os.path.exists(file_path)
             else create_stage(file_path))
    if scene_paths is None:
        scene_paths = [f'/World/PointClouds/pointcloud_{i}'
                       for i in range(len(pointclouds))]
    for i, (pc, sp) in enumerate(zip(pointclouds, scene_paths)):
        add_pointcloud(stage, pc, sp,
                       colors=None if colors is None else colors[i],
                       time=None if times is None else times[i])
    stage.save(file_path)
    return stage


pointcloud_return_type = namedtuple(
    'pointcloud_return_type', ['points', 'colors', 'normals'])


def import_pointcloud(file_path_or_stage, scene_path, time=None,
                      device=None):
    """Import one pointcloud.

    Returns:
        ``pointcloud_return_type(points (N, 3), colors, normals)`` on
        ``device`` (default: the card).
    """
    points, colors, normals = import_pointclouds(
        file_path_or_stage, [scene_path], time=time, device=device)
    return pointcloud_return_type(points[0], colors[0], normals[0])


def import_pointclouds(file_path_or_stage, scene_paths=None, time=None,
                       device=None):
    """Import all (or selected) pointclouds: lists of points, colors and
    normals (None where absent) on ``device`` (default: the card)."""
    device = entry_device(device)
    stage = _stage(file_path_or_stage)
    if scene_paths is None:
        scene_paths = get_scene_paths(stage, prim_types='Points')
    points_out, colors_out, normals_out = [], [], []
    for sp in scene_paths:
        prim = stage.get_prim(sp)
        if prim is None:
            raise ValueError(f'scene path {sp!r} not found')
        for name, out in (('points', points_out),
                          ('primvars:displayColor', colors_out),
                          ('normals', normals_out)):
            v = _sample(prim.attrs.get(name), time)
            out.append(None if v is None else torch.as_tensor(
                np.asarray(v, np.float32), device=device))
    return points_out, colors_out, normals_out


def get_pointcloud_scene_paths(file_path_or_stage):
    """All pointcloud prim paths in a stage."""
    return get_scene_paths(_stage(file_path_or_stage),
                           prim_types=['Points', 'PointInstancer'])


def get_pointcloud_bracketing_time_samples(stage, scene_path, target_time):
    """(lower, upper) authored time samples around target_time."""
    prim = _stage(stage).get_prim(scene_path)
    times = set()
    for v in prim.attrs.values():
        if isinstance(v, TimeSampled):
            times.update(v.keys())
    if not times:
        return (target_time, target_time)
    lower = max([t for t in times if t <= target_time], default=min(times))
    upper = min([t for t in times if t >= target_time], default=max(times))
    return (lower, upper)
