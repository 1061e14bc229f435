"""USD stage utilities.

Port of ``kaolin_tpu/io/usd/utils.py``.
"""

from kaolin_tpu_torch.io.usd.mesh import create_stage, get_scene_paths, \
    _open_stage, _stage
from kaolin_tpu_torch.io.usd.usda import TimeSampled

__all__ = ['create_stage', 'get_scene_paths', 'get_authored_time_samples',
           'open_stage']


def open_stage(file_path):
    """Open (or create) a USD(A) stage."""
    return _open_stage(file_path)


def get_authored_time_samples(file_path_or_stage):
    """All time samples authored anywhere in the stage, sorted."""
    times = set()
    for prim in _stage(file_path_or_stage).prims():
        for v in prim.attrs.values():
            if isinstance(v, TimeSampled):
                times.update(v.keys())
    return sorted(times)
