"""Timelapse: 3D training checkpoints as time-sampled USD files.

Port of ``kaolin_tpu/visualize/timelapse.py``.  Each (category, id) pair
gets its own ``.usda`` file with one time sample per training iteration;
viewers (dash3d, Omniverse) read them back via :class:`TimelapseParser`.
The writers take tensors on any device and write the same files as the JAX
package's :class:`Timelapse` for the same values.
"""

import glob
import os

from kaolin_tpu_torch.io import usd as usd_io
from kaolin_tpu_torch.io.usd.usda import TimeSampled, UsdaStage

__all__ = ['Timelapse', 'TimelapseParser']


class Timelapse:
    """Write 3D checkpoints (meshes / pointclouds / voxelgrids) over
    time."""

    def __init__(self, log_dir, up_axis='Y'):
        self.logdir = log_dir
        os.makedirs(self.logdir, exist_ok=True)
        self.up_axis = up_axis

    def _validate_batch(self, *batches):
        sizes = [len(b) for b in batches if b is not None]
        assert len(set(sizes)) <= 1, \
            f"all batches must have the same length, got {sizes}"
        return sizes[0] if sizes else 0

    def _get_path(self, category, subdirectory):
        out_dir = os.path.join(self.logdir, subdirectory) \
            if subdirectory else self.logdir
        os.makedirs(out_dir, exist_ok=True)
        return out_dir

    def add_mesh_batch(self, iteration=0, category='', vertices_list=None,
                       faces_list=None, uvs_list=None, face_uvs_idx_list=None,
                       face_normals_list=None, materials_list=None):
        """Add a batch of meshes at a training iteration."""
        n = self._validate_batch(vertices_list, faces_list, uvs_list,
                                 face_uvs_idx_list, face_normals_list)
        out_dir = self._get_path(category, category)

        def get(lst, i):
            return None if lst is None else lst[i]

        for i in range(n):
            path = os.path.join(out_dir, f'mesh_{i}.usda')
            usd_io.export_mesh(
                path, scene_path=f'/mesh_{i}',
                vertices=get(vertices_list, i), faces=get(faces_list, i),
                uvs=get(uvs_list, i),
                face_uvs_idx=get(face_uvs_idx_list, i),
                face_normals=get(face_normals_list, i),
                time=iteration)

    def add_pointcloud_batch(self, iteration=0, category='',
                             pointcloud_list=None, colors_list=None,
                             points_type='point_instancer',
                             semantic_ids=None):
        """Add a batch of pointclouds at a training iteration."""
        n = self._validate_batch(pointcloud_list, colors_list)
        out_dir = self._get_path(category, category)
        for i in range(n):
            path = os.path.join(out_dir, f'pointcloud_{i}.usda')
            usd_io.export_pointclouds(
                path, [pointcloud_list[i]], [f'/pointcloud_{i}'],
                colors=None if colors_list is None else [colors_list[i]],
                times=[iteration])

    def add_voxelgrid_batch(self, iteration=0, category='',
                            voxelgrid_list=None, semantic_ids=None):
        """Add a batch of voxelgrids at a training iteration."""
        n = self._validate_batch(voxelgrid_list)
        out_dir = self._get_path(category, category)
        for i in range(n):
            path = os.path.join(out_dir, f'voxelgrid_{i}.usda')
            usd_io.export_voxelgrids(
                path, [voxelgrid_list[i]], [f'/voxelgrid_{i}'],
                times=[iteration])


class TimelapseParser:
    """Index and read back a Timelapse log directory."""

    def __init__(self, logdir):
        self.logdir = logdir
        self.dir_info = {'mesh': None, 'pointcloud': None,
                         'voxelgrid': None}
        self.parse()

    @staticmethod
    def get_parsed_bundle_path(bundle):
        return bundle['file']

    def parse(self):
        """Scan the log directory for checkpoint files."""
        for typ in self.dir_info:
            pattern = os.path.join(self.logdir, '**', f'{typ}_*.usda')
            files = sorted(glob.glob(pattern, recursive=True))
            bundles = []
            for f in files:
                rel = os.path.relpath(f, self.logdir)
                category = os.path.dirname(rel).replace(os.sep, '/')
                name = os.path.basename(f)
                idx = int(name[len(typ) + 1:-len('.usda')])
                bundles.append({'file': f, 'category': category, 'id': idx})
            self.dir_info[typ] = bundles
        return self.dir_info

    def num_mesh_categories(self):
        return len({b['category'] for b in self.dir_info['mesh']})

    def num_mesh_items(self):
        return len(self.dir_info['mesh'])

    def num_pointcloud_categories(self):
        return len({b['category'] for b in self.dir_info['pointcloud']})

    def num_pointcloud_items(self):
        return len(self.dir_info['pointcloud'])

    def num_voxelgrid_items(self):
        return len(self.dir_info['voxelgrid'])

    def get_file_path(self, type, category, id):
        for b in self.dir_info.get(type, []):
            if b['category'] == category and b['id'] == int(id):
                return b['file']
        return None

    def get_timestamps(self, type, category, id):
        """All time samples available in a checkpoint file."""
        path = self.get_file_path(type, category, id)
        if path is None:
            return []
        stage = UsdaStage.load(path)
        times = set()
        for prim in stage.prims():
            for v in prim.attrs.values():
                if isinstance(v, TimeSampled):
                    times.update(v.keys())
        return sorted(times)
