"""Spc: batched structured point cloud (octree) container.

Port of ``kaolin_tpu/rep/spc.py``: packed octree bytes plus their scan
products (max_level, pyramids, exsum) and point hierarchies, computed
lazily on first access on the octrees' device.
"""

import torch

__all__ = ['Spc']


class Spc:
    """Batched octree container.

    Args:
        octrees: packed uint8 bytes of all octrees (tensor on any device).
        lengths: (B,) bytes per octree (host values).
        max_level / pyramids / exsum / point_hierarchies: optional
            precomputed scan products (computed lazily otherwise).
        features: optional packed per-point features at the deepest level.
    """

    KEYS = {'octrees', 'lengths', 'max_level', 'pyramids', 'exsum',
            'point_hierarchies'}

    def __init__(self, octrees, lengths, max_level=None, pyramids=None,
                 exsum=None, point_hierarchies=None, features=None):
        self.octrees = torch.as_tensor(octrees)
        self.lengths = torch.as_tensor(lengths).cpu().to(torch.int32)
        self._max_level = max_level
        self._pyramids = pyramids
        self._exsum = exsum
        self._point_hierarchies = point_hierarchies
        self.features = features

    def _apply_scan_octrees(self):
        from kaolin_tpu_torch.ops.spc import scan_octrees
        self._max_level, self._pyramids, self._exsum = scan_octrees(
            self.octrees, self.lengths)

    @property
    def max_level(self):
        if self._max_level is None:
            self._apply_scan_octrees()
        return self._max_level

    @property
    def pyramids(self):
        if self._pyramids is None:
            self._apply_scan_octrees()
        return self._pyramids

    @property
    def exsum(self):
        if self._exsum is None:
            self._apply_scan_octrees()
        return self._exsum

    @property
    def point_hierarchies(self):
        if self._point_hierarchies is None:
            from kaolin_tpu_torch.ops.spc import generate_points
            self._point_hierarchies = generate_points(
                self.octrees, self.pyramids, self.exsum)
        return self._point_hierarchies

    @classmethod
    def from_list(cls, octrees_list):
        """Build from a list of single octree byte tensors."""
        lengths = [len(o) for o in octrees_list]
        octrees = torch.cat([torch.as_tensor(o, dtype=torch.uint8)
                             for o in octrees_list])
        return cls(octrees=octrees, lengths=lengths)

    def __len__(self):
        return self.lengths.shape[0]

    @property
    def batch_size(self):
        return self.lengths.shape[0]

    def num_points(self, lod: int):
        """Number of points at a level of detail, per octree."""
        return self.pyramids[:, 0, lod]

    def to_dict(self, keys=None):
        if keys is None:
            keys = self.KEYS
        return {k: getattr(self, k) for k in keys}

    def __repr__(self):
        return (f"Spc of {len(self)} octrees, "
                f"num_bytes={int(self.lengths.sum())}")
