"""Spc: batched structured point cloud (octree) container.

Port of ``kaolin_tpu/rep/spc.py``: packed octree bytes plus their scan
products (max_level, pyramids, exsum) and point hierarchies, computed
lazily on first access on the octrees' device: the device of a tensor
``octrees``, else ``device``, else the card.
"""

import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['Spc']


class Spc:
    """Batched octree container.

    Args:
        octrees: packed uint8 bytes of all octrees (tensor on any device).
        lengths: (B,) bytes per octree (host values).
        max_level / pyramids / exsum / point_hierarchies: optional
            precomputed scan products (computed lazily otherwise).
        features: optional packed per-point features at the deepest level.
        device: where the octrees live (default: the device of a tensor
            ``octrees``, the card for a numpy one).
    """

    KEYS = {'octrees', 'lengths', 'max_level', 'pyramids', 'exsum',
            'point_hierarchies'}

    def __init__(self, octrees, lengths, max_level=None, pyramids=None,
                 exsum=None, point_hierarchies=None, features=None,
                 device=None):
        self.octrees = torch.as_tensor(octrees,
                                       device=entry_device(device, octrees))
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
    def from_features(cls, feature_grids, masks=None, device=None):
        """Build from dense (B, C, X, Y, Z) feature grids (see
        :func:`~kaolin_tpu_torch.ops.spc.feature_grids_to_spc`), with the
        occupied voxels' features as ``features``."""
        from kaolin_tpu_torch.ops.spc import feature_grids_to_spc
        octrees, lengths, features = feature_grids_to_spc(
            feature_grids, masks, device=device)
        return cls(octrees=octrees, lengths=lengths, features=features)

    @classmethod
    def make_dense(cls, level, batch_size=1, device=None):
        """A batch of fully dense octrees of ``level`` on ``device``
        (default: the card)."""
        from kaolin_tpu_torch.ops.spc import create_dense_spc
        octree, length = create_dense_spc(level, device=device)
        return cls(octrees=octree.repeat(batch_size),
                   lengths=length.repeat(batch_size))

    @classmethod
    def from_list(cls, octrees_list, device=None):
        """Build from a list of single octree byte tensors or arrays, on
        ``device`` (default: the device of the first tensor, the card for
        arrays)."""
        device = entry_device(device, *octrees_list)
        lengths = [len(o) for o in octrees_list]
        octrees = torch.cat([torch.as_tensor(o, dtype=torch.uint8,
                                             device=device)
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

    def to_dense(self, input=None, level=-1):
        """Densify features (default: ``self.features``) into a
        (B, C, 2^l, 2^l, 2^l) grid (see :func:`~kaolin_tpu_torch.ops.spc.
        to_dense`)."""
        from kaolin_tpu_torch.ops.spc import to_dense
        feats = input if input is not None else self.features
        return to_dense(self.point_hierarchies, self.pyramids, feats, level)

    def __repr__(self):
        return (f"Spc of {len(self)} octrees, "
                f"num_bytes={int(self.lengths.sum())}")
