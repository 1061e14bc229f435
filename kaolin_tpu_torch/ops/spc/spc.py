"""SPC core ops: scan, point hierarchy, query, dense grids, dual octree.

Port of ``kaolin_tpu/ops/spc/spc.py``.  The JAX package runs the scan, the
point expansion, the dual and the trinkets in host numpy; here they run on
the octree's own device with a 256-entry popcount table, ``cumsum``,
``nonzero``, ``unique`` and ``searchsorted``, with equal outputs.  Pyramids
stay on the host: their values are shapes.  The query walk is the JAX
package's, one gather of the octree byte, a popcount and an exsum gather per
level, with no host sync inside it.
"""

import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.ops.spc.points import (CORNERS, morton_to_points,
                                             points_to_corners,
                                             points_to_morton,
                                             quantize_points,
                                             unbatched_points_to_octree)
from kaolin_tpu_torch.ops.spc.uint8 import popcount_table, uint8_bits_sum

__all__ = ['scan_octrees', 'generate_points', 'unbatched_get_level_points',
           'unbatched_query', 'to_dense', 'feature_grids_to_spc',
           'unbatched_make_dual', 'unbatched_make_trinkets']

KAOLIN_SPC_MAX_LEVELS = 15  # reference spc_math.h:37


def scan_octrees(octrees, lengths):
    """Popcounts, exclusive sums and pyramids of a batch of octrees.

    Args:
        octrees: packed (num_bytes,) uint8 tensor of all octrees.
        lengths: (B,) bytes per octree (host values).

    Returns:
        (max_level int, pyramids (B, 2, max_level + 2) int32 CPU tensor —
        ``[b, 0, l]`` points at level l, ``[b, 1, l]`` their prefix — and
        exsum (num_bytes + B,) int32 on the octrees' device: per octree a
        leading 0, then the inclusive popcount sum).
    """
    lengths = [int(n) for n in torch.as_tensor(lengths).reshape(-1).tolist()]
    counts = uint8_bits_sum(octrees)
    exsums, pyramids = [], []
    start = 0
    for osize in lengths:
        ex = torch.zeros(osize + 1, dtype=torch.int32, device=octrees.device)
        torch.cumsum(counts[start:start + osize], 0, out=ex[1:])
        exsums.append(ex)
        # nodes at level l+1 = children through the level-l bytes; bytes
        # through level l = 1 + the previous sum (scan_octrees.cu:96-108)
        sizes = [1]
        total, prev_sum = 1, 0
        while total <= osize:
            curr_sum = int(ex[prev_sum + 1])
            sizes.append(curr_sum - prev_sum)
            total += sizes[-1]
            prev_sum = curr_sum
        pyramids.append(sizes)
        start += osize
    max_level = max((len(s) - 1 for s in pyramids), default=0)
    pyr = torch.zeros((len(lengths), 2, max_level + 2), dtype=torch.int32)
    for b, sizes in enumerate(pyramids):
        s = torch.tensor(sizes, dtype=torch.int32)
        pyr[b, 0, :len(sizes)] = s
        pyr[b, 1, 1:len(sizes) + 1] = torch.cumsum(s, 0)
    exsum = (torch.cat(exsums) if exsums else
             torch.zeros(0, dtype=torch.int32, device=octrees.device))
    return max_level, pyr, exsum


def generate_points(octrees, pyramids, exsum):
    """Decode octrees into point hierarchies on the octrees' device.

    Returns:
        (total_points, 3) int16: per octree the points of level 0 (root)
        to the deepest level, each level in byte order and within a byte in
        child order (the reference's BFS order).
    """
    del exsum
    pyr = torch.as_tensor(pyramids).cpu()
    device = octrees.device
    offs = CORNERS.to(device)
    shifts = torch.arange(8, dtype=torch.int32, device=device)
    out = []
    start = 0
    for b in range(pyr.shape[0]):
        sizes = pyr[b, 0].tolist()
        depth = max((i for i, s in enumerate(sizes) if s), default=0)
        pts = [torch.zeros((1, 3), dtype=torch.int32, device=device)]
        for level in range(depth):
            level_bytes = octrees[start:start + sizes[level]].to(torch.int32)
            start += sizes[level]
            bits = (level_bytes[:, None] >> shifts) & 1
            parent, child = torch.nonzero(bits, as_tuple=True)
            pts.append(pts[level][parent] * 2 + offs[child])
        out.append(torch.cat(pts).to(torch.int16))
    return torch.cat(out)


def unbatched_get_level_points(point_hierarchy, pyramid, level):
    """Points of one level of an unbatched hierarchy."""
    pyramid = torch.as_tensor(pyramid)
    return point_hierarchy[int(pyramid[1, level]):int(pyramid[1, level + 1])]


def unbatched_query(octree, exsum, query_coords, level, with_parents=False,
                    device=None):
    """Point-hierarchy indices of coordinates at ``level`` (-1: no voxel).

    Args:
        octree: (num_bytes,) uint8 tensor.
        exsum: (num_bytes + 1,) int32 (a leading 0, then the inclusive
            popcount sum), on the octree's device.
        query_coords: (N, 3) tensor on that device; float in [-1, 1]
            (quantized, so clipped into the grid) or integer in
            [0, 2^level) (out-of-range coords miss).
        level: target level.
        with_parents: also return the indices on the path from the root.
        device: where to query (default: the device of the tensor inputs,
            the card for numpy ones).

    Returns:
        (N,) int32, or (N, level + 1) int32 with ``with_parents``.
    """
    device = entry_device(device, query_coords, octree)
    octree, exsum, query_coords = (torch.as_tensor(x, device=device) for x in
                                   (octree, exsum, query_coords))
    if query_coords.is_floating_point():
        coords = quantize_points(query_coords, level).to(torch.int32)
    else:
        coords = query_coords.to(torch.int32)
    popcount = popcount_table(octree.device)
    octree = octree.to(torch.int32)
    exsum = exsum.to(torch.int32)
    alive = ((coords >= 0) & (coords < (1 << level))).all(-1)
    ord_ = torch.zeros(coords.shape[0], dtype=torch.int32,
                       device=coords.device)
    path = [torch.where(alive, 0, -1)] if with_parents else None
    for lv in range(level):
        cbits = (coords >> (level - lv - 1)) & 1
        child = (cbits[:, 0] << 2) | (cbits[:, 1] << 1) | cbits[:, 2]
        bits = octree[torch.clamp(ord_, 0, octree.shape[0] - 1)]
        # the inclusive rank of the child among the byte's set bits
        rank = popcount[bits & ((2 << child) - 1)]
        new_ord = exsum[torch.clamp(ord_, 0, exsum.shape[0] - 1)] + rank
        alive = alive & (((bits >> child) & 1) == 1)
        ord_ = torch.where(alive, new_ord, ord_)
        if with_parents:
            path.append(torch.where(alive, ord_, -1))
    result = torch.where(alive, ord_, -1).to(torch.int32)
    if with_parents:
        path[-1] = result
        return torch.stack(path, dim=-1).to(torch.int32)
    return result


def to_dense(point_hierarchies, pyramids, input, level=-1, **kwargs):
    """Scatter SPC features into a dense (B, C, 2^l, 2^l, 2^l) grid,
    differentiable with respect to ``input``.

    Args:
        point_hierarchies: packed (total_points, 3) int coords.
        pyramids: (B, 2, max_level + 2) int32 (host values).
        input: (points at ``level`` over the batch, C) features, packed.
        level: level to densify (-1: the deepest).
    """
    pyr = torch.as_tensor(pyramids).cpu()
    B = pyr.shape[0]
    max_level = pyr.shape[2] - 2
    if level < 0:
        level = max_level
    res = 2 ** level
    idx, in_start, hier_start = [], 0, 0
    for b in range(B):
        lo = hier_start + int(pyr[b, 1, level])
        n = int(pyr[b, 0, level])
        pts = point_hierarchies[lo:lo + n].long()
        idx.append(((b * res + pts[:, 0]) * res + pts[:, 1]) * res
                   + pts[:, 2])
        in_start += n
        hier_start += int(pyr[b, 1, max_level + 1])
    C = input.shape[-1]
    out = input.new_zeros((B * res ** 3, C)).index_put(
        (torch.cat(idx),), input[:in_start])
    return out.reshape(B, res, res, res, C).permute(0, 4, 1, 2, 3)


def feature_grids_to_spc(feature_grids, masks=None, device=None):
    """Dense (B, C, X, Y, Z) feature grids to an SPC.

    Args:
        feature_grids: (B, C, X, Y, Z), X = Y = Z a power of 2.
        masks: optional (B, X, Y, Z) occupancy (default: any feature != 0).
        device: where to build (default: the device of a tensor
            ``feature_grids``, the card for a numpy one).

    Returns:
        (packed uint8 octrees, (B,) int32 CPU lengths, the occupied voxels'
        features (num_voxels, C), per octree in morton order).
    """
    grids = torch.as_tensor(feature_grids,
                            device=entry_device(device, feature_grids))
    level = int(grids.shape[2]).bit_length() - 1
    if masks is None:
        masks = (grids != 0).any(dim=1)
    else:
        masks = torch.as_tensor(masks, device=grids.device).bool()
    octrees, lengths, feats = [], [], []
    for b in range(grids.shape[0]):
        coords = torch.nonzero(masks[b])
        coords = coords[torch.argsort(points_to_morton(coords))]
        octree = unbatched_points_to_octree(coords, level)
        octrees.append(octree)
        lengths.append(octree.shape[0])
        feats.append(grids[b, :, coords[:, 0], coords[:, 1],
                           coords[:, 2]].T)
    return (torch.cat(octrees), torch.tensor(lengths, dtype=torch.int32),
            torch.cat(feats))


def unbatched_make_dual(point_hierarchy, pyramid, device=None):
    """The dual octree: the corners of the voxels of every level, per level
    in morton order, on ``device`` (default: the device of a tensor
    ``point_hierarchy``, the card for a numpy one).

    Returns:
        (point_hierarchy_dual (num_dual, 3) int16, pyramid_dual
        (2, max_level + 2) int32 CPU tensor).
    """
    point_hierarchy = torch.as_tensor(
        point_hierarchy, device=entry_device(device, point_hierarchy))
    pyr = torch.as_tensor(pyramid).cpu()
    num_levels = pyr.shape[1] - 1
    dual = []
    for lv in range(num_levels):
        pts = point_hierarchy[int(pyr[1, lv]):int(pyr[1, lv + 1])]
        corners = points_to_corners(pts.to(torch.int64)).reshape(-1, 3)
        dual.append(morton_to_points(torch.unique(points_to_morton(corners))))
    sizes = torch.tensor([d.shape[0] for d in dual], dtype=torch.int32)
    pyramid_dual = torch.zeros((2, num_levels + 1), dtype=torch.int32)
    pyramid_dual[0, :num_levels] = sizes
    pyramid_dual[1, 1:] = torch.cumsum(sizes, 0)
    return torch.cat(dual), pyramid_dual


def unbatched_make_trinkets(point_hierarchy, pyramid, point_hierarchy_dual,
                            pyramid_dual, device=None):
    """Pointers from every voxel to its 8 dual corners, and to its parent,
    on ``device`` (default: the device of the tensor hierarchies, the card
    for numpy ones).

    Returns:
        (trinkets (num_points, 8) int32: indices into the voxel's own level
        slice of the dual hierarchy; parents (num_points,) int32: global
        indices of the parent voxels, -1 for the root).
    """
    device = entry_device(device, point_hierarchy, point_hierarchy_dual)
    point_hierarchy, point_hierarchy_dual = (
        torch.as_tensor(x, device=device) for x in (point_hierarchy,
                                                     point_hierarchy_dual))
    pyr = torch.as_tensor(pyramid).cpu()
    pyr_dual = torch.as_tensor(pyramid_dual).cpu()
    num_levels = min(pyr.shape[1] - 1, pyr_dual.shape[1] - 1)

    def level_morton(hier, p, lv):
        return points_to_morton(hier[int(p[1, lv]):int(p[1, lv + 1])])

    trinkets = []
    parents = [torch.full((1,), -1, dtype=torch.int32, device=device)]
    for lv in range(num_levels):
        pts = point_hierarchy[int(pyr[1, lv]):int(pyr[1, lv + 1])].to(
            torch.int64)
        corners = points_to_morton(points_to_corners(pts).reshape(-1, 3))
        dual = level_morton(point_hierarchy_dual, pyr_dual, lv)  # sorted
        trinkets.append(torch.searchsorted(dual, corners).reshape(-1, 8))
        if lv > 0:
            prev = level_morton(point_hierarchy, pyr, lv - 1)
            parents.append(torch.searchsorted(prev, points_to_morton(
                pts // 2)) + int(pyr[1, lv - 1]))
    return (torch.cat(trinkets).to(torch.int32),
            torch.cat(parents).to(torch.int32))
