"""SPC core ops on the trace path: scan, point hierarchy, level points.

Port of ``kaolin_tpu/ops/spc/spc.py`` (query, dense, dual and trinkets are
still to port).  The JAX package runs the scan and the point expansion in
host numpy; here they run on the octree's own device with a 256-entry
popcount table, ``cumsum`` and ``nonzero``.  Pyramids stay on the host: their
values are shapes.
"""

import torch

from kaolin_tpu_torch.ops.spc.uint8 import uint8_bits_sum

__all__ = ['scan_octrees', 'generate_points', 'unbatched_get_level_points']

KAOLIN_SPC_MAX_LEVELS = 15  # reference spc_math.h:37

_CHILD_OFFSETS = torch.tensor([[(k >> 2) & 1, (k >> 1) & 1, k & 1]
                               for k in range(8)], dtype=torch.int32)


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
    offs = _CHILD_OFFSETS.to(device)
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
