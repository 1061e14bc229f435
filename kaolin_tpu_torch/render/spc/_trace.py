"""Kernel K3: the coherent-ray trace of the cell-table engine.

Port of ``kaolin_tpu/render/spc/raster.py::_trace_kernel`` (a Pallas TPU
kernel).  :func:`trace` tests each ray of each active block against every
voxel of the block's candidate cells and writes a per-ray k-buffer:

* hits in candidate order (cell slot ``0..nb-1``, then lane ``0..cw-1``),
  hit rule ``tf > tn & tf > 0 & tn > 0 & pid >= 0`` with the slab test of
  ``raytrace.voxel_slab``; a row may hold ``-1`` in any of its slots;
* the exact count; when it exceeds ``kbuf`` only the first ``kbuf`` hits in
  candidate order are kept (saturation is flagged upstream);
* the kept hits sorted by t_near, ties in candidate order; a kept hit's
  pidx is its slot's leaf index plus ``pidx_offset``; padding is ``inf`` /
  ``-1``, and ``t_far`` stays ``inf`` when ``with_exit`` is False.

Rows of blocks that are not active keep those defaults.  CPU tensors run
:func:`_trace_torch`, the plain PyTorch version; CUDA tensors launch
``spc_trace_kernel`` (``csrc/spc_trace.cu``, through the extension module
``csrc/spc_trace_module.cpp``, which tests the inputs and launches in C++)
or raise.  ``LAUNCHES`` counts kernel launches.

The kernel, in short (its source says more): one warp per active block,
one ray per lane, warps that share nothing.  The warp stages a cell row in
shared memory with the slots that hold a voxel packed to the front (a
ballot) as float corners and final pidx, so the slab tests run over voxels
only and convert nothing; each lane then tests its ray against the packed
voxels, four at a time, one broadcast read each.  A lane that hits appends
at position count of its ray's output row, which serves as the k-buffer; at
the end the warp reads each row back and rank-sorts it in place.  The
shared memory is one staged unit per warp, whatever ``rays_per_tile`` is
(the sort reuses it).
"""

import torch

from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch.render.spc.raytrace import voxel_slab

__all__ = ['trace', 'LAUNCHES']

LAUNCHES = {'trace': 0}

_PLAIN_BLOCK = 1 << 22      # (ray, voxel) pairs per chunk of the plain version
_MAX_SMEM = 232448          # dynamic shared memory a block can use (H100)
# the kernel's shape, as csrc/spc_trace.cu sets it
_THREADS = 64               # per CTA: one ray block per warp
_MAX_RT = 32                # rays per block: one per lane
_UNIT = 256                 # slots of a cell row staged at once
_UNROLL = 4                 # voxels per step of the test loop


def _outputs(num_blocks, rt, kbuf, device):
    inf = torch.inf
    return (torch.full((num_blocks, rt, kbuf), inf, device=device),
            torch.full((num_blocks, rt, kbuf), inf, device=device),
            torch.full((num_blocks, rt, kbuf), -1, dtype=torch.int32,
                       device=device),
            torch.zeros((num_blocks, rt), dtype=torch.int32, device=device))


def _chunks(rays, cell_rows, block_cells, nb, half, pidx_offset):
    """The plain version's slab tests, dense over (ray, candidate voxel)
    pairs, in chunks of active blocks of at most ``_PLAIN_BLOCK`` pairs
    padded to the widest block's candidates; trailing blocks with nb = 0
    are skipped.  Yields (a0, a1, hit, t_near, t_far, pidx), each (a1 - a0,
    rt, C * cw) in candidate order, pidx final (-1 for no voxel)."""
    rt = rays.shape[1]
    cw = cell_rows.shape[2]
    side = 2. * half
    device = rays.device
    nb_host = nb.tolist()
    nA = len(nb_host)
    while nA and not nb_host[nA - 1]:
        nA -= 1
    a0 = 0
    while a0 < nA:
        a1, C = a0, 1
        while a1 < nA:
            c = max(C, nb_host[a1])
            if a1 > a0 and (a1 - a0 + 1) * rt * c * cw > _PLAIN_BLOCK:
                break
            C = c
            a1 += 1
        n = a1 - a0
        slot_ok = (torch.arange(C, device=device)[None]
                   < nb[a0:a1, None])                          # (n, C)
        g = cell_rows[block_cells[a0:a1, :C].long()]           # (n, C, 4, cw)
        g = g.permute(0, 2, 1, 3).reshape(n, 4, C * cw)
        pid = torch.where(slot_ok.repeat_interleave(cw, dim=1), g[:, 3], -1)
        q = g[:, :3].permute(0, 2, 1)[:, None]                 # (n, 1, Ccw, 3)
        r = rays[a0:a1, :, None]                               # (n, rt, 1, 6)
        tn, tf = voxel_slab(q, side, r[..., :3], r[..., 3:])   # (n, rt, Ccw)
        hit = (tf > tn) & (tf > 0.) & (tn > 0.) & (pid >= 0)[:, None]
        pid = torch.where(pid >= 0, pid + pidx_offset, -1)
        yield a0, a1, hit, tn, tf, pid[:, None].expand(n, rt, -1)
        a0 = a1


def _packer(hit, kbuf):
    """``pack(x, fill)``: per ray, x at its first ``kbuf`` hits in
    candidate order, ``fill`` after them."""
    rank = torch.cumsum(hit, dim=-1) - 1
    keep = hit & (rank < kbuf)
    dst = torch.where(keep, rank, kbuf)

    def pack(x, fill):
        buf = torch.full(hit.shape[:-1] + (kbuf + 1,), fill, dtype=x.dtype,
                         device=x.device)
        return buf.scatter_(2, dst, torch.where(keep, x, fill))[..., :kbuf]
    return pack


def _trace_torch(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
                 with_exit, num_blocks, pidx_offset=0, out=None):
    """Plain PyTorch version of K3 (same arguments as :func:`trace`), dense
    over the pairs (:func:`_chunks`): the count, the first kbuf hits, their
    stable sort by t_near."""
    if out is None:
        out = _outputs(num_blocks, rays.shape[1], kbuf, rays.device)
    tn_out, tf_out, pi_out, cnt_out = out
    for a0, a1, hit, tn, tf, pid in _chunks(rays, cell_rows, block_cells, nb,
                                            half, pidx_offset):
        bids = block_ids[a0:a1]
        cnt_out[bids] = hit.sum(dim=-1, dtype=torch.int32)
        pack = _packer(hit, kbuf)
        tn_out[bids], order = torch.sort(pack(tn, torch.inf), dim=-1,
                                         stable=True)
        pi_out[bids] = pack(pid, -1).gather(-1, order)
        if with_exit:
            tf_out[bids] = pack(tf, torch.inf).gather(-1, order)
    return out


def _smem_bytes(kbuf, with_exit):
    """Dynamic shared memory of a launch (``warp_bytes`` of the source, per
    warp): the staged unit and its padding as float4, or the sort's kbuf
    entries, whichever is larger, in 16-byte steps."""
    unit = (_UNIT + _UNROLL) * 16
    sort = kbuf * 4 * (3 if with_exit else 2)
    return _THREADS // 32 * ((max(unit, sort) + 15) // 16 * 16)


def _launchable(rt, kbuf, with_exit):
    """Raise ValueError unless the kernel takes ``rt`` rays per block and a
    k-buffer of ``kbuf`` entries: before a launch, so nothing is built for a
    shape the kernel cannot take."""
    smem = _smem_bytes(kbuf, with_exit)
    if not 1 <= rt <= _MAX_RT or not 1 <= kbuf or smem > _MAX_SMEM:
        raise ValueError(
            f'spc_trace_kernel (one ray per lane, {_THREADS // 32} blocks '
            f'per CTA) takes 1 <= rays_per_tile <= {_MAX_RT} and at most '
            f'{_MAX_SMEM} B of shared memory (per warp a staged unit or a '
            f'sort buffer of kbuf entries); got rays_per_tile={rt}, '
            f'kbuf={kbuf} ({smem} B)')


def _launch(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
            with_exit, out, pidx_offset=0):
    """Launch K3 into preallocated outputs ``out`` = (t_near, t_far, pidx,
    count), as :func:`_outputs` makes them, and add one to
    ``LAUNCHES['trace']``; rows of blocks not in ``block_ids`` are not
    touched.  The extension module tests the inputs."""
    _launchable(rays.shape[1], kbuf, with_exit)
    if _cuda.load_module('spc_trace').trace(
            rays, cell_rows, block_cells, nb, block_ids, *out, int(kbuf),
            float(2. * half), int(bool(with_exit)), int(pidx_offset),
            _cuda.stream_getter()(rays.get_device())):
        LAUNCHES['trace'] += 1
    return out


def _trace_cuda(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
                with_exit, num_blocks, pidx_offset=0, out=None):
    """Launch K3 into ``out``, allocated here where it is None; same
    contract as the plain version."""
    if out is None:
        out = _outputs(num_blocks, rays.shape[1], kbuf, rays.device)
    return _launch(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
                   with_exit, out, pidx_offset)


def trace(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
          with_exit, num_blocks, pidx_offset=0, out=None):
    """K3: trace the active blocks' rays against their candidate cells.

    Args:
        rays: (nA, rt, 6) f32 per active block: origin, then 1 / direction.
        cell_rows: (Mc + 1, 4, cw) int32 cell table rows (x, y, z, local
            leaf index; -1, in any slot, for no voxel).
        block_cells: (nA, ckmax) int32 candidate cell ids per block, in
            candidate order.
        nb: (nA,) int32 candidate cells to read per block (<= ckmax).
        block_ids: (nA,) int64 output row of each active block.
        kbuf: k-buffer width.  half: voxel half side, 1 / 2**level.
        with_exit: also write exit depths.
        num_blocks: number of output rows nB.
        pidx_offset: added to the leaf index of every kept hit (the leaf
            level's offset in the point hierarchy gives global indices).
        out: the outputs, as :func:`_outputs` makes them (the defaults in
            place), to write into and return; default: allocated here.
            Made ahead, their fills can run on the card while the host
            prepares the other arguments.

    Returns:
        (t_near (nB, rt, kbuf) f32, t_far (nB, rt, kbuf) f32, pidx (nB, rt,
        kbuf) int32 leaf indices + ``pidx_offset``, -1 for padding, count
        (nB, rt) int32).
    """
    if rays.device.type == 'cpu':
        return _trace_torch(rays, cell_rows, block_cells, nb, block_ids,
                            kbuf, half, with_exit, num_blocks, pidx_offset,
                            out)
    if rays.device.type != 'cuda':
        raise ValueError(f'no spc trace for device {rays.device}')
    return _trace_cuda(rays, cell_rows, block_cells, nb, block_ids, kbuf,
                       half, with_exit, num_blocks, pidx_offset, out=out)

