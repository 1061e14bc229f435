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
``spc_trace_kernel`` (``csrc/spc_trace.cu``) or raise.  ``LAUNCHES`` counts
kernel launches.

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

:func:`trace_staged` is the same kernel cut at one of six stages (slab
test, hit ranks, packing, k-buffer append, sort of every k-buffer entry,
K3's sort), the port of ``scripts/probe_r5_kbisect.py::staged_kernel``; it
measures what each part of K3 costs.  Its plain version is
:func:`_trace_staged_torch`.
"""

import ctypes

import torch

from kaolin_tpu_torch.render.spc.raytrace import voxel_slab

__all__ = ['trace', 'trace_staged', 'LAUNCHES']

STAGES = (1, 2, 3, 4, 5, 6)  # the cuts of trace_staged; 6 is K3
LAUNCHES = {'trace': 0, **{f'stage{s}': 0 for s in STAGES}}

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


def _trace_torch(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
                 with_exit, num_blocks, pidx_offset=0):
    """Plain PyTorch version of K3 (same arguments as :func:`trace`)."""
    return _trace_staged_torch(6, rays, cell_rows, block_cells, nb,
                               block_ids, kbuf, half, with_exit, num_blocks,
                               pidx_offset)


def _trace_staged_torch(stage, rays, cell_rows, block_cells, nb, block_ids,
                        kbuf, half, with_exit, num_blocks, pidx_offset=0):
    """Plain PyTorch version of :func:`trace_staged` (stage 6 is K3's).

    Dense over (ray, candidate voxel) pairs, in chunks of active blocks of
    at most ``_PLAIN_BLOCK`` pairs; each chunk is padded to its widest
    block's candidate count.
    """
    nA, rt = rays.shape[:2]
    cw = cell_rows.shape[2]
    side = 2. * half
    device = rays.device
    tn_out, tf_out, pi_out, cnt_out = _outputs(num_blocks, rt, kbuf, device)
    nb_host = nb.tolist()
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
        bids = block_ids[a0:a1]
        cnt_out[bids] = hit.sum(dim=-1, dtype=torch.int32)
        pid = torch.where(pid >= 0, pid + pidx_offset, -1)
        pid = pid[:, None].expand(n, rt, -1)
        if stage == 3:      # the last candidate cell's hits, in lane order
            last = (nb[a0:a1].long() - 1).clamp(min=0)[:, None, None, None]
            hit, tn = (x.reshape(n, rt, C, cw).gather(
                2, last.expand(n, rt, 1, cw))[:, :, 0] for x in (hit, tn))
        if stage >= 3:
            rank = torch.cumsum(hit, dim=-1) - 1
            keep = hit & (rank < kbuf)
            dst = torch.where(keep, rank, kbuf)

            def pack(x, fill):
                buf = torch.full((n, rt, kbuf + 1), fill, dtype=x.dtype,
                                 device=device)
                return buf.scatter_(2, dst, torch.where(keep, x, fill))[
                    ..., :kbuf]

            tn_k = pack(tn, torch.inf)
            order = None
            if stage >= 5:
                tn_k, order = torch.sort(tn_k, dim=-1, stable=True)
            tn_out[bids] = tn_k
            if stage >= 4:
                pi_k = pack(pid, -1)
                pi_out[bids] = pi_k if order is None else pi_k.gather(
                    -1, order)
                if with_exit:
                    tf_k = pack(tf, torch.inf)
                    tf_out[bids] = tf_k if order is None else tf_k.gather(
                        -1, order)
        a0 = a1
    return tn_out, tf_out, pi_out, cnt_out


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f'{name}: expected a contiguous {dtype} tensor of shape {shape} '
            f'on {device}, got {t.dtype} {tuple(t.shape)} on {t.device} '
            f'(contiguous={t.is_contiguous()})')


def _smem_bytes(kbuf, with_exit):
    """Dynamic shared memory of a launch (``warp_bytes`` of the source, per
    warp): the staged unit and its padding as float4, or the sort's kbuf
    entries, whichever is larger, in 16-byte steps."""
    unit = (_UNIT + _UNROLL) * 16
    sort = kbuf * 4 * (3 if with_exit else 2)
    return _THREADS // 32 * ((max(unit, sort) + 15) // 16 * 16)


def _lib():
    """The built ``csrc/spc_trace.cu``, its C function typed."""
    from kaolin_tpu_torch import _cuda
    lib = _cuda.load('spc_trace')
    if lib.spc_trace.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.spc_trace.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, i, i, f,
                                  i, i, i, p]
        lib.spc_trace.restype = ctypes.c_int
    return lib


def _launch(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
            with_exit, out, stage=6, counter='trace', pidx_offset=0):
    """Launch K3 (``stage`` 6) or its cut at ``stage`` into preallocated
    outputs ``out`` = (t_near, t_far, pidx, count), as :func:`_outputs`
    makes them, and add one to ``LAUNCHES[counter]``; rows of blocks not in
    ``block_ids`` are not touched."""
    device = rays.device
    nA, rt = rays.shape[:2]
    cw = cell_rows.shape[2]
    ckmax = block_cells.shape[1]
    _check('rays', rays, torch.float32, (nA, rt, 6), device)
    _check('cell_rows', cell_rows, torch.int32,
           (cell_rows.shape[0], 4, cw), device)
    _check('block_cells', block_cells, torch.int32, (nA, ckmax), device)
    _check('nb', nb, torch.int32, (nA,), device)
    _check('block_ids', block_ids, torch.int64, (nA,), device)
    nB = out[3].shape[0]
    for name, t, dtype in zip(('t_near', 't_far', 'pidx'), out[:3],
                              (torch.float32, torch.float32, torch.int32)):
        _check(name, t, dtype, (nB, rt, kbuf), device)
    _check('count', out[3], torch.int32, (nB, rt), device)
    if stage not in STAGES:
        raise ValueError(f'stage must be one of {STAGES}, got {stage}')
    smem = _smem_bytes(kbuf, with_exit)
    if not 1 <= rt <= _MAX_RT or not 1 <= kbuf or smem > _MAX_SMEM:
        raise ValueError(
            f'spc_trace_kernel (one ray per lane, {_THREADS // 32} blocks '
            f'per CTA) takes 1 <= rays_per_tile <= {_MAX_RT} and at most '
            f'{_MAX_SMEM} B of shared memory (per warp a staged unit or a '
            f'sort buffer of kbuf entries); got rays_per_tile={rt}, '
            f'kbuf={kbuf} ({smem} B)')
    if nA == 0:
        return out
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (
        rays, cell_rows, block_cells, nb, block_ids, *out)]
    args = [*ptr, nA, rt, cw, ckmax, kbuf, float(2. * half),
            int(bool(with_exit)), int(pidx_offset)]
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
    rc = _lib().spc_trace(*args, int(stage), stream)
    if rc != 0:
        raise RuntimeError(f'spc_trace_kernel failed to launch: cudaError {rc}')
    LAUNCHES[counter] += 1
    return out


def _trace_cuda(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
                with_exit, num_blocks, pidx_offset=0, stage=6,
                counter='trace'):
    """Allocate the outputs and launch K3 (or its cut at ``stage``); same
    contract as the plain version."""
    out = _outputs(num_blocks, rays.shape[1], kbuf, rays.device)
    return _launch(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
                   with_exit, out, stage, counter, pidx_offset)


def trace(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
          with_exit, num_blocks, pidx_offset=0):
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

    Returns:
        (t_near (nB, rt, kbuf) f32, t_far (nB, rt, kbuf) f32, pidx (nB, rt,
        kbuf) int32 leaf indices + ``pidx_offset``, -1 for padding, count
        (nB, rt) int32).
    """
    if rays.device.type == 'cpu':
        return _trace_torch(rays, cell_rows, block_cells, nb, block_ids,
                            kbuf, half, with_exit, num_blocks, pidx_offset)
    if rays.device.type != 'cuda':
        raise ValueError(f'no spc trace for device {rays.device}')
    return _trace_cuda(rays, cell_rows, block_cells, nb, block_ids, kbuf,
                       half, with_exit, num_blocks, pidx_offset)


def trace_staged(stage, rays, cell_rows, block_cells, nb, block_ids, kbuf,
                 half, with_exit, num_blocks, pidx_offset=0):
    """K3 cut at ``stage``, for measuring its parts (arguments as
    :func:`trace`).

    What each stage adds, and what it writes over the defaults:

    1. the slab tests and the exact per-ray count: count only;
    2. each hit's rank among the ray's hits (kept, unused): count only;
    3. the packing of each cell's hits: t_near holds the ray's hits in the
       block's last candidate cell, in lane order (first kbuf), inf after;
    4. the k-buffer append: the first kbuf hits in candidate order,
       unsorted (t_near, pidx, and t_far when ``with_exit``);
    5. a sort by t_near of all kbuf entries, padding included;
    6. the sort of the min(count, kbuf) kept entries only: K3's output.

    Stages 5 and 6 give the same result; they differ in cost.  CPU tensors
    run :func:`_trace_staged_torch`; CUDA tensors launch the kernel's
    ``STAGE`` instance (counted in ``LAUNCHES[f'stage{stage}']``) or
    raise.
    """
    if rays.device.type == 'cpu':
        if stage not in STAGES:
            raise ValueError(f'stage must be one of {STAGES}, got {stage}')
        return _trace_staged_torch(stage, rays, cell_rows, block_cells, nb,
                                   block_ids, kbuf, half, with_exit,
                                   num_blocks, pidx_offset)
    if rays.device.type != 'cuda':
        raise ValueError(f'no spc trace for device {rays.device}')
    return _trace_cuda(rays, cell_rows, block_cells, nb, block_ids, kbuf,
                       half, with_exit, num_blocks, pidx_offset, stage=stage,
                       counter=f'stage{stage}')
