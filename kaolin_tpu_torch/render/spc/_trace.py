"""Kernel K3: the coherent-ray trace of the cell-table engine.

Port of ``kaolin_tpu/render/spc/raster.py::_trace_kernel`` (a Pallas TPU
kernel).  :func:`trace` tests each ray of each active block against every
voxel of the block's candidate cells and writes a per-ray k-buffer:

* hits in candidate order (cell slot ``0..nb-1``, then lane ``0..cw-1``),
  hit rule ``tf > tn & tf > 0 & tn > 0 & pid >= 0`` with the slab test of
  ``raytrace.voxel_slab``;
* the exact count; when it exceeds ``kbuf`` only the first ``kbuf`` hits in
  candidate order are kept (saturation is flagged upstream);
* the kept hits sorted by t_near, ties in candidate order; padding is
  ``inf`` / ``-1``, and ``t_far`` stays ``inf`` when ``with_exit`` is False.

Rows of blocks that are not active keep those defaults.  CPU tensors run
:func:`_trace_torch`, the plain PyTorch version; CUDA tensors launch
``spc_trace_kernel`` (``csrc/spc_trace.cu``) or raise.  ``LAUNCHES`` counts
kernel launches.
"""

import ctypes

import torch

from kaolin_tpu_torch.render.spc.raytrace import voxel_slab

__all__ = ['trace', 'LAUNCHES']

LAUNCHES = {'trace': 0}

_PLAIN_BLOCK = 1 << 22      # (ray, voxel) pairs per chunk of the plain version
_THREADS = 256              # threads per block of the kernel
_MAX_RT = 32                # rays per block the kernel takes (4 per warp)
_MAX_SMEM = 232448          # dynamic shared memory a block can use (H100)


def _outputs(num_blocks, rt, kbuf, device):
    inf = torch.inf
    return (torch.full((num_blocks, rt, kbuf), inf, device=device),
            torch.full((num_blocks, rt, kbuf), inf, device=device),
            torch.full((num_blocks, rt, kbuf), -1, dtype=torch.int32,
                       device=device),
            torch.zeros((num_blocks, rt), dtype=torch.int32, device=device))


def _trace_torch(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
                 with_exit, num_blocks):
    """Plain PyTorch version of K3 (same arguments as :func:`trace`).

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
        rank = torch.cumsum(hit, dim=-1) - 1
        keep = hit & (rank < kbuf)
        dst = torch.where(keep, rank, kbuf)

        def pack(x, fill):
            buf = torch.full((n, rt, kbuf + 1), fill, dtype=x.dtype,
                             device=device)
            return buf.scatter_(2, dst, torch.where(keep, x, fill))[..., :kbuf]

        tn_k, order = torch.sort(pack(tn, torch.inf), dim=-1, stable=True)
        bids = block_ids[a0:a1]
        tn_out[bids] = tn_k
        pi_out[bids] = pack(pid[:, None].expand(n, rt, -1), -1).gather(
            -1, order)
        if with_exit:
            tf_out[bids] = pack(tf, torch.inf).gather(-1, order)
        cnt_out[bids] = hit.sum(dim=-1, dtype=torch.int32)
        a0 = a1
    return tn_out, tf_out, pi_out, cnt_out


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f'{name}: expected a contiguous {dtype} tensor of shape {shape} '
            f'on {device}, got {t.dtype} {tuple(t.shape)} on {t.device} '
            f'(contiguous={t.is_contiguous()})')


def _smem_bytes(rt, cw, kbuf, with_exit):
    return 4 * (4 * cw + rt * kbuf * (3 if with_exit else 2))


def _lib():
    from kaolin_tpu_torch import _cuda
    lib = _cuda.load('spc_trace')
    if lib.spc_trace.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.spc_trace.argtypes = [p, p, p, p, p, p, p, p, p,
                                  i, i, i, i, i, f, i, p]
        lib.spc_trace.restype = ctypes.c_int
    return lib


def _launch(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
            with_exit, out):
    """Launch K3 into preallocated outputs ``out`` = (t_near, t_far, pidx,
    count), as :func:`_outputs` makes them; rows of blocks not in
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
    smem = _smem_bytes(rt, cw, kbuf, with_exit)
    if not 1 <= rt <= _MAX_RT or smem > _MAX_SMEM:
        raise ValueError(
            f'spc_trace_kernel takes 1 <= rays_per_tile <= {_MAX_RT} and '
            f'at most {_MAX_SMEM} B of k-buffer and cell row in shared '
            f'memory; got rays_per_tile={rt}, kbuf={kbuf}, cell width {cw} '
            f'({smem} B)')
    if nA == 0:
        return out
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (
        rays, cell_rows, block_cells, nb, block_ids, *out)]
    rc = _lib().spc_trace(
        *ptr, nA, rt, cw, ckmax, kbuf, float(2. * half), int(bool(with_exit)),
        ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream))
    if rc != 0:
        raise RuntimeError(f'spc_trace_kernel failed to launch: cudaError {rc}')
    LAUNCHES['trace'] += 1
    return out


def _trace_cuda(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
                with_exit, num_blocks):
    """Allocate the outputs and launch K3; same contract as the plain
    version."""
    out = _outputs(num_blocks, rays.shape[1], kbuf, rays.device)
    return _launch(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
                   with_exit, out)


def trace(rays, cell_rows, block_cells, nb, block_ids, kbuf, half,
          with_exit, num_blocks):
    """K3: trace the active blocks' rays against their candidate cells.

    Args:
        rays: (nA, rt, 6) f32 per active block: origin, then 1 / direction.
        cell_rows: (Mc + 1, 4, cw) int32 cell table rows (x, y, z, local
            leaf index; -1 pads).
        block_cells: (nA, ckmax) int32 candidate cell ids per block, in
            candidate order.
        nb: (nA,) int32 candidate cells to read per block (<= ckmax).
        block_ids: (nA,) int64 output row of each active block.
        kbuf: k-buffer width.  half: voxel half side, 1 / 2**level.
        with_exit: also write exit depths.
        num_blocks: number of output rows nB.

    Returns:
        (t_near (nB, rt, kbuf) f32, t_far (nB, rt, kbuf) f32, pidx (nB, rt,
        kbuf) int32 local leaf indices, count (nB, rt) int32).
    """
    if rays.device.type == 'cpu':
        return _trace_torch(rays, cell_rows, block_cells, nb, block_ids,
                            kbuf, half, with_exit, num_blocks)
    if rays.device.type != 'cuda':
        raise ValueError(f'no spc trace for device {rays.device}')
    return _trace_cuda(rays, cell_rows, block_cells, nb, block_ids, kbuf,
                       half, with_exit, num_blocks)
