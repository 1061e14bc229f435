"""Probe kernels P1 (kA..kH), P2 (the dummy grid) and P3 (K3 by stage):
wrappers and plain versions.

Ports of the Pallas TPU probes ``scripts/probe_r5_mosaic3.py::kA..kH``,
``scripts/probe_r5_stages.py::dummy_kernel`` and
``scripts/probe_r5_kbisect.py::staged_kernel``; the CUDA kernels are in
``csrc/probes.cu``, P3's as instances of K3's template
(``csrc/spc_trace.cuh``).  Layouts follow the scripts: ``x`` is (NB, R, C)
float32 (NB grid steps), ``nbs`` is (NB, 2) int32 of which column 0 is
read, ``ids`` is (NB, 1, CK) int32 rows of ``table`` (M, R, C) float32.
P3 takes K3's arguments (:func:`~kaolin_tpu_torch.render.spc._trace.trace`).

CPU tensors run the plain PyTorch versions (``PLAIN``,
:func:`_trace_staged_torch`); CUDA tensors launch the kernel or raise.
``LAUNCHES`` counts launches by wrapper name, P3's by stage (a call
captured in a CUDA graph counts once, its replays not at all).  Every
kernel equals its plain version bit for bit: the sums run in the scripts'
order.
"""

import torch

from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch.render.spc import _trace

__all__ = ['kA', 'kB', 'kC', 'kD', 'kE', 'kF', 'kG', 'kH', 'dummy',
           'trace_staged', 'STAGES', 'LAUNCHES', 'PLAIN', 'KB_SLOTS',
           'P2_TILE_BYTES', 'kb_smem_bytes']

STAGES = (1, 2, 3, 4, 5, 6)  # the cuts of trace_staged; 6 is K3
LAUNCHES = {k: 0 for k in ('kA', 'kB', 'kC', 'kD', 'kE', 'kF', 'kG', 'kH',
                           'dummy', *(f'stage{s}' for s in STAGES))}

ROLL_LANES, SHIFT_LANES, ROLL_ROWS = 0, 1, 2     # probe_shift's ops
# kB's ring in csrc/probes.cu (KB_SLOTS row slots after KB_BARRIERS bytes of
# barriers) and P2's tile (P2_TILE_BYTES a CTA); a CPU test holds these in
# step with the source
KB_SLOTS = 8
KB_BARRIERS = 128
P2_TILE_BYTES = 4096


def kb_smem_bytes(row_floats):
    """Dynamic shared memory of one kB CTA: its barriers and KB_SLOTS row
    slots of ``row_floats`` float32."""
    return KB_BARRIERS + KB_SLOTS * 4 * row_floats
_SHIFTS = {'kE': (ROLL_LANES, 3), 'kF': (ROLL_LANES, 3),
           'kG': (SHIFT_LANES, 4), 'kH': (ROLL_ROWS, 1)}


# ---------------------------------------------------------------------------
# plain versions

def _kA_torch(nbs, x):
    """x added nbs[b, 0] times, from 0, in order."""
    nb = nbs[:, 0].reshape(-1, *([1] * (x.dim() - 1)))
    acc = torch.zeros_like(x)
    for j in range(int(nb.max()) if nb.numel() else 0):
        acc = torch.where(j < nb, acc + x, acc)
    return acc


def _row_sum_torch(ids, table, count=None):
    """sum over j < count[b] (default: all CK) of table[ids[b, 0, j]], in
    j order from 0."""
    ids = ids[:, 0].long()
    acc = table.new_zeros((ids.shape[0],) + tuple(table.shape[1:]))
    shape = (-1,) + (1,) * (table.dim() - 1)
    for j in range(ids.shape[1]):
        row = table[ids[:, j]]
        acc = acc + row if count is None else torch.where(
            (j < count).reshape(shape), acc + row, acc)
    return acc


def _shift_torch(x, op, s):
    if op == ROLL_LANES:
        return x + torch.roll(x, s, dims=-1)
    if op == SHIFT_LANES:
        return x + torch.cat([x[..., s:], torch.zeros_like(x[..., :s])],
                             dim=-1)
    return x + torch.roll(x, s, dims=-2)


def _dummy_torch(x):
    return x * 2.


PLAIN = {
    'kA': _kA_torch,
    'kB': lambda ids, table, x: _row_sum_torch(ids, table),
    # kC runs on kD's kernel with every count CK: kD's plain version so
    'kC': lambda ids, table, x: _row_sum_torch(
        ids, table, torch.full((ids.shape[0],), ids.shape[2],
                               dtype=torch.int32, device=ids.device)),
    'kD': lambda nbs, ids, table, x: _row_sum_torch(ids, table, nbs[:, 0]),
    'kE': lambda x: _shift_torch(x, *_SHIFTS['kE']),
    'kF': lambda x: _shift_torch(x, *_SHIFTS['kF']),
    'kG': lambda x: _shift_torch(x, *_SHIFTS['kG']),
    'kH': lambda x: _shift_torch(x, *_SHIFTS['kH']),
    'dummy': _dummy_torch,
}


# ---------------------------------------------------------------------------
# CUDA launches: each wrapper hands its tensors and the current stream to an
# entry point of the extension module (csrc/probes_module.cpp), which tests
# them (and raises for what the kernel does not take), allocates the output
# and launches in C++, so a call costs the host about what one PyTorch op
# costs.

def _plain(name, x, *args):
    """The plain version, for a CPU tensor ``x``; other devices raise."""
    if x.device.type != 'cpu':
        raise ValueError(f'no probe kernel for device {x.device}')
    return PLAIN[name](*args)


def _row_sum(name, ids, table, x, nbs=None):
    """kB through the TMA ring (``row_sum``); kC (``nbs`` None: every count
    CK) and kD through kD's kernel (``bag_sum``)."""
    if not x.is_cuda:
        return (_plain(name, x, nbs, ids, table, x) if name == 'kD'
                else _plain(name, x, ids, table, x))
    ext = _cuda.load_module('probes')
    stream = _cuda.stream_getter()(x.get_device())
    out = (ext.row_sum(ids, table, x, stream) if name == 'kB'
           else ext.bag_sum(nbs, ids, table, x, stream))
    LAUNCHES[name] += 1
    return out


def kA(nbs, x):
    """x[b] added nbs[b, 0] times, from 0 (a loop bound read at run
    time)."""
    if not x.is_cuda:
        return _plain('kA', x, nbs, x)
    out = _cuda.load_module('probes').dyn_loop(
        nbs, x, _cuda.stream_getter()(x.get_device()))
    LAUNCHES['kA'] += 1
    return out


def kB(ids, table, x):
    """sum over j < CK of table[ids[b, 0, j]]; rows staged in shared memory
    by the copy engine, KB_SLOTS in flight per bag."""
    return _row_sum('kB', ids, table, x)


def kC(ids, table, x):
    """The same sum, rows loaded straight into registers (kD's kernel with
    every count CK)."""
    return _row_sum('kC', ids, table, x)


def kD(nbs, ids, table, x):
    """sum over j < nbs[b, 0] of table[ids[b, 0, j]]; every row of a short
    bag in flight before the first add."""
    return _row_sum('kD', ids, table, x, nbs=nbs)


def _shift(name, x):
    op, s = _SHIFTS[name]
    if not x.is_cuda:
        return _plain(name, x, x)
    out = _cuda.load_module('probes').shift(
        x, op, s, _cuda.stream_getter()(x.get_device()))
    LAUNCHES[name] += 1
    return out


def kE(x):
    """x + roll(x, 3) along lanes (the TPU's pltpu.roll)."""
    return _shift('kE', x)


def kF(x):
    """x + roll(x, 3) along lanes (the TPU's jnp.roll): kE's kernel."""
    return _shift('kF', x)


def kG(x):
    """x + x shifted left by 4 along lanes, zero-filled."""
    return _shift('kG', x)


def kH(x):
    """x + roll(x, 1) along rows."""
    return _shift('kH', x)


def dummy(x):
    """P2: 2 x over the steps of x (nsteps, ...), a CTA per 4 KB tile, in
    and out of shared memory by the copy engine."""
    if not x.is_cuda:
        return _plain('dummy', x, x)
    out = _cuda.load_module('probes').dummy(
        x, _cuda.stream_getter()(x.get_device()))
    LAUNCHES['dummy'] += 1
    return out


# ---------------------------------------------------------------------------
# P3: K3 cut at a stage (the port of scripts/probe_r5_kbisect.py)

def _trace_staged_torch(stage, rays, cell_rows, block_cells, nb, block_ids,
                        kbuf, half, with_exit, num_blocks, pidx_offset=0,
                        out=None):
    """Plain PyTorch version of :func:`trace_staged`: K3's
    (``_trace._trace_torch``) for stages 5 and 6, which give its result,
    and its dense pairs (``_trace._chunks``) cut short for stages 1-4."""
    if stage >= 5:
        return _trace._trace_torch(rays, cell_rows, block_cells, nb,
                                   block_ids, kbuf, half, with_exit,
                                   num_blocks, pidx_offset, out)
    if out is None:
        out = _trace._outputs(num_blocks, rays.shape[1], kbuf, rays.device)
    tn_out, tf_out, pi_out, cnt_out = out
    cw = cell_rows.shape[2]
    for a0, a1, hit, tn, tf, pid in _trace._chunks(
            rays, cell_rows, block_cells, nb, half, pidx_offset):
        bids = block_ids[a0:a1]
        cnt_out[bids] = hit.sum(dim=-1, dtype=torch.int32)
        if stage == 3:      # the last candidate cell's hits, in lane order
            n, rt, C = hit.shape[0], hit.shape[1], hit.shape[2] // cw
            last = (nb[a0:a1].long() - 1).clamp(min=0)[:, None, None, None]
            hit, tn = (x.reshape(n, rt, C, cw).gather(
                2, last.expand(n, rt, 1, cw))[:, :, 0] for x in (hit, tn))
        if stage >= 3:
            pack = _trace._packer(hit, kbuf)
            tn_out[bids] = pack(tn, torch.inf)
        if stage == 4:
            pi_out[bids] = pack(pid, -1)
            if with_exit:
                tf_out[bids] = pack(tf, torch.inf)
    return out


def _trace_staged_cuda(stage, rays, cell_rows, block_cells, nb, block_ids,
                       kbuf, half, with_exit, out, pidx_offset=0):
    """Launch K3's cut at ``stage`` into preallocated outputs ``out`` (as
    ``_trace._outputs`` makes them) and add one to
    ``LAUNCHES[f'stage{stage}']``."""
    _trace._launchable(rays.shape[1], kbuf, with_exit)
    if _cuda.load_module('probes').trace_stage(
            rays, cell_rows, block_cells, nb, block_ids, *out, int(kbuf),
            float(2. * half), int(bool(with_exit)), int(pidx_offset),
            int(stage), _cuda.stream_getter()(rays.get_device())):
        LAUNCHES[f'stage{stage}'] += 1
    return out


def trace_staged(stage, rays, cell_rows, block_cells, nb, block_ids, kbuf,
                 half, with_exit, num_blocks, pidx_offset=0):
    """K3 cut at ``stage``, for measuring its parts (arguments as
    ``_trace.trace``).

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
    ``STAGE`` instance in the probes' module (counted in
    ``LAUNCHES[f'stage{stage}']``) or raise.
    """
    if stage not in STAGES:
        raise ValueError(f'stage must be one of {STAGES}, got {stage}')
    if rays.device.type == 'cpu':
        return _trace_staged_torch(stage, rays, cell_rows, block_cells, nb,
                                   block_ids, kbuf, half, with_exit,
                                   num_blocks, pidx_offset)
    if rays.device.type != 'cuda':
        raise ValueError(f'no spc trace for device {rays.device}')
    out = _trace._outputs(num_blocks, rays.shape[1], kbuf, rays.device)
    return _trace_staged_cuda(stage, rays, cell_rows, block_cells, nb,
                              block_ids, kbuf, half, with_exit, out,
                              pidx_offset)
