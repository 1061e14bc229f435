"""P1: the port of ``scripts/probe_r5_mosaic3.py`` (kernels kA..kH).

The TPU script bisected what Mosaic would compile for K3: a loop whose
bound is read at run time (kA), table rows copied into scratch by DMA in a
loop, double buffered (kB) or not (kC, kD with a run-time bound), and lane
and row rolls (kE..kH).  On the card each is a CUDA kernel
(``csrc/probes.cu``, wrappers in :mod:`._kernels`), and the question is
what each costs.  kB stages each row in shared memory by the copy engine
(a ring of ``KB_SLOTS`` slots, TMA bulk copies and mbarriers); kC loads
the same rows straight into registers (kD's kernel with every count CK).
At K3's staging shape (one row of 4 x 192 cell values per candidate cell,
61 cells for each of 4,452 blocks) kB against kC says whether staging
rows through shared memory pays, for rows each thread reads once.  kA and
kE..kH are also timed at a large shape (P2's grid), where their bound lies
above the launch latency.  Every time comes twice: ``ms``, per call as a
Python caller pays it, and ``device_ms``, the device's time without the
host (a CUDA graph's replay); a library call that computes the same
function is timed both ways beside it, in turns with the kernel.

Run on the card: ``python -m kaolin_tpu_torch.probes.mosaic3``.
"""

import ctypes
import time

import numpy as np
import torch
import torch.nn.functional as F

from kaolin_tpu_torch.probes import (_kernels, main, max_abs_err, same_bits,
                                     seeded)
from kaolin_tpu_torch.utils.measure import (bound_ms, device_ms, in_turns,
                                            replayed, time_ms)

__all__ = ['NB', 'R', 'C', 'M', 'CK', 'KERNELS', 'SHIFTS', 'LARGE',
           'LARGE_NB', 'inputs', 'large_inputs', 'call', 'check',
           'check_captured', 'shift_work', 'measure', 'host_us', 'run']

NB, R, C, M, CK = 64, 8, 128, 256, 8       # the script's shapes
KERNELS = ('kA', 'kB', 'kC', 'kD', 'kE', 'kF', 'kG', 'kH')
ROW_SUMS = ('kB', 'kC', 'kD')
SHIFTS = ('kE', 'kF', 'kG', 'kH')
LARGE = ('kA',) + SHIFTS        # timed at the large shape too
# K3's staging shape on the SPC cell: active blocks, the most candidate
# cells of a block, one cell row (x, y, z, pid) x cell width
STAGING = dict(nb=4452, ck=61, rows=(4, 192))
# the large shape of kA and kE..kH: P2's 65,536 blocks of (R, C) float32,
# where the bound (~0.16 ms, bytes) lies above the launch latency
LARGE_NB = 65536
ITERS, PLAIN_ITERS = 50, 5      # timed calls of a kernel, a plain version
LARGE_ITERS = 20
HOST_CALLS = 2000                 # calls per part in host_us


def inputs(device, nb=NB, rows=(R, C), m=M, ck=CK):
    """The script's inputs: ``table = arange(m * R * C)`` as (m, R, C),
    ``ids`` from ``default_rng(0).integers(0, m, (nb, 1, ck))``, ``nbs``
    from ``default_rng(1).integers(1, ck + 1, (nb, 2))``, ``x`` ones."""
    table = torch.arange(m * rows[0] * rows[1], dtype=torch.float32,
                         device=device).reshape(m, *rows)
    ids = np.random.default_rng(0).integers(0, m, (nb, 1, ck))
    nbs = np.random.default_rng(1).integers(1, ck + 1, (nb, 2))
    return dict(table=table,
                ids=torch.as_tensor(ids, dtype=torch.int32, device=device),
                nbs=torch.as_tensor(nbs, dtype=torch.int32, device=device),
                x=torch.ones((nb,) + tuple(rows), device=device))


def _args(name, inp):
    if name == 'kA':
        return inp['nbs'], inp['x']
    if name in ('kB', 'kC'):
        return inp['ids'], inp['table'], inp['x']
    if name == 'kD':
        return inp['nbs'], inp['ids'], inp['table'], inp['x']
    return (inp['x'],)


def call(name, inp):
    """The wrapper of kernel ``name`` on the inputs ``inp``."""
    return getattr(_kernels, name)(*_args(name, inp))


def check(inp, names=KERNELS):
    """Each kernel against its plain version on the same inputs, bit for
    bit; raises on a difference.  Returns {name: max |kernel - plain|}."""
    errs = {}
    for name in names:
        out = call(name, inp)
        ref = _kernels.PLAIN[name](*_args(name, inp))
        if not same_bits(out, ref):
            raise RuntimeError(f'probe kernel {name} differs from its plain '
                               f'version (max |d| {max_abs_err(out, ref)})')
        errs[name] = max_abs_err(out, ref)
    return errs


def shift_work(nb, rows):
    """(bytes, float32 operations) of ``x + shift(x)`` (kE..kH; also kA's
    output and P2's) over ``nb`` blocks of ``rows`` float32: x read once,
    the output written once, one add an element."""
    n = nb * int(np.prod(rows))
    return 4 * 2 * n, n


def _work(name, inp):
    """(bytes, float32 operations) the function needs on these inputs:
    each input it reads once (each distinct table row once), each output
    written once."""
    x, nbs, ids = inp['x'], inp['nbs'], inp['ids'][:, 0]
    nb, n = x.shape[0], x[0].numel()
    if name in ROW_SUMS:
        if name == 'kD':
            cnt = nbs[:, 0].long()
            used = torch.arange(ids.shape[1], device=ids.device)[None] \
                < cnt[:, None]
            ids = ids[used]
            adds = int(cnt.sum()) * n
        else:
            adds = ids.numel() * n
        rows = int(torch.unique(ids).numel())
        return 4 * (rows * n + ids.numel() + nb * n), adds
    if name == 'kA':
        return 4 * (2 * nb * n + nb), int(nbs[:, 0].sum()) * n
    return shift_work(nb, x.shape[1:])


def _library(name, inp):
    """One PyTorch call that computes the same function, or None: a
    product for kA, a bag sum of table rows for kB..kD."""
    x, nbs, ids, table = inp['x'], inp['nbs'], inp['ids'][:, 0], inp['table']
    if name == 'kA':
        scale = nbs[:, :1, None].to(x.dtype)
        return lambda: torch.mul(x, scale)
    if name in ROW_SUMS:
        flat = table.reshape(table.shape[0], -1)
        if name == 'kD':
            used = torch.arange(ids.shape[1], device=ids.device)[None] \
                < nbs[:, :1]
            bag = ids[used].long()
            offsets = torch.cumsum(nbs[:, 0].long(), 0) - nbs[:, 0].long()
            return lambda: F.embedding_bag(bag, flat, offsets, mode='sum')
        bag = ids.long()
        return lambda: F.embedding_bag(bag, flat, mode='sum')
    return None


def measure(inp, names, iters=ITERS):
    """Times of the kernels in ``names`` on ``inp`` beside their plain
    versions, one library call where there is one, and the bound.  Each
    kernel and library call has two: ``ms`` per call as a Python caller
    pays it (:func:`time_ms`) and ``device_ms`` without the host
    (:func:`device_ms`, one CUDA graph of ``iters`` calls).  The library
    call's inputs (kD's bag and offsets too) are made before it is timed."""
    out = {}
    for name in names:
        args = _args(name, inp)
        kernel = getattr(_kernels, name)
        plain = _kernels.PLAIN[name]
        lib = _library(name, inp)
        nbytes, flops = _work(name, inp)
        bound, by = bound_ms(nbytes, flops)
        ms, lib_ms = in_turns(time_ms, lambda: kernel(*args), lib, iters)
        dev_ms, lib_dev_ms = in_turns(device_ms, lambda: kernel(*args), lib,
                                      iters)
        out[name] = dict(
            ms=ms, device_ms=dev_ms,
            plain_ms=time_ms(lambda: plain(*args), PLAIN_ITERS),
            library_ms=lib_ms, library_device_ms=lib_dev_ms,
            bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    return out


def host_us(inp, calls=HOST_CALLS):
    """Host microseconds per call (``time.perf_counter`` over ``calls``
    calls, no sync inside) of kA and kD beside their library calls, and of
    the parts of a launch from Python: what :func:`time_ms` reads where the
    host is slower than the device.  The wrappers' route (the extension
    module's entry: test, allocation and launch in C++) is timed beside the
    parts of the ctypes route (``torch.empty_like``, the ctypes call of the
    same C entry with and without its launch, the stream)."""
    from kaolin_tpu_torch import _cuda
    x, nbs = inp['x'], inp['nbs']
    i = x.get_device()
    ext = _cuda.load_module('probes')
    stream = _cuda.stream_getter()
    c_entry = _cuda.load('probes').probe_dyn_loop
    c_entry.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                        ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_void_p]
    c_entry.restype = ctypes.c_int
    out = torch.empty_like(x)
    ptrs = nbs.data_ptr(), nbs.shape[1], x.data_ptr(), out.data_ptr()
    nb, n = x.shape[0], x[0].numel()
    parts = {
        'kA': lambda: _kernels.kA(nbs, x),
        'torch.mul': _library('kA', inp),
        'kD': lambda: call('kD', inp),
        'F.embedding_bag': _library('kD', inp),
        'kA entry of the extension': lambda: ext.dyn_loop(nbs, x, stream(i)),
        'torch.empty_like': lambda: torch.empty_like(x),
        'ctypes entry, no launch': lambda: c_entry(*ptrs, 0, n, stream(i)),
        'ctypes entry and launch': lambda: c_entry(*ptrs, nb, n, stream(i)),
        'stream, raw': lambda: stream(i),
        'stream, torch.cuda.current_stream': (
            lambda: torch.cuda.current_stream(i).cuda_stream),
    }
    res = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        res[name] = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
    return res


def large_inputs(device):
    """The large shape: P2's grid of LARGE_NB blocks of (R, C) float32,
    ``x`` from numpy seed 2, ``nbs`` from ``default_rng(1)`` in 1..CK (as
    :func:`inputs` draws them)."""
    return dict(inputs(device, LARGE_NB),
                x=seeded((LARGE_NB, R, C), 2, device))


def check_captured(inp, names=KERNELS):
    """Each kernel's launch captured in a CUDA graph and replayed against
    the same launch made eagerly, bit for bit; raises on a difference."""
    for name in names:
        eager = call(name, inp)
        graph = replayed(lambda: call(name, inp))
        if not same_bits(eager, graph):
            raise RuntimeError(f'probe kernel {name}: a captured launch '
                               f'differs from an eager one (max |d| '
                               f'{max_abs_err(eager, graph)})')


def run(device='cuda', table_rows=None):
    """Check kA..kH against their plain versions on the script's inputs and
    on a random ``x`` (numpy seed 2), bit for bit; with ``table_rows`` (the
    cell table's row count) also kB, kC, kD at K3's staging shape.  On CUDA
    also kA and kE..kH at the large shape (:func:`large_inputs`), each
    kernel's captured launch against its eager one (kB, kC, kD at the
    staging shape too), and the times (:func:`measure`) at the script's
    shape, the large shape and the staging shape, and the host's share of
    a launch (:func:`host_us`).

    Returns dict(max_abs_err={name: x}, script={name: times},
    staging={name: times} or None, large={name: times} (kA, kE..kH),
    host_us={part: us}); no times on the CPU.
    """
    device = torch.device(device)
    script = inputs(device)
    errs = check(script)
    noisy = dict(script, x=seeded((NB, R, C), 2, device))

    def fold(more):
        for name, e in more.items():
            errs[name] = max(errs[name], e)

    fold(check(noisy))
    res = dict(max_abs_err=errs, script=None, staging=None, large=None,
               host_us=None)
    staging = None
    if table_rows is not None:
        staging = inputs(device, STAGING['nb'], STAGING['rows'],
                         int(table_rows), STAGING['ck'])
        fold(check(staging, ROW_SUMS))
    if device.type != 'cuda':
        return res
    large = large_inputs(device)
    fold(check(large, LARGE))
    check_captured(noisy)
    if staging is not None:
        check_captured(staging, ROW_SUMS)
    res['host_us'] = host_us(script)
    res['script'] = measure(script, KERNELS)
    res['large'] = measure(large, LARGE, LARGE_ITERS)
    if staging is not None:
        res['staging'] = measure(staging, ROW_SUMS)
    return res


if __name__ == '__main__':
    from kaolin_tpu_torch.probes import spc_cell
    main(lambda dev: run(dev, table_rows=spc_cell(dev)[
        'table'].rows.shape[0]))
