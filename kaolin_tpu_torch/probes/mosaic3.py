"""P1: the port of ``scripts/probe_r5_mosaic3.py`` (kernels kA..kH).

The TPU script bisected what Mosaic would compile for K3: a loop whose
bound is read at run time (kA), table rows copied into scratch by DMA in a
loop, double buffered (kB) or not (kC, kD with a run-time bound), and lane
and row rolls (kE..kH).  On the card each is a CUDA kernel
(``csrc/probes.cu``, wrappers in :mod:`._kernels`), and the question is
what each costs; kB against kC at K3's staging shape (one row of 4 x 192
cell values per candidate cell, 61 cells for each of 4,452 blocks) is the
gain of a double-buffered row copy where K3 stages its cell rows.

Run on the card: ``python -m kaolin_tpu_torch.probes.mosaic3``.
"""

import numpy as np
import torch
import torch.nn.functional as F

from kaolin_tpu_torch.probes import (_kernels, main, max_abs_err, same_bits,
                                     seeded)
from kaolin_tpu_torch.utils.measure import bound_ms, time_ms

__all__ = ['NB', 'R', 'C', 'M', 'CK', 'KERNELS', 'inputs', 'call', 'check',
           'run']

NB, R, C, M, CK = 64, 8, 128, 256, 8       # the script's shapes
KERNELS = ('kA', 'kB', 'kC', 'kD', 'kE', 'kF', 'kG', 'kH')
ROW_SUMS = ('kB', 'kC', 'kD')
# K3's staging shape on the SPC cell: active blocks, the most candidate
# cells of a block, one cell row (x, y, z, pid) x cell width
STAGING = dict(nb=4452, ck=61, rows=(4, 192))
ITERS, PLAIN_ITERS = 50, 5      # timed calls of a kernel, a plain version


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
    return 4 * 2 * nb * n, nb * n


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


def measure(inp, names):
    """Device times of the kernels in ``names`` on ``inp`` beside their
    plain versions, one library call where there is one, and the bound."""
    out = {}
    for name in names:
        args = _args(name, inp)
        kernel = getattr(_kernels, name)
        plain = _kernels.PLAIN[name]
        lib = _library(name, inp)
        nbytes, flops = _work(name, inp)
        bound, by = bound_ms(nbytes, flops)
        out[name] = dict(
            ms=time_ms(lambda: kernel(*args), ITERS),
            plain_ms=time_ms(lambda: plain(*args), PLAIN_ITERS),
            library_ms=None if lib is None else time_ms(lib, ITERS),
            bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    return out


def run(device='cuda', table_rows=None):
    """Check kA..kH against their plain versions on the script's inputs and
    on a random ``x`` (numpy seed 2); on CUDA also time them there and time
    kB, kC, kD at K3's staging shape with ``table_rows`` table rows (the
    cell table's row count; skipped when None).

    Returns dict(max_abs_err={name: x}, script={name: times},
    staging={name: times} or None); no times on the CPU.
    """
    device = torch.device(device)
    script = inputs(device)
    errs = check(script)
    noisy = dict(script, x=seeded((NB, R, C), 2, device))
    for name, e in check(noisy).items():
        errs[name] = max(errs[name], e)
    res = dict(max_abs_err=errs, script=None, staging=None)
    staging = None
    if table_rows is not None:
        staging = inputs(device, STAGING['nb'], STAGING['rows'],
                         int(table_rows), STAGING['ck'])
        for name, e in check(staging, ROW_SUMS).items():
            errs[name] = max(errs[name], e)
    if device.type != 'cuda':
        return res
    res['script'] = measure(script, KERNELS)
    if staging is not None:
        res['staging'] = measure(staging, ROW_SUMS)
    return res


if __name__ == '__main__':
    from kaolin_tpu_torch.probes import spc_cell
    main(lambda dev: run(dev, table_rows=spc_cell(dev)[
        'table'].rows.shape[0]))
