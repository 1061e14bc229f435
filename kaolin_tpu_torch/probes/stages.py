"""P2 and the trace by stage: the port of ``scripts/probe_r5_stages.py``.

The TPU script timed the coherent trace of the bench scene in growing
prefixes (S1 the culling candidates, S1b + the sort of blocks, S2 + the
segment gathers, S3 the whole trace) and the cost of one grid step of a
trivial Pallas kernel (``dummy_kernel``, P2).  Here:

* S1 = :func:`~kaolin_tpu_torch.render.spc.raster._cull_candidates` (beam
  boxes, super-tile x cell and block x candidate tests, first-k packs);
* S1b = S1 + :func:`~kaolin_tpu_torch.render.spc.raster._order_blocks`
  (a stable sort of every block by candidate count, the non-empty first,
  cut to the fixed ``max_active_blocks``; segment caps);
* S2 = S1b + :func:`~kaolin_tpu_torch.render.spc.raster._gather_inputs`
  (K3's rays and candidate lists): the whole culling;
* S3 = ``unbatched_raytrace_coherent`` with the prebuilt cell table;
* on their own: K3 into allocated outputs, and the allocation and fill of
  the three k-buffer outputs;
* S3 as it was before K3 wrote the final pidx (:func:`trace_offset_after`:
  K3 with offset 0, then a pass ``where(pidx >= 0, pidx + offset, -1)`` over
  the whole k-buffer): S3 beside it is what the fused offset saves;

all on the SPC cell of ``chip_smoke.py`` (uv_sphere(100, 51) at radius
0.45, level 10, 1024^2 rays, rt 32, knum 256, the bench's segments), and
the dummy kernel (``o = 2 x``, a CTA per (8, 128) step, in and out of
shared memory by the copy engine) at 65,536 and 262,144 steps, in turns
with ``torch.mul(x, 2.)`` and by both timers: ``ms`` per call as Python
pays it and ``device_ms`` on the device alone (a CUDA graph's replay),
with ns per step and the bound.

Run on the card: ``python -m kaolin_tpu_torch.probes.stages``.
"""

import torch

from kaolin_tpu_torch.probes import (_kernels, main, max_abs_err, mosaic3,
                                     same_bits, seeded, spc_cell)
from kaolin_tpu_torch.render.spc import _trace
from kaolin_tpu_torch.render.spc.raster import (
    CoherentHits, _cull_candidates, _cull_settings, _gather_inputs,
    _order_blocks, _pad_rays, _trace_cells, trace_inputs,
    unbatched_raytrace_coherent)
from kaolin_tpu_torch.utils.measure import (TRACE, bound_ms, device_ms,
                                            in_turns, time_ms)

__all__ = ['NSTEPS', 'STEP', 'dummy_inputs', 'dummy_work', 'check_dummy',
           'measure_dummy', 'trace_offset_after', 'run']

NSTEPS = (65536, 262144)        # the script's grid sizes
STEP = (8, 128)                 # one grid step's block
ITERS = 5                       # timed calls of each stage
# timed calls of P2 and of torch.mul, per timer and turn: at 262,144 steps
# each call makes a 1 GiB output, and device_ms captures all of them in
# one graph, whose pool reuses a freed output (peak printed as peak_gib)
P2_ITERS = 20


def dummy_inputs(nsteps, device, seed=None):
    """The script's input ``ones((nsteps, 8, 128))``, or a seeded normal
    one."""
    if seed is None:
        return torch.ones((nsteps,) + STEP, device=device)
    return seeded((nsteps,) + STEP, seed, device)


def dummy_work(nsteps):
    """(bytes, float32 operations) of P2 over ``nsteps`` steps: x read
    once, 2 x written once, one product an element."""
    return mosaic3.shift_work(nsteps, STEP)


def check_dummy(nsteps, device):
    """The dummy kernel against 2 x, bit for bit, on ones and on a random
    x; returns max |kernel - plain|."""
    err = 0.
    for seed in (None, 3):
        x = dummy_inputs(nsteps, device, seed)
        out = _kernels.dummy(x)
        ref = _kernels.PLAIN['dummy'](x)
        if not same_bits(out, ref):
            raise RuntimeError('the dummy kernel differs from 2 x')
        err = max(err, max_abs_err(out, ref))
    return err


def measure_dummy(nsteps, device, iters=P2_ITERS):
    """P2 at ``nsteps`` steps beside ``torch.mul(x, 2.)``: each timer in
    turns (kernel, library, library, kernel; :func:`in_turns`), ``ms`` per
    call (:func:`time_ms`) and ``device_ms`` on the device
    (:func:`device_ms`, after one untimed graph of each), ns per step by
    each, the plain version's ``ms``, the bound and the peak device memory
    of the timing (GiB)."""
    x = dummy_inputs(nsteps, device)
    kernel = lambda: _kernels.dummy(x)
    lib = lambda: torch.mul(x, 2.)
    nbytes, flops = dummy_work(nsteps)
    bound, by = bound_ms(nbytes, flops)
    torch.cuda.reset_peak_memory_stats(device)
    ms, lib_ms = in_turns(time_ms, kernel, lib, iters)
    # the first graph in fresh pool memory after the trace's allocations can
    # read slow: one untimed graph of each first
    device_ms(kernel, iters)
    device_ms(lib, iters)
    dev_ms, lib_dev_ms = in_turns(device_ms, kernel, lib, iters)
    return dict(
        ms=ms, device_ms=dev_ms, library_ms=lib_ms,
        library_device_ms=lib_dev_ms,
        plain_ms=time_ms(lambda: _kernels.PLAIN['dummy'](x), ITERS),
        ns_per_step=ms * 1e6 / nsteps,
        device_ns_per_step=dev_ms * 1e6 / nsteps,
        bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops,
        peak_gib=torch.cuda.max_memory_allocated(device) / 2 ** 30)


def _dummy_untimed(nsteps):
    """P2's entry where nothing is timed: the work and the bound, None for
    every time."""
    nbytes, flops = dummy_work(nsteps)
    bound, by = bound_ms(nbytes, flops)
    return dict(dict.fromkeys(('ms', 'device_ms', 'library_ms',
                               'library_device_ms', 'plain_ms',
                               'ns_per_step', 'device_ns_per_step',
                               'peak_gib')),
                bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)


def trace_offset_after(cell):
    """The trace of the SPC cell with the pidx offset as a pass of its own:
    K3 writes leaf indices (``pidx_offset`` 0) and ``torch.where`` adds the
    level's offset to the live ones afterwards.  The same
    :class:`CoherentHits` as ``unbatched_raytrace_coherent`` gives, bit for
    bit, at the cost of a read and a write of the pidx buffer."""
    table = cell['table']
    tns, tfs, pis, cnt, sat = _trace_cells(
        table, cell['o'], cell['d'], TRACE['rays_per_tile'], TRACE['knum'],
        TRACE['segments'], TRACE['max_super_voxels'],
        TRACE['max_active_blocks'], TRACE['with_exit'], pidx_offset=0)
    pis = torch.where(pis >= 0, pis + table.offset, -1)
    return CoherentHits(tns, tfs, pis, cnt, sat)


def _culling(cell):
    """Closures of the trace's stages on the SPC cell with TRACE's
    settings."""
    table = cell['table']
    rt = TRACE['rays_per_tile']
    origin, direction = _pad_rays(cell['o'], cell['d'], rt)
    nB = origin.shape[0] // rt
    _, segs, cs, ne_cap = _cull_settings(
        table, nB, TRACE['knum'], TRACE['segments'],
        TRACE['max_super_voxels'], TRACE['max_active_blocks'])
    ck_max = segs[0][1]
    o = origin.reshape(nB, rt, 3)
    d = direction.reshape(nB, rt, 3)

    def s1():
        return _cull_candidates(table.blo, table.bhi, o, d, cs, ck_max)

    def s1b():
        return _order_blocks(s1()[0], segs, ck_max, ne_cap)

    def s2():
        n_b, blk_ids, _ = s1()
        block_ids = _order_blocks(n_b, segs, ck_max, ne_cap)[0]
        return _gather_inputs(o, d, blk_ids, block_ids)

    def s3():
        return unbatched_raytrace_coherent(
            cell['octree'], cell['ph'], cell['pyramid'], cell['exsum'],
            cell['o'], cell['d'], table.level, engine='mosaic',
            cell_table=table, **TRACE)
    return dict(s1=s1, s1b=s1b, s2=s2, s3=s3, nB=nB, rt=rt)


def run(device='cuda', cell=None, offset_after=True):
    """Check the dummy kernel and the staged culling; on CUDA time them.

    ``cell``: a :func:`~kaolin_tpu_torch.probes.spc_cell` (default: the SPC
    cell on CUDA, a level-5 sphere with 64^2 rays on the CPU).  Returns
    dict(dummy={nsteps: {...}}, trace={stage: ms}, counts).  On CUDA the
    dummy kernel's captured launch is held against its eager one and
    timed at each of NSTEPS (:func:`measure_dummy`); on the CPU (16 steps)
    its entry has the work and the bound, and None for every time.  Raises if the stages do not compose to ``trace_inputs`` or if
    the trace differs from :func:`trace_offset_after`; ``offset_after``
    False leaves that comparison and its time (``s3_offset_after``) out, for
    a caller that has made them.
    """
    device = torch.device(device)
    cuda = device.type == 'cuda'
    if cell is None:
        cell = spc_cell(device) if cuda else spc_cell(device, 5, 64,
                                                       (24, 13))
    res = dict(dummy={}, trace=None)
    for n in (NSTEPS if cuda else (16,)):
        res['dummy'][n] = dict(_dummy_untimed(n),
                               max_abs_err=check_dummy(n, device))
        if cuda:
            mosaic3.check_captured(dict(x=dummy_inputs(n, device, 3)),
                                   ('dummy',))

    st = _culling(cell)
    sat1 = st['s1']()[2]
    block_ids, nb, sat2 = st['s1b']()
    rays, block_cells = st['s2']()
    args, sat_t = trace_inputs(cell['table'], cell['o'], cell['d'],
                               **{k: TRACE[k] for k in (
                                   'rays_per_tile', 'knum', 'segments',
                                   'max_super_voxels', 'max_active_blocks')})
    # the stages compose to the culling of the trace
    if not (same_bits((rays, block_cells, nb, block_ids),
                      (args['rays'], args['block_cells'], args['nb'],
                       args['block_ids']))
            and bool(sat1 | sat2) == bool(sat_t)):
        raise RuntimeError('the culling stages do not compose to '
                           'trace_inputs')
    hits = st['s3']()
    if offset_after and not same_bits(tuple(hits),
                                      tuple(trace_offset_after(cell))):
        raise RuntimeError('the trace with the offset written by K3 differs '
                           'from the trace with the offset pass after it')
    res['counts'] = dict(active_blocks=int((nb > 0).sum()),
                         traced_blocks=int(block_ids.shape[0]),
                         blocks=st['nB'], candidate_cells=int(nb.sum()),
                         hits=int(hits.count.sum()),
                         saturated=bool(hits.saturated))
    if not cuda:
        return res

    for n in NSTEPS:
        res['dummy'][n].update(measure_dummy(n, device))

    out = _trace._outputs(args['num_blocks'], st['rt'], args['kbuf'],
                          device)
    launch = {k: v for k, v in args.items() if k != 'num_blocks'}
    res['trace'] = dict(
        s1=time_ms(st['s1'], ITERS), s1b=time_ms(st['s1b'], ITERS),
        s2=time_ms(st['s2'], ITERS), s3=time_ms(st['s3'], ITERS),
        k3=time_ms(lambda: _trace._launch(with_exit=TRACE['with_exit'],
                                          out=out, **launch), ITERS),
        fills=time_ms(lambda: _trace._outputs(
            args['num_blocks'], st['rt'], args['kbuf'], device), ITERS))
    if offset_after:
        res['trace']['s3_offset_after'] = time_ms(
            lambda: trace_offset_after(cell), ITERS)
    return res


if __name__ == '__main__':
    main(run)
