"""P3: the port of ``scripts/probe_r5_kbisect.py``, K3 by stage.

The TPU script compiled the trace kernel cut after each of its parts to
find which one Mosaic refused.  Here the same cuts are instances of K3's
own kernel (:func:`~kaolin_tpu_torch.render.spc._trace.trace_staged`,
``csrc/spc_trace.cu``), and the question is what each part costs: the
stages' times at the SPC cell's K3 inputs, and each stage's delta over the
one before, are K3's breakdown into slab tests, hit ranks, packing,
k-buffer append and sort.

Inputs in the script's layout: rays (NBS, RT, 8) with columns 0-5 =
origin and 1 / direction; cells (NBS * CKB, 1, 8, CW) int32 with rows 0-3
= voxel x, y, z at level 10 and the leaf index (-1 pads); nb (NBS,) cells
to read per block.  :func:`from_probe_layout` maps them onto K3's
arguments.  The script's random inputs give no hit at all, so
:func:`hit_scene` adds rays that run along rows of voxels.

Run on the card: ``python -m kaolin_tpu_torch.probes.kbisect``.
"""

import numpy as np
import torch

from kaolin_tpu_torch.probes import main, max_abs_err, same_bits, spc_cell
from kaolin_tpu_torch.render.spc import _trace
from kaolin_tpu_torch.render.spc._trace import (STAGES, _trace_staged_torch,
                                                trace_staged)
from kaolin_tpu_torch.render.spc.raster import trace_inputs
from kaolin_tpu_torch.utils.measure import TRACE, bound_ms, time_ms

__all__ = ['RT', 'CW', 'KBUF', 'CKB', 'NBS', 'HALF', 'probe_inputs',
           'hit_scene', 'from_probe_layout', 'check_stages', 'trace_work',
           'run']

RT, CW, KBUF, CKB, NBS = 16, 192, 256, 8, 64    # the script's shapes
HALF = 1.0 / 1024                               # voxel half side, level 10
# float32 operations K3's function needs: the fewest known to reach the
# plain version's bits (csrc/spc_trace.cu::slab).  The plain version
# (raytrace.voxel_slab and the hit rule) spends 22 on a pair: a min and a
# max per axis where a sum with the step split by sign does, and tf > 0,
# which tf > tn > 0 implies
PAIR_FLOPS = 18     # a (ray, voxel) slab test: 3 x (sub, mul, add n, add p),
#                     2 max for t_near, 2 min for t_far, 2 compares
VOXEL_FLOPS = 9     # a voxel's corner: 3 x (int -> float, mul, sub)
RAY_FLOPS = 3       # a ray's side / direction: 3 mul
ITERS = 20          # timed launches of each stage
SPC_KEYS = ('rays_per_tile', 'knum', 'segments', 'max_super_voxels',
            'max_active_blocks')


def probe_inputs(nbs=NBS, seed=0):
    """The script's ``run_stage`` inputs, numpy: (nb (nbs,) int32 in
    [0, CKB], rays (nbs, RT, 8) f32 normal, cells (nbs * CKB, 1, 8, CW)
    int32 in [0, 1024))."""
    rng = np.random.default_rng(seed)
    nb = rng.integers(0, CKB + 1, (nbs,)).astype(np.int32)
    rays = rng.normal(size=(nbs, RT, 8)).astype(np.float32)
    cells = rng.integers(0, 1024, (nbs * CKB, 1, 8, CW)).astype(np.int32)
    return nb, rays, cells


def hit_scene(nbs=8, seed=1):
    """Inputs in the script's layout where rays hit hundreds of voxels.

    Block b holds a row of 300-1024 level-10 voxels along x, scattered over
    its CKB * CW slots (pid = slot), the other slots random voxels or
    padding (pid -1).  Rays 0-11 run along the row (hitting every row voxel
    in the cells they read), rays 12-15 are random.  nb cycles through
    8, 8, 5, 0, 8, 3, 1, 8.  Returns (nb, rays, cells) as
    :func:`probe_inputs`.
    """
    rng = np.random.default_rng(seed)
    slots = CKB * CW
    side = 2. * HALF
    nb = np.array([8, 8, 5, 0, 8, 3, 1, 8] * -(-nbs // 8))[:nbs]
    rays = np.zeros((nbs, RT, 8), np.float32)
    cells = np.zeros((nbs, slots, 8), np.int32)
    for b in range(nbs):
        y, z = rng.integers(0, 1024, 2)
        k = int(rng.integers(300, 1025))
        xyz = rng.integers(0, 1024, (slots, 3))
        pid = np.where(rng.random(slots) < 0.5, np.arange(slots), -1)
        on_row = rng.permutation(slots)[:k]
        xyz[on_row] = np.stack([rng.permutation(1024)[:k],
                                np.full(k, y), np.full(k, z)], -1)
        pid[on_row] = on_row
        cells[b, :, :3] = xyz
        cells[b, :, 3] = pid
        o = np.stack([np.full(12, -1.2),
                      (y + 0.5 + rng.uniform(-0.3, 0.3, 12)) * side - 1.,
                      (z + 0.5 + rng.uniform(-0.3, 0.3, 12)) * side - 1.],
                     -1)
        dr = np.concatenate([np.ones((12, 1)),
                             rng.uniform(-1e-5, 1e-5, (12, 2))], -1)
        o = np.concatenate([o, rng.uniform(-1.5, 1.5, (4, 3))])
        dr = np.concatenate([dr, rng.normal(size=(4, 3))])
        dr /= np.linalg.norm(dr, axis=-1, keepdims=True)
        rays[b, :, :3] = o
        rays[b, :, 3:6] = 1. / dr
    cells = cells.reshape(nbs, CKB, CW, 8).transpose(0, 1, 3, 2)
    return (nb.astype(np.int32), rays,
            np.ascontiguousarray(cells.reshape(nbs * CKB, 1, 8, CW)))


def from_probe_layout(nb, rays, cells, device):
    """K3's arguments (:func:`~kaolin_tpu_torch.render.spc._trace.trace`
    but ``with_exit``) for inputs in the script's layout: block b reads
    cells b * CKB .. b * CKB + nb[b] - 1 and writes output row b."""
    nbs = rays.shape[0]
    ckb = cells.shape[0] // nbs
    return dict(
        rays=torch.as_tensor(rays[:, :, :6], device=device).contiguous(),
        cell_rows=torch.as_tensor(cells[:, 0, :4],
                                  device=device).contiguous(),
        block_cells=torch.arange(nbs * ckb, dtype=torch.int32,
                                 device=device).reshape(nbs, ckb),
        nb=torch.as_tensor(nb, dtype=torch.int32, device=device),
        block_ids=torch.arange(nbs, device=device), kbuf=KBUF, half=HALF,
        num_blocks=nbs)


def check_stages(args, with_exit, stages=STAGES):
    """Each stage of ``trace_staged`` against ``_trace_staged_torch`` on
    the same arguments, bit for bit; raises on a difference.  Returns
    ({stage: max |t_near kernel - plain|}, the last stage's output)."""
    errs, out = {}, None
    for stage in stages:
        out = trace_staged(stage, with_exit=with_exit, **args)
        ref = _trace_staged_torch(stage, with_exit=with_exit, **args)
        if not same_bits(out, ref):
            raise RuntimeError(f'trace stage {stage} differs from its plain '
                               f'version (with_exit={with_exit})')
        errs[stage] = max_abs_err(out[0], ref[0])
    return errs, out


def trace_work(args, count, with_exit):
    """(bytes, float32 operations, slab tests) K3 needs on ``args``.

    Operations: a slab test for each (ray, voxel) pair of a block's
    candidate cells, where only slots that hold a voxel (pid >= 0) count,
    each distinct voxel's corner once and each ray's side / direction once.
    Bytes: the rays, the block lists and the distinct cell rows read once,
    the kept hits and the counts written once.
    """
    nA, rt = args['rays'].shape[:2]
    cw = args['cell_rows'].shape[2]
    nb = args['nb']
    used = torch.arange(args['block_cells'].shape[1],
                        device=nb.device)[None] < nb[:, None]
    cells = args['block_cells'][used].long()
    live = (args['cell_rows'][:, 3] >= 0).sum(1)     # voxels per cell row
    rows = torch.unique(cells)
    tests = rt * int(live[cells].sum())
    flops = (PAIR_FLOPS * tests + VOXEL_FLOPS * int(live[rows].sum())
             + RAY_FLOPS * nA * rt)
    kept = int(torch.clamp(count, max=args['kbuf']).sum())
    nbytes = (args['rays'].numel() * 4 + rows.numel() * 4 * cw * 4
              + int(nb.sum()) * 4 + nA * (4 + 8)
              + kept * (12 if with_exit else 8) + nA * rt * 4)
    return nbytes, flops, tests


def _summary(out, kbuf):
    cnt = out[3]
    return dict(rays_hit=int((cnt > 0).sum()), hits=int(cnt.sum()),
                max_hits=int(cnt.max()), rays_over_64=int((cnt > 64).sum()),
                rays_over_kbuf=int((cnt > kbuf).sum()))


def run(device='cuda', spc_args=None, scenes=None):
    """Check every stage against its plain version, then time the stages
    at the SPC cell.

    ``scenes``: more K3 argument dicts to check ({name: args}); the
    script's inputs (``'probe'``) and :func:`hit_scene` (``'hits'``) are
    always checked, with and without exit depths.  ``spc_args``: K3's
    arguments at the SPC cell (default: built with ``trace_inputs``; on
    the CPU a level-5 sphere with 64^2 rays): every stage against its plain
    version and stage 6 against K3, bit for bit, then (CUDA only) every
    stage's time into allocated outputs, K3's time, the deltas and the
    bound.  A stage's delta is over the stage before it; stages 5 and 6,
    two sorts of stage 4's k-buffer, both count from stage 4.  Returns
    dict(max_abs_err={stage: x}, scenes, spc[, stages, k3_ms, bound_ms,
    ...]).
    """
    device = torch.device(device)
    cuda = device.type == 'cuda'
    all_scenes = dict(probe=from_probe_layout(*probe_inputs(8 if not cuda
                                                            else NBS),
                                              device),
                      hits=from_probe_layout(*hit_scene(), device))
    all_scenes.update(scenes or {})
    res = dict(scenes={}, max_abs_err={s: 0. for s in STAGES})
    errs = res['max_abs_err']
    for name, args in all_scenes.items():
        for with_exit in (True, False):
            e, out = check_stages(args, with_exit)
            errs.update({s: max(errs[s], e[s]) for s in STAGES})
        res['scenes'][name] = _summary(out, args['kbuf'])

    if spc_args is None:
        cell = spc_cell(device) if cuda else spc_cell(device, 5, 64, (24, 13))
        spc_args, _ = trace_inputs(cell['table'], cell['o'], cell['d'],
                                   **{k: TRACE[k] for k in SPC_KEYS})
    we = TRACE['with_exit']
    e, s6 = check_stages(spc_args, we)
    errs.update({s: max(errs[s], e[s]) for s in STAGES})
    k3 = _trace.trace(with_exit=we, **spc_args)
    if not same_bits(s6, k3):
        raise RuntimeError('trace stage 6 differs from K3 at the SPC cell')
    nbytes, flops, tests = trace_work(spc_args, k3[3], we)
    res['spc'] = _summary(k3, spc_args['kbuf'])
    res['spc'].update(active_blocks=int((spc_args['nb'] > 0).sum()),
                      traced_blocks=int(spc_args['nb'].shape[0]),
                      slab_tests=tests)
    if not cuda:
        return res

    out = _trace._outputs(spc_args['num_blocks'], spc_args['rays'].shape[1],
                          spc_args['kbuf'], device)
    launch = {k: v for k, v in spc_args.items() if k != 'num_blocks'}
    bound, by = bound_ms(nbytes, flops)
    stages = {}
    for stage in STAGES:
        ms = time_ms(lambda: _trace._launch(
            with_exit=we, out=out, stage=stage, counter=f'stage{stage}',
            **launch), ITERS)
        # stages 5 and 6 are two sorts after stage 4's append
        prev = stages[min(stage - 1, 4)]['ms'] if stage > 1 else 0.
        stages[stage] = dict(ms=ms, delta_ms=ms - prev, plain_ms=time_ms(
            lambda: _trace_staged_torch(stage, with_exit=we, **spc_args), 1))
    res['stages'] = stages
    res['k3_ms'] = time_ms(lambda: _trace._launch(with_exit=we, out=out,
                                                  **launch), ITERS)
    res.update(bound_ms=bound, bound_by=by, bytes=nbytes, flops=flops)
    return res


if __name__ == '__main__':
    main(run)
