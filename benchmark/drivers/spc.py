"""The SPC trace: frames of camera rays through a level-``level`` octree.

Set-up voxelizes the cell's mesh through the program
(``ops/conversions/trianglemesh.py::unbatched_mesh_to_spc_device``), scans
it, decodes its point hierarchy and builds the cell table, as a viewer does
once per model; it makes the frames' rays (a ``side`` x ``side`` camera
grid in 4 x 4 pixel blocks, turned about the y axis to each of ``turns``
directions) and traces one frame per direction.  The window then traces
frames one at a time, each turned to the next direction of a seeded order,
through ``render/spc/raster.py::unbatched_raytrace_coherent`` with the
prebuilt table; a frame's latency runs from the call until its hits are
ready on a synchronise.  A frame whose trace saturated (a cap cut
candidates, or a ray's hits overflowed the k-buffer) counts as failed.

The comparison, after the window: the octree against the reference's
voxelization of the same mesh, and the hits of a sample of rays drawn from
the seed, in a sample of the window's frames drawn from the seed, against
the reference's trace of those rays through its own voxels.
"""

import math

import numpy as np
import torch

from benchmark.harness import scene, trace, work
from benchmark.harness.compare import judge
from benchmark.harness.context import Clock, Outcome
from benchmark.reference import spc as ref

__all__ = ['run', 'make_inputs']


def make_inputs(config, cell, device):
    """The mesh's triangles (F, 3, 3) float32 and the frames' rays, one
    (origin, direction) pair (turns, N, 3) float32 per direction."""
    mesh = cell['mesh']
    verts, faces, _ = scene.uv_sphere(mesh['n_lon'], mesh['n_lat'])
    fv = torch.as_tensor((verts * mesh['radius'])[faces], device=device)
    rays = cell['rays']
    o, d = scene.camera_grid(rays['side'], rays['z'], rays['spread'],
                             rays['extent'])
    perm = scene.block_order(rays['side'], rays['side'], rays['block'],
                             rays['block'])
    o, d = o[perm], d[perm]
    turns = [2 * math.pi * k / rays['turns'] for k in range(rays['turns'])]
    origin = np.stack([scene.turn_y(o, a) for a in turns]).astype(np.float32)
    direction = np.stack([scene.turn_y(d, a) for a in turns]).astype(
        np.float32)
    return fv, (torch.as_tensor(origin, device=device),
                torch.as_tensor(direction, device=device))


def _trace_kwargs(config):
    t = dict(config['trace'])
    t['segments'] = tuple((None if a is None else int(a), int(b))
                          for a, b in t['segments'])
    return t


def run(ctx):
    from kaolin_tpu_torch.ops.conversions.trianglemesh import \
        unbatched_mesh_to_spc_device
    from kaolin_tpu_torch.ops.spc import generate_points, scan_octrees
    from kaolin_tpu_torch.render.spc.raster import (
        build_cell_table, unbatched_raytrace_coherent)
    config, cell, dev = ctx.config, ctx.cell, ctx.device
    clock = Clock(dev)
    level = config['level']
    fv, (origin, direction) = make_inputs(config, cell, dev)
    turns, N = origin.shape[:2]
    kw = _trace_kwargs(config)
    knum = kw['knum']

    # the program's set-up, as a viewer makes it once per model
    octree, _, _, _ = unbatched_mesh_to_spc_device(fv, level,
                                                   cap=config['cap'])
    _, pyramids, exsum = scan_octrees(octree, [octree.shape[0]])
    ph = generate_points(octree, pyramids, exsum)
    table = build_cell_table(ph, pyramids[0], level,
                             cell_shift=config['cell_shift'],
                             cell_width=config['cell_width'])

    def frame(t):
        return unbatched_raytrace_coherent(
            octree, ph, pyramids[0], exsum, origin[t], direction[t], level,
            engine='mosaic', cell_table=table, **kw)

    order = scene.schedule(ctx.seed, turns, 1, cell['rounds']).reshape(-1)
    order = order.tolist()
    g = scene.generator(ctx.seed, 'cpu')
    sample = cell['sample']
    picked = torch.randperm(sample['within'], generator=g)[:sample['frames']]
    picked = set(picked.tolist())
    ray_ids = {f: torch.randperm(N, generator=g)[:sample['rays']].to(dev)
               for f in sorted(picked)}
    for t in range(turns):
        frame(t)
    clock.sync()
    setup_s = clock.now() - ctx.t0

    # the window
    kept, lat = {}, []
    sat = torch.zeros((), dtype=torch.int64, device=dev)
    f = 0
    t_start = clock.now()
    while clock.now() - t_start < ctx.seconds:
        a = clock.now()
        hits = frame(order[f % len(order)])
        clock.sync()
        lat.append(clock.now() - a)
        sat += hits.saturated.to(torch.int64)
        if f in picked:
            ids = ray_ids[f]
            kept[f] = (order[f % len(order)], ids, hits.count[ids].clone(),
                       hits.pidx[ids].clone(), hits.t_near[ids].clone())
        f += 1
    clock.sync()
    window_s = clock.now() - t_start
    peak = clock.peak()
    del hits

    record = None
    if ctx.trace:
        counts = [None] * turns
        start = -(-f // turns) * turns

        def block():
            for j in range(start, start + turns):
                t = order[j % len(order)]
                counts[t] = frame(t).count
        record = trace.profiled(block, turns, ctx.trace_path, clock.sync)
        counts = [int(c.sum()) for c in counts]
        off = int(pyramids[0][1, level])
        leaf = ph[off:off + int(pyramids[0][0, level])]
        nbytes = flops = 0
        for t in range(turns):
            b, fl = work.k3_work(leaf, level, config['cell_shift'],
                                 origin[t], direction[t], counts[t])
            nbytes, flops = nbytes + b, flops + fl
        record['work'] = dict(k3_bytes=nbytes / turns, k3_flops=flops / turns)
        record['memory_peak_bytes'] = peak

    failed = int(sat)
    off, V = int(pyramids[0][1, level]), int(pyramids[0][0, level])
    leaf = ph[off:off + V].to(torch.int64)
    last = ph.shape[0] - 1
    answers = [(t, ids, cnt, torch.where(pidx >= 0, ref.morton(
        ph[pidx.long().clamp(0, last)].to(torch.int64)), -1), tn)
        for t, ids, cnt, pidx, tn in kept.values()]
    values = compare(octree, leaf, fv, level, origin, direction, answers,
                     knum)
    values['rays_missing'] = sample['frames'] * sample['rays'] - values.pop(
        'rays_compared')
    checks = judge(values, cell['limits'])
    return Outcome(
        values=dict(spc_mrays_s=N * f / window_s / 1e6,
                    spc_frame_p95_ms=float(np.percentile(lat, 95)) * 1e3,
                    setup_s=setup_s),
        attempted=f, failed=failed, checks=checks, memory_peak_bytes=peak,
        record=record)


def compare(octree, leaf, fv, level, origin, direction, answers, knum):
    """The numbers compared: the leaf voxels and octree bytes against the
    reference's voxelization of the mesh ``fv``; each answer (direction,
    ray ids, count, the morton codes of the voxels hit (-1 padded), entry
    depths) against the reference's trace of the same rays through its
    own voxels."""
    vox = ref.voxelize(fv, level)
    mine = ref.morton(leaf)
    theirs = ref.morton(vox)
    both = torch.cat([mine, theirs]).unique(return_counts=True)[1]
    voxels_differ = int((both == 1).sum()) + (mine.numel() - int(
        mine.unique().numel()))
    ob = ref.octree_bytes(vox, level)
    pb = octree.to(ob.device)
    n = min(ob.numel(), pb.numel())
    bytes_differ = int((ob[:n] != pb[:n]).sum()) + abs(ob.numel()
                                                       - pb.numel())
    rays_differ = rays = 0
    t_err = 0.
    for t, ids, cnt, code, tn in answers:
        r_cnt, r_t, r_id = ref.trace(vox, level, origin[t][ids],
                                     direction[t][ids], knum)
        r_code = torch.where(r_id >= 0, theirs[r_id.clamp(min=0)], -1)
        same = (cnt.long() == r_cnt) & (
            torch.sort(code, 1).values == torch.sort(r_code, 1).values
        ).all(1)
        rays += ids.numel()
        rays_differ += int((~same).sum())
        if same.any():
            a = torch.sort(tn[same].float(), 1).values
            b = torch.sort(r_t[same], 1).values
            fin = torch.isfinite(b)
            if fin.any():
                t_err = max(t_err, float((a - b).abs()[fin].max()))
    return dict(voxels_differ=voxels_differ, octree_bytes_differ=bytes_differ,
                rays_differ=rays_differ, t_near_err=t_err, rays_compared=rays)
