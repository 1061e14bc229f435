"""DIB-R inverse rendering over several cards: every step renders all the
views, each card its share, through ``parallel/sharding.py``'s
``multi_view_grad`` (local autograd, then one all-reduce of the loss and
the gradients), and Adam on every card.

The driver spawns one process per card (start method ``spawn``); they
join a process group through a ``file://`` store under ``TMPDIR``.  Each
makes every input from the seed (the same on every card: the generators
run on the cards, the same stream on each), renders its share of the
targets through the program, and takes the fit's first three steps;
then every card takes steps until rank 0's clock has passed ``seconds``,
rank 0 broadcasting each step whether to go on (read two steps late, so
the host is not held at every step).  ``dibr_mpix_s`` counts every card's
views x H x W of every step over rank 0's window.

The comparison: on each card the reference follows the same three steps
on the same share of the views, the losses and gradients summed over the
cards by ``torch.distributed`` itself, and the numbers of
``drivers/dibr.py::numbers`` are held against it, the worst card's.
Each card reports the forbidden modules (``harness/env.py``) loaded in its
process once its window and reference are done; ``run.py`` prints no
result where one is.
"""

import os
import queue
import sys
import tempfile
import time
import traceback

import torch

from benchmark.drivers import dibr
from benchmark.harness import env, trace, work
from benchmark.harness.compare import judge
from benchmark.harness.context import Clock, Outcome
from benchmark.reference import dibr as ref

__all__ = ['run']

TIMEOUT_S = 330         # every rank's whole run, start-up included
TRACED_STEPS = 6


def run(ctx):
    world = ctx.cell['chips']
    cuda = ctx.device.type == 'cuda'
    if cuda:
        # build the kernels once, before the ranks load them
        from kaolin_tpu_torch import _cuda
        for name in ('dibr_fused', 'epilogue'):
            _cuda.load_module(name)
    mp = torch.multiprocessing.get_context('spawn')
    results = mp.Queue()
    args = dict(cell=ctx.cell, config=ctx.config, seed=ctx.seed,
                seconds=ctx.seconds, trace=ctx.trace, t0=ctx.t0,
                cuda=cuda, trace_path=str(ctx.trace_path), world=world)
    deadline = time.monotonic() + TIMEOUT_S
    with tempfile.TemporaryDirectory(prefix='bench_ranks_') as tmp:
        procs = [mp.Process(target=_rank, args=(
            r, 'file://' + os.path.join(tmp, 'store'), args, results))
            for r in range(world)]
        out = {}
        try:
            for p in procs:
                p.start()
            while len(out) < world:
                if time.monotonic() > deadline:
                    raise RuntimeError(f'multiview: the {world} ranks did '
                                       f'not finish within {TIMEOUT_S} s')
                try:
                    rank, status, payload = results.get(timeout=1.)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(f'multiview: rank {dead[0]} '
                                           f'exited with no result')
                    continue
                if status != 'ok':
                    raise RuntimeError(f'multiview: rank {rank} failed:\n'
                                       f'{payload}')
                out[rank] = payload
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
            results.close()
    lead = out[0]
    record = lead['record']     # rank 0's, which the per-layer readers read
    if record is not None:
        # the result line's device busy time and window: over the cards
        record['device_busy_s'] = sum(o['busy_s'] for o in out.values()) \
            / world
        record['device_window_s'] = sum(o['window_s'] for o in
                                        out.values()) / world
        record['memory_peak_bytes'] = max(o['peak'] for o in out.values())
    values = {k: max(o['numbers'][k] for o in out.values())
              for k in lead['numbers']}
    return Outcome(values=lead['values'], attempted=lead['steps'],
                   failed=lead['failed'],
                   checks=judge(values, ctx.cell['limits']),
                   memory_peak_bytes=max(o['peak'] for o in out.values()),
                   count=world, record=record,
                   forbidden=[f'rank {r}: {name}' for r, o in
                              sorted(out.items()) for name in o['forbidden']])


def _rank(rank, init_method, args, results):
    """One card's share of the run; puts (rank, 'ok', its results) or
    (rank, 'error', the traceback)."""
    import torch.distributed as dist
    try:
        from kaolin_tpu_torch.parallel import distributed as D
        world = args['world']
        if args['cuda']:
            dev = D.initialize(init_method, world, rank,
                               local_device_ids=[rank])
        else:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
            dev = D.initialize(init_method, world, rank, device='cpu')
        results.put((rank, 'ok', _share(rank, world, dev, args)))
    except Exception:
        results.put((rank, 'error', traceback.format_exc()))
    finally:
        sys.stdout.flush()
        if dist.is_initialized():
            dist.destroy_process_group()


def _share(rank, world, dev, args):
    import torch.distributed as dist
    from kaolin_tpu_torch.models import inverse_render as M
    from kaolin_tpu_torch.parallel import sharding
    config, cell = args['config'], args['cell']
    clock = Clock(dev)
    H = W = cell['height']
    inp = dibr.make_inputs(config, cell, args['seed'], dev)
    faces, face_uvs = inp['faces'], inp['face_uvs']
    rot, trans, proj = inp['views']
    mesh = sharding.make_mesh(device=dev)
    # the seeded order of all views, and this card's share of it
    order = inp['rows'][0]
    mine = sharding.shard_views(mesh, order)
    views = M.CameraViews(rot[mine], trans[mine], proj)

    gt = M.InverseRender(*(t.clone() for t in inp['gt'].leaves()))
    with torch.no_grad():
        sel = M.compute_selection(gt, views, faces, H, W,
                                  backend=config['backend'])
        tgt_img, tgt_mask, _ = M.render_views(
            gt, views, faces, face_uvs, H, W, backend=config['backend'],
            selection=sel)
    del gt, sel
    model = M.InverseRender(*(t.clone() for t in inp['start'].leaves()))
    params = list(model.parameters())
    opt = torch.optim.Adam(params, lr=config['lr'],
                           betas=tuple(config['betas']),
                           eps=config['adam_eps'])

    def loss_fn(p, v):
        return M.render_loss(p, v, faces, face_uvs, tgt_img, tgt_mask, H, W,
                             backend=config['backend'])
    grad = sharding.multi_view_grad(loss_fn, mesh)

    def step():
        loss, grads = grad(model.as_params(), views)
        for p, g in zip(params, grads):
            p.grad = g
        opt.step()
        return loss

    p0 = [p.detach().clone() for p in params]
    first, g1 = [], None
    for k in range(dibr.FIRST_STEPS):
        first.append(step())
        if k == 0:
            g1 = [opt.state[p]['exp_avg'] / (1. - config['betas'][0])
                  for p in params]
    p3 = [p.detach().clone() for p in params]
    clock.sync()
    dist.barrier()
    setup_s = clock.now() - args['t0']

    # the window: rank 0's clock decides, read two steps late
    flag = torch.ones((), dtype=torch.int32, device=dev)
    pending, losses = [], []
    t_start = clock.now()
    while True:
        losses.append(step())
        go = flag.clone()
        if rank == 0:
            go.fill_(int(clock.now() - t_start < args['seconds']))
        dist.broadcast(go, 0)
        pending.append(go)
        if len(pending) > 2 and not int(pending.pop(0)):
            break               # rank 0's later flags are 0 as well
    clock.sync()
    window_s = clock.now() - t_start
    steps = len(losses)
    peak = clock.peak()

    record = None
    if args['trace']:
        with torch.no_grad():
            vc, vi = ref.project(model.vertices.detach(), views.camera_rot,
                                 views.camera_trans, proj)
            fvc = vc[:, faces]
            nz = torch.linalg.cross(fvc[..., 1, :] - fvc[..., 0, :],
                                    fvc[..., 2, :] - fvc[..., 0, :])[..., 2]
            k1_bytes, k1_flops = work.k1_work(vi[:, faces], nz >= 0, H, W,
                                              config['boxlen'])

        def block():
            for _ in range(TRACED_STEPS):
                step()
        path = args['trace_path'].replace('.json', f'.rank{rank}.json')
        from pathlib import Path
        record = trace.profiled(block, TRACED_STEPS, Path(path), clock.sync)
        record['work'] = dict(k1_bytes=k1_bytes, k1_flops=k1_flops)
        record['memory_peak_bytes'] = peak

    failed = int((~torch.isfinite(torch.stack(losses))).sum())
    prog = dibr.readings(first, g1, p0, p3)
    del model, opt, params, tgt_img, tgt_mask, losses, grad, p0, p3, g1
    if clock.cuda:
        torch.cuda.empty_cache()

    rows = torch.arange(mine.numel(), device=dev)[None].expand(
        dibr.FIRST_STEPS, -1)
    r = ref.fit(inp['start'], inp['gt'], (rot[mine], trans[mine], proj), faces,
                face_uvs, rows, H, W, dibr._cfg(config), dibr.FIRST_STEPS,
                reduce=dist.all_reduce)
    base = dibr.reference_readings(r, inp)
    numbers = dibr.numbers(prog, base)
    busy = record['busy_s'] if record else 0.
    win = record['window_s'] if record else 0.
    return dict(values=dict(dibr_mpix_s=world * mine.numel() * H * W * steps
                            / window_s / 1e6, setup_s=setup_s),
                steps=steps, failed=failed, peak=peak, numbers=numbers,
                record=record if rank == 0 else None, busy_s=busy,
                window_s=win, forbidden=env.forbidden_modules())
