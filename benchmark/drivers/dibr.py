"""DIB-R inverse rendering: the fit's compiled step, one replay a step.

Set-up makes every input from the seed on the device (the mesh's start
point, perturbed by ``noise`` N(0, 1); the ground-truth and start textures,
uniform), renders the view pool's targets through the program from the
ground truth, builds ``models/inverse_render.py::compiled_step`` and takes
the fit's first three steps through the same call and feed as the window,
keeping the losses, the first gradient (from Adam's first moment) and the
parameters after the third.  The window then takes steps until
``seconds`` have passed, each on the next views of a seeded order of the
pool, its loss kept on the device; it closes on a synchronise.
``dibr_mpix_s`` counts views x H x W of every step over the window.

The comparison: the reference follows the same three steps from the same
start, on targets it renders itself; each step's loss, the first
gradient's norms and the parameters' change after three steps are held
against it (:func:`numbers`).
"""

import math

import torch

from benchmark.harness import scene, trace, work
from benchmark.harness.compare import (judge, leaf_gap, median_gap,
                                      median_leaf, rel_gap)
from benchmark.harness.context import Clock, Outcome
from benchmark.reference import dibr as ref

__all__ = ['run', 'make_inputs', 'FIRST_STEPS']

FIRST_STEPS = 3         # the steps that the reference follows
TRACED_ROUNDS = 5       # the traced block: this many passes over the pool
SKIP_BELOW = 1e-3       # a leaf whose reference gradient is under this
#                         share of the median leaf's moves by round-off
VERTICES, TEXTURE = 0, 1    # the leaves' order: vertices, texture, SH


def make_inputs(config, cell, seed, device):
    """The cell's inputs from the seed: dict of the mesh (faces, face_uvs),
    the start and ground-truth parameters (ref.Params), the view pool
    (rot, trans, proj) and the order of views (rows of ``views_per_step``).
    """
    mesh = cell['mesh']
    verts, faces, face_uvs = scene.uv_sphere(mesh['n_lon'], mesh['n_lat'])
    v = scene.normalized(torch.as_tensor(verts, device=device))
    g = scene.generator(seed, device)
    res = config['texture_res']
    noise = torch.randn(v.shape, generator=g, device=device)
    tex_gt = torch.rand((3, res, res), generator=g, device=device)
    tex0 = torch.rand((3, res, res), generator=g, device=device)
    sh = torch.zeros(9, device=device)
    sh[0] = config['sh_dc']
    cam = config['camera']
    views = scene.turntable_views(cell['view_pool'], cam['distance'],
                                  math.radians(cam['fovy_deg']),
                                  cam['elevation'], device)
    rows = scene.schedule(seed, cell['view_pool'], cell['views_per_step'],
                          cell['rounds']).to(device)
    return dict(faces=torch.as_tensor(faces, device=device),
                face_uvs=torch.as_tensor(face_uvs, device=device),
                start=ref.Params(v + cell['noise'] * noise, tex0, sh.clone()),
                gt=ref.Params(v, tex_gt, sh.clone()), views=views, rows=rows)


def _cfg(config):
    return dict(multiplier=config['multiplier'], boxlen=config['boxlen'],
                sigmainv=config['sigmainv'], lr=config['lr'],
                betas=config['betas'], adam_eps=config['adam_eps'])


def run(ctx):
    from kaolin_tpu_torch.models import inverse_render as M
    config, cell, dev = ctx.config, ctx.cell, ctx.device
    clock = Clock(dev)
    H = W = cell['height']
    inp = make_inputs(config, cell, ctx.seed, dev)
    faces, face_uvs, rows = inp['faces'], inp['face_uvs'], inp['rows']
    rot, trans, proj = inp['views']
    per = cell['views_per_step']

    # the program: targets from the ground truth, the model, the step
    gt = M.InverseRender(*(t.clone() for t in inp['gt'].leaves()))
    imgs, masks = [], []
    with torch.no_grad():
        for s in range(0, rot.shape[0], per):
            views = M.CameraViews(rot[s:s + per], trans[s:s + per], proj)
            sel = M.compute_selection(gt, views, faces, H, W,
                                      backend=config['backend'])
            im, sm, _ = M.render_views(gt, views, faces, face_uvs, H, W,
                                       backend=config['backend'],
                                       selection=sel)
            imgs.append(im)
            masks.append(sm)
    tgt_img, tgt_mask = torch.cat(imgs), torch.cat(masks)
    del gt, imgs, masks, sel, im, sm
    model = M.InverseRender(*(t.clone() for t in inp['start'].leaves()))
    params = list(model.parameters())
    beta1 = config['betas'][0]
    opt = torch.optim.Adam(params, lr=config['lr'],
                           betas=tuple(config['betas']),
                           eps=config['adam_eps'], capturable=clock.cuda)

    def feed(k):
        idx = rows[k % rows.shape[0]]
        return (M.CameraViews(rot.index_select(0, idx),
                              trans.index_select(0, idx), proj),
                tgt_img.index_select(0, idx), tgt_mask.index_select(0, idx))

    views0, img0, mask0 = feed(0)
    step = M.compiled_step(model, views0, faces, face_uvs, img0, mask0, H, W,
                           opt, backend=config['backend'])

    # the fit's first steps, through the window's call and feed
    p0 = [p.detach().clone() for p in params]
    first, g1 = [], None
    for k in range(FIRST_STEPS):
        first.append(step(*feed(k)))
        if k == 0:
            g1 = [opt.state[p]['exp_avg'] / (1. - beta1) for p in params]
    p3 = [p.detach().clone() for p in params]
    clock.sync()
    setup_s = clock.now() - ctx.t0

    # the window
    losses, k = [], FIRST_STEPS
    t_start = clock.now()
    while clock.now() - t_start < ctx.seconds:
        losses.append(step(*feed(k)))
        k += 1
    clock.sync()
    window_s = clock.now() - t_start
    steps = k - FIRST_STEPS
    peak = clock.peak()

    record = None
    if ctx.trace:
        per_round = rows.shape[0] // cell['rounds']
        k = -(-k // per_round) * per_round
        units = TRACED_ROUNDS * per_round
        with torch.no_grad():
            vc, vi = ref.project(model.vertices.detach(), rot, trans, proj)
            fvc, fvi = vc[:, faces], vi[:, faces]
            nz = torch.linalg.cross(fvc[..., 1, :] - fvc[..., 0, :],
                                    fvc[..., 2, :] - fvc[..., 0, :])[..., 2]
            k1_bytes, k1_flops = work.k1_work(fvi, nz >= 0, H, W,
                                              config['boxlen'])
        start_k = k

        def block():
            for j in range(start_k, start_k + units):
                step(*feed(j))
        record = trace.profiled(block, units, ctx.trace_path, clock.sync)
        # the pool once per round: per step, the pool's work / steps a round
        record['work'] = dict(k1_bytes=k1_bytes / per_round,
                              k1_flops=k1_flops / per_round)
        record['memory_peak_bytes'] = peak

    loss_vals = torch.stack(losses).double() if losses else torch.zeros(0)
    failed = int((~torch.isfinite(loss_vals)).sum())
    prog = readings(first, g1, p0, p3)
    del step, model, opt, params, tgt_img, tgt_mask, losses, p0, p3, g1
    if clock.cuda:
        torch.cuda.empty_cache()

    refr = reference_readings(ref.fit(
        inp['start'], inp['gt'], inp['views'], faces, face_uvs,
        rows[:FIRST_STEPS], H, W, _cfg(config), FIRST_STEPS), inp)
    checks = judge(numbers(prog, refr), cell['limits'])
    mpix = steps * per * H * W / window_s / 1e6
    return Outcome(values=dict(dibr_mpix_s=mpix, setup_s=setup_s),
                   attempted=steps, failed=failed, checks=checks,
                   memory_peak_bytes=peak, record=record)


def readings(losses, grads, start, end):
    """One side's readings of the first steps: each step's loss, the first
    gradient's norm per leaf and per vertex, and the change's norm per
    leaf from ``start`` to ``end``."""
    return dict(
        losses=[float(x) for x in losses],
        grads=[float(torch.linalg.norm(g.double())) for g in grads],
        vertex_grads=torch.linalg.norm(grads[VERTICES].double(), dim=1).cpu(),
        change=[float(torch.linalg.norm((b - a).double()))
                for a, b in zip(start, end)])


def reference_readings(r, inp):
    """The readings of a reference fit (``reference/dibr.py::fit``)."""
    return readings(r['losses'], r['grads'], inp['start'].leaves(),
                    r['params'])


def numbers(prog, refr):
    """The numbers compared, of two sets of readings: the first step's loss
    and the worse of the later steps' (relative gaps); the first
    gradient's norm of the median leaf (SH) and of the texture, and the
    median vertex's (:func:`median_gap`); and the parameters' change after
    the first steps by the worst leaf (leaves whose reference gradient is
    under ``SKIP_BELOW`` of the median leaf's left out).  A gradient's size
    shows in its norms, its sign in the later losses.  PERF.md gives the
    readings that each limit was set from, and why the vertices' gradient
    is taken vertex by vertex: a near-tie that the two z-buffers break
    apart moves a few vertices' gradient far, and Adam's first step, lr *
    sign(g), carries that into the later losses, so their limit stands
    further from its readings."""
    med = median_leaf(refr['grads'])
    skip = {i for i, g in enumerate(refr['grads'])
            if g < SKIP_BELOW * refr['grads'][med]}
    return dict(
        loss1_gap=rel_gap(prog['losses'][0], refr['losses'][0]),
        loss23_gap=max(rel_gap(a, b) for a, b in zip(prog['losses'][1:],
                                                     refr['losses'][1:])),
        grad_median_gap=leaf_gap(prog['grads'], refr['grads'], leaf=med),
        grad_vertex_gap=median_gap(prog['vertex_grads'],
                                   refr['vertex_grads']),
        grad_texture_gap=leaf_gap(prog['grads'], refr['grads'],
                                  leaf=TEXTURE),
        change_gap=leaf_gap(prog['change'], refr['change'], skip))
