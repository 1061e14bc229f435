"""DIB-R++ inverse rendering: shape, material and 32 SG lights fitted
through the DIB-R step's compiled form, one replay a step.

As ``drivers/dibr.py``, with the model of ``models/dibrpp.py`` and its
``render_loss`` as the compiled step's loss.  Set-up makes every input from
the seed on the device: the mesh's start point (perturbed by ``noise``
N(0, 1)); the ground-truth material (albedo uniform in [0, 1), roughness
uniform in ``roughness_gt``) and the start's (albedo uniform, roughness
``roughness_start``); the ground-truth lights drawn in ``lights``' ranges
and the start's, those perturbed as ``perturb`` says.  It renders the view
pool's targets through the program from the ground truth, builds
``models/inverse_render.py::compiled_step(..., loss_fn=dibrpp.render_loss)``
and takes the fit's first three steps through the same call and feed as
the window.  The window and ``dibr_mpix_s`` are the DIB-R cells'.

The comparison: the reference (``reference/dibrpp.py``) follows the same
three steps from the same start on targets it renders itself; each step's
loss, the first gradient's norms of the vertices (vertex by vertex), the
albedo, the roughness and the lights, and the parameters' change after
three steps are held against it (:func:`numbers`).  :func:`control` gives
the readings its limits are set from.
"""

import math

import torch

from benchmark.drivers.dibr import FIRST_STEPS, TRACED_ROUNDS
from benchmark.harness import scene, trace, work
from benchmark.harness.compare import judge, leaf_gap, median_gap, rel_gap
from benchmark.harness.context import Clock, Outcome
from benchmark.reference import dibr as dibr_ref
from benchmark.reference import dibrpp as ref

__all__ = ['run', 'make_inputs', 'numbers', 'control']

SKIP_BELOW = 1e-3       # a leaf whose reference change is under this share
#                         of the median leaf's moves by round-off
# the pieces of the leaves that the readings take one norm each of
PIECES = ('vertices', 'albedo', 'roughness', 'amplitude', 'azimuth',
          'elevation', 'sharpness')
LIGHTS = PIECES[3:]


def _uniform(g, shape, lo_hi, device):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


def make_inputs(config, cell, seed, device):
    """The cell's inputs from the seed: dict of the mesh (faces, face_uvs),
    the start and ground-truth parameters (ref.Params), the view pool
    (rot, trans, proj) and the order of views (rows of ``views_per_step``).
    """
    mesh = cell['mesh']
    verts, faces, face_uvs = scene.uv_sphere(mesh['n_lon'], mesh['n_lat'])
    v = scene.normalized(torch.as_tensor(verts, device=device))
    g = scene.generator(seed, device)
    res, n = config['texture_res'], config['lobes']
    noise = torch.randn(v.shape, generator=g, device=device)
    mat_gt = torch.rand((4, res, res), generator=g, device=device)
    lo, hi = config['roughness_gt']
    mat_gt[3] = lo + (hi - lo) * mat_gt[3]
    mat0 = torch.rand((4, res, res), generator=g, device=device)
    mat0[3] = config['roughness_start']
    r, p = config['lights'], config['perturb']
    gt = [_uniform(g, (n, 3), r['amplitude'], device),
          *(_uniform(g, n, r[k], device)
            for k in ('azimuth', 'elevation', 'sharpness'))]
    start = [gt[0] * _uniform(g, (n, 3), p['amplitude_scale'], device),
             gt[1] + p['azimuth_sd'] * torch.randn(
                 n, generator=g, device=device),
             gt[2] + p['elevation_sd'] * torch.randn(
                 n, generator=g, device=device),
             gt[3] * _uniform(g, n, p['sharpness_scale'], device)]
    cam = config['camera']
    views = scene.turntable_views(cell['view_pool'], cam['distance'],
                                  math.radians(cam['fovy_deg']),
                                  cam['elevation'], device)
    rows = scene.schedule(seed, cell['view_pool'], cell['views_per_step'],
                          cell['rounds']).to(device)
    return dict(faces=torch.as_tensor(faces, device=device),
                face_uvs=torch.as_tensor(face_uvs, device=device),
                start=ref.Params(v + cell['noise'] * noise, mat0, *start),
                gt=ref.Params(v, mat_gt, *gt), views=views, rows=rows)


def _cfg(config):
    return {k: config[k] for k in ('multiplier', 'boxlen', 'sigmainv', 'lr',
                                   'betas', 'adam_eps', 'spec_albedo',
                                   'roughness_clip')}


def run(ctx):
    # a program without the model stops here, before any set-up
    from kaolin_tpu_torch.models import dibrpp as D
    from kaolin_tpu_torch.models import inverse_render as M
    config, cell, dev = ctx.config, ctx.cell, ctx.device
    clock = Clock(dev)
    H = W = cell['height']
    inp = make_inputs(config, cell, ctx.seed, dev)
    faces, face_uvs, rows = inp['faces'], inp['face_uvs'], inp['rows']
    rot, trans, proj = inp['views']
    per = cell['views_per_step']
    backend = config['backend']

    # the program: targets from the ground truth, the model, the step
    gt = D.DIBRPP(*(t.clone() for t in inp['gt'].leaves()))
    imgs, masks = [], []
    with torch.no_grad():
        for s in range(0, rot.shape[0], per):
            views = M.CameraViews(rot[s:s + per], trans[s:s + per], proj)
            sel = M.compute_selection(gt, views, faces, H, W,
                                      backend=backend)
            im, sm, _ = D.render_views(gt, views, faces, face_uvs, H, W,
                                       backend=backend, selection=sel)
            imgs.append(im)
            masks.append(sm)
    tgt_img, tgt_mask = torch.cat(imgs), torch.cat(masks)
    del gt, imgs, masks, sel, im, sm
    model = D.DIBRPP(*(t.clone() for t in inp['start'].leaves()))
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
                           opt, backend=backend, loss_fn=D.render_loss)

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
        start_k = -(-k // per_round) * per_round
        units = TRACED_ROUNDS * per_round
        k1_bytes, k1_flops = _k1_work(model.vertices, inp, H, W,
                                      config['boxlen'])

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

    refr = reference_readings(_fit(inp, config, cell), inp)
    checks = judge(numbers(prog, refr), cell['limits'])
    mpix = steps * per * H * W / window_s / 1e6
    return Outcome(values=dict(dibr_mpix_s=mpix, setup_s=setup_s),
                   attempted=steps, failed=failed, checks=checks,
                   memory_peak_bytes=peak, record=record)


def _k1_work(vertices, inp, H, W, boxlen):
    """(bytes, flops) of K1 over the whole view pool at ``vertices``
    (``harness/work.py::k1_work``, as ``drivers/dibr.py`` counts it)."""
    rot, trans, proj = inp['views']
    faces = inp['faces']
    with torch.no_grad():
        vc, vi = dibr_ref.project(vertices.detach(), rot, trans, proj)
        fvc, fvi = vc[:, faces], vi[:, faces]
        nz = torch.linalg.cross(fvc[..., 1, :] - fvc[..., 0, :],
                                fvc[..., 2, :] - fvc[..., 0, :])[..., 2]
        return work.k1_work(fvi, nz >= 0, H, W, boxlen)


def _pieces(leaves):
    """The leaves (vertices, material, the four lights' tensors) as the
    pieces of :data:`PIECES`: the material split into albedo and
    roughness."""
    v, mat, *lights = leaves
    return [v, mat[:3], mat[3], *lights]


def readings(losses, grads, start, end):
    """One side's readings of the first steps: each step's loss, the first
    gradient's norm per piece and per vertex, and the change's norm per
    piece from ``start`` to ``end``."""
    return dict(
        losses=[float(x) for x in losses],
        grads=[float(torch.linalg.norm(g.double())) for g in _pieces(grads)],
        vertex_grads=torch.linalg.norm(grads[0].double(), dim=1).cpu(),
        change=[float(torch.linalg.norm((b - a).double())) for a, b in
                zip(_pieces(start), _pieces(end))])


def reference_readings(r, inp):
    """The readings of a reference fit (``reference/dibrpp.py::fit``)."""
    return readings(r['losses'], r['grads'], inp['start'].leaves(),
                    r['params'])


def _fit(inp, config, cell, **kw):
    return ref.fit(inp['start'], inp['gt'], inp['views'], inp['faces'],
                   inp['face_uvs'], inp['rows'][:FIRST_STEPS],
                   cell['height'], cell['height'], _cfg(config), FIRST_STEPS,
                   **kw)


def numbers(prog, refr):
    """The numbers compared, of two sets of readings: the first step's loss
    and the worse of the later steps' (relative gaps); the first
    gradient's norm of the median vertex (:func:`median_gap`, as
    ``drivers/dibr.py`` takes it), of the albedo, of the roughness and the
    worst of the four lights' tensors (each relative to its own norm: the
    roughness is seen by the specular term alone and its gradient is the
    smallest, so a share of the median leaf would not see it); and the
    parameters' change after the first steps by the worst piece
    (``leaf_gap``; pieces whose reference change is under ``SKIP_BELOW``
    of the median piece's left out)."""
    g, r = dict(zip(PIECES, prog['grads'])), dict(zip(PIECES, refr['grads']))
    med = sorted(refr['change'])[len(refr['change']) // 2]
    skip = {i for i, c in enumerate(refr['change']) if c < SKIP_BELOW * med}
    return dict(
        loss1_gap=rel_gap(prog['losses'][0], refr['losses'][0]),
        loss23_gap=max(rel_gap(a, b) for a, b in zip(prog['losses'][1:],
                                                     refr['losses'][1:])),
        grad_vertex_gap=median_gap(prog['vertex_grads'],
                                   refr['vertex_grads']),
        grad_albedo_gap=rel_gap(g['albedo'], r['albedo']),
        grad_roughness_gap=rel_gap(g['roughness'], r['roughness']),
        grad_lights_gap=max(rel_gap(g[k], r[k]) for k in LIGHTS),
        change_gap=leaf_gap(prog['change'], refr['change'], skip))


FAULTS = {'fault_no_specular': dict(specular=False),
          'fault_half_lights': dict(lobes_used=16),
          'fault_roughness_grad_zeroed': dict(roughness_grad=False),
          'fault_half_batch': dict(half_batch=True)}


def control(cell, config, seed, device, only=None):
    """The readings a limit's upper side is set from, the reference alone
    in one process: the reference in bfloat16 (``control_bf16``) and with
    each fault of :data:`FAULTS` planted, each put in the program's place
    and held against the reference in float32.  Returns {name: the
    numbers of :func:`numbers`} and the reference's own readings;
    ``only`` (default all) names the readings to take."""
    inp = make_inputs(config, cell, seed, device)
    runs = dict(control_bf16=dict(dtype=torch.bfloat16), **FAULTS)
    base = reference_readings(_fit(inp, config, cell), inp)
    out = {name: numbers(reference_readings(_fit(inp, config, cell, **kw),
                                            inp), base)
           for name, kw in runs.items() if only is None or name in only}
    out['reference'] = {k: v for k, v in base.items() if k != 'vertex_grads'}
    return out
