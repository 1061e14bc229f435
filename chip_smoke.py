#!/usr/bin/env python3
"""Smoke run of kaolin_tpu_torch, the PyTorch + CUDA port, on one GPU.

Drives the port's two ported paths and checks them phase by phase.

The DIB-R inverse-rendering trainer of
``examples/dibr_inverse_rendering.py`` (fused selection -> textured,
SH-lit render -> image L1 + mask IoU loss -> backward -> Adam) at 512^2,
4 views, a 256^2 texture and a 10,000-face textured UV sphere:

1. toolchain: the card, torch, nvcc, triton; every kernel source in
   ``kaolin_tpu_torch/csrc`` is built at once, one ``nvcc`` each, into
   ``build/kaolin_tpu_torch/``;
2. the forward kernel (K1) against its plain PyTorch version;
3. the backward kernel (K2) against its plain PyTorch version;
4. 5 Adam steps; step 0's loss and gradients against the plain path (the
   same step on the CPU, where the wrappers run the plain versions);
5. times (CUDA events after warm-up) of the step and of each kernel
   beside its plain version.

The SPC pipeline of BASELINE config #3 (mesh -> level-10 octree -> coherent
trace of 1,048,576 camera rays -> per-ray opacity), on the same 10,000-face
sphere scaled to radius 0.45 (~1.0M voxels at level 10):

6. build: the device mesh builder against the host builder at level 8;
   level-10 builds at two capacities must be identical;
   then the main path, once, through the user entry points
   (``unbatched_mesh_to_spc_device`` -> ``scan_octrees`` ->
   ``generate_points`` -> ``build_cell_table`` ->
   ``unbatched_raytrace_coherent`` -> ``hits_to_nuggets`` ->
   ``exponential_integration``), with K3's launch count read around it;
7. K3 against its plain version on every active block of the scene;
8. K3 against its plain version on a dense random level-6 octree whose
   rays hit more than 64 voxels and, some, more than the k-buffer;
9. the whole trace against the port's BFS on the 1,048,576 rays;
10. times of the trace, K3, the cell table, the mesh builder and the BFS.

Every phase synchronises and raises on failure; there is no CPU path.
Usage: ``python3 chip_smoke.py`` from the root of the repository.  The last
line of its output is ``{"ok": true, "device": {...}}``; the line before
it lists the kernels.
"""

import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch.models import inverse_render as M
from kaolin_tpu_torch.ops.conversions.trianglemesh import (
    _tri_aabb_sat, unbatched_mesh_to_spc, unbatched_mesh_to_spc_device)
from kaolin_tpu_torch.ops.spc import (generate_points, scan_octrees,
                                      unbatched_points_to_octree)
from kaolin_tpu_torch.render.mesh import _fused as FU
from kaolin_tpu_torch.render.spc import (
    _trace, exponential_integration, hits_to_nuggets, mark_pack_boundaries,
    unbatched_raytrace)
from kaolin_tpu_torch.render.spc.raster import (
    _block_order, build_cell_table, trace_inputs, unbatched_raytrace_coherent)
from kaolin_tpu_torch.utils.testing import camera_grid, uv_sphere

HEIGHT = WIDTH = 512
VIEWS = 4
TEXTURE_RES = 256
SPHERE = (100, 51)          # uv_sphere(100, 51): 10,000 faces
STEPS = 5
LR = 5e-3
MULT = 1000.                # fused engine defaults (compute_selection)
SIGMAINV = 7000.
BOXLEN = 0.02
EPS = 1e-8

# acceptance limits of the kernels against their plain versions (same
# inputs, same card); only summation order differs, see csrc/dibr_fused.cu
K1_FID_MISMATCH_MAX = 1e-4  # share of pixels whose face id differs
K1_PROD_MAX = 1e-5          # max |prod_kernel - prod_plain|
K2_REL_MAX = 1e-3           # max |grad diff| / max |grad|
# the kernel path on the card against the plain path on the CPU: also
# differ in prepare_vertices' arithmetic and in the order of the
# index/grid_sample backward's atomic sums
STEP0_LOSS_RTOL = 1e-4
STEP0_GRAD_REL = 1e-3

# SPC pipeline (BASELINE config #3, as bench.py::_phase_spc runs it)
SPC_RADIUS = 0.45           # the sphere scaled to ~fox's 992k level-10 voxels
SPC_LEVEL = 10
SPC_PARITY_LEVEL = 8        # device vs host builder (host: numpy float64)
SPC_CAPS = (2 ** 22, 2 ** 23)
RAY_SIDE = 1024             # 1,048,576 camera rays in 4 x 4 pixel blocks
CELLS = dict(cell_shift=3, cell_width=192)
TRACE = dict(knum=256, with_exit=False, rays_per_tile=32,   # bench.py:243
             max_super_voxels=512 * 192, max_active_blocks=8192,
             segments=((512, 192), (1536, 48), (4096, 16), (None, 4)))
TAU = 0.25                  # optical thickness per voxel hit (opacity check)
DENSE = dict(level=6, points=250_000, side=128, knum=128, seed=6)
FOX = ('fox.obj (bench.py): 992k voxels at level 10, <= 179 hits per ray; '
       'its non-saturating caps allow <= 8192 active blocks and <= 192 '
       'candidate cells per block')
# acceptance limits
BORDER_SLACK = 1e-5         # face_idx flips only where a triangle grazes
BARY_ATOL = 1e-5
GRAZING = 1e-5              # trace-only hits must span less than this
BFS_DEPTH_ATOL = 1e-6
OPACITY_ATOL = 1e-5


def _check(ok, what):
    if not ok:
        raise RuntimeError(f'chip_smoke: check failed: {what}')


def _card():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters, warmup=1):
    """Mean device time of fn() over iters launches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def toolchain(card):
    """Phase 1: what the machine has; builds the kernels."""
    print(f'card: {card}')
    print(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
          f'{torch.cuda.device_count()} device(s), '
          f'device 0 = {torch.cuda.get_device_name(0)}, '
          f'capability {torch.cuda.get_device_capability(0)}')
    nvcc = _cuda.find_nvcc()
    ver = subprocess.run([nvcc, '--version'], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    print(f'nvcc: {nvcc}: {ver.strip().splitlines()[-1]}')
    try:
        import triton
        print(f'triton {triton.__version__} imports')
    except ImportError as exc:
        print(f'triton does not import: {exc}')
    names = sorted(p.stem for p in _cuda.CSRC.glob('*.cu'))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:     # one nvcc per source
        list(pool.map(_cuda.load, names))
    print(f'kernel builds + loads, in parallel '
          f'({", ".join(n + ".cu" for n in names)}): '
          f'{time.perf_counter() - t0:.2f} s')
    for name in names:
        for line in _cuda.BUILD_LOG.get(name, '').splitlines():
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                print(f'  ptxas: {line.strip()}')


def make_scene(dev, height=HEIGHT, views=VIEWS, texture_res=TEXTURE_RES,
               sphere=SPHERE):
    """The trainer's inputs: targets from the unperturbed sphere with a
    numpy-seeded texture; the start point perturbed by 0.05 N(0, 1)."""

    s = uv_sphere(*sphere)
    faces = torch.as_tensor(s.faces, device=dev)
    face_uvs = torch.as_tensor(s.uvs[s.face_uvs_idx], device=dev)
    cams = M.make_views(views, device=dev)
    params = M.init_params(s, texture_res, device=dev)
    tex = np.random.default_rng(7).random(
        (3, texture_res, texture_res), dtype=np.float32)
    gt = M.from_jax_params(params.vertices.detach().cpu().numpy(), tex,
                           params.sh_coeffs.detach().cpu().numpy(),
                           device=dev)
    with torch.no_grad():
        sel = M.compute_selection(gt, cams, faces, height, height)
        target_images, target_masks, _ = M.render_views(
            gt, cams, faces, face_uvs, height, height, selection=sel)
        noise = np.random.default_rng(0).standard_normal(
            tuple(params.vertices.shape)).astype(np.float32)
        params.vertices += 0.05 * torch.as_tensor(noise, device=dev)
    return dict(faces=faces, face_uvs=face_uvs, views=cams, params=params,
                target_images=target_images, target_masks=target_masks,
                height=height)


def kernel_inputs(scene):
    """build_face_tiles of the start point, as compute_selection makes it."""
    H = scene['height']
    with torch.no_grad():
        fvc, fvi, fn = M._prepare(scene['params'], scene['views'],
                                  scene['faces'])
        vt, tr, ctr, cbb, _, _ = FU.build_face_tiles(
            fvc[..., 2], fvi * MULT, fn[..., 2] >= 0., H, H, MULT,
            BOXLEN * MULT)
    return vt.float().contiguous(), tr, ctr, cbb.float().contiguous()


def check_forward(scene, inputs):
    """Phase 2: K1 against its plain version."""
    H = scene['height']
    vt, tr, _, cbb = inputs
    fid_k, prod_k = FU._fused_forward_cuda(vt, tr, cbb, H, H, MULT, EPS,
                                           SIGMAINV, True)
    torch.cuda.synchronize()
    fid_p, prod_p = FU._fused_forward_torch(vt, tr, cbb, H, H, MULT, EPS,
                                            SIGMAINV, True)
    torch.cuda.synchronize()
    mismatch = (fid_k != fid_p).float().mean().item()
    dprod = (prod_k - prod_p).abs().max().item()
    mask_k = torch.where(fid_k < 0, 1. - prod_k, 1.)
    mask_p = torch.where(fid_p < 0, 1. - prod_p, 1.)
    dmask = (mask_k - mask_p).abs().max().item()
    covered = (fid_k >= 0).float().mean().item()
    print(f'K1 fused_forward_kernel vs plain: face_idx mismatch share '
          f'{mismatch:.3e} (limit {K1_FID_MISMATCH_MAX:g}), max|dprod| '
          f'{dprod:.3e} (limit {K1_PROD_MAX:g}), soft mask max|d| '
          f'{dmask:.3e}; covered pixels {covered:.4f}, '
          f'chunks {vt.shape[1]}')
    _check(covered > 0.01, 'the scene covers some pixels')
    _check(mismatch <= K1_FID_MISMATCH_MAX, 'K1 face_idx mismatch share')
    _check(dprod <= K1_PROD_MAX, 'K1 max |dprod|')
    _check(torch.isfinite(prod_k).all().item(), 'K1 prod finite')
    return fid_k, prod_k, dprod


def check_backward(scene, inputs, fid, prod):
    """Phase 3: K2 against its plain version, g numpy-seeded."""
    H = scene['height']
    vt, _, ctr, cbb = inputs
    g = torch.as_tensor(np.random.default_rng(1).standard_normal(
        tuple(fid.shape)).astype(np.float32), device=fid.device)
    g_prod = torch.where(fid < 0, g * prod, 0.).contiguous()
    out_k = FU._fused_backward_cuda(vt, ctr, cbb, g_prod, H, H, MULT,
                                    SIGMAINV)
    torch.cuda.synchronize()
    out_p = FU._fused_backward_torch(vt, ctr, cbb, g_prod, H, H, MULT,
                                     SIGMAINV)
    torch.cuda.synchronize()
    scale = out_p.abs().max().item()
    err = (out_k - out_p).abs().max().item()
    print(f'K2 fused_backward_kernel vs plain: max|d| {err:.3e}, '
          f'max|grad| {scale:.3e}, ratio {err / max(scale, 1e-30):.3e} '
          f'(limit {K2_REL_MAX:g})')
    _check(scale > 0, 'K2 gradient is not all zero')
    _check(torch.isfinite(out_k).all().item(), 'K2 output finite')
    _check(err <= K2_REL_MAX * scale, 'K2 max |d| / max |grad|')
    return g_prod, err


def _step(scene, params, selection=None):
    """compute_selection -> render_loss -> backward; returns the loss."""
    H = scene['height']
    sel = M.compute_selection(params, scene['views'], scene['faces'], H, H)
    for p in params.parameters():
        p.grad = None
    loss = M.render_loss(params, scene['views'], scene['faces'],
                         scene['face_uvs'], scene['target_images'],
                         scene['target_masks'], H, H,
                         selection=sel if selection is None else selection)
    loss.backward()
    return loss, sel


def check_step_against_plain(scene, params, loss, sel):
    """The same step on the CPU, where the wrappers run the plain
    versions: loss and gradients of the kernel path must match it."""
    cpu = {k: (v.detach().cpu() if torch.is_tensor(v) else v)
           for k, v in scene.items()}
    cpu['views'] = M.CameraViews(*(v.cpu() for v in scene['views']))
    p_cpu = M.from_jax_params(*(p.detach().cpu().numpy() for p in (
        params.vertices, params.texture_map, params.sh_coeffs)))
    t0 = time.perf_counter()
    loss_c, sel_c = _step(cpu, p_cpu)
    cpu_s = time.perf_counter() - t0
    mism = (sel[0].cpu() != sel_c[0]).float().mean().item()
    rel_loss = abs(loss.item() - loss_c.item()) / abs(loss_c.item())
    print(f'step 0, kernel path (card) vs plain path (CPU, {cpu_s:.1f} s): '
          f'loss {loss.item():.7f} vs {loss_c.item():.7f} (rel '
          f'{rel_loss:.2e}, limit {STEP0_LOSS_RTOL:g}); face_idx mismatch '
          f'share {mism:.2e}')
    _check(rel_loss <= STEP0_LOSS_RTOL, 'step-0 loss kernel vs plain')
    for name in ('vertices', 'texture_map', 'sh_coeffs'):
        g = getattr(params, name).grad.cpu()
        g_c = getattr(p_cpu, name).grad
        scale = g_c.abs().max().item()
        err = (g - g_c).abs().max().item()
        print(f'  grad {name}: max|d| {err:.3e}, max|g| {scale:.3e}, '
              f'ratio {err / max(scale, 1e-30):.2e} '
              f'(limit {STEP0_GRAD_REL:g})')
        _check(scale > 0 and err <= STEP0_GRAD_REL * scale,
               f'step-0 grad {name} kernel vs plain')


def train(scene, steps=STEPS):
    """Phase 4: the trainer.  Returns the kernels' launch counts."""
    params = scene['params']
    opt = torch.optim.Adam(params.parameters(), lr=LR)
    start = {n: p.detach().clone() for n, p in params.named_parameters()}
    losses = []
    for k in FU.LAUNCHES:
        FU.LAUNCHES[k] = 0
    for step in range(steps):
        t0 = time.perf_counter()
        loss, sel = _step(scene, params)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if step == 0:
            check_step_against_plain(scene, params, loss, sel)
        opt.step()
        losses.append(loss.item())
        print(f'step {step}: loss {losses[-1]:.7f} ({dt * 1e3:.1f} ms host '
              f'clock, first step includes warm-up)')
    launches = dict(FU.LAUNCHES)
    print(f'kernel launches during the {steps} steps: {launches}')
    _check(all(np.isfinite(losses)), 'losses finite')
    for n, p in params.named_parameters():
        _check(torch.isfinite(p).all().item(), f'{n} finite')
        _check(not torch.equal(p.detach(), start[n]), f'{n} moved')
    _check(launches['fwd'] >= steps and launches['bwd'] >= steps,
           'both kernels launched on every step')
    return launches


def times(scene, inputs, g_prod, card):
    """Phase 5: device times after warm-up."""
    H = scene['height']
    B = scene['views'].camera_rot.shape[0]
    F = scene['faces'].shape[0]
    vt, tr, ctr, cbb = inputs
    step_ms = _time_ms(lambda: _step(scene, scene['params']), 5)
    fwd = (vt, tr, cbb, H, H, MULT, EPS, SIGMAINV, True)
    bwd = (vt, ctr, cbb, g_prod, H, H, MULT, SIGMAINV)
    k1_ms = _time_ms(lambda: FU._fused_forward_cuda(*fwd), 20)
    k1_plain_ms = _time_ms(lambda: FU._fused_forward_torch(*fwd), 3)
    k2_ms = _time_ms(lambda: FU._fused_backward_cuda(*bwd), 20)
    k2_plain_ms = _time_ms(lambda: FU._fused_backward_torch(*bwd), 3)
    print(f'[{card}] fwd+bwd step (selection + render_loss + backward, '
          f'{B} views, {H}x{H}, {F} faces): {step_ms:.3f} ms = '
          f'{B * H * H / step_ms / 1e3:.3f} Mpix/s, '
          f'{B * F / step_ms * 1e3:.0f} triangles/s')
    print(f'[{card}] K1 fused_forward_kernel {k1_ms:.4f} ms, plain '
          f'{k1_plain_ms:.4f} ms')
    print(f'[{card}] K2 fused_backward_kernel {k2_ms:.4f} ms, plain '
          f'{k2_plain_ms:.4f} ms')
    return dict(step_ms=step_ms, k1_ms=k1_ms, k1_plain_ms=k1_plain_ms,
                k2_ms=k2_ms, k2_plain_ms=k2_plain_ms)


# ---------------------------------------------------------------------------
# SPC pipeline

def _bits(x):
    """The bits of a float32 tensor, for bitwise comparisons."""
    return x.contiguous().view(torch.int32)


def _same_outputs(a, b):
    """K3 outputs (t_near, t_far, pidx, count): floats bitwise equal."""
    return all(torch.equal(_bits(x), _bits(y)) if x.is_floating_point()
               else torch.equal(x, y) for x, y in zip(a, b))


def _max_t_err(a, b):
    """max |t_near a - t_near b| over the entries finite in both."""
    fin = torch.isfinite(a[0]) & torch.isfinite(b[0])
    return (a[0] - b[0])[fin].abs().max().item() if fin.any() else 0.


def spc_mesh():
    """The scaled sphere: (F, 3, 3) float32 face vertices (numpy)."""
    s = uv_sphere(*SPHERE)
    return (s.vertices * SPC_RADIUS)[s.faces]


def camera_rays(dev):
    """camera_grid(1024), permuted once into 4 x 4 pixel blocks."""
    o, d = camera_grid(RAY_SIDE)
    perm, _ = _block_order(RAY_SIDE, RAY_SIDE, 4, 4)
    return (torch.as_tensor(o[perm], device=dev),
            torch.as_tensor(d[perm], device=dev))


def spc_build(fv, dev):
    """Phase 6: the level-8 device builder against the host builder,
    level-10 builds at two capacities."""
    fv_d = torch.as_tensor(fv, device=dev)
    L = SPC_PARITY_LEVEL
    t0 = time.perf_counter()
    host = unbatched_mesh_to_spc(fv.astype(np.float64), L)
    host_s = time.perf_counter() - t0
    devb = [x.cpu() for x in unbatched_mesh_to_spc_device(
        fv_d, L, cap=SPC_CAPS[0])]
    _check(torch.equal(host[0], devb[0]), f'level-{L} octree device == host')
    _check(torch.equal(host[1], devb[1]), f'level-{L} points device == host')
    diff = host[2] != devb[2]
    vox = host[1][diff].numpy().astype(np.int64)
    tris = fv.astype(np.float64)[torch.minimum(host[2], devb[2])[diff]]
    grazing = bool(_tri_aabb_sat(tris, vox, L, BORDER_SLACK).all()
                   and not _tri_aabb_sat(tris, vox, L, -BORDER_SLACK).any())
    bary_err = (host[3] - devb[3])[~diff].abs().max().item()
    print(f'level {L}, device builder (card) vs host builder (numpy float64,'
          f' {host_s:.1f} s): {host[1].shape[0]} voxels, {host[0].shape[0]} '
          f'octree bytes, bytes and points equal; face_idx equal on '
          f'{int((~diff).sum())} voxels, the other {int(diff.sum())} all '
          f'grazing (lower-id triangle inside the voxel grown by '
          f'{BORDER_SLACK:g}, outside it shrunk by {BORDER_SLACK:g}): '
          f'{grazing}; bary max|d| {bary_err:.3e} (limit {BARY_ATOL:g})')
    _check(grazing, 'face_idx differs only where a triangle grazes')
    _check(diff.float().mean().item() < 0.05, 'face_idx differs on < 5%')
    _check(bary_err <= BARY_ATOL, 'bary device vs host')
    builds = []
    for cap in SPC_CAPS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = unbatched_mesh_to_spc_device(fv_d, SPC_LEVEL, cap=cap)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        print(f'level {SPC_LEVEL}, cap 2^{cap.bit_length() - 1}: '
              f'{out[1].shape[0]} voxels, {out[0].shape[0]} octree bytes, '
              f'build {ms:.1f} ms (host clock, synchronised, first call '
              f'includes warm-up), peak device memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB')
        builds.append(out)
    for a, b, name in zip(*builds, ('octree', 'points', 'face_idx', 'bary')):
        _check(torch.equal(a, b), f'level-{SPC_LEVEL} {name} equal at both '
               'caps (no proposals cut)')


def spc_main_path(fv, dev):
    """The SPC pipeline through its entry points, from the mesh to a per-ray
    opacity; K3's launch count is read around it."""
    fv_d = torch.as_tensor(fv, device=dev)
    o, d = camera_rays(dev)
    torch.cuda.synchronize()
    _trace.LAUNCHES['trace'] = 0
    octree, _, _, _ = unbatched_mesh_to_spc_device(fv_d, SPC_LEVEL,
                                                   cap=SPC_CAPS[0])
    max_level, pyramids, exsum = scan_octrees(octree, [octree.shape[0]])
    ph = generate_points(octree, pyramids, exsum)
    table = build_cell_table(ph, pyramids[0], SPC_LEVEL, **CELLS)
    hits = unbatched_raytrace_coherent(octree, ph, pyramids[0], exsum, o, d,
                                       SPC_LEVEL, engine='mosaic',
                                       cell_table=table, **TRACE)
    ridx, pidx, _ = hits_to_nuggets(hits)
    first = mark_pack_boundaries(ridx)
    ones = torch.ones((ridx.shape[0], 1), device=dev)
    per_ray, _ = exponential_integration(ones, TAU * ones, first)
    opacity = torch.zeros(o.shape[0], device=dev)
    opacity[ridx[first].long()] = per_ray[:, 0]
    torch.cuda.synchronize()
    launches = _trace.LAUNCHES['trace']

    pyr = pyramids[0]
    V, off = int(pyr[0, SPC_LEVEL]), int(pyr[1, SPC_LEVEL])
    cnt = hits.count
    hit = cnt > 0
    expected = 1. - torch.exp(-TAU * torch.clamp(cnt, max=TRACE['knum']))
    op_err = (opacity - expected).abs().max().item()
    print(f'SPC main path: level {max_level}, {V} voxels, '
          f'{table.rows.shape[0] - 1} cells (overflow {table.overflow}), '
          f'{o.shape[0]} rays, {int(hit.sum())} hit, {int(cnt.sum())} hits, '
          f'max {int(cnt.max())} per ray, saturated {bool(hits.saturated)}; '
          f'opacity max|d| from 1 - exp(-{TAU:g} count) {op_err:.2e} '
          f'(limit {OPACITY_ATOL:g}); K3 launches {launches}')
    _check(max_level == SPC_LEVEL, 'octree depth')
    _check(table.overflow == 0, 'cell table overflow 0')
    _check(not bool(hits.saturated), 'the sphere trace does not saturate')
    _check(tuple(hits.t_near.shape) == (o.shape[0], TRACE['knum']),
           'k-buffer shape')
    live = hits.pidx >= 0
    _check(torch.equal(live.sum(1, dtype=torch.int32), cnt), 'count = hits')
    _check(bool(torch.isfinite(hits.t_near[live]).all()), 'depths finite')
    _check(bool(((hits.pidx[live] >= off) & (hits.pidx[live] < off + V))
                .all()), 'pidx in the leaf level')
    _check(pidx.shape[0] == int(cnt.sum()), 'nuggets = hits')
    _check(torch.equal(opacity > 0, hit), 'opacity > 0 exactly where hit')
    _check(op_err <= OPACITY_ATOL, 'opacity')
    _check(launches >= 1, 'K3 launched on the main path')
    return dict(octree=octree, pyramid=pyr, exsum=exsum, ph=ph, table=table,
                o=o, d=d, hits=hits, launches=launches, fv=fv_d)


def _trace_args(spc, knum):
    keys = ('rays_per_tile', 'segments', 'max_super_voxels',
            'max_active_blocks')
    return trace_inputs(spc['table'], spc['o'], spc['d'], knum=knum,
                        **{k: TRACE[k] for k in keys})


def check_trace_kernel(spc):
    """Phase 7: K3 against its plain version on every active block of the
    sphere scene, with the main path's settings."""
    args, sat = _trace_args(spc, TRACE['knum'])
    nb, rt = args['nb'], args['rays'].shape[1]
    out_k = _trace._trace_cuda(with_exit=False, **args)
    torch.cuda.synchronize()
    out_p = _trace._trace_torch(with_exit=False, **args)
    torch.cuda.synchronize()
    N = spc['o'].shape[0]
    cnt = out_k[3].reshape(N)
    hit = cnt > 0
    same = _same_outputs(out_k, out_p)
    main = spc['hits']
    same_main = (torch.equal(cnt, main.count) and torch.equal(
        _bits(out_k[0].reshape(N, -1)), _bits(main.t_near)))
    err = _max_t_err(out_k, out_p)
    print(f'K3 spc_trace_kernel vs plain on the sphere scene: '
          f'{nb.shape[0]} active blocks of {args["num_blocks"]}, candidate '
          f'cells per block max {int(nb.max())}, mean '
          f'{nb.float().mean().item():.2f}; '
          f'{rt * args["cell_rows"].shape[2] * int(nb.sum())} (ray, voxel) '
          f'slab tests; hits per ray max {int(cnt.max())}, mean '
          f'{cnt[hit].float().mean().item():.2f} over the {int(hit.sum())} '
          f'rays that hit; count, pidx and t_near (bitwise) equal: {same}; '
          f'max|dt| {err:.3e}; same rows as the main path: {same_main}; '
          f'culling saturated {bool(sat)}')
    print(f'  for comparison, {FOX}')
    _check(same, 'K3 equals its plain version on the sphere scene')
    _check(same_main, 'the main path went through the same K3 rows')
    _check(not bool(sat), 'culling does not saturate')
    return args, err


def check_dense(dev):
    """Phase 8: K3 against its plain version where rays hit more than 64
    voxels and some more than the k-buffer (a dense random level-6 octree,
    rays along the diagonal)."""
    L = DENSE['level']
    rng = np.random.default_rng(DENSE['seed'])
    pts = torch.as_tensor(rng.integers(0, 2 ** L, (DENSE['points'], 3)),
                          device=dev)
    octree = unbatched_points_to_octree(pts, L)
    _, pyramids, exsum = scan_octrees(octree, [octree.shape[0]])
    ph = generate_points(octree, pyramids, exsum)
    table = build_cell_table(ph, pyramids[0], L, cell_shift=2, cell_width=64)
    o, d = camera_grid(DENSE['side'], z=-2.5, spread=0.05, extent=0.3)
    o[:, :2] -= 2.5
    d = d + np.array([1., 1., 0.], np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    kw = dict(rays_per_tile=32, segments=((None, 4096),),
              max_super_voxels=64 * 4096)
    args, sat = trace_inputs(table, o, d, knum=DENSE['knum'], **kw)
    kbuf = args['kbuf']
    err = 0.
    for with_exit in (True, False):
        out_k = _trace._trace_cuda(with_exit=with_exit, **args)
        torch.cuda.synchronize()
        out_p = _trace._trace_torch(with_exit=with_exit, **args)
        torch.cuda.synchronize()
        _check(_same_outputs(out_k, out_p),
               f'K3 equals its plain version, dense, with_exit={with_exit}')
        err = max(err, _max_t_err(out_k, out_p))
    cnt = out_k[3]
    trace = dict(engine='mosaic', cell_table=table, **kw)
    sat_k = unbatched_raytrace_coherent(octree, ph, pyramids[0], exsum, o, d,
                                        L, knum=DENSE['knum'], **trace)
    sat_256 = unbatched_raytrace_coherent(octree, ph, pyramids[0], exsum, o,
                                          d, L, knum=256, **trace)
    print(f'K3 vs plain, dense level-{L} octree ({ph.shape[0]} points): '
          f'{args["nb"].shape[0]} active blocks, candidate cells per block '
          f'max {int(args["nb"].max())}; hits per ray max {int(cnt.max())}, '
          f'{int((cnt > 64).sum())} rays > 64, {int((cnt > kbuf).sum())} '
          f'> kbuf {kbuf}; equal (bitwise) with and without exit depths; '
          f'saturated at knum {DENSE["knum"]}: {bool(sat_k.saturated)}, '
          f'at knum 256: {bool(sat_256.saturated)}')
    _check(not bool(sat), 'dense culling does not saturate')
    _check(int((cnt > kbuf).sum()) > 0 and int((cnt > 64).sum()) > 0,
           'dense counts exceed 64 and kbuf')
    _check(bool(sat_k.saturated), 'saturated where count > kbuf')
    _check(bool(sat_256.saturated) == bool((sat_256.count > 256).any()),
           'saturated exactly when a count exceeds knum')
    return err


def check_against_bfs(spc):
    """Phase 9: the whole trace (with exit depths) against the port's BFS
    on the same 1,048,576 rays: every BFS hit traced, extras only where
    grazing, common depths within BFS_DEPTH_ATOL."""
    args = (spc['octree'], spc['ph'], spc['pyramid'], spc['exsum'],
            spc['o'], spc['d'], SPC_LEVEL)
    hits = unbatched_raytrace_coherent(
        *args, engine='mosaic', cell_table=spc['table'],
        **dict(TRACE, with_exit=True))
    main = spc['hits']
    _check(torch.equal(hits.count, main.count)
           and torch.equal(hits.pidx, main.pidx)
           and torch.equal(_bits(hits.t_near), _bits(main.t_near)),
           'with_exit changes no hit')
    r2, p2, d2 = hits_to_nuggets(hits)
    t0 = time.perf_counter()
    r1, p1, d1, info = unbatched_raytrace(*args, with_exit=True,
                                          return_info=True)
    torch.cuda.synchronize()
    bfs_s = time.perf_counter() - t0
    P = spc['ph'].shape[0]
    k1 = r1.long() * P + p1.long()
    k2 = r2.long() * P + p2.long()
    s2, i2 = torch.sort(k2)
    pos = torch.searchsorted(s2, k1).clamp(max=max(0, s2.shape[0] - 1))
    found = s2[pos] == k1
    j = i2[pos[found]]
    dmax = (d2[j] - d1[found]).abs().max().item() if j.numel() else 0.
    in_bfs = torch.zeros(k2.shape[0], dtype=torch.bool, device=k2.device)
    in_bfs[j] = True
    span = d2[~in_bfs, 1] - d2[~in_bfs, 0]
    span_max = span.max().item() if span.numel() else 0.
    print(f'trace vs BFS ({bfs_s:.2f} s host clock, first call), '
          f'{spc["o"].shape[0]} rays: BFS {r1.shape[0]} nuggets (saturated '
          f'{info.saturated}), trace {r2.shape[0]}; BFS hits missing from '
          f'the trace {int((~found).sum())}; trace-only hits '
          f'{span.shape[0]}, max span {span_max:.2e} (limit {GRAZING:g}); '
          f'common depths max|d| {dmax:.2e} (limit {BFS_DEPTH_ATOL:g})')
    _check(not info.saturated, 'BFS did not saturate')
    _check(bool(found.all()), 'every BFS hit is in the trace')
    _check(bool((span < GRAZING).all()), 'extras are grazing')
    _check(dmax <= BFS_DEPTH_ATOL, 'common depths')


def spc_times(spc, args, card):
    """Phase 10: device times (CUDA events) after warm-up."""
    trace_args = (spc['octree'], spc['ph'], spc['pyramid'], spc['exsum'],
                  spc['o'], spc['d'], SPC_LEVEL)
    N = spc['o'].shape[0]
    trace_ms = _time_ms(lambda: unbatched_raytrace_coherent(
        *trace_args, engine='mosaic', cell_table=spc['table'], **TRACE), 5)
    launch = {k: v for k, v in args.items() if k != 'num_blocks'}
    out = _trace._outputs(args['num_blocks'], args['rays'].shape[1],
                          args['kbuf'], spc['o'].device)
    k3_ms = _time_ms(lambda: _trace._launch(with_exit=False, out=out,
                                            **launch), 20)
    k3_alloc_ms = _time_ms(
        lambda: _trace._trace_cuda(with_exit=False, **args), 20)
    k3_plain_ms = _time_ms(
        lambda: _trace._trace_torch(with_exit=False, **args), 2)
    table_ms = _time_ms(lambda: build_cell_table(
        spc['ph'], spc['pyramid'], SPC_LEVEL, **CELLS), 5)
    build_ms = _time_ms(lambda: unbatched_mesh_to_spc_device(
        spc['fv'], SPC_LEVEL, cap=SPC_CAPS[0]), 3)
    bfs_ms = _time_ms(lambda: unbatched_raytrace(*trace_args,
                                                 with_exit=True), 2)
    print(f'[{card}] trace (culling + K3 + outputs, {N} rays, knum '
          f'{TRACE["knum"]}): {trace_ms:.3f} ms = {N / trace_ms / 1e3:.3f} '
          f'Mrays/s')
    print(f'[{card}] K3 spc_trace_kernel {k3_ms:.4f} ms (into allocated '
          f'outputs; {k3_alloc_ms:.4f} ms with their allocation and fill), '
          f'plain {k3_plain_ms:.4f} ms')
    print(f'[{card}] build_cell_table {table_ms:.3f} ms; '
          f'unbatched_mesh_to_spc_device (level {SPC_LEVEL}, cap '
          f'2^{SPC_CAPS[0].bit_length() - 1}) {build_ms:.3f} ms; BFS '
          f'unbatched_raytrace {bfs_ms:.3f} ms')
    print(f'[{card}] peak device memory so far '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB')
    return dict(trace_ms=trace_ms, k3_ms=k3_ms, k3_plain_ms=k3_plain_ms)


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py: torch.cuda.is_available() is '
                         'False; this script runs only on a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    card = _card()

    toolchain(card)
    scene = make_scene(dev)
    torch.cuda.synchronize()
    inputs = kernel_inputs(scene)
    fid, prod, k1_err = check_forward(scene, inputs)
    g_prod, k2_err = check_backward(scene, inputs, fid, prod)
    launches = train(scene)
    t = times(scene, inputs, g_prod, card)

    fv = spc_mesh()
    spc_build(fv, dev)
    spc = spc_main_path(fv, dev)
    args, k3_err = check_trace_kernel(spc)
    k3_err = max(k3_err, check_dense(dev))
    check_against_bfs(spc)
    ts = spc_times(spc, args, card)

    src = 'kaolin_tpu_torch/csrc/dibr_fused.cu'
    kernels = [
        dict(name='fused_forward_kernel', route='cuda', source=src,
             replaces='kaolin_tpu/render/mesh/_fused.py:232',
             launches=launches['fwd'], max_abs_err=k1_err,
             ms=t['k1_ms'], plain_ms=t['k1_plain_ms']),
        dict(name='fused_backward_kernel', route='cuda', source=src,
             replaces='kaolin_tpu/render/mesh/_fused.py:386',
             launches=launches['bwd'], max_abs_err=k2_err,
             ms=t['k2_ms'], plain_ms=t['k2_plain_ms']),
        dict(name='spc_trace_kernel', route='cuda',
             source='kaolin_tpu_torch/csrc/spc_trace.cu',
             replaces='kaolin_tpu/render/spc/raster.py:459',
             launches=spc['launches'], max_abs_err=k3_err,
             ms=ts['k3_ms'], plain_ms=ts['k3_plain_ms']),
    ]
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
