#!/usr/bin/env python3
"""Smoke run of kaolin_tpu_torch, the PyTorch + CUDA port, on one GPU.

Drives the port's paths and checks them phase by phase.

The DIB-R inverse-rendering trainer of
``examples/dibr_inverse_rendering.py`` (fused selection -> textured,
SH-lit render -> image L1 + mask IoU loss -> backward -> Adam) at 512^2,
4 views, a 256^2 texture and a 10,000-face textured UV sphere:

1. toolchain: the card, torch, nvcc, triton; every kernel source in
   ``kaolin_tpu_torch/csrc`` is built at once, one ``nvcc`` each, into
   ``build/kaolin_tpu_torch/``;
2. the forward kernel (K1) against its plain PyTorch version;
3. the backward kernel (K2) against its plain PyTorch version; the work
   both kernels cull to (K1's evaluated (pixel, face) pairs beside those of
   one CTA per tile walking whole chunks, its face lists per sub-tile, K2's
   sub-tiles with a non-zero g*prod), counted in torch from their rules;
4. 5 Adam steps; step 0's loss and gradients against the plain path (the
   same step on the CPU, where the wrappers run the plain versions);
5. times (CUDA events after warm-up) of the step and of each kernel
   beside its plain version; the step on the card's timeline
   (``torch.profiler``): kernels per step, device busy and idle share, the
   largest kernels.

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
   every live pidx must lie in the leaf level (K3 adds the level's offset);
7. K3 against its plain version on every active block of the scene, with
   pidx offset 0 and with the level's; the main path's hits against the
   trace whose offset is a ``torch.where`` pass after K3, bit for bit;
8. K3 against its plain version on a dense random level-6 octree whose
   rays hit more than 64 voxels and, some, more than the k-buffer, then on
   the same octree with voxels taken out of and put into its cell rows
   (rows with holes, empty rows, full rows with tied depths) and blocks
   with no candidate cell; both offsets, with and without exit depths;
9. the whole trace against the port's BFS on the 1,048,576 rays;
10. times of the trace, of the trace with the offset pass after K3, of K3,
    the cell table, the mesh-to-octree build and the BFS.

The probes of K3 and of the card (``kaolin_tpu_torch.probes``, the port of
the TPU probe scripts), each driven through its entry point ``run`` with
its kernels' launch counts set to 0 just before and read just after:

11. P1, ``probes.mosaic3``: kernels kA..kH against their plain versions on
    the script's inputs and a random x, bit for bit, and kB/kC/kD at K3's
    staging shape (4,452 blocks x 61 rows of 4 x 192 from a table of the
    level-10 cell table's row count); their times;
12. P2, ``probes.stages``: the dummy kernel against 2 x, ns per CTA at
    65,536 and 262,144 CTAs beside ``torch.mul``; the trace of the SPC cell
    by stage (culling candidates, block order, gathers, the whole trace,
    K3, output fills, the trace with the offset pass after K3);
13. P3, ``probes.kbisect``: K3 cut at stages 1-6 against the plain version
    on the script's inputs, on a scene with rays past kbuf, and on phase
    8's dense level-6 octree; at the SPC cell every stage against plain
    and stage 6 equal to K3 bit for bit; each stage's time and its delta.

Every kernel of the ``kernels`` line carries its time, its plain
version's, its bound (the larger of bytes over 3.35 TB/s and float32
operations over 67 TFLOP/s, counted on this run's inputs) and, where one
PyTorch call computes the same function, that call's time.

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
from kaolin_tpu_torch.probes import _kernels as PK
from kaolin_tpu_torch.probes import kbisect, mosaic3, stages
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
from kaolin_tpu_torch.utils import measure
from kaolin_tpu_torch.utils.measure import TRACE, bound_ms, time_ms
from kaolin_tpu_torch.utils.testing import (camera_grid, punch_cell_rows,
                                            uv_sphere)

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
TAU = 0.25                  # optical thickness per voxel hit (opacity check)
DENSE = dict(level=6, points=250_000, side=128, knum=128, seed=6)
FOX = ('fox.obj (bench.py): 992k voxels at level 10, <= 179 hits per ray; '
       'its non-saturating caps allow <= 8192 active blocks and <= 192 '
       'candidate cells per block')
# float32 operations per pair, counted from csrc/dibr_fused.cu (bounds);
# only the pairs where the function needs them
K1_COVER_FLOPS = 35   # (pixel, valid face) in the face's own box (a pixel
#                       outside it is never covered): 5 affine forms, the
#                       sign tests, z
K1_MASK_FLOPS = 87    # (pixel, face) in the face's enlarged bbox (outside
#                       it p = 0): 6 distance candidates, their min, exp,
#                       the product
K2_FLOPS = 125        # (face, pixel) in the bbox where g*prod != 0: the
#                       candidates, exp, dL/dd, the argmin, 4-6 gradient terms
# the TPU kernels the probes replace (def lines in the scripts)
P1_LINES = dict(kA=61, kB=73, kC=97, kD=119, kE=144, kF=153, kG=162, kH=174)
# acceptance limits
BORDER_SLACK = 1e-5         # face_idx flips only where a triangle grazes
BARY_ATOL = 1e-5
GRAZING = 1e-5              # trace-only hits must span less than this
BFS_DEPTH_ATOL = 1e-6
OPACITY_ATOL = 1e-5


def _bound(nbytes, flops):
    ms, by = bound_ms(nbytes, flops)
    return dict(bound_ms=ms, bound_by=by)


def _check(ok, what):
    if not ok:
        raise RuntimeError(f'chip_smoke: check failed: {what}')


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


def culling(scene, inputs, g_prod):
    """Phase 3, continued: the work K1 and K2 cull to, counted in torch
    from their rules (``_fused._cull_forward``, ``_fused._cull_backward``)
    on this run's inputs."""
    H = scene['height']
    vt, tr, ctr, cbb = inputs
    B, nC = vt.shape[:2]
    _, _, TW = FU._tile_dims(*FU._padded_dims(H, H))
    _, _, bounds = FU._tile_pixels(H, H, MULT, vt.device)
    c = torch.arange(nC, device=vt.device)
    visits = sum(int((FU._chunk_hits_tile(cbb[b], bounds) & (c >= tr[b, :, :1])
                      & (c < tr[b, :, 1:])).sum()) for b in range(B))
    lists = FU._cull_forward(vt, tr, cbb, H, H, MULT).sum(-1)
    busy = lists[lists > 0].float()
    visited, computed, nonzero = FU._cull_backward(ctr, cbb, g_prod, H, H,
                                                   MULT)
    res = dict(k1_pairs=int(lists.sum()) * FU._SUB ** 2,
               k1_tile_pairs=visits * FU.FC * FU.PS * TW,
               list_max=int(lists.max()), list_mean=busy.mean().item(),
               subtiles=lists.numel(), empty=int((lists == 0).sum()),
               k2_units=nonzero.numel(), k2_active=int(nonzero.sum()),
               k2_visited=int(visited.sum()), k2_computed=int(computed.sum()),
               k2_chunk_max=int(computed.sum(-1).max()))
    print(f'K1 culling: {res["k1_pairs"]} (pixel, face) pairs evaluated by '
          f'{FU._SUB} x {FU._SUB} sub-tiles, against {res["k1_tile_pairs"]} '
          f'for one CTA per {FU.PS} x {TW} tile walking every face of each '
          f'visited chunk ({visits} (tile, chunk) visits); face list per '
          f'sub-tile max {res["list_max"]}, mean {res["list_mean"]:.2f} '
          f'over the {lists.numel() - res["empty"]} non-empty of '
          f'{lists.numel()} (sub-tile, view) CTAs')
    print(f'K2 culling: {res["k2_active"]} of {res["k2_units"]} (8-row unit, '
          f'view) sub-tiles hold a pixel with g*prod != 0; (chunk, unit) '
          f'pairs visited {res["k2_visited"]}, computed on '
          f'{res["k2_computed"]}; at most {res["k2_chunk_max"]} per chunk, '
          f'so at most {-(-res["k2_chunk_max"] // FU._BWD_SLICES)} per CTA')
    return res


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
        params.vertices, params.texture_map, params.sh_coeffs)),
        device='cpu')
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


def step_profile(scene, card, steps=3, top=8):
    """The step on the card's timeline (``torch.profiler`` over ``steps``
    steps after the timed ones): kernels per step, the union of their
    intervals against the host clock (device busy and idle share), and the
    kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            _step(scene, scene['params'])
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    path = _cuda.BUILD_DIR / 'step_trace.json'
    _cuda.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    spans = sorted((e['ts'], e['ts'] + e['dur'], e['name']) for e in
                   json.loads(path.read_text())['traceEvents']
                   if e.get('cat') == 'kernel')
    _check(len(spans) > 0, 'the profiler traced the card')
    busy, end, by_name = 0., -np.inf, {}
    for a, b, name in spans:
        busy += max(0., b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.) + (b - a) / 1e3 / steps
    heavy = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    print(f'[{card}] step on the timeline ({steps} steps, profiled): '
          f'{len(spans) / steps:.0f} kernels per step, device busy '
          f'{busy / 1e3 / steps:.3f} ms of {wall / steps:.3f} ms per step '
          f'(idle share {1 - busy / 1e3 / wall:.3f}), kernel time '
          f'{sum(by_name.values()):.3f} ms per step; largest: ' + '; '.join(
              f'{n[:48]} {ms:.3f}' for n, ms in heavy))


def times(scene, inputs, g_prod, card):
    """Phase 5: device times after warm-up."""
    H = scene['height']
    B = scene['views'].camera_rot.shape[0]
    F = scene['faces'].shape[0]
    vt, tr, ctr, cbb = inputs
    step_ms = time_ms(lambda: _step(scene, scene['params']), 5)
    step_profile(scene, card)
    fwd = (vt, tr, cbb, H, H, MULT, EPS, SIGMAINV, True)
    bwd = (vt, ctr, cbb, g_prod, H, H, MULT, SIGMAINV)
    k1_ms = time_ms(lambda: FU._fused_forward_cuda(*fwd), 20)
    k1_plain_ms = time_ms(lambda: FU._fused_forward_torch(*fwd), 3)
    k2_ms = time_ms(lambda: FU._fused_backward_cuda(*bwd), 20)
    k2_plain_ms = time_ms(lambda: FU._fused_backward_torch(*bwd), 3)
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
    off = spc['table'].offset
    out_p = _trace._trace_torch(with_exit=False, **args)
    same = True
    for offset in (0, off):
        out_k = _trace._trace_cuda(with_exit=False, pidx_offset=offset,
                                   **args)
        torch.cuda.synchronize()
        moved = torch.where(out_p[2] >= 0, out_p[2] + offset, -1)
        same &= _same_outputs(out_k, (out_p[0], out_p[1], moved, out_p[3]))
    same_plain_off = torch.equal(moved, _trace._trace_torch(
        with_exit=False, pidx_offset=off, **args)[2])
    N = spc['o'].shape[0]
    cnt = out_k[3].reshape(N)
    hit = cnt > 0
    main = spc['hits']
    same_main = (torch.equal(cnt, main.count) and torch.equal(
        _bits(out_k[0].reshape(N, -1)), _bits(main.t_near)))
    err = _max_t_err(out_k, out_p)
    tests = kbisect.trace_work(args, out_k[3], False)[2]
    print(f'K3 spc_trace_kernel vs plain on the sphere scene: '
          f'{nb.shape[0]} active blocks of {args["num_blocks"]}, candidate '
          f'cells per block max {int(nb.max())}, mean '
          f'{nb.float().mean().item():.2f}; '
          f'{rt * args["cell_rows"].shape[2] * int(nb.sum())} (ray, slot) '
          f'pairs, {tests} of them (ray, voxel) slab tests; hits per ray '
          f'max {int(cnt.max())}, mean '
          f'{cnt[hit].float().mean().item():.2f} over the {int(hit.sum())} '
          f'rays that hit; count, pidx and t_near (bitwise) equal with '
          f'pidx offset 0 and {off}: {same}; max|dt| {err:.3e}; same rows '
          f'as the main path: {same_main}; culling saturated {bool(sat)}')
    print(f'  for comparison, {FOX}')
    _check(same, 'K3 equals its plain version on the sphere scene')
    _check(same_plain_off, 'the plain version adds the offset to live pidx')
    _check(same_main, 'the main path went through the same K3 rows')
    _check(not bool(sat), 'culling does not saturate')
    return args, err


def _k3_vs_plain(args, offset, name):
    """K3 against its plain version on ``args``, with pidx offset 0 and
    ``offset``, with and without exit depths; (max |dt|, count)."""
    err = 0.
    for with_exit in (True, False):
        for off in (0, offset):
            out_k = _trace._trace_cuda(with_exit=with_exit, pidx_offset=off,
                                       **args)
            torch.cuda.synchronize()
            out_p = _trace._trace_torch(with_exit=with_exit, pidx_offset=off,
                                        **args)
            torch.cuda.synchronize()
            _check(_same_outputs(out_k, out_p),
                   f'K3 equals its plain version, {name}, with_exit='
                   f'{with_exit}, pidx_offset={off}')
            err = max(err, _max_t_err(out_k, out_p))
    return err, out_k[3]


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
    err, cnt = _k3_vs_plain(args, table.offset, 'dense')
    # the same scene with voxels taken out of and put into the rows, and
    # every third block without a candidate cell
    odd = dict(args, cell_rows=torch.as_tensor(punch_cell_rows(
        args['cell_rows'].cpu().numpy(), DENSE['seed']), device=dev),
        nb=args['nb'].clone())
    odd['nb'][::3] = 0
    live = odd['cell_rows'][:, 3] >= 0
    fill = (live * torch.arange(1, live.shape[1] + 1, device=dev)).amax(1)
    kinds = dict(full=int(live.all(1).sum()), empty=int((~live.any(1)).sum()),
                 holes=int((live.sum(1) < fill).sum()))
    err_odd, cnt_odd = _k3_vs_plain(odd, table.offset, 'dense with holes')
    print(f'K3 vs plain, the dense octree\'s rows punched: {kinds["holes"]} '
          f'rows with a hole before their last voxel, {kinds["empty"]} '
          f'empty, {kinds["full"]} full (tied depths), '
          f'{int((odd["nb"] == 0).sum())} blocks with nb = 0; hits per ray '
          f'max {int(cnt_odd.max())}, {int((cnt_odd > kbuf).sum())} rays > '
          f'kbuf {kbuf}; equal (bitwise) with both offsets, with and '
          f'without exit depths')
    _check(min(kinds.values()) > 0 and int((cnt_odd > kbuf).sum()) > 0,
           'punched rows of every kind, counts past kbuf')
    err = max(err, err_odd)
    trace = dict(engine='mosaic', cell_table=table, **kw)
    sat_k = unbatched_raytrace_coherent(octree, ph, pyramids[0], exsum, o, d,
                                        L, knum=DENSE['knum'], **trace)
    sat_256 = unbatched_raytrace_coherent(octree, ph, pyramids[0], exsum, o,
                                          d, L, knum=256, **trace)
    print(f'K3 vs plain, dense level-{L} octree ({ph.shape[0]} points): '
          f'{args["nb"].shape[0]} active blocks, candidate cells per block '
          f'max {int(args["nb"].max())}; hits per ray max {int(cnt.max())}, '
          f'{int((cnt > 64).sum())} rays > 64, {int((cnt > kbuf).sum())} '
          f'> kbuf {kbuf}; equal (bitwise) with pidx offset 0 and '
          f'{table.offset}, with and without exit depths; '
          f'saturated at knum {DENSE["knum"]}: {bool(sat_k.saturated)}, '
          f'at knum 256: {bool(sat_256.saturated)}')
    _check(not bool(sat), 'dense culling does not saturate')
    _check(int((cnt > kbuf).sum()) > 0 and int((cnt > 64).sum()) > 0,
           'dense counts exceed 64 and kbuf')
    _check(bool(sat_k.saturated), 'saturated where count > kbuf')
    _check(bool(sat_256.saturated) == bool((sat_256.count > 256).any()),
           'saturated exactly when a count exceeds knum')
    return err, args


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
    trace_ms = time_ms(lambda: unbatched_raytrace_coherent(
        *trace_args, engine='mosaic', cell_table=spc['table'], **TRACE), 5)
    # once: the trace as it was before K3 wrote the final pidx
    same_after = _same_outputs(spc['hits'], stages.trace_offset_after(spc))
    after_ms = time_ms(lambda: stages.trace_offset_after(spc), 5)
    launch = {k: v for k, v in args.items() if k != 'num_blocks'}
    out = _trace._outputs(args['num_blocks'], args['rays'].shape[1],
                          args['kbuf'], spc['o'].device)
    off = spc['table'].offset
    k3_ms = time_ms(lambda: _trace._launch(with_exit=False, out=out,
                                            pidx_offset=off, **launch), 20)
    k3_alloc_ms = time_ms(lambda: _trace._trace_cuda(
        with_exit=False, pidx_offset=off, **args), 20)
    k3_plain_ms = time_ms(lambda: _trace._trace_torch(
        with_exit=False, pidx_offset=off, **args), 2)
    table_ms = time_ms(lambda: build_cell_table(
        spc['ph'], spc['pyramid'], SPC_LEVEL, **CELLS), 5)
    build_ms = time_ms(lambda: unbatched_mesh_to_spc_device(
        spc['fv'], SPC_LEVEL, cap=SPC_CAPS[0]), 3)
    bfs_ms = time_ms(lambda: unbatched_raytrace(*trace_args,
                                                 with_exit=True), 2)
    print(f'[{card}] trace (culling + K3 + outputs, {N} rays, knum '
          f'{TRACE["knum"]}): {trace_ms:.3f} ms = {N / trace_ms / 1e3:.3f} '
          f'Mrays/s; with the pidx offset as a torch.where pass after K3 '
          f'(K3 at offset 0): {after_ms:.3f} ms, its hits equal to the main '
          f'path\'s bit for bit: {same_after}')
    _check(same_after, 'K3\'s fused offset equals the offset pass after it')
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


def dibr_work(scene, inputs, g_prod):
    """(K1 bytes, K1 flops, K2 bytes, K2 flops) on this run's inputs.

    Over the (tile, chunk) visits that pass the bbox test: for K1 the
    (pixel, valid face) pairs inside the face's own box (coverage) and the
    (pixel, face) pairs inside its enlarged bbox (soft mask); for K2 those
    of the enlarged bbox where g*prod != 0.  Each visited chunk's table and
    each image read once, each output written once.
    """
    H = scene['height']
    vt, tr, _, cbb = inputs
    B, nC = vt.shape[:2]
    dev = vt.device
    nI, nJ, TW = FU._tile_dims(*FU._padded_dims(H, H))
    T = nI * nJ
    x0, y0, bounds = FU._tile_pixels(H, H, MULT, dev)
    xcol, yrow = x0[:, :TW], y0[:, ::TW]                  # (T, TW), (T, PS)
    gz = torch.zeros((B, nI * FU.PS, nJ * TW), device=dev)
    gz[:, :H, :H] = (g_prod != 0).float()
    gz = gz.reshape(B, nI, FU.PS, nJ, TW).permute(0, 1, 3, 2, 4).reshape(
        B, T, FU.PS, TW)
    c = torch.arange(nC, device=dev)
    cover = bbox = k2 = chunks = 0
    for b in range(B):
        ov = (FU._chunk_hits_tile(cbb[b], bounds) & (c >= tr[b, :, :1])
              & (c < tr[b, :, 1:]))                        # (T, nC)
        t_i, c_i = torch.nonzero(ov, as_tuple=True)
        chunks += int(torch.unique(c_i).numel())
        for s in range(0, t_i.numel(), 4096):
            t, ci = t_i[s:s + 4096], c_i[s:s + 4096]
            f = vt[b, ci]                                  # (V, FC, NCOL)
            bb = f[..., FU._BB:FU._BB + 4]
            fx = f[..., FU._VX:FU._VX + 6:2]               # (V, FC, 3)
            fy = f[..., FU._VX + 1:FU._VX + 6:2]
            xs, ys = xcol[t][:, None], yrow[t][:, None]
            cols = ((xs >= bb[..., 0:1]) & (xs < bb[..., 2:3])).double()
            rows = ((ys >= bb[..., 1:2]) & (ys < bb[..., 3:4])).double()
            bbox += int((cols.sum(-1) * rows.sum(-1)).sum())
            own_c = ((xs >= fx.amin(-1, keepdim=True))
                     & (xs <= fx.amax(-1, keepdim=True))
                     & (f[..., FU._VALID:FU._VALID + 1] > 0.))
            own_r = ((ys >= fy.amin(-1, keepdim=True))
                     & (ys <= fy.amax(-1, keepdim=True)))
            cover += int((own_c.sum(-1) * own_r.sum(-1)).sum())
            k2 += int(torch.einsum('vfc,vrc,vfr->', cols,
                                   gz[b, t].double(), rows))
    table = chunks * FU.FC * FU._NCOL * 4
    k1_bytes = table + B * T * 8 + B * nC * 16 + B * H * H * 8
    k1_flops = K1_COVER_FLOPS * cover + K1_MASK_FLOPS * bbox
    k2_bytes = (table + B * nC * 24 + B * H * H * 4
                + B * nC * FU.FC * 6 * 4)
    return k1_bytes, k1_flops, k2_bytes, K2_FLOPS * k2


def _probe_path(run, *args, **kwargs):
    """Drive one probe entry point with every probe kernel's launch count
    set to 0 just before; returns (its result, the counts just after)."""
    for k in PK.LAUNCHES:
        PK.LAUNCHES[k] = 0
    for st in _trace.STAGES:
        _trace.LAUNCHES[f'stage{st}'] = 0
    torch.cuda.synchronize()
    res = run(*args, **kwargs)
    torch.cuda.synchronize()
    counts = dict(PK.LAUNCHES)
    counts.update({f'stage{st}': _trace.LAUNCHES[f'stage{st}']
                   for st in _trace.STAGES})
    return res, counts


def _probe_counts():
    return sum(PK.LAUNCHES.values()) + sum(
        _trace.LAUNCHES[f'stage{st}'] for st in _trace.STAGES)


def probe_p1(spc, card):
    """Phase 11: P1 through ``probes.mosaic3.run``."""
    rows = spc['table'].rows.shape[0]
    t0 = time.perf_counter()
    res, counts = _probe_path(mosaic3.run, spc['o'].device, table_rows=rows)
    print(f'P1 kA..kH vs plain (script inputs, random x, and kB/kC/kD at '
          f'K3\'s staging shape {mosaic3.STAGING} with {rows} table rows): '
          f'bitwise equal, max|d| {max(res["max_abs_err"].values()):.1e}; '
          f'launches {counts}; {time.perf_counter() - t0:.1f} s')
    for where in ('script', 'staging'):
        for name, t in res[where].items():
            lib = ('-' if t['library_ms'] is None
                   else f'{t["library_ms"]:.4f}')
            print(f'[{card}] P1 {name} ({where}): {t["ms"]:.4f} ms, plain '
                  f'{t["plain_ms"]:.4f}, library {lib}, bound '
                  f'{t["bound_ms"]:.4f} ({t["bound_by"]})')
    sb, sc = res['staging']['kB'], res['staging']['kC']
    print(f'[{card}] P1 at K3\'s staging shape: double-buffered kB '
          f'{sb["ms"]:.4f} ms vs single-slot kC {sc["ms"]:.4f} ms '
          f'(kC / kB = {sc["ms"] / sb["ms"]:.3f})')
    _check(all(counts[k] >= 1 for k in mosaic3.KERNELS),
           'every P1 kernel launched on its path')
    return res, counts


def probe_p2(spc, card):
    """Phase 12: P2 and the trace by stage through ``probes.stages.run``."""
    cell = {k: spc[k] for k in ('octree', 'ph', 'pyramid', 'exsum', 'table',
                                'o', 'd')}
    t0 = time.perf_counter()
    res, counts = _probe_path(stages.run, spc['o'].device, cell=cell,
                              offset_after=False)       # phase 10 has it
    print(f'P2 dummy kernel vs 2 x: bitwise equal; launches {counts["dummy"]}'
          f'; {time.perf_counter() - t0:.1f} s')
    for n, t in res['dummy'].items():
        print(f'[{card}] P2 dummy grid, {n} CTAs of 8 x 128 f32: '
              f'{t["ms"]:.4f} ms = {t["ns_per_cta"]:.2f} ns per CTA; '
              f'torch.mul {t["library_ms"]:.4f} ms; bound '
              f'{t["bound_ms"]:.4f} ms ({t["bound_by"]})')
    tr = res['trace']
    print(f'[{card}] trace by stage ({res["counts"]}): S1 candidates '
          f'{tr["s1"]:.3f} ms, S1b + order {tr["s1b"]:.3f} ms, S2 + gathers '
          f'{tr["s2"]:.3f} ms, S3 whole trace {tr["s3"]:.3f} ms; on their '
          f'own: K3 {tr["k3"]:.3f} ms, output allocation + fills '
          f'{tr["fills"]:.3f} ms')
    _check(counts['dummy'] >= 1, 'the P2 kernel launched on its path')
    _check(not res['counts']['saturated'], 'the staged trace does not '
           'saturate')
    return res, counts


def probe_p3(args, dense_args, card):
    """Phase 13: P3, K3 by stage, through ``probes.kbisect.run``."""
    t0 = time.perf_counter()
    res, counts = _probe_path(kbisect.run, args['rays'].device,
                              spc_args=args,
                              scenes={'dense level-6': dense_args})
    print(f'P3 stages 1-6 vs plain, with and without exit depths, bitwise '
          f'equal on {res["scenes"]}; at the SPC cell ({res["spc"]}) every '
          f'stage = plain and stage 6 = K3 bit for bit; launches {counts}; '
          f'{time.perf_counter() - t0:.1f} s')
    for st, t in res['stages'].items():
        print(f'[{card}] P3 stage {st}: {t["ms"]:.4f} ms (+{t["delta_ms"]:.4f}'
              f'), plain {t["plain_ms"]:.2f} ms')
    print(f'[{card}] P3 K3 in the same loop {res["k3_ms"]:.4f} ms; bound '
          f'{res["bound_ms"]:.4f} ms ({res["bound_by"]}: {res["flops"]:.4g} '
          f'flops, {res["bytes"]:.4g} bytes)')
    _check(res['scenes']['hits']['rays_over_kbuf'] > 0
           and res['scenes']['dense level-6']['rays_over_64'] > 0,
           'P3 scenes with counts past 64 and past kbuf')
    _check(all(counts[f'stage{st}'] >= 1 for st in _trace.STAGES),
           'every P3 stage launched on its path')
    return res, counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke.py: torch.cuda.is_available() is '
                         'False; this script runs only on a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda', 0)
    card = measure.card()

    toolchain(card)
    scene = make_scene(dev)
    torch.cuda.synchronize()
    inputs = kernel_inputs(scene)
    fid, prod, k1_err = check_forward(scene, inputs)
    g_prod, k2_err = check_backward(scene, inputs, fid, prod)
    culling(scene, inputs, g_prod)
    launches = train(scene)
    t = times(scene, inputs, g_prod, card)

    fv = spc_mesh()
    spc_build(fv, dev)
    spc = spc_main_path(fv, dev)
    args, k3_err = check_trace_kernel(spc)
    dense_err, dense_args = check_dense(dev)
    k3_err = max(k3_err, dense_err)
    check_against_bfs(spc)
    ts = spc_times(spc, args, card)

    _check(_probe_counts() == 0, 'no probe kernel ran on the DIB-R and '
           'SPC paths')
    p1, c1 = probe_p1(spc, card)
    p2, c2 = probe_p2(spc, card)
    p3, c3 = probe_p3(args, dense_args, card)

    k1_b, k1_f, k2_b, k2_f = dibr_work(scene, inputs, g_prod)
    k3_b, k3_f, _ = kbisect.trace_work(args, spc['hits'].count, False)
    print(f'bounds from this run\'s inputs: K1 {k1_b} bytes, {k1_f} flops; '
          f'K2 {k2_b} bytes, {k2_f} flops ({k2_f // K2_FLOPS} (face, pixel) '
          f'pairs); K3 {k3_b} bytes, {k3_f} flops')
    src = 'kaolin_tpu_torch/csrc/dibr_fused.cu'
    trace_src = 'kaolin_tpu_torch/csrc/spc_trace.cu'
    kernels = [
        dict(name='fused_forward_kernel', route='cuda', source=src,
             replaces='kaolin_tpu/render/mesh/_fused.py:232',
             launches=launches['fwd'], max_abs_err=k1_err,
             ms=t['k1_ms'], plain_ms=t['k1_plain_ms'],
             **_bound(k1_b, k1_f), library_ms=None),
        dict(name='fused_backward_kernel', route='cuda', source=src,
             replaces='kaolin_tpu/render/mesh/_fused.py:386',
             launches=launches['bwd'], max_abs_err=k2_err,
             ms=t['k2_ms'], plain_ms=t['k2_plain_ms'],
             **_bound(k2_b, k2_f), library_ms=None),
        dict(name='spc_trace_kernel', route='cuda', source=trace_src,
             replaces='kaolin_tpu/render/spc/raster.py:459',
             launches=spc['launches'], max_abs_err=k3_err,
             ms=ts['k3_ms'], plain_ms=ts['k3_plain_ms'],
             **_bound(k3_b, k3_f), library_ms=None),
    ]
    # the probes: `launches` counts their own entry point's run; none ran
    # on the DIB-R or SPC main paths (main_path_launches)
    for name in mosaic3.KERNELS:
        k = p1['script'][name]
        kernels.append(dict(
            name=name, route='cuda',
            source='kaolin_tpu_torch/csrc/probes.cu',
            replaces=f'scripts/probe_r5_mosaic3.py:{P1_LINES[name]}',
            launches=c1[name], main_path_launches=0,
            max_abs_err=p1['max_abs_err'][name], ms=k['ms'],
            plain_ms=k['plain_ms'], bound_ms=k['bound_ms'],
            bound_by=k['bound_by'], library_ms=k['library_ms']))
    k = p2['dummy'][max(p2['dummy'])]
    kernels.append(dict(
        name='dummy_kernel', route='cuda',
        source='kaolin_tpu_torch/csrc/probes.cu',
        replaces='scripts/probe_r5_stages.py:166', launches=c2['dummy'],
        main_path_launches=0, max_abs_err=k['max_abs_err'], ms=k['ms'],
        plain_ms=k['plain_ms'], bound_ms=k['bound_ms'],
        bound_by=k['bound_by'], library_ms=k['library_ms']))
    for st, k in p3['stages'].items():
        kernels.append(dict(
            name=f'spc_trace_kernel<STAGE={st}>', route='cuda',
            source=trace_src, replaces='scripts/probe_r5_kbisect.py:32',
            launches=c3[f'stage{st}'], main_path_launches=0,
            max_abs_err=p3['max_abs_err'][st], ms=k['ms'],
            plain_ms=k['plain_ms'], bound_ms=p3['bound_ms'],
            bound_by=p3['bound_by'], library_ms=None))
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
