#!/usr/bin/env python3
"""Smoke run of kaolin_tpu_torch, the PyTorch + CUDA port, on one GPU.

Drives the port's main path — the DIB-R inverse-rendering trainer of
``examples/dibr_inverse_rendering.py`` (fused selection -> textured,
SH-lit render -> image L1 + mask IoU loss -> backward -> Adam) — at 512^2,
4 views, a 256^2 texture and a 10,000-face textured UV sphere, and checks
it phase by phase:

1. toolchain: the card, torch, nvcc, triton; the kernels are built from
   ``kaolin_tpu_torch/csrc`` into ``build/kaolin_tpu_torch/``;
2. the forward kernel (K1) against its plain PyTorch version;
3. the backward kernel (K2) against its plain PyTorch version;
4. 5 Adam steps; step 0's loss and gradients against the plain path (the
   same step on the CPU, where the wrappers run the plain versions);
5. times (CUDA events after warm-up) of the step and of each kernel
   beside its plain version.

Every phase synchronises and raises on failure; there is no CPU path.
Usage: ``python3 chip_smoke.py`` from the root of the repository.  The last
line of its output is ``{"ok": true, "device": {...}}``; the line before
it lists the kernels.
"""

import json
import subprocess
import time

import numpy as np
import torch

from kaolin_tpu_torch import _cuda
from kaolin_tpu_torch.models import inverse_render as M
from kaolin_tpu_torch.render.mesh import _fused as FU
from kaolin_tpu_torch.utils.testing import uv_sphere

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
    t0 = time.perf_counter()
    _cuda.load('dibr_fused')
    build_s = time.perf_counter() - t0
    print(f'kernel build + load (dibr_fused.cu): {build_s:.2f} s')
    for line in _cuda.BUILD_LOG.get('dibr_fused', '').splitlines():
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
    ]
    print(card)
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
