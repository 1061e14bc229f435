"""What the port's measurements share: the card's peaks, the bound, a
device timer, the card's name and the SPC cell's trace settings.

``chip_smoke.py`` times the main paths with these, and the probes
(:mod:`kaolin_tpu_torch.probes`) time their kernels with the same, so a
main-path time and a probe's time of the same kernel are comparable.
"""

import subprocess

import torch

__all__ = ['HBM_BYTES_PER_S', 'FP32_FLOP_PER_S', 'TRACE', 'time_ms',
           'bound_ms', 'card']

# H100 SXM published peaks (NVIDIA's data sheet, at the 700 W power limit):
# device memory and float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

# the coherent trace of BASELINE config #3 as bench.py:243 runs it: knum
# 256, no exit depths, 32 rays per tile, the non-saturating segment caps
TRACE = dict(knum=256, with_exit=False, rays_per_tile=32,
             max_super_voxels=512 * 192, max_active_blocks=8192,
             segments=((512, 192), (1536, 48), (4096, 16), (None, 4)))


def time_ms(fn, iters, warmup=1):
    """Mean device time of fn() over ``iters`` calls after warm-up (CUDA
    events on the current stream)."""
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


def bound_ms(nbytes, flops):
    """The least time the card could take: (ms, 'bytes' or 'operations'),
    the larger of bytes over the device memory rate and float32
    operations over the float32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def card():
    """``nvidia-smi``'s name and power limit of the first card."""
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
