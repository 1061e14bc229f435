"""Primary / shadow ray generation (deprecated in the reference).

Port of ``kaolin_tpu/render/spc/raygen.py``; parity
``kaolin/csrc/render/spc/raytrace_cuda.cu:763-894``.
"""

import torch

from kaolin_tpu_torch._device import entry_device

__all__ = ['generate_primary_rays', 'generate_shadow_rays']


def generate_primary_rays(width, height, tf, device=None):
    """Camera-matrix primary rays, one per pixel.

    For pixel index ``i``: ``px = i % width`` and ``py = i // height`` (the
    reference divides by *height*; this matters only for non-square
    images), ``ray_o = (0, 0, 1, 0) @ tf`` and ``ray_d = (px, py, 0, 1) @
    tf``.

    Args:
        width, height: image size.
        tf: (4, 4) row-vector transform matrix.
        device: where to run (default: the device of a tensor ``tf``, the
            card for a numpy one).

    Returns:
        (ray_o (num, 3), ray_d (num, 3)) float32, ``num = width * height``,
        on that device.
    """
    tf = torch.as_tensor(tf, dtype=torch.float32,
                         device=entry_device(device, tf))
    num = width * height
    i = torch.arange(num, dtype=torch.int64, device=tf.device)
    px = (i % width).to(torch.float32)
    py = (i // height).to(torch.float32)
    a = torch.tensor([0., 0., 1., 0.], device=tf.device) @ tf
    b = torch.stack([px, py, torch.zeros_like(px), torch.ones_like(px)],
                    dim=-1) @ tf
    return a[:3].expand(num, 3), b[:, :3]


def generate_shadow_rays(ray_o, ray_d, light, plane, device=None):
    """Shadow rays toward a point light from ray/plane intersections.

    Each ray is intersected with ``plane`` ((4,): ax + by + cz + d = 0);
    hits with ``t > 0`` and ``|dir . n| > 1e-3`` are kept in order, and
    each shadow ray starts at ``light`` pointing at its intersection.  It
    runs on ``device`` (default: the device of the first tensor input, the
    card for numpy inputs).

    Returns:
        (src (cnt, 3) — ``light`` repeated, dst (cnt, 3) unit directions
        light -> intersection, map (cnt,) int64 — index of the primary ray).
    """
    device = entry_device(device, ray_o, ray_d, light, plane)
    ray_o, ray_d, light, plane = (
        torch.as_tensor(x, dtype=torch.float32, device=device)
        for x in (ray_o, ray_d, light, plane))
    a = ray_o @ plane[:3] + plane[3]
    b = ray_d @ plane[:3]
    t = -a / torch.where(b.abs() > 1e-3, b, 1.)
    hit = (b.abs() > 1e-3) & (t > 0.)
    idx = torch.nonzero(hit).squeeze(1)
    pts = (ray_o + t[:, None] * ray_d)[idx]
    dirs = pts - light
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    return light.expand(pts.shape), dirs, idx
