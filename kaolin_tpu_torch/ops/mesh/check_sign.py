"""Point-in-watertight-mesh test (ray parity).

Port of ``kaolin_tpu/ops/mesh/check_sign.py``.  The default path is a
parity count of +z ray crossings over (point chunk x triangles).  With
``use_hash=True`` the native 2D triangle hash
(:class:`kaolin_tpu_torch._native.TriangleHash`) is built and queried on
the host, and only its candidate (point, triangle) pairs are tested, on
the entry device, with the JAX hash path's own rule: strict on every edge.
Neither path falls back to the other.
"""

import numpy as np
import torch

from kaolin_tpu_torch import _native
from kaolin_tpu_torch._device import entry_device

__all__ = ['check_sign', '_unbatched_check_sign_cuda']

# (point, face) pairs per step: ~25 (chunk, F) temporaries of 4 bytes
_CHUNK_PAIRS = 2 ** 24


def _crossings(points, v0, v1, v2):
    """Count +z ray crossings for each point against all triangles.

    points: (P, 3); v0/v1/v2: (F, 3).  Returns (P,) int32 counts.

    A crossing counts when the point's xy lies inside the triangle's xy
    projection (all edge functions share the sign of the doubled area; on
    an edge only for a positive area, so a shared edge counts once) and
    the triangle's plane at that xy lies above the point.
    """
    px = points[:, 0:1]  # (P, 1)
    py = points[:, 1:2]
    pz = points[:, 2:3]
    x0, y0, z0 = v0[:, 0], v0[:, 1], v0[:, 2]  # (F,)
    x1, y1, z1 = v1[:, 0], v1[:, 1], v1[:, 2]
    x2, y2, z2 = v2[:, 0], v2[:, 1], v2[:, 2]

    # edge functions w.r.t. each edge, (P, F)
    e01 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    e12 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    e20 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    area2 = (x1 - x0) * (y2 - y0) - (y1 - y0) * (x2 - x0)  # (F,)
    s = torch.sign(area2)
    inside = ((e01 * s > 0) & (e12 * s > 0) & (e20 * s > 0)) | \
             ((e01 * s >= 0) & (e12 * s >= 0) & (e20 * s >= 0) &
              ((e01 == 0) | (e12 == 0) | (e20 == 0)) & (s > 0))
    degenerate = area2 == 0
    # z of the triangle's plane at (px, py), barycentric
    denom = torch.where(degenerate, 1., area2)
    w0 = e12 / denom
    w1 = e20 / denom
    w2 = e01 / denom
    z_at = w0 * z0 + w1 * z1 + w2 * z2  # (P, F)
    hit = inside & ~degenerate & (z_at > pz)
    return torch.sum(hit, dim=1, dtype=torch.int32)


def _hash_parity(tris, points, pidx, tidx):
    """The hash path's device test: for each candidate pair (point
    ``pidx``, triangle ``tidx``) the strict inside test and the plane's z in
    float32, in the JAX hash path's order; then the parity of each point's
    hits.  ``tris`` (F, 3, 3) and ``points`` (P, 3) on the device, the pairs
    int64 on the same device, taken ~16 M at a time."""
    counts = torch.zeros(points.shape[0], dtype=torch.int64,
                         device=points.device)
    for lo in range(0, pidx.shape[0], _CHUNK_PAIRS):
        pi = pidx[lo:lo + _CHUNK_PAIRS]
        t = tris[tidx[lo:lo + _CHUNK_PAIRS]]
        p = points[pi]
        v0, v1, v2 = t[:, 0], t[:, 1], t[:, 2]
        e01 = ((v1[:, 0] - v0[:, 0]) * (p[:, 1] - v0[:, 1])
               - (v1[:, 1] - v0[:, 1]) * (p[:, 0] - v0[:, 0]))
        e12 = ((v2[:, 0] - v1[:, 0]) * (p[:, 1] - v1[:, 1])
               - (v2[:, 1] - v1[:, 1]) * (p[:, 0] - v1[:, 0]))
        e20 = ((v0[:, 0] - v2[:, 0]) * (p[:, 1] - v2[:, 1])
               - (v0[:, 1] - v2[:, 1]) * (p[:, 0] - v2[:, 0]))
        area2 = ((v1[:, 0] - v0[:, 0]) * (v2[:, 1] - v0[:, 1])
                 - (v1[:, 1] - v0[:, 1]) * (v2[:, 0] - v0[:, 0]))
        s = torch.sign(area2)
        inside = (e01 * s > 0) & (e12 * s > 0) & (e20 * s > 0) \
            & (area2 != 0)
        denom = torch.where(area2 == 0, 1., area2)
        z_at = (e12 * t[:, 0, 2] + e20 * t[:, 1, 2]
                + e01 * t[:, 2, 2]) / denom
        hit = inside & (z_at > p[:, 2])
        counts += torch.bincount(pi[hit], minlength=points.shape[0])
    return counts % 2 == 1


def _check_sign_hash(verts, faces, points, hash_resolution):
    """The hash path: candidate pairs from the native triangle hash over
    the triangles' xy (float64 copies of the float32 values, on the host),
    then :func:`_hash_parity` on the device."""
    out = []
    for verts_b, points_b in zip(verts, points):
        tris = verts_b[faces]  # (F, 3, 3)
        th = _native.TriangleHash(
            tris[:, :, :2].detach().cpu().numpy().astype(np.float64),
            hash_resolution)
        pidx, tidx = th.query(
            points_b[:, :2].detach().cpu().numpy().astype(np.float64))
        out.append(_hash_parity(tris, points_b,
                                torch.as_tensor(pidx, device=verts.device),
                                torch.as_tensor(tidx, device=verts.device)))
    return torch.stack(out)


def check_sign(verts, faces, points, hash_resolution=512, chunk_size=None,
               use_hash=False, device=None):
    """Whether points lie inside watertight triangle meshes.

    Args:
        verts: ``(B, V, 3)``.
        faces: ``(F, 3)`` int.
        points: ``(B, P, 3)``.
        hash_resolution: cells per side of the triangle hash
            (``use_hash=True``).
        chunk_size: points per step of the default path (default: ~16 M
            (point, face) pairs).
        use_hash: take the candidates from the native triangle hash
            (host) and test only those (strict on every edge, as the JAX
            hash path) instead of every (point, face) pair.
        device: where the test runs (default: the device of ``verts``,
            else of ``points``, else the card, see
            :func:`~kaolin_tpu_torch._device.entry_device`).

    Returns:
        ``(B, P)`` bool, True = inside.
    """
    if verts.ndim != 3 or verts.shape[-1] != 3:
        raise ValueError(
            f"verts must be (B, V, 3), got {tuple(verts.shape)}")
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(
            f"points must be (B, P, 3), got {tuple(points.shape)}")
    device = entry_device(device, verts, points)
    verts = torch.as_tensor(verts, device=device)
    points = torch.as_tensor(points, device=device)
    faces = torch.as_tensor(faces, device=device).long()
    if use_hash:
        return _check_sign_hash(verts, faces, points, hash_resolution)
    rows = chunk_size or max(1, _CHUNK_PAIRS // max(1, faces.shape[0]))
    out = []
    for verts_b, points_b in zip(verts, points):
        fv = verts_b[faces]  # (F, 3, 3)
        counts = torch.cat([
            _crossings(points_b[lo:lo + rows], fv[:, 0], fv[:, 1], fv[:, 2])
            for lo in range(0, points_b.shape[0], rows)])
        out.append(counts % 2 == 1)
    return torch.stack(out)


def _unbatched_check_sign_cuda(verts, faces, points):
    """The reference's CUDA entry point: the unbatched ray-parity test."""
    return check_sign(verts[None], faces, points[None])[0]
