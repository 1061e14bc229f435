"""Point-in-watertight-mesh test (ray parity).

Port of ``kaolin_tpu/ops/mesh/check_sign.py``, its default vectorised path:
a parity count of +z ray crossings over (point chunk x triangles).  The
JAX package's ``use_hash=True`` path (a native 2D triangle hash) is not
ported: it raises here rather than falling back to another path.
"""

import torch

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


def check_sign(verts, faces, points, hash_resolution=512, chunk_size=None,
               use_hash=False):
    """Whether points lie inside watertight triangle meshes.

    Args:
        verts: ``(B, V, 3)``.
        faces: ``(F, 3)`` int.
        points: ``(B, P, 3)``.
        hash_resolution: accepted for the API (no hash here).
        chunk_size: points per step (default: ~16 M (point, face) pairs).
        use_hash: the JAX package's native triangle-hash path; not ported.

    Returns:
        ``(B, P)`` bool, True = inside.

    Raises:
        NotImplementedError: ``use_hash=True``.
    """
    if verts.ndim != 3 or verts.shape[-1] != 3:
        raise ValueError(
            f"verts must be (B, V, 3), got {tuple(verts.shape)}")
    if points.ndim != 3 or points.shape[-1] != 3:
        raise ValueError(
            f"points must be (B, P, 3), got {tuple(points.shape)}")
    if use_hash:
        raise NotImplementedError(
            'check_sign(use_hash=True) needs the native triangle hash '
            '(csrc/triangle_hash.cpp), which kaolin_tpu_torch does not load '
            'yet (ROADMAP.md section 1, item 14: the native loaders); use '
            'the default use_hash=False')
    faces = torch.as_tensor(faces, device=verts.device).long()
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
