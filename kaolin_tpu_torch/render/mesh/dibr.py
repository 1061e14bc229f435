"""DIB-R: soft silhouette mask + full differentiable renderer.

Port of ``kaolin_tpu/render/mesh/dibr.py``.  Two soft-mask paths:

* **fused** (``kbuf`` a :class:`~._fused.FusedSelection`): one fused
  selection pass (kernel K1 on the card) yields both the z-buffer winner
  and the uncapped soft-mask product; the soft mask's backward is kernel
  K2.
* **k-buffer** (``kbuf`` a ``(B, H, W, knum)`` tensor or None), plain
  PyTorch:

  1. the non-differentiable selection :func:`dibr_soft_mask_select`: for
     each empty pixel the first ``knum`` faces, in face order, whose
     enlarged bbox covers it;
  2. the differentiable epilogue :class:`_SoftMaskEpilogue`: per (pixel,
     k) the min squared distance to the face (3 perpendicular edge
     distances with the "bad triangle" sentinel ``4*multiplier**2`` and 3
     vertex distances), ``prob = exp(-sigmainv * d / multiplier**2)``,
     combined as ``1 - prod(1 - p)``.  Its backward is hand-derived: it
     recomputes the distances, takes the argmin branch and uses exact
     exclusive products (left and right cumprods) for ``dL/dprob``.
"""

import torch

from kaolin_tpu_torch.render.mesh._fused import (
    FusedSelection, fused_selection, softmask_fused)
from kaolin_tpu_torch.render.mesh.rasterization import (
    _resolve_backend, pixel_coords, rasterize)

__all__ = ['dibr_soft_mask', 'dibr_soft_mask_select', 'dibr_rasterization']

_EPS = 1e-7


def _soft_mask_select(face_bboxes, empty_pixel, xs, ys, height, width, knum,
                      pixel_chunk=4096):
    """First-knum covering faces per pixel (single mesh).

    face_bboxes: (F, 4) enlarged [xmin, ymin, xmax, ymax] (scaled);
    empty_pixel: (H, W) bool.  The first ``knum`` faces in face order have
    the ``knum`` largest keys ``F + 1 - fid`` among the covering faces;
    ``torch.topk`` over all faces per block of ``pixel_chunk`` pixels.

    Returns:
        (H, W, knum) int32 face indices, -1 padded.
    """
    F = face_bboxes.shape[0]
    P = height * width
    dev = face_bboxes.device
    pix = torch.arange(P, device=dev)
    px, py = xs[pix % width], ys[pix // width]
    empty = empty_pixel.reshape(-1)
    keys_cover = F + 1 - torch.arange(F, dtype=torch.int32, device=dev)
    out = torch.empty((P, knum), dtype=torch.int32, device=dev)
    for lo in range(0, P, pixel_chunk):
        x0 = px[lo:lo + pixel_chunk, None]
        y0 = py[lo:lo + pixel_chunk, None]
        covered = ((x0 >= face_bboxes[None, :, 0])
                   & (x0 < face_bboxes[None, :, 2])
                   & (y0 >= face_bboxes[None, :, 1])
                   & (y0 < face_bboxes[None, :, 3])
                   & empty[lo:lo + pixel_chunk, None])
        keys = torch.where(covered, keys_cover, 0)
        if F < knum:        # topk needs k <= axis size; pad with invalid keys
            keys = torch.nn.functional.pad(keys, (0, knum - F))
        best = torch.topk(keys, knum, dim=1).values
        out[lo:lo + pixel_chunk] = torch.where(best > 0, F + 1 - best, -1)
    return out.reshape(height, width, knum)


def _sqdists(fv, x0, y0, multiplier):
    """The 6 squared-distance candidates from pixel (x0, y0) to a 2D
    triangle, stacked on the last axis: 3 perpendicular edge distances
    (sentinel ``4*multiplier**2`` when the foot point falls outside the
    segment), then 3 vertex distances."""
    sentinel = 4. * multiplier * multiplier
    dists = [torch.where(e[6] > 0, sentinel, e[5])
             for e in _soft_mask_edge_terms(fv, x0, y0)]
    for i in range(3):
        dists.append((x0 - fv[..., i, 0]) ** 2 + (y0 - fv[..., i, 1]) ** 2)
    return torch.stack(dists, dim=-1)


def _face_min_sqdist(fv, x0, y0, multiplier):
    """Min squared distance from pixel (x0, y0) to a 2D triangle.

    fv: (..., 3, 2) scaled face verts; x0/y0 broadcastable to (...).
    """
    return _sqdists(fv, x0, y0, multiplier).amin(dim=-1)


def dibr_soft_mask_select(face_vertices_image, selected_face_idx,
                          boxlen=0.02, knum=30, multiplier=1000.):
    """Run only the (non-differentiable) k-buffer selection of the soft
    mask: the first ``knum`` faces whose enlarged bbox covers each empty
    pixel.  Feed the result to :func:`dibr_soft_mask` via ``kbuf=``.

    Returns:
        ``(B, H, W, knum)`` int32 face indices (-1 padded).
    """
    B, H, W = selected_face_idx.shape
    fvi_scaled = face_vertices_image.detach() * multiplier
    bboxes = torch.cat([fvi_scaled.amin(dim=-2) - boxlen * multiplier,
                        fvi_scaled.amax(dim=-2) + boxlen * multiplier],
                       dim=-1)
    xs, ys = pixel_coords(H, W, multiplier, dtype=fvi_scaled.dtype,
                          device=fvi_scaled.device)
    empty = selected_face_idx < 0
    return torch.stack([
        _soft_mask_select(bboxes[b], empty[b], xs, ys, H, W, knum)
        for b in range(B)])


def _soft_mask_gather(fvi_scaled, kbuf):
    """Gather per-(pixel, k) face vertices, batch folded into the ids."""
    B, F = fvi_scaled.shape[:2]
    sel = torch.clamp(kbuf, min=0).long()
    gid = sel + (torch.arange(B, device=sel.device)
                 .reshape((B,) + (1,) * (kbuf.ndim - 1))) * F
    return fvi_scaled.reshape(B * F, 3, 2)[gid], gid


def _soft_mask_edge_terms(fv, x0, y0):
    """Line coefficients + perpendicular distances for the 3 edges.

    Returns per-edge tuples (A, B, C, up, down, perp, direct).
    """
    out = []
    for i in range(3):
        x1, y1 = fv[..., i, 0], fv[..., i, 1]
        x2, y2 = fv[..., (i + 1) % 3, 0], fv[..., (i + 1) % 3, 1]
        A = y2 - y1
        B = x1 - x2
        C = x2 * y1 - x1 * y2
        up = A * x0 + B * y0 + C
        down = A * A + B * B
        x3 = (B * B * x0 - A * B * y0 - A * C) / (down + _EPS)
        y3 = (A * A * y0 - A * B * x0 - B * C) / (down + _EPS)
        direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2)
        perp = up * up / (down + _EPS)
        out.append((A, B, C, up, down, perp, direct))
    return out


def _soft_mask_prob(fvi_scaled, kbuf, sigmainv, multiplier, xs, ys):
    """Per-(pixel, k) influence probability, its argmin branch and the
    flat face ids it gathered."""
    x0 = xs[None, None, :, None]
    y0 = ys[None, :, None, None]
    fv, gid = _soft_mask_gather(fvi_scaled, kbuf)   # (B, H, W, K, 3, 2)
    d, branch = _sqdists(fv, x0, y0, multiplier).min(dim=-1)  # first min
    z = (sigmainv / (multiplier * multiplier)) * d
    prob = torch.where(kbuf >= 0, torch.exp(-z), 0.)
    return prob, branch, gid


class _SoftMaskEpilogue(torch.autograd.Function):
    """Differentiable soft-mask epilogue over a fixed k-buffer.

    fvi_scaled: (B, F, 3, 2); kbuf: (B, H, W, K) int32 (-1 padded);
    empty: (B, H, W) bool; xs (W,) / ys (H,) pixel-center coords (scaled).
    Returns the (B, H, W) mask.

    The backward is the hand-derived one of the JAX package's
    ``_soft_mask_epilogue_bwd``: it recomputes the distances in one pass,
    selects the argmin branch with masks, takes ``dL/dprob_k = g *
    prod_{j != k}(1 - p_j)`` from exact exclusive cumprods (no ``(1 -
    allprob) / (1 - p_k)`` division) and accumulates the six coordinate
    gradients with one ``index_add_``.  The padded (-1) slots carry zero
    gradient.  They all gather face 0, and on the card the adds of
    millions of zero rows to one row run serially, so each adds its zero
    to a row of its own (its position modulo B * F) instead: leaving them
    out by a boolean mask would wait for the card, which a CUDA graph of
    the step cannot.  A zero added changes no sum.
    """

    @staticmethod
    def forward(ctx, fvi_scaled, kbuf, empty, xs, ys, sigmainv, multiplier):
        prob, _, _ = _soft_mask_prob(fvi_scaled, kbuf, sigmainv, multiplier,
                                     xs, ys)
        allprob = 1. - torch.prod(1. - prob, dim=-1)
        ctx.save_for_backward(fvi_scaled, kbuf, empty, xs, ys)
        ctx.consts = (sigmainv, multiplier)
        return torch.where(empty, allprob, 1.)

    @staticmethod
    def backward(ctx, g):
        fvi_scaled, kbuf, empty, xs, ys = ctx.saved_tensors
        sigmainv, multiplier = ctx.consts
        B, F = fvi_scaled.shape[:2]
        x0 = xs[None, None, :, None]
        y0 = ys[None, :, None, None]
        prob, branch, gid = _soft_mask_prob(fvi_scaled, kbuf, sigmainv,
                                            multiplier, xs, ys)
        fv, _ = _soft_mask_gather(fvi_scaled, kbuf)

        one_minus = 1. - prob
        ones = torch.ones_like(one_minus[..., :1])
        left = torch.cat([ones, torch.cumprod(one_minus[..., :-1], -1)], -1)
        right = torch.cat([torch.flip(torch.cumprod(
            torch.flip(one_minus[..., 1:], [-1]), -1), [-1]), ones], -1)
        g_eff = torch.where(empty, g, 0.)
        dprob = g_eff[..., None] * (left * right)
        inv = sigmainv / (multiplier * multiplier)
        # prob = exp(-inv * d) -> dL/dd = -inv * prob * dL/dprob
        dd = torch.where(kbuf >= 0, -inv * prob * dprob, 0.)

        comp = [torch.zeros_like(dd) for _ in range(6)]  # x0,y0,..,x2,y2
        for e, (A, Bc, C, up, down, perp, direct) in enumerate(
                _soft_mask_edge_terms(fv, x0, y0)):
            w = torch.where((branch == e) & (direct <= 0), dd, 0.)
            dA = 2. * (up * x0 - perp * A) / (down + _EPS)
            dB = 2. * (up * y0 - perp * Bc) / (down + _EPS)
            dC = 2. * up / (down + _EPS)
            j = (e + 1) % 3
            x1, y1 = fv[..., e, 0], fv[..., e, 1]
            x2, y2 = fv[..., j, 0], fv[..., j, 1]
            comp[2 * e] = comp[2 * e] + w * (dB - dC * y2)
            comp[2 * e + 1] = comp[2 * e + 1] + w * (dC * x2 - dA)
            comp[2 * j] = comp[2 * j] + w * (dC * y1 - dB)
            comp[2 * j + 1] = comp[2 * j + 1] + w * (dA - dC * x1)
        for v in range(3):
            w = torch.where(branch == 3 + v, dd, 0.)
            comp[2 * v] = comp[2 * v] + w * 2. * (fv[..., v, 0] - x0)
            comp[2 * v + 1] = comp[2 * v + 1] + w * 2. * (fv[..., v, 1] - y0)

        live = (kbuf >= 0).reshape(-1)
        rows = torch.stack([c.reshape(-1) for c in comp], dim=-1)  # (N, 6)
        spread = torch.arange(live.numel(), device=live.device) % (B * F)
        dfvi = torch.zeros((B * F, 6), dtype=fvi_scaled.dtype,
                           device=fvi_scaled.device)
        dfvi.index_add_(0, torch.where(live, gid.reshape(-1), spread),
                        torch.where(live[:, None], rows, 0.))
        return dfvi.reshape(B, F, 3, 2), None, None, None, None, None, None


def dibr_soft_mask(face_vertices_image, selected_face_idx, sigmainv=7000,
                   boxlen=0.02, knum=30, multiplier=1000., kbuf=None):
    """Differentiable soft silhouette mask.

    Args:
        face_vertices_image: ``(B, F, 3, 2)`` image-plane positions in
            [-1, 1].
        selected_face_idx: ``(B, H, W)`` winning face per pixel (-1 = empty).
        sigmainv: sharpness (higher = sharper).
        boxlen: influence margin around each face bbox.
        knum: max faces influencing one pixel (k-buffer path).
        multiplier: internal coordinate scale.
        kbuf: precomputed selection: the ``(B, H, W, knum)`` k-buffer from
            :func:`dibr_soft_mask_select`, or the
            :class:`~kaolin_tpu_torch.render.mesh.FusedSelection` of the
            same geometry (uncapped product; ``knum`` ignored); computed
            here (k-buffer) when None.

    Returns:
        ``(B, H, W)`` soft mask in [0, 1].
    """
    _, H, W = selected_face_idx.shape
    fvi_scaled = face_vertices_image * multiplier
    if isinstance(kbuf, FusedSelection):
        return softmask_fused(fvi_scaled, kbuf,
                              (H, W, float(multiplier), float(sigmainv)))
    if kbuf is None:
        kbuf = dibr_soft_mask_select(face_vertices_image, selected_face_idx,
                                     boxlen, knum, multiplier)
    xs, ys = pixel_coords(H, W, multiplier, dtype=fvi_scaled.dtype,
                          device=fvi_scaled.device)
    return _SoftMaskEpilogue.apply(fvi_scaled, kbuf.detach(),
                                   selected_face_idx < 0, xs, ys,
                                   float(sigmainv), float(multiplier))


def dibr_rasterization(height, width, face_vertices_z, face_vertices_image,
                       face_features, face_normals_z, sigmainv=7000,
                       boxlen=0.02, knum=30, multiplier=None, eps=None,
                       rast_backend='auto'):
    """Full DIB-R differentiable renderer: rasterize with backface culling
    (``face_normals_z >= 0``) + soft mask.

    Returns:
        (image_features, soft_mask, face_idx).
    """
    _multiplier = 1000. if multiplier is None else multiplier
    if _resolve_backend(rast_backend) == 'fused':
        # one fused selection pass yields both the z-buffer winner and the
        # soft-mask product; the epilogues reuse it
        sel = fused_selection(
            face_vertices_z, face_vertices_image, face_normals_z >= 0.,
            height, width, _multiplier, boxlen=boxlen, sigmainv=sigmainv,
            eps=1e-8 if eps is None else eps)
        interpolated_features, face_idx = rasterize(
            height, width, face_vertices_z, face_vertices_image,
            face_features, multiplier=multiplier, eps=eps,
            precomputed_face_idx=sel.face_idx)
        soft_mask = dibr_soft_mask(face_vertices_image, face_idx, sigmainv,
                                   boxlen, knum, _multiplier, kbuf=sel)
        return interpolated_features, soft_mask, face_idx
    interpolated_features, face_idx = rasterize(
        height, width, face_vertices_z, face_vertices_image, face_features,
        face_normals_z >= 0., multiplier, eps, 'jnp')
    soft_mask = dibr_soft_mask(face_vertices_image, face_idx, sigmainv,
                               boxlen, knum, _multiplier)
    return interpolated_features, soft_mask, face_idx
