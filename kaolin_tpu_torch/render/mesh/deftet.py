"""DefTet sparse volumetric renderer: a depth-sorted k-buffer rasterizer.

Port of ``kaolin_tpu/render/mesh/deftet.py``, plain PyTorch (the JAX
package computes it with XLA ops, no Pallas kernel).  Two engines with the
same answer whenever the binned engine's candidate cap covers the scene:

* the default one: a non-differentiable selection pass
  (:func:`_deftet_select`) keeps, per pixel, the first ``knum`` covering
  faces in mesh order (one ``topk`` over all faces per pixel block); a
  differentiable epilogue recomputes barycentric weights, sorts the slots
  by depth (stable, near to far) and interpolates the features;
* the binned one (:func:`_deftet_render_binned`, ``max_candidates`` set):
  faces sorted by quantized bbox center in chunks of 64, and per block of
  pixels only the face chunks whose bbox overlaps the block are tested.

Both stop the gradient to ``pixel_coords`` (the JAX package's default
engine passes it; the binned one and the reference Kaolin do not).
"""

import torch
import torch.nn.functional as F_

__all__ = ['deftet_sparse_render', '_naive_deftet_sparse_render']

_BIG = 2 ** 30
_GROUP_ELEMS = 2 ** 24      # (pixel, candidate) pairs per binned group


def _split_features(feats, face_features, as_tuple):
    out, cur = [], 0
    for f in face_features:
        out.append(feats[..., cur:cur + f.shape[-1]])
        cur += f.shape[-1]
    return tuple(out) if as_tuple else out


def _bary(rows, x0, y0, eps_of):
    """Normalized barycentrics of rows (..., >= 6) = (ax, ay, bx, by, cx,
    cy, ...) at (x0, y0); ``eps_of(norm)`` is the engine's epsilon rule."""
    a_ex, a_ey = rows[..., 0] - x0, rows[..., 1] - y0
    b_ex, b_ey = rows[..., 2] - x0, rows[..., 3] - y0
    c_ex, c_ey = rows[..., 4] - x0, rows[..., 5] - y0
    w0 = b_ex * c_ey - b_ey * c_ex
    w1 = c_ex * a_ey - c_ey * a_ex
    w2 = a_ex * b_ey - a_ey * b_ex
    norm = w0 + w1 + w2
    norm = norm + eps_of(norm)
    return w0 / norm, w1 / norm, w2 / norm


def _deftet_render_binned(pixel_coords, render_ranges, face_vertices_z,
                          face_vertices_image, face_features, valid_faces,
                          knum, eps, max_candidates, pixel_chunk=1024):
    """Spatially binned k-buffer render (single mesh): selection and
    interpolation in one pass.

    * faces are sorted by quantized bbox center and grouped into chunks of
      64; per pixel chunk only the first ``ceil(max_candidates / 64)`` face
      chunks (in sorted order) whose bbox overlaps the pixel chunk's bbox
      are tested: an undersized cap drops the face chunks with the highest
      sort keys;
    * the first ``knum`` covering faces per pixel in mesh order are the
      ``knum`` smallest face ids among the covered candidates;
    * the slots are sorted by depth (stable, near to far).

    Returns:
        (feats (P, knum, D), face_idx (P, knum) depth-sorted, -1 pad).
    """
    F = face_vertices_z.shape[0]
    P = pixel_coords.shape[0]
    D = face_features.shape[-1]
    dev = face_vertices_z.device
    CKf = max(1, -(-int(max_candidates) // 64))
    fpad = (-F) % 64
    Fp = F + fpad
    nFc = Fp // 64
    CKf = min(CKf, nFc)
    C = CKf * 64

    fvi = face_vertices_image.detach()
    fmin = fvi.amin(dim=1)                                # (F, 2)
    fmax = fvi.amax(dim=1)

    # spatial sort by quantized bbox center (row-major)
    ctr = (fmin + fmax) * 0.5
    clo = ctr.amin(dim=0)
    chi = ctr.amax(dim=0)
    q = torch.clamp(((ctr - clo) / torch.clamp(chi - clo, min=1e-12)
                     * 1023.).to(torch.int32), 0, 1023)
    perm = torch.argsort(q[:, 1] * 1024 + q[:, 0], stable=True)

    def pad64(a, fill=0.):
        return F_.pad(a, (0, 0) * (a.ndim - 1) + (0, fpad), value=fill)

    fvi_s = pad64(face_vertices_image[perm])              # (Fp, 3, 2) diff
    fvz_s = pad64(face_vertices_z[perm])
    ff_s = pad64(face_features[perm])                     # (Fp, 3, D)
    fid_s = F_.pad(perm.to(torch.int32), (0, fpad), value=_BIG)
    valid_s = pad64(valid_faces[perm].to(fvi.dtype))
    bmin_s = pad64(fmin[perm], float('inf'))
    bmax_s = pad64(fmax[perm], float('-inf'))
    cb_lo = bmin_s.reshape(nFc, 64, 2).amin(dim=1)         # (nFc, 2)
    cb_hi = bmax_s.reshape(nFc, 64, 2).amax(dim=1)

    # chunked tables (differentiable; selection metadata) + a dump chunk
    W = 9 + 3 * D
    vt_g = torch.cat([fvi_s.reshape(Fp, 6), fvz_s, ff_s.reshape(Fp, 3 * D)],
                     dim=-1).reshape(nFc, 64, W)
    vt_g = torch.cat([vt_g, vt_g.new_zeros((1, 64, W))])
    vt_m = torch.stack([bmin_s[:, 0], bmin_s[:, 1], bmax_s[:, 0],
                        bmax_s[:, 1], valid_s], -1).reshape(nFc, 64, 5)
    vt_m = torch.cat([vt_m, vt_m.new_zeros((1, 64, 5))])
    fid_c = torch.cat([fid_s.reshape(nFc, 64),
                       torch.full((1, 64), _BIG, dtype=torch.int32,
                                  device=dev)])

    # pixel chunks and their candidate face chunks; padded pixels sit at
    # (0, 0) with the empty range (0, 0), and the tail is sliced off
    ppad = (-P) % pixel_chunk
    nPc = (P + ppad) // pixel_chunk
    pcs = F_.pad(pixel_coords.detach(), (0, 0, 0, ppad)).reshape(
        nPc, pixel_chunk, 2)
    rrs = F_.pad(render_ranges.detach(), (0, 0, 0, ppad)).reshape(
        nPc, pixel_chunk, 2)
    plo = pcs.amin(dim=1)
    phi = pcs.amax(dim=1)
    ov = ((cb_lo[None, :, 0] <= phi[:, None, 0])
          & (cb_hi[None, :, 0] >= plo[:, None, 0])
          & (cb_lo[None, :, 1] <= phi[:, None, 1])
          & (cb_hi[None, :, 1] >= plo[:, None, 1]))        # (nPc, nFc)
    cidx = torch.arange(nFc, dtype=torch.int32, device=dev)
    top = torch.topk(torch.where(ov, nFc - cidx, 0), CKf, dim=1).values
    cand_ids = torch.where(top > 0, nFc - top, nFc).long()  # (nPc, CKf)

    def eps_sel(norm):
        return torch.where(norm >= 0., eps, -eps)

    K = min(knum, C)
    group = max(1, _GROUP_ELEMS // (pixel_chunk * C))
    feats_out, fidx_out = [], []
    for lo in range(0, nPc, group):
        ids = cand_ids[lo:lo + group]                      # (G, CKf)
        G = ids.shape[0]
        g = vt_g[ids].reshape(G, C, W)                     # differentiable
        m = vt_m[ids].reshape(G, C, 5)
        fid = fid_c[ids].reshape(G, C)
        pcc, rrc = pcs[lo:lo + group], rrs[lo:lo + group]  # (G, pc, 2)
        x0, y0 = pcc[..., 0:1], pcc[..., 1:2]              # (G, pc, 1)
        with torch.no_grad():
            gs = g.detach()[:, None]                       # (G, 1, C, W)
            m_ = m[:, None]
            in_bbox = ((x0 >= m_[..., 0]) & (x0 < m_[..., 2])
                       & (y0 >= m_[..., 1]) & (y0 < m_[..., 3])
                       & (m_[..., 4] > 0.))
            w0, w1, w2 = _bary(gs, x0, y0, eps_sel)
            inside = (w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.)
            depth = w0 * gs[..., 6] + w1 * gs[..., 7] + w2 * gs[..., 8]
            covered = (in_bbox & inside & (depth > rrc[..., 0:1])
                       & (depth < rrc[..., 1:2]))          # (G, pc, C)
            keys = torch.where(covered, fid[:, None], _BIG)
            best, slot = torch.topk(keys, K, dim=-1, largest=False)
            live = best < _BIG
            slots = torch.where(live, slot, -1)
            if K < knum:
                slots = F_.pad(slots, (0, knum - K), value=-1)
                live = slots >= 0

        # differentiable epilogue: gather the selected candidates' rows,
        # recompute barycentrics, depth-sort
        sel = torch.clamp(slots, min=0)
        bidx = torch.arange(G, device=dev)[:, None, None]
        rows = torch.where(live[..., None], g[bidx, sel], 0.)  # (G,pc,k,W)
        # sign(0) -> +1: dead slots have all-zero rows
        w0, w1, w2 = _bary(rows, x0, y0, eps_sel)
        depth = w0 * rows[..., 6] + w1 * rows[..., 7] + w2 * rows[..., 8]
        feats = (w0[..., None] * rows[..., 9:9 + D]
                 + w1[..., None] * rows[..., 9 + D:9 + 2 * D]
                 + w2[..., None] * rows[..., 9 + 2 * D:9 + 3 * D])
        feats = torch.where(live[..., None], feats, 0.)
        fid_k = torch.where(live, fid[bidx, sel], -1)
        out_d = torch.where(live, depth.detach(), float('-inf'))
        order = torch.argsort(-out_d, dim=-1, stable=True)
        fidx_out.append(torch.gather(fid_k, -1, order))
        feats_out.append(torch.gather(
            feats, -2, order[..., None].expand(feats.shape)))
    feats = torch.cat(feats_out).reshape(-1, knum, D)[:P]
    fidx = torch.cat(fidx_out).reshape(-1, knum)[:P]
    return feats, fidx


def _deftet_select(pixel_coords, render_ranges, face_vertices_z,
                   face_vertices_image, valid_faces, knum, eps,
                   pixel_chunk=4096):
    """First-knum covering faces per pixel (single mesh), mesh order.

    One ``topk`` over the keys ``F + 1 - fid`` of all covering faces per
    block of ``pixel_chunk`` pixels.

    Returns:
        (P, knum) int32 face ids (-1 pad).
    """
    F = face_vertices_z.shape[0]
    P = pixel_coords.shape[0]
    dev = face_vertices_z.device
    face_min = face_vertices_image.amin(dim=1)            # (F, 2)
    face_max = face_vertices_image.amax(dim=1)
    rows = face_vertices_image.reshape(1, F, 6)
    keys_cover = F + 1 - torch.arange(F, dtype=torch.int32, device=dev)
    out = torch.empty((P, knum), dtype=torch.int32, device=dev)
    for lo in range(0, P, pixel_chunk):
        x0 = pixel_coords[lo:lo + pixel_chunk, 0:1]       # (pc, 1)
        y0 = pixel_coords[lo:lo + pixel_chunk, 1:2]
        rr = render_ranges[lo:lo + pixel_chunk]
        in_bbox = ((x0 >= face_min[None, :, 0]) & (x0 < face_max[None, :, 0])
                   & (y0 >= face_min[None, :, 1])
                   & (y0 < face_max[None, :, 1])
                   & valid_faces[None, :])                 # (pc, F)
        w0, w1, w2 = _bary(rows, x0, y0, lambda n: eps * torch.sign(n))
        inside = (w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.)
        depth = (w0 * face_vertices_z[None, :, 0]
                 + w1 * face_vertices_z[None, :, 1]
                 + w2 * face_vertices_z[None, :, 2])
        covered = (in_bbox & inside & (depth > rr[:, 0:1])
                   & (depth < rr[:, 1:2]))
        keys = torch.where(covered, keys_cover, 0)
        best = torch.topk(keys, min(knum, F), dim=1).values
        if knum > F:
            best = F_.pad(best, (0, knum - F))
        out[lo:lo + pixel_chunk] = torch.where(best > 0, F + 1 - best, -1)
    return out


def _deftet_epilogue(kb, pc, fz, fi, ff, eps):
    """Differentiable epilogue of the default engine (single mesh)."""
    valid_k = kb >= 0
    sel = torch.clamp(kb, min=0).long()
    fv = fi[sel].reshape(sel.shape + (6,))                # (P, knum, 6)
    fzk = fz[sel]                                         # (P, knum, 3)
    ffk = ff[sel]                                         # (P, knum, 3, D)
    w0, w1, w2 = _bary(fv, pc[:, None, 0], pc[:, None, 1],
                       lambda n: eps * torch.sign(n))
    depth = w0 * fzk[..., 0] + w1 * fzk[..., 1] + w2 * fzk[..., 2]
    depth = torch.where(valid_k, depth, float('-inf'))
    # sort by depth descending (near-to-far; invalid -inf sinks last)
    order = torch.argsort(-depth.detach(), dim=-1, stable=True)
    kb_sorted = torch.gather(kb, -1, order)
    w = torch.stack([w0, w1, w2], dim=-1)
    w = torch.gather(w, 1, order[..., None].expand(w.shape))
    w = torch.where(torch.gather(valid_k, -1, order)[..., None], w, 0.)
    ffs = torch.gather(ffk, 1, order[..., None, None].expand(ffk.shape))
    return (w[..., None] * ffs).sum(dim=-2), kb_sorted    # (P, knum, D)


def deftet_sparse_render(pixel_coords, render_ranges, face_vertices_z,
                         face_vertices_image, face_features, knum=300,
                         valid_faces=None, eps=1e-8, max_candidates=None,
                         pixel_chunk=1024):
    """Render all intersections per pixel, depth-sorted (k-buffer).

    Args:
        pixel_coords: ``(B, P, 2)`` image coords (not differentiable).
        render_ranges: ``(B, P, 2)`` (min_depth, max_depth) per pixel;
            camera-space depths are negative (closer = higher).
        face_vertices_z: ``(B, F, 3)``.
        face_vertices_image: ``(B, F, 3, 2)``.
        face_features: ``(B, F, 3, D)`` or list of such.
        knum: max intersections kept per pixel.
        valid_faces: optional ``(B, F)`` bool mask of faces to render.
        eps: barycentric normalization epsilon.
        max_candidates: optional cap enabling the spatially binned engine
            (:func:`_deftet_render_binned`): per pixel chunk only face
            chunks whose bbox overlaps the chunk's pixel bbox are tested,
            capped at ``max_candidates`` faces (rounded up to 64).  The cap
            must cover the worst pixel chunk.
        pixel_chunk: pixels per processing chunk (binned engine).

    Returns:
        (interpolated_features ``(B, P, knum, D)`` [or list],
        sorted_face_idx ``(B, P, knum)`` with -1 padding).
    """
    is_list = isinstance(face_features, (list, tuple))
    features = (torch.cat(list(face_features), dim=-1) if is_list
                else face_features)
    B, F = face_vertices_z.shape[:2]
    valid = (torch.ones((B, F), dtype=torch.bool,
                        device=face_vertices_z.device)
             if valid_faces is None else
             torch.as_tensor(valid_faces, device=face_vertices_z.device)
             .bool())
    pixel_coords = pixel_coords.detach()
    if max_candidates is not None:
        outs = [_deftet_render_binned(
            pixel_coords[b], render_ranges[b], face_vertices_z[b],
            face_vertices_image[b], features[b], valid[b], knum=knum,
            eps=float(eps), max_candidates=int(max_candidates),
            pixel_chunk=int(pixel_chunk)) for b in range(B)]
    else:
        outs = []
        for b in range(B):
            kb = _deftet_select(
                pixel_coords[b], render_ranges[b].detach(),
                face_vertices_z[b].detach(),
                face_vertices_image[b].detach(), valid[b], knum=knum,
                eps=eps)
            outs.append(_deftet_epilogue(
                kb, pixel_coords[b], face_vertices_z[b],
                face_vertices_image[b], features[b], eps))
    feats = torch.stack([o[0] for o in outs])
    sorted_idx = torch.stack([o[1] for o in outs])
    if is_list:
        feats = _split_features(feats, face_features, False)
    return feats, sorted_idx


def _naive_deftet_sparse_render(pixel_coords, render_ranges,
                                face_vertices_z, face_vertices_image,
                                face_features, knum=300, valid_faces=None,
                                eps=1e-8):
    """Naive dense reference implementation of
    :func:`deftet_sparse_render`.

    Differences from :func:`deftet_sparse_render`: faces per pixel are the
    first ``knum`` by *depth* order (the k-buffer keeps the first ``knum``
    by mesh order), so results agree whenever ``knum`` covers all
    intersections; and the interpolation uses the k1/k2/k3 epilogue
    (``w0 = 1 - w1 - w2``).  Fully dense (P, F) math.
    """
    is_list = isinstance(face_features, (list, tuple))
    features = (torch.cat(list(face_features), dim=-1) if is_list
                else face_features)
    B = pixel_coords.shape[0]
    Fn = face_vertices_z.shape[1]
    if valid_faces is None:
        valid_faces = torch.ones((B, Fn), dtype=torch.bool,
                                 device=face_vertices_z.device)
    pixel_coords = pixel_coords.detach()

    def one_batch(pc, rr, fz, fi, ff, valid):
        x0 = pc[:, 0:1]
        y0 = pc[:, 1:2]
        fmin = fi.amin(dim=1)
        fmax = fi.amax(dim=1)
        in_bbox = ((x0 >= fmin[None, :, 0]) & (x0 < fmax[None, :, 0])
                   & (y0 >= fmin[None, :, 1]) & (y0 < fmax[None, :, 1])
                   & valid[None, :])
        ax, ay = fi[:, 0, 0], fi[:, 0, 1]
        bx, by = fi[:, 1, 0], fi[:, 1, 1]
        cx, cy = fi[:, 2, 0], fi[:, 2, 1]
        w0n, w1n, w2n = _bary(fi.reshape(1, -1, 6), x0, y0,
                              lambda n: eps * torch.sign(n))
        inside = (w0n >= 0.) & (w1n >= 0.) & (w2n >= 0.)
        depth = (w0n * fz[None, :, 0] + w1n * fz[None, :, 1]
                 + w2n * fz[None, :, 2])
        covered = (in_bbox & inside
                   & (depth > rr[:, 0:1]) & (depth < rr[:, 1:2]))
        # first knum by depth (descending = near-to-far), tie -> face id
        key = torch.where(covered, depth, float('-inf'))
        if knum > key.shape[-1]:
            key = F_.pad(key, (0, knum - key.shape[-1]),
                         value=float('-inf'))
            covered = F_.pad(covered, (0, knum - covered.shape[-1]))
        order = torch.argsort(-key.detach(), dim=-1, stable=True)[:, :knum]
        sel_valid = torch.gather(covered, -1, order)
        order = torch.clamp(order, max=fz.shape[0] - 1)
        fidx = torch.where(sel_valid, order, -1)

        # k1/k2/k3 epilogue, w0 = 1 - w1 - w2
        sel = torch.clamp(fidx, min=0)
        _m = (bx - ax)[sel]
        _p = (by - ay)[sel]
        _n = (cx - ax)[sel]
        _q = (cy - ay)[sel]
        _k3 = torch.where(sel_valid, _m * _q - _n * _p, 1.)
        _ax = torch.where(sel_valid, ax[sel], 0.)
        _ay = torch.where(sel_valid, ay[sel], 0.)
        _s = pc[:, 0:1] - _ax
        _t = pc[:, 1:2] - _ay
        _k1 = _s * _q - _n * _t
        _k2 = _m * _t - _s * _p
        norm_eps = eps * torch.sign(_k3)
        w1k = _k1 / (_k3 + norm_eps)
        w2k = _k2 / (_k3 + norm_eps)
        w0k = 1. - w1k - w2k
        w = torch.stack([w0k, w1k, w2k], dim=-1)
        w = torch.where(sel_valid[..., None], w, 0.)
        ffk = torch.where(sel_valid[..., None, None], ff[sel], 0.)
        return (ffk * w[..., None]).sum(dim=-2), fidx.to(torch.int32)

    outs = [one_batch(pixel_coords[b], render_ranges[b], face_vertices_z[b],
                      face_vertices_image[b], features[b], valid_faces[b])
            for b in range(B)]
    feats = torch.stack([o[0] for o in outs])
    fidx = torch.stack([o[1] for o in outs])
    if is_list:
        feats = _split_features(feats, face_features, True)
    return feats, fidx
