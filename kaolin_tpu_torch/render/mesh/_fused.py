"""Fused tile-binned DIB-R engine (CUDA kernels for Hopper).

Port of ``kaolin_tpu/render/mesh/_fused.py``.  The engine and its tile
geometry are the JAX package's, so every intermediate can be compared one
to one with it:

1. :func:`build_face_tiles` (plain PyTorch): faces are sorted by the pixel
   tile (``PS`` rows x ``TW`` columns) that holds the centre of their
   enlarged bbox, padded to chunks of ``FC`` faces, and turned into a
   ``(FC, _NCOL)`` table of affine per-face columns.  Each tile gets the
   range ``[lo, hi)`` of chunks whose bbox overlaps it and each chunk the
   range of tiles it overlaps; an exact chunk-bbox test skips the rest.
2. Forward kernel (``csrc/dibr_fused.cu``, ``fused_forward_kernel``): per
   pixel, the z-buffer winner among covering valid faces and the soft-mask
   product ``prod(1 - p)`` over all faces whose enlarged bbox holds it.  One
   block per 16 x 16 sub-tile culls its tiles' chunk ranges to the faces
   whose enlarged bbox meets it, then runs one pixel per thread over them.
3. Backward kernel (``fused_backward_kernel``): the soft-mask gradient with
   respect to the scaled image-space vertices, with the CUDA
   product-division rule ``dL/dp_k = g * prod / (1 - p_k + 1e-7)``.  A
   first pass marks the units (a tile's blocks of 8 rows x 32 or 16
   columns) that hold a pixel with ``g * prod != 0``; each 64-face chunk
   owns its output rows and deals its marked units, in order, to
   ``_BWD_SLICES`` blocks, which write partial sums to a scratch buffer; a
   last pass adds them in slice order, so there are no atomics.

Each kernel has a plain PyTorch version of the same function beside it
(:func:`_fused_forward_torch`, :func:`_fused_backward_torch`) that honours
the same chunk ranges and bbox skip.  The wrappers :func:`_fused_forward`
and :func:`_fused_backward` run the plain version for tensors on the CPU
and the kernel for tensors on a CUDA device; there is no fallback between
the two.  A kernel is launched through the extension module
``csrc/dibr_fused_module.cpp``, which tests the inputs, allocates the
outputs and launches in C++ on the stream it is given.  ``LAUNCHES`` counts
kernel launches: a wrapper adds one where it launches, and a replayed CUDA
graph adds what it holds (``models/inverse_render.py::compiled_step``).
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ['FusedSelection', 'fused_selection', 'softmask_fused',
           'build_face_tiles', 'LAUNCHES']

_EPS = 1e-7        # product-division epsilon of the soft-mask backward
PS = 8             # pixel tile rows
FC = 64            # faces per chunk
_SUB = 16          # side of the forward kernel's sub-tiles

# vt column layout of the (FC, _NCOL) per-chunk face table
_W0 = 0            # w0 affine: c, cx, cy            (edge function 0)
_W1 = 3
_W2 = 6
_NRM = 9           # norm = w0+w1+w2 affine
_ZU = 12           # z numerator affine
_VALID = 15
_VX = 16           # x1,y1,x2,y2,x3,y3 image verts
_BB = 22           # enlarged bbox: xlo, ylo, xhi, yhi
_ED = 26           # per edge e: A, B, C, inv(A^2+B^2+EPS) at 26+4e
_NCOL = 40         # 38 used, padded to a multiple of 8

# elements per intermediate in one block of the plain versions
_PLAIN_BLOCK = 1 << 22
# blocks per chunk of the backward kernel (partial sums, added in order)
_BWD_SLICES = 8

LAUNCHES = {'fwd': 0, 'bwd': 0}


class FusedSelection(NamedTuple):
    """Selection-pass outputs + residuals for the soft-mask backward."""
    face_idx: torch.Tensor       # (B, H, W) int32, original face ids, -1 empty
    prod: torch.Tensor           # (B, H, W) f32 prod(1-p) over covering faces
    vt: torch.Tensor             # (B, nC, FC, NCOL) sorted face columns
    chunk_tranges: torch.Tensor  # (B, nC, 2) int32 tile range per chunk
    chunk_bbox: torch.Tensor     # (B, nC, 4) f32 chunk bbox (union of faces)
    inv_perm: torch.Tensor       # (B, F) sorted position of each original face


def _pixel_affine(height, width, multiplier):
    """x0 = ax*wi + bx, y0 = ay*hi + by (pixel centres, scaled)."""
    ax = 2. * multiplier / width
    bx = multiplier * (1. - width) / width
    ay = -2. * multiplier / height
    by = multiplier * (height - 1.) / height
    return ax, bx, ay, by


def _padded_dims(height, width):
    """Tile-aligned padded image dims; extra pixels computed then cropped."""
    hp = -(-height // PS) * PS
    if width > 128:
        wp = -(-width // 128) * 128
    else:
        wp = -(-width // 16) * 16
    return hp, wp


def _tile_dims(hp, wp):
    tw = min(128, wp)
    return hp // PS, wp // tw, tw


def _ranges(mask, n):
    """[lo, hi) covering the True entries of each row of mask (..., n)."""
    idx = torch.arange(n, dtype=torch.int32, device=mask.device)
    lo = torch.where(mask, idx, n).amin(dim=-1)
    hi = torch.where(mask, idx + 1, 0).amax(dim=-1)
    return torch.stack([torch.minimum(lo, hi), hi], dim=-1).int()


def build_face_tiles(face_vertices_z, fvi_scaled, valid_faces, height,
                     width, multiplier, margin):
    """Sort faces spatially, build per-face columns + tile/chunk ranges.

    Batched form of the JAX function (which is vmapped there): fvz
    ``(B, F, 3)``, fvi_scaled ``(B, F, 3, 2)``, valid ``(B, F)``.

    Returns:
        (vt (B, nC, FC, NCOL), tile_ranges (B, T, 2) int32,
        chunk_tranges (B, nC, 2) int32, chunk_bbox (B, nC, 4),
        perm (B, F) int64, inv_perm (B, F) int64).
    """
    B, F_ = face_vertices_z.shape[:2]
    device = fvi_scaled.device
    hp, wp = _padded_dims(height, width)
    nI, nJ, TW = _tile_dims(hp, wp)
    T = nI * nJ
    axp, bxp, ayp, byp = _pixel_affine(height, width, multiplier)
    dtype = fvi_scaled.dtype

    mn = fvi_scaled.amin(dim=-2) - margin    # (B, F, 2) enlarged bbox
    mx = fvi_scaled.amax(dim=-2) + margin

    # ---- spatial sort by tile of bbox center ----------------------------
    # .int() truncates toward zero and // floors, as astype + // do in JAX
    cx = (mn[..., 0] + mx[..., 0]) * 0.5
    cy = (mn[..., 1] + mx[..., 1]) * 0.5
    wi_c = (cx - bxp) / axp
    hi_c = (cy - byp) / ayp
    tx = torch.clamp(wi_c.int() // TW, 0, nJ - 1)
    ty = torch.clamp(hi_c.int() // PS, 0, nI - 1)
    perm = torch.argsort(ty * nJ + tx, dim=-1, stable=True)
    inv_perm = torch.argsort(perm, dim=-1)

    fpad = (-F_) % FC
    Fp = F_ + fpad
    nC = Fp // FC
    bidx = torch.arange(B, device=device)[:, None]

    def sort_pad(a, fill=0.):
        a = a[bidx, perm]
        tail = a.new_full((B, fpad) + tuple(a.shape[2:]), fill)
        return torch.cat([a, tail], dim=1)

    fvz = sort_pad(face_vertices_z)
    fvi = sort_pad(fvi_scaled)
    valid = sort_pad(valid_faces.to(dtype))
    # padded faces: bbox that never covers and never overlaps a tile
    mn = sort_pad(mn, fill=2. * float(multiplier))
    mx = sort_pad(mx, fill=-2. * float(multiplier))

    ax_, ay_ = fvi[..., 0, 0], fvi[..., 0, 1]
    bx_, by_ = fvi[..., 1, 0], fvi[..., 1, 1]
    cx_, cy_ = fvi[..., 2, 0], fvi[..., 2, 1]
    za, zb, zc = fvz[..., 0], fvz[..., 1], fvz[..., 2]

    cols = [None] * _NCOL
    # edge-function affine coefficients (value, d/dx0, d/dy0)
    cols[_W0:_W0 + 3] = [bx_ * cy_ - by_ * cx_, by_ - cy_, cx_ - bx_]
    cols[_W1:_W1 + 3] = [cx_ * ay_ - cy_ * ax_, cy_ - ay_, ax_ - cx_]
    cols[_W2:_W2 + 3] = [ax_ * by_ - ay_ * bx_, ay_ - by_, bx_ - ax_]
    for k in range(3):
        cols[_NRM + k] = (cols[_W0 + k] + cols[_W1 + k] + cols[_W2 + k])
        cols[_ZU + k] = (cols[_W0 + k] * za + cols[_W1 + k] * zb
                         + cols[_W2 + k] * zc)
    cols[_VALID] = valid
    cols[_VX:_VX + 6] = [ax_, ay_, bx_, by_, cx_, cy_]
    cols[_BB:_BB + 4] = [mn[..., 0], mn[..., 1], mx[..., 0], mx[..., 1]]
    vx = [ax_, ay_, bx_, by_, cx_, cy_]
    for e in range(3):
        x1, y1 = vx[2 * e], vx[2 * e + 1]
        x2 = vx[2 * ((e + 1) % 3)]
        y2 = vx[2 * ((e + 1) % 3) + 1]
        A = y2 - y1
        Bc = x1 - x2
        Cc = x2 * y1 - x1 * y2
        cols[_ED + 4 * e:_ED + 4 * e + 4] = [
            A, Bc, Cc, 1. / (A * A + Bc * Bc + _EPS)]
    zero = torch.zeros((B, Fp), dtype=dtype, device=device)
    cols = [zero if c is None else c for c in cols]
    vt = torch.stack(cols, dim=-1).reshape(B, nC, FC, _NCOL)

    # ---- chunk bboxes + tile <-> chunk overlap ranges --------------------
    cmn = mn.reshape(B, nC, FC, 2).amin(dim=2)               # (B, nC, 2)
    cmx = mx.reshape(B, nC, FC, 2).amax(dim=2)
    chunk_bbox = torch.cat([cmn, cmx], dim=-1)               # (B, nC, 4)

    # tile pixel-coordinate ranges (x increases with wi, y decreases w/ hi)
    t_xlo, t_xhi, t_ylo, t_yhi = _tile_bounds(
        torch.arange(nJ, dtype=dtype, device=device),
        torch.arange(nI, dtype=dtype, device=device),
        TW, axp, bxp, ayp, byp)
    ov_x = ((cmn[:, None, :, 0] <= t_xhi[None, :, None])
            & (cmx[:, None, :, 0] >= t_xlo[None, :, None]))  # (B, nJ, nC)
    ov_y = ((cmn[:, None, :, 1] <= t_yhi[None, :, None])
            & (cmx[:, None, :, 1] >= t_ylo[None, :, None]))  # (B, nI, nC)
    ov = (ov_y[:, :, None, :] & ov_x[:, None, :, :]).reshape(B, T, nC)

    tile_ranges = _ranges(ov, nC)                            # (B, T, 2)
    chunk_tranges = _ranges(ov.transpose(1, 2), T)           # (B, nC, 2)
    return vt, tile_ranges, chunk_tranges, chunk_bbox, perm, inv_perm


def _tile_bounds(j, i, TW, axp, bxp, ayp, byp):
    """Pixel-coordinate bounds of tile column(s) j and tile row(s) i.

    ``ayp < 0``, so a tile's first pixel row has its largest y.
    """
    t_xlo = axp * (j * TW) + bxp
    t_xhi = axp * (j * TW + TW - 1) + bxp
    t_yhi = ayp * (i * PS) + byp
    t_ylo = ayp * (i * PS + PS - 1) + byp
    return t_xlo, t_xhi, t_ylo, t_yhi


def _tile_pixels(height, width, multiplier, device):
    """Pixel centres of every tile, x0 and y0 (T, P), and tile bounds."""
    hp, wp = _padded_dims(height, width)
    nI, nJ, TW = _tile_dims(hp, wp)
    axp, bxp, ayp, byp = _pixel_affine(height, width, multiplier)
    t = torch.arange(nI * nJ, device=device)
    lane = torch.arange(PS * TW, device=device)
    i = (t // nJ)[:, None]
    j = (t % nJ)[:, None]
    wi = (j * TW + lane % TW).float()
    hi = (i * PS + lane // TW).float()
    x0 = axp * wi + bxp
    y0 = ayp * hi + byp
    bounds = _tile_bounds((t % nJ).float(), (t // nJ).float(), TW,
                          axp, bxp, ayp, byp)
    return x0, y0, bounds


def _chunk_hits_tile(chunk_bbox, bounds):
    """Exact chunk-bbox vs tile-bounds test: (nC, 4), 4 x (T,) -> (T, nC)."""
    t_xlo, t_xhi, t_ylo, t_yhi = (v[:, None] for v in bounds)
    return ((chunk_bbox[None, :, 0] <= t_xhi)
            & (chunk_bbox[None, :, 2] >= t_xlo)
            & (chunk_bbox[None, :, 1] <= t_yhi)
            & (chunk_bbox[None, :, 3] >= t_ylo))


def _active_list(active):
    """Ascending column ids of the True entries of each row, padded.

    active (M, n) bool -> (ids (M, K) long, valid (M, K) bool), K = the
    largest row count.
    """
    n = active.shape[1]
    idx = torch.arange(n, device=active.device)
    K = int(active.sum(dim=1).max()) if active.numel() else 0
    order = torch.sort(torch.where(active, idx, n + idx), dim=1).values
    order = order[:, :K]
    ok = order < n
    return torch.where(ok, order, 0), ok


def _in_bbox(col, x0, y0):
    return ((x0 >= col(_BB)) & (x0 < col(_BB + 2))
            & (y0 >= col(_BB + 1)) & (y0 < col(_BB + 3)))


def _distance_candidates(col, x0, y0, sentinel):
    """The 6 squared-distance candidates of pixel(s) to face(s).

    Edges e = 0..2 (``sentinel`` where the perpendicular foot falls off the
    segment), then vertices.  Returns (d = their min, per-edge
    (up, perp, direct, candidate), per-vertex candidates).
    """
    edges = []
    d = None
    for e in range(3):
        A = col(_ED + 4 * e)
        Bc = col(_ED + 4 * e + 1)
        Cc = col(_ED + 4 * e + 2)
        idn = col(_ED + 4 * e + 3)
        up = A * x0 + Bc * y0 + Cc
        t_ = up * idn
        x3 = x0 - A * t_
        y3 = y0 - Bc * t_
        x1 = col(_VX + 2 * e)
        y1 = col(_VX + 2 * e + 1)
        x2 = col(_VX + 2 * ((e + 1) % 3))
        y2 = col(_VX + 2 * ((e + 1) % 3) + 1)
        direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2)
        perp = up * up * idn
        de = torch.where(direct > 0., sentinel, perp)
        edges.append((up, perp, direct, de))
        d = de if d is None else torch.minimum(d, de)
    verts = []
    for v in range(3):
        dv = (x0 - col(_VX + 2 * v)) ** 2 + (y0 - col(_VX + 2 * v + 1)) ** 2
        verts.append(dv)
        d = torch.minimum(d, dv)
    return d, edges, verts


# ---------------------------------------------------------------------------
# forward: z-buffer winner + soft-mask product per pixel

def _fused_forward_torch(vt, tile_ranges, chunk_bbox, height, width,
                         multiplier, eps, sigmainv, with_softmask):
    """Plain PyTorch version of the forward kernel (same arguments).

    Dense over (pixels x faces of the chunks a tile visits), in blocks of
    tiles.  The winner is the largest z; on a tie the lowest sorted id wins,
    as in the kernel's ascending walk with a strict ``>``.

    Returns (face_idx_sorted (B, H, W) int32, prod (B, H, W) f32).
    """
    B, nC = vt.shape[:2]
    device = vt.device
    x0_all, y0_all, bounds = _tile_pixels(height, width, multiplier, device)
    T, P = x0_all.shape
    inv_sigma = float(sigmainv) / float(multiplier) ** 2
    sentinel = 4. * float(multiplier) ** 2
    fid_t = torch.full((B, T, P), -1, dtype=torch.int32, device=device)
    prod_t = torch.ones((B, T, P), dtype=torch.float32, device=device)
    cidx = torch.arange(nC, device=device)
    frow = torch.arange(FC, device=device)
    for b in range(B):
        lo, hi = tile_ranges[b, :, 0:1], tile_ranges[b, :, 1:2]
        active = (_chunk_hits_tile(chunk_bbox[b], bounds)
                  & (cidx >= lo) & (cidx < hi))               # (T, nC)
        cid, ok = _active_list(active)                        # (T, K)
        K = cid.shape[1]
        if K == 0:
            continue
        tb = max(1, _PLAIN_BLOCK // (K * FC * P))
        for t0 in range(0, T, tb):
            sl = slice(t0, t0 + tb)
            n = cid[sl].shape[0]
            cols = vt[b][cid[sl]].reshape(n, K * FC, _NCOL)
            fmask = ok[sl].repeat_interleave(FC, dim=1)[..., None]
            sid = (cid[sl][..., None] * FC + frow).reshape(n, K * FC)
            x0 = x0_all[sl][:, None, :]                       # (n, 1, P)
            y0 = y0_all[sl][:, None, :]

            def col(c):
                return cols[:, :, c:c + 1]                    # (n, KF, 1)

            def affine(c):
                return col(c) + col(c + 1) * x0 + col(c + 2) * y0

            w0 = affine(_W0)
            w1 = affine(_W1)
            w2 = affine(_W2)
            nrm = affine(_NRM)
            zu = affine(_ZU)
            s = nrm + torch.where(nrm >= 0., eps, -eps)
            cov = ((w0 * s >= 0.) & (w1 * s >= 0.) & (w2 * s >= 0.)
                   & (col(_VALID) > 0.) & fmask)
            z = torch.where(cov, zu / s, -torch.inf)
            zc, arg = torch.max(z, dim=1)                     # first max
            fid_t[b, sl] = torch.where(
                zc > -torch.inf, torch.gather(sid, 1, arg), -1).int()
            if with_softmask:
                d, _, _ = _distance_candidates(col, x0, y0, sentinel)
                p = torch.where(_in_bbox(col, x0, y0) & fmask,
                                torch.exp(-inv_sigma * d), 0.)
                prod_t[b, sl] = torch.prod(1. - p, dim=1)
    return _untile(fid_t, height, width), _untile(prod_t, height, width)


def _check(name, t, dtype, shape, device):
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f'{name}: expected a contiguous {dtype} tensor of shape {shape} '
            f'on {device}, got {t.dtype} {tuple(t.shape)} on {t.device} '
            f'(contiguous={t.is_contiguous()})')


_ext = _stream = None       # the extension module, the stream getter


def _bind():
    global _ext, _stream
    if _ext is None:
        from kaolin_tpu_torch import _cuda
        _stream = _cuda.stream_getter()
        _ext = _cuda.load_module('dibr_fused')
    return _ext


def _refused(tests):
    """Raise for inputs the extension refused: the first of ``tests``
    ((name, tensor, dtype, shape, device)) that fails :func:`_check`, else
    the size the kernels index with ints."""
    for test in tests:
        _check(*test)
    raise ValueError('fused kernels index with ints: every input and output '
                     'must hold fewer than 2^31 elements')


def _fused_forward_cuda(vt, tile_ranges, chunk_bbox, height, width,
                        multiplier, eps, sigmainv, with_softmask):
    """Launch the forward kernel; same contract as the plain version."""
    nI, nJ, TW = _tile_dims(*_padded_dims(height, width))
    out = (_ext or _bind()).forward(
        vt, tile_ranges, chunk_bbox, height, width, nI * nJ, nJ, TW,
        *_pixel_affine(height, width, multiplier), float(eps),
        float(sigmainv) / float(multiplier) ** 2, 4. * float(multiplier) ** 2,
        int(bool(with_softmask)), _stream(vt.get_device()))
    if out is None:
        B, nC = vt.shape[:2]
        _refused((('vt', vt, torch.float32, (B, nC, FC, _NCOL), vt.device),
                  ('tile_ranges', tile_ranges, torch.int32, (B, nI * nJ, 2),
                   vt.device),
                  ('chunk_bbox', chunk_bbox, torch.float32, (B, nC, 4),
                   vt.device)))
    LAUNCHES['fwd'] += 1
    return out


def _fused_forward(vt, tile_ranges, chunk_bbox, height, width, multiplier,
                   eps, sigmainv, with_softmask):
    """Batched fused forward.  vt (B, nC, FC, NCOL) etc (sorted space).

    CPU tensors run :func:`_fused_forward_torch`; CUDA tensors launch the
    kernel.  Returns (face_idx_sorted (B, H, W) int32, prod (B, H, W) f32).
    """
    if vt.device.type == 'cpu':
        return _fused_forward_torch(vt, tile_ranges, chunk_bbox, height,
                                    width, multiplier, eps, sigmainv,
                                    with_softmask)
    if vt.device.type != 'cuda':
        raise ValueError(f'no fused forward for device {vt.device}')
    return _fused_forward_cuda(vt, tile_ranges, chunk_bbox, height, width,
                               multiplier, eps, sigmainv, with_softmask)


# ---------------------------------------------------------------------------
# backward: soft-mask gradient w.r.t. image-space vertices

def _fused_backward_torch(vt, chunk_tranges, chunk_bbox, g_prod, height,
                          width, multiplier, sigmainv):
    """Plain PyTorch version of the backward kernel (same arguments).

    g_prod: (B, H, W) = g * prod on empty pixels, 0 elsewhere.  Dense over
    (faces of a chunk x pixels of the tiles it visits), in blocks of
    chunks.  Each (face, pixel) gradient goes to the argmin candidate only:
    edges before vertices, the first ``== d`` wins, and an edge adds only
    where its foot lies on the segment.

    Returns (B, nC*FC, 6) gradients in sorted face order.
    """
    B, nC = vt.shape[:2]
    device = vt.device
    x0_all, y0_all, bounds = _tile_pixels(height, width, multiplier, device)
    T, P = x0_all.shape
    g_t = _tile_image(g_prod.float(), height, width)          # (B, T, P)
    inv_sigma = float(sigmainv) / float(multiplier) ** 2
    sentinel = 4. * float(multiplier) ** 2
    out = torch.zeros((B, nC, FC, 6), dtype=torch.float32, device=device)
    tidx = torch.arange(T, device=device)
    for b in range(B):
        lo, hi = chunk_tranges[b, :, 0:1], chunk_tranges[b, :, 1:2]
        active = (_chunk_hits_tile(chunk_bbox[b], bounds).T
                  & (tidx >= lo) & (tidx < hi))               # (nC, T)
        tid, ok = _active_list(active)                        # (nC, K)
        K = tid.shape[1]
        if K == 0:
            continue
        cb = max(1, _PLAIN_BLOCK // (FC * K * P))
        for c0 in range(0, nC, cb):
            sl = slice(c0, c0 + cb)
            n = tid[sl].shape[0]
            cols = vt[b, sl]                                  # (n, FC, NCOL)
            x0 = x0_all[tid[sl]].reshape(n, 1, K * P)
            y0 = y0_all[tid[sl]].reshape(n, 1, K * P)
            gt = torch.where(ok[sl][..., None], g_t[b][tid[sl]], 0.)
            gt = gt.reshape(n, 1, K * P)

            def col(c):
                return cols[:, :, c:c + 1]                    # (n, FC, 1)

            d, edges, verts = _distance_candidates(col, x0, y0, sentinel)
            p = torch.where(_in_bbox(col, x0, y0),
                            torch.exp(-inv_sigma * d), 0.)
            dd = (-inv_sigma) * p * gt / (1. - p + _EPS)      # (n, FC, KP)

            remaining = torch.ones_like(dd, dtype=torch.bool)
            comp = [0.] * 6
            for e in range(3):
                up, perp, direct, de = edges[e]
                sel = remaining & (de == d)
                remaining = remaining & ~sel
                w = torch.where(sel & (direct <= 0.), dd, 0.)
                A = col(_ED + 4 * e)
                Bc = col(_ED + 4 * e + 1)
                idn = col(_ED + 4 * e + 3)
                dA = 2. * (up * x0 - perp * A) * idn
                dB = 2. * (up * y0 - perp * Bc) * idn
                dC = 2. * up * idn
                jj = (e + 1) % 3
                x1, y1 = col(_VX + 2 * e), col(_VX + 2 * e + 1)
                x2, y2 = col(_VX + 2 * jj), col(_VX + 2 * jj + 1)
                comp[2 * e] = comp[2 * e] + w * (dB - dC * y2)
                comp[2 * e + 1] = comp[2 * e + 1] + w * (dC * x2 - dA)
                comp[2 * jj] = comp[2 * jj] + w * (dC * y1 - dB)
                comp[2 * jj + 1] = comp[2 * jj + 1] + w * (dA - dC * x1)
            for v in range(3):
                sel = remaining & (verts[v] == d)
                remaining = remaining & ~sel
                w = torch.where(sel, dd, 0.)
                comp[2 * v] = comp[2 * v] + w * 2. * (col(_VX + 2 * v) - x0)
                comp[2 * v + 1] = (comp[2 * v + 1]
                                   + w * 2. * (col(_VX + 2 * v + 1) - y0))
            out[b, sl] = torch.stack([c.sum(dim=-1) for c in comp], dim=-1)
    return out.reshape(B, nC * FC, 6)


def _fused_backward_cuda(vt, chunk_tranges, chunk_bbox, g_prod, height,
                         width, multiplier, sigmainv):
    """Launch the backward kernel; same contract as the plain version."""
    nI, nJ, TW = _tile_dims(*_padded_dims(height, width))
    out = (_ext or _bind()).backward(
        vt, chunk_tranges, chunk_bbox, g_prod, height, width, nI * nJ, nJ, TW,
        _BWD_SLICES, nI * nJ * (TW // _unit_width(TW)),
        *_pixel_affine(height, width, multiplier),
        float(sigmainv) / float(multiplier) ** 2, 4. * float(multiplier) ** 2,
        _stream(vt.get_device()))
    if out is None:
        B, nC = vt.shape[:2]
        _refused((('vt', vt, torch.float32, (B, nC, FC, _NCOL), vt.device),
                  ('chunk_tranges', chunk_tranges, torch.int32, (B, nC, 2),
                   vt.device),
                  ('chunk_bbox', chunk_bbox, torch.float32, (B, nC, 4),
                   vt.device),
                  ('g_prod', g_prod, torch.float32, (B, height, width),
                   vt.device)))
    LAUNCHES['bwd'] += 1
    return out


def _fused_backward(vt, chunk_tranges, chunk_bbox, g_prod, height, width,
                    multiplier, sigmainv):
    """Batched soft-mask backward.  Returns (B, nC*FC, 6) sorted grads.

    CPU tensors run :func:`_fused_backward_torch`; CUDA tensors launch the
    kernel.
    """
    if vt.device.type == 'cpu':
        return _fused_backward_torch(vt, chunk_tranges, chunk_bbox, g_prod,
                                     height, width, multiplier, sigmainv)
    if vt.device.type != 'cuda':
        raise ValueError(f'no fused backward for device {vt.device}')
    return _fused_backward_cuda(vt, chunk_tranges, chunk_bbox, g_prod,
                                height, width, multiplier, sigmainv)


def _unit_width(TW):
    """Columns of the backward kernel's units (blocks of PS rows)."""
    return 32 if TW % 32 == 0 else 16


def _tile_image(img, height, width):
    """(B, H, W) -> (B, T, PS*TW) in tile layout, zero padded."""
    B = img.shape[0]
    hp, wp = _padded_dims(height, width)
    nI, nJ, TW = _tile_dims(hp, wp)
    img = F.pad(img, (0, wp - width, 0, hp - height))
    img = img.reshape(B, nI, PS, nJ, TW).permute(0, 1, 3, 2, 4)
    return img.reshape(B, nI * nJ, PS * TW)


def _untile(img, height, width):
    """(B, T, PS*TW) tile layout -> (B, H, W), padding cropped."""
    B = img.shape[0]
    hp, wp = _padded_dims(height, width)
    nI, nJ, TW = _tile_dims(hp, wp)
    img = img.reshape(B, nI, nJ, PS, TW).permute(0, 1, 3, 2, 4)
    return img.reshape(B, hp, wp)[:, :height, :width]


# ---------------------------------------------------------------------------
# the kernels' culling rules in plain PyTorch (for tests and work counts)

def _pixel_bounds(r0, c0, rows, cols, axp, bxp, ayp, byp):
    """Pixel-centre bounds (xlo, xhi, ylo, yhi) of the blocks of ``rows`` x
    ``cols`` pixels at rows r0 and columns c0 (int tensors)."""
    return (axp * c0.float() + bxp, axp * (c0 + cols - 1).float() + bxp,
            ayp * (r0 + rows - 1).float() + byp, ayp * r0.float() + byp)


def _box_hits(box, xlo, xhi, ylo, yhi):
    """Closed test of boxes (..., 4) = (xlo, ylo, xhi, yhi) against bounds."""
    return ((box[..., 0] <= xhi) & (box[..., 2] >= xlo)
            & (box[..., 1] <= yhi) & (box[..., 3] >= ylo))


def _cull_forward(vt, tile_ranges, chunk_bbox, height, width, multiplier):
    """The face lists of the forward kernel's sub-tiles.

    Sub-tile s (row-major over ``_SUB`` x ``_SUB`` blocks of the padded
    image) walks the union of the chunk ranges of the tile rows it spans,
    keeps the chunks whose bbox meets its pixel-centre bounds and, of
    those, the faces whose enlarged bbox does (closed tests).

    Returns (B, nS, nC*FC) bool: True where sorted face f is in the list
    of sub-tile s.
    """
    B, nC = vt.shape[:2]
    device = vt.device
    hp, wp = _padded_dims(height, width)
    nI, nJ, TW = _tile_dims(hp, wp)
    nSI, nSJ = -(-hp // _SUB), wp // _SUB
    axp, bxp, ayp, byp = _pixel_affine(height, width, multiplier)
    r0 = torch.arange(nSI, device=device).repeat_interleave(nSJ) * _SUB
    c0 = torch.arange(nSJ, device=device).repeat(nSI) * _SUB
    xlo, xhi, ylo, yhi = (v[None, :, None] for v in _pixel_bounds(
        r0, c0, _SUB, _SUB, axp, bxp, ayp, byp))
    lo = torch.zeros((B, nSI * nSJ), dtype=torch.int32, device=device)
    hi = torch.zeros_like(lo)
    for k in range(_SUB // PS):                   # the tile rows spanned
        ti = r0 // PS + k
        r = tile_ranges[:, (ti.clamp(max=nI - 1) * nJ + c0 // TW)]
        use = (ti < nI) & (r[..., 0] < r[..., 1])
        lo = torch.where(use & (lo < hi), torch.minimum(lo, r[..., 0]),
                         torch.where(use, r[..., 0], lo))
        hi = torch.where(use, torch.maximum(hi, r[..., 1]), hi)
    cidx = torch.arange(nC, device=device)
    chunks = ((cidx >= lo[..., None]) & (cidx < hi[..., None])
              & _box_hits(chunk_bbox[:, None], xlo, xhi, ylo, yhi))
    faces = _box_hits(vt[:, None, :, :, _BB:_BB + 4], xlo[..., None],
                      xhi[..., None], ylo[..., None], yhi[..., None])
    return (chunks[..., None] & faces).reshape(B, nSI * nSJ, nC * FC)


def _cull_backward(chunk_tranges, chunk_bbox, g_prod, height, width,
                   multiplier):
    """The units of the backward kernel's chunks.

    A unit is a tile's 8 x SW block of pixels (SW = 32 where the tile
    width allows it, else 16), numbered ``t * (TW // SW) + k``.  A chunk
    visits the units of the tiles in its range whose pixel-centre bounds
    its bbox meets; it computes on those with a pixel where g*prod != 0,
    the i-th of them in slice ``i % _BWD_SLICES``.

    Returns (visited (B, nC, U) bool, computed (B, nC, U) bool,
    nonzero (B, U) bool: units holding a pixel with g*prod != 0).
    """
    B, nC = chunk_bbox.shape[:2]
    device = chunk_bbox.device
    hp, wp = _padded_dims(height, width)
    nI, nJ, TW = _tile_dims(hp, wp)
    sw = _unit_width(TW)
    nsub = TW // sw
    U = nI * nJ * nsub
    axp, bxp, ayp, byp = _pixel_affine(height, width, multiplier)
    u = torch.arange(U, device=device)
    t = u // nsub
    r0 = (t // nJ) * PS
    c0 = (t % nJ) * TW + (u % nsub) * sw
    bounds = _pixel_bounds(r0, c0, PS, sw, axp, bxp, ayp, byp)
    visited = (_box_hits(chunk_bbox[:, :, None], *bounds)
               & (t >= chunk_tranges[..., :1]) & (t < chunk_tranges[..., 1:]))
    g = F.pad(g_prod != 0, (0, wp - width, 0, hp - height))
    nonzero = g.reshape(B, nI, PS, nJ, nsub, sw).any(dim=5).any(dim=2)
    nonzero = nonzero.reshape(B, U)
    return visited, visited & nonzero[:, None], nonzero


# ---------------------------------------------------------------------------
# public API

def fused_selection(face_vertices_z, face_vertices_image, valid_faces=None,
                    height=256, width=256, multiplier=1000., boxlen=0.02,
                    sigmainv=7000., eps=1e-8, with_softmask=True):
    """Fused z-buffer + soft-mask selection pass (non-differentiable).

    Args:
        face_vertices_z: (B, F, 3) camera-space z.
        face_vertices_image: (B, F, 3, 2) image coords in [-1, 1].
        valid_faces: (B, F) bool (z-buffer only; the soft mask uses all
            faces).

    Returns:
        :class:`FusedSelection` — feed to :func:`softmask_fused` for the
        differentiable mask and to ``rasterize(precomputed_face_idx=...)``
        for feature interpolation.
    """
    B, F_ = face_vertices_z.shape[:2]
    device = face_vertices_z.device
    if valid_faces is None:
        valid_faces = torch.ones((B, F_), dtype=torch.bool, device=device)
    margin = float(boxlen) * float(multiplier)
    with torch.no_grad():
        fvz = face_vertices_z.detach()
        fvi_scaled = face_vertices_image.detach() * multiplier
        (vt, tile_ranges, chunk_tranges, chunk_bbox, perm,
         inv_perm) = build_face_tiles(fvz, fvi_scaled, valid_faces, height,
                                      width, float(multiplier), margin)
        vt = vt.float().contiguous()
        chunk_bbox = chunk_bbox.float().contiguous()
        fid_s, prod = _fused_forward(
            vt, tile_ranges, chunk_bbox, height, width, float(multiplier),
            float(eps), float(sigmainv), with_softmask)
        # sorted -> original face ids
        safe = torch.clamp(fid_s, 0, F_ - 1).long().reshape(B, -1)
        mapped = torch.gather(perm, 1, safe).reshape(fid_s.shape)
        face_idx = torch.where(fid_s >= 0, mapped, -1).int()
    return FusedSelection(face_idx, prod, vt, chunk_tranges, chunk_bbox,
                          inv_perm)


class _SoftmaskFused(torch.autograd.Function):
    """Soft mask from a selection; backward = the fused backward kernel."""

    @staticmethod
    def forward(ctx, fvi_scaled, face_idx, prod, vt, chunk_tranges,
                chunk_bbox, inv_perm, config):
        ctx.config = config
        ctx.save_for_backward(face_idx, prod, vt, chunk_tranges, chunk_bbox,
                              inv_perm)
        return torch.where(face_idx < 0, 1. - prod, 1.)

    @staticmethod
    def backward(ctx, g):
        height, width, multiplier, sigmainv = ctx.config
        face_idx, prod, vt, chunk_tranges, chunk_bbox, inv_perm = \
            ctx.saved_tensors
        B, F_ = inv_perm.shape
        g_prod = torch.where(face_idx < 0, g * prod, 0.).float().contiguous()
        dsorted = _fused_backward(vt, chunk_tranges, chunk_bbox, g_prod,
                                  height, width, float(multiplier),
                                  float(sigmainv))             # (B, Fp, 6)
        dfvi = torch.gather(dsorted, 1, inv_perm[..., None].expand(B, F_, 6))
        return (dfvi.reshape(B, F_, 3, 2).to(g.dtype),
                None, None, None, None, None, None, None)


def softmask_fused(fvi_scaled, sel: FusedSelection, config):
    """Differentiable soft mask from a :class:`FusedSelection`.

    ``config`` = (height, width, multiplier, sigmainv).  ``fvi_scaled`` must
    be the geometry the selection was built from: the forward value reuses
    the selection's product, the backward differentiates it w.r.t.
    ``fvi_scaled``.
    """
    return _SoftmaskFused.apply(fvi_scaled, *sel, config)
