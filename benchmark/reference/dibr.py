"""DIB-R inverse rendering in plain PyTorch: the textured, SH-lit render of
a mesh seen from a batch of cameras, its soft silhouette, the image L1 +
silhouette IoU loss, autograd's gradients and Adam.

The renderer follows DIB-R (Chen et al. 2019, arXiv:1908.01210) as kaolin
defines it:

- ``P_cam = R (P - T)``; image = ``(x, y) * proj[:2] / -z``; flat face
  normals ``(v1 - v0) x (v2 - v0)``, unit (the norm floored at 1e-12); a
  face is front-facing where the normal's z is >= 0;
- coordinates are scaled by ``multiplier`` (1000); pixel centres
  ``x = (2 i + 1 - W) / W``, ``y = (H - 2 j - 1) / H`` (y up);
- the z-buffer: a front face covers a pixel where its three barycentric
  weights are >= 0 (normalised by their sum plus ``eps`` of its sign); the
  covering face of largest camera z wins, a tie to the lower face id;
- features (uv, normal) interpolate by those weights; the texture is
  sampled bilinearly at ``uv`` clipped to [0, 1], v flipped, with
  align_corners=False unnormalisation, each corner index clipped on its
  own; SH9 lighting clipped at 0 multiplies the albedo; the image clipped
  to [0, 1], 0 off the mesh;
- the soft silhouette is 1 where a face covers the pixel, else
  ``1 - prod(1 - exp(-sigmainv * d^2))`` over every face (front or back)
  whose bbox grown by ``boxlen`` holds the pixel (half-open), ``d`` the
  distance to the triangle (to an edge where the foot of the perpendicular
  falls on it, else to a vertex);
- loss = mean |image - target| + 1 - mean IoU of the soft masks.

Work is done only on the (face, pixel) pairs inside each face's bbox, so
the full-size cells fit.  Every clip is ``min(max(x, lo), hi)``.
"""

import torch

__all__ = ['Params', 'project', 'render', 'loss', 'render_targets', 'fit']

_EDGE_EPS = 1e-7


class Params:
    """Vertices (V, 3), texture (3, TH, TW), SH coefficients (9,)."""

    def __init__(self, vertices, texture, sh):
        self.vertices, self.texture, self.sh = vertices, texture, sh

    def leaves(self):
        return [self.vertices, self.texture, self.sh]

    def to(self, dtype):
        return Params(*(t.detach().to(dtype) for t in self.leaves()))


def _clip(x, lo=None, hi=None):
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def project(vertices, rot, trans, proj):
    """(camera-space vertices (B, V, 3), image-space (B, V, 2))."""
    vc = torch.matmul(vertices[None] - trans[:, None, :], rot.transpose(1, 2))
    p = vc * proj.reshape(1, 1, 3)
    return vc, p[..., :2] / p[..., 2:3]


def _pixel_coords(H, W, mult, dtype, device):
    xs = (mult / W) * (2 * torch.arange(W, device=device, dtype=dtype)
                       + 1 - W)
    ys = (mult / H) * (H - 2 * torch.arange(H, device=device, dtype=dtype)
                       - 1)
    return xs, ys


def _bbox_pairs(lo, hi, H, W):
    """(face id, row j, column i) of every pixel whose centre may lie in a
    face's box ``[lo, hi]`` (F, 2), unscaled; a pixel of margin each side,
    the exact test is the caller's."""
    lo, hi = lo.double(), hi.double()
    i_lo = torch.ceil((lo[:, 0] * W + W - 1) / 2).long() - 1
    i_hi = torch.floor((hi[:, 0] * W + W - 1) / 2).long() + 1
    j_lo = torch.ceil((H - 1 - hi[:, 1] * H) / 2).long() - 1
    j_hi = torch.floor((H - 1 - lo[:, 1] * H) / 2).long() + 1
    i_lo, i_hi = i_lo.clamp(0, W - 1), i_hi.clamp(-1, W - 1)
    j_lo, j_hi = j_lo.clamp(0, H - 1), j_hi.clamp(-1, H - 1)
    nx = (i_hi - i_lo + 1).clamp(min=0)
    ny = (j_hi - j_lo + 1).clamp(min=0)
    n = nx * ny
    fid = torch.repeat_interleave(torch.arange(lo.shape[0],
                                               device=lo.device), n)
    k = torch.arange(fid.shape[0], device=lo.device) - (
        torch.cumsum(n, 0) - n)[fid]
    return fid, j_lo[fid] + k // nx[fid], i_lo[fid] + k % nx[fid]


def _bary(f, x0, y0, eps):
    """Normalised barycentric weights of points (x0, y0) in faces ``f``
    (..., 3, 2), scaled coordinates."""
    a_x, a_y = f[..., 0, 0] - x0, f[..., 0, 1] - y0
    b_x, b_y = f[..., 1, 0] - x0, f[..., 1, 1] - y0
    c_x, c_y = f[..., 2, 0] - x0, f[..., 2, 1] - y0
    w0 = b_x * c_y - b_y * c_x
    w1 = c_x * a_y - c_y * a_x
    w2 = a_x * b_y - a_y * b_x
    norm = w0 + w1 + w2
    norm = norm + torch.where(torch.signbit(norm), -eps, eps).to(norm.dtype)
    return w0 / norm, w1 / norm, w2 / norm


def _sq_distance(f, x0, y0, sentinel):
    """Squared distance of points to triangles ``f`` (P, 3, 2), scaled."""
    d = None
    for e in range(3):
        x1, y1 = f[:, e, 0], f[:, e, 1]
        x2, y2 = f[:, (e + 1) % 3, 0], f[:, (e + 1) % 3, 1]
        A, Bc = y2 - y1, x1 - x2
        C = x2 * y1 - x1 * y2
        idn = 1. / (A * A + Bc * Bc + _EDGE_EPS)
        up = A * x0 + Bc * y0 + C
        t = up * idn
        x3, y3 = x0 - A * t, y0 - Bc * t
        direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2)
        de = torch.where(direct > 0., sentinel, up * up * idn)
        d = de if d is None else torch.minimum(d, de)
    for v in range(3):
        d = torch.minimum(d, (x0 - f[:, v, 0]) ** 2 + (y0 - f[:, v, 1]) ** 2)
    return d


def _select(fvc_z, fvi, valid, H, W, mult, eps):
    """The z-buffer (no gradient): face id (B*H*W,) int64, -1 off the mesh."""
    B = fvi.shape[0]
    xs, ys = _pixel_coords(H, W, mult, fvi.dtype, fvi.device)
    out = torch.full((B * H * W,), -1, dtype=torch.long, device=fvi.device)
    for b in range(B):
        faces = torch.nonzero(valid[b]).squeeze(1)
        f_un = fvi[b, faces]
        k, j, i = _bbox_pairs(f_un.amin(1), f_un.amax(1), H, W)
        fid = faces[k]
        x0, y0 = xs[i], ys[j]
        w0, w1, w2 = _bary(fvi[b, fid] * mult, x0, y0, eps)
        cov = (w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.)
        z = fvc_z[b, fid]
        zz = w0 * z[:, 0] + w1 * z[:, 1] + w2 * z[:, 2]
        pix = (j * W + i)[cov]
        fid, zz = fid[cov], zz[cov]
        zmax = torch.full((H * W,), float('-inf'), dtype=zz.dtype,
                          device=zz.device).scatter_reduce(
            0, pix, zz, 'amax', include_self=True)
        top = zz == zmax[pix]
        best = torch.full((H * W,), fid.numel() and int(fid.max()) + 1,
                          dtype=torch.long, device=fid.device)
        best = best.scatter_reduce(0, pix[top], fid[top], 'amin',
                                   include_self=True)
        hit = torch.isfinite(zmax)
        out[b * H * W:(b + 1) * H * W] = torch.where(hit, best, -1)
    return out


def render(params, rot, trans, proj, faces, face_uvs, H, W, cfg):
    """(images (B, H, W, 3), soft mask (B, H, W), face ids (B*H*W,)) of
    ``params`` from the B cameras, differentiable in the parameters."""
    mult, eps = cfg['multiplier'], 1e-8
    B = rot.shape[0]
    dt, dev = params.vertices.dtype, params.vertices.device
    vc, vi = project(params.vertices, rot, trans, proj)
    fvc, fvi = vc[:, faces], vi[:, faces]
    n = torch.linalg.cross(fvc[..., 1, :] - fvc[..., 0, :],
                           fvc[..., 2, :] - fvc[..., 0, :], dim=-1)
    n = n / _clip(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)
    with torch.no_grad():
        face_idx = _select(fvc[..., 2], fvi, n[..., 2] >= 0., H, W, mult,
                           eps)
    xs, ys = _pixel_coords(H, W, mult, dt, dev)
    fs = fvi * mult
    HW = H * W

    # covered pixels: interpolation, texture, lighting
    cp = torch.nonzero(face_idx >= 0).squeeze(1)
    b, fid = cp // HW, face_idx[cp]
    x0, y0 = xs[cp % W], ys[(cp % HW) // W]
    w0, w1, w2 = _bary(fs[b, fid], x0, y0, eps)
    uv3 = face_uvs.to(dt)[fid]
    uv = (w0[:, None] * uv3[:, 0] + w1[:, None] * uv3[:, 1]
          + w2[:, None] * uv3[:, 2])
    nf = n[b, fid]
    normal = w0[:, None] * nf + w1[:, None] * nf + w2[:, None] * nf
    albedo = _bilinear(params.texture, _clip(uv, 0., 1.))
    light = _sh9(normal, params.sh)
    color = _clip(albedo * _clip(light, 0.)[:, None], 0., 1.)
    images = torch.zeros((B * HW, 3), dtype=dt, device=dev).index_copy(
        0, cp, color).reshape(B, H, W, 3)

    # empty pixels: the soft silhouette
    margin = cfg['boxlen'] * mult
    sentinel = 4. * mult ** 2
    logq = torch.zeros((B * HW,), dtype=dt, device=dev)
    for v in range(B):
        with torch.no_grad():
            k, j, i = _bbox_pairs(fvi[v].amin(1) - cfg['boxlen'],
                                  fvi[v].amax(1) + cfg['boxlen'], H, W)
            pix = v * HW + j * W + i
            mn = fs[v].amin(1) - margin
            mx = fs[v].amax(1) + margin
            x0, y0 = xs[i], ys[j]
            keep = ((face_idx[pix] < 0) & (x0 >= mn[k, 0]) & (x0 < mx[k, 0])
                    & (y0 >= mn[k, 1]) & (y0 < mx[k, 1]))
            k, pix, x0, y0 = k[keep], pix[keep], x0[keep], y0[keep]
        d = _sq_distance(fs[v, k], x0, y0, sentinel)
        p = torch.exp(-(cfg['sigmainv'] / mult ** 2) * d)
        logq = logq.index_add(0, pix, torch.log(_clip(1. - p, 1e-30)))
    soft = torch.where(face_idx >= 0, torch.ones_like(logq),
                       1. - torch.exp(logq)).reshape(B, H, W)
    return images, soft, face_idx


def _bilinear(texture, uv):
    """Bilinear samples (P, C) of ``texture`` (C, TH, TW) at ``uv`` (P, 2)."""
    C, TH, TW = texture.shape
    uv = uv * 2. - 1.
    x = (uv[:, 0] + 1.) * TW / 2. - 0.5
    y = (-uv[:, 1] + 1.) * TH / 2. - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    xi, yi = x0.long(), y0.long()
    rows = texture.permute(1, 2, 0).reshape(TH * TW, C)

    def tap(yy, xx):
        return rows[yy.clamp(0, TH - 1) * TW + xx.clamp(0, TW - 1)]
    return (tap(yi, xi) * (1 - wx) * (1 - wy) + tap(yi, xi + 1) * wx * (1 - wy)
            + tap(yi + 1, xi) * (1 - wx) * wy + tap(yi + 1, xi + 1) * wx * wy)


def _sh9(normal, sh):
    """Real SH9 irradiance of unit ``normal`` (P, 3) under ``sh`` (9,)."""
    x, y, z = normal[:, 0], normal[:, 1], normal[:, 2]
    bands = torch.stack([
        0.28209479177 * torch.ones_like(x), 0.4886025119 * x,
        0.4886025119 * z, 0.4886025119 * y, 1.09254843059 * (x * y),
        1.09254843059 * (y * z), 0.94617469575 * (z * z) - 0.31539156525,
        0.77254840404 * (x * z), 0.38627420202 * (x * x - y * y)], dim=-1)
    return torch.sum(bands * sh.reshape(1, 9), dim=-1)


def loss(images, soft, target_images, target_masks):
    """Image L1 + (1 - mean IoU) of the soft masks."""
    B = soft.shape[0]
    inter = torch.sum((soft * target_masks).reshape(B, -1), dim=1)
    union = torch.sum((soft + target_masks - soft * target_masks)
                      .reshape(B, -1), dim=1)
    return (torch.mean(torch.abs(images - target_images))
            + 1. - torch.mean(inter / (union + 1e-10)))


def render_targets(params, views, faces, face_uvs, H, W, cfg, batch):
    """Target images and soft masks of every view, ``batch`` views at a
    time (no gradient)."""
    rot, trans, proj = views
    imgs, masks = [], []
    with torch.no_grad():
        for s in range(0, rot.shape[0], batch):
            im, sm, _ = render(params, rot[s:s + batch], trans[s:s + batch],
                               proj, faces, face_uvs, H, W, cfg)
            imgs.append(im)
            masks.append(sm)
    return torch.cat(imgs), torch.cat(masks)


def fit(start, gt, views, faces, face_uvs, rows, H, W, cfg, steps,
        dtype=torch.float32, views_used=None, reduce=None, shares=1,
        grad_scale=None):
    """``steps`` Adam steps from ``start`` toward the targets that ``gt``
    renders, step k on the views ``rows[k]``, everything in ``dtype``.

    ``shares`` (default 1) splits each step's batch into that many equal
    shares, each a loss of its own: the step's loss and gradients are
    their sums, as over the cards of a multi-card step.  ``reduce``
    (default none), called on the loss and on each gradient in place
    before the update, sums them over the processes of a multi-card step,
    each of which holds a share of the views.
    Two faults: ``views_used`` (default all) keeps the first that many
    views of each share, the fault of a step that leaves part of its
    batch out and takes the mean over the rest; ``grad_scale`` (default none), one factor per leaf,
    scales each gradient before the update, the fault of a backward that
    gives a gradient the wrong size or sign.
    Returns dict(losses (steps,) float64, grads (the first step's gradient
    per leaf), params (the leaves after ``steps`` steps)), float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rot, trans, proj = (t.to(dtype) for t in views)
    batch = rows.shape[1] // shares
    tgt_img, tgt_mask = render_targets(gt.to(dtype), (rot, trans, proj),
                                       faces, face_uvs, H, W, cfg, batch)
    p = start.to(dtype)
    leaves = [t.clone().requires_grad_() for t in p.leaves()]
    params = Params(*leaves)
    opt = torch.optim.Adam(leaves, lr=cfg['lr'], betas=tuple(cfg['betas']),
                           eps=cfg['adam_eps'])
    losses, grads = [], None
    for k in range(steps):
        opt.zero_grad(set_to_none=True)
        value = 0.
        for share in rows[k].to(rot.device).split(batch):
            share = share[:views_used]
            images, soft, _ = render(params, rot[share], trans[share], proj,
                                     faces, face_uvs, H, W, cfg)
            part = loss(images, soft, tgt_img[share], tgt_mask[share])
            part.backward()
            value = value + part.detach()
        if reduce is not None:
            for t in [value] + [t.grad for t in leaves]:
                reduce(t)
        if grad_scale is not None:
            for t, s in zip(leaves, grad_scale):
                t.grad.mul_(s)
        if grads is None:
            grads = [t.grad.detach().float().clone() for t in leaves]
        opt.step()
        losses.append(float(value))
    return dict(losses=losses, grads=grads,
                params=[t.detach().float() for t in leaves])
