"""DIB-R++ inverse rendering in plain PyTorch: the mesh, a material map
(albedo and GGX roughness) and spherical-Gaussian lights seen from a batch
of cameras, rendered in DIB-R++'s rasterization mode (Chen et al. 2021,
arXiv:2111.00140), DIB-R's soft silhouette, the image L1 + silhouette IoU
loss, autograd's gradients and Adam.

The rasterization, the z-buffer, the bilinear sample and the soft
silhouette are ``reference/dibr.py``'s.  The shading of a covered pixel:

- its face's uvs, world-space unit normal and world-space corners
  interpolated by its barycentric weights; albedo = the material's
  channels 0-2 and roughness = channel 3 clipped to ``roughness_clip``,
  sampled bilinearly at the uv; view = ``normalize(eye - x)``, the eye the
  camera's translation;
- SG lights ``(a_k, d_k, s_k)``, ``d_k`` = (cos az cos el, sin az cos el,
  sin el); the inner product of two SGs ``2 pi a a' (1 - exp(-2 dm))
  exp(dm - lm) / dm``, ``dm = |s d + s' d'|``, ``lm = s + s'``;
- diffuse = ``max(sum_k <(1.17, n, 2.133), light_k>, 0) * albedo / pi``
  (the clamped cosine as one SG);
- specular = ``max(sum_k <warped NDF, light_k> * G1(n.w) G1(n.v) F(w.h)
  (n.w), 0)``: the GGX NDF as the SG ``(1 / (pi m2), n, 2 / m2)``, ``m2 =
  roughness^2``, warped to ``w = 2 (n.v) n - v`` with sharpness ``2 / m2 /
  (4 max(n.v, 1e-4))``; the dots clipped to [0, 1]; ``G1(x) = 1 / (x +
  sqrt(m2 + (1 - m2) x^2))``; Schlick ``F(x) = F0 + (1 - F0) (1 - x)^5``,
  ``F0 = spec_albedo``; ``h = normalize(w + v)``;
- colour = ``clip(diffuse + specular, 0, 1)``, 0 off the mesh.

Departures from the paper: a constant specular albedo and a roughness map
in place of the network's predictions; DIB-R's soft silhouette and IoU in
place of the paper's alpha channel.  Only covered pixels are shaded.

Faults for the control (``fit``): the specular term left out, part of the
lights left out, the roughness gradient zeroed before the update, half of
each step's views left out.
"""

import math

import torch

from benchmark.reference import dibr as base

__all__ = ['Params', 'shade', 'render', 'render_targets', 'fit']


class Params:
    """Vertices (V, 3), material (4, TH, TW), amplitude (K, 3), azimuth,
    elevation, sharpness (K,)."""

    def __init__(self, vertices, material, amplitude, azimuth, elevation,
                 sharpness):
        self.vertices, self.material = vertices, material
        self.lights = [amplitude, azimuth, elevation, sharpness]

    def leaves(self):
        return [self.vertices, self.material, *self.lights]

    def to(self, dtype):
        return Params(*(t.detach().to(dtype) for t in self.leaves()))


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _sg_sum(a, d, s, la, ld, ls):
    """sum_k <(a, d, s), light_k> of per-pixel SGs (P, 3), (P, 3), (P,)
    against lights (K, 3), (K, 3), (K,): (P, 3)."""
    dm_vec = s[:, None, None] * d[:, None] + ls[None, :, None] * ld[None]
    dm = torch.sqrt(_dot(dm_vec, dm_vec))
    lm = s[:, None, None] + ls[None, :, None]
    inner = (2. * math.pi * torch.exp(dm - lm) * (a[:, None] * la[None])
             * (1. - torch.exp(-2. * dm)) / dm)
    return inner.sum(dim=1)


def shade(normal, view, albedo, roughness, lights, spec_albedo,
          specular=True):
    """Diffuse + specular radiance (P, 3) of unit normals and views (P, 3),
    albedo (P, 3) and roughness (P,) under ``lights`` (amplitude, azimuth,
    elevation, sharpness)."""
    amp, az, el, sharp = lights
    d = torch.stack([torch.cos(az) * torch.cos(el),
                     torch.sin(az) * torch.cos(el), torch.sin(el)], dim=-1)
    cos_lobe = _sg_sum(torch.full_like(normal, 1.17), normal,
                       torch.full_like(normal[:, 0], 2.133), amp, d, sharp)
    out = base._clip(cos_lobe, 0.) * albedo / math.pi
    if not specular:
        return out
    m2 = roughness * roughness
    ndv_raw = _dot(normal, view)
    w = 2. * ndv_raw * normal - view
    warp_sharp = (2. / m2) / (4. * base._clip(ndv_raw[:, 0], 1e-4))
    ndf = _sg_sum((1. / (math.pi * m2))[:, None].expand(normal.shape), w,
                  warp_sharp, amp, d, sharp)
    ndl = base._clip(_dot(normal, w), 0., 1.)
    ndv = base._clip(ndv_raw, 0., 1.)
    h = w + view
    h = h / torch.sqrt(_dot(h, h))
    ldh = base._clip(_dot(w, h), 0., 1.)
    m2 = m2[:, None]
    g1l = 1. / (ndl + torch.sqrt(m2 + (1. - m2) * ndl * ndl))
    g1v = 1. / (ndv + torch.sqrt(m2 + (1. - m2) * ndv * ndv))
    fres = spec_albedo + (1. - spec_albedo) * (1. - ldh) ** 5
    return out + base._clip(ndf * g1l * g1v * fres * ndl, 0.)


def _soft_silhouette(fvi, face_idx, H, W, cfg):
    """DIB-R's soft silhouette (B, H, W) of ``reference/dibr.py::render``."""
    mult = cfg['multiplier']
    B, HW = fvi.shape[0], H * W
    dt, dev = fvi.dtype, fvi.device
    xs, ys = base._pixel_coords(H, W, mult, dt, dev)
    fs = fvi * mult
    margin = cfg['boxlen'] * mult
    logq = torch.zeros((B * HW,), dtype=dt, device=dev)
    for v in range(B):
        with torch.no_grad():
            k, j, i = base._bbox_pairs(fvi[v].amin(1) - cfg['boxlen'],
                                       fvi[v].amax(1) + cfg['boxlen'], H, W)
            pix = v * HW + j * W + i
            mn = fs[v].amin(1) - margin
            mx = fs[v].amax(1) + margin
            x0, y0 = xs[i], ys[j]
            keep = ((face_idx[pix] < 0) & (x0 >= mn[k, 0]) & (x0 < mx[k, 0])
                    & (y0 >= mn[k, 1]) & (y0 < mx[k, 1]))
            k, pix, x0, y0 = k[keep], pix[keep], x0[keep], y0[keep]
        d = base._sq_distance(fs[v, k], x0, y0, 4. * mult ** 2)
        p = torch.exp(-(cfg['sigmainv'] / mult ** 2) * d)
        logq = logq.index_add(0, pix, torch.log(base._clip(1. - p, 1e-30)))
    return torch.where(face_idx >= 0, torch.ones_like(logq),
                       1. - torch.exp(logq)).reshape(B, H, W)


def render(params, rot, trans, proj, faces, face_uvs, H, W, cfg,
           specular=True, lobes_used=None):
    """(images (B, H, W, 3), soft silhouettes (B, H, W)) of ``params``
    from the B cameras, differentiable in the parameters.  Faults:
    ``specular=False`` leaves the specular term out, ``lobes_used`` keeps
    the first that many lights."""
    mult, eps = cfg['multiplier'], 1e-8
    B, HW = rot.shape[0], H * W
    dt, dev = params.vertices.dtype, params.vertices.device
    vc, vi = base.project(params.vertices, rot, trans, proj)
    fvc, fvi = vc[:, faces], vi[:, faces]
    n_cam = torch.linalg.cross(fvc[..., 1, :] - fvc[..., 0, :],
                               fvc[..., 2, :] - fvc[..., 0, :], dim=-1)
    n_cam = n_cam / base._clip(torch.linalg.norm(n_cam, dim=-1, keepdim=True),
                               1e-12)
    with torch.no_grad():
        face_idx = base._select(fvc[..., 2], fvi, n_cam[..., 2] >= 0., H, W,
                                mult, eps)
    corners = params.vertices[faces]                     # (F, 3, 3) world
    n = torch.linalg.cross(corners[:, 1] - corners[:, 0],
                           corners[:, 2] - corners[:, 0], dim=-1)
    n = n / base._clip(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)
    xs, ys = base._pixel_coords(H, W, mult, dt, dev)

    cp = torch.nonzero(face_idx >= 0).squeeze(1)
    b, fid = cp // HW, face_idx[cp]
    w0, w1, w2 = base._bary(fvi[b, fid] * mult, xs[cp % W],
                            ys[(cp % HW) // W], eps)
    w = torch.stack([w0, w1, w2], dim=-1)[..., None]     # (P, 3, 1)
    uv = (w * face_uvs.to(dt)[fid]).sum(dim=1)
    normal = (w * n[fid][:, None, :]).sum(dim=1)
    pos = (w * corners[fid]).sum(dim=1)
    view = trans.to(dt)[b] - pos
    view = view / torch.sqrt(_dot(view, view))
    mat = base._bilinear(params.material, base._clip(uv, 0., 1.))
    lights = [t[:lobes_used] for t in params.lights]
    color = base._clip(shade(normal, view, mat[:, :3],
                             base._clip(mat[:, 3], *cfg['roughness_clip']),
                             lights, cfg['spec_albedo'], specular), 0., 1.)
    images = torch.zeros((B * HW, 3), dtype=dt, device=dev).index_copy(
        0, cp, color).reshape(B, H, W, 3)
    return images, _soft_silhouette(fvi, face_idx, H, W, cfg)


def render_targets(params, views, faces, face_uvs, H, W, cfg, batch):
    """Target images and soft silhouettes of every view, ``batch`` views at
    a time (no gradient)."""
    rot, trans, proj = views
    imgs, masks = [], []
    with torch.no_grad():
        for s in range(0, rot.shape[0], batch):
            im, sm = render(params, rot[s:s + batch], trans[s:s + batch],
                            proj, faces, face_uvs, H, W, cfg)
            imgs.append(im)
            masks.append(sm)
    return torch.cat(imgs), torch.cat(masks)


def fit(start, gt, views, faces, face_uvs, rows, H, W, cfg, steps,
        dtype=torch.float32, specular=True, lobes_used=None,
        roughness_grad=True, half_batch=False):
    """``steps`` Adam steps from ``start`` toward the targets that ``gt``
    renders, step k on the views ``rows[k]``, everything in ``dtype``.
    Faults: ``specular=False`` and ``lobes_used`` shade the fit (not the
    targets) without the specular term or with the first that many
    lights; ``roughness_grad=False`` zeroes the roughness channel's
    gradient before the update; ``half_batch=True`` keeps the first half
    of each step's views, the fault of a step that leaves part of its
    batch out and takes the mean over the rest.
    Returns dict(losses (steps,) float, grads (the first step's gradient
    per leaf), params (the leaves after ``steps`` steps)), float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rot, trans, proj = (t.to(dtype) for t in views)
    tgt_img, tgt_mask = render_targets(gt.to(dtype), (rot, trans, proj),
                                       faces, face_uvs, H, W, cfg,
                                       rows.shape[1])
    leaves = [t.clone().requires_grad_() for t in start.to(dtype).leaves()]
    params = Params(*leaves)
    opt = torch.optim.Adam(leaves, lr=cfg['lr'], betas=tuple(cfg['betas']),
                           eps=cfg['adam_eps'])
    losses, grads = [], None
    for k in range(steps):
        opt.zero_grad(set_to_none=True)
        views_k = rows[k].to(rot.device)
        if half_batch:
            views_k = views_k[:views_k.shape[0] // 2]
        images, soft = render(params, rot[views_k], trans[views_k], proj,
                              faces, face_uvs, H, W, cfg, specular,
                              lobes_used)
        value = base.loss(images, soft, tgt_img[views_k], tgt_mask[views_k])
        value.backward()
        if not roughness_grad:
            leaves[1].grad[3] = 0.
        if grads is None:
            grads = [t.grad.detach().float().clone() for t in leaves]
        opt.step()
        losses.append(float(value.detach()))
    return dict(losses=losses, grads=grads,
                params=[t.detach().float() for t in leaves])
