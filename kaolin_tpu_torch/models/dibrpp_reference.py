"""DIB-R++ in plain PyTorch: the oracle of :mod:`.dibrpp`'s tests.

The rasterization mode of DIB-R++ (Chen et al. 2021, arXiv:2111.00140) on
DIB-R's renderer (Chen et al. 2019, arXiv:1908.01210), written from the
published descriptions and kaolin's definitions, float32 with TF32 off,
one view and one pixel-face pair at a time as broadcasts: no kernel, no
cache, nothing shared between views, and nothing imported from the rest
of the package.

- ``P_cam = R (P - T)``, the eye is ``T``; image = ``(x, y) * proj[:2] /
  -z``; coordinates scaled by ``MULTIPLIER``; pixel centres ``x = (2 i + 1
  - W) / W``, ``y = (H - 2 j - 1) / H``;
- a face covers a pixel where it faces the camera (its camera-space unit
  normal's z >= 0) and its three barycentric weights are >= 0 (normalised
  by their sum plus ``EPS`` of its sign); the covering face of largest
  camera z wins, a tie to the lower face id;
- a covered pixel interpolates its face's uvs, world-space unit normal and
  world-space corners by those weights; the material map is sampled
  bilinearly at the uv clipped to [0, 1], v flipped, align_corners=False,
  each corner index clipped on its own; albedo = channels 0-2, roughness =
  channel 3 clipped to ``ROUGHNESS``; view = ``normalize(eye - x)``;
- SG lights ``(a_k, d_k, s_k)``, ``d_k`` = (cos az cos el, sin az cos el,
  sin el); the inner product of two SGs is ``2 pi a a' (1 - exp(-2 dm))
  exp(dm - lm) / dm``, ``dm = |s d + s' d'|``, ``lm = s + s'``;
- diffuse = ``max(sum_k <cosine lobe, light_k>, 0) * albedo / pi``, the
  clamped cosine as the SG (1.17, n, 2.133);
- specular: the GGX NDF as the SG ``(1 / (pi m2), n, 2 / m2)``, ``m2 =
  roughness^2``, warped to the reflected view ``w = 2 (n.v) n - v`` with
  sharpness ``2 / m2 / (4 max(n.v, 1e-4))``; ``sum_k <warped NDF,
  light_k> * G1(n.w) G1(n.v) * F(w.h) * (n.w)``, the dots clipped to [0,
  1], ``G1(x) = 1 / (x + sqrt(m2 + (1 - m2) x^2))``, Schlick ``F(x) = F0 +
  (1 - F0) (1 - x)^5`` with ``F0 = SPEC_ALBEDO``, ``h = normalize(w + v)``,
  clipped at 0;
- image = ``clip(diffuse + specular, 0, 1)``, 0 off the mesh;
- the soft silhouette is 1 where a face covers the pixel, else ``1 -
  prod(1 - exp(-SIGMAINV d^2 / MULTIPLIER^2))`` over every face whose bbox
  grown by ``BOXLEN`` holds the pixel (half-open), ``d`` the distance to
  the triangle (to an edge where the foot of the perpendicular falls on
  it, else to a vertex);
- loss = ``mean |image - target| + 1 - mean IoU`` of the soft silhouettes.

Departures from the paper: the lights are SGs in the world frame (the
paper's are too) but their number is set by the caller; the specular
albedo is a constant and the roughness a map (DIB-R++'s network predicts
both); the silhouette term is DIB-R's soft mask and IoU, not the paper's
alpha channel of a Monte-Carlo pass.
"""

import math

import torch

__all__ = ['MULTIPLIER', 'EPS', 'BOXLEN', 'SIGMAINV', 'SPEC_ALBEDO',
           'ROUGHNESS', 'render', 'loss', 'loss_and_grads']

MULTIPLIER = 1000.
EPS = 1e-8
BOXLEN = 0.02
SIGMAINV = 7000.
SPEC_ALBEDO = 0.04
ROUGHNESS = (0.1, 1.)
_EDGE_EPS = 1e-7


def _clip(x, lo=None, hi=None):
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _unit_normals(corners):
    """Unit normals (..., 3) of triangles (..., 3, 3), norm floored at
    1e-12."""
    n = torch.linalg.cross(corners[..., 1, :] - corners[..., 0, :],
                           corners[..., 2, :] - corners[..., 0, :], dim=-1)
    return n / _clip(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)


def _bary(f, x0, y0):
    """Normalised barycentric weights of points (x0, y0) in triangles ``f``
    (..., 3, 2), scaled coordinates."""
    a_x, a_y = f[..., 0, 0] - x0, f[..., 0, 1] - y0
    b_x, b_y = f[..., 1, 0] - x0, f[..., 1, 1] - y0
    c_x, c_y = f[..., 2, 0] - x0, f[..., 2, 1] - y0
    w0 = b_x * c_y - b_y * c_x
    w1 = c_x * a_y - c_y * a_x
    w2 = a_x * b_y - a_y * b_x
    norm = w0 + w1 + w2
    norm = norm + torch.where(torch.signbit(norm), -EPS, EPS).to(norm.dtype)
    return w0 / norm, w1 / norm, w2 / norm


def _sq_distance(f, x0, y0):
    """Squared distance of points to triangles ``f`` (..., 3, 2), scaled;
    an edge whose foot falls outside it counts as ``4 MULTIPLIER^2``."""
    sentinel = 4. * MULTIPLIER ** 2
    d = None
    for e in range(3):
        x1, y1 = f[..., e, 0], f[..., e, 1]
        x2, y2 = f[..., (e + 1) % 3, 0], f[..., (e + 1) % 3, 1]
        A, Bc = y2 - y1, x1 - x2
        C = x2 * y1 - x1 * y2
        idn = 1. / (A * A + Bc * Bc + _EDGE_EPS)
        up = A * x0 + Bc * y0 + C
        t = up * idn
        x3, y3 = x0 - A * t, y0 - Bc * t
        direct = (x3 - x1) * (x3 - x2) + (y3 - y1) * (y3 - y2)
        de = torch.where(direct > 0., torch.full_like(up, sentinel),
                         up * up * idn)
        d = de if d is None else torch.minimum(d, de)
    for v in range(3):
        d = torch.minimum(d, (x0 - f[..., v, 0]) ** 2
                          + (y0 - f[..., v, 1]) ** 2)
    return d


def _bilinear(texture, uv):
    """Bilinear samples (P, C) of ``texture`` (C, TH, TW) at ``uv`` (P, 2)
    in [0, 1], v up."""
    C, TH, TW = texture.shape
    x = uv[:, 0] * TW - 0.5
    y = (1. - uv[:, 1]) * TH - 0.5
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = (x - x0)[:, None], (y - y0)[:, None]
    xi, yi = x0.long(), y0.long()
    texels = texture.permute(1, 2, 0)

    def tap(yy, xx):
        return texels[yy.clamp(0, TH - 1), xx.clamp(0, TW - 1)]
    return (tap(yi, xi) * (1 - wx) * (1 - wy) + tap(yi, xi + 1) * wx * (1 - wy)
            + tap(yi + 1, xi) * (1 - wx) * wy + tap(yi + 1, xi + 1) * wx * wy)


def _sg_sum(a, d, s, la, ld, ls):
    """sum_k <(a, d, s), (la_k, ld_k, ls_k)>: per-pixel SGs (P, 3), (P, 3),
    (P,) against the lights (K, 3), (K, 3), (K,); (P, 3)."""
    dm_vec = s[:, None, None] * d[:, None] + ls[None, :, None] * ld[None]
    dm = torch.sqrt(_dot(dm_vec, dm_vec))
    lm = s[:, None, None] + ls[None, :, None]
    inner = (2. * math.pi * torch.exp(dm - lm) * (a[:, None] * la[None])
             * (1. - torch.exp(-2. * dm)) / dm)
    return inner.sum(dim=1)


def shade(normal, view, albedo, roughness, lights, specular=True):
    """Diffuse + specular radiance (P, 3) of pixels (unit normal and view
    (P, 3), albedo (P, 3), roughness (P,)) under ``lights`` = (amplitude
    (K, 3), azimuth, elevation, sharpness (K,))."""
    amp, az, el, sharp = lights
    d = torch.stack([torch.cos(az) * torch.cos(el),
                     torch.sin(az) * torch.cos(el), torch.sin(el)], dim=-1)
    cos_lobe = _sg_sum(torch.full_like(normal, 1.17), normal,
                       torch.full_like(normal[:, 0], 2.133), amp, d, sharp)
    out = _clip(cos_lobe, 0.) * albedo / math.pi
    if not specular:
        return out
    m2 = roughness * roughness
    ndv_raw = _dot(normal, view)
    w = 2. * ndv_raw * normal - view
    warp_sharp = (2. / m2) / (4. * _clip(ndv_raw[:, 0], 1e-4))
    ndf = _sg_sum((1. / (math.pi * m2))[:, None].expand(normal.shape), w,
                  warp_sharp, amp, d, sharp)
    ndl = _clip(_dot(normal, w), 0., 1.)
    ndv = _clip(ndv_raw, 0., 1.)
    h = w + view
    h = h / torch.sqrt(_dot(h, h))
    ldh = _clip(_dot(w, h), 0., 1.)
    m2 = m2[:, None]
    g1l = 1. / (ndl + torch.sqrt(m2 + (1. - m2) * ndl * ndl))
    g1v = 1. / (ndv + torch.sqrt(m2 + (1. - m2) * ndv * ndv))
    fres = SPEC_ALBEDO + (1. - SPEC_ALBEDO) * (1. - ldh) ** 5
    return out + _clip(ndf * g1l * g1v * fres * ndl, 0.)


def render(params, rot, trans, proj, faces, face_uvs, H, W):
    """(images (B, H, W, 3), soft silhouettes (B, H, W)) of ``params`` =
    (vertices (V, 3), material (4, TH, TW), amplitude (K, 3), azimuth,
    elevation, sharpness (K,)) from B cameras, one view at a time."""
    vertices, material, *lights = params
    dt, dev = vertices.dtype, vertices.device
    xs = (MULTIPLIER / W) * (2 * torch.arange(W, dtype=dt, device=dev)
                             + 1 - W)
    ys = (MULTIPLIER / H) * (H - 2 * torch.arange(H, dtype=dt, device=dev)
                             - 1)
    x0 = xs.repeat(H)
    y0 = ys.repeat_interleave(W)
    corners_w = vertices[faces]                          # (F, 3, 3)
    normal_w = _unit_normals(corners_w)
    uvs = face_uvs.to(dt)
    images, masks = [], []
    for b in range(rot.shape[0]):
        cam = torch.matmul(vertices - trans[b], rot[b].t())
        p = cam * proj.reshape(1, 3)
        img = p[:, :2] / p[:, 2:3]
        fs = img[faces] * MULTIPLIER                     # (F, 3, 2)
        valid = _unit_normals(cam[faces])[:, 2] >= 0.
        with torch.no_grad():
            w0, w1, w2 = _bary(fs[None], x0[:, None], y0[:, None])
            cov = (w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.) & valid[None]
            z = cam[faces][:, :, 2]
            zz = w0 * z[:, 0] + w1 * z[:, 1] + w2 * z[:, 2]
            zz = torch.where(cov, zz, float('-inf'))
            zmax = zz.max(dim=1).values
            hit = torch.isfinite(zmax)
            fid = torch.argmax((zz == zmax[:, None]).to(torch.int8), dim=1)
        cp = torch.nonzero(hit).squeeze(1)
        f = fid[cp]
        w0, w1, w2 = _bary(fs[f], x0[cp], y0[cp])
        w = torch.stack([w0, w1, w2], dim=-1)[..., None]     # (P, 3, 1)
        uv = (w * uvs[f]).sum(dim=1)
        normal = (w * normal_w[f][:, None, :]).sum(dim=1)
        pos = (w * corners_w[f]).sum(dim=1)
        view = trans[b] - pos
        view = view / torch.sqrt(_dot(view, view))
        mat = _bilinear(material, _clip(uv, 0., 1.))
        color = _clip(shade(normal, view, mat[:, :3],
                            _clip(mat[:, 3], *ROUGHNESS), lights), 0., 1.)
        images.append(torch.zeros((H * W, 3), dtype=dt, device=dev)
                      .index_copy(0, cp, color).reshape(H, W, 3))

        lo = fs.amin(dim=1) - BOXLEN * MULTIPLIER
        hi = fs.amax(dim=1) + BOXLEN * MULTIPLIER
        inbox = ((x0[:, None] >= lo[None, :, 0]) & (x0[:, None] < hi[None, :, 0])
                 & (y0[:, None] >= lo[None, :, 1])
                 & (y0[:, None] < hi[None, :, 1]))
        d = _sq_distance(fs[None], x0[:, None], y0[:, None])
        pf = torch.where(inbox, torch.exp(-(SIGMAINV / MULTIPLIER ** 2) * d),
                         torch.zeros_like(d))
        soft = torch.where(hit, torch.ones_like(zmax),
                           1. - torch.prod(1. - pf, dim=1))
        masks.append(soft.reshape(H, W))
    return torch.stack(images), torch.stack(masks)


def loss(images, soft, target_images, target_masks):
    """Image L1 + (1 - mean IoU) of the soft silhouettes."""
    B = soft.shape[0]
    inter = torch.sum((soft * target_masks).reshape(B, -1), dim=1)
    union = torch.sum((soft + target_masks - soft * target_masks)
                      .reshape(B, -1), dim=1)
    return (torch.mean(torch.abs(images - target_images))
            + 1. - torch.mean(inter / (union + 1e-10)))


def loss_and_grads(params, views, faces, face_uvs, target_images,
                   target_masks, H, W):
    """(loss, [the gradient of each of ``params``]) of ``params`` seen
    from ``views`` = (rot (B, 3, 3), trans (B, 3), proj (3, 1)), in
    float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    leaves = [p.detach().float().clone().requires_grad_() for p in params]
    rot, trans, proj = (v.float() for v in views)
    images, soft = render(leaves, rot, trans, proj, faces, face_uvs, H, W)
    value = loss(images, soft, target_images.float(), target_masks.float())
    value.backward()
    return value.detach(), [p.grad for p in leaves]
