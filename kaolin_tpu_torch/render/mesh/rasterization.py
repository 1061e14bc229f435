"""Differentiable z-buffer triangle rasterization (DIB-R).

Port of ``kaolin_tpu/render/mesh/rasterization.py``.  Rasterization is
split into a non-differentiable selection pass (the z-buffer winner per
pixel) and a differentiable epilogue: gather the selected face per pixel,
recompute its normalized barycentric weights with the ``copysign(eps)``
rule and interpolate the features.  Autograd of the epilogue is the
rasterizer's backward.

Two selection backends, named as in the JAX package:

* ``'fused'``: the tile-binned fused engine of :mod:`._fused` (kernel K1 on
  the card);
* ``'jnp'``: the brute-force selection in plain PyTorch, every pixel
  against every face in chunks (:func:`_selection_jnp`).  The name is the
  JAX package's, so that a backend name means the same in both packages.

``'auto'`` is ``'fused'`` on every device (the JAX package picks ``'jnp'``
off the TPU).

Pixel-center convention: ``x0 = mult/W * (2*wi + 1 - W)``,
``y0 = mult/H * (H - 2*hi - 1)`` — image coords in [-1, 1] with y up and
row 0 at the top.
"""

import torch

from kaolin_tpu_torch._device import entry_device
from kaolin_tpu_torch.ops.gather import flat_index, gather_rows
from kaolin_tpu_torch.render.mesh._fused import fused_selection

__all__ = ['rasterize', 'rasterize_selection', 'fused_backend_supported']


def fused_backend_supported(height, width):
    """Whether the 'fused' backend supports this image size.

    Always true: the engine pads the tile grid internally and crops.
    """
    return height >= 1 and width >= 1


def _resolve_backend(backend):
    if backend == 'auto':
        return 'fused'
    if backend not in ('jnp', 'fused'):
        raise ValueError(f'"{backend}" is not a valid backend, '
                         'valid choices are ["jnp", "fused", "auto"]')
    return backend


def pixel_coords(height, width, multiplier, dtype=torch.float32,
                 device=None):
    """Pixel-center coordinates: xs (W,), ys (H,), on ``device`` (default:
    the card)."""
    device = entry_device(device)
    xs = (multiplier / width) * (
        2 * torch.arange(width, dtype=dtype, device=device) + 1 - width)
    ys = (multiplier / height) * (
        height - 2 * torch.arange(height, dtype=dtype, device=device) - 1)
    return xs, ys


def _copysign_eps(norm, eps):
    """copysign(eps, norm): the sign bit decides, so -0.0 takes -eps."""
    return torch.where(torch.signbit(norm), -eps, eps)


def _bary_weights_pairwise(fvi, x0, y0, eps):
    """Normalized barycentric weights for pixels x faces.

    fvi: (F, 3, 2); x0/y0: (P,).  Returns w0, w1, w2 each (P, F).
    """
    x0 = x0[:, None]
    y0 = y0[:, None]
    a_ex = fvi[None, :, 0, 0] - x0
    a_ey = fvi[None, :, 0, 1] - y0
    b_ex = fvi[None, :, 1, 0] - x0
    b_ey = fvi[None, :, 1, 1] - y0
    c_ex = fvi[None, :, 2, 0] - x0
    c_ey = fvi[None, :, 2, 1] - y0
    w0 = b_ex * c_ey - b_ey * c_ex
    w1 = c_ex * a_ey - c_ey * a_ex
    w2 = a_ex * b_ey - a_ey * b_ex
    norm = w0 + w1 + w2
    norm = norm + _copysign_eps(norm, eps)
    return w0 / norm, w1 / norm, w2 / norm


def _selection_jnp(face_vertices_z, face_vertices_image_scaled, valid_faces,
                   xs, ys, height, width, eps, pixel_chunk=8192,
                   face_chunk=1024):
    """Z-buffer winning-face selection (single mesh), brute force.

    Every pixel against every face, in blocks of ``pixel_chunk`` pixels by
    ``face_chunk`` faces.  The answer does not depend on the chunk sizes:
    within a chunk ``torch.max`` returns the first (lowest-index) maximum,
    and across chunks only a strictly larger z replaces the winner, so a z
    tie goes to the lowest face id.

    Args:
        face_vertices_z: (F, 3); face_vertices_image_scaled: (F, 3, 2)
        (multiplier applied); valid_faces: (F,) bool; xs (W,), ys (H,).

    Returns:
        (H, W) int32 face index, -1 where empty.
    """
    F = face_vertices_z.shape[0]
    P = height * width
    pix = torch.arange(P, device=xs.device)
    px, py = xs[pix % width], ys[pix // width]
    out = torch.empty(P, dtype=torch.int32, device=xs.device)
    neg_inf = float('-inf')
    for lo_p in range(0, P, pixel_chunk):
        x0, y0 = px[lo_p:lo_p + pixel_chunk], py[lo_p:lo_p + pixel_chunk]
        best_z = torch.full(x0.shape, neg_inf, dtype=face_vertices_z.dtype,
                            device=x0.device)
        best_idx = torch.full(x0.shape, -1, dtype=torch.int32,
                              device=x0.device)
        for lo in range(0, F, face_chunk):
            fvz = face_vertices_z[lo:lo + face_chunk]
            w0, w1, w2 = _bary_weights_pairwise(
                face_vertices_image_scaled[lo:lo + face_chunk], x0, y0, eps)
            z0 = w0 * fvz[None, :, 0] + w1 * fvz[None, :, 1] \
                + w2 * fvz[None, :, 2]
            ok = ((w0 >= 0.) & (w1 >= 0.) & (w2 >= 0.)
                  & valid_faces[None, lo:lo + face_chunk])
            z0 = torch.where(ok, z0, neg_inf)
            chunk_best, chunk_idx = torch.max(z0, dim=1)
            upd = chunk_best > best_z
            best_z = torch.where(upd, chunk_best, best_z)
            best_idx = torch.where(upd, chunk_idx.to(torch.int32) + lo,
                                   best_idx)
        out[lo_p:lo_p + pixel_chunk] = torch.where(best_z > neg_inf,
                                                   best_idx, -1)
    return out.reshape(height, width)


def _bary_weights_gathered(fv, x0, y0, eps):
    """Weights for one face per pixel.  fv: (..., 3, 2); x0/y0: (...)."""
    a_ex = fv[..., 0, 0] - x0
    a_ey = fv[..., 0, 1] - y0
    b_ex = fv[..., 1, 0] - x0
    b_ey = fv[..., 1, 1] - y0
    c_ex = fv[..., 2, 0] - x0
    c_ey = fv[..., 2, 1] - y0
    w0 = b_ex * c_ey - b_ey * c_ex
    w1 = c_ex * a_ey - c_ey * a_ex
    w2 = a_ex * b_ey - a_ey * b_ex
    norm = w0 + w1 + w2
    norm = norm + _copysign_eps(norm, eps)
    return w0 / norm, w1 / norm, w2 / norm


def _interpolate_selected_batched(face_idx, face_vertices_image_scaled,
                                  face_features, xs, ys, eps):
    """Batched differentiable epilogue: one flat row gather + weights +
    lerp, as the JAX package computes it.

    The image-space vertices and the features of each face form one
    ``(B*F, 6 + 3C)`` table, and each pixel gathers its face's row with
    :func:`~kaolin_tpu_torch.ops.gather.gather_rows` at
    ``flat_index(max(face_idx, 0), F)``: one scatter in the backward (E3 on
    the card).  Background pixels gather row ``b*F`` and get zero weights;
    E3 splits their long run over warps.

    face_idx: (B, H, W) int; fvi: (B, F, 3, 2) scaled; features
    (B, F, 3, C).

    Returns:
        (image_features (B, H, W, C), weights (B, H, W, 3)).
    """
    B, F = face_vertices_image_scaled.shape[:2]
    H, W = face_idx.shape[1:]
    C = face_features.shape[-1]
    covered = face_idx >= 0                            # (B, H, W)
    gidx = flat_index(torch.clamp(face_idx, min=0), F)
    combined = torch.cat(
        [face_vertices_image_scaled.reshape(B * F, 6),
         face_features.reshape(B * F, 3 * C)], dim=-1)
    rows = gather_rows(combined, gidx)                 # (P, 6 + 3C)
    fv = rows[:, :6].reshape(B, H, W, 3, 2)
    ff = rows[:, 6:].reshape(B, H, W, 3, C)
    w0, w1, w2 = _bary_weights_gathered(fv, xs[None, None, :],
                                        ys[None, :, None], eps)
    weights = torch.stack([w0, w1, w2], dim=-1)        # (B, H, W, 3)
    weights = torch.where(covered[..., None], weights, 0.)
    feats = (weights[..., 0:1] * ff[..., 0, :]
             + weights[..., 1:2] * ff[..., 1, :]
             + weights[..., 2:3] * ff[..., 2, :])
    return feats, weights


def rasterize_selection(height, width, face_vertices_z, face_vertices_image,
                        valid_faces=None, multiplier=None, eps=None,
                        backend='auto'):
    """Run only the (non-differentiable) z-buffer selection pass.

    Returns:
        ``(B, H, W)`` int32 winning-face indices (-1 = background).
    """
    backend = _resolve_backend(backend)
    if multiplier is None:
        multiplier = 1000
    if eps is None:
        eps = 1e-8
    if backend == 'fused':
        return fused_selection(
            face_vertices_z, face_vertices_image, valid_faces, height, width,
            float(multiplier), eps=eps, with_softmask=False).face_idx
    B, F = face_vertices_z.shape[:2]
    if valid_faces is None:
        valid_faces = torch.ones((B, F), dtype=torch.bool,
                                 device=face_vertices_z.device)
    fvz = face_vertices_z.detach()
    fvi_scaled = face_vertices_image.detach() * multiplier
    xs, ys = pixel_coords(height, width, multiplier, dtype=fvz.dtype,
                          device=fvz.device)
    return torch.stack([
        _selection_jnp(fvz[b], fvi_scaled[b], valid_faces[b], xs, ys,
                       height, width, eps) for b in range(B)])


def rasterize(height, width, face_vertices_z, face_vertices_image,
              face_features, valid_faces=None, multiplier=None, eps=None,
              backend='auto', with_weights=False,
              precomputed_face_idx=None):
    """Differentiable rasterization of triangle meshes to feature images.

    Args:
        height, width: output image size.
        face_vertices_z: ``(B, F, 3)`` camera-space z of face vertices
            (camera looks down -z: larger z = closer).
        face_vertices_image: ``(B, F, 3, 2)`` image-plane positions in
            [-1, 1] (y up).
        face_features: ``(B, F, 3, C)`` per-face-vertex features, or a list
            of such (concatenated and re-split).
        valid_faces: optional ``(B, F)`` bool mask.
        multiplier: coordinate scale to avoid numeric issues (default 1000).
        eps: barycentric normalization epsilon (default 1e-8).
        backend: 'jnp' (brute force), 'fused', or 'auto' (= 'fused').
        with_weights: also return the per-pixel barycentric weights.
        precomputed_face_idx: ``(B, H, W)`` selection to reuse.

    Returns:
        (image_features ``(B, H, W, C)`` [or tuple], face_idx
        ``(B, H, W)`` int32 with -1 for background[, weights
        ``(B, H, W, 3)``]).
    """
    if multiplier is None:
        multiplier = 1000
    if eps is None:
        eps = 1e-8
    is_list = isinstance(face_features, (list, tuple))
    features = (torch.cat(list(face_features), dim=-1) if is_list
                else face_features)

    fvi_scaled = face_vertices_image * multiplier
    xs, ys = pixel_coords(height, width, multiplier,
                          dtype=face_vertices_z.dtype,
                          device=face_vertices_z.device)

    if precomputed_face_idx is not None:
        face_idx = precomputed_face_idx.detach()
    else:
        face_idx = rasterize_selection(
            height, width, face_vertices_z, face_vertices_image,
            valid_faces, multiplier, eps, backend)

    image_features, weights = _interpolate_selected_batched(
        face_idx, fvi_scaled, features, xs, ys, eps)

    if is_list:
        out = []
        cur = 0
        for f in face_features:
            out.append(image_features[..., cur:cur + f.shape[-1]])
            cur += f.shape[-1]
        image_features = tuple(out)
    if with_weights:
        return image_features, face_idx, weights
    return image_features, face_idx
