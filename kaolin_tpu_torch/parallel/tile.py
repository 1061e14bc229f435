"""Pixel-tile (image-row) sharding of the rasterizer.

Port of ``kaolin_tpu/parallel/tile.py``: a ``(data, tile)`` mesh, views
data-parallel on one axis and each view's pixel rows split over the other,
so that one large render (BASELINE config #5: 64 views x 1024^2) spreads
over cards.  Rasterization reads every face for every row, so a row slab
needs no halo: each rank tests every face against its own rows.

Each rank is given the whole of every input, as the JAX functions are, and
takes its own views and rows from them.
"""

import torch

from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch.models import inverse_render as M
from kaolin_tpu_torch.render.mesh import (spherical_harmonic_lighting,
                                          texture_mapping)
from kaolin_tpu_torch.render.mesh.dibr import (_SoftMaskEpilogue,
                                               _soft_mask_select)
from kaolin_tpu_torch.render.mesh.rasterization import (
    _interpolate_selected_batched, _selection_jnp, pixel_coords)

__all__ = ['tile_sharded_selection', 'tile_sharded_render_loss']


def _row_slab(mesh, tile_axis, height):
    """(rows per rank, this rank's first row)."""
    n = mesh.shape[tile_axis]
    if height % n:
        raise ValueError(f'height {height} not divisible by tile axis '
                         f'size {n}')
    rows = height // n
    return rows, mesh.axis_index(tile_axis) * rows


def _slab_selection(fvz, fvi_scaled, valid, xs, ys, width, eps):
    """``_selection_jnp`` of every view on the rows ``ys``."""
    return torch.stack([
        _selection_jnp(fvz[b], fvi_scaled[b], valid[b], xs, ys,
                       ys.shape[0], width, eps)
        for b in range(fvz.shape[0])])


class _SumOverRanks(torch.autograd.Function):
    """Forward: the sum of ``x`` over the ranks of ``mesh`` along ``axis``.
    Backward: the identity.

    Every rank back-propagates the same summed loss, so the gradient to its
    own term is the loss's gradient, once.  (``torch.distributed.nn``'s
    all-reduce sums those gradients over the ranks too, which multiplies
    every gradient by the axis size.)"""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.detach().clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GradSummed(torch.autograd.Function):
    """Forward: the identity on the parameters.  Backward: their gradients,
    each rank's part of the loss's, summed over the whole mesh by one
    all-reduce, so that every rank holds the whole gradient (the transpose
    of the JAX package's replicated ``in_specs``)."""

    @staticmethod
    def forward(ctx, mesh, *params):
        ctx.mesh = mesh
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        flat = ctx.mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]))
        out, start = [], 0
        for g in grads:
            out.append(flat[start:start + g.numel()].view_as(g))
            start += g.numel()
        return (None, *out)


def tile_sharded_selection(mesh, face_vertices_z, face_vertices_image,
                           valid_faces, height, width, tile_axis='tile',
                           multiplier=1000., eps=1e-8):
    """Z-buffer selection with image rows sharded over ``tile_axis``.

    Each rank renders its contiguous slab of ``height // ndev`` rows of
    every view (faces given whole to every rank); the slabs are stitched
    into the full ``(B, H, W)`` image on every rank.  Equal to
    :func:`kaolin_tpu_torch.render.mesh.rasterize_selection` with the
    ``'jnp'`` backend.

    Args:
        mesh: a :class:`~kaolin_tpu_torch.parallel.sharding.Mesh` with
            ``tile_axis``.
        face_vertices_z: (B, F, 3) camera z.
        face_vertices_image: (B, F, 3, 2) image coords in [-1, 1].
        valid_faces: (B, F) bool.
        height, width: full image size; ``height`` must divide evenly by
            the tile-axis size.
        tile_axis: mesh axis name to shard rows over.

    Returns:
        (B, H, W) int32 winning-face image (-1 = background).
    """
    rows, lo = _row_slab(mesh, tile_axis, height)
    fvz = face_vertices_z.detach()
    fvi_scaled = face_vertices_image.detach() * multiplier
    xs, ys = pixel_coords(height, width, multiplier, dtype=fvz.dtype,
                          device=fvz.device)
    slab = _slab_selection(fvz, fvi_scaled, valid_faces, xs,
                           ys[lo:lo + rows], width, eps)
    # the stitch: each rank writes its slab, shifted so that background is
    # 0, into an image of zeros, and the sum over the tile axis is the whole
    # image (gloo takes CUDA tensors in all_reduce, not in all_gather)
    full = torch.zeros((fvz.shape[0], height, width), dtype=torch.int32,
                       device=fvz.device)
    full[:, lo:lo + rows] = slab + 1
    return mesh.all_reduce(full, tile_axis) - 1


def tile_sharded_render_loss(mesh, params, views, faces, face_uvs,
                             target_images, target_masks, height, width,
                             data_axis='data', tile_axis='tile',
                             sigmainv=7000., boxlen=0.02, knum=30,
                             multiplier=1000., eps=1e-8):
    """DIB-R textured render loss sharded over a ``(data, tile)`` mesh:
    views data-parallel, each view's image rows split over ``tile_axis``.

    Every stage runs on the rank's own views and row slab: the z-buffer
    selection, the texture and SH epilogue, the soft mask's k-buffer and
    epilogue.  The image L1 sum and each view's IoU numerator and
    denominator are summed over the tile axis before the division, then the
    two loss terms over the data axis (two all-reduces).  ``backward()`` of
    the returned loss leaves on every rank the gradient of the whole loss
    to ``params`` (one more all-reduce, over the mesh).  Equal in value and
    gradients to the one-process
    :func:`~kaolin_tpu_torch.models.inverse_render.render_loss` with
    ``backend='jnp'``.

    Args:
        mesh: Mesh with ``data_axis`` (divides the number of views) and
            ``tile_axis`` (divides ``height``).
        params: ``InverseRenderParams``, the same on every rank.
        views: ``CameraViews`` of every view.
        faces, face_uvs: (F, 3), (F, 3, 2).
        target_images: (B, H, W, 3); target_masks: (B, H, W).

    Returns:
        scalar loss, the same on every rank.
    """
    rows, lo = _row_slab(mesh, tile_axis, height)
    num_views = views.camera_rot.shape[0]
    nd = mesh.shape[data_axis]
    if num_views % nd:
        raise ValueError(f'{num_views} views not divisible by data axis '
                         f'size {nd}')
    B = num_views // nd
    vs = slice(mesh.axis_index(data_axis) * B,
               (mesh.axis_index(data_axis) + 1) * B)
    p = M.InverseRenderParams(*_GradSummed.apply(mesh, *params))
    v = M.CameraViews(views.camera_rot[vs], views.camera_trans[vs],
                      views.camera_proj)
    t_img = target_images[vs, lo:lo + rows]
    t_mask = target_masks[vs, lo:lo + rows]
    xs, ys = pixel_coords(height, width, multiplier,
                          dtype=p.vertices.dtype, device=p.vertices.device)
    ys = ys[lo:lo + rows]

    fvc, fvi, fn = M._prepare(p, v, faces)
    fvi_scaled = fvi * multiplier
    with torch.no_grad():
        face_idx = _slab_selection(fvc[..., 2], fvi_scaled, fn[..., 2] >= 0.,
                                   xs, ys, width, eps)

    F = faces.shape[0]
    feats = torch.cat([face_uvs[None].expand(B, F, 3, 2),
                       fn[:, :, None, :].expand(B, F, 3, 3)], dim=-1)
    img_feats, _ = _interpolate_selected_batched(face_idx, fvi_scaled, feats,
                                                 xs, ys, eps)
    texture = p.texture_map[None].expand((B,) + tuple(p.texture_map.shape))
    albedo = texture_mapping(img_feats[..., :2], texture, mode='bilinear')
    lighting = spherical_harmonic_lighting(img_feats[..., 2:5],
                                           p.sh_coeffs[None].expand(B, 9))
    images = clip(albedo * clip(lighting, 0.)[..., None], 0., 1.)
    images = torch.where((face_idx >= 0)[..., None], images, 0.)

    # soft mask on the slab
    empty = face_idx < 0
    with torch.no_grad():
        bboxes = torch.cat([fvi_scaled.amin(dim=-2) - boxlen * multiplier,
                            fvi_scaled.amax(dim=-2) + boxlen * multiplier],
                           dim=-1)
        kbuf = torch.stack([
            _soft_mask_select(bboxes[b], empty[b], xs, ys, rows, width, knum)
            for b in range(B)])
    soft_mask = _SoftMaskEpilogue.apply(fvi_scaled, kbuf, empty, xs, ys,
                                        float(sigmainv), float(multiplier))

    # the losses as pixel sums, summed over the tile axis
    mul = soft_mask * t_mask
    add = soft_mask + t_mask
    sums = _SumOverRanks.apply(torch.cat([
        torch.sum(torch.abs(images - t_img)).reshape(1),
        torch.sum(mul.reshape(B, -1), dim=1),
        torch.sum((add - mul).reshape(B, -1), dim=1)]), mesh, tile_axis)
    image_loss = sums[0] / (num_views * height * width * 3)
    iou = torch.sum(sums[1:B + 1] / (sums[B + 1:] + 1e-10))
    terms = _SumOverRanks.apply(torch.stack([image_loss, iou]), mesh,
                                data_axis)
    return terms[0] + (1.0 - terms[1] / num_views)
