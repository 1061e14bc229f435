"""DIB-R: soft silhouette mask + full differentiable renderer.

Port of ``kaolin_tpu/render/mesh/dibr.py``, fused engine only: one fused
selection pass (:mod:`._fused`) yields both the z-buffer winner and the
soft-mask product, and the soft mask's backward is the fused backward
kernel.  The JAX package's k-buffer path (``dibr_soft_mask_select`` and
its epilogue) is not ported yet.
"""

from kaolin_tpu_torch.render.mesh._fused import (
    FusedSelection, fused_selection, softmask_fused)
from kaolin_tpu_torch.render.mesh.rasterization import (
    _resolve_backend, rasterize)

__all__ = ['dibr_soft_mask', 'dibr_rasterization']

_KBUFFER_TODO = ('the k-buffer soft mask (JAX dibr_soft_mask_select and its '
                 'epilogue) is not ported: it is a ROADMAP open item '
                 '(slice 1, k-buffer backend); pass kbuf=FusedSelection '
                 'from fused_selection')


def dibr_soft_mask(face_vertices_image, selected_face_idx, sigmainv=7000,
                   boxlen=0.02, knum=30, multiplier=1000., kbuf=None):
    """Differentiable soft silhouette mask.

    Args:
        face_vertices_image: ``(B, F, 3, 2)`` image-plane positions in
            [-1, 1].
        selected_face_idx: ``(B, H, W)`` winning face per pixel (-1 = empty).
        sigmainv: sharpness (higher = sharper).
        boxlen: influence margin around each face bbox (used by the
            selection that built ``kbuf``).
        knum: unused by the fused engine (its product is uncapped).
        multiplier: internal coordinate scale.
        kbuf: the :class:`~kaolin_tpu_torch.render.mesh.FusedSelection`
            of the same geometry.

    Returns:
        ``(B, H, W)`` soft mask in [0, 1].
    """
    if not isinstance(kbuf, FusedSelection):
        raise NotImplementedError(_KBUFFER_TODO)
    _, H, W = selected_face_idx.shape
    fvi_scaled = face_vertices_image * multiplier
    return softmask_fused(fvi_scaled, kbuf,
                          (H, W, float(multiplier), float(sigmainv)))


def dibr_rasterization(height, width, face_vertices_z, face_vertices_image,
                       face_features, face_normals_z, sigmainv=7000,
                       boxlen=0.02, knum=30, multiplier=None, eps=None,
                       rast_backend='auto'):
    """Full DIB-R differentiable renderer: rasterize with backface culling
    (``face_normals_z >= 0``) + soft mask.

    Returns:
        (image_features, soft_mask, face_idx).
    """
    _resolve_backend(rast_backend)
    _multiplier = 1000. if multiplier is None else multiplier
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
