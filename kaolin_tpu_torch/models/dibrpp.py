"""DIB-R++: shape, material and spherical-Gaussian lights fitted together.

Chen et al., "DIB-R++: Learning to Predict Lighting and Material with a
Hybrid Differentiable Renderer" (NeurIPS 2021, arXiv:2111.00140), in its
rasterization mode, on the DIB-R step of :mod:`.inverse_render`.  The
parameters are the mesh's vertices, a material map whose channels 0-2 are
the diffuse albedo and channel 3 the GGX roughness, and ``LOBES``
spherical-Gaussian lights (amplitude, azimuth, elevation, sharpness; the
direction is :func:`~kaolin_tpu_torch.ops.coords.spherical2cartesian` of
the two angles).  :func:`render_loss` takes the step as
:func:`.inverse_render.render_loss` does, with another shading:

1. the selection (K1) of :func:`.inverse_render.compute_selection` and the
   projection of :func:`.inverse_render._prepare`;
2. the soft silhouette (K2's backward);
3. each pixel's uv, world-space face normal and world position,
   interpolated by its face's barycentric weights (E3 scatters the face
   rows' gradients back);
4. the material map sampled bilinearly at the uv (E1 / E2); the roughness
   clipped to ``ROUGHNESS``;
5. the view direction, ``normalize(eye - x)``;
6. the SG diffuse term (a cosine lobe's inner product with every light,
   times albedo / pi) plus the warped-SG GGX specular term with Schlick
   fresnel at ``SPEC_ALBEDO``, both of
   :mod:`kaolin_tpu_torch.render.lighting.sg`;
7. clipped to [0, 1], 0 on the background;
8. ``mean |image - target| + 1 - mean IoU`` of the soft silhouettes.

Step 6 runs over every pixel of every view, (B*H*W, LOBES, 3) at a time,
with fixed shapes and nothing read back, so the step captures in
:func:`.inverse_render.compiled_step`'s CUDA graph (``loss_fn=
render_loss``).  A background pixel takes its view direction as its
normal, which keeps the specular term's half vector finite there; its
colour is then masked out.  The chain is one autograd Function
(:class:`_SGShading`) whose forward opens the span ``dibr.sg`` and whose
backward opens ``dibr.sg_backward`` around autograd's backward of the
same PyTorch ops, so a trace of the step shows both on the card's
timeline, also in the graph's replays.
"""

from typing import NamedTuple

import torch
from torch import nn

from kaolin_tpu_torch._clip import clip
from kaolin_tpu_torch.metrics.render import mask_iou
from kaolin_tpu_torch.models import inverse_render as IR
from kaolin_tpu_torch.ops.coords import spherical2cartesian
from kaolin_tpu_torch.ops.mesh import face_normals, index_vertices_by_faces
from kaolin_tpu_torch.render.lighting import sg
from kaolin_tpu_torch.render.mesh._shade import EPS, MULTIPLIER
from kaolin_tpu_torch.render.mesh.rasterization import (
    _interpolate_selected_batched, pixel_coords)
from kaolin_tpu_torch.render.mesh.utils import texture_mapping
from kaolin_tpu_torch.utils.profiler import span

__all__ = ['DIBRPP', 'DIBRPPParams', 'LOBES', 'SPEC_ALBEDO', 'ROUGHNESS',
           'lobe_directions', 'sg_shading', 'render_views', 'render_loss']

LOBES = 32              # the lights: path C's count
SPEC_ALBEDO = 0.04      # Schlick's F0 of a dielectric
ROUGHNESS = (0.1, 1.)   # the roughness map's clip


class DIBRPPParams(NamedTuple):
    """The model's parameters: the state a checkpoint holds."""
    vertices: torch.Tensor      # (V, 3)
    material: torch.Tensor      # (4, TH, TW): albedo 0-2, roughness 3
    amplitude: torch.Tensor     # (LOBES, 3)
    azimuth: torch.Tensor       # (LOBES,)
    elevation: torch.Tensor     # (LOBES,)
    sharpness: torch.Tensor     # (LOBES,)


class DIBRPP(nn.Module):
    """Optimizable parameters of the DIB-R++ model, in the order of
    :class:`DIBRPPParams`."""

    def __init__(self, vertices, material, amplitude, azimuth, elevation,
                 sharpness):
        super().__init__()
        self.vertices = nn.Parameter(vertices)
        self.material = nn.Parameter(material)
        self.amplitude = nn.Parameter(amplitude)
        self.azimuth = nn.Parameter(azimuth)
        self.elevation = nn.Parameter(elevation)
        self.sharpness = nn.Parameter(sharpness)

    def as_params(self):
        """The parameters as a :class:`DIBRPPParams` (the module's own
        tensors, not copies)."""
        return DIBRPPParams(*(getattr(self, n) for n in DIBRPPParams._fields))


def lobe_directions(azimuth, elevation):
    """Unit directions (LOBES, 3) of the lights' angles."""
    return torch.stack(spherical2cartesian(azimuth, elevation), dim=-1)


def _sg_terms(normal, view, albedo, roughness, amplitude, azimuth,
              elevation, sharpness):
    """SG diffuse + GGX specular radiance (P, 3) of P pixels."""
    direction = lobe_directions(azimuth, elevation)
    return (sg.sg_diffuse_inner_product(amplitude, direction, sharpness,
                                        normal, albedo)
            + sg.sg_warp_specular_term(amplitude, direction, sharpness,
                                       normal, roughness, view,
                                       SPEC_ALBEDO))


class _SGShading(torch.autograd.Function):
    """:func:`_sg_terms` with its forward in the span ``dibr.sg`` and its
    backward (autograd's, of the forward's own graph) in
    ``dibr.sg_backward``."""

    @staticmethod
    def forward(ctx, *inputs):
        leaves = [x.detach().requires_grad_(need)
                  for x, need in zip(inputs, ctx.needs_input_grad)]
        with torch.enable_grad(), span('dibr.sg', inputs[0].device):
            out = _sg_terms(*leaves)
        ctx.inner = (leaves, out)
        return out.detach()

    @staticmethod
    def backward(ctx, grad):
        leaves, out = ctx.inner
        del ctx.inner
        wanted = [x for x in leaves if x.requires_grad]
        with span('dibr.sg_backward', grad.device):
            got = iter(torch.autograd.grad(out, wanted, grad,
                                           allow_unused=True))
        return tuple(next(got) if x.requires_grad else None for x in leaves)


def sg_shading(normal, view, albedo, roughness, amplitude, azimuth,
               elevation, sharpness):
    """SG diffuse + GGX specular radiance of P pixels under the lights.

    Args:
        normal, view: (P, 3) unit normals and unit directions to the eye.
        albedo: (P, 3); roughness: (P,).
        amplitude: (LOBES, 3); azimuth, elevation, sharpness: (LOBES,).

    Returns:
        (P, 3), unclipped.
    """
    inputs = (normal, view, albedo, roughness, amplitude, azimuth,
              elevation, sharpness)
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return _SGShading.apply(*inputs)
    with span('dibr.sg', normal.device):
        return _sg_terms(*inputs)


def _render(params, views, faces, face_uvs, selection, with_soft_mask,
            knum):
    """(images (B, H, W, 3), soft mask (B, H, W)) of the selected faces."""
    face_idx = selection[0]
    _, face_vertices_image, _ = IR._prepare(params, views, faces)
    soft_mask = IR._soft_mask(face_vertices_image, selection, with_soft_mask,
                              IR._SIGMAINV, knum)
    B, F = face_vertices_image.shape[:2]
    H, W = face_idx.shape[1:]
    corners = index_vertices_by_faces(params.vertices[None], faces)
    normals = face_normals(corners, unit=True)
    features = torch.cat([face_uvs[None],
                          normals[:, :, None, :].expand(1, F, 3, 3),
                          corners], dim=-1).expand(B, F, 3, 8)
    xs, ys = pixel_coords(H, W, MULTIPLIER, dtype=face_vertices_image.dtype,
                          device=face_vertices_image.device)
    feats, _ = _interpolate_selected_batched(
        face_idx.detach(), face_vertices_image * MULTIPLIER, features, xs, ys,
        EPS)
    uv, normal, position = feats[..., 0:2], feats[..., 2:5], feats[..., 5:8]
    material = texture_mapping(
        uv, params.material[None].expand((B,) + tuple(params.material.shape)),
        mode='bilinear')
    view = views.camera_trans[:, None, None, :] - position
    view = view / torch.sqrt(torch.sum(view * view, dim=-1, keepdim=True))
    covered = (face_idx >= 0)[..., None]
    normal = torch.where(covered, normal, view)
    rgb = sg_shading(normal.reshape(-1, 3), view.reshape(-1, 3),
                     material[..., 0:3].reshape(-1, 3),
                     clip(material[..., 3], *ROUGHNESS).reshape(-1),
                     params.amplitude, params.azimuth, params.elevation,
                     params.sharpness)
    images = torch.where(covered, clip(rgb.reshape(B, H, W, 3), 0., 1.), 0.)
    return images, soft_mask


def render_views(params, views, faces, face_uvs, height, width,
                 backend='auto', with_soft_mask=True, selection=None,
                 knum=30):
    """Render all views under the SG lights.

    Args:
        params: the parameters (a :class:`DIBRPP` or :class:`DIBRPPParams`).
        views: an :class:`.inverse_render.CameraViews` of B views; each
            view's ``camera_trans`` is its eye in world space.
        faces: (F, 3) int; face_uvs: (F, 3, 2).
        selection: :func:`.inverse_render.compute_selection` of these
            parameters; computed here when None.

    Returns:
        (images (B, H, W, 3), soft_mask (B, H, W), face_idx (B, H, W)).
    """
    if selection is None:
        selection = IR.compute_selection(params, views, faces, height, width,
                                         backend, knum=knum)
    images, soft_mask = _render(params, views, faces, face_uvs, selection,
                                with_soft_mask, knum)
    return images, soft_mask, selection[0]


def render_loss(params, views, faces, face_uvs, target_images, target_masks,
                height, width, backend='auto', with_soft_mask=True,
                selection=None, knum=30):
    """``mean |image - target| + 1 - mean IoU`` of :func:`render_views`'
    images and soft mask: :func:`.inverse_render.render_loss`'s loss
    under SG lights, and :func:`.inverse_render.compiled_step`'s
    ``loss_fn`` for a :class:`DIBRPP` model."""
    with span('dibr.render', params.vertices.device):
        if selection is None:
            selection = IR.compute_selection(params, views, faces, height,
                                             width, backend, knum=knum)
        images, soft_mask = _render(params, views, faces, face_uvs,
                                    selection, with_soft_mask, knum)
        return (torch.mean(torch.abs(images - target_images))
                + mask_iou(soft_mask, target_masks))
