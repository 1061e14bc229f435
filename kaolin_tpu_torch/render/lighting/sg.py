"""Spherical gaussians lighting: GGX specular + diffuse (DIB-R++).

Port of ``kaolin_tpu/render/lighting/sg.py``.  The inner products are
plain broadcasts and reductions with autograd, as in the JAX package (no
fused kernel: none of these functions reaches a Pallas kernel there).
Every clip goes through :func:`kaolin_tpu_torch._clip.clip`, so gradients
at a bound (a normal at right angles to the view, zero albedo) equal the
JAX package's.
"""

import math

import torch

from kaolin_tpu_torch._clip import clip

__all__ = [
    'sg_distribution_term',
    'sg_warp_distribution',
    'sg_warp_specular_term',
    'cosine_lobe_sg',
    'approximate_sg_integral',
    'sg_irradiance_fitted',
    'sg_diffuse_fitted',
    'sg_irradiance_inner_product',
    'sg_diffuse_inner_product',
    'unbatched_sg_inner_product',
    'unbatched_reduced_sg_inner_product',
    'fresnel',
]


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def _reflect(direction, normal):
    return direction - 2 * _dot(direction, normal) * normal


def _ggx_v1(m2, n_dot_x):
    """Smith visibility helper for the GGX distribution."""
    return 1. / (n_dot_x + torch.sqrt(m2 + (1. - m2) * n_dot_x * n_dot_x))


def fresnel(ldh, spec_albedo):
    """Schlick fresnel."""
    pow_term = (1. - ldh) ** 5
    return spec_albedo + (1. - spec_albedo) * pow_term


def sg_distribution_term(direction, roughness):
    """Single-lobe SG approximation of the GGX NDF.

    Args:
        direction: ``(N, 3)`` normals.
        roughness: ``(N,)``.

    Returns:
        (amplitude ``(N, 3)``, direction, sharpness ``(N,)``).
    """
    m2 = roughness * roughness
    sharpness = 2. / m2
    amplitude = (1. / (math.pi * m2))[:, None].expand(direction.shape)
    return amplitude, direction, sharpness


def sg_warp_distribution(amplitude, direction, sharpness, view):
    """Warp an NDF SG into the BRDF slice along the view."""
    warp_direction = _reflect(-view, direction)
    warp_sharpness = sharpness / (
        4. * clip(_dot(direction, view)[..., 0], 1e-4))
    return amplitude, warp_direction, warp_sharpness


def cosine_lobe_sg(direction):
    """Clamped-cosine lobe approximated as an SG."""
    amplitude = torch.full_like(direction, 1.17)
    sharpness = torch.full_like(direction[:, 0], 2.133)
    return amplitude, direction, sharpness


def approximate_sg_integral(amplitude, sharpness):
    """Approximate full-sphere SG integral."""
    return 2. * math.pi * (amplitude / sharpness[..., None])


def unbatched_sg_inner_product(amplitude, direction, sharpness,
                               other_amplitude, other_direction,
                               other_sharpness):
    """SG inner product, all lhs x rhs pairs.

    Returns:
        ``(num_sg, num_other, 3)``.
    """
    a = amplitude[:, None]            # (S, 1, 3)
    d = direction[:, None]
    s = sharpness[:, None, None]
    oa = other_amplitude[None]        # (1, O, 3)
    od = other_direction[None]
    os_ = other_sharpness[None, :, None]
    dm_vec = s * d + os_ * od
    dm = torch.sqrt(_dot(dm_vec, dm_vec))
    lm = s + os_
    expo = torch.exp(dm - lm) * (a * oa)
    other = 1.0 - torch.exp(-2.0 * dm)
    return 2.0 * math.pi * expo * other / dm


def unbatched_reduced_sg_inner_product(amplitude, direction, sharpness,
                                       other_amplitude, other_direction,
                                       other_sharpness):
    """``unbatched_sg_inner_product(...).sum(1)``.

    Returns:
        ``(num_sg, 3)``.
    """
    return unbatched_sg_inner_product(
        amplitude, direction, sharpness,
        other_amplitude, other_direction, other_sharpness).sum(dim=1)


def sg_warp_specular_term(amplitude, direction, sharpness, normal,
                          roughness, view, spec_albedo):
    """Cook-Torrance specular reflectance from SG radiance.

    Args:
        amplitude / direction / sharpness: incoming-radiance SGs.
        normal: ``(N, 3)``; roughness ``(N,)``; view ``(N, 3)``;
        spec_albedo ``(N, 3)``.

    Returns:
        ``(N, 3)`` specular reflectance.
    """
    ndf_amplitude, ndf_direction, ndf_sharpness = sg_distribution_term(
        normal, roughness)
    ndf_amplitude, ndf_direction, ndf_sharpness = sg_warp_distribution(
        ndf_amplitude, ndf_direction, ndf_sharpness, view)
    ndl = clip(_dot(normal, ndf_direction), 0., 1.)
    ndv = clip(_dot(normal, view), 0., 1.)
    h = ndf_direction + view
    h = h / torch.sqrt(_dot(h, h))
    ldh = clip(_dot(ndf_direction, h), 0., 1.)

    output = unbatched_reduced_sg_inner_product(
        ndf_amplitude, ndf_direction, ndf_sharpness,
        amplitude, direction, sharpness)
    m2 = (roughness * roughness)[:, None]
    output = output * _ggx_v1(m2, ndl) * _ggx_v1(m2, ndv)
    output = output * fresnel(ldh, spec_albedo)
    output = output * ndl
    return clip(output, 0.)


def sg_irradiance_fitted(amplitude, direction, sharpness, normal):
    """Irradiance via Stephen Hill's fitted polynomial.

    Returns:
        ``(num_points, num_sg, 3)``.
    """
    mu_n = normal @ direction.t()     # (N, S)
    lbda = sharpness[None, :]

    c0 = 0.36
    c1 = 1. / (4. * c0)
    eml = torch.exp(-lbda)
    em2l = eml * eml
    rl = 1. / lbda
    scale = 1. + 2. * em2l - rl
    bias = (eml - em2l) * rl - em2l
    x = torch.sqrt(1. - scale)
    x0 = c0 * mu_n
    x1 = c1 * x
    n = x0 + x1
    y = torch.where(torch.abs(x0) <= x1, n * n / x, clip(mu_n, 0., 1.))
    result = scale * y + bias
    return result[..., None] * approximate_sg_integral(
        amplitude, sharpness)[None]


def sg_diffuse_fitted(amplitude, direction, sharpness, normal, albedo):
    """Lambertian diffuse radiance via fitted irradiance."""
    brdf = albedo / math.pi
    return clip(sg_irradiance_fitted(amplitude, direction, sharpness,
                                     normal).mean(dim=1), 0.) * brdf


def sg_irradiance_inner_product(amplitude, direction, sharpness, normal):
    """Irradiance via cosine-lobe SG inner product."""
    lobe_amplitude, lobe_direction, lobe_sharpness = cosine_lobe_sg(normal)
    return clip(unbatched_reduced_sg_inner_product(
        lobe_amplitude, lobe_direction, lobe_sharpness,
        amplitude, direction, sharpness), 0.)


def sg_diffuse_inner_product(amplitude, direction, sharpness, normal,
                             albedo):
    """DIB-R++ diffuse reflectance."""
    brdf = albedo / math.pi
    return sg_irradiance_inner_product(
        amplitude, direction, sharpness, normal) * brdf
