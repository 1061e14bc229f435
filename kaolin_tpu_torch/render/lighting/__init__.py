from kaolin_tpu_torch.render.lighting.sh import (  # noqa: F401
    project_onto_sh9, sh9_irradiance, sh9_diffuse)
from kaolin_tpu_torch.render.lighting.sg import (  # noqa: F401
    sg_distribution_term, sg_warp_distribution, sg_warp_specular_term,
    cosine_lobe_sg, approximate_sg_integral, sg_irradiance_fitted,
    sg_diffuse_fitted, sg_irradiance_inner_product,
    sg_diffuse_inner_product, unbatched_sg_inner_product,
    unbatched_reduced_sg_inner_product, fresnel)
