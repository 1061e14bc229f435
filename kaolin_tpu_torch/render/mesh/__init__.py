from kaolin_tpu_torch.render.mesh.rasterization import (  # noqa: F401
    rasterize, rasterize_selection)
from kaolin_tpu_torch.render.mesh.dibr import (  # noqa: F401
    dibr_soft_mask, dibr_rasterization)
from kaolin_tpu_torch.render.mesh._fused import (  # noqa: F401
    FusedSelection, fused_selection, softmask_fused)
from kaolin_tpu_torch.render.mesh.utils import (  # noqa: F401
    texture_mapping, spherical_harmonic_lighting, prepare_vertices)
