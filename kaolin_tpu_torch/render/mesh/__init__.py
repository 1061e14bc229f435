from kaolin_tpu_torch.render.mesh.rasterization import (  # noqa: F401
    rasterize, rasterize_selection, fused_backend_supported)
from kaolin_tpu_torch.render.mesh.dibr import (  # noqa: F401
    dibr_soft_mask, dibr_soft_mask_select, dibr_rasterization)
from kaolin_tpu_torch.render.mesh.deftet import (  # noqa: F401
    deftet_sparse_render)
from kaolin_tpu_torch.render.mesh._fused import (  # noqa: F401
    FusedSelection, fused_selection, softmask_fused)
from kaolin_tpu_torch.render.mesh.utils import (  # noqa: F401
    texture_mapping, spherical_harmonic_lighting, prepare_vertices)
