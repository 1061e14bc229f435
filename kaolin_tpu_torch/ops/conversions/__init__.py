from kaolin_tpu_torch.ops.conversions.trianglemesh import (  # noqa: F401
    unbatched_mesh_to_spc, unbatched_mesh_to_spc_device)
from kaolin_tpu_torch.ops.conversions.tetmesh import marching_tetrahedra  # noqa: F401,E501
