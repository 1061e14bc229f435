from kaolin_tpu_torch.ops.conversions.trianglemesh import (  # noqa: F401
    unbatched_mesh_to_spc, unbatched_mesh_to_spc_device)
