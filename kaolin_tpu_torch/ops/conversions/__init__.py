from kaolin_tpu_torch.ops.conversions.trianglemesh import (  # noqa: F401
    trianglemeshes_to_voxelgrids, unbatched_mesh_to_spc,
    unbatched_mesh_to_spc_device)
from kaolin_tpu_torch.ops.conversions.pointcloud import (  # noqa: F401
    pointclouds_to_voxelgrids, unbatched_pointcloud_to_spc)
from kaolin_tpu_torch.ops.conversions.sdf import sdf_to_voxelgrids  # noqa: F401
from kaolin_tpu_torch.ops.conversions.tetmesh import marching_tetrahedra  # noqa: F401,E501
from kaolin_tpu_torch.ops.conversions.voxelgrid import (  # noqa: F401
    voxelgrids_to_cubic_meshes, voxelgrids_to_trianglemeshes)
