from kaolin_tpu_torch.io.usd.usda import UsdaStage, parse_usda  # noqa: F401
from kaolin_tpu_torch.io.usd.mesh import (  # noqa: F401
    import_mesh, import_meshes, add_mesh, export_mesh, export_meshes,
    create_stage, get_scene_paths)
from kaolin_tpu_torch.io.usd.pointcloud import (  # noqa: F401
    import_pointcloud, import_pointclouds, add_pointcloud,
    export_pointcloud, export_pointclouds)
from kaolin_tpu_torch.io.usd.materials import (  # noqa: F401
    export_material, import_material)
from kaolin_tpu_torch.io.usd.voxelgrid import (  # noqa: F401
    import_voxelgrid, import_voxelgrids, add_voxelgrid,
    export_voxelgrid, export_voxelgrids)
from kaolin_tpu_torch.io.usd.utils import (  # noqa: F401
    get_authored_time_samples, open_stage)
from kaolin_tpu_torch.io.usd.pointcloud import (  # noqa: F401
    get_pointcloud_scene_paths, get_pointcloud_bracketing_time_samples)
from kaolin_tpu_torch.io.usd.mesh import (  # noqa: F401
    get_raw_mesh_prim_geometry, get_mesh_prim_materials)
