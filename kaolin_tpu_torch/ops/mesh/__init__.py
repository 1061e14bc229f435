from kaolin_tpu_torch.ops.mesh.mesh import (  # noqa: F401
    index_vertices_by_faces, compute_vertex_normals)
from kaolin_tpu_torch.ops.mesh.trianglemesh import face_normals  # noqa: F401
from kaolin_tpu_torch.ops.mesh.tetmesh import (  # noqa: F401
    inverse_vertices_offset, subdivide_tetmesh)
