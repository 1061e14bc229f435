from kaolin_tpu_torch.ops.mesh.mesh import (  # noqa: F401
    index_vertices_by_faces, adjacency_matrix, uniform_laplacian,
    compute_vertex_normals)
from kaolin_tpu_torch.ops.mesh.trianglemesh import (  # noqa: F401
    face_areas, packed_face_areas, sample_points, packed_sample_points,
    face_normals, subdivide_trianglemesh)
from kaolin_tpu_torch.ops.mesh.tetmesh import (  # noqa: F401
    inverse_vertices_offset, subdivide_tetmesh)
from kaolin_tpu_torch.ops.mesh.check_sign import check_sign  # noqa: F401
