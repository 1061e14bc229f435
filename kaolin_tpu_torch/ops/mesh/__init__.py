from kaolin_tpu_torch.ops.mesh.mesh import index_vertices_by_faces  # noqa: F401
from kaolin_tpu_torch.ops.mesh.trianglemesh import face_normals  # noqa: F401
