from kaolin_tpu_torch.rep.spc import Spc  # noqa: F401
from kaolin_tpu_torch.rep.surface_mesh import SurfaceMesh  # noqa: F401
