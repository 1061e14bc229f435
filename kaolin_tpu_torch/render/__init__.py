from kaolin_tpu_torch.render import camera  # noqa: F401
from kaolin_tpu_torch.render import lighting  # noqa: F401
from kaolin_tpu_torch.render import mesh  # noqa: F401
from kaolin_tpu_torch.render import spc  # noqa: F401
