from kaolin_tpu_torch.ops import conversions  # noqa: F401
from kaolin_tpu_torch.ops import mesh  # noqa: F401
from kaolin_tpu_torch.ops import spc  # noqa: F401
