from kaolin_tpu_torch.utils import testing  # noqa: F401
from kaolin_tpu_torch.utils import profiler  # noqa: F401
