from kaolin_tpu_torch.io import materials  # noqa: F401
from kaolin_tpu_torch.io import obj  # noqa: F401
from kaolin_tpu_torch.io import off  # noqa: F401
from kaolin_tpu_torch.io import usd  # noqa: F401
from kaolin_tpu_torch.io import utils  # noqa: F401
