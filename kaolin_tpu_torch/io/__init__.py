from kaolin_tpu_torch.io import dataset  # noqa: F401
from kaolin_tpu_torch.io import materials  # noqa: F401
from kaolin_tpu_torch.io import modelnet  # noqa: F401
from kaolin_tpu_torch.io import obj  # noqa: F401
from kaolin_tpu_torch.io import off  # noqa: F401
from kaolin_tpu_torch.io import render  # noqa: F401
from kaolin_tpu_torch.io import shapenet  # noqa: F401
from kaolin_tpu_torch.io import shrec  # noqa: F401
from kaolin_tpu_torch.io import usd  # noqa: F401
from kaolin_tpu_torch.io import utils  # noqa: F401
from kaolin_tpu_torch.io.dataset import CachedDataset  # noqa: F401
from kaolin_tpu_torch.io.modelnet import ModelNet  # noqa: F401
from kaolin_tpu_torch.io.shapenet import ShapeNetV1, ShapeNetV2  # noqa: F401
from kaolin_tpu_torch.io.shrec import SHREC16  # noqa: F401
