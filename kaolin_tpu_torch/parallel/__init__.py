"""Multi-GPU execution on ``torch.distributed``: the port of
``kaolin_tpu/parallel``.  Importing it starts no process group."""
from kaolin_tpu_torch.parallel.sharding import (  # noqa: F401
    make_mesh, shard_views, replicate, multi_view_grad)
from kaolin_tpu_torch.parallel import distributed  # noqa: F401
from kaolin_tpu_torch.parallel.tile import tile_sharded_selection  # noqa: F401
