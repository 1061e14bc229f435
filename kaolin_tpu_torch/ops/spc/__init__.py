from kaolin_tpu_torch.ops.spc.uint8 import (  # noqa: F401
    uint8_to_bits, bits_to_uint8, uint8_bits_sum)
from kaolin_tpu_torch.ops.spc.points import (  # noqa: F401
    quantize_points, unbatched_points_to_octree, points_to_morton,
    morton_to_points)
from kaolin_tpu_torch.ops.spc.spc import (  # noqa: F401
    scan_octrees, generate_points, unbatched_get_level_points)
