from kaolin_tpu_torch.ops.spc.uint8 import (  # noqa: F401
    uint8_to_bits, bits_to_uint8, uint8_bits_sum)
from kaolin_tpu_torch.ops.spc.points import (  # noqa: F401
    quantize_points, unbatched_points_to_octree, points_to_morton,
    morton_to_points, points_to_corners, coords_to_trilinear,
    coords_to_trilinear_coeffs, unbatched_interpolate_trilinear,
    create_dense_spc)
from kaolin_tpu_torch.ops.spc.spc import (  # noqa: F401
    scan_octrees, generate_points, unbatched_get_level_points,
    unbatched_query, to_dense, feature_grids_to_spc, unbatched_make_dual,
    unbatched_make_trinkets)
from kaolin_tpu_torch.ops.spc.convolution import (  # noqa: F401
    conv3d, conv_transpose3d, Conv3d, ConvTranspose3d, from_jax_params)
