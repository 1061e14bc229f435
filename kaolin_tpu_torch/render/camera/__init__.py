from kaolin_tpu_torch.render.camera.legacy import (  # noqa: F401
    rotate_translate_points, generate_rotate_translate_matrices,
    generate_transformation_matrix,
    perspective_camera, generate_perspective_projection)
