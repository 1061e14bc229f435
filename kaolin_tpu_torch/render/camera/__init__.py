from kaolin_tpu_torch.render.camera.camera import Camera, allclose  # noqa: F401,E501
from kaolin_tpu_torch.render.camera.extrinsics import CameraExtrinsics  # noqa: F401,E501
from kaolin_tpu_torch.render.camera.extrinsics_backends import (  # noqa: F401
    available_backends, ExtrinsicsRep, register_backend)
from kaolin_tpu_torch.render.camera.intrinsics import (  # noqa: F401
    CameraFOV, CameraIntrinsics, up_to_homogeneous, down_from_homogeneous)
from kaolin_tpu_torch.render.camera.intrinsics_pinhole import (  # noqa: F401
    PinholeIntrinsics, PinholeParamsDefEnum)
from kaolin_tpu_torch.render.camera.intrinsics_ortho import (  # noqa: F401
    OrthographicIntrinsics, OrthoParamsDefEnum)
from kaolin_tpu_torch.render.camera.legacy import (  # noqa: F401
    rotate_translate_points, generate_rotate_translate_matrices,
    generate_transformation_matrix,
    perspective_camera, generate_perspective_projection)
from kaolin_tpu_torch.render.camera.coordinates import (  # noqa: F401
    blender_coords, opengl_coords)
