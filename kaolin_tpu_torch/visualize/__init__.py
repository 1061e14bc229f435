from kaolin_tpu_torch.visualize.timelapse import Timelapse, TimelapseParser  # noqa: F401
from kaolin_tpu_torch.visualize.ipython import (  # noqa: F401
    BaseIpyVisualizer, IpyTurntableVisualizer, IpyFirstPersonVisualizer,
    update_canvas, conjugate, make_quaternion_rotation, mulqq, mulqv,
    rotate_around_axis)
