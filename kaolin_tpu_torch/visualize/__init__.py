from kaolin_tpu_torch.visualize.timelapse import Timelapse, TimelapseParser  # noqa: F401
