from kaolin_tpu_torch.utils import testing  # noqa: F401
