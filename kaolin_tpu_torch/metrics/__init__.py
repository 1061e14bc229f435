from kaolin_tpu_torch.metrics import render  # noqa: F401
