from kaolin_tpu_torch.ops import mesh  # noqa: F401
