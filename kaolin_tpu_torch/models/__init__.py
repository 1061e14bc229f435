from kaolin_tpu_torch.models import inverse_render  # noqa: F401
