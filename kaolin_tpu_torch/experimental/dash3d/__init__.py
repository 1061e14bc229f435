from kaolin_tpu_torch.experimental.dash3d.util import (  # noqa: F401
    StreamingGeometryHelper, serialize_arrays, deserialize_arrays)
