from hso_tpu_torch.cameras.base import AbstractCamera  # noqa: F401
from hso_tpu_torch.cameras.models import (  # noqa: F401
    EquidistantCamera,
    FOVCamera,
    PinholeCamera,
    projection_model,
)
