from hso_tpu_torch.cameras.base import AbstractCamera  # noqa: F401
from hso_tpu_torch.cameras.models import PinholeCamera  # noqa: F401
