from repro_torch.models.config import ModelConfig  # noqa: F401
from repro_torch.models.api import ModelAPI, get_api  # noqa: F401
