from repro_torch.rollout.engine import DecodeEngine  # noqa: F401
from repro_torch.rollout.paged_engine import PagedDecodeEngine  # noqa: F401
from repro_torch.rollout.sampler import sample_tokens  # noqa: F401
