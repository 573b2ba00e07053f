"""The serving core the port needs: request/result types, SLO config and
the ``LLMProxy`` event loop (copies of the JAX package's framework-free
modules, importing nothing of it)."""
from repro_torch.core.llm_proxy import InferenceEngine, LLMProxy  # noqa: F401
from repro_torch.core.slo import SLOConfig  # noqa: F401
from repro_torch.core.types import (  # noqa: F401
    GenerationRequest, GenerationResult, Rejected, RolloutTask)
