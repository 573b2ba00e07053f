"""ROLL Flash core, the port's copy: the paper's contribution.

Fine-grained parallelism (LLMProxy, queue scheduling, prompt replication,
EnvManager pools, the ProxyRouter over N replicas) + rollout-train
decoupling (SampleBuffer with per-sample asynchronous-ratio freshness,
AsyncController with blocking and overlapped weight sync), plus the
theoretical model (Propositions 1 & 2, ``theory``) and the discrete-event
simulator behind the paper-figure benchmarks (``simulator``).  Every
module but ``locks`` is a copy of the JAX package's framework-free module
of the same name, importing nothing of it.
"""
from repro_torch.core.sample_buffer import SampleBuffer, StaleSampleError  # noqa: F401
from repro_torch.core.llm_proxy import InferenceEngine, LLMProxy  # noqa: F401
from repro_torch.core.rollout_client import (  # noqa: F401
    GenerationHandle, GroupHandle, RolloutClient, Session)
from repro_torch.core.router import MultiEvent, ProxyRouter  # noqa: F401
from repro_torch.core.async_controller import AsyncController, StepStats  # noqa: F401
from repro_torch.core.slo import SLOConfig  # noqa: F401
from repro_torch.core.types import (  # noqa: F401
    GenerationRequest, GenerationResult, Rejected, RolloutTask, Sample,
    Trajectory, Turn)
from repro_torch.core import simulator, theory  # noqa: F401
