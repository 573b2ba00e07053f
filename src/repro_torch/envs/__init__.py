from repro_torch.envs.base import BaseEnv  # noqa: F401
from repro_torch.envs.sim_envs import GridTargetEnv, LatencyEnv  # noqa: F401
