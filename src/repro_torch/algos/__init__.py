from repro_torch.algos.advantages import (  # noqa: F401
    gae, group_normalized_advantage, reward_normalize, sequence_to_token_advantage)
from repro_torch.algos.off_policy import LossConfig, VARIANTS, policy_loss, kl_k3  # noqa: F401
from repro_torch.algos.grpo import rl_loss, token_logprobs  # noqa: F401
