from repro_torch.train.optimizer import OptConfig, adamw_update, init_opt_state  # noqa: F401
from repro_torch.train.trainer import (  # noqa: F401
    HostTrainer, TrainerConfig, make_logprob_fn, make_train_state, make_train_step)
from repro_torch.train.critic import (  # noqa: F401
    init_value_head, make_critic_train_state, make_critic_train_step, value_apply)
