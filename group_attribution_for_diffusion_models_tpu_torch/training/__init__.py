from .state import (  # noqa: F401
    EnsembleState,
    Optimizer,
    OptState,
    TrainState,
    ema_decay_schedule,
    ema_update,
    init_ensemble_state,
    make_optimizer,
    make_schedule_fn,
    stack_states,
    unstack_state,
)
from .train import (  # noqa: F401
    diffusion_loss,
    make_members_step,
    make_train_step,
    members_loss,
)
