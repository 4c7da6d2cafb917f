from .state import (  # noqa: F401
    Optimizer,
    OptState,
    TrainState,
    ema_decay_schedule,
    ema_update,
    make_optimizer,
    make_schedule_fn,
)
from .train import diffusion_loss, make_train_step  # noqa: F401
