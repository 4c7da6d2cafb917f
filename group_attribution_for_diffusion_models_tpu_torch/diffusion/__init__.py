from .sampling import make_sampler, sample_loop, sample_with_trajectory  # noqa: F401
from .schedulers import (  # noqa: F401
    ScheduleState,
    add_noise,
    antithetic_timesteps,
    ddim_step,
    ddpm_step,
    inference_timesteps,
    make_betas,
    make_schedule,
    pred_original_sample,
    velocity_target,
)
