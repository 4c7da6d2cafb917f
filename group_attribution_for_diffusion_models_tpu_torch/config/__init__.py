from . import constants  # noqa: F401
from .registry import (  # noqa: F401
    OptimizerSpec,
    SchedulerSpec,
    TrainSpec,
    UNetSpec,
    VQVAESpec,
    WorkloadConfig,
    get_config,
)
