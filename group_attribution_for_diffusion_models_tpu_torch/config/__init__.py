from . import constants  # noqa: F401
from .registry import (  # noqa: F401
    KLVAESpec,
    LoraTrainSpec,
    OptimizerSpec,
    SchedulerSpec,
    TrainSpec,
    UNetSpec,
    VQVAESpec,
    WorkloadConfig,
    get_config,
)
