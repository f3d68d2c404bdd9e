from .analytic import (
    CosineScheduler as CosineScheduler,
    LinearBetaScheduler as LinearBetaScheduler,
    LogSNRScheduler as LogSNRScheduler,
)
from .base import Scheduler as Scheduler
