from .analytic import (
    CosineScheduler as CosineScheduler,
    LinearBetaScheduler as LinearBetaScheduler,
    LogSNRScheduler as LogSNRScheduler,
)
from .base import Scheduler as Scheduler
from .interpolated import (
    InterpolatedScheduler as InterpolatedScheduler,
    custom_scheduler as custom_scheduler,
    entropy_scheduler as entropy_scheduler,
    entropy_scheduler_from_npz as entropy_scheduler_from_npz,
    extrapolate_entropy as extrapolate_entropy,
    fisher_rao_arc_length as fisher_rao_arc_length,
    from_alpha_bars as from_alpha_bars,
    metric_scheduler as metric_scheduler,
    metric_scheduler_from_npz as metric_scheduler_from_npz,
)
