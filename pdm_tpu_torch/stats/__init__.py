from .sweep import (
    forward_stats as forward_stats,
    metric_stats as metric_stats,
    thermo_sweep as thermo_sweep,
)
