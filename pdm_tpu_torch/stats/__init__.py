from .mc_metric import (
    metric_matrix_diag as metric_matrix_diag,
    metric_scalar as metric_scalar,
    rescaled_metric_diag as rescaled_metric_diag,
)
from .model_metric import (
    empirical_entropy_stats as empirical_entropy_stats,
    integrate_entropy_curves as integrate_entropy_curves,
    model_metric_stats as model_metric_stats,
)
from .sweep import (
    forward_stats as forward_stats,
    metric_stats as metric_stats,
    thermo_sweep as thermo_sweep,
)
