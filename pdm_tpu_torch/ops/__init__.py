from .attention import (
    attention_bwd as attention_bwd,
    attention_bwd_reference as attention_bwd_reference,
    attention_reference as attention_reference,
    fused_spatial_attention as fused_spatial_attention,
)
from .groupnorm import (
    fused_group_norm_act as fused_group_norm_act,
    group_norm_bwd as group_norm_bwd,
    group_norm_bwd_reference as group_norm_bwd_reference,
    group_norm_reference as group_norm_reference,
)
from .boltzmann import (
    BoltzmannMoments as BoltzmannMoments,
    boltzmann_moments as boltzmann_moments,
    merge_moments as merge_moments,
)
from .knn import knn_sqdist as knn_sqdist
