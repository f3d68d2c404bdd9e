from .attention import (
    attention_reference as attention_reference,
    fused_spatial_attention as fused_spatial_attention,
)
from .groupnorm import (
    fused_group_norm_act as fused_group_norm_act,
    group_norm_reference as group_norm_reference,
)
