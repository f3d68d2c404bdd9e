from .attention import (
    attention_bwd as attention_bwd,
    attention_bwd_reference as attention_bwd_reference,
    attention_reference as attention_reference,
    fused_spatial_attention as fused_spatial_attention,
    use_fused_attention as use_fused_attention,
)
from .attention_block import (
    attention_block_bwd as attention_block_bwd,
    attention_block_bwd_reference as attention_block_bwd_reference,
    attention_block_reference as attention_block_reference,
    fused_attention_block as fused_attention_block,
    use_fused_attention_block as use_fused_attention_block,
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
    boltzmann_moments_reference as boltzmann_moments_reference,
    merge_moments as merge_moments,
    true_posterior_mean_x0 as true_posterior_mean_x0,
    true_score as true_score,
)
from .distance import (
    compute_gram_matrix as compute_gram_matrix,
    compute_pw_dist_sqr as compute_pw_dist_sqr,
    norm_sqr as norm_sqr,
)
from .knn import knn_sqdist as knn_sqdist
from .mmd import mmd_rbf as mmd_rbf

# registers the sampler's forward kernels as torch.library custom ops
# (pdm::...), which an exported sampler step calls (ops/library.py)
from . import library as library  # noqa: E402
