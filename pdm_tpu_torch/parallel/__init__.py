from .distributed import (
    initialize_multihost as initialize_multihost,
    sharded_sampler as sharded_sampler,
)
from .mesh import (
    batch_sharding as batch_sharding,
    make_mesh as make_mesh,
    params_sharding as params_sharding,
    replicated as replicated,
    shard_batch as shard_batch,
    shard_params as shard_params,
    unet_with_model_parallel as unet_with_model_parallel,
    unet_with_sp as unet_with_sp,
    unet_with_tp as unet_with_tp,
)
