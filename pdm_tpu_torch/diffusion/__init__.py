from .sampling import (
    DDPMSampler as DDPMSampler,
    discretize_schedule as discretize_schedule,
    get_samples as get_samples,
)
from .trainer import (
    DDPMTrainer as DDPMTrainer,
    TrainState as TrainState,
    warmup_linear_decay as warmup_linear_decay,
)
