from .sampling import (
    DDPMSampler as DDPMSampler,
    discretize_schedule as discretize_schedule,
    get_samples as get_samples,
)
