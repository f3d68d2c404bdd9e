from .base import DDPM as DDPM
from .predictions import (
    Predictions as Predictions,
    convert_prediction as convert_prediction,
    training_target as training_target,
)
from .unet import UNet2D as UNet2D, unet_from_config as unet_from_config
from .unet_ddpm import UNetDDPM as UNetDDPM
from .weights import from_flax_params as from_flax_params
