"""UNet configs of the model families the port runs beside the flagship.

``CELEBAHQ_UNET`` is the 256x256 family: the ``UNet2DModel`` config of
``google/ddpm-celebahq-256``, whose checkpoints the dataset configs
``celeba-hq``, ``celeba-hq-256-30k`` and ``lsun-bedrooms`` name
(``config/datasets.py``). Built by ``models.unet.unet_from_config`` it has
``HIGHRES_PARAMS_M`` million parameters and, per forward, the attention
blocks and GroupNorms of ``HIGHRES_CALLS``: six blocks of one head of 512
channels (five at 16 x 16, the mid block at 8 x 8) and 71 GroupNorms.
"""

CELEBAHQ_UNET = {
    "block_out_channels": [128, 128, 256, 256, 512, 512],
    "down_block_types": ["DownBlock2D", "DownBlock2D", "DownBlock2D",
                         "DownBlock2D", "AttnDownBlock2D", "DownBlock2D"],
    "up_block_types": ["UpBlock2D", "AttnUpBlock2D", "UpBlock2D",
                       "UpBlock2D", "UpBlock2D", "UpBlock2D"],
    "layers_per_block": 2,
    "attention_head_dim": None,  # one head per attention block
    "dropout": 0.0, "norm_eps": 1e-6, "freq_shift": 1,
    "flip_sin_to_cos": False, "downsample_padding": 0,
}
HIGHRES_SIZE = 256
HIGHRES_PARAMS_M = 113.67
HIGHRES_CALLS = {"attention": 6, "group_norm": 71}  # per forward
