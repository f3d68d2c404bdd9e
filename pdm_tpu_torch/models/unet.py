"""UNet2D denoiser in PyTorch — the flagship model of the sampler.

Counterpart of ``pdm_tpu/models/unet.py``: the diffusers ``UNet2DModel``
architecture the reference configures (sinusoidal time embedding, ResNet
blocks with GroupNorm+SiLU, spatial self-attention, zero-pad-right stride-2
downsampling, nearest x2 + conv upsampling, mid block resnet-attn-resnet).

Module names follow diffusers' ``UNet2DModel`` (``down_blocks.{i}.resnets.
{j}.norm1``, ``attentions.{j}.to_q``, ``to_out.0``, ``mid_block``, ...), so
a diffusers state dict loads with ``load_state_dict`` and no renaming.

Compute policy, as the JAX package's: convolutions and projections run in
``dtype`` (bf16 for the flagship); GroupNorm statistics and the time
embedding MLP run in fp32; GroupNorm output is cast to ``dtype``; the
network's output is fp32. Activations are NCHW tensors in
``torch.channels_last`` memory, so ``x.permute(0, 2, 3, 1).reshape(B, H*W,
C)`` is a view and both kernels (``ops/groupnorm.py``, ``ops/attention.py``)
read the same (B, S, C) memory the JAX kernels read.

The model takes continuous ``tau in [0, 1]`` and has no backward kernels
yet: on a CUDA device run it under ``torch.no_grad()``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..core.device import DeviceLike, resolve_device
from ..ops.attention import fused_spatial_attention
from ..ops.groupnorm import fused_group_norm_act


def sinusoidal_time_embedding(
    timesteps: Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = False,
    freq_shift: float = 1.0,
    max_period: float = 10_000.0,
) -> Tensor:
    """Transformer-style sinusoidal embedding of (possibly fractional)
    timesteps; diffusers ``get_timestep_embedding`` semantics."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    exponent = exponent / (half - freq_shift)
    freqs = torch.exp(exponent)
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


def _to_bsc(x: Tensor) -> Tensor:
    """NCHW (channels_last) -> (B, H*W, C), a view when channels_last."""
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, C)


def _from_bsc(y: Tensor, H: int, W: int) -> Tensor:
    """(B, H*W, C) contiguous -> NCHW view in channels_last memory."""
    B, _, C = y.shape
    return y.reshape(B, H, W, C).permute(0, 3, 1, 2)


class TimeEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting the sinusoidal embedding (fp32)."""

    def __init__(self, in_dim: int, embed_dim: int, device=None):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, embed_dim, device=device)
        self.linear_2 = nn.Linear(embed_dim, embed_dim, device=device)

    def forward(self, t_sinusoidal: Tensor) -> Tensor:
        return self.linear_2(F.silu(self.linear_1(t_sinusoidal)))


class GroupNormAct(nn.Module):
    """GroupNorm (+ optional SiLU) through ``fused_group_norm_act`` with
    ``nn.GroupNorm``'s parameter names (``weight``/``bias``, fp32)."""

    def __init__(self, num_groups: int, num_channels: int, eps: float,
                 act: str = "none", device=None):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels, device=device))
        self.bias = nn.Parameter(torch.zeros(num_channels, device=device))

    def forward(self, x: Tensor) -> Tensor:
        _, _, H, W = x.shape
        y = fused_group_norm_act(_to_bsc(x), self.weight, self.bias,
                                 self.num_groups, self.eps, self.act)
        return _from_bsc(y, H, W)


class ResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, temb_channels: int,
                 dropout: float, norm_groups: int, norm_eps: float,
                 dtype: torch.dtype, device=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.norm1 = GroupNormAct(norm_groups, in_channels, norm_eps, "silu",
                                  device=device)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1, **kw)
        self.time_emb_proj = nn.Linear(temb_channels, out_channels, **kw)
        self.norm2 = GroupNormAct(norm_groups, out_channels, norm_eps, "silu",
                                  device=device)
        self.dropout = nn.Dropout(dropout)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, **kw)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1, **kw)
            if in_channels != out_channels else None
        )

    def forward(self, x: Tensor, temb: Tensor) -> Tensor:
        h = self.conv1(self.norm1(x))
        t = self.time_emb_proj(F.silu(temb).to(self.time_emb_proj.weight.dtype))
        h = h + t[:, :, None, None]
        h = self.conv2(self.dropout(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AttentionBlock(nn.Module):
    """Single-image spatial self-attention with a residual connection
    (diffusers ``Attention`` names: group_norm, to_q/k/v, to_out.0)."""

    def __init__(self, channels: int, head_dim: int, norm_groups: int,
                 norm_eps: float, dtype: torch.dtype, device=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.heads = max(1, channels // head_dim)
        self.scale = 1.0 / math.sqrt(channels // self.heads)
        self.group_norm = GroupNormAct(norm_groups, channels, norm_eps, "none",
                                       device=device)
        self.to_q = nn.Linear(channels, channels, **kw)
        self.to_k = nn.Linear(channels, channels, **kw)
        self.to_v = nn.Linear(channels, channels, **kw)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels, **kw),
                                     nn.Dropout(0.0)])

    def forward(self, x: Tensor) -> Tensor:
        _, C, H, W = x.shape
        h = _to_bsc(self.group_norm(x))
        # one (B*T, C) x (C, 3C) projection; q, k, v are its column thirds,
        # which the kernel reads in place (token rows 3C apart)
        w_qkv = torch.cat([self.to_q.weight, self.to_k.weight, self.to_v.weight])
        b_qkv = torch.cat([self.to_q.bias, self.to_k.bias, self.to_v.bias])
        q, k, v = F.linear(h, w_qkv, b_qkv).split(C, dim=-1)
        out = fused_spatial_attention(q, k, v, self.heads, self.scale)
        out = self.to_out[1](self.to_out[0](out))
        return x + _from_bsc(out, H, W)


class Downsample(nn.Module):
    """Stride-2 conv; ``padding=0`` is diffusers' downsample_padding=0
    (asymmetric (0, 1, 0, 1) zero pad, then no conv padding)."""

    def __init__(self, channels: int, padding: int, dtype: torch.dtype,
                 device=None):
        super().__init__()
        self.padding = padding
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=padding,
                              device=device, dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        if self.padding == 0:
            x = F.pad(x, (0, 1, 0, 1)).contiguous(
                memory_format=torch.channels_last)
        return self.conv(x)


class Upsample(nn.Module):
    def __init__(self, channels: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1, device=device,
                              dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """One down/up/mid block: ``resnets``, optional ``attentions`` and an
    optional ``downsamplers``/``upsamplers`` list (diffusers names)."""

    def __init__(self, resnets: List[nn.Module], attentions: List[nn.Module],
                 downsample: Optional[nn.Module] = None,
                 upsample: Optional[nn.Module] = None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if downsample is not None:
            self.downsamplers = nn.ModuleList([downsample])
        if upsample is not None:
            self.upsamplers = nn.ModuleList([upsample])

    def attention(self, j: int) -> Optional[nn.Module]:
        attns = getattr(self, "attentions", None)
        return attns[j] if attns is not None else None


class UNet2D(nn.Module):
    """Config mirror of diffusers UNet2DModel for the reference experiments.

    ``down_block_types``: "DownBlock2D" | "AttnDownBlock2D";
    ``up_block_types``: "UpBlock2D" | "AttnUpBlock2D". Input and output are
    NCHW; the output is fp32. Built on ``device`` (the CUDA card unless
    ``device="cpu"``), with conv/linear weights in ``dtype``, and in eval
    mode (dropout off; ``.train()`` turns it on).
    """

    def __init__(
        self,
        in_channels: int = 3,
        out_channels: int = 3,
        block_out_channels: Sequence[int] = (128, 256, 256, 256),
        down_block_types: Sequence[str] = (
            "DownBlock2D", "AttnDownBlock2D", "DownBlock2D", "DownBlock2D"),
        up_block_types: Sequence[str] = (
            "UpBlock2D", "UpBlock2D", "AttnUpBlock2D", "UpBlock2D"),
        layers_per_block: int = 3,
        attention_head_dim: int = 64,
        dropout: float = 0.2,
        norm_groups: int = 32,
        norm_eps: float = 1e-6,
        freq_shift: float = 1.0,
        flip_sin_to_cos: bool = False,
        add_mid_attention: bool = True,
        downsample_padding: int = 0,
        dtype: torch.dtype = torch.float32,
        device: DeviceLike = None,
    ):
        super().__init__()
        device = resolve_device(device)
        self.dtype = dtype
        self.freq_shift = freq_shift
        self.flip_sin_to_cos = flip_sin_to_cos
        self.layers_per_block = layers_per_block
        ch0 = block_out_channels[0]
        temb_ch = ch0 * 4
        kw = dict(dtype=dtype, device=device)

        def resnet(cin, cout):
            return ResnetBlock(cin, cout, temb_ch, dropout, norm_groups,
                               norm_eps, **kw)

        def attn(ch):
            return AttentionBlock(ch, attention_head_dim, norm_groups,
                                  norm_eps, **kw)

        self.time_embedding = TimeEmbedding(ch0, temb_ch, device=device)
        self.conv_in = nn.Conv2d(in_channels, ch0, 3, padding=1, **kw)

        n_blocks = len(block_out_channels)
        skip_chs = [ch0]
        ch = ch0
        down = []
        for i, (btype, out_ch) in enumerate(
                zip(down_block_types, block_out_channels)):
            resnets, attns = [], []
            for _ in range(layers_per_block):
                resnets.append(resnet(ch, out_ch))
                ch = out_ch
                if btype == "AttnDownBlock2D":
                    attns.append(attn(ch))
                skip_chs.append(ch)
            ds = None
            if i < n_blocks - 1:
                ds = Downsample(ch, downsample_padding, **kw)
                skip_chs.append(ch)
            down.append(_Block(resnets, attns, downsample=ds))
        self.down_blocks = nn.ModuleList(down)

        mid_ch = block_out_channels[-1]
        self.mid_block = _Block(
            [resnet(ch, mid_ch), resnet(mid_ch, mid_ch)],
            [attn(mid_ch)] if add_mid_attention else [],
        )
        ch = mid_ch

        up = []
        for i, btype in enumerate(up_block_types):
            out_ch = block_out_channels[::-1][i]
            resnets, attns = [], []
            for _ in range(layers_per_block + 1):
                resnets.append(resnet(ch + skip_chs.pop(), out_ch))
                ch = out_ch
                if btype == "AttnUpBlock2D":
                    attns.append(attn(ch))
            us = Upsample(ch, **kw) if i < n_blocks - 1 else None
            up.append(_Block(resnets, attns, upsample=us))
        self.up_blocks = nn.ModuleList(up)
        if skip_chs:
            raise ValueError(f"unconsumed skip connections: {len(skip_chs)}")

        self.conv_norm_out = GroupNormAct(norm_groups, ch, norm_eps, "silu",
                                          device=device)
        self.conv_out = nn.Conv2d(ch, out_channels, 3, padding=1, **kw)
        self.to(memory_format=torch.channels_last)
        # no dropout unless asked, as the JAX module's deterministic=True
        self.eval()

    def forward(self, x: Tensor, tau: Tensor) -> Tensor:
        temb = sinusoidal_time_embedding(
            tau, self.conv_in.out_channels,
            flip_sin_to_cos=self.flip_sin_to_cos, freq_shift=self.freq_shift,
        )
        temb = self.time_embedding(temb)

        h = self.conv_in(
            x.to(self.dtype).contiguous(memory_format=torch.channels_last))
        skips = [h]
        for block in self.down_blocks:
            for j, res in enumerate(block.resnets):
                h = res(h, temb)
                a = block.attention(j)
                if a is not None:
                    h = a(h)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)

        mid = self.mid_block
        h = mid.resnets[0](h, temb)
        if mid.attention(0) is not None:
            h = mid.attention(0)(h)
        h = mid.resnets[1](h, temb)

        for block in self.up_blocks:
            for j, res in enumerate(block.resnets):
                h = torch.cat([h, skips.pop()], dim=1).contiguous(
                    memory_format=torch.channels_last)
                h = res(h, temb)
                a = block.attention(j)
                if a is not None:
                    h = a(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)

        h = self.conv_out(self.conv_norm_out(h))
        return h.float()


# diffusers config.json carries metadata/keys with no counterpart in this
# architecture; everything NOT here and not consumed below is an error
# (silently dropping an unknown key would build a different network than
# the config describes)
_IGNORED_UNET_KEYS = {
    "_class_name", "_diffusers_version", "in_channels", "out_channels",
    "sample_size", "num_train_timesteps",
}

# Keys this architecture does not consume but whose NON-default values
# change network behavior (diffusers UNet2DModel semantics), each with its
# accepted (equivalent-to-this-architecture) values.
_DEFAULT_ONLY_UNET_KEYS: Dict[str, tuple] = {
    "act_fn": ("silu",),
    "center_input_sample": (False,),
    "time_embedding_type": ("positional",),
    "resnet_time_scale_shift": ("default",),
    "class_embed_type": (None,),
    "num_class_embeds": (None,),
    "attn_norm_num_groups": (None,),
    "mid_block_scale_factor": (1, 1.0),
}

_KNOWN_UNET_KEYS = {
    "block_out_channels", "down_block_types", "up_block_types",
    "layers_per_block", "attention_head_dim", "dropout", "norm_eps",
    "freq_shift", "flip_sin_to_cos", "downsample_padding",
    "norm_groups", "norm_num_groups", "add_mid_attention", "add_attention",
}


def unet_from_config(
    image_channels: int,
    unet_config: Optional[Dict[str, Any]] = None,
    dtype: torch.dtype = torch.float32,
    device: DeviceLike = None,
) -> UNet2D:
    """Build a UNet2D from a reference-style unet_config dict
    (config/groups/ddpm.yaml keys) or a diffusers UNet2DModel config.json
    dict (norm_num_groups / add_attention spellings accepted)."""
    cfg = dict(unet_config or {})
    unknown = (
        set(cfg) - _KNOWN_UNET_KEYS - _IGNORED_UNET_KEYS
        - set(_DEFAULT_ONLY_UNET_KEYS)
    )
    if unknown:
        raise ValueError(
            f"unet_config keys with no effect on this architecture: "
            f"{sorted(unknown)} (known: {sorted(_KNOWN_UNET_KEYS)})"
        )
    for key, accepted in _DEFAULT_ONLY_UNET_KEYS.items():
        if key in cfg and cfg[key] not in accepted:
            raise ValueError(
                f"unet_config[{key!r}]={cfg[key]!r} is not supported by this "
                f"architecture (accepted: {accepted}); importing such a "
                f"checkpoint would silently build a behaviorally different "
                f"network"
            )
    head_dim = cfg.get("attention_head_dim", 64)
    return UNet2D(
        in_channels=image_channels,
        out_channels=image_channels,
        block_out_channels=tuple(cfg.get("block_out_channels", (128, 256, 256, 256))),
        down_block_types=tuple(cfg.get(
            "down_block_types",
            ("DownBlock2D", "AttnDownBlock2D", "DownBlock2D", "DownBlock2D"))),
        up_block_types=tuple(cfg.get(
            "up_block_types",
            ("UpBlock2D", "UpBlock2D", "AttnUpBlock2D", "UpBlock2D"))),
        layers_per_block=int(cfg.get("layers_per_block", 3)),
        # diffusers semantics: attention_head_dim null => ONE head per
        # attention; a huge head_dim makes heads = max(1, C // head_dim) = 1
        attention_head_dim=1 << 30 if head_dim is None else int(head_dim),
        dropout=float(cfg.get("dropout", 0.2)),
        norm_groups=int(cfg.get("norm_groups", cfg.get("norm_num_groups", 32))),
        norm_eps=float(cfg.get("norm_eps", 1e-6)),
        freq_shift=float(cfg.get("freq_shift", 1.0)),
        flip_sin_to_cos=bool(cfg.get("flip_sin_to_cos", False)),
        add_mid_attention=bool(
            cfg.get("add_mid_attention", cfg.get("add_attention", True))),
        downsample_padding=int(cfg.get("downsample_padding", 0)),
        dtype=dtype,
        device=device,
    )
