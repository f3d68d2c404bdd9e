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
read the same (B, S, C) memory the JAX kernels read. An attention block
runs the attention kernel inside JAX's geometry gate
(``ops.attention.use_fused_attention``) and JAX's XLA-branch computation
outside it (one head of 256 channels, say). With ``PDM_FUSED_BLOCK=1``
(opt-in, as in the JAX package) an attention block whose shape the
whole-block kernels take runs ``ops/attention_block.py``'s kernel instead
of its projections, attention and residual add.

The model takes continuous ``tau in [0, 1]``. It is differentiable: both
kernels carry their own backward kernels (``autograd.Function``s in
``ops/``). It is built in eval mode; in train mode (``.train()``) the
resnets apply dropout after norm2's SiLU, as the JAX module does with
``deterministic=False``, with masks drawn from the ``torch.Generator``
passed to ``forward`` (never from the global RNG).

Weights stay resident in ``dtype``: the forward adds no casts, so
sampling launches nothing extra. A trainer keeps fp32 master copies and
refreshes these weights after each step (``diffusion/trainer.py``), which
is flax's fp32 parameters cast at use, written out.
"""

from __future__ import annotations

import copy
import itertools
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..core.device import DeviceLike, resolve_device
from ..core.draws import batch_rand
from ..ops.attention import (
    attention_reference, fused_spatial_attention, use_fused_attention,
)
from ..ops.attention_block import (
    fused_attention_block, kernels_take, use_fused_attention_block,
)
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


def dropout(h: Tensor, rate: float, generator: Optional[torch.Generator],
            cut: Optional[Tuple[int, int, int]] = None) -> Tensor:
    """flax ``nn.Dropout`` on an NCHW activation: keep each element with
    probability 1 - rate and divide the kept ones by it. The mask is drawn
    from ``generator`` in NHWC order (the layout the JAX module masks); a
    ``core.draws.SlicedGenerator`` draws the global batch's masks and keeps
    this rank's. ``cut = (dim, m, r)``: ``h`` is the r-th of m equal
    slices of the whole activation along NCHW ``dim``; the mask is drawn
    at the whole activation's shape and cut the same way."""
    if generator is None:
        raise ValueError("dropout in train mode draws its masks from an "
                         "explicit torch.Generator: pass generator=")
    keep_prob = 1.0 - rate
    if keep_prob <= 0.0:
        return torch.zeros_like(h)
    shape = list(h.shape)
    if cut is not None:
        shape[cut[0]] *= cut[1]
    B, C, H, W = shape
    keep = (batch_rand((B, H, W, C), generator, device=h.device)
            < keep_prob).permute(0, 3, 1, 2)
    if cut is not None:
        dim, _, r = cut
        n = h.shape[dim]
        keep = keep.narrow(dim, r * n, n)
    return torch.where(keep, h / keep_prob,
                       torch.zeros((), dtype=h.dtype, device=h.device))


def _to_bsc(x: Tensor) -> Tensor:
    """NCHW (channels_last) -> (B, H*W, C), a view when channels_last."""
    B, C, H, W = x.shape
    return x.permute(0, 2, 3, 1).reshape(B, H * W, C)


def _from_bsc(y: Tensor, H: int, W: int) -> Tensor:
    """(B, H*W, C) contiguous -> NCHW view in channels_last memory."""
    B, _, C = y.shape
    return y.reshape(B, H, W, C).permute(0, 3, 1, 2)


def _cl(t: Tensor) -> Tensor:
    return t.contiguous(memory_format=torch.channels_last)


def attend(q: Tensor, k: Tensor, v: Tensor, heads: int, scale: float) -> Tensor:
    """Multi-head attention of (B, T, C) q, k, v: row 1 inside JAX's
    geometry gate (``ops.attention.use_fused_attention``), else JAX's XLA
    branch (pdm_tpu/models/unet.py:238-254): fp32 logits and softmax, P
    cast to the module dtype, P v in it."""
    if use_fused_attention(q.shape[1], q.shape[2], heads):
        return fused_spatial_attention(q, k, v, heads, scale)
    return attention_reference(q, k, v, heads, scale)


class Layout:
    """How the UNet's traversal (:func:`run_unet`) runs each op. This one
    is one process's: whole tensors, each layer its module's call.
    ``parallel/model_parallel.py``'s layouts run the same traversal on a
    rank's shard of each activation, with the collectives put in."""

    def enter(self, x: Tensor):
        return x

    def exit(self, h) -> Tensor:
        return h

    def time_embedding(self, te: nn.Module, t_sin: Tensor) -> Tensor:
        return te(t_sin)

    def conv(self, conv: nn.Conv2d, h):
        return conv(h)

    def norm(self, gn: nn.Module, h):
        return gn(h)

    def add_temb(self, h, proj: nn.Linear, temb: Tensor):
        """``h`` plus the resnet's projection of the time embedding."""
        return h + proj(F.silu(temb).to(proj.weight.dtype))[:, :, None, None]

    def dropout(self, h, rate: float, generator):
        return dropout(h, rate, generator)

    def add(self, a, b):
        return a + b

    def cat(self, a, b):
        return _cl(torch.cat([a, b], dim=1))

    def attention(self, blk: nn.Module, h):
        return blk(h)

    def down(self, ds: nn.Module, h):
        return ds(h)

    def up(self, us: nn.Module, h):
        return us(h)


WHOLE = Layout()


def copy_layers(module: nn.Module,
                convert: Optional[Callable[[Tensor], Tensor]] = None
                ) -> nn.Module:
    """A copy of ``module``'s layers whose parameters and buffers are
    ``module``'s own tensors (shared, not copied), or ``convert`` of each
    (``lambda t: t.to("meta")``: the layers without storage)."""
    memo = {}
    for t in itertools.chain(module.parameters(), module.buffers()):
        new = t
        if convert is not None:
            new = convert(t.detach())
            if isinstance(t, nn.Parameter):
                new = nn.Parameter(new, requires_grad=t.requires_grad)
        memo[id(t)] = new
    return copy.deepcopy(module, memo)


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
        self.dropout_rate = dropout
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1, **kw)
        self.conv_shortcut = (
            nn.Conv2d(in_channels, out_channels, 1, **kw)
            if in_channels != out_channels else None
        )

    def forward(self, x: Tensor, temb: Tensor,
                generator: Optional[torch.Generator] = None,
                layout: Layout = WHOLE) -> Tensor:
        L = layout
        h = L.conv(self.conv1, L.norm(self.norm1, x))
        h = L.norm(self.norm2, L.add_temb(h, self.time_emb_proj, temb))
        if self.training and self.dropout_rate > 0.0:
            h = L.dropout(h, self.dropout_rate, generator)
        h = L.conv(self.conv2, h)
        if self.conv_shortcut is not None:
            x = L.conv(self.conv_shortcut, x)
        return L.add(x, h)


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

    def qkv(self, h: Tensor,
            bias: Callable[[Tensor], Tensor] = lambda b: b) -> List[Tensor]:
        """q, k, v of (B, T, C) ``h`` from one (B*T, C) x (C, 3C')
        projection: its column thirds, which the kernel reads in place
        (token rows 3C' apart). ``bias`` gives the part of each bias the
        weights' rows go with."""
        layers = (self.to_q, self.to_k, self.to_v)
        w = torch.cat([lin.weight for lin in layers])
        b = torch.cat([bias(lin.bias) for lin in layers])
        return F.linear(h, w, b).chunk(3, dim=-1)

    def forward(self, x: Tensor) -> Tensor:
        _, C, H, W = x.shape
        T = H * W
        h = _to_bsc(self.group_norm(x))
        if (use_fused_attention_block(T, C, self.heads)
                and kernels_take(T, C, self.heads)):
            # the opt-in whole-block kernel (PDM_FUSED_BLOCK=1): projections,
            # attention, out projection and residual in one call, the
            # weights read in place; a shape its kernels do not take runs
            # the standard path below
            proj = self.to_out[0]
            out = fused_attention_block(
                _to_bsc(x), h, self.to_q.weight, self.to_k.weight,
                self.to_v.weight,
                (self.to_q.bias, self.to_k.bias, self.to_v.bias),
                proj.weight, proj.bias, self.heads, self.scale)
            return _from_bsc(out, H, W)
        q, k, v = self.qkv(h)
        # to_out.1 is diffusers' Dropout(0.0)
        out = self.to_out[0](attend(q, k, v, self.heads, self.scale))
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
    mode (dropout off; ``.train()`` turns it on, and ``forward`` then
    needs the ``generator`` its masks come from).
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

    def forward(self, x: Tensor, tau: Tensor,
                generator: Optional[torch.Generator] = None) -> Tensor:
        return run_unet(self, WHOLE, x, tau, generator)


def run_unet(net: nn.Module, layout: Layout, x: Tensor, tau: Tensor,
             generator: Optional[torch.Generator] = None) -> Tensor:
    """The UNet's traversal: ``net``'s layers (a ``UNet2D``'s, or a
    model-parallel UNet's, which hold the same names) in order, each op
    run by ``layout``. The output is fp32."""
    L = layout
    temb = L.time_embedding(net.time_embedding, sinusoidal_time_embedding(
        tau, net.conv_in.out_channels, flip_sin_to_cos=net.flip_sin_to_cos,
        freq_shift=net.freq_shift))
    h = L.conv(net.conv_in, L.enter(_cl(x.to(net.dtype))))
    skips = [h]
    for block in net.down_blocks:
        for j, res in enumerate(block.resnets):
            h = res(h, temb, generator, L)
            a = block.attention(j)
            if a is not None:
                h = L.attention(a, h)
            skips.append(h)
        if hasattr(block, "downsamplers"):
            h = L.down(block.downsamplers[0], h)
            skips.append(h)

    mid = net.mid_block
    h = mid.resnets[0](h, temb, generator, L)
    if mid.attention(0) is not None:
        h = L.attention(mid.attention(0), h)
    h = mid.resnets[1](h, temb, generator, L)

    for block in net.up_blocks:
        for j, res in enumerate(block.resnets):
            h = res(L.cat(h, skips.pop()), temb, generator, L)
            a = block.attention(j)
            if a is not None:
                h = L.attention(a, h)
        if hasattr(block, "upsamplers"):
            h = L.up(block.upsamplers[0], h)

    h = L.conv(net.conv_out, L.norm(net.conv_norm_out, h))
    return L.exit(h).float()


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
