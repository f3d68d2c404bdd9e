"""InceptionV3 feature extractor (the FID-standard pool-2048 head).

Counterpart of ``pdm_tpu/models/inception.py``. Topology of the
torchvision / FID InceptionV3: a stem of five convolutions and two max
pools, 3x InceptionA, InceptionB, 4x InceptionC, InceptionD, 2x
InceptionE, global average pool -> 2048 features. Each convolution has no
bias and is followed by inference BatchNorm (eps 1e-3) on four plain
buffers (``bn_scale``, ``bn_bias``, ``bn_mean``, ``bn_var``) and a ReLU.

Input contract: NCHW images in [-1, 1]; grayscale is repeated to RGB and
the images are resized to 299 x 299 bilinearly inside the extractor
(``F.interpolate``, half-pixel centres as ``jax.image.resize``, with
antialiasing when shrinking, as ``jax.image.resize`` does). The forward
runs in fp32 with TF32 off for cuDNN (``precision.full_fp32_conv``).

Weights, three ways in and one out:

* ``load_inception`` / ``save_inception``: the JAX package's .npz, keys
  joined with ``/`` such as ``Mixed_5b/branch1x1/conv/kernel`` (HWIO) and
  ``Mixed_5b/branch1x1/bn_scale``;
* ``inception_from_flax_params``: JAX's parameter tree;
* ``convert_torch_state_dict``: a torchvision / pytorch-fid state dict
  (``fc`` and ``AuxLogits`` dropped, ``bn.running_mean`` and friends put
  into the four BN buffers).
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..core.device import DeviceLike, resolve_device
from ..ops.precision import full_fp32_conv

FID_SIZE = 299
BN_EPS = 1e-3
BN_LEAVES = ("bn_scale", "bn_bias", "bn_mean", "bn_var")
_TORCH_BN = {"weight": "bn_scale", "bias": "bn_bias",
             "running_mean": "bn_mean", "running_var": "bn_var"}

Pad = Union[int, Tuple[int, int]]


class ConvBN(nn.Module):
    """Conv (no bias) + inference BatchNorm (eps 1e-3) + ReLU."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int],
                 stride: int = 1, padding: Pad = 0):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride=stride,
                              padding=padding, bias=False)
        for name, value in zip(BN_LEAVES, (1.0, 0.0, 0.0, 1.0)):
            self.register_buffer(name, torch.full((out_ch,), value))

    def forward(self, x: Tensor) -> Tensor:
        x = self.conv(x)
        inv = torch.rsqrt(self.bn_var + BN_EPS) * self.bn_scale
        x = (x - self.bn_mean[:, None, None]) * inv[:, None, None]
        return F.relu(x + self.bn_bias[:, None, None])


def _avg_pool_3x3_same(x: Tensor, fid_variant: bool) -> Tensor:
    """3x3 stride-1 average pool. The FID-standard network (pytorch-fid /
    torchmetrics FIDInceptionA/C/E) leaves the padding out of the count;
    torchvision's inception_v3 counts it."""
    return F.avg_pool2d(x, 3, stride=1, padding=1,
                        count_include_pad=not fid_variant)


def _max_pool_3x3_2(x: Tensor) -> Tensor:
    return F.max_pool2d(x, 3, stride=2)  # VALID padding


class InceptionA(nn.Module):
    def __init__(self, in_ch: int, pool_features: int, fid_variant: bool = True):
        super().__init__()
        self.fid_variant = fid_variant
        self.branch1x1 = ConvBN(in_ch, 64, (1, 1))
        self.branch5x5_1 = ConvBN(in_ch, 48, (1, 1))
        self.branch5x5_2 = ConvBN(48, 64, (5, 5), padding=2)
        self.branch3x3dbl_1 = ConvBN(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), padding=1)
        self.branch_pool = ConvBN(in_ch, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avg_pool_3x3_same(x, self.fid_variant))
        return torch.cat([b1, b5, b3, bp], dim=1)


class InceptionB(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3 = ConvBN(in_ch, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = ConvBN(in_ch, 64, (1, 1))
        self.branch3x3dbl_2 = ConvBN(64, 96, (3, 3), padding=1)
        self.branch3x3dbl_3 = ConvBN(96, 96, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _max_pool_3x3_2(x)], dim=1)


class InceptionC(nn.Module):
    def __init__(self, in_ch: int, channels_7x7: int, fid_variant: bool = True):
        super().__init__()
        c7 = channels_7x7
        self.fid_variant = fid_variant
        self.branch1x1 = ConvBN(in_ch, 192, (1, 1))
        self.branch7x7_1 = ConvBN(in_ch, c7, (1, 1))
        self.branch7x7_2 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7_3 = ConvBN(c7, 192, (7, 1), padding=(3, 0))
        self.branch7x7dbl_1 = ConvBN(in_ch, c7, (1, 1))
        self.branch7x7dbl_2 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_3 = ConvBN(c7, c7, (1, 7), padding=(0, 3))
        self.branch7x7dbl_4 = ConvBN(c7, c7, (7, 1), padding=(3, 0))
        self.branch7x7dbl_5 = ConvBN(c7, 192, (1, 7), padding=(0, 3))
        self.branch_pool = ConvBN(in_ch, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = self.branch7x7dbl_1(x)
        for i in range(2, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avg_pool_3x3_same(x, self.fid_variant))
        return torch.cat([b1, b7, bd, bp], dim=1)


class InceptionD(nn.Module):
    def __init__(self, in_ch: int):
        super().__init__()
        self.branch3x3_1 = ConvBN(in_ch, 192, (1, 1))
        self.branch3x3_2 = ConvBN(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = ConvBN(in_ch, 192, (1, 1))
        self.branch7x7x3_2 = ConvBN(192, 192, (1, 7), padding=(0, 3))
        self.branch7x7x3_3 = ConvBN(192, 192, (7, 1), padding=(3, 0))
        self.branch7x7x3_4 = ConvBN(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool_3x3_2(x)], dim=1)


class InceptionE(nn.Module):
    """The FID-standard Mixed_7c (FIDInceptionE_2) pools its pool branch
    with a stride-1 max pool (padding 1); Mixed_7b and torchvision average."""

    def __init__(self, in_ch: int, pool_mode: str = "avg",
                 fid_variant: bool = True):
        super().__init__()
        self.pool_mode, self.fid_variant = pool_mode, fid_variant
        self.branch1x1 = ConvBN(in_ch, 320, (1, 1))
        self.branch3x3_1 = ConvBN(in_ch, 384, (1, 1))
        self.branch3x3_2a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3_2b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch3x3dbl_1 = ConvBN(in_ch, 448, (1, 1))
        self.branch3x3dbl_2 = ConvBN(448, 384, (3, 3), padding=1)
        self.branch3x3dbl_3a = ConvBN(384, 384, (1, 3), padding=(0, 1))
        self.branch3x3dbl_3b = ConvBN(384, 384, (3, 1), padding=(1, 0))
        self.branch_pool = ConvBN(in_ch, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], dim=1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)],
                       dim=1)
        if self.pool_mode == "max":
            bp = F.max_pool2d(x, 3, stride=1, padding=1)
        else:
            bp = _avg_pool_3x3_same(x, self.fid_variant)
        return torch.cat([b1, b3, bd, self.branch_pool(bp)], dim=1)


def resize_bilinear(x: Tensor, size: Tuple[int, int]) -> Tensor:
    """NCHW bilinear resize as ``jax.image.resize(..., "bilinear")``:
    half-pixel centres, and a triangle filter widened by the scale when
    shrinking (PyTorch's ``antialias``, off when enlarging, where it would
    change nothing in JAX's resize either)."""
    shrink = x.shape[-2] > size[0] or x.shape[-1] > size[1]
    return F.interpolate(x, size=size, mode="bilinear", align_corners=False,
                         antialias=shrink)


class InceptionV3Features(nn.Module):
    """(B, C, H, W) in [-1, 1] -> (B, 2048) pool features.

    ``fid_variant=True`` (the default) is the FID-standard network
    torchmetrics / pytorch-fid evaluate with (count_include_pad=False
    average pools in A/C/E and a max-pool branch in Mixed_7c); False gives
    plain torchvision inception_v3 semantics."""

    def __init__(self, resize_input: bool = True, fid_variant: bool = True):
        super().__init__()
        self.resize_input = resize_input
        fv = fid_variant
        self.Conv2d_1a_3x3 = ConvBN(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = ConvBN(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = ConvBN(32, 64, (3, 3), padding=1)
        self.Conv2d_3b_1x1 = ConvBN(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = ConvBN(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32, fv)
        self.Mixed_5c = InceptionA(256, 64, fv)
        self.Mixed_5d = InceptionA(288, 64, fv)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128, fv)
        self.Mixed_6c = InceptionC(768, 160, fv)
        self.Mixed_6d = InceptionC(768, 160, fv)
        self.Mixed_6e = InceptionC(768, 192, fv)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280, "avg", fv)
        self.Mixed_7c = InceptionE(2048, "max" if fv else "avg", fv)

    def forward(self, x: Tensor) -> Tensor:
        with full_fp32_conv():
            x = x.float()
            if x.shape[1] == 1:
                x = x.repeat(1, 3, 1, 1)
            if self.resize_input and tuple(x.shape[-2:]) != (FID_SIZE, FID_SIZE):
                x = resize_bilinear(x, (FID_SIZE, FID_SIZE))
            # the FID network takes [-1, 1] directly: no normalization
            x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
            x = _max_pool_3x3_2(x)
            x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(x))
            x = _max_pool_3x3_2(x)
            for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a",
                         "Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e",
                         "Mixed_7a", "Mixed_7b", "Mixed_7c"):
                x = getattr(self, name)(x)
            return torch.mean(x, dim=(2, 3))  # global average pool -> 2048


# ---------------------------------------------------------------------------
# weights: JAX's layout, JAX's tree, torchvision's state dict
# ---------------------------------------------------------------------------


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for name, node in tree.items():
        if isinstance(node, Mapping):
            yield from _leaves(node, prefix + (name,))
        else:
            yield prefix + (name,), node


def _port_key(path: Sequence[str], value: np.ndarray
              ) -> Tuple[str, np.ndarray]:
    """A JAX path (..., 'conv', 'kernel') or (..., 'bn_*') -> the port's
    key and value (kernel HWIO -> weight OIHW)."""
    *scope, leaf = path
    if leaf == "kernel":
        return ".".join([*scope, "weight"]), np.transpose(value, (3, 2, 0, 1))
    if leaf in BN_LEAVES:
        return ".".join([*scope, leaf]), value
    raise KeyError(f"unmapped InceptionV3 leaf {'/'.join(path)}")


def inception_from_flax_params(params: Mapping) -> Dict[str, Tensor]:
    """JAX's InceptionV3Features parameter tree -> the port's state dict
    (fp32 CPU tensors)."""
    sd = {}
    for path, val in _leaves(params):
        key, arr = _port_key(path, np.array(val, dtype=np.float32))
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd


def inception_arrays(state_dict: Mapping[str, Tensor]) -> Dict[str, np.ndarray]:
    """The port's state dict under the JAX .npz's keys (HWIO kernels)."""
    out = {}
    for key, val in state_dict.items():
        arr = val.detach().float().cpu().numpy()
        *scope, leaf = key.split(".")
        if leaf == "weight":
            out["/".join([*scope, "kernel"])] = np.transpose(arr, (2, 3, 1, 0))
        else:
            out["/".join([*scope, leaf])] = arr
    return out


def save_inception(model: InceptionV3Features, path: str) -> None:
    np.savez(path, **inception_arrays(model.state_dict()))


def load_inception(path: str, device: DeviceLike = None,
                   **kwargs) -> InceptionV3Features:
    """InceptionV3Features (``kwargs`` to its constructor) with the
    weights of a JAX-layout .npz, on ``device`` (the card unless
    ``device="cpu"``), in eval mode."""
    dev = resolve_device(device)
    sd = {}
    with np.load(path) as raw:
        for key in raw.files:
            k, arr = _port_key(key.split("/"),
                               np.asarray(raw[key], dtype=np.float32))
            sd[k] = torch.from_numpy(np.ascontiguousarray(arr))
    model = InceptionV3Features(**kwargs)
    model.load_state_dict(sd, strict=True)
    return model.to(dev).eval()


def convert_torch_state_dict(state_dict: Mapping[str, object]
                             ) -> Dict[str, Tensor]:
    """A torchvision / pytorch-fid InceptionV3 state dict (tensors or
    arrays) -> the port's state dict: ``fc`` and ``AuxLogits`` dropped,
    ``X.conv.weight`` kept, ``X.bn.{weight,bias,running_mean,running_var}``
    into ``X.bn_{scale,bias,mean,var}``, ``num_batches_tracked`` dropped."""
    sd = {}
    for key, val in state_dict.items():
        parts = key.split(".")
        if parts[0] in ("fc", "AuxLogits"):
            continue
        *scope, mod, leaf = parts
        t = torch.as_tensor(np.asarray(val, dtype=np.float32))
        if mod == "conv" and leaf == "weight":
            sd[key] = t
        elif mod == "bn" and leaf in _TORCH_BN:
            sd[".".join([*scope, _TORCH_BN[leaf]])] = t
    return sd
