"""The UNet over a mesh's model axis: tensor (channel) and spatial (row)
parallelism.

Counterpart of ``pdm_tpu/parallel/mesh.py::unet_with_tp`` and
``unet_with_sp``, where GSPMD partitions one program from sharding
annotations. Nothing partitions the port's UNet, whose kernels are ctypes
calls, so :class:`ModelParallelUNet` runs each layer on this rank's shard
and puts the collectives in by hand (``parallel/collectives.py``, over the
mesh's ``model_group``, counted in ``Mesh.model_stats``). The ranks of one
model group hold the same images and split their work:

* ``"channel"``: every weight of two or more dims whose output channels
  divide by m (the model axis's size) holds this rank's output channels,
  as JAX's ``params_sharding`` places them; biases and GroupNorm scales
  are whole and each rank uses its channels of them. An activation whose
  channels divide by m holds this rank's channels. A conv or a dense layer
  all-gathers its input's channels, then computes its own output channels
  (``conv_in``, the resnets' convs, shortcuts and time projections,
  ``Downsample``, ``Upsample``, ``to_q/k/v`` and ``to_out``, the time
  embedding's MLP). A layer whose output channels do not divide (``conv_out``'s
  3) is whole and computed whole, on every rank, from the gathered input,
  and so is everything else of that width. GroupNorm (rows 3 and 4) runs on
  the rank's channels and ``G / m`` groups when m divides G (whole groups
  are local: no collective); otherwise on the gathered channels, keeping
  its own. Attention (rows 1 and 2) runs on the rank's heads when m
  divides the heads; otherwise q, k and v are gathered and each rank
  attends over its ``B / m`` images (all of them when m does not divide
  B), then the images are gathered. The input and the output are whole.
* ``"spatial"``: parameters are whole; an activation holds this rank's
  contiguous rows of the image (NCHW dim 2) at every level whose height
  divides by m, and the whole image at a level whose height does not
  (every rank then computes that level whole). 3x3 convs exchange one
  halo row with each neighbour (zeros at the image's edges; ``Downsample``
  one row from one side, the next rank for diffusers' ``downsample_padding``
  0, the previous one for 1; ``Upsample`` after its nearest x2). GroupNorm
  runs rows 3s and 4s: per-rank sums, an fp32 all-reduce of the (B, G, 2)
  sums, then the normalise (``ops/groupnorm.py::split_group_norm_act``).
  Attention gathers the rows, every rank runs the whole block on the whole
  image (rows 1 and 2 at the full T), and keeps its rows: the blocks sit at
  the lowest resolutions, where the compute is smallest, and the gather is
  the one JAX's GSPMD makes there. The input and the output are the rank's
  rows.

Every collective's backward is its transpose (an all-gather's is an
all-reduce, then this rank's slice), which makes each rank's gradient of a
whole input its own part of the sum over the ranks. The trainer therefore
gives each rank 1/m of the loss (the loss of its replicated output under
``"channel"``, the mean over its rows under ``"spatial"``): a sharded
weight's gradient is then complete on its rank, and a whole leaf's is this
rank's part, summed over the model group (``diffusion/trainer.py``).
Randomness does not depend on m: dropout masks are drawn in the whole
activation's shape (and the global batch's, through ``core/draws.py``)
and each rank keeps its channels or rows.

The whole-block attention kernels (rows 5 and 6, ``PDM_FUSED_BLOCK=1``) are
refused under a model axis, at construction and at every call.

The module runs the UNet's own traversal (``models/unet.py::run_unet``,
``ResnetBlock.forward``) with a layout of this module (:class:`_Channel`,
:class:`_Spatial`) in place of one process's, so a change to the network
is made once. It keeps the UNet's parameter names; ``load_state_dict``
takes a whole state dict and keeps this rank's part of each tensor, and
:meth:`ModelParallelUNet.whole_state_dict` gathers them back. It copies
no weight it keeps whole: those tensors are the UNet's own (under
"spatial", all of them), and only the leaves it cuts are new tensors,
this rank's slices.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from ..ops.groupnorm import fused_group_norm_act, split_group_norm_act
from ..models.unet import (
    Layout, UNet2D, _cl, _from_bsc, _to_bsc, attend, copy_layers, dropout,
    run_unet,
)
from .collectives import all_gather_dim, gather_along, halo_rows
from .mesh import Spec, port_params_sharding, shard_leaf

PARTITIONS = ("channel", "spatial")


def refuse_fused_block() -> None:
    """The whole-block kernels take whole images and all heads: refused
    under a model axis."""
    if os.environ.get("PDM_FUSED_BLOCK", "0") == "1":
        raise ValueError(
            "PDM_FUSED_BLOCK=1: the whole attention block's kernels (rows 5 "
            "and 6) do not run under a model axis (parallel.model_axis > 1); "
            "unset PDM_FUSED_BLOCK")


class _Act:
    """An activation: this rank's shard (``split``) or the whole tensor;
    ``whole`` caches the gathered tensor where one was made."""

    __slots__ = ("t", "split", "whole")

    def __init__(self, t: Tensor, split: bool, whole: Optional[Tensor] = None):
        self.t, self.split, self.whole = t, split, whole


class _Layout(Layout):
    """What the two partitions share: the model group and its counters.
    Their ops take and return :class:`_Act`s."""

    def __init__(self, mp: "ModelParallelUNet"):
        self.mp = mp
        self.m, self.r = mp.model_size, mp.model_index
        self.group, self.stats = mp.model_group, mp.model_stats

    def gather(self, t: Tensor, dim: int) -> Tensor:
        return gather_along(t, dim, self.group, self.m, self.r, self.stats)

    def own(self, t: Tensor, dim: int) -> Tensor:
        n = t.shape[dim] // self.m
        return t.narrow(dim, self.r * n, n)

    def add(self, a: _Act, b: _Act) -> _Act:
        if a.split != b.split:
            raise ValueError("a residual of two layouts")
        return _Act(a.t + b.t, a.split)

    def add_temb(self, h: _Act, proj: nn.Linear, temb: Tensor) -> _Act:
        t = self.linear(proj, _Act(F.silu(temb).to(proj.weight.dtype), False))
        return _Act(h.t + t.t[:, :, None, None], h.split)

    def dropout(self, a: _Act, rate: float, generator) -> _Act:
        """The whole activation's mask (its global batch's through
        ``core/draws.py``), cut as the activation is."""
        cut = (self.dim, self.m, self.r) if a.split else None
        return _Act(dropout(a.t, rate, generator, cut), a.split)


class _Channel(_Layout):
    """Tensor parallelism: activations hold this rank's channels."""

    dim = 1

    def whole(self, a: _Act) -> Tensor:
        if not a.split:
            return a.t
        if a.whole is None:
            dim = 1 if a.t.ndim == 4 else -1
            w = self.gather(a.t, dim)
            a.whole = _cl(w) if w.ndim == 4 else w
        return a.whole

    def local(self, t: Tensor, dim: int = 1) -> _Act:
        """``t`` (whole) as an activation: this rank's channels when they
        divide, else whole."""
        if t.shape[dim] % self.m:
            return _Act(t, False)
        o = self.own(t, dim)
        return _Act(_cl(o) if o.ndim == 4 else o, True, whole=t)

    def enter(self, x: Tensor) -> _Act:
        return _Act(x, False)

    def _weight(self, layer):
        """(weight, bias) of a layer as this rank uses them, and whether
        its output is sharded."""
        sharded = self.mp.is_sharded(layer.weight)
        b = layer.bias
        if sharded and b is not None:
            b = self.own(b, 0)
        return layer.weight, b, sharded

    def conv(self, conv: nn.Conv2d, a: _Act) -> _Act:
        w, b, sharded = self._weight(conv)
        y = F.conv2d(self.whole(a), w, b, conv.stride, conv.padding)
        return _Act(y, sharded)

    def linear(self, lin: nn.Linear, a: _Act) -> _Act:
        w, b, sharded = self._weight(lin)
        return _Act(F.linear(self.whole(a), w, b), sharded)

    def norm(self, gn, a: _Act) -> _Act:
        G = gn.num_groups
        _, C, H, W = a.t.shape
        if a.split and G % self.m == 0:
            y = fused_group_norm_act(_to_bsc(a.t), self.own(gn.weight, 0),
                                     self.own(gn.bias, 0), G // self.m, gn.eps,
                                     gn.act)
            return _Act(_from_bsc(y, H, W), True)
        x = self.whole(a)
        y = _from_bsc(fused_group_norm_act(_to_bsc(x), gn.weight, gn.bias, G,
                                           gn.eps, gn.act), H, W)
        return self.local(y) if a.split else _Act(y, False)

    def cat(self, a: _Act, b: _Act) -> _Act:
        xc = _cl(torch.cat([self.whole(a), self.whole(b)], dim=1))
        return self.local(xc) if a.split or b.split else _Act(xc, False)

    def attention(self, blk, a: _Act) -> _Act:
        _, _, H, W = a.t.shape
        h = _to_bsc(_cl(self.whole(self.norm(blk.group_norm, a))))
        sharded = self.mp.is_sharded(blk.to_q.weight)
        # the weights hold this rank's rows where sharded; so its biases
        q, k, v = blk.qkv(h, (lambda b: self.own(b, 0)) if sharded else
                          (lambda b: b))
        heads = blk.heads
        if sharded and heads % self.m == 0:
            # the rank's channels of q, k and v are its heads
            out = self.gather(attend(q, k, v, heads // self.m, blk.scale), -1)
        elif sharded:
            q, k, v = (self.gather(t.contiguous(), -1) for t in (q, k, v))
            B = q.shape[0]
            if B % self.m == 0:  # each rank attends over its images
                q, k, v = (self.own(t, 0).contiguous() for t in (q, k, v))
                out = self.gather(attend(q, k, v, heads, blk.scale), 0)
            else:
                q, k, v = (t.contiguous() for t in (q, k, v))
                out = attend(q, k, v, heads, blk.scale)
        else:
            out = attend(q, k, v, heads, blk.scale)
        o = self.linear(blk.to_out[0], _Act(out, False))
        return self.add(a, _Act(_from_bsc(o.t, H, W), o.split))

    def down(self, ds, a: _Act) -> _Act:
        x = self.whole(a)
        if ds.padding == 0:
            x = _cl(F.pad(x, (0, 1, 0, 1)))
        return self.conv(ds.conv, _Act(x, False))

    def up(self, us, a: _Act) -> _Act:
        x = F.interpolate(self.whole(a), scale_factor=2.0, mode="nearest")
        return self.conv(us.conv, _Act(x, False))

    def time_embedding(self, te, t_sin: Tensor) -> Tensor:
        h = self.linear(te.linear_1, _Act(t_sin, False))
        h = _Act(F.silu(h.t), h.split)
        return self.whole(self.linear(te.linear_2, h))

    def exit(self, a: _Act) -> Tensor:
        return self.whole(a)


class _Spatial(_Layout):
    """Spatial parallelism: activations hold this rank's image rows."""

    dim = 2

    def whole(self, a: _Act) -> Tensor:
        if not a.split:
            return a.t
        if a.whole is None:
            a.whole = _cl(self.gather(a.t, 2))
        return a.whole

    def level(self, t: Tensor) -> _Act:
        """A whole activation at its level's layout: this rank's rows where
        m divides the height, else whole."""
        if t.shape[2] % self.m:
            return _Act(t, False)
        return _Act(_cl(self.own(t, 2)), True, whole=t)

    def enter(self, x: Tensor) -> _Act:
        return _Act(x, True)

    def halo(self, t: Tensor, top: int, bottom: int) -> Tensor:
        return _cl(halo_rows(t, 2, top, bottom, self.group, self.m, self.r,
                             self.stats))

    def conv(self, conv: nn.Conv2d, a: _Act) -> _Act:
        k = conv.kernel_size[0]
        if not a.split or k == 1:
            return _Act(conv(a.t), a.split)
        if conv.stride != (1, 1) or conv.padding != (k // 2, k // 2):
            raise ValueError(f"no row-split form of {conv}")
        x = self.halo(a.t, k // 2, k // 2)
        return _Act(F.conv2d(x, conv.weight, conv.bias, 1, (0, k // 2)), True)

    def linear(self, lin: nn.Linear, a: _Act) -> _Act:
        return _Act(lin(a.t), False)

    def norm(self, gn, a: _Act) -> _Act:
        _, C, H, W = a.t.shape
        if a.split:
            y = split_group_norm_act(_to_bsc(a.t), gn.weight, gn.bias,
                                     gn.num_groups, gn.eps, gn.act, self.group,
                                     self.m, self.stats)
        else:
            y = fused_group_norm_act(_to_bsc(a.t), gn.weight, gn.bias,
                                     gn.num_groups, gn.eps, gn.act)
        return _Act(_from_bsc(y, H, W), a.split)

    def cat(self, a: _Act, b: _Act) -> _Act:
        return _Act(_cl(torch.cat([a.t, b.t], dim=1)), a.split)

    def attention(self, blk, a: _Act) -> _Act:
        return self.level(blk(self.whole(a))) if a.split else _Act(blk(a.t), False)

    def down(self, ds, a: _Act) -> _Act:
        conv = ds.conv
        if a.split and a.t.shape[2] % 2 == 0 and ds.padding in (0, 1):
            if ds.padding == 0:  # diffusers' (0, 1, 0, 1) pad: the next rank's row
                x = _cl(F.pad(self.halo(a.t, 0, 1), (0, 1, 0, 0)))
                pad = (0, 0)
            else:  # symmetric pad 1: the previous rank's row
                x, pad = self.halo(a.t, 1, 0), (0, 1)
            return _Act(F.conv2d(x, conv.weight, conv.bias, 2, pad), True)
        return self.level(ds(self.whole(a)))

    def up(self, us, a: _Act) -> _Act:
        if a.split:
            x = _Act(F.interpolate(a.t, scale_factor=2.0, mode="nearest"), True)
            return self.conv(us.conv, x)
        return self.level(us(a.t))

    def exit(self, a: _Act) -> Tensor:
        return a.t


class ModelParallelUNet(nn.Module):
    """A ``UNet2D`` partitioned over the model axis of ``mesh``
    (``partition`` "channel" or "spatial"; see the module docstring),
    holding this rank's parameters under the UNet's names. ``forward(x,
    tau, generator)`` takes and returns whole images under "channel" and
    this rank's rows of them under "spatial". The tensors it keeps whole
    are ``net``'s own, shared: a write to one is a write to the other."""

    def __init__(self, net: UNet2D, mesh, partition: str = "channel"):
        super().__init__()
        if partition not in PARTITIONS:
            raise ValueError(
                f"unknown model partition {partition!r} (channel|spatial)")
        if mesh.model_size <= 1:
            raise ValueError("a model-parallel UNet needs a model axis of 2 "
                             "or more ranks")
        refuse_fused_block()
        self.partition = partition
        self.mesh = mesh
        self.model_size, self.model_index = mesh.model_size, mesh.model_index
        self.model_group, self.model_stats = mesh.model_group, mesh.model_stats
        self.dtype = net.dtype
        self.freq_shift, self.flip_sin_to_cos = net.freq_shift, net.flip_sin_to_cos
        for name, child in copy_layers(net).named_children():
            self.add_module(name, child)
        self.specs: Dict[str, Spec] = port_params_sharding(
            {n: tuple(p.shape) for n, p in net.named_parameters()}, mesh,
            partition)
        with torch.no_grad():
            for name, spec in self.specs.items():
                if "model" not in spec:
                    continue
                owner, leaf = self._owner(name)
                p = nn.Parameter(_cl_like(shard_leaf(
                    getattr(owner, leaf).data, spec, mesh, ("model",)).clone(),
                    getattr(owner, leaf).data))
                setattr(owner, leaf, p)
        self._sharded = {id(p) for n, p in self.named_parameters()
                         if "model" in self.specs[n]}
        self.train(net.training)

    def _owner(self, name: str):
        prefix, _, leaf = name.rpartition(".")
        return self.get_submodule(prefix), leaf

    def is_sharded(self, p: Tensor) -> bool:
        """``p`` holds this rank's output channels (tensor parallelism)."""
        return id(p) in self._sharded

    def local_state(self, state: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """This rank's part of each tensor of a whole state dict."""
        return {k: (shard_leaf(v, self.specs[k], self.mesh, ("model",))
                    if k in self.specs else v) for k, v in state.items()}

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """A whole state dict (the UNet's); each rank keeps its part."""
        return super().load_state_dict(self.local_state(state_dict), strict,
                                       assign)

    @torch.no_grad()
    def whole_state_dict(self) -> Dict[str, Tensor]:
        """The UNet's whole parameters, gathered over the model group."""
        out = {}
        for name, p in self.named_parameters():
            spec = self.specs[name]
            if "model" in spec:
                p = all_gather_dim(p.detach().contiguous(), self.model_group,
                                   self.model_size, spec.index("model"),
                                   self.model_stats)
            out[name] = p.detach()
        return out

    def forward(self, x: Tensor, tau: Tensor,
                generator: Optional[torch.Generator] = None) -> Tensor:
        refuse_fused_block()
        layout = (_Channel if self.partition == "channel" else _Spatial)(self)
        return run_unet(self, layout, x, tau, generator)


def _cl_like(t: Tensor, like: Tensor) -> Tensor:
    """``t`` in ``like``'s memory format (channels_last for conv weights)."""
    if like.ndim == 4 and like.is_contiguous(memory_format=torch.channels_last):
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()
