"""Carry the JAX package's UNet2D parameters into the port.

:func:`from_flax_params` takes the JAX package's nested parameter dict (of
numpy arrays, or anything ``np.asarray`` accepts) and returns the port's
state dict, ready for ``UNet2D.load_state_dict``. It is the inverse of the
JAX package's diffusers importer (``models/diffusers_import.py``:
``_map_module_path`` and ``_LEAF_MAP``), kept here as a port-local copy:

  conv_in / conv_out / conv_norm_out     -> same
  time_embedding.linear_{1,2}            -> same
  down_{i}_resnet_{j} / down_{i}_attn_{j} -> down_blocks.{i}.resnets.{j} /
                                            down_blocks.{i}.attentions.{j}
  down_{i}_downsample                    -> down_blocks.{i}.downsamplers.0
  mid_resnet_{k} / mid_attn              -> mid_block.resnets.{k} /
                                            mid_block.attentions.0
  up_{i}_resnet_{j} / up_{i}_attn_{j}    -> up_blocks.{i}.resnets.{j} /
                                            up_blocks.{i}.attentions.{j}
  up_{i}_upsample                        -> up_blocks.{i}.upsamplers.0
  attention to_out                       -> to_out.0

Leaves: conv kernel HWIO -> weight OIHW; dense kernel (in, out) -> weight
(out, in); norm ``scale`` -> ``weight``; ``bias`` -> ``bias``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

_MODULE_RULES = [
    (re.compile(r"^down_(\d+)_resnet_(\d+)$"), r"down_blocks.\1.resnets.\2"),
    (re.compile(r"^down_(\d+)_attn_(\d+)$"), r"down_blocks.\1.attentions.\2"),
    (re.compile(r"^down_(\d+)_downsample$"), r"down_blocks.\1.downsamplers.0"),
    (re.compile(r"^mid_resnet_(\d+)$"), r"mid_block.resnets.\1"),
    (re.compile(r"^mid_attn$"), r"mid_block.attentions.0"),
    (re.compile(r"^up_(\d+)_resnet_(\d+)$"), r"up_blocks.\1.resnets.\2"),
    (re.compile(r"^up_(\d+)_attn_(\d+)$"), r"up_blocks.\1.attentions.\2"),
    (re.compile(r"^up_(\d+)_upsample$"), r"up_blocks.\1.upsamplers.0"),
    (re.compile(r"^(conv_in|conv_out|conv_norm_out|time_embedding)$"), r"\1"),
]


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for name, node in tree.items():
        if isinstance(node, Mapping):
            yield from _leaves(node, prefix + (name,))
        else:
            yield prefix + (name,), node


def _map_module(top: str) -> str:
    for pat, repl in _MODULE_RULES:
        if pat.match(top):
            return pat.sub(repl, top)
    raise KeyError(f"unmapped JAX module name: {top}")


def _map_leaf(leaf: str, val: np.ndarray) -> Tuple[str, np.ndarray]:
    if leaf == "kernel" and val.ndim == 4:
        return "weight", np.transpose(val, (3, 2, 0, 1))  # HWIO -> OIHW
    if leaf == "kernel" and val.ndim == 2:
        return "weight", np.transpose(val, (1, 0))  # (in, out) -> (out, in)
    if leaf == "scale" and val.ndim == 1:
        return "weight", val
    if leaf == "bias" and val.ndim == 1:
        return "bias", val
    raise KeyError(f"unmapped JAX leaf {leaf!r} of rank {val.ndim}")


def from_flax_params(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX UNet2D parameter tree -> the port's UNet2D state dict (fp32 CPU
    tensors; ``load_state_dict`` casts and moves them into the model)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, val in _leaves(params):
        top, *mid, leaf = path
        val = np.asarray(val, dtype=np.float32)
        mid = ["to_out.0" if m == "to_out" else m for m in mid]
        name, arr = _map_leaf(leaf, val)
        key = ".".join([_map_module(top), *mid, name])
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    return sd
