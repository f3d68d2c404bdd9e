"""Import pretrained diffusers ``UNet2DModel`` checkpoints into the port's
UNet2D.

Counterpart of ``pdm_tpu/models/diffusers_import.py``. The port's UNet2D
already carries diffusers' parameter names and layouts (NCHW convs,
(out, in) linears), so importing is reading the state dict and renaming
the legacy attention leaves that checkpoints older than diffusers'
Attention refactor store (the ``google/ddpm-*`` ones among them):

  query / key / value / proj_attn  ->  to_q / to_k / to_v / to_out.0

``diffusion_pytorch_model.bin`` is read with ``torch.load(weights_only=
True)``; ``.safetensors`` by :func:`read_safetensors`, which needs no
package: an 8-byte little-endian header length, a JSON header (the
``__metadata__`` entry skipped; ``dtype``, ``shape`` and ``data_offsets``
per tensor), then ``torch.frombuffer`` views of the raw little-endian data
(F32, F16, BF16). :func:`write_safetensors` writes the same format. The
factory loads the result with ``load_state_dict(strict=True)``: unknown or
missing keys and shape mismatches raise.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import torch
from torch import Tensor

_LEGACY = ((".query.", ".to_q."), (".key.", ".to_k."), (".value.", ".to_v."),
           (".proj_attn.", ".to_out.0."))
SAFETENSORS_DTYPES = {"F32": torch.float32, "F16": torch.float16,
                      "BF16": torch.bfloat16}


def rename_legacy_keys(state_dict: Mapping[str, Tensor]) -> Dict[str, Tensor]:
    """The legacy attention leaf names migrated as diffusers' own
    checkpoint-version shim does. The substrings occur only inside
    attention modules, so the replacement is safe."""
    out = {}
    for key, val in state_dict.items():
        for old, new in _LEGACY:
            key = key.replace(old, new)
        if key in out:
            raise KeyError(f"two checkpoint keys map to {key}")
        out[key] = val
    return out


def read_safetensors(path: str) -> Dict[str, Tensor]:
    """A ``.safetensors`` file -> {name: CPU tensor}."""
    with open(path, "rb") as f:
        buf = bytearray(f.read())
    if len(buf) < 8:
        raise ValueError(f"{path}: too short for a safetensors file")
    (n,) = struct.unpack("<Q", buf[:8])
    if 8 + n > len(buf):
        raise ValueError(f"{path}: header length {n} beyond the file")
    header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    base = 8 + n
    data_len = len(buf) - base
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = SAFETENSORS_DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}; read: "
                             f"{sorted(SAFETENSORS_DTYPES)}")
        shape = [int(s) for s in info["shape"]]
        begin, end = (int(o) for o in info["data_offsets"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        count = 1
        for s in shape:
            count *= s
        if not 0 <= begin <= end <= data_len or end - begin != count * itemsize:
            raise ValueError(f"{path}: tensor {name} offsets {begin}..{end} "
                             f"do not hold {shape} {info['dtype']}")
        if count == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=count,
                                     offset=base + begin).reshape(shape)
    return out


def write_safetensors(path: str, tensors: Mapping[str, Tensor]) -> None:
    """{name: tensor} (F32, F16 or BF16) -> a ``.safetensors`` file: names
    in sorted order, data contiguous, the header padded with spaces to a
    multiple of 8 bytes."""
    codes = {v: k for k, v in SAFETENSORS_DTYPES.items()}
    header, blobs, offset = {}, [], 0
    for name in sorted(tensors):
        t = tensors[name].detach().cpu().contiguous()
        if t.dtype not in codes:
            raise ValueError(f"tensor {name} has dtype {t.dtype}; write: "
                             f"{sorted(codes.values())}")
        raw = t.view(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": codes[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    text = json.dumps(header, separators=(",", ":")).encode("utf-8")
    text += b" " * (-len(text) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(text)))
        f.write(text)
        for raw in blobs:
            f.write(raw)


def load_diffusers_unet(path: str) -> Dict[str, Tensor]:
    """A diffusers UNet2DModel checkpoint file (``.safetensors``, or
    ``.bin``/``.pth`` through ``torch.load``) -> the port's state dict
    (legacy attention names migrated), CPU tensors in the file's dtype."""
    if path.endswith(".safetensors"):
        sd = read_safetensors(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    return rename_legacy_keys(sd)

