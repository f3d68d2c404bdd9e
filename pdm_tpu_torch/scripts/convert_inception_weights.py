"""Convert an InceptionV3 PyTorch checkpoint to the JAX-layout .npz that
``PDM_INCEPTION_WEIGHTS`` names (read by both packages).

Counterpart of ``scripts/convert_inception_weights.py``. For FID numbers
comparable with the reference (torchmetrics / pytorch-fid), convert the
FID-standard weights ``pt_inception-2015-12-05-*.pth``: the network of
``models/inception.py`` defaults to that variant's pooling
(``fid_variant=True``). Plain torchvision inception_v3 weights convert too
(the same parameter names) but match ``fid_variant=False``.

    python -m pdm_tpu_torch.scripts.convert_inception_weights CKPT.pth \\
        [--out checkpoints/inception_fid.npz]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..models.inception import convert_torch_state_dict, inception_arrays


def main(argv: Optional[Sequence[str]] = None) -> str:
    parser = argparse.ArgumentParser()
    parser.add_argument("torch_checkpoint", help=".pth state_dict path")
    parser.add_argument("--out", default="checkpoints/inception_fid.npz")
    args = parser.parse_args(argv)

    sd = torch.load(args.torch_checkpoint, map_location="cpu",
                    weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    np.savez(args.out, **inception_arrays(convert_torch_state_dict(sd)))
    print(f"saved {args.out}")
    return args.out


if __name__ == "__main__":
    main()
