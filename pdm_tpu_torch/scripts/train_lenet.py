"""Train the LeNet FID feature extractor -> checkpoints/lenet_{dataset}.npz
(the JAX package's key format, read by both packages).

Counterpart of ``scripts/train_lenet.py``: the dataset's labelled train
and test splits from the local Hugging Face cache (nothing is
downloaded), Adam and cross-entropy, 10 epochs at batch 64, seed 0.
"""

from __future__ import annotations

import torch

from ..config.config import Config
from ..config.loader import with_config
from ..core.device import resolve_device
from ..models.lenet import save_lenet, train_lenet
from ..utils.data import load_hf_images
from ._common import ensure_dirs


@with_config(parse_args=(__name__ == "__main__"))
def main(config: Config, device=None) -> str:
    dev = resolve_device(device)
    ensure_dirs("checkpoints")
    ds = config.dataset_config
    train_x, train_y = load_hf_images(
        ds.hf_dataset_name, ds.image_key, ds.image_size, ds.channels, "train")
    test_x, test_y = load_hf_images(
        ds.hf_dataset_name, ds.image_key, ds.image_size, ds.channels, "test")
    model = train_lenet(torch.Generator().manual_seed(0), train_x, train_y,
                        test_x, test_y, device=dev)
    out = f"checkpoints/lenet_{config.dataset_name}.npz"
    save_lenet(model, out)
    print(f"saved {out}")
    return out


if __name__ == "__main__":
    main()
