"""Forward free-energy / entropy sweep -> stats/{dataset}_forward.npz.

Counterpart of ``scripts/compute_stats_forward.py``: a log-spaced
temperature grid over the dataset's temperature range, MC-averaged
entropy estimator. ``--forward_stats.stream_chunk N`` keeps the dataset
in host memory and sweeps it through chunks of N points on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.config import Config
from ..config.loader import with_config
from ..core.device import resolve_device
from ..stats.sweep import forward_stats
from ..utils.data import get_data_array, get_data_tensor
from ._common import ensure_dirs, temp_grid


@with_config(parse_args=(__name__ == "__main__"))
def main(config: Config, device=None) -> None:
    dev = resolve_device(device)
    ensure_dirs("stats")
    fs = config.forward_stats
    for dataset_name in config.available_datasets:
        print(dataset_name)
        config.dataset_name = dataset_name
        data = (get_data_array(config) if fs.stream_chunk is not None
                else get_data_tensor(config, device=dev))
        temp = temp_grid(*config.dataset_config.temp_range, fs.n_temps)
        stats = forward_stats(
            data, temp, n_samples=fs.n_samples, batch_size=fs.batch_size,
            generator=torch.Generator(device=dev).manual_seed(0),
            stream_chunk=fs.stream_chunk, device=dev)
        np.savez(config.forward_stats_path, **stats)
        print(f"saved {config.forward_stats_path}")


if __name__ == "__main__":
    main()
