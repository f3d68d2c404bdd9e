"""Model-based dS/dlogT sweep and its integrated entropy ->
stats/{experiment}_empirical.npz (keys temp / entropy / rescaled_entropy /
d_entropy_d_log_temp, the curves anchored to 0 at the max temperature).

Counterpart of ``scripts/compute_stats_empirical.py``, with its config
flags plus ``--device``: for each dataset of ``config.available_datasets``
the pretrained model (a checkpoint, or the analytic denoiser with
``--ddpm.model_name true``) and ``stats/model_metric.py::
empirical_entropy_stats`` over ``empirical_stats``' temperature grid,
``batch_size x n_steps_per_temp`` samples from a generator seeded 0 (JAX's
``PRNGKey(0)``). In-process, ``main(argv=[...], draws=...)`` replaces the
generator's draws with the given (idx, eps) batches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config.config import Config
from ..config.loader import with_config
from ..core.device import resolve_device
from ..models.from_config import ddpm_from_config
from ..stats.model_metric import empirical_entropy_stats
from ..utils.data import get_data_tensor
from ._common import ensure_dirs, temp_grid


@with_config(parse_args=(__name__ == "__main__"))
def main(config: Config, device=None, draws=None) -> dict:
    dev = resolve_device(device)
    ensure_dirs("stats")
    written = {}
    for dataset_name in config.available_datasets:
        print(dataset_name)
        config.dataset_name = dataset_name
        data = get_data_tensor(config, device=dev)
        ddpm = ddpm_from_config(config, pretrained=True, device=dev)
        es = config.empirical_stats
        temp = temp_grid(
            es.min_temp if es.min_temp is not None else config.diffusion.min_temp,
            es.max_temp if es.max_temp is not None else config.diffusion.max_temp,
            es.n_temps,
        )
        kw = ({"draws": draws} if draws is not None else
              {"generator": torch.Generator(device=dev).manual_seed(0)})
        out = empirical_entropy_stats(
            ddpm, data, temp, n_samples=es.batch_size * es.n_steps_per_temp,
            batch_size=es.batch_size, device=dev, **kw)
        np.savez(config.empirical_stats_path, temp=out["temp"],
                 entropy=out["entropy"], rescaled_entropy=out["rescaled_entropy"],
                 d_entropy_d_log_temp=out["d_entropy_d_log_temp"])
        print(f"saved {config.empirical_stats_path}")
        written[config.empirical_stats_path] = out
    return written


if __name__ == "__main__":
    main()
