"""Model-based Fisher-Rao metric -> a dense schedule table that
``custom`` schedules read.

Counterpart of ``scripts/compute_model_metric_schedule.py``, with its
flags (``--n_samples``, ``--n_temps``, ``--out``) plus ``--device``: the
config's pretrained model (``PDM_CONFIG``; the analytic denoiser with
``ddpm.model_name: true``) and ``stats/model_metric.py::
model_metric_stats`` over n_temps temperatures log-spaced over the
config's range, from a generator seeded 0 (JAX's ``PRNGKey(0)``). Writes
the statistics to ``stats/{dataset}_metric_model.npz`` and the table
(log_temp, timestamps from 0 to 1 along the Fisher-Rao arc length) to
``--out`` (default ``stats/{dataset}_metric_model_schedule.npz``).
In-process, ``main(argv=[...], draws=...)`` replaces the generator's
draws with the given (idx, eps) batches.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..config.loader import load_config
from ..core.device import resolve_device
from ..models.from_config import ddpm_from_config
from ..schedulers.interpolated import fisher_rao_arc_length
from ..stats.model_metric import model_metric_stats
from ..utils.data import get_data_tensor
from ._common import ensure_dirs, temp_grid


def main(argv: Optional[Sequence[str]] = None, *, draws=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n_samples", type=int, default=2048)
    parser.add_argument("--n_temps", type=int, default=100)
    parser.add_argument("--out", type=str, default=None)
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    config = load_config()
    ensure_dirs("stats")
    data = get_data_tensor(config, device=dev)
    ddpm = ddpm_from_config(config, pretrained=True, device=dev)
    temp = temp_grid(config.diffusion.min_temp, config.diffusion.max_temp,
                     args.n_temps)
    kw = ({"draws": draws} if draws is not None else
          {"generator": torch.Generator(device=dev).manual_seed(0)})
    stats = model_metric_stats(ddpm, data, temp, n_samples=args.n_samples,
                               device=dev, **kw)
    stats_out = config.metric_stats_path.replace(".npz", "_model.npz")
    np.savez(stats_out, **stats)
    print(f"saved {stats_out}")

    # a dense table over the whole measured grid, timestamps from 0 (a
    # sparse knot set starting at tau = 1/n would leave a finer sampler
    # extrapolating below the first knot)
    log_temp, r = fisher_rao_arc_length(stats["log_temp"], stats["metric"])
    if r[-1] <= 0:
        raise RuntimeError("integrated Fisher-Rao distance is non-positive")
    out = args.out or config.metric_stats_path.replace(
        ".npz", "_model_schedule.npz")
    np.savez(out, log_temp=log_temp, timestamps=r / r[-1])
    print(f"saved {out}: {len(log_temp)}-knot dense schedule")
    return {"stats": stats, "stats_path": stats_out, "schedule_path": out,
            "log_temp": log_temp, "timestamps": r / r[-1]}


if __name__ == "__main__":
    main()
