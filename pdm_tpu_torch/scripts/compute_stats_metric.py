"""Empirical (data-space) Fisher-Rao metric sweep ->
stats/{dataset}_metric.npz.

Counterpart of ``scripts/compute_stats_metric.py``, with its flags:
manifold regularization (a global floor, or adaptive k-NN), the sample
and temperature counts, and ``--stream_chunk`` for the host-streaming
tier; plus ``--device``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from ..config.loader import load_config
from ..core.device import resolve_device
from ..stats.sweep import metric_stats
from ..utils.data import get_data_array, get_data_tensor
from ._common import ensure_dirs, temp_grid


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_samples", type=int, default=2000)
    parser.add_argument("--n_temps", type=int, default=100)
    parser.add_argument("--regularize", action="store_true")
    parser.add_argument("--adaptive_knn", action="store_true")
    parser.add_argument("--knn_k", type=int, default=5)
    parser.add_argument("--sigma_reg_scale", type=float, default=1e-4)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument(
        "--stream_chunk", type=int, default=None,
        help="host-streaming tier for datasets larger than the card: the "
        "dataset stays in host memory, swept in device chunks of this many "
        "points (incompatible with --adaptive_knn)")
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    args = parser.parse_args(argv)

    dev = resolve_device(args.device)
    config = load_config()
    if args.dataset:
        config.dataset_name = args.dataset
    ensure_dirs("stats")
    data = (get_data_array(config) if args.stream_chunk is not None
            else get_data_tensor(config, device=dev))
    temp = temp_grid(*config.dataset_config.temp_range, args.n_temps)
    stats = metric_stats(
        data, temp,
        n_samples=args.n_samples,
        batch_size=min(args.n_samples, 512),
        generator=torch.Generator(device=dev).manual_seed(0),
        regularize=args.regularize,
        adaptive_knn=args.adaptive_knn,
        knn_k=args.knn_k,
        sigma_reg_scale=args.sigma_reg_scale,
        stream_chunk=args.stream_chunk,
        device=dev,
    )
    np.savez(config.metric_stats_path, **stats)
    print(f"saved {config.metric_stats_path}")


if __name__ == "__main__":
    main()
