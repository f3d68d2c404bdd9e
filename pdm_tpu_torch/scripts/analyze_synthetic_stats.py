"""Hypersphere thermodynamics: the MC sweep against the exact Bessel
closed forms, across dataset sizes N.

Counterpart of ``scripts/analyze_synthetic_stats.py``, with its flags
(``--d``, ``--sizes``, ``--n_samples``) plus ``--device``: 40
temperatures log-spaced over [10^-2.5, 10^2]; ``thermo_sweep`` over
points on the unit sphere in d dimensions (seed 0) for each size, its
entropy and heat capacity beside ``stats/hypersphere.py::marginal_stats``,
and the largest |S_mc - S_exact| over the middle temperatures at the
largest size. Run as ``python -m
pdm_tpu_torch.scripts.analyze_synthetic_stats [--device cpu]``. The
temperature count is ``main``'s keyword; ``draws(n, seed)`` gives a
sweep's (idx, eps) batches in place of a generator seeded ``seed`` (JAX's
``PRNGKey(seed)``). The figure, hypersphere_stats.png, needs matplotlib.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..core.device import resolve_device
from ..stats.hypersphere import marginal_stats
from ..stats.sweep import thermo_sweep
from ..utils.synthetic import sample_on_hypersphere
from ._common import pyplot

PLOT = "hypersphere_stats.png"
MID = slice(10, 30)  # the middle temperatures of JAX's 40


def main(argv: Optional[Sequence[str]] = None, *, n_temps: int = 40,
         draws: Optional[Callable[[int, int], list]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--d", type=int, default=10)
    parser.add_argument("--sizes", type=int, nargs="+",
                        default=[100, 1000, 10_000])
    parser.add_argument("--n_samples", type=int, default=512)
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)

    temps = np.logspace(-2.5, 2, n_temps)
    oracle = marginal_stats(temps, d=args.d)

    def sweep(n, seed):
        data = sample_on_hypersphere(args.d, n=n, radius=1.0, seed=0)
        kw = ({"draws": draws(n, seed)} if draws is not None else
              {"generator": torch.Generator(device=dev).manual_seed(seed)})
        return thermo_sweep(data, temps, n_samples=args.n_samples,
                            batch_size=args.n_samples, device=dev, **kw)

    curves = {n: sweep(n, 0) for n in args.sizes}
    plt = pyplot(PLOT)
    if plt is not None:
        plt.figure(figsize=(12, 4))
        for i, key in enumerate(["S", "C"], 1):
            plt.subplot(1, 2, i)
            plt.plot(temps, oracle[key], "k-", linewidth=2,
                     label="exact (Bessel)")
            for n, out in curves.items():
                vals = out["entropy"] if key == "S" else out["heat_capacity"]
                plt.plot(temps, vals, "--", label=f"MC N={n}")
            plt.xscale("log")
            plt.title(f"{key}(T), d={args.d}")
            plt.xlabel("Temperature")
            plt.grid(alpha=0.3)
            plt.legend(fontsize=8)
        plt.tight_layout()
        plt.savefig(PLOT)
        print(f"saved {PLOT}")
    # numeric check at mid temperatures
    check = sweep(max(args.sizes), 1)
    err = float(np.abs(check["entropy"][MID] - oracle["S"][MID]).max())
    print(f"max |S_mc - S_exact| (mid range, N={max(args.sizes)}): {err:.4f}")
    return {"temp": temps, "oracle": oracle, "curves": curves, "check": check,
            "mid_err": err}


if __name__ == "__main__":
    main()
