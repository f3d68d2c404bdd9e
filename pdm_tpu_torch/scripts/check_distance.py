"""How the Fisher-Rao arc length distributes over temperature.

Counterpart of ``scripts/check_distance.py``, with its flags plus
``--device`` (the card by default, raising without one; the arithmetic
runs on the host). Loads a metric-stats artifact (temp, metric, log_temp)
and prints the total geodesic distance and the fraction of it
accumulated below a probe temperature: if most of the arc length sits
below T ~ 1e-2, the geodesic schedule spends most of its steps there.
The figure of the cumulative fraction is written where matplotlib is
installed; elsewhere a note on stderr says it was skipped.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np

from ..core.device import resolve_device
from ..schedulers.interpolated import fisher_rao_arc_length
from ._common import pyplot


def main(argv: Optional[Sequence[str]] = None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--stats_path", default="stats/cifar10_metric.npz",
                        help="metric-stats npz (keys: temp, metric, log_temp)")
    parser.add_argument("--probe_temp", type=float, default=1e-2,
                        help="temperature at which to report the distance "
                             "fraction")
    parser.add_argument("--out", default="debug_distance.png")
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    args = parser.parse_args(argv)
    resolve_device(args.device)

    stats = np.load(args.stats_path)
    log_temp, r = fisher_rao_arc_length(stats["log_temp"], stats["metric"])
    temp = np.exp(log_temp)

    plt = pyplot(args.out)
    if plt is not None:
        fig, ax = plt.subplots(figsize=(8, 5))
        ax.semilogx(temp, r / r[-1])
        ax.axvline(args.probe_temp, ls=":", color="gray")
        ax.set(xlabel="temperature", ylabel="fraction of total FR distance",
               title="cumulative Fisher-Rao arc length")
        fig.savefig(args.out, dpi=120)
        plt.close(fig)

    i = min(int(np.searchsorted(temp, args.probe_temp)), len(temp) - 1)
    frac = r[i] / r[-1] if r[-1] > 0 else float("nan")
    print(f"total arc length: {r[-1]:.4f}")
    print(f"fraction accumulated below T={args.probe_temp:g}: {frac:.4f} "
          f"(r={r[i]:.4f})")
    if plt is not None:
        print(f"wrote {args.out}")
    return {"total": float(r[-1]), "fraction": float(frac), "r": float(r[i])}


if __name__ == "__main__":
    main()
