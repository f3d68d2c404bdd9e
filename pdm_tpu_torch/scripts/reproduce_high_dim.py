"""High-dimensional physics experiment: the 100-D anisotropic GMM, one
fused forward + metric sweep, entropy and metric schedules against cosine
and log-SNR, analytic-denoiser sampling, and MMD / KL / occupancy / MSE.

Counterpart of ``scripts/reproduce_high_dim.py``. Its scales come from
the port's copy of the profile ``config/yaml/high_dim_exp.yaml``
(``PDM_CONFIG`` overrides it): dim 100, 5 components, 50,000 training
points, the sweep's temperatures and samples, DDPM-20 for 10,000 samples
at batch 1000 over [1e-4, 1e4]. Writes
stats/anisotropic_gmm_repro_forward.npz (temp, entropy),
stats/anisotropic_gmm_repro_metric.npz (temp, metric, log_temp,
dataset_tr_sigma0) and high_dim_plots.png (with matplotlib), and prints
the table. Run as ``python -m pdm_tpu_torch.scripts.reproduce_high_dim
[--device cpu]``; the sweep draws from a generator seeded 0, the samplers
from one seeded 1 (JAX's keys). ``main``'s keywords cut the sizes (the
profile's values when None); ``draws`` gives the sweep's (idx, eps)
batches.

The KL column fits a GMM to each sample set with scikit-learn and
integrates with scipy; where either is missing the column reads
"skipped" and one line says why. It is optional output: nothing else
changes.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

import numpy as np
import torch

from ..config.loader import DEFAULT_CONFIG_PATH, load_config
from ..core.device import resolve_device
from ..diffusion.sampling import get_samples
from ..models.base import TrueDDPM
from ..ops.mmd import mmd_rbf
from ..schedulers.analytic import CosineScheduler, LogSNRScheduler
from ..schedulers.interpolated import entropy_scheduler, metric_scheduler
from ..stats.sweep import thermo_sweep
from ..utils.synthetic import generate_anisotropic_gmm
from ._common import ensure_dirs, pyplot

PROFILE = os.path.join(os.path.dirname(DEFAULT_CONFIG_PATH), "high_dim_exp.yaml")
N_COMPONENTS = 5  # a fact of the data's generation, not a config knob
PLOT = "high_dim_plots.png"


def kl_backend() -> Optional[str]:
    """None where scikit-learn and scipy are installed, else why not."""
    try:
        import scipy.stats  # noqa: F401
        import sklearn.mixture  # noqa: F401
    except ImportError as e:
        return f"{e.name} is not installed"
    return None


def compute_kl_gmm(samples, true_means, true_covs) -> float:
    """KL(P_induced || P_true): a GMM fitted to the samples, integrated by
    Monte Carlo over its own draws (the JAX script's compute_kl_gmm)."""
    from scipy.stats import multivariate_normal
    from sklearn.mixture import GaussianMixture

    dim = samples.shape[1]
    n_comp = len(true_means)
    gmm = GaussianMixture(
        n_components=n_comp, covariance_type="full", init_params="random",
        n_init=3, random_state=42, reg_covar=1e-4, max_iter=200)
    gmm.fit(samples)
    w = gmm.weights_.astype(np.float64)
    gmm.weights_ = w / w.sum()
    x_mc, _ = gmm.sample(50_000)
    log_p_ind = gmm.score_samples(x_mc)
    log_ps = np.stack([
        multivariate_normal(true_means[k], true_covs[k] + 1e-8 * np.eye(dim),
                            allow_singular=True).logpdf(x_mc)
        for k in range(n_comp)])
    m = log_ps.max(0)
    log_p_true = m + np.log(np.exp(log_ps - m).sum(0)) - np.log(n_comp)
    return float(np.mean(log_p_ind - log_p_true))


def plot(schedulers, stats, dev) -> None:
    plt = pyplot(PLOT)
    if plt is None:
        return
    plt.figure(figsize=(15, 10))
    plt.subplot(2, 2, 1)
    tau = torch.linspace(0, 1, 100, device=dev)
    for name, sch in schedulers.items():
        lw = 2 if name in ("Cosine", "Metric") else 1
        plt.plot(tau.cpu().numpy(),
                 np.exp(sch.log_temp_from_tau(tau).cpu().numpy()),
                 label=name, linewidth=lw, alpha=1.0 if lw == 2 else 0.3)
    plt.yscale("log")
    plt.legend()
    plt.grid(alpha=0.3)
    plt.xlabel("tau")
    plt.ylabel("Temperature")
    plt.title("Temperature vs Time")
    plt.subplot(2, 2, 2)
    sqrt_g = np.sqrt(np.clip(stats["metric"], 0, None))
    dr = 0.5 * (sqrt_g[1:] + sqrt_g[:-1]) * np.diff(stats["log_temp"])
    plt.semilogx(stats["temp"], np.concatenate([[0], np.cumsum(dr)]))
    plt.xlabel("Temperature")
    plt.ylabel("r(0, sigma)")
    plt.title("Fisher-Rao distance")
    plt.grid(alpha=0.3)
    plt.subplot(2, 2, 3)
    plt.semilogx(stats["temp"], stats["entropy"], "k--")
    plt.xlabel("Temperature")
    plt.ylabel("Entropy")
    plt.grid(alpha=0.3)
    plt.subplot(2, 2, 4)
    plt.loglog(stats["temp"], stats["metric"], "b-", label="Empirical G")
    plt.loglog(stats["temp"], float(stats["dataset_tr_sigma0"]) / stats["temp"],
               "r--", label="Tail Tr(Sigma0)/sigma^2")
    plt.legend()
    plt.grid(which="both", alpha=0.3)
    plt.xlabel("Temperature")
    plt.ylabel("Metric G")
    plt.tight_layout()
    plt.savefig(PLOT)
    print(f"Saved {PLOT}")


def main(argv: Optional[Sequence[str]] = None, *, n_train: int = 50_000,
         n_gen: Optional[int] = None, n_temps: Optional[int] = None,
         sweep_samples: Optional[int] = None, sweep_batch: Optional[int] = None,
         n_steps: Optional[int] = None, draws=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="the card by default; cpu runs the plain versions")
    dev = resolve_device(parser.parse_args(argv).device)

    config = load_config(os.environ.get("PDM_CONFIG") or PROFILE)
    dim = config.dataset_config.image_size[0]
    n_gen = n_gen or config.sample.n_samples
    min_temp, max_temp = config.diffusion.temp_range
    fs = config.forward_stats

    print(f"Generating data (dim={dim}, components={N_COMPONENTS}, n={n_train})...")
    train_data, true_means, true_covs = generate_anisotropic_gmm(
        dim=dim, n_components=N_COMPONENTS, n_samples=n_train)
    data = torch.as_tensor(train_data, device=dev)

    ensure_dirs("stats")
    temps = np.logspace(np.log10(min_temp), np.log10(max_temp),
                        n_temps or fs.n_temps)
    print("Computing forward + metric stats (one fused sweep)...")
    kw = ({"draws": draws} if draws is not None else
          {"generator": torch.Generator(device=dev).manual_seed(0)})
    stats = thermo_sweep(data, temps, n_samples=sweep_samples or fs.n_samples,
                         batch_size=sweep_batch or fs.batch_size, device=dev,
                         **kw)
    np.savez("stats/anisotropic_gmm_repro_forward.npz",
             temp=stats["temp"], entropy=stats["entropy"])
    np.savez("stats/anisotropic_gmm_repro_metric.npz",
             temp=stats["temp"], metric=stats["metric"],
             log_temp=stats["log_temp"],
             dataset_tr_sigma0=stats["dataset_tr_sigma0"])

    schedulers = {
        "Linear log-SNR": LogSNRScheduler(min_temp, max_temp),
        "Cosine": CosineScheduler(min_temp, max_temp),
        "Entropic": entropy_scheduler(stats["temp"], stats["entropy"],
                                      extrapolate=False, device=dev),
        "Metric": metric_scheduler(stats["log_temp"], stats["metric"],
                                   device=dev),
    }
    plot(schedulers, stats, dev)

    def sample_with(name):
        print(f"Sampling with {name} schedule...")
        scheduler = schedulers[name]
        ddpm = TrueDDPM(scheduler=scheduler, train_data=data, device=dev)
        out = get_samples(
            ddpm, scheduler, n_steps=n_steps or config.sample.n_steps,
            obj_size=(1, dim, 1), n_samples=n_gen,
            batch_size=min(n_gen, config.sample.batch_size),
            step_type=config.sample.step_type,
            generator=torch.Generator(device=dev).manual_seed(1), device=dev)
        return out["x"].reshape(n_gen, dim)

    samples = {"Cosine": sample_with("Cosine"), "Metric": sample_with("Metric")}
    rng = np.random.RandomState(0)
    flat = train_data.reshape(n_train, dim)
    ref = flat[rng.randint(0, n_train, n_gen)]
    samples = {"Baseline (True)": flat[rng.randint(0, n_train, n_gen)], **samples}

    no_kl = kl_backend()
    if no_kl is not None:
        print(f"KL skipped: {no_kl} (scikit-learn and scipy fit and integrate "
              f"the GMM); the other columns are complete")
    print("-" * 85)
    print(f"{'Schedule':<20} | {'MMD':<10} | {'KL':<10} | {'Avg MSE':<10} | "
          f"Component Dist.")
    print("-" * 85)
    table = {}
    for name, x in samples.items():
        mmd = float(mmd_rbf(torch.as_tensor(x[:5000], device=dev),
                            torch.as_tensor(ref[:5000], device=dev),
                            sigmas=(float(np.sqrt(dim)),)))
        kl = None if no_kl else compute_kl_gmm(
            x.astype(np.float64), true_means.astype(np.float64),
            true_covs.astype(np.float64))
        d = ((x[:, None, :] - true_means[None]) ** 2).sum(-1)
        assign = d.argmin(1)
        occ = np.bincount(assign, minlength=N_COMPONENTS) / len(x)
        mse = np.nanmean([
            ((x[assign == i] - true_means[i]) ** 2).sum(1).mean()
            if (assign == i).any() else np.nan for i in range(N_COMPONENTS)])
        occ_str = ", ".join(f"{v:.2f}" for v in occ)
        kl_str = "skipped" if kl is None else f"{kl:.4f}"
        print(f"{name:<20} | {mmd:<10.6f} | {kl_str:<10} | {mse:<10.4f} | "
              f"[{occ_str}]")
        table[name] = {"mmd": mmd, "kl": kl, "mse": float(mse), "occupancy": occ}
    print("-" * 85)
    return {"stats": stats, "samples": samples, "table": table}


if __name__ == "__main__":
    main()
