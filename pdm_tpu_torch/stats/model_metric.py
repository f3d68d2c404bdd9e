"""Model-based metric and entropy-derivative estimators.

Counterpart of ``pdm_tpu/stats/model_metric.py``. Both estimate
thermodynamic quantities through a denoiser's reconstruction error:

    G(lambda) ~ 0.5 * E ||x0 - x0_hat||^2 / T      (Fisher-Rao metric)
    dS/dlogT  = the same quantity                   (I-MMSE relation)

with the reference's two noising conventions: ``noising="ve"``,
xt = x0 + sqrt(T) eps, and ``noising="vp"``, xt = sqrt(ab) x0 +
sqrt(1 - ab) eps through ``scheduler.add_noise`` at tau(log T) (the
empirical entropy artifact). dS/dlogT integrates with the trapezoid rule
to an entropy curve.

Randomness comes from a ``torch.Generator`` on the estimator's device (each
batch draws its indices, then one noise draw per temperature) or from
explicit per-batch ``draws`` [(idx (bs,), eps (n_temps, bs, ...)), ...],
so a test can replay another implementation's draws. ``device=None`` means
the CUDA card, where the analytic denoiser runs the moments kernel.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core.device import DeviceLike, resolve_device
from ..models.base import DDPM

Draws = Sequence[Tuple[Tensor, Tensor]]


def _model_metric_batch(ddpm: DDPM, x0: Tensor, temp: Tensor, eps: Tensor,
                        noising: str) -> Tensor:
    """(n_temps,) batch mean of 0.5 ||x0 - x0_hat||^2 / T; ``eps``
    (n_temps, bs, ...) holds each temperature's noise."""
    out = []
    for i, t in enumerate(temp):
        log_t = torch.broadcast_to(torch.log(t), (x0.shape[0],))
        if noising == "vp":
            tau = ddpm.scheduler.tau_from_log_temp(log_t)
            _, _, xt = ddpm.scheduler.add_noise(x0, tau, eps=eps[i])
        else:
            xt = x0 + torch.sqrt(t) * eps[i]
        preds = ddpm.get_predictions(xt, log_t)
        err = torch.sum(torch.square(preds.x0 - x0).reshape(x0.shape[0], -1),
                        dim=-1)
        out.append(0.5 * torch.mean(err) / t)
    return torch.stack(out)


def model_metric_stats(
    ddpm: DDPM,
    data,
    temp: np.ndarray,
    n_samples: int = 1024,
    batch_size: int = 256,
    noising: str = "ve",
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """The reference artifact: {temp, metric, log_temp, dataset_tr_sigma0}.
    ``data`` (N, ...) in the layout ``ddpm`` takes."""
    if noising not in ("ve", "vp"):
        raise ValueError(f"noising must be 've' or 'vp': {noising!r}")
    dev = resolve_device(device)
    data = torch.as_tensor(data, dtype=torch.float32, device=dev)
    data2d = data.reshape(data.shape[0], -1)
    n = data2d.shape[0]
    temp_t = torch.as_tensor(np.asarray(temp), dtype=torch.float32, device=dev)
    sizes = [min(batch_size, n_samples - lo) for lo in range(0, n_samples, batch_size)]
    if draws is not None and [int(i.shape[0]) for i, _ in draws] != sizes:
        raise ValueError(f"draws must hold batches of sizes {sizes}")
    acc = np.zeros(len(temp), np.float64)
    with torch.inference_mode():
        for b, bs in enumerate(sizes):
            if draws is not None:
                idx = torch.as_tensor(draws[b][0], device=dev).long()
                eps = torch.as_tensor(draws[b][1], dtype=torch.float32, device=dev)
            else:
                idx = torch.randint(0, n, (bs,), generator=generator, device=dev)
                eps = torch.randn((len(temp), bs, *data.shape[1:]),
                                  generator=generator, device=dev)
            x0 = data[idx]
            vals = _model_metric_batch(ddpm, x0, temp_t, eps, noising)
            acc += vals.cpu().numpy().astype(np.float64) * bs
        tr_sigma0 = float(torch.var(data2d, dim=0, unbiased=True).sum())
    return {
        "temp": np.asarray(temp),
        "metric": acc / sum(sizes),
        "log_temp": np.log(np.asarray(temp)),
        "dataset_tr_sigma0": np.asarray(tr_sigma0),
    }


def empirical_entropy_stats(
    ddpm: DDPM,
    data,
    temp: np.ndarray,
    n_samples: int = 1024,
    batch_size: int = 256,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """The empirical-stats artifact: dS/dlogT from VP-noised
    reconstruction error, trapezoid-integrated to entropy and rescaled
    entropy, both anchored to 0 at the MAX temperature. As the JAX package,
    the anchor 0 is prepended (entropy[k] is the integral from temp[0] to
    temp[k]), one grid index later than the reference's trailing pad."""
    out = model_metric_stats(ddpm, data, temp, n_samples, batch_size, "vp",
                             generator=generator, draws=draws, device=device)
    curves = integrate_entropy_curves(out["metric"], out["temp"], out["log_temp"])
    return {
        "temp": out["temp"],
        "entropy": curves["entropy"],
        "rescaled_entropy": curves["rescaled_entropy"],
        "d_entropy_d_log_temp": out["metric"],
        "log_temp": out["log_temp"],
    }


def integrate_entropy_curves(ds: np.ndarray, temp: np.ndarray,
                             log_temp: np.ndarray) -> Dict[str, np.ndarray]:
    """Trapezoid-integrate dS/dlogT to (entropy, rescaled_entropy), both
    anchored to 0 at the max temperature, the 0 prepended (pinned by
    tests/fixtures/empirical_entropy_golden.npz: ours[k+1] equals the
    reference's [k])."""
    d_log_t = np.diff(log_temp)
    entropy = np.concatenate([[0.0], np.cumsum(0.5 * (ds[1:] + ds[:-1]) * d_log_t)])
    entropy -= entropy[-1]
    sigma = np.sqrt(temp)
    rescaled = np.concatenate([[0.0], np.cumsum(
        0.5 * (ds[1:] * sigma[1:] + ds[:-1] * sigma[:-1]) * d_log_t)])
    rescaled -= rescaled[-1]
    return {"entropy": entropy, "rescaled_entropy": rescaled}
