"""Monte-Carlo estimators of the Fisher-Rao metric over noise levels, via
G = I_noise - Var_y[marginal score].

Counterpart of ``pdm_tpu/stats/mc_metric.py``:

* ``metric_scalar``: isotropic Sigma = sigma^2 I, lambda = log sigma^2;
  the marginal score of a y-sample is -D/2 + E_p[g] with g the moments
  op's energy over T, so the estimator is one streaming pass.
* ``metric_matrix_diag``: diagonal Lambda, per-dim scores from the
  posterior moments E_p[x], E_p[x^2] that ride the op's payload (K = 2D).
* ``rescaled_metric_diag``: theta = Sigma, with the reference's empirical
  rescaling 4 Sigma^2 / (Sigma0 + 2 Sigma).

They call the moments op's dispatcher, so on the card they run the moments
kernel; the JAX package calls its XLA path here (``mc_metric.py:30``).
Variances are unbiased (ddof = 1), as the JAX package's. Each batch of
y-samples is drawn from a ``torch.Generator`` (indices, then noise) or
given as ``draws=(idx (n_y,), eps (n_y, D))``. ``device=None`` means the
CUDA card.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from ..core.device import DeviceLike, resolve_device
from ..ops.boltzmann import boltzmann_moments

Draw = Tuple[Tensor, Tensor]


def _samples(x_samples, device: DeviceLike) -> Tensor:
    return torch.as_tensor(x_samples, dtype=torch.float32,
                           device=resolve_device(device))


def _draw(x: Tensor, n_y: int, generator, draws: Optional[Draw]) -> Draw:
    K, D = x.shape
    if draws is not None:
        idx, eps = draws
        return (torch.as_tensor(idx, device=x.device).long(),
                torch.as_tensor(eps, dtype=torch.float32, device=x.device))
    idx = torch.randint(0, K, (n_y,), generator=generator, device=x.device)
    return idx, torch.randn((n_y, D), generator=generator, device=x.device)


def metric_scalar(log_sigma_sq, x_samples, n_y: int = 10_000, *,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Draw] = None,
                  device: DeviceLike = None) -> Tensor:
    """G(lambda) for lambda = log sigma^2, isotropic noise:
    D/2 - Var_y[E_p[g]] with the op's g = H / sigma^2."""
    x = _samples(x_samples, device)
    D = x.shape[1]
    sigma_sq = torch.exp(torch.as_tensor(log_sigma_sq, dtype=torch.float32,
                                         device=x.device))
    idx, eps = _draw(x, n_y, generator, draws)
    with torch.inference_mode():
        y = x[idx] + torch.sqrt(sigma_sq) * eps
        mom = boltzmann_moments(y, x, inv_temp=1.0 / sigma_sq)
        return 0.5 * D - torch.var(mom.e1, unbiased=True)


def _posterior_dim_moments(y: Tensor, x: Tensor, sigma_diag: Tensor
                           ) -> Tuple[Tensor, Tensor]:
    """E_p[x_d] and E_p[x_d^2] under the anisotropic posterior
    p ~ exp(-0.5 sum_d (y_d - x_d)^2 / Sigma_dd), by whitening the
    coordinates (v' = v / sqrt(Sigma)) and a K = 2D payload."""
    inv_s = 1.0 / torch.sqrt(sigma_diag)
    vals = torch.cat([x, torch.square(x)], dim=1)
    mom = boltzmann_moments(y * inv_s[None, :], x * inv_s[None, :],
                            inv_temp=1.0, values=vals)
    D = x.shape[1]
    return mom.mean[:, :D], mom.mean[:, D:]


def _e_sq_diff(y: Tensor, ex: Tensor, ex2: Tensor) -> Tensor:
    """E_p[(y_d - x_d)^2] = y_d^2 - 2 y_d E[x_d] + E[x_d^2]."""
    return torch.square(y) - 2.0 * y * ex + ex2


def _diag_scores_input(sigma_diag: Tensor, x: Tensor, n_y: int, generator,
                       draws: Optional[Draw]) -> Tuple[Tensor, Tensor, Tensor]:
    idx, eps = _draw(x, n_y, generator, draws)
    y = x[idx] + torch.sqrt(sigma_diag)[None, :] * eps
    ex, ex2 = _posterior_dim_moments(y, x, sigma_diag)
    return y, ex, ex2


def metric_matrix_diag(lambda_diag, x_samples, n_y: int = 10_000, *,
                       generator: Optional[torch.Generator] = None,
                       draws: Optional[Draw] = None,
                       device: DeviceLike = None) -> Tensor:
    """Diagonal G(Lambda) for Sigma = diag(exp(lambda_d)): per-dim score
    -1/2 + E_p[(y_d - x_d)^2] / (2 Sigma_dd), G_dd = 1/2 - Var_y[s_d]."""
    x = _samples(x_samples, device)
    sigma_diag = torch.exp(torch.as_tensor(lambda_diag, dtype=torch.float32,
                                           device=x.device))
    with torch.inference_mode():
        y, ex, ex2 = _diag_scores_input(sigma_diag, x, n_y, generator, draws)
        scores = -0.5 + 0.5 * _e_sq_diff(y, ex, ex2) / sigma_diag[None, :]
        return 0.5 - torch.var(scores, dim=0, unbiased=True)


def rescaled_metric_diag(sigma_diag, x_samples, n_y: int = 10_000, *,
                         generator: Optional[torch.Generator] = None,
                         draws: Optional[Draw] = None,
                         device: DeviceLike = None) -> Tensor:
    """Rescaled metric G_tilde for theta = Sigma (diagonal): per-dim score
    -1/(2 Sigma_dd) + E_p[(y_d - x_d)^2] / (2 Sigma_dd^2), G_dd =
    1/(2 Sigma_dd^2) - Var_y[s_d], times 4 Sigma^2 / (Sigma0 + 2 Sigma)."""
    x = _samples(x_samples, device)
    D = x.shape[1]
    sigma_diag = torch.broadcast_to(torch.as_tensor(
        sigma_diag, dtype=torch.float32, device=x.device), (D,))
    with torch.inference_mode():
        y, ex, ex2 = _diag_scores_input(sigma_diag, x, n_y, generator, draws)
        scores = (-0.5 / sigma_diag[None, :]
                  + 0.5 * _e_sq_diff(y, ex, ex2) / torch.square(sigma_diag)[None, :])
        g = 0.5 / torch.square(sigma_diag) - torch.var(scores, dim=0, unbiased=True)
        sigma0_diag = torch.var(x, dim=0, unbiased=True)
        return g * (4.0 * torch.square(sigma_diag) / (sigma0_diag + 2.0 * sigma_diag))
