"""Noise-schedule abstraction.

A scheduler is an invertible monotone map between the scaled time
``tau in [0, 1]`` and the thermodynamic coordinate ``log_temp = log T``.
Everything else (alpha_bar, the VP forward process, sampling grids) derives
from that pair of functions.

Counterpart of ``pdm_tpu/schedulers/base.py``. Schedulers are frozen
dataclasses whose methods are plain tensor functions; randomness comes from
an explicit ``torch.Generator`` (or explicit ``eps``/``tau``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import Tensor

from ..core.draws import batch_rand, batch_randn
from ..core.temperature import (
    alpha_bar_from_log_temp,
    bcast_right,
    one_minus_alpha_bar_from_log_temp,
)


class Scheduler:
    """Base class. Subclasses implement the tau <-> log_temp bijection."""

    def log_temp_from_tau(self, tau: Tensor) -> Tensor:
        raise NotImplementedError

    def tau_from_log_temp(self, log_temp: Tensor) -> Tensor:
        raise NotImplementedError

    def alpha_bar_from_tau(self, tau: Tensor) -> Tensor:
        return alpha_bar_from_log_temp(self.log_temp_from_tau(tau))

    def add_noise(
        self,
        x0: Tensor,
        tau: Optional[Tensor] = None,
        *,
        generator: Optional[torch.Generator] = None,
        eps: Optional[Tensor] = None,
    ) -> Tuple[Tensor, Tensor, Tensor]:
        """VP forward process with uniform-tau sampling.

        Returns (tau, eps, xt) with xt = sqrt(ab) x0 + sqrt(1-ab) eps.
        ``tau`` and ``eps`` are drawn from ``generator`` unless given (a
        ``core.draws.SlicedGenerator`` draws the global batch's values and
        keeps this rank's rows).
        """
        if tau is None:
            tau = batch_rand((x0.shape[0],), generator, device=x0.device,
                             dtype=x0.dtype)
        if eps is None:
            eps = batch_randn(x0.shape, generator, device=x0.device,
                              dtype=x0.dtype)
        log_temp = self.log_temp_from_tau(tau)
        ab = bcast_right(alpha_bar_from_log_temp(log_temp), x0.ndim)
        omab = bcast_right(one_minus_alpha_bar_from_log_temp(log_temp), x0.ndim)
        xt = torch.sqrt(ab) * x0 + torch.sqrt(omab) * eps
        return tau, eps, xt

    # -- analytic (dataset-exact) quantities, through ops/boltzmann.py --

    def true_posterior_mean_x0(self, xt: Tensor, tau: Tensor, data) -> Tensor:
        """Bayes-optimal E[x0 | xt] over a finite dataset."""
        from ..ops.boltzmann import true_posterior_mean_x0

        return true_posterior_mean_x0(xt, self.log_temp_from_tau(tau), data)

    def true_score(self, xt: Tensor, tau: Tensor, data) -> Tensor:
        """Analytic marginal score over a finite dataset."""
        from ..ops.boltzmann import true_score

        return true_score(xt, self.log_temp_from_tau(tau), data)
