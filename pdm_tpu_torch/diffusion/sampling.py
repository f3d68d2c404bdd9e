"""Reverse-process sampler over a discretized log-temperature schedule.

Counterpart of ``pdm_tpu/diffusion/sampling.py``. The schedule is
discretized once into a ``(n_steps,)`` log-temperature grid, from which all
per-step coefficients are precomputed as tables; the JAX package's
``lax.scan`` over them becomes a Python loop. The final step has
``alpha_bar_prev == 1`` so its noise coefficient is exactly zero
(``safe_sqrt``), with no branch on the step index.

Step rules (x-space; see the JAX module for the derivations):

  DDPM:     x_prev = c_x0 * x0_hat + c_xt * xt + c_n * xi
  DDIM:     x_prev = sqrt(ab_prev) x0_hat + sqrt(1 - ab_prev) eps_hat
  HEUN:     Euler predictor + trapezoid corrector on the PF-ODE in
            z = x / sqrt(ab), sigma = sqrt(T); the final step to sigma = 0
            is peeled out of the loop and returns x0_hat (2n-1 NFE).
  DPMPP_2M: DPM-Solver++(2M), one model eval per step, extrapolating the
            two most recent x0 predictions (k = 0 on the first and last).

Noise comes from an explicit ``torch.Generator`` on the sampler's device.
``batch_sample`` also takes explicit noise (the initial ``x_T`` and a
``(n_steps, B, ...)`` stack) so tests can feed in another sampler's draws.
With ``batch_sharding`` (``parallel.sharded_sampler``) each rank of a data
mesh steps its rows of the batch: it draws the global batch's x_T and
noise and keeps its rows, so the samples do not depend on the number of
ranks, and the batch is gathered at the end.
``precision="half"`` runs the model on bf16 inputs and casts x0 back to
fp32, where the JAX package does; all step arithmetic is fp32.

The loop is differentiable in the grid (``diffusion/schedule_opt.py``
calls it under grad, outside ``batch_sample``'s inference mode). With
``remat`` each step, Heun's peeled final step included, runs under
``torch.utils.checkpoint`` (non-reentrant), JAX's ``jax.checkpoint`` of
the scan body: the backward recomputes one step's forward at a time. The
recompute restores only the global RNG, so DDPM's per-step noise is drawn
before the loop then (the same draws, in the same order, as the loop's).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from ..core.device import DeviceLike, resolve_device
from ..core.draws import batch_randn
from ..core.temperature import alpha_bar_from_log_temp
from ..models.base import DDPM
from ..parallel.mesh import BatchSharding
from ..schedulers.base import Scheduler

STEP_TYPES = ("ddpm", "ddim", "heun", "dpmpp_2m")

# Stability envelope for the deterministic 2nd-order PF-ODE solver: above
# this top temperature the JAX package measured catastrophic divergence
# (scripts/endurance_heun_table.md), so the sampler clamps (or warns).
HEUN_VALIDATED_MAX_TEMP = 4.0e2


def discretize_schedule(
    scheduler: Scheduler,
    n_steps: int,
    *,
    max_log_temp: Optional[float] = None,
    log_temp: Optional[Tensor] = None,
    device: DeviceLike = "cpu",
) -> Tensor:
    """(n_steps,) grid of log temperatures, ascending in T.

    tau grid = linspace(0, 1, n+1)[1:], mapped through the schedule and
    clipped to the model's max temperature. A custom ``log_temp`` grid
    (e.g. an optimized schedule) bypasses the scheduler.
    """
    if log_temp is None:
        tau = torch.linspace(0.0, 1.0, n_steps + 1, dtype=torch.float32,
                             device=device)[1:]
        log_temp = scheduler.log_temp_from_tau(tau)
    log_temp = torch.as_tensor(log_temp, dtype=torch.float32, device=device)
    if max_log_temp is not None:
        log_temp = torch.clamp(log_temp, max=max_log_temp)
    return log_temp


def safe_sqrt(u: Tensor) -> Tensor:
    """sqrt with a zero (not inf) gradient at u == 0. The final step has
    ab_prev == 1 exactly, so sqrt(1 - ab_prev) = sqrt(0); the double-where
    keeps a backward through the schedule off the singular branch."""
    pos = u > 0.0
    return torch.where(pos, torch.sqrt(torch.where(pos, u, 1.0)), 0.0)


def _step_tables(log_temp: Tensor) -> Dict[str, Tensor]:
    """Per-step coefficient tables, ordered high-T -> low-T.

    Step i goes from level i to level i-1; the last step goes to the clean
    state (log_temp = -inf, alpha_bar = 1).
    """
    ab = alpha_bar_from_log_temp(log_temp)  # ascending in T
    one = torch.ones((1,), dtype=ab.dtype, device=ab.device)
    zero = torch.zeros((1,), dtype=ab.dtype, device=ab.device)
    ab_prev = torch.cat([one, ab[:-1]])
    # Heun: sigma = sqrt(T) = exp(log T / 2) per level (0 at the clean
    # state), and a finite placeholder log-temp for the peeled final step
    sig = torch.exp(0.5 * log_temp)
    sig_prev = torch.cat([zero, sig[:-1]])
    lt_prev_safe = torch.cat([log_temp[:1], log_temp[:-1]])
    # reverse: step 0 is the highest temperature
    ab, ab_prev = ab.flip(0), ab_prev.flip(0)
    sig, sig_prev, lt_prev_safe = sig.flip(0), sig_prev.flip(0), lt_prev_safe.flip(0)
    alpha = ab / ab_prev
    beta = 1.0 - alpha
    omab = 1.0 - ab

    # DPM-Solver++(2M): amplitudes a = sqrt(ab), noise scales s =
    # sqrt(1 - ab) of source and target levels; history weight
    # k = h_i / (2 h_{i-1}) over log-SNR spans h = (lt_src - lt_tgt) / 2,
    # zero on the first step (no history) and the final one (h = inf)
    lt_r = log_temp.flip(0)
    a_src, s_src = torch.sqrt(ab), safe_sqrt(1.0 - ab)
    a_tgt, s_tgt = torch.sqrt(ab_prev), safe_sqrt(1.0 - ab_prev)
    if lt_r.shape[0] > 1:
        h = 0.5 * (lt_r[:-1] - lt_r[1:])
        dpm_k = torch.cat([zero, h[1:] / (2.0 * h[:-1]), zero])
    else:
        dpm_k = zero.clone()
    return {
        "log_temp": lt_r,
        "ab": ab,
        "ab_prev": ab_prev,
        "ddpm_x0": torch.sqrt(ab_prev) * beta / omab,
        "ddpm_xt": torch.sqrt(alpha) * (1.0 - ab_prev) / omab,
        "ddpm_noise": safe_sqrt(beta * (1.0 - ab_prev) / omab),
        "ddim_x0": torch.sqrt(ab_prev),
        "ddim_eps": safe_sqrt(1.0 - ab_prev),
        "sqrt_ab": torch.sqrt(ab),
        "sqrt_ab_prev": torch.sqrt(ab_prev),
        "sig": sig,
        "sig_prev": sig_prev,
        "heun_lt_prev": lt_prev_safe,
        "dpm_cx": s_tgt / s_src,
        "dpm_cd": a_tgt - s_tgt * a_src / s_src,
        "dpm_k": dpm_k,
    }


@dataclasses.dataclass(frozen=True)
class DDPMSampler:
    """Batched reverse-process sampler (parity surface: n_steps /
    batch_size / n_samples / step_type / precision / track_states / custom
    log_temp grid). Runs on ``device``: the CUDA card unless
    ``device="cpu"``."""

    ddpm: DDPM
    scheduler: Scheduler
    n_steps: int
    obj_size: Tuple[int, ...]
    batch_size: int = 1000
    n_samples: int = 1000
    step_type: str = "ddim"
    precision: str = "full"  # "full" | "half" (bf16 model compute)
    track_states: bool = False
    log_temp: Optional[Tensor] = None  # custom grid overrides scheduler
    # with step_type='heun', clamp schedules above HEUN_VALIDATED_MAX_TEMP
    # to the validated envelope (False: run the raw schedule, warn)
    heun_clamp: bool = True
    device: DeviceLike = None
    # the batch axis over a mesh's 'data' axis (parallel.sharded_sampler)
    batch_sharding: Optional[BatchSharding] = None

    def __post_init__(self):
        if self.step_type not in STEP_TYPES:
            raise ValueError(f"step_type must be one of {STEP_TYPES}: "
                             f"{self.step_type!r}")
        if self.precision not in ("full", "half"):
            raise ValueError(f"precision must be 'full' or 'half': "
                             f"{self.precision!r}")
        object.__setattr__(self, "device", resolve_device(self.device))
        if self.step_type == "heun":
            raw = discretize_schedule(
                self.scheduler, self.n_steps,
                max_log_temp=self.ddpm.max_log_temp, log_temp=self.log_temp,
            )
            max_t = float(torch.exp(torch.max(raw)))
            if max_t > HEUN_VALIDATED_MAX_TEMP:
                if self.heun_clamp:
                    warnings.warn(
                        f"step_type='heun': clamping the schedule's max "
                        f"temperature {max_t:.3g} to the validated envelope "
                        f"{HEUN_VALIDATED_MAX_TEMP:.3g} (the PF-ODE diverges "
                        f"above it). Pass heun_clamp=False to run the raw "
                        f"schedule.", stacklevel=2)
                else:
                    warnings.warn(
                        f"step_type='heun' with max schedule temperature "
                        f"{max_t:.3g} > validated envelope "
                        f"{HEUN_VALIDATED_MAX_TEMP:.3g} and heun_clamp=False: "
                        f"the deterministic PF-ODE diverges there.",
                        stacklevel=2)

    def _grid(self) -> Tensor:
        max_lt = self.ddpm.max_log_temp
        if self.step_type == "heun" and self.heun_clamp:
            clamp = math.log(HEUN_VALIDATED_MAX_TEMP)
            max_lt = clamp if max_lt is None else min(float(max_lt), clamp)
        return discretize_schedule(
            self.scheduler, self.n_steps, max_log_temp=max_lt,
            log_temp=self.log_temp, device=self.device,
        )

    def batch_sample(
        self,
        generator: Optional[torch.Generator] = None,
        batch_size: Optional[int] = None,
        *,
        x_init: Optional[Tensor] = None,
        noise: Optional[Tensor] = None,
    ) -> Dict[str, Tensor]:
        """One batch. ``x_init`` (B, *obj_size) and, for step_type 'ddpm',
        ``noise`` (n_steps, B, *obj_size) replace the generator's draws.
        Under ``batch_sharding`` each rank steps its rows of the batch (of
        the global batch's draws, or of the given ``x_init`` and
        ``noise``) and the result is gathered: every rank returns the
        whole batch."""
        bs = batch_size or self.batch_size
        shard = self.batch_sharding
        rows = slice(None) if shard is None else shard.rows(bs)
        if shard is not None:
            generator = shard.generator(generator, bs)
        if x_init is None:
            local = bs if shard is None else bs // shard.size
            x_init = batch_randn((local, *self.obj_size), generator,
                                 device=self.device, dtype=torch.float32)
        elif shard is not None:
            x_init = x_init[rows]
        x_init = x_init.to(self.device, torch.float32)
        if noise is not None:
            noise = noise.to(self.device, torch.float32)
            if noise.shape != (self.n_steps, bs, *x_init.shape[1:]):
                raise ValueError(f"noise must be (n_steps, B, ...) = "
                                 f"{(self.n_steps, bs, *x_init.shape[1:])}: "
                                 f"{tuple(noise.shape)}")
            noise = noise[:, rows]
        with torch.inference_mode():
            x, states = _sample_loop(
                self.ddpm, _step_tables(self._grid()), x_init, self.step_type,
                self.precision == "half", self.track_states, generator, noise,
            )
            if shard is not None:
                x = shard.gather(x)
                if states is not None:
                    states = shard.gather(states.transpose(0, 1)).transpose(0, 1)
        out = {"x": x}
        if states is not None:
            out["states"] = states
        return out

    def sample(self, generator: Optional[torch.Generator] = None
               ) -> Dict[str, np.ndarray]:
        """Generate ``n_samples`` in batches; gathers to host numpy."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        chunks: Dict[str, list] = {}
        for _ in range(math.ceil(self.n_samples / self.batch_size)):
            for k, v in self.batch_sample(generator).items():
                chunks.setdefault(k, []).append(v.cpu().numpy())
        res = {}
        for k, v in chunks.items():
            if k == "states":
                # states are (n_steps, batch, ...): batches concat on axis 1
                res[k] = np.concatenate(v, axis=1)[:, : self.n_samples]
            else:
                res[k] = np.concatenate(v)[: self.n_samples]
        return res


def _sample_loop(
    ddpm: DDPM,
    tables: Dict[str, Tensor],
    xt: Tensor,
    step_type: str,
    half: bool,
    track_states: bool,
    generator: Optional[torch.Generator],
    noise: Optional[Tensor],
    remat: bool = False,
) -> Tuple[Tensor, Optional[Tensor]]:
    n = tables["log_temp"].shape[0]

    def model_in(x):
        return x.to(torch.bfloat16) if half else x

    def tab(i):
        return {k: v[i] for k, v in tables.items()}

    def run(step, *args):
        if remat:
            return checkpoint(step, *args, use_reentrant=False)
        return step(*args)

    def draw():
        return batch_randn(xt.shape, generator, device=xt.device,
                           dtype=torch.float32)

    states = []

    def keep(x):
        if track_states:
            states.append(x)

    if step_type == "dpmpp_2m":
        def dpm_step(t, xt, x0_prev):
            x0 = ddpm.get_predictions(model_in(xt), t["log_temp"]).x0.float()
            d = (1.0 + t["dpm_k"]) * x0 - t["dpm_k"] * x0_prev
            return t["dpm_cx"] * xt + t["dpm_cd"] * d, x0

        x0_prev = torch.zeros_like(xt)
        for i in range(n):
            xt, x0_prev = run(dpm_step, tab(i), xt, x0_prev)
            keep(xt)
    elif step_type == "heun":
        def heun_step(t, xt):
            eps1 = ddpm.get_predictions(model_in(xt), t["log_temp"]).eps.float()
            z = xt / t["sqrt_ab"]
            dsig = t["sig_prev"] - t["sig"]
            x_p = (z + dsig * eps1) * t["sqrt_ab_prev"]
            eps2 = ddpm.get_predictions(
                model_in(x_p), t["heun_lt_prev"]).eps.float()
            return (z + dsig * 0.5 * (eps1 + eps2)) * t["sqrt_ab_prev"]

        def final_step(lt, xt):
            return ddpm.get_predictions(model_in(xt), lt).x0.float()

        # every looped step has a real lower level to re-evaluate at; the
        # final step to sigma = 0 is peeled below and returns x0_hat
        for i in range(n - 1):
            xt = run(heun_step, tab(i), xt)
            keep(xt)
        xt = run(final_step, tables["log_temp"][-1], xt)
        keep(xt)
    else:
        def step(t, xt, xi):
            preds = ddpm.get_predictions(model_in(xt), t["log_temp"])
            x0 = preds.x0.float()
            if step_type == "ddpm":
                return t["ddpm_x0"] * x0 + t["ddpm_xt"] * xt + t["ddpm_noise"] * xi
            return t["ddim_x0"] * x0 + t["ddim_eps"] * preds.eps.float()

        if step_type == "ddpm" and noise is None and remat:
            noise = torch.stack([draw() for _ in range(n)])
        for i in range(n):
            xi = None
            if step_type == "ddpm":
                xi = noise[i] if noise is not None else draw()
            xt = run(step, tab(i), xt, xi)
            keep(xt)
    if not track_states:
        return xt, None
    # the reference stacks states low-T -> high-T; the loop runs hot -> cold
    return xt, torch.stack(states[::-1])


def get_samples(
    ddpm: DDPM,
    scheduler: Scheduler,
    n_steps: int,
    obj_size: Tuple[int, ...],
    n_samples: int,
    batch_size: int = 1000,
    step_type: str = "ddim",
    precision: str = "full",
    track_states: bool = False,
    generator: Optional[torch.Generator] = None,
    log_temp: Optional[Tensor] = None,
    heun_clamp: bool = True,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    sampler = DDPMSampler(
        ddpm=ddpm, scheduler=scheduler, n_steps=n_steps, obj_size=obj_size,
        batch_size=batch_size, n_samples=n_samples, step_type=step_type,
        precision=precision, track_states=track_states, log_temp=log_temp,
        heun_clamp=heun_clamp, device=device,
    )
    return sampler.sample(generator)
