"""Streaming Boltzmann-posterior moments over a dataset, and the analytic
denoiser built on them.

Counterpart of ``pdm_tpu/ops/boltzmann.py`` (``boltzmann_moments_xla``, the
dispatcher, ``true_posterior_mean_x0``, ``true_score``, ``merge_moments``)
and, through ``ops/boltzmann_kernel.py``, of ``ops/boltzmann_pallas.py``.
Given queries ``x`` (B, D), a dataset ``y`` (N, D), a per-query inverse
temperature ``inv_temp`` and a per-query dataset scaling ``y_scale``:

    H_ij = 0.5 * || x_i - y_scale_i * y_j ||^2          (energy)
    g_ij = H_ij * inv_temp_i                            (energy over T)
    p_ij = softmax_j(-g_ij)                             (posterior)

one pass over the dataset with an online softmax (running max and
rescaled fp32 accumulators) gives ``log_z``, the shift-stabilized moments
of g and, optionally, the posterior mean of a per-point payload. The
(B x N) energy matrix never exists whole.

:func:`boltzmann_moments` dispatches on the queries' device: on CUDA
tensors it launches the hand-written kernel of ``csrc/boltzmann_moments.cu``
(it replaces the TPU kernel ``_pallas_moments``) in every precision mode;
on CPU tensors it runs :func:`boltzmann_moments_reference`, the plain
version, whose Gram goes to ``torch.matmul`` in the mode of
``ops/precision.py`` (fp32 by default, never TF32) and whose payload
product is fp32. One deliberate difference from the JAX package: there the
Pallas kernel runs only under ``PDM_BOLTZMANN_IMPL=pallas`` on a TPU and the
XLA path otherwise; the port has no such switch and no fallback. Over a
data mesh (``parallel/``) each rank runs the op on its shard of the
dataset and :func:`merge_moments_over` joins the shards exactly
(:func:`boltzmann_moments_shard_body`).

The posterior mean of the dataset itself is differentiable in the queries,
``inv_temp`` and ``y_scale`` (:class:`PosteriorMean`), as JAX's autodiff of
the XLA scan makes it: for a cotangent c_i of mean_i the VJP is

    w_ij = p_ij (c_i.y_j - c_i.mean_i)                   (dL/dl_ij)
    dL/dx_i       = -inv_temp_i (W_i x_i - y_scale_i sum_j w_ij y_j)
    dL/dinv_temp_i = -sum_j w_ij H_ij = -sum_j w_ij (log_z_i - l_ij) / inv_temp_i
    dL/dy_scale_i = -inv_temp_i sum_j w_ij (y_scale_i |y_j|^2 - x_i.y_j)

with W_i = sum_j w_ij (~0, computed). dL/dinv_temp is shift-stabilized as
the forward's e1_hat: sum_j w_ij = 0, so the energy is taken from log_z
(log_z - l = -log p >= 0), and W's rounding is not multiplied by log_z. :func:`posterior_mean_vjp`
dispatches it as the moments: the kernel of
``csrc/boltzmann_moments_vjp.cu`` on CUDA tensors, the chunked plain
version :func:`posterior_mean_vjp_reference` on CPU tensors. Both recompute
p from the forward's saved ``log_z``; neither forms the whole (B x N)
matrix (the kernels' large-D path holds w for a bounded segment of the
dataset at a time).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import torch
from torch import Tensor

from ..core.temperature import (
    alpha_bar_from_log_temp,
    bcast_right,
    one_minus_alpha_bar_from_log_temp,
)
from .precision import boltzmann_precision_mode, gram, matmul_fp32

DEFAULT_CHUNK = 0  # 0 = adaptive (see _auto_chunk)

# memory budgets for the streamed buffers (fp32 words)
_MAX_LOGIT_WORDS = 128 * 1024 * 1024  # B x chunk logits buffer: 512 MB
_MAX_YCHUNK_WORDS = 64 * 1024 * 1024  # chunk x D dataset tile: 256 MB


def _auto_chunk(B: int, N: int, D: int) -> int:
    """The dataset-axis chunk: as large as the memory budgets allow, a
    multiple of 128, at least 1024 (the JAX package's rule)."""
    by_logits = _MAX_LOGIT_WORDS // max(B, 1)
    by_tile = _MAX_YCHUNK_WORDS // max(D, 1)
    chunk = max(1024, min(by_logits, by_tile))
    chunk = min(chunk, -(-N // 128) * 128)
    return max(128, (chunk // 128) * 128)


class BoltzmannMoments(NamedTuple):
    """Per-query posterior statistics (fp32, shift-stabilized).

    ``shift`` is the online-softmax stabilizer (max of -g); ``e1_hat`` and
    ``e2_hat`` are posterior moments of ``g_hat = g + shift``. Fields are
    (B,) for one temperature and (n_temps, B) for a sweep; ``mean`` has a
    trailing K.
    """

    log_z: Tensor  # logsumexp_j(-g_ij)
    shift: Tensor  # max_j(-g_ij)
    e1_hat: Tensor  # E_p[g + shift]
    e2_hat: Tensor  # E_p[(g + shift)^2]
    mean: Optional[Tensor]  # E_p[values_j]

    @property
    def e1(self) -> Tensor:
        """E_p[g]: the posterior mean energy over T."""
        return self.e1_hat - self.shift

    @property
    def var(self) -> Tensor:
        """Var_p[g] (shift-invariant, cancellation-free)."""
        return torch.clamp(self.e2_hat - torch.square(self.e1_hat), min=0.0)

    def entropy(self, num_objects: int) -> Tensor:
        """S = log Z + E_p[g] - log N, as (log_z - shift) + e1_hat - log N
        so the large shift cancels analytically."""
        return (self.log_z - self.shift) + self.e1_hat - math.log(
            float(num_objects))


class _RawAcc(NamedTuple):
    m: Tensor  # running max of -g
    s0: Tensor  # sum of exp(-g - m)
    s1: Tensor  # sum of exp(-g - m) * g_hat
    s2: Tensor  # sum of exp(-g - m) * g_hat^2
    sy: Optional[Tensor]  # sum of exp(-g - m) * values


def _finalize(acc: _RawAcc) -> BoltzmannMoments:
    return BoltzmannMoments(
        log_z=acc.m + torch.log(acc.s0),
        shift=acc.m,
        e1_hat=acc.s1 / acc.s0,
        e2_hat=acc.s2 / acc.s0,
        mean=None if acc.sy is None else acc.sy / acc.s0[:, None],
    )


def _scan_raw(xf: Tensor, yf: Tensor, inv_temp: Tensor, y_scale: Tensor,
              values: Optional[Tensor], chunk_size: int, mode: str) -> _RawAcc:
    B, D = xf.shape
    N = yf.shape[0]
    chunk = min(chunk_size or _auto_chunk(B, N, D), N)
    x_sq = 0.5 * torch.sum(xf * xf, dim=-1)  # (B,)
    m = torch.full((B,), float("-inf"), dtype=torch.float32, device=xf.device)
    s0 = torch.zeros_like(m)
    s1 = torch.zeros_like(m)
    s2 = torch.zeros_like(m)
    sy = None
    if values is not None:
        sy = torch.zeros((B, values.shape[1]), dtype=torch.float32,
                         device=xf.device)
    for lo in range(0, N, chunk):
        yc = yf[lo:lo + chunk]
        # H_ij = 0.5||x_i||^2 - s_i x_i.y_j + 0.5 s_i^2 ||y_j||^2
        g = gram(xf, yc.T, mode)
        y_sq = 0.5 * torch.sum(yc * yc, dim=-1)
        h = (x_sq[:, None] - y_scale[:, None] * g
             + torch.square(y_scale)[:, None] * y_sq[None, :])
        lg = -h * inv_temp[:, None]
        m_new = torch.maximum(m, torch.max(lg, dim=-1).values)
        finite = torch.isfinite(m)
        c = torch.where(finite, torch.exp(m - m_new), 0.0)
        delta = torch.where(finite, m_new - m, 0.0)
        p = torch.exp(lg - m_new[:, None])
        g_hat = m_new[:, None] - lg  # shift-stabilized energy over T
        s0, s1, s2 = (
            s0 * c + torch.sum(p, dim=-1),
            (s1 + delta * s0) * c + torch.sum(p * g_hat, dim=-1),
            (s2 + 2.0 * delta * s1 + torch.square(delta) * s0) * c
            + torch.sum(p * torch.square(g_hat), dim=-1),
        )
        if sy is not None:
            sy = sy * c[:, None] + matmul_fp32(p, values[lo:lo + chunk])
        m = m_new
    return _RawAcc(m, s0, s1, s2, sy)


def _per_row(v, B: int, device: torch.device) -> Tensor:
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32,
                                              device=device), (B,))


def boltzmann_moments_reference(
    x: Tensor,
    y: Tensor,
    inv_temp,
    y_scale=1.0,
    *,
    values: Optional[Tensor] = None,
    compute_mean: bool = False,
    chunk_size: int = DEFAULT_CHUNK,
    mxu_precision: Optional[str] = None,
) -> BoltzmannMoments:
    """The plain version of the moments kernel (``boltzmann_moments_xla``).

    ``values`` (N, K): per-point payload whose posterior mean is returned
    as ``mean``; ``compute_mean=True`` is sugar for ``values=y``.
    ``mxu_precision``: the Gram's mode (``ops/precision.py``). Runs on the
    tensors' device in plain PyTorch; the payload product is fp32.
    """
    if not isinstance(y, Tensor):
        raise ValueError("the plain version takes the dataset itself, not a "
                         "kernel pack")
    mode = boltzmann_precision_mode(mxu_precision)
    B = x.shape[0]
    xf = x.reshape(B, -1).to(torch.float32)
    yf = y.reshape(y.shape[0], -1).to(torch.float32)
    if values is not None:
        values = values.reshape(values.shape[0], -1).to(torch.float32)
    elif compute_mean:
        values = yf
    return _finalize(_scan_raw(xf, yf, _per_row(inv_temp, B, xf.device),
                               _per_row(y_scale, B, xf.device), values,
                               chunk_size, mode))


def boltzmann_moments(
    x: Tensor,
    y,
    inv_temp,
    y_scale=1.0,
    *,
    values: Optional[Tensor] = None,
    compute_mean: bool = False,
    chunk_size: int = DEFAULT_CHUNK,
    mxu_precision: Optional[str] = None,
) -> BoltzmannMoments:
    """Moments of the Boltzmann posterior of each query over ``y``.

    ``y`` is the dataset (N, ...) or, on CUDA, its kernel pack
    (``ops/boltzmann_sweep.prepare_y`` in the same mode, reused across
    calls; ``values`` must then be given for a mean). On CUDA tensors the
    kernel (two launches, ``boltzmann_moments.launches``; no input may
    require grad: the kernel has no backward, as the TPU kernel has none),
    on CPU tensors the plain version; any other device raises.
    ``chunk_size`` only splits the plain version's passes. While
    ``torch.export`` traces (``torch.compiler.is_exporting()``), the call
    is the custom op ``pdm::boltzmann_moments`` on every device
    (``ops/library.py::traced_moments``).
    """
    mode = boltzmann_precision_mode(mxu_precision)
    if torch.compiler.is_exporting():
        from .library import traced_moments

        return traced_moments(x, y, inv_temp, y_scale, values=values,
                              compute_mean=compute_mean, mode=mode)
    if x.device.type == "cpu":
        return boltzmann_moments_reference(
            x, y, inv_temp, y_scale, values=values, compute_mean=compute_mean,
            chunk_size=chunk_size, mxu_precision=mode)
    if x.device.type != "cuda":
        raise ValueError(f"boltzmann_moments runs on CUDA (the kernel) or the "
                         f"CPU (the plain version), not on {x.device}")
    from .boltzmann_kernel import boltzmann_moments_cuda

    return boltzmann_moments_cuda(x, y, inv_temp, y_scale, values=values,
                                  compute_mean=compute_mean, mode=mode)


# kernel launches since the last reset (set to 0 to reset); the wrapper in
# ops/boltzmann_kernel.py counts
boltzmann_moments.launches = 0


class MeanVJP(NamedTuple):
    """The posterior mean's VJP: gradients of <c, mean> (fp32)."""

    x: Tensor  # (B, D)
    inv_temp: Tensor  # (B,)
    y_scale: Tensor  # (B,)


def posterior_mean_vjp_reference(
    x: Tensor,
    y: Tensor,
    inv_temp,
    y_scale,
    log_z: Tensor,
    mean: Tensor,
    cot: Tensor,
    *,
    chunk_size: int = DEFAULT_CHUNK,
    mxu_precision: Optional[str] = None,
) -> MeanVJP:
    """The plain version of the VJP kernel: the VJP of mean = E_p[y_j]
    (the dataset as the payload) for the cotangent ``cot`` (B, D), from the
    forward's ``log_z`` and ``mean``. One chunked pass over the dataset
    recomputes p = exp(l - log_z); the Grams x.y and cot.y in
    ``mxu_precision``'s arithmetic, the product w.y in fp32.
    dL/dinv_temp is shift-stabilized (the module docstring): -A_i /
    inv_temp_i with A_i = sum_j w_ij (log_z_i - l_ij)."""
    mode = boltzmann_precision_mode(mxu_precision)
    B = x.shape[0]
    xf = x.reshape(B, -1).to(torch.float32)
    yf = y.reshape(y.shape[0], -1).to(torch.float32)
    cf = cot.reshape(B, -1).to(torch.float32)
    N, D = yf.shape
    it = _per_row(inv_temp, B, xf.device)
    s = _per_row(y_scale, B, xf.device)
    log_z = log_z.to(torch.float32)
    cm = torch.sum(cf * mean.reshape(B, -1).to(torch.float32), dim=-1)
    x_sq = 0.5 * torch.sum(xf * xf, dim=-1)
    w_sum = torch.zeros_like(x_sq)
    a_sum = torch.zeros_like(x_sq)
    s_sum = torch.zeros_like(x_sq)
    wy = torch.zeros_like(xf)
    chunk = min(chunk_size or _auto_chunk(B, N, D), N)
    for lo in range(0, N, chunk):
        yc = yf[lo:lo + chunk]
        g = gram(xf, yc.T, mode)
        y_sq = 0.5 * torch.sum(yc * yc, dim=-1)
        h = (x_sq[:, None] - s[:, None] * g
             + torch.square(s)[:, None] * y_sq[None, :])
        gz = log_z[:, None] + h * it[:, None]  # log_z - l = -log p
        w = torch.exp(-gz) * (gram(cf, yc.T, mode) - cm[:, None])
        w_sum = w_sum + torch.sum(w, dim=-1)
        a_sum = a_sum + torch.sum(w * gz, dim=-1)
        s_sum = s_sum + torch.sum(
            w * ((2.0 * s)[:, None] * y_sq[None, :] - g), dim=-1)
        wy = wy + matmul_fp32(w, yc)
    return MeanVJP(
        x=-it[:, None] * (w_sum[:, None] * xf - s[:, None] * wy),
        inv_temp=-a_sum / it,
        y_scale=-it * s_sum,
    )


def posterior_mean_vjp(x: Tensor, y, inv_temp, y_scale, log_z: Tensor,
                       mean: Tensor, cot: Tensor, *,
                       values: Optional[Tensor] = None,
                       mxu_precision: Optional[str] = None) -> MeanVJP:
    """The VJP of the posterior mean of the dataset (see the module
    docstring). ``y`` is the dataset or, on CUDA, its kernel pack with the
    dataset itself as ``values``; ``log_z`` and ``mean`` are the forward's.
    On CUDA tensors the kernels (two launches at D <= 4 in fp32, three at
    one segment otherwise: ``ops.boltzmann_kernel.plan_vjp``; counted on
    ``posterior_mean_vjp.launches``), on CPU tensors the plain version; any
    other device raises."""
    mode = boltzmann_precision_mode(mxu_precision)
    if x.device.type == "cpu":
        return posterior_mean_vjp_reference(x, y, inv_temp, y_scale, log_z,
                                            mean, cot, mxu_precision=mode)
    if x.device.type != "cuda":
        raise ValueError(f"posterior_mean_vjp runs on CUDA (the kernel) or "
                         f"the CPU (the plain version), not on {x.device}")
    from .boltzmann_kernel import posterior_mean_vjp_cuda

    return posterior_mean_vjp_cuda(x, y, inv_temp, y_scale, log_z, mean, cot,
                                   values=values, mode=mode)


# kernel launches since the last reset (set to 0 to reset); the wrapper in
# ops/boltzmann_kernel.py counts
posterior_mean_vjp.launches = 0


class PosteriorMean(torch.autograd.Function):
    """mean_i = E_p[y_j] of the Boltzmann posterior over the dataset,
    differentiable in ``x`` (B, D), ``inv_temp`` (B,) and ``y_scale`` (B,).
    Forward: the moments (row 7's kernel on CUDA, the plain version on the
    CPU); backward: :func:`posterior_mean_vjp` from the saved ``log_z``."""

    @staticmethod
    def forward(ctx, x, inv_temp, y_scale, data, values, mode):
        xd, it, s = x.detach(), inv_temp.detach(), y_scale.detach()
        mom = boltzmann_moments(xd, data, it, s, values=values,
                                compute_mean=values is None, mxu_precision=mode)
        ctx.data, ctx.values, ctx.mode = data, values, mode
        ctx.save_for_backward(xd, it, s, mom.log_z, mom.mean)
        return mom.mean

    @staticmethod
    def backward(ctx, g_mean):
        x, it, s, log_z, mean = ctx.saved_tensors
        vjp = posterior_mean_vjp(x, ctx.data, it, s, log_z, mean, g_mean,
                                 values=ctx.values, mxu_precision=ctx.mode)
        return vjp.x, vjp.inv_temp, vjp.y_scale, None, None, None


def true_posterior_mean_x0(xt: Tensor, log_temp, data, *,
                           values: Optional[Tensor] = None) -> Tensor:
    """Bayes-optimal denoiser E[x0 | xt] over a finite dataset (VP
    process): energy 0.5 ||xt - sqrt(ab) x0_j||^2 at temperature 1 - ab.
    Cast back to ``xt``'s dtype. ``data`` is the dataset or, on CUDA, its
    kernel pack, with the dataset itself as ``values``. Differentiable in
    ``xt`` and ``log_temp`` (:class:`PosteriorMean`) when grad mode is on
    and either requires grad; otherwise the moments op's call alone.

    Under grad the payload must be the dataset (``values`` None, or given
    with a pack): the VJP reads the dataset as the payload (x.y and c.y on
    its pack, w.y on its rows), and JAX differentiates only that mean."""
    B = xt.shape[0]
    log_temp = _per_row(log_temp, B, xt.device)
    ab = alpha_bar_from_log_temp(log_temp)
    omab = one_minus_alpha_bar_from_log_temp(log_temp)
    if torch.is_grad_enabled() and (xt.requires_grad or log_temp.requires_grad):
        if isinstance(data, Tensor):
            dataset = values is None or values is data
        else:  # a kernel pack: the dataset itself comes as values
            dataset = (values is not None and values.shape[0] == data.n
                       and values[0].numel() == data.d)
        if not dataset:
            raise ValueError(
                "the posterior mean is differentiable only with the dataset "
                "as its payload (values None, or the pack's own dataset); a "
                "differentiable payload mean is not ported (ROADMAP.md)")
        mean = PosteriorMean.apply(xt.reshape(B, -1), 1.0 / omab,
                                   torch.sqrt(ab), data, values,
                                   boltzmann_precision_mode())
        return mean.reshape(xt.shape).to(xt.dtype)
    out = boltzmann_moments(xt, data, inv_temp=1.0 / omab,
                            y_scale=torch.sqrt(ab), values=values,
                            compute_mean=values is None)
    return out.mean.reshape(xt.shape).to(xt.dtype)


def true_score(xt: Tensor, log_temp, data, *,
               values: Optional[Tensor] = None) -> Tensor:
    """Analytic marginal score of the VP-noised data distribution:
    (sqrt(ab) E[x0 | xt] - xt) / (1 - ab)."""
    B = xt.shape[0]
    log_temp = _per_row(log_temp, B, xt.device)
    ab = bcast_right(alpha_bar_from_log_temp(log_temp), xt.ndim)
    omab = bcast_right(one_minus_alpha_bar_from_log_temp(log_temp), xt.ndim)
    mean = true_posterior_mean_x0(xt, log_temp, data, values=values)
    return (torch.sqrt(ab) * mean - xt) / omab


def _rescaled_sums(mom: BoltzmannMoments, m_g: Tensor) -> List[Tensor]:
    """One part's partition sums (s0, s1, s2, and the payload's s0 * mean
    when there is a mean) rescaled from its shift to ``m_g``. A part with
    no finite logit (an empty shard) adds zeros: JAX's isfinite guards."""
    finite = torch.isfinite(mom.shift)
    c = torch.where(finite, torch.exp(mom.shift - m_g), 0.0)
    delta = torch.where(finite, m_g - mom.shift, 0.0)
    s0 = torch.where(finite, torch.exp(mom.log_z - mom.shift), 0.0)
    s1 = torch.where(finite, mom.e1_hat * s0, 0.0)
    s2 = torch.where(finite, mom.e2_hat * s0, 0.0)
    sums = [s0 * c, (s1 + delta * s0) * c,
            (s2 + 2.0 * delta * s1 + torch.square(delta) * s0) * c]
    if mom.mean is not None:
        sums.append(torch.where(finite[..., None],
                                mom.mean * (s0 * c)[..., None], 0.0))
    return sums


def _from_sums(m_g: Tensor, s0: Tensor, s1: Tensor, s2: Tensor,
               sy: Optional[Tensor] = None) -> BoltzmannMoments:
    return BoltzmannMoments(
        log_z=m_g + torch.log(s0), shift=m_g, e1_hat=s1 / s0, e2_hat=s2 / s0,
        mean=None if sy is None else sy / s0[..., None])


def merge_moments(a: BoltzmannMoments, b: BoltzmannMoments) -> BoltzmannMoments:
    """Exact two-way merge of shift-stabilized moments of two disjoint
    parts of a dataset: global shift by max, each side's partition sums
    rescaled by exp(m - m_g), added. Shapes broadcast, so it merges the
    single-temperature (B,) layout and the sweep's (n_temps, B) alike;
    ``mean`` merges partition-weighted when both sides have it."""
    m_g = torch.maximum(a.shift, b.shift)
    keep = 4 if a.mean is not None and b.mean is not None else 3
    sums = zip(_rescaled_sums(a, m_g)[:keep], _rescaled_sums(b, m_g)[:keep])
    return _from_sums(m_g, *[sa + sb for sa, sb in sums])


def merge_moments_over(mom: BoltzmannMoments, mesh) -> BoltzmannMoments:
    """The exact merge of every data rank's moments of its own shard of
    the dataset (``merge_moments``' algebra over the mesh): the global
    shift by an all-reduce MAX, each rank's sums rescaled to it, then one
    all-reduce SUM of all the sums in one buffer. Every rank returns the
    merged moments."""
    m_g = mesh.all_reduce(mom.shift.clone(), "max")
    sums = _rescaled_sums(mom, m_g)
    flat = mesh.all_reduce(torch.cat([t.reshape(-1) for t in sums]))
    parts = flat.split([t.numel() for t in sums])
    return _from_sums(m_g, *[p.view(t.shape) for p, t in zip(parts, sums)])


def boltzmann_moments_shard_body(
    x: Tensor,
    y_shard,
    inv_temp,
    y_scale=1.0,
    *,
    mesh,
    values: Optional[Tensor] = None,
    compute_mean: bool = False,
    chunk_size: int = DEFAULT_CHUNK,
    mxu_precision: Optional[str] = None,
) -> BoltzmannMoments:
    """The moments over a dataset split across the mesh's data axis: this
    rank's ``y_shard`` (its ``values`` with it) through
    :func:`boltzmann_moments` (the kernel on the card), the queries
    replicated, then :func:`merge_moments_over`. Shards may differ in
    size; an empty one adds nothing."""
    n = y_shard.shape[0] if isinstance(y_shard, Tensor) else y_shard.n
    if n:
        mom = boltzmann_moments(x, y_shard, inv_temp, y_scale, values=values,
                                compute_mean=compute_mean,
                                chunk_size=chunk_size,
                                mxu_precision=mxu_precision)
    else:
        B = x.shape[0]
        ninf = torch.full((B,), float("-inf"), device=x.device)
        zero = torch.zeros((B,), device=x.device)
        k = (math.prod(values.shape[1:]) if values is not None
             else math.prod(x.shape[1:]) if compute_mean else None)
        mom = BoltzmannMoments(
            ninf, ninf, zero, zero,
            None if k is None else torch.zeros((B, k), device=x.device))
    return merge_moments_over(mom, mesh)
