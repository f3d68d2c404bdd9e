"""Thermodynamic sweeps over noise levels: free energy, entropy, heat
capacity and the empirical Fisher-Rao metric, from one fused sweep per
batch of trajectory starts.

Counterpart of ``pdm_tpu/stats/sweep.py``. Noise the data as
``xt = x0 + sqrt(T) eps``; the Boltzmann posterior over the dataset at
temperature T gives

    F(T)  = -T E[log Z]                    (free energy)
    S(T)  = E[log Z + U/T] - log N          (entropy)
    C(T)  = Var_p[H/T]                      (heat capacity, = dS/dlogT)
    G(T)  = Var_p[H/T]                      (empirical Fisher-Rao metric in
                                             lambda = log T)

MC protocol (the reference's): ``n_samples`` trajectory starts drawn
uniformly from the dataset, in batches; ONE noise draw per batch shared
across all temperatures (common random numbers, which lets the sweep
visit the dataset once for every temperature); batch means averaged. The
optional metric regularization (a global floor or an adaptive k-NN
sigma^2 per point) rides the sweep's payload channel.

Randomness comes from a ``torch.Generator`` on the sweep's device (each
batch draws its indices, then its noise), or from explicit per-batch
``draws`` [(idx (bs,), eps (bs, D)), ...], so a test can replay another
implementation's draws. ``device=None`` means the CUDA card. The dataset
is packed for the sweep kernel once per sweep.

``mesh=``: the dataset axis shards over the mesh's 'data' axis. Every
rank holds the whole dataset and draws the same starts and noise (the
same seeds); each packs and sweeps its shard of the dataset through the
kernel (``ops/boltzmann_sweep.py::boltzmann_sweep_shard_body``), and the
moments merge exactly over the ranks, so every rank returns the result.
As in JAX, the remainder of N under the axis size is dropped (and the
k-NN floor with it), and the entropy counts the points kept.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core.device import DeviceLike, resolve_device
from ..ops.boltzmann import merge_moments
from ..ops.boltzmann_sweep import (
    boltzmann_sweep,
    boltzmann_sweep_shard_body,
    prepare_y,
)
from ..ops.knn import knn_sqdist
from ..ops.precision import boltzmann_precision_mode, sweep_precision_mode
from ..parallel.mesh import batch_sharding

Draws = Sequence[Tuple[Tensor, Tensor]]


def _regularized_metric(
    var_g: np.ndarray,  # (n_temps, B)
    temp: np.ndarray,
    regularize: bool,
    sigma_eff: Optional[np.ndarray],
    global_sigma_reg_sq: float,
) -> np.ndarray:
    """The manifold-regularization floor per (temp, sample), then the mean
    over samples. G_reg = 0.5 s2 (s2 + 2T) / (s2 + T)^2, the metric of a
    Gaussian cluster of variance s2 (reference stats.py:97-108)."""
    if not regularize:
        return var_g.mean(axis=1)
    t = temp[:, None]
    s2 = sigma_eff if sigma_eff is not None else global_sigma_reg_sq
    g_reg = 0.5 * s2 * (s2 + 2 * t) / (s2 + t) ** 2
    return np.maximum(var_g, g_reg).mean(axis=1)


def _batches(n_samples: int, batch_size: int) -> List[int]:
    return [min(batch_size, n_samples - lo) for lo in range(0, n_samples, batch_size)]


def _draw(n: int, d: int, sizes: List[int], generator, draws: Optional[Draws],
          dev: torch.device) -> List[Tuple[Tensor, Tensor]]:
    """Each batch's (indices, shared noise), from ``draws`` or drawn."""
    if draws is not None:
        if [int(i.shape[0]) for i, _ in draws] != sizes:
            raise ValueError(f"draws must hold batches of sizes {sizes}")
        return [(torch.as_tensor(i, device=dev).long(),
                 torch.as_tensor(e, dtype=torch.float32, device=dev))
                for i, e in draws]
    out = []
    for bs in sizes:
        idx = torch.randint(0, n, (bs,), generator=generator, device=dev)
        eps = torch.randn((bs, d), generator=generator, device=dev)
        out.append((idx, eps))
    return out


def _artifact(temp, entropy, free_energy, var_g, metric, tr_sigma0):
    return {
        "temp": np.asarray(temp),
        "entropy": entropy,
        "free_energy": free_energy,
        "heat_capacity": var_g.mean(axis=1),
        "metric": metric,
        "log_temp": np.log(np.asarray(temp)),
        "dataset_tr_sigma0": np.asarray(tr_sigma0),
    }


def thermo_sweep(
    data,
    temp: np.ndarray,
    n_samples: int = 1024,
    batch_size: int = 1024,
    *,
    generator: Optional[torch.Generator] = None,
    draws: Optional[Draws] = None,
    regularize: bool = False,
    adaptive_knn: bool = False,
    knn_k: int = 5,
    sigma_reg_scale: float = 1.0,
    global_sigma_reg_sq: float = 1e-3,
    stream_chunk: Optional[int] = None,
    mesh=None,
    device: DeviceLike = None,
) -> Dict[str, np.ndarray]:
    """Full MC sweep: entropy, free energy, heat capacity, metric.

    ``data`` (N, ...): a tensor or array, moved to ``device`` whole.
    Returns the union of both reference artifact contracts: temp /
    entropy / free_energy / heat_capacity / metric / log_temp /
    dataset_tr_sigma0 (numpy).

    ``stream_chunk``: the tier for datasets larger than device memory.
    ``data`` stays on the host; each MC batch visits it in chunks of this
    many points through the sweep, and the per-chunk moments join with the
    exact shift-stabilized merge. It cannot combine with ``mesh`` or
    ``adaptive_knn`` (the k-NN graph needs the dataset on the device).

    ``mesh``: the dataset's shards over the mesh's 'data' axis (module
    docstring).
    """
    dev = resolve_device(device)
    if stream_chunk is not None:
        if mesh is not None or adaptive_knn:
            raise ValueError(
                "stream_chunk is a single-device host-streaming path; "
                "it cannot combine with mesh= or adaptive_knn")
        return _thermo_sweep_streamed(
            data, temp, n_samples, batch_size, stream_chunk,
            regularize=regularize, global_sigma_reg_sq=global_sigma_reg_sq,
            generator=generator, draws=draws, dev=dev)
    data2d = torch.as_tensor(data, dtype=torch.float32, device=dev)
    data2d = data2d.reshape(data2d.shape[0], -1)
    n, d = data2d.shape
    temp_t = torch.as_tensor(np.asarray(temp), dtype=torch.float32, device=dev)
    mode = sweep_precision_mode()

    values = None
    with_knn = bool(regularize and adaptive_knn)
    if with_knn:
        d_k = knn_sqdist(data2d, k=knn_k, mxu_precision=boltzmann_precision_mode())
        values = (d_k * (sigma_reg_scale / float(d)))[:, None]

    shard, n_objects = data2d, n
    if mesh is not None:
        # this rank's shard of the first n_keep points (the remainder
        # under the axis size dropped, as JAX's shard_map needs)
        n_objects = (n // mesh.shape["data"]) * mesh.shape["data"]
        rows = batch_sharding(mesh).rows(n_objects)
        shard = data2d[rows]
        if values is not None:
            values = values[rows]
    prep = prepare_y(shard, mode)  # the dataset packed once for the sweep
    sizes = _batches(n_samples, batch_size)
    entropy_acc, free_energy_acc, var_chunks, sigma_chunks = [], [], [], []
    for idx, eps in _draw(n, d, sizes, generator, draws, dev):
        bs = idx.shape[0]
        if mesh is None:
            mom = boltzmann_sweep(data2d[idx], eps, prep, temp_t,
                                  values=values, mxu_precision=mode)
        else:
            mom = boltzmann_sweep_shard_body(data2d[idx], eps, prep, temp_t,
                                             mesh=mesh, values=values,
                                             mxu_precision=mode)
        entropy_acc.append(mom.entropy(n_objects).mean(dim=1).cpu().numpy() * bs)
        free_energy_acc.append(
            (-temp_t[:, None] * mom.log_z).mean(dim=1).cpu().numpy() * bs)
        var_chunks.append(mom.var.cpu().numpy())
        if with_knn:
            sigma_chunks.append(mom.mean[:, :, 0].cpu().numpy())
    seen = sum(sizes)
    var_g = np.concatenate(var_chunks, axis=1)  # (n_temps, n_samples)
    sigma_eff = np.concatenate(sigma_chunks, axis=1) if with_knn else None
    metric = _regularized_metric(var_g, np.asarray(temp, np.float64), regularize,
                                 sigma_eff, global_sigma_reg_sq)
    tr_sigma0 = float(torch.var(data2d, dim=0, unbiased=True).sum())
    return _artifact(temp, np.sum(entropy_acc, axis=0) / seen,
                     np.sum(free_energy_acc, axis=0) / seen, var_g, metric,
                     tr_sigma0)


def _thermo_sweep_streamed(
    data,
    temp: np.ndarray,
    n_samples: int,
    batch_size: int,
    stream_chunk: int,
    *,
    regularize: bool,
    global_sigma_reg_sq: float,
    generator: Optional[torch.Generator],
    draws: Optional[Draws],
    dev: torch.device,
) -> Dict[str, np.ndarray]:
    """The host-streaming tier: every batch's starts and noise drawn up
    front, then chunk-outer / batch-inner, so the dataset crosses to the
    device once per sweep and each chunk is packed once; the per-chunk
    moments join exactly, so the result is the device-resident sweep's up
    to rounding."""
    data_np = np.asarray(data)
    data_np = data_np.reshape(data_np.shape[0], -1)
    n, d = data_np.shape
    temp_t = torch.as_tensor(np.asarray(temp), dtype=torch.float32, device=dev)
    mode = sweep_precision_mode()

    # the dataset's trace of covariance, streamed in float64 (one pass)
    s1 = np.zeros(d, np.float64)
    s2 = np.zeros(d, np.float64)
    for lo in range(0, n, stream_chunk):
        c = data_np[lo:lo + stream_chunk].astype(np.float64)
        s1 += c.sum(axis=0)
        s2 += np.square(c).sum(axis=0)
    tr_sigma0 = float(((s2 - np.square(s1) / n) / (n - 1)).sum())

    sizes = _batches(n_samples, batch_size)
    batches = [(torch.as_tensor(data_np[idx.cpu().numpy()], dtype=torch.float32,
                                device=dev), eps)
               for idx, eps in _draw(n, d, sizes, generator, draws, dev)]
    moms = [None] * len(batches)
    for lo in range(0, n, stream_chunk):
        prep = prepare_y(torch.as_tensor(data_np[lo:lo + stream_chunk],
                                         dtype=torch.float32, device=dev), mode)
        for i, (x0, eps) in enumerate(batches):
            m = boltzmann_sweep(x0, eps, prep, temp_t, mxu_precision=mode)
            moms[i] = m if moms[i] is None else merge_moments(moms[i], m)

    seen = sum(sizes)
    entropy = sum(m.entropy(n).mean(dim=1).cpu().numpy() * bs
                  for m, bs in zip(moms, sizes)) / seen
    free_energy = sum((-temp_t[:, None] * m.log_z).mean(dim=1).cpu().numpy() * bs
                      for m, bs in zip(moms, sizes)) / seen
    var_g = np.concatenate([m.var.cpu().numpy() for m in moms], axis=1)
    metric = _regularized_metric(var_g, np.asarray(temp, np.float64), regularize,
                                 None, global_sigma_reg_sq)
    return _artifact(temp, entropy, free_energy, var_g, metric, tr_sigma0)


def forward_stats(data, temp: np.ndarray, n_samples: int = 1024,
                  batch_size: int = 1024, *, generator=None, draws=None,
                  stream_chunk: Optional[int] = None, mesh=None,
                  device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """The forward-stats artifact: {temp, entropy} (reference
    utils/stats.py compute_stats), plus the free energy and heat capacity
    that come with the same sweep. ``mesh`` shards the dataset axis."""
    out = thermo_sweep(data, temp, n_samples, batch_size, generator=generator,
                       draws=draws, stream_chunk=stream_chunk, mesh=mesh,
                       device=device)
    return {k: out[k] for k in ("temp", "entropy", "free_energy",
                                "heat_capacity")}


def metric_stats(data, temp: np.ndarray, n_samples: int = 1024,
                 batch_size: int = 1024, *, generator=None, draws=None,
                 regularize: bool = False, adaptive_knn: bool = False,
                 knn_k: int = 5, sigma_reg_scale: float = 1.0,
                 stream_chunk: Optional[int] = None, mesh=None,
                 device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """The metric-stats artifact: {temp, metric, log_temp,
    dataset_tr_sigma0} (reference utils/stats.py compute_metric_stats).
    ``mesh`` shards the dataset axis."""
    out = thermo_sweep(data, temp, n_samples, batch_size, generator=generator,
                       draws=draws, regularize=regularize,
                       adaptive_knn=adaptive_knn, knn_k=knn_k,
                       sigma_reg_scale=sigma_reg_scale,
                       stream_chunk=stream_chunk, mesh=mesh, device=device)
    return {k: out[k] for k in ("temp", "metric", "log_temp",
                                "dataset_tr_sigma0")}
