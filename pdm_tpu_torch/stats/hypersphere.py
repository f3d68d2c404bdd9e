"""Closed-form thermodynamics of data uniform on the unit hypersphere.

A port-local copy of ``pdm_tpu/stats/hypersphere.py``: the known-answer
oracle for the MC estimators in :mod:`pdm_tpu_torch.stats.sweep` and the
closed forms ``analyze_synthetic_stats`` uses (the reference's
``hypersphere.ipynb`` cell 0 derives the same quantities via modified
Bessel functions I_nu).

Setup: x0 ~ Uniform(S^{d-1}), forward noising x_t = x0 + sqrt(T) * eps
(the VE convention the stats sweep uses). Conditioned on |x_t| = r, the
Boltzmann posterior over the sphere with energy H = |x_t - y|^2 / 2 is a
von Mises-Fisher distribution in cos(theta) with concentration z = r / T:

    Z(r, T)  = Gamma(d/2) (2T/r)^nu I_nu(r/T) * exp(-(r^2+1)/(2T)),
    U(r, T)  = (r^2+1)/2 - r * m(z),          m(z) = I_{nu+1}(z)/I_nu(z),
    S(r, T)  = log Z + U / T,
    C(r, T)  = Var[H]/T^2 = r^2 (1 - m^2 - (d-1) m / z) / T^2,

with nu = (d-2)/2. The marginal over r is the noncentral-chi density
p(r|T) = r^{d/2} exp(-(r^2+1)/(2T)) I_nu(r/T) / T.

All evaluation is log-stable: ``log_iv`` never materializes I_nu itself
(it overflows past z ~ 700), and the Bessel *ratio* m(z) is computed from
the exponentially-scaled ``ive`` so the low-temperature regime (z ~ 1e6)
keeps the O(1/z) correction that the raw large-z asymptote of log I_nu
cancels out.

Host-side float64 numpy (and ``scipy.special``) on purpose: this is the
exact oracle the card's estimators are tested against, not a compute path.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
from scipy.special import gammaln, ive

ArrayLike = Union[float, np.ndarray]
# numpy 2 renamed trapz; the card's numpy may be either
_trapezoid = getattr(np, "trapezoid", None) or np.trapz


def _log_iv_series(nu: float, z: np.ndarray) -> np.ndarray:
    """log I_nu(z) by log-space summation of the ascending series.

    Valid for ANY (nu, z) in float64 — the terms
    t_k = (2k+nu) log(z/2) - lgamma(k+1) - lgamma(nu+k+1) peak at
    k* = (-(nu+1) + sqrt((nu+1)^2 + z^2)) / 2 and are summed by
    logsumexp, so neither the peak magnitude nor the count overflows.
    Used where the exponentially-scaled ``ive`` underflows (z well below
    nu at large nu); O(K * len(z)) host work, oracle-path only.
    """
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    zs = np.clip(z, 1e-300, None)
    kstar = 0.5 * (-(nu + 1.0) + np.sqrt((nu + 1.0) ** 2 + float(zs.max()) ** 2))
    K = int(kstar + 12.0 * np.sqrt(kstar + 1.0) + 30.0)
    k = np.arange(K, dtype=np.float64)[:, None]
    logt = (
        (2.0 * k + nu) * np.log(zs / 2.0)[None, :]
        - gammaln(k + 1.0)
        - gammaln(nu + k + 1.0)
    )
    m = logt.max(axis=0)
    return m + np.log(np.exp(logt - m).sum(axis=0))


def log_iv(nu: float, z: ArrayLike) -> np.ndarray:
    """log I_nu(z) for z >= 0, stable across the full range.

    Three regimes: a series head ``nu*log(z/2) - lgamma(nu+1)`` as z -> 0,
    the exact exponentially-scaled Bessel ``log(ive) + z`` wherever ive is
    representable, and the full log-space series where ive underflows —
    which at large nu is NOT just tiny z: ive(nu, z) vanishes for all
    z <~ nu (e.g. ive(1535, 100) == 0.0), exactly the regime a
    high-dimensional sphere oracle lives in.
    """
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    small = 1e-6 * (nu + 1.0)
    zs = np.clip(z, 1e-300, None)
    head = nu * np.log(zs / 2.0) - gammaln(nu + 1.0)
    scaled = ive(nu, zs)
    mid = np.log(np.clip(scaled, 1e-300, None)) + z
    out = np.where(z < small, head, mid)
    need_series = (z >= small) & (scaled < 1e-280)
    if np.any(need_series):
        out[need_series] = _log_iv_series(nu, zs[need_series])
    return out


def _bessel_ratio(nu: float, z: ArrayLike) -> np.ndarray:
    """m(z) = I_{nu+1}(z) / I_nu(z) via the scaled ive quotient.

    Where either ive underflows (z -> 0, or z <~ nu at large nu) the
    quotient degenerates; splice in the exact small-z limit z/(2nu+2)
    and the log-series difference respectively.
    """
    z = np.atleast_1d(np.asarray(z, dtype=np.float64))
    small = 1e-4 * (nu + 1.0)
    zs = np.clip(z, small, None)
    lo = ive(nu, zs)
    quot = ive(nu + 1.0, zs) / np.clip(lo, 1e-300, None)
    out = np.where(z < small, z / (2.0 * nu + 2.0), quot)
    need_series = (z >= small) & (lo < 1e-280)
    if np.any(need_series):
        zn = zs[need_series]
        out[need_series] = np.exp(
            _log_iv_series(nu + 1.0, zn) - _log_iv_series(nu, zn)
        )
    return out


def log_partition(r: ArrayLike, temp: ArrayLike, d: int) -> np.ndarray:
    """log Z(r, T) of the sphere posterior at observation radius r."""
    r = np.asarray(r, dtype=np.float64)
    temp = np.asarray(temp, dtype=np.float64)
    nu = (d - 2) / 2.0
    z = r / temp
    return (
        gammaln(d / 2.0)
        - (r**2 + 1.0) / (2.0 * temp)
        + nu * (np.log(2.0 * temp) - np.log(r))
        + log_iv(nu, z)
    )


def internal_energy(r: ArrayLike, temp: ArrayLike, d: int) -> np.ndarray:
    """U(r, T) = E[H] under the Boltzmann posterior on the sphere."""
    r = np.asarray(r, dtype=np.float64)
    temp = np.asarray(temp, dtype=np.float64)
    m = _bessel_ratio((d - 2) / 2.0, r / temp)
    return 0.5 * (r**2 + 1.0) - r * m


def entropy(r: ArrayLike, temp: ArrayLike, d: int) -> np.ndarray:
    """S(r, T) = log Z + U/T (0 at T -> inf where posterior = prior)."""
    return log_partition(r, temp, d) + internal_energy(r, temp, d) / np.asarray(
        temp, dtype=np.float64
    )


def heat_capacity(r: ArrayLike, temp: ArrayLike, d: int) -> np.ndarray:
    """C(r, T) = Var[H]/T^2 = T dS/dT at fixed r.

    Var[H] = r^2 Var[cos theta]; the vMF identity gives
    Var[cos theta] = 1 - m^2 - (d-1) m / z exactly.
    """
    r = np.asarray(r, dtype=np.float64)
    temp = np.asarray(temp, dtype=np.float64)
    z = r / temp
    m = _bessel_ratio((d - 2) / 2.0, z)
    var_cos = 1.0 - m**2 - (d - 1.0) * m / np.clip(z, 1e-300, None)
    return (r**2) * np.clip(var_cos, 0.0, None) / temp**2


def radius_log_density(r: ArrayLike, temp: float, d: int) -> np.ndarray:
    """log p(r | T): noncentral-chi density of |x0 + sqrt(T) eps|, |x0|=1."""
    r = np.asarray(r, dtype=np.float64)
    nu = (d - 2) / 2.0
    return (
        (d / 2.0) * np.log(np.clip(r, 1e-300, None))
        - (r**2 + 1.0) / (2.0 * temp)
        - np.log(temp)
        + log_iv(nu, r / temp)
    )


def _radius_grid(temp: float, d: int, n_r: int) -> np.ndarray:
    """Quadrature grid covering the bulk of p(r | T)."""
    m2 = 1.0 + d * temp  # E|x_t|^2
    s2 = np.sqrt(2.0 * d * temp**2 + 4.0 * temp)  # std of |x_t|^2
    lo2 = max(m2 - 14.0 * s2, 0.0)
    hi2 = m2 + 14.0 * s2
    return np.sqrt(np.linspace(lo2 + 1e-12, hi2, n_r))


def marginal_stats(
    temps: ArrayLike, d: int, n_r: int = 4096
) -> Dict[str, np.ndarray]:
    """Exact S(T), C(T), U(T), log Z(T) marginalized over the radius.

    Quadrature of the pointwise closed forms against p(r | T); the
    normalization is re-imposed by trapezoid so tail truncation cannot
    bias the averages. Returns a dict keyed 'S', 'C', 'U', 'log_Z'.
    """
    temps = np.atleast_1d(np.asarray(temps, dtype=np.float64))
    out = {k: np.empty_like(temps) for k in ("S", "C", "U", "log_Z")}
    for i, t in enumerate(temps):
        r = _radius_grid(float(t), d, n_r)
        logp = radius_log_density(r, float(t), d)
        p = np.exp(logp - logp.max())
        zmass = _trapezoid(p, r)
        avg = lambda f: _trapezoid(p * f, r) / zmass  # noqa: E731
        out["S"][i] = avg(entropy(r, t, d))
        out["C"][i] = avg(heat_capacity(r, t, d))
        out["U"][i] = avg(internal_energy(r, t, d))
        out["log_Z"][i] = avg(log_partition(r, t, d))
    return out
