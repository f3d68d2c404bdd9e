"""Port parity: the plain Boltzmann-moment op, its merge and the precision
policy (pdm_tpu_torch.ops.{boltzmann,precision}).

Same numpy inputs through ``boltzmann_moments_xla`` / ``merge_moments``
of the JAX package and their counterparts in the port, on the CPU.
Tolerances: both sides are fp32 with the same decomposition; they differ
in the order of the Gram's and the chunk sums' additions, so 1e-5 of the
value (the JAX package's own merge test) and 1e-4 for the variance, whose
e2 - e1^2 cancels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.ops.boltzmann import (
    boltzmann_moments_xla,
    merge_moments as j_merge,
)
from pdm_tpu.ops.boltzmann_sweep import boltzmann_sweep_xla

from pdm_tpu_torch.ops import precision
from pdm_tpu_torch.ops.boltzmann import boltzmann_moments, merge_moments
from pdm_tpu_torch.ops.boltzmann_sweep import boltzmann_sweep

from torch_port_fixtures import two_torch_threads  # noqa: F401

FIELDS = ("log_z", "shift", "e1_hat", "e2_hat")


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _assert_moments(got, want, with_mean):
    for f in FIELDS:
        _close(getattr(got, f).numpy(), getattr(want, f))
    _close(got.var.numpy(), want.var, rtol=1e-4)
    if with_mean:
        _close(got.mean.numpy(), want.mean)
    else:
        assert got.mean is None and want.mean is None


@pytest.mark.parametrize("chunk", [0, 64])
@pytest.mark.parametrize("payload", ["none", "values", "compute_mean"])
def test_moments_match_jax(chunk, payload):
    """Per-query inverse temperature and y scale, several chunks (64) or
    one (adaptive); the payload as values (N, 3) or y itself."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((9, 12)).astype(np.float32)
    y = rng.standard_normal((301, 12)).astype(np.float32)
    inv_t = rng.uniform(0.2, 3.0, 9).astype(np.float32)
    y_scale = rng.uniform(0.5, 1.0, 9).astype(np.float32)
    vals = rng.standard_normal((301, 3)).astype(np.float32)
    kw = {"values": vals} if payload == "values" else {
        "compute_mean": payload == "compute_mean"}
    want = boltzmann_moments_xla(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(inv_t), jnp.asarray(y_scale),
        chunk_size=chunk, **{k: jnp.asarray(v) if k == "values" else v
                             for k, v in kw.items()})
    got = boltzmann_moments(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(inv_t),
        torch.from_numpy(y_scale), chunk_size=chunk,
        **{k: torch.from_numpy(v) if k == "values" else v for k, v in kw.items()})
    _assert_moments(got, want, payload != "none")
    _close(got.entropy(301).numpy(), want.entropy(301))
    _close(got.e1.numpy(), want.e1)


def test_merge_matches_single_shot_and_jax():
    """merge(part A, part B) equals the op on A + B and JAX's merge of the
    same parts, in the single-temperature (B,) layout with a mean channel
    and in the sweep's (n_temps, B) layout (tests/test_stats.py:301)."""
    rng = np.random.RandomState(0)
    x = rng.standard_normal((8, 12)).astype(np.float32)
    ya = rng.standard_normal((37, 12)).astype(np.float32)
    yb = rng.standard_normal((21, 12)).astype(np.float32)
    y = np.concatenate([ya, yb])
    inv_t = 1.0 / 0.37
    t = {k: torch.from_numpy(v) for k, v in (("x", x), ("ya", ya), ("yb", yb), ("y", y))}

    full = boltzmann_moments(t["x"], t["y"], inv_t, compute_mean=True)
    merged = merge_moments(
        boltzmann_moments(t["x"], t["ya"], inv_t, compute_mean=True),
        boltzmann_moments(t["x"], t["yb"], inv_t, compute_mean=True))
    j_merged = j_merge(
        boltzmann_moments_xla(jnp.asarray(x), jnp.asarray(ya), inv_t,
                              compute_mean=True),
        boltzmann_moments_xla(jnp.asarray(x), jnp.asarray(yb), inv_t,
                              compute_mean=True))
    for f in FIELDS + ("mean",):
        _close(getattr(merged, f).numpy(), getattr(full, f).numpy())
        _close(getattr(merged, f).numpy(), getattr(j_merged, f))
    _close(merged.entropy(58).numpy(), full.entropy(58).numpy())

    eps = rng.standard_normal((8, 12)).astype(np.float32)
    temps = np.logspace(-2, 1, 7).astype(np.float32)
    te = torch.from_numpy(eps)
    tt = torch.from_numpy(temps)
    full_s = boltzmann_sweep(t["x"], te, t["y"], tt)
    merged_s = merge_moments(boltzmann_sweep(t["x"], te, t["ya"], tt),
                             boltzmann_sweep(t["x"], te, t["yb"], tt))
    j_merged_s = j_merge(
        boltzmann_sweep_xla(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(ya),
                            jnp.asarray(temps)),
        boltzmann_sweep_xla(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(yb),
                            jnp.asarray(temps)))
    _close(merged_s.log_z.numpy(), full_s.log_z.numpy())
    _close(merged_s.var.numpy(), full_s.var.numpy(), rtol=1e-4)
    _close(merged_s.log_z.numpy(), j_merged_s.log_z)
    _close(merged_s.var.numpy(), j_merged_s.var, rtol=1e-4)


def test_precision_modes_resolve_like_jax(monkeypatch):
    from pdm_tpu.ops import precision as jp

    for env in ({}, {"PDM_BOLTZMANN_PRECISION": "bf16"},
                {"PDM_BOLTZMANN_PRECISION": "bf16", "PDM_SWEEP_PRECISION": "bf16_3x"}):
        for k in ("PDM_BOLTZMANN_PRECISION", "PDM_SWEEP_PRECISION"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for override in (None, "fp32", "bf16_3x"):
            assert (precision.boltzmann_precision_mode(override)
                    == jp.boltzmann_precision_mode(override))
            assert (precision.sweep_precision_mode(override)
                    == jp.sweep_precision_mode(override))
    monkeypatch.setenv("PDM_BOLTZMANN_PRECISION", "tf32")
    with pytest.raises(ValueError, match="PDM_BOLTZMANN_PRECISION"):
        precision.boltzmann_precision_mode()


def test_fp32_gram_never_runs_as_tf32():
    """The guard sets full fp32 matmuls (no TF32) for the call and restores
    the process-wide setting after it."""
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")  # TF32 allowed outside
        with precision.full_fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


@pytest.mark.parametrize("mode", ["fp32", "bf16_3x", "bf16"])
def test_split_gram_is_the_split_products(mode):
    """gram() in each mode equals float64 sums of the bf16 split products
    (hi*hi, + hi*lo + lo*hi for bf16_3x) to fp32 summation error, and
    bf16_3x is within ~2^-16 of the fp32 Gram."""
    rng = np.random.RandomState(2)
    a = torch.from_numpy(rng.standard_normal((7, 40)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((40, 11)).astype(np.float32))
    a_hi, a_lo = precision.split(a, mode)
    b_hi, b_lo = precision.split(b, mode)
    want = a_hi.double() @ b_hi.double()
    if mode == "bf16_3x":
        want = want + a_hi.double() @ b_lo.double() + a_lo.double() @ b_hi.double()
    got = precision.gram(a, b, mode)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    if mode != "bf16":
        # each product's split drops lo*lo, below 2^-16 of |a_i b_j|
        scale = a.abs().double() @ b.abs().double()
        rel = 1e-6 if mode == "fp32" else 2.0 ** -15
        assert bool(((got.double() - a.double() @ b.double()).abs()
                     <= rel * scale).all())
