"""Port parity: the single-temperature moments op's plain version and its
dispatcher (pdm_tpu_torch.ops.boltzmann, ops.boltzmann_kernel).

* ``boltzmann_moments_reference`` against the JAX package's Pallas moments
  kernel run in interpret mode on the CPU (``boltzmann_moments_pallas(...,
  interpret=True)``; JAX's CPU dispatcher would run its fp32 XLA path
  whatever the mode), in fp32, bf16_3x and bf16, with per-row inverse
  temperatures and dataset scales, N not a multiple of 128, no payload,
  ``compute_mean`` and a K != D payload, and D = 1. Both sides sum the same
  (bf16 split) products in fp32 in another order, so each logit may differ
  by ``chip_smoke.moments_logit_error`` (about 2 sqrt(D) ulp of the largest
  half squared norm, times s and 1/T); the moments are held to what that
  allows (``chip_smoke.moments_check``).
* The dispatcher: the plain version for CPU tensors, bit for bit and with
  no launch; any other device raises; the sweep's per-temperature oracle
  calls the plain version by name, never the dispatcher.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.ops.boltzmann_pallas import boltzmann_moments_pallas

from pdm_tpu_torch.ops import boltzmann as bz
from pdm_tpu_torch.ops import boltzmann_sweep as sw

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
from chip_smoke import moments_check, moments_logit_error, top_two_gap  # noqa: E402
from torch_port_fixtures import two_torch_threads  # noqa: E402,F401


def _case(B, N, D, K, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, D).astype(np.float32)
    y = rng.randn(N, D).astype(np.float32)
    inv_t = rng.uniform(0.5, 3.0, B).astype(np.float32)
    scale = rng.uniform(0.5, 1.0, B).astype(np.float32)
    v = rng.randn(N, K).astype(np.float32)
    return x, y, inv_t, scale, v


@pytest.mark.parametrize("case", ["none", "compute_mean", "values", "d1"])
@pytest.mark.parametrize("mode", ["fp32", "bf16_3x", "bf16"])
def test_reference_matches_jax_kernel(mode, case):
    B, N, D, K = (5, 300, 1, 1) if case == "d1" else (9, 300, 12, 5)
    x, y, inv_t, scale, v = _case(B, N, D, K)
    kw = {"none": {}, "compute_mean": {"compute_mean": True},
          "values": {"values": v}, "d1": {"compute_mean": True}}[case]
    want = boltzmann_moments_pallas(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(inv_t), jnp.asarray(scale),
        mxu_precision=mode, interpret=True,
        **{k: jnp.asarray(a) if k == "values" else a for k, a in kw.items()})
    got = bz.boltzmann_moments_reference(
        torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(inv_t),
        torch.from_numpy(scale), mxu_precision=mode,
        **{k: torch.from_numpy(a) if k == "values" else a for k, a in kw.items()})
    want_t = bz.BoltzmannMoments(*(None if f is None else torch.from_numpy(np.array(f))
                                   for f in want))
    assert got.log_z.shape == (B,)
    sq = [float((0.5 * (a.astype(np.float64) ** 2).sum(1)).max()) for a in (x, y)]
    delta = moments_logit_error(*sq, D, inv_t, scale, np.sqrt(D))
    payload = v if case == "values" else y
    if case == "none":
        assert got.mean is None and want_t.mean is None
    else:
        assert got.mean.shape == want_t.mean.shape == (B, payload.shape[1])
    gap = top_two_gap(*(torch.from_numpy(a) for a in (x, y, inv_t, scale)))
    _, worst = moments_check(got, want_t, delta, gap,
                             float(payload.max() - payload.min()),
                             float(np.abs(payload).max()), N)
    assert worst <= 1.0, worst


def test_cpu_dispatch_is_the_plain_version():
    """On CPU tensors the dispatcher is the plain version bit for bit, with
    no kernel launch; a kernel pack is for the card only."""
    x, y, inv_t, scale, v = _case(6, 200, 8, 3, seed=1)
    args = [torch.from_numpy(a) for a in (x, y, inv_t, scale)]
    before = bz.boltzmann_moments.launches
    for kw in ({}, {"compute_mean": True}, {"values": torch.from_numpy(v)}):
        got = bz.boltzmann_moments(*args, **kw)
        want = bz.boltzmann_moments_reference(*args, **kw)
        for a, b in zip(got, want):
            if b is None:
                assert a is None
            else:
                torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert bz.boltzmann_moments.launches == before
    with pytest.raises(ValueError, match="kernel pack"):
        bz.boltzmann_moments(args[0], sw.prepare_y(args[1]), 1.0,
                             values=args[1])


def test_dispatch_refuses_other_devices():
    x = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="not on meta"):
        bz.boltzmann_moments(x, torch.zeros(4, 3, device="meta"), 1.0)


def test_sweep_oracle_calls_the_plain_version_by_name(monkeypatch):
    """boltzmann_sweep_per_temp is the sweep kernel's independent oracle:
    it must call the moments op's plain version, so that on the card it
    never becomes the moments kernel."""
    calls = []
    plain = bz.boltzmann_moments_reference

    def spy(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("the oracle went through the dispatcher")

    monkeypatch.setattr(sw, "boltzmann_moments_reference", spy)
    monkeypatch.setattr(bz, "boltzmann_moments", refuse)
    rng = np.random.RandomState(3)
    x0, eps = (torch.from_numpy(rng.randn(4, 5).astype(np.float32)) for _ in range(2))
    y = torch.from_numpy(rng.randn(50, 5).astype(np.float32))
    out = sw.boltzmann_sweep_per_temp(x0, eps, y, torch.tensor([0.1, 1.0, 10.0]))
    assert len(calls) == 3 and out.log_z.shape == (3, 4)
    assert not hasattr(sw, "boltzmann_moments")
