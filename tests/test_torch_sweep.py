"""Port parity: the fused multi-temperature sweep's plain version, the
per-temperature oracle and k-NN (pdm_tpu_torch.ops.{boltzmann_sweep,knn}).

* ``boltzmann_sweep_reference`` against the JAX package's Pallas sweep
  kernel run in interpret mode on the CPU, in all three precision modes,
  with and without the (N, 1) payload, at the shapes of
  ``tests/test_boltzmann_sweep.py``. Both compute the same bf16 split
  products (exact in fp32) and sum them in fp32 in another order, so
  their logits differ by at most ``chip_smoke.sweep_logit_error`` (about
  sqrt(D) ulp of the largest Gram term a side, over T and sqrt(T)); the
  moments are held to what that logit error allows to first order
  (``chip_smoke.sweep_check``).
* ``boltzmann_sweep_per_temp`` against ``boltzmann_sweep_xla`` at that
  file's tolerances (log_z 1e-5, var 1e-4 relative).
* ``knn_sqdist`` against the JAX package's: the same fp32 expansion in
  another summation order, 1e-5 relative.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.ops.boltzmann_sweep import boltzmann_sweep as j_sweep
from pdm_tpu.ops.boltzmann_sweep import boltzmann_sweep_xla
from pdm_tpu.ops.knn import knn_sqdist as j_knn

from pdm_tpu_torch.ops import boltzmann_sweep as sw
from pdm_tpu_torch.ops.knn import knn_sqdist

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
from chip_smoke import (  # noqa: E402
    per_temp_logit_error, sweep_check, sweep_logit_error,
)
from torch_port_fixtures import two_torch_threads  # noqa: E402,F401

SHAPES = [(24, 700, 20, 7), (16, 1100, 640, 3)]  # B, N, D, n_temps


def _case(B, N, D, nt, seed=0):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(B, D).astype(np.float32)
    eps = rng.randn(B, D).astype(np.float32)
    y = rng.randn(N, D).astype(np.float32)
    temps = np.logspace(-1.5, 1.5, nt).astype(np.float32)
    v = (rng.rand(N, 1) + 0.1).astype(np.float32)
    return x0, eps, y, temps, v


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _logit_tol(x0, eps, y, temps):
    sq = [float((0.5 * (a.astype(np.float64) ** 2).sum(1)).max())
          for a in (x0, eps, y)]
    d = x0.shape[1]
    return sweep_logit_error(*sq, d, temps, np.sqrt(d))


@pytest.mark.parametrize("values", [False, True])
@pytest.mark.parametrize("mode", ["fp32", "bf16_3x", "bf16"])
@pytest.mark.parametrize("B,N,D,nt", SHAPES)
def test_reference_matches_jax_kernel(B, N, D, nt, mode, values):
    x0, eps, y, temps, v = _case(B, N, D, nt)
    v = v if values else None
    want = j_sweep(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(y),
                   jnp.asarray(temps), values=None if v is None else jnp.asarray(v),
                   mxu_precision=mode, interpret=True)
    got = sw.boltzmann_sweep_reference(*_torch(x0, eps, y, temps), values=_torch(v)[0],
                                       mxu_precision=mode)
    want_t = sw.BoltzmannMoments(*(None if f is None else torch.from_numpy(np.array(f))
                                   for f in want))
    assert got.log_z.shape == (nt, B)
    _, worst = sweep_check(got, want_t, _logit_tol(x0, eps, y, temps),
                           v_max=float(v.max()) if values else 0.0)
    assert worst <= 1.0, worst
    if values:
        assert got.mean.shape == (nt, B, 1)


def test_cpu_dispatch_runs_the_plain_version():
    """On CPU tensors boltzmann_sweep is the plain version, bit for bit,
    with no kernel launch; a raw dataset and its pack give the same."""
    x0, eps, y, temps, v = _case(8, 300, 10, 4, seed=1)
    args = _torch(x0, eps, y, temps)
    before = sw.boltzmann_sweep.launches
    got = sw.boltzmann_sweep(*args, values=torch.from_numpy(v))
    packed = sw.boltzmann_sweep(args[0], args[1], sw.prepare_y(args[2]), args[3],
                                values=torch.from_numpy(v))
    want = sw.boltzmann_sweep_reference(*args, values=torch.from_numpy(v))
    assert sw.boltzmann_sweep.launches == before
    for a, b, c in zip(got, packed, want):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
        torch.testing.assert_close(b, c, rtol=0, atol=0)


def test_prepare_y_layout_and_mode_checks():
    y = torch.randn(300, 3, 2, generator=torch.Generator().manual_seed(0))
    prep = sw.prepare_y(y, "bf16_3x")
    assert prep.yt_hi.shape == (6, 384) and prep.yt_hi.dtype == torch.bfloat16
    assert prep.yt_lo is not None and (prep.n, prep.d) == (300, 6)
    torch.testing.assert_close(prep.ysq[:300], 0.5 * (y.reshape(300, 6) ** 2).sum(1))
    assert bool((prep.ysq[300:] == 0).all() and (prep.yt_hi[:, 300:] == 0).all())
    x = torch.zeros(2, 6)
    with pytest.raises(ValueError, match="bf16_3x"):
        sw.boltzmann_sweep(x, x, prep, torch.ones(2), mxu_precision="fp32")
    with pytest.raises(ValueError, match=r"\(N, 1\)"):
        sw.boltzmann_sweep(x, x, y, torch.ones(2), values=torch.ones(300, 2))
    # the layout the kernel's pointers assume, checked before a launch
    cpu = torch.device("cpu")
    sw.check_pack(prep, cpu)
    for bad in (prep._replace(yt_hi=prep.yt_hi.float()),
                prep._replace(yt_lo=None),
                prep._replace(ysq=prep.ysq[:300]),
                prep._replace(yt_hi=prep.yt_hi.T.contiguous().T)):
        with pytest.raises(ValueError, match="PreparedY|yt_lo"):
            sw.check_pack(bad, cpu)


def test_per_temp_oracle_matches_jax():
    x0, eps, y, temps, v = _case(24, 700, 20, 7)
    want = boltzmann_sweep_xla(jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(y),
                               jnp.asarray(temps), values=jnp.asarray(v))
    got = sw.boltzmann_sweep_per_temp(*_torch(x0, eps, y, temps),
                                      values=torch.from_numpy(v))
    np.testing.assert_allclose(got.log_z.numpy(), np.asarray(want.log_z),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.var.numpy(), np.asarray(want.var), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-4,
                               atol=1e-4)


def test_reference_matches_per_temp_oracle():
    """The shared-noise decomposition against one pass per temperature at
    xt: the oracle's Gram terms grow with T (|xt|^2 ~ |x0|^2 + T |eps|^2),
    so its own rounding, sqrt(D) ulp of them over T, adds to the bound."""
    x0, eps, y, temps, v = _case(16, 900, 48, 6, seed=2)
    got = sw.boltzmann_sweep_reference(*_torch(x0, eps, y, temps))
    want = sw.boltzmann_sweep_per_temp(*_torch(x0, eps, y, temps))
    sq = [float((0.5 * (a.astype(np.float64) ** 2).sum(1)).max()) for a in (x0, eps, y)]
    own = per_temp_logit_error(*sq, 48, temps)
    _, worst = sweep_check(got, want, _logit_tol(x0, eps, y, temps) + own)
    assert worst <= 1.0, worst


@pytest.mark.parametrize("n,d,k,chunk", [(300, 5, 3, 64), (257, 33, 1, 1024)])
def test_knn_matches_jax(n, d, k, chunk):
    rng = np.random.RandomState(10)
    x = rng.randn(n, d).astype(np.float32)
    want = np.asarray(j_knn(jnp.asarray(x), k=k, chunk_size=chunk))
    got = knn_sqdist(torch.from_numpy(x), k=k, chunk_size=chunk).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(want.max()))
    dist = ((x[:, None].astype(np.float64) - x[None]) ** 2).sum(-1)
    np.fill_diagonal(dist, np.inf)
    np.testing.assert_allclose(got, np.sort(dist, axis=1)[:, k - 1], rtol=1e-4,
                               atol=1e-4)
