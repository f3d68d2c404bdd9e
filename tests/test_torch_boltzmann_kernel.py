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
* The kernels' launch plan (``ops.boltzmann_kernel.plan_moments``, a pure
  function): which of the tall, cluster and tiled kernels a call takes,
  the cluster threshold, the query padding, and that every plan for
  chip_smoke's main and edge shapes takes each dataset column once.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.ops.boltzmann_pallas import boltzmann_moments_pallas

from pdm_tpu_torch.ops import boltzmann as bz
from pdm_tpu_torch.ops import boltzmann_kernel as bk
from pdm_tpu_torch.ops import boltzmann_sweep as sw

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))
from chip_smoke import (  # noqa: E402
    MOMENTS_EDGES, MOMENTS_MAIN, moments_check, moments_logit_error, top_two_gap,
)
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


@pytest.mark.parametrize("mode", ["fp32", "bf16_3x", "bf16"])
@pytest.mark.parametrize("shape", [MOMENTS_MAIN, *MOMENTS_EDGES], ids=lambda s: s[0])
def test_plan_covers_every_column_once(shape, mode):
    """Every main and edge shape of chip_smoke's phase 10 gets a plan in
    every payload form, at slot counts like the card's (264 resident
    blocks, 15 clusters of 8) and smaller: chunk c takes the dataset tiles
    [c per_chunk, (c + 1) per_chunk), so the chunks take each tile exactly
    once when none is empty and the last reaches the last tile; its row
    tiles hold every query, and a cluster's blocks cover K with none
    idle."""
    _, B, N, D, K = shape
    n_pad = sw.round_up(N, sw.TILE_COLS)
    vec = bk.PAYLOAD_VEC4 if K % 4 == 0 else bk.PAYLOAD_SCALAR
    for payload, k in ((bk.PAYLOAD_NONE, 0), (vec, K), (bk.PAYLOAD_SCALAR, K)):
        for slots in (1, 15, 132, 264):
            plan = bk.plan_moments(mode, payload, k, B, n_pad, slots)
            assert plan.kernel == bk.kernel_choice(mode, payload, k)[0]
            n_tiles = -(-n_pad // plan.tile_cols)
            assert (plan.n_chunks - 1) * plan.per_chunk < n_tiles <= plan.n_chunks * plan.per_chunk
            assert plan.tile_rows * -(-B // plan.tile_rows) >= B
            if plan.kernel == "cluster":
                assert plan.cluster <= bk.CLUSTER_MAX
                assert (plan.cluster - 1) * plan.width < k <= plan.cluster * plan.width


def test_kernel_choice_and_threshold():
    """fp32 takes the tall kernel (128-row blocks) for every payload; the
    bf16 modes take the cluster kernel for K % 4 == 0 up to CLUSTER_MAX_K =
    3072 and the tiled kernel above it, without a payload, and for any
    K % 4 != 0; the queries are padded to the chosen kernel's rows
    (operands, on CPU tensors)."""
    V, S, Z = bk.PAYLOAD_VEC4, bk.PAYLOAD_SCALAR, bk.PAYLOAD_NONE
    assert bk.CLUSTER_MAX_K == 3072
    for mode in ("bf16_3x", "bf16"):
        assert bk.kernel_choice(mode, V, 3072) == ("cluster", 8, 384)
        assert bk.kernel_choice(mode, V, 3076) == ("tiled", 1, 0)
        assert bk.kernel_choice(mode, V, 1028) == ("cluster", 3, 384)
        assert bk.kernel_choice(mode, V, 1024) == ("cluster", 8, 128)
        assert bk.kernel_choice(mode, V, 4) == ("cluster", 1, 128)
        assert bk.kernel_choice(mode, Z, 0) == ("tiled", 1, 0)
        assert bk.kernel_choice(mode, S, 131) == ("tiled", 1, 0)
    assert bk.kernel_choice("fp32", V, 6144) == ("tall", 1, 0)
    assert bk.kernel_choice("fp32", Z, 0) == ("tall", 1, 0)
    assert bk.kernel_choice("fp32", S, 1) == ("tall", 1, 0)
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(65, 8).astype(np.float32))
    y = torch.from_numpy(rng.randn(300, 8).astype(np.float32))
    for mode, vals, rows in (("fp32", y, 128), ("bf16", y, 64), ("fp32", y[:, :3], 128)):
        ops = bk.operands(x, y, 1.0, values=vals.contiguous(), mode=mode)
        assert ops.x_hi.shape[1] == -(-65 // rows) * rows


@pytest.mark.parametrize("slots,row_tiles,n_tiles", [
    (264, 16, 391), (264, 8, 391), (264, 1, 40), (15, 16, 196), (1, 3, 7),
])
def test_split_chunks(slots, row_tiles, n_tiles):
    """Whole tiles in every chunk, none empty; where the row tiles fit the
    card, one wave of row tiles x chunks blocks, as many chunks as fit."""
    n_chunks, per = sw.split_chunks(slots, row_tiles, n_tiles)
    assert (n_chunks - 1) * per < n_tiles <= n_chunks * per
    if row_tiles <= slots:
        assert n_chunks == min(n_tiles, slots // row_tiles)
