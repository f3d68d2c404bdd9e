"""Port parity: serving export (pdm_tpu_torch/utils/serving.py) on the CPU.

* JAX's two cases of tests/test_serving.py: TrueDDPM on the 1-D GMM
  (20,000 points, LogSNR(1e-4, 1e1), DDIM-6, batch 32) and the tiny bf16
  UNet at 16 x 16 (DDIM-4, batch 8). Each loaded artifact's ``fn(seed)``
  is the port's ``batch_sample`` on ``Generator().manual_seed(seed)``
  bitwise; fed JAX's own draws (``jax_sampler_draws``) through
  ``fn.replay``, it matches JAX's ``batch_sample(PRNGKey(seed))``: the GMM
  within JAX's 1e-5, the bf16 UNet within 2e-2 of the sample's scale, the
  port's half-precision tolerance against JAX (test_torch_sampler.py).
* ddpm, dpmpp_2m and heun (two programs) on the GMM case, bitwise.
* The whole-block path (PDM_FUSED_BLOCK=1, read at export) on a tiny UNet
  whose head dim the block kernels take.
* The exported graphs hold the ``pdm::`` custom ops (on the CPU their
  implementations are the plain versions); ``torch.library.opcheck`` on
  each op's CPU and fake implementations.
* The manifest's keys against JAX's; a sampler with ``batch_sharding`` is
  refused.
"""

import json
import os
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.diffusion.sampling import DDPMSampler as JSampler
from pdm_tpu.models.base import TrueDDPM as JTrueDDPM
from pdm_tpu.models.unet import UNet2D as JUNet2D
from pdm_tpu.models.unet_ddpm import UNetDDPM as JUNetDDPM
from pdm_tpu.schedulers.analytic import LogSNRScheduler as JLogSNR
from pdm_tpu.utils.serving import export_sampler as j_export_sampler
from pdm_tpu.utils.synthetic import generate_gmm_1d

import pdm_tpu_torch.ops  # noqa: F401  (registers the pdm:: ops)
from pdm_tpu_torch.diffusion.sampling import DDPMSampler
from pdm_tpu_torch.models.base import TrueDDPM
from pdm_tpu_torch.models.unet import unet_from_config
from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
from pdm_tpu_torch.models.weights import from_flax_params
from pdm_tpu_torch.ops import attention, attention_block, groupnorm
from pdm_tpu_torch.ops.boltzmann import boltzmann_moments_reference
from pdm_tpu_torch.ops.boltzmann_sweep import prepare_y
from pdm_tpu_torch.parallel.mesh import BatchSharding
from pdm_tpu_torch.schedulers.analytic import LogSNRScheduler
from pdm_tpu_torch.utils.serving import export_sampler, load_exported

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_port_fixtures import jax_sampler_draws, two_torch_threads  # noqa: E402,F401

UNET = {"block_out_channels": [16, 32],
        "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
        "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
        "layers_per_block": 1, "attention_head_dim": 8, "dropout": 0.0,
        "norm_groups": 8}


def pdm_ops(path):
    """The pdm:: ops an artifact's graph calls, by name."""
    ep = torch.export.load(path)
    return sorted({str(n.target).split(".")[1] for n in ep.graph.nodes
                   if str(n.target).startswith("pdm.")})


@pytest.fixture(scope="module")
def gmm():
    data = generate_gmm_1d(20_000)
    sched = LogSNRScheduler(1e-4, 1e1)
    jsched = JLogSNR(1e-4, 1e1)
    return (TrueDDPM(scheduler=sched, train_data=data, device="cpu"), sched,
            JTrueDDPM(scheduler=jsched, train_data=jnp.asarray(data)), jsched)


def gmm_sampler(gmm, step_type="ddim", **kw):
    ddpm, sched, _, _ = gmm
    return DDPMSampler(ddpm=ddpm, scheduler=sched, n_steps=6,
                       obj_size=(1, 1, 1), batch_size=32, n_samples=32,
                       step_type=step_type, device="cpu", **kw)


def test_gmm_roundtrip_and_jax(gmm, tmp_path):
    """tests/test_serving.py::test_export_roundtrip's case."""
    path = str(tmp_path / "gmm.pt2")
    sampler = gmm_sampler(gmm)
    assert export_sampler(sampler, path) == path
    fn, manifest = load_exported(path)
    assert manifest["n_steps"] == 6 and manifest["batch_size"] == 32
    got = fn(7)
    assert tuple(got.shape) == tuple(manifest["out_shape"])
    want = sampler.batch_sample(torch.Generator().manual_seed(7))["x"]
    assert torch.equal(got, want)
    assert pdm_ops(path) == ["boltzmann_moments"]

    _, _, jddpm, jsched = gmm
    key = jax.random.PRNGKey(jnp.uint32(7))
    jsampler = JSampler(ddpm=jddpm, scheduler=jsched, n_steps=6,
                        obj_size=(1, 1, 1), batch_size=32, n_samples=32,
                        step_type="ddim")
    jx = np.asarray(jsampler.batch_sample(key)["x"])
    x_init, _ = jax_sampler_draws(key, 6, (32, 1, 1, 1))
    got = fn.replay(torch.from_numpy(x_init)).numpy()
    np.testing.assert_allclose(got, jx, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("step_type", ["ddpm", "dpmpp_2m", "heun"])
def test_gmm_step_types_replay_batch_sample(gmm, tmp_path, step_type):
    path = str(tmp_path / f"gmm_{step_type}.pt2")
    sampler = gmm_sampler(gmm, step_type)
    export_sampler(sampler, path)
    fn, manifest = load_exported(path)
    want = sampler.batch_sample(torch.Generator().manual_seed(11))["x"]
    assert torch.equal(fn(11), want)
    files = manifest["programs"]
    assert len(files) == len(fn.programs) == (2 if step_type == "heun" else 1)
    assert all((tmp_path / f).exists() for f in files)
    assert manifest["bytes"] == sum(os.path.getsize(tmp_path / f) for f in files)
    if step_type == "ddpm":  # explicit draws replace the generator's
        g = torch.Generator().manual_seed(5)
        x_init = torch.randn((32, 1, 1, 1), generator=g)
        noise = torch.randn((6, 32, 1, 1, 1), generator=g)
        ref = sampler.batch_sample(x_init=x_init, noise=noise)["x"]
        assert torch.equal(fn.replay(x_init, noise), ref)
        with pytest.raises(ValueError, match="noise"):
            fn.replay(x_init)


@pytest.fixture(scope="module")
def tiny_unet():
    """tests/test_serving.py:49-66's bf16 UNet and weights, both packages."""
    size = 16
    jnet = JUNet2D(
        in_channels=3, out_channels=3, block_out_channels=(16, 32),
        down_block_types=("DownBlock2D", "AttnDownBlock2D"),
        up_block_types=("AttnUpBlock2D", "UpBlock2D"), layers_per_block=1,
        attention_head_dim=8, dropout=0.0, norm_groups=8, dtype=jnp.bfloat16)
    shapes = jax.eval_shape(
        lambda k: jnet.init(k, jnp.zeros((2, size, size, 3)),
                            jnp.zeros((2,)))["params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)
    params = jax.tree_util.tree_map(
        lambda s: (rng.standard_normal(s.shape) * 0.05).astype(np.float32),
        shapes)
    jm = JUNetDDPM(scheduler=JLogSNR(1e-4, 1e1),
                   params=jax.tree_util.tree_map(
                       lambda a, s: jnp.asarray(a, s.dtype), params, shapes),
                   module=jnet, parametrization="eps")
    net = unet_from_config(3, UNET, dtype=torch.bfloat16, device="cpu")
    net.load_state_dict(from_flax_params(params))
    tm = UNetDDPM(LogSNRScheduler(1e-4, 1e1), net, parametrization="eps",
                  device="cpu")
    return jm, tm


def unet_sampler(ddpm):
    return DDPMSampler(ddpm=ddpm, scheduler=ddpm.scheduler, n_steps=4,
                       obj_size=(3, 16, 16), batch_size=8, n_samples=8,
                       step_type="ddim", precision="half", device="cpu")


def test_bf16_unet_roundtrip_and_jax(tiny_unet, tmp_path, monkeypatch):
    """tests/test_serving.py::test_export_unet_with_fused_attention's case:
    rows 1 and 3 in the graph."""
    monkeypatch.delenv("PDM_FUSED_BLOCK", raising=False)
    jm, tm = tiny_unet
    path = str(tmp_path / "unet.pt2")
    sampler = unet_sampler(tm)
    export_sampler(sampler, path)
    assert pdm_ops(path) == ["attention_fwd", "group_norm_act"]
    fn, manifest = load_exported(path)
    assert manifest["precision"] == "half"
    want = sampler.batch_sample(torch.Generator().manual_seed(3))["x"]
    got = fn(3)
    assert got.dtype == torch.float32 and torch.equal(got, want)

    key = jax.random.PRNGKey(jnp.uint32(3))
    jx = np.asarray(JSampler(
        ddpm=jm, scheduler=jm.scheduler, n_steps=4, obj_size=(3, 16, 16),
        batch_size=8, n_samples=8, step_type="ddim", precision="half",
    ).batch_sample(key)["x"])
    x_init, _ = jax_sampler_draws(key, 4, (8, 3, 16, 16))
    got = fn.replay(torch.from_numpy(x_init)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, jx, rtol=0,
                               atol=2e-2 * float(np.abs(jx).max()))


def test_whole_block_export(tmp_path, monkeypatch):
    """PDM_FUSED_BLOCK=1 at export puts row 5 (and row 3) in the graph,
    and the replay needs no setting: it is baked in."""
    monkeypatch.setenv("PDM_FUSED_BLOCK", "1")
    net = unet_from_config(3, {**UNET, "attention_head_dim": 16},
                           dtype=torch.bfloat16, device="cpu")
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in net.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    sampler = unet_sampler(UNetDDPM(LogSNRScheduler(1e-4, 1e1), net,
                                    device="cpu"))
    path = str(tmp_path / "block.pt2")
    export_sampler(sampler, path)
    assert pdm_ops(path) == ["attention_block_fwd", "group_norm_act"]
    want = sampler.batch_sample(torch.Generator().manual_seed(4))["x"]
    monkeypatch.delenv("PDM_FUSED_BLOCK")
    fn, _ = load_exported(path)
    assert torch.equal(fn(4), want)


def test_manifest_keys_match_jax(gmm, tmp_path):
    path = str(tmp_path / "gmm.pt2")
    export_sampler(gmm_sampler(gmm), path)
    _, _, jddpm, jsched = gmm
    jpath = str(tmp_path / "gmm.stablehlo")
    j_export_sampler(JSampler(ddpm=jddpm, scheduler=jsched, n_steps=6,
                              obj_size=(1, 1, 1), batch_size=32, n_samples=32,
                              step_type="ddim"), jpath)
    with open(path + ".json") as f:
        mine = json.load(f)
    with open(jpath + ".json") as f:
        theirs = json.load(f)
    assert set(theirs) <= set(mine)
    for key in ("batch_size", "n_steps", "step_type", "obj_size", "precision",
                "out_shape"):
        assert mine[key] == theirs[key], key
    assert mine["platforms"] == ["cpu"]
    assert "import pdm_tpu_torch.ops" in mine["entry"]
    assert mine["bytes"] == os.path.getsize(path)


def test_export_refuses_batch_sharding(gmm, tmp_path):
    mesh = types.SimpleNamespace(data_size=1, data_index=0)
    sampler = gmm_sampler(gmm, batch_sharding=BatchSharding(mesh))
    with pytest.raises(ValueError, match="batch_sharding"):
        export_sampler(sampler, str(tmp_path / "x.pt2"))


def _rng(seed):
    return np.random.RandomState(seed)


def opcheck_cases():
    """(op, args) at small shapes, for each op's CPU and fake
    implementations."""
    r = _rng(0)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(r.standard_normal(shape).astype(np.float32)).to(dtype)

    cases = []
    for dt in (torch.float32, torch.bfloat16):
        qkv = t(2, 16, 96, dtype=dt)
        q, k, v = qkv.chunk(3, dim=-1)  # column thirds, as the UNet's
        cases.append(("attention_fwd", (q, k, v, 2, 0.25)))
        cases.append(("group_norm_act", (t(2, 16, 32, dtype=dt), t(32), t(32),
                                         4, 1e-5, "silu")))
        cases.append(("attention_block_fwd", (
            t(2, 16, 32, dtype=dt), t(2, 16, 32, dtype=dt),
            *(t(32, 32, dtype=dt) * 0.2 for _ in range(3)),
            t(32), t(32), t(32), t(32, 32, dtype=dt) * 0.2, t(32), 2, 0.25)))
    y = t(300, 6)
    for mode, values in (("fp32", t(300, 4)), ("bf16_3x", None), ("bf16", y)):
        prep = prepare_y(y, mode)
        cases.append(("boltzmann_moments", (
            t(5, 6), prep.yt_hi, prep.yt_lo, prep.ysq, prep.n, mode,
            torch.rand(5) + 0.5, torch.rand(5) + 0.5, values)))
    return cases


@pytest.mark.parametrize("case", range(len(opcheck_cases())))
def test_opcheck_cpu_and_fake(case):
    name, args = opcheck_cases()[case]
    torch.library.opcheck(getattr(torch.ops.pdm, name).default, args)


def test_ops_cpu_implementations_are_the_plain_versions():
    """Each op on CPU tensors equals its wrapper's plain version."""
    by_name = {}
    for name, args in opcheck_cases():
        by_name.setdefault(name, args)
    q, k, v, heads, scale = by_name["attention_fwd"]
    for a, b in zip(torch.ops.pdm.attention_fwd(q, k, v, heads, scale),
                    attention._reference_with_lse(q, k, v, heads, scale)):
        assert torch.equal(a, b)
    x, s, b, g, eps, act = by_name["group_norm_act"]
    assert torch.equal(torch.ops.pdm.group_norm_act(x, s, b, g, eps, act),
                       groupnorm.group_norm_reference(x, s, b, g, eps, act))
    x, h, wq, wk, wv, bq, bk, bv, wo, bo, heads, scale = by_name[
        "attention_block_fwd"]
    got = torch.ops.pdm.attention_block_fwd(x, h, wq, wk, wv, bq, bk, bv, wo,
                                            bo, heads, scale)
    want = attention_block._reference_with_lse(x, h, wq, wk, wv, (bq, bk, bv),
                                               wo, bo, heads, scale)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # row 7 from an fp32 pack reads the dataset back exactly
    r = _rng(1)
    y = torch.from_numpy(r.standard_normal((300, 6)).astype(np.float32))
    x = torch.from_numpy(r.standard_normal((5, 6)).astype(np.float32))
    it, sc = torch.rand(5) + 0.5, torch.rand(5) + 0.5
    for mode in ("fp32", "bf16_3x", "bf16"):
        prep = prepare_y(y, "fp32")
        stats, mean = torch.ops.pdm.boltzmann_moments(
            x, prep.yt_hi, None, prep.ysq, prep.n, mode, it, sc, y)
        want = boltzmann_moments_reference(x, y, it, sc, compute_mean=True,
                                           mxu_precision=mode)
        assert torch.equal(stats, torch.stack(
            [want.log_z, want.shift, want.e1_hat, want.e2_hat]))
        assert torch.equal(mean, want.mean)
