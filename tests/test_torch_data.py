"""Port parity: the data layer (pdm_tpu_torch.runtime, pdm_tpu_torch.
utils.data) and the trainer's host-resident path.

* The port's copy of the native runtime against ``pdm_tpu.runtime`` on the
  same bytes, bitwise: normalize, resize (up and down), gather from fp32
  and uint8 sources; the numpy fallbacks likewise; a PDMC cache written by
  each package and read by the other (and the files byte-identical).
* ``get_data_array`` / ``get_data_tensor`` on a PDMC cache and on the
  synthetic datasets, bitwise equal to JAX's ``get_data_array``; the
  decode equals numpy's ``u8 * float32(2/255) - 1`` in fp32 bitwise.
* ``HostResidentData``: gathers equal ``data[idx]``; the port trainer's
  host-resident steps gather exactly the rows JAX's trainer gathers at the
  same steps (its ``host_batch_indices``, recorded from a JAX run whose
  step is stubbed out); a run resumed at step 3 continues the stream as an
  uninterrupted run does (tests/test_runtime.py:103-160 for JAX); the
  ``PhaseTimer`` sees one "data" and one "train_step" phase a step.
* ``get_data_generator``, ``to_uint8``, ``compute_dataset_average``.
"""

import types

import numpy as np
import pytest
import torch

from pdm_tpu import runtime as jrt
from pdm_tpu.config.loader import load_config as j_load_config
from pdm_tpu.utils import data as jdata

from pdm_tpu_torch import runtime as rt
from pdm_tpu_torch.config.loader import load_config
from pdm_tpu_torch.diffusion.trainer import DDPMTrainer, host_batch_indices
from pdm_tpu_torch.models.unet import unet_from_config
from pdm_tpu_torch.models.unet_ddpm import init_unet_ddpm
from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler
from pdm_tpu_torch.utils import data as tdata
from pdm_tpu_torch.utils.profiling import PhaseTimer
from torch_port_fixtures import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def native():
    if not rt.native_available() or jrt.get_lib() is None:
        pytest.skip(f"no C++ toolchain: {rt.build_error}")


def images(n=7, h=9, w=11, c=3, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, h, w, c),
                                               dtype=np.uint8)


def test_native_library_builds_into_the_build_dir(native):
    assert rt.library_path().parent.name == "_build"
    assert rt.library_path().exists()
    assert rt.get_lib().pdm_version() == 1


def test_normalize_matches_jax(native):
    u8 = images()
    got = rt.normalize_u8_to_chw_f32(u8)
    np.testing.assert_array_equal(got, jrt.normalize_u8_to_chw_f32(u8))
    want = (u8.astype(np.float32) * np.float32(2 / 255) - np.float32(1))
    np.testing.assert_array_equal(got, want.transpose(0, 3, 1, 2))


@pytest.mark.parametrize("size", [(4, 5), (32, 32), (9, 11), (17, 3)])
def test_resize_matches_jax(native, size):
    u8 = images(c=1)
    np.testing.assert_array_equal(rt.resize_bilinear_u8(u8, *size),
                                  jrt.resize_bilinear_u8(u8, *size))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_gather_matches_jax(native, dtype):
    rng = np.random.RandomState(1)
    data = (rng.randint(0, 256, (50, 3, 4, 5)).astype(dtype) if dtype == np.uint8
            else rng.standard_normal((50, 3, 4, 5)).astype(dtype))
    idx = rng.randint(0, 50, 13)
    want = jrt.gather_rows(data, idx)
    np.testing.assert_array_equal(rt.gather_rows(data, idx), want)
    out = np.empty((13, 60), np.float32)
    got = rt.gather_rows(data, idx, out)
    np.testing.assert_array_equal(got, want)
    assert np.shares_memory(got, out)
    with pytest.raises(ValueError, match="out"):
        rt.gather_rows(data, idx, np.empty((12, 60), np.float32))
    with pytest.raises(IndexError):
        rt.gather_rows(data, np.array([50]))


def test_numpy_fallbacks_match_jax(monkeypatch):
    monkeypatch.setattr(rt, "get_lib", lambda: None)
    monkeypatch.setattr(jrt, "get_lib", lambda: None)
    u8 = images(c=3)
    np.testing.assert_array_equal(rt.normalize_u8_to_chw_f32(u8),
                                  jrt.normalize_u8_to_chw_f32(u8))
    np.testing.assert_array_equal(rt.resize_bilinear_u8(u8, 5, 6),
                                  jrt.resize_bilinear_u8(u8, 5, 6))
    idx = np.array([3, 0, 6, 6])
    np.testing.assert_array_equal(rt.gather_rows(u8, idx),
                                  jrt.gather_rows(u8, idx))


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_cache_written_by_either_is_read_by_the_other(tmp_path, dtype):
    arr = images(n=5, h=4, w=3, c=2).astype(dtype)
    rt.write_cache(str(tmp_path / "port.pdmc"), arr)
    jrt.write_cache(str(tmp_path / "jax.pdmc"), arr)
    assert ((tmp_path / "port.pdmc").read_bytes()
            == (tmp_path / "jax.pdmc").read_bytes())
    np.testing.assert_array_equal(jrt.read_cache(str(tmp_path / "port.pdmc")), arr)
    for mmap in (True, False):
        np.testing.assert_array_equal(
            rt.read_cache(str(tmp_path / "jax.pdmc"), mmap=mmap), arr)
    (tmp_path / "bad.pdmc").write_bytes(b"NOTACACHE" * 4)
    with pytest.raises(ValueError, match="PDMC"):
        rt.read_cache(str(tmp_path / "bad.pdmc"))


def test_get_data_array_reads_a_pdmc_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("PDM_DATA_CACHE", str(tmp_path))
    u8 = images(n=20, h=32, w=32, c=3, seed=2)
    rt.write_cache(tdata.pdmc_cache_path("cifar10", True), u8)
    cfg, jcfg = load_config(), j_load_config()
    got = tdata.get_data_array(cfg)
    assert got.shape == (20, 3, 32, 32) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jdata.get_data_array(jcfg))
    np.testing.assert_array_equal(tdata.get_data_array(cfg, limit=6), got[:6])
    t = tdata.get_data_tensor(cfg, device="cpu")
    assert t.dtype == torch.float32 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), got)
    # no test split cached, and nothing is downloaded (the Hugging Face
    # source needs the optional `datasets` package)
    with pytest.raises((RuntimeError, ModuleNotFoundError)):
        tdata.get_data_array(cfg, train=False)


@pytest.mark.parametrize("name", ["gmm1d", "gaussian", "anisotropic_gmm_repro"])
def test_synthetic_datasets_match_jax(name):
    cfg, jcfg = load_config(), j_load_config()
    cfg.dataset_name = jcfg.dataset_name = name
    got = tdata.get_data_array(cfg)
    np.testing.assert_array_equal(got, np.asarray(jdata.get_data_array(jcfg)))
    assert got.shape[1:] == cfg.dataset_config.obj_size


def test_get_dataset_any_keeps_cpu_data_as_a_tensor():
    cfg = load_config()
    cfg.dataset_name = "gaussian"
    got = tdata.get_dataset_any(cfg, batch_size=8, device="cpu")
    assert isinstance(got, torch.Tensor) and got.shape == (1000, 100, 1, 1)
    assert tdata.data_budget_bytes(torch.device("cpu")) == 0


def test_host_resident_gathers_rows(native):
    data = np.random.RandomState(0).standard_normal((40, 2, 3, 3)).astype(np.float32)
    host = tdata.HostResidentData(data, batch_size=8, device="cpu")
    assert len(host) == 40 and host.device.type == "cpu"
    idx = np.array([5, 0, 39, 5])
    np.testing.assert_array_equal(host.gather(idx), data[idx])
    got = host.device_batch(idx)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), data[idx])
    again = host.device_batch(np.array([1, 2, 3, 4]))
    np.testing.assert_array_equal(got.numpy(), data[idx])  # not overwritten
    np.testing.assert_array_equal(again.numpy(), data[[1, 2, 3, 4]])
    u8 = images(n=10, h=2, w=2, c=3)
    hu = tdata.HostResidentData(u8, batch_size=4, device="cpu")
    np.testing.assert_array_equal(hu.gather(np.array([9, 1])),
                                  jrt.gather_rows(u8, np.array([9, 1])))


DATA = np.random.RandomState(0).randn(64, 1, 16, 16).astype(np.float32)
BATCH = 8


def jax_host_indices(total):
    """The rows JAX's trainer gathers from a host-resident dataset at steps
    1..total (its step stubbed out: only the data path runs)."""
    from pdm_tpu.diffusion.trainer import DDPMTrainer as JTrainer

    import jax.numpy as jnp

    host = jdata.HostResidentData(DATA, batch_size=BATCH)
    seen = []
    orig = host.device_batch

    def record(idx):
        seen.append(np.asarray(idx).copy())
        return orig(idx)

    host.device_batch = record
    ddpm = types.SimpleNamespace(params={"w": jnp.zeros((2,))})
    trainer = JTrainer(ddpm=ddpm, learning_rate=1e-3, warmup_steps=0,
                       total_iters=total, eval_steps=1000)
    trainer.train_step = lambda state, key, x0: (state, {})
    trainer.train(host, batch_size=BATCH, total_iters=total)
    return seen


def port_trainer(ckpt_dir=None, timer=None):
    net = unet_from_config(1, {
        "block_out_channels": [8, 16],
        "down_block_types": ["DownBlock2D", "DownBlock2D"],
        "up_block_types": ["UpBlock2D", "UpBlock2D"],
        "layers_per_block": 1, "attention_head_dim": 8, "norm_groups": 4,
        "dropout": 0.0}, device="cpu")
    ddpm = init_unet_ddpm(torch.Generator().manual_seed(0),
                          LinearBetaScheduler(1e-4, 1e2), net, (1, 16, 16))
    return DDPMTrainer(ddpm, learning_rate=1e-3, warmup_steps=0, total_iters=6,
                       grad_clip=1.0, ema_decay=0.9, checkpoint_dir=ckpt_dir,
                       checkpoint_every=3, eval_steps=1000,
                       horizontal_flip=True, timer=timer)


def recording_host():
    host = tdata.HostResidentData(DATA, batch_size=BATCH, device="cpu")
    seen, batches = [], []
    orig = host.device_batch

    def record(idx):
        seen.append(np.asarray(idx).copy())
        out = orig(idx)
        batches.append(out.clone())
        return out

    host.device_batch = record
    return host, seen, batches


def test_host_resident_stream_matches_jax_and_resumes(native, tmp_path):
    want = jax_host_indices(6)
    assert len(want) == 6
    for it, idx in enumerate(want, 1):
        np.testing.assert_array_equal(host_batch_indices(it, 64, BATCH), idx)
    # uninterrupted port run
    host, seen, batches = recording_host()
    timer = PhaseTimer()
    state = port_trainer(timer=timer).train(host, batch_size=BATCH)
    assert state.step == 6
    assert len(seen) == 6
    for got, w, b in zip(seen, want, batches):
        np.testing.assert_array_equal(got, w)
        np.testing.assert_array_equal(b.numpy(), DATA[w])
    summary = timer.summary()
    assert summary["data"]["count"] == 6 and summary["train_step"]["count"] == 6
    assert set(summary["data"]) == {"total_s", "count", "mean_ms"}
    # crash at 3, resume to 6: the stream continues with draw 4
    ckpt = str(tmp_path / "ckpt")
    host_a, seen_a, _ = recording_host()
    port_trainer(ckpt).train(host_a, batch_size=BATCH, total_iters=3)
    host_b, seen_b, _ = recording_host()
    resumed = port_trainer(ckpt).train(host_b, batch_size=BATCH)
    assert resumed.step == 6
    for got, w in zip(seen_a + seen_b, want):
        np.testing.assert_array_equal(got, w)
    for name, p in resumed.params.items():
        assert torch.equal(p, state.params[name]), name


def test_trainer_refuses_data_on_another_device():
    elsewhere = types.SimpleNamespace(device=torch.device("meta"))
    with pytest.raises(ValueError, match="device"):
        port_trainer().train(elsewhere, batch_size=BATCH)


def test_data_generator_uint8_and_average():
    data = torch.arange(40, dtype=torch.float32).reshape(10, 4)
    gen = tdata.get_data_generator(data, batch_size=4)
    b1, b2 = next(gen), next(gen)
    assert b1.shape == (4, 4) and b2.shape == (4, 4)
    assert set(b1[:, 0].tolist()) <= set(data[:, 0].tolist())
    g = torch.Generator().manual_seed(0)
    idx = torch.randint(0, 10, (4,), generator=g)
    again = next(tdata.get_data_generator(data, 4))
    assert torch.equal(again, data[idx])
    np.testing.assert_array_equal(tdata.to_uint8(np.array([-1.0, 0.0, 1.0])),
                                  [0, 127, 255])
    x = np.random.RandomState(0).uniform(-1.3, 1.3, (3, 2, 4)).astype(np.float32)
    np.testing.assert_array_equal(tdata.to_uint8(x), jdata.to_uint8(x))
    np.testing.assert_array_equal(tdata.to_uint8(torch.from_numpy(x)),
                                  jdata.to_uint8(x))
    np.testing.assert_allclose(
        tdata.compute_dataset_average(torch.from_numpy(x)).numpy(),
        np.asarray(jdata.compute_dataset_average(x)), rtol=1e-6, atol=1e-7)
