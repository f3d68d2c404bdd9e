"""Port parity: the diffusers importer (pdm_tpu_torch.models.
diffusers_import) and ``model_name: diffusers`` in the factory.

* The committed diffusers fixture (tests/fixtures/diffusers_tiny_sd.npz),
  its attention keys renamed to the legacy spelling (query / key / value /
  proj_attn), written as ``diffusion_pytorch_model.bin`` and as
  ``.safetensors`` by the port's writer, loads into the port's UNet
  bitwise equal to the fixture, with tau scaled by num_train_timesteps - 1.
* The port's forward on that directory against JAX's
  ``diffusers_ddpm_from_config`` on the same directory (as
  tests/test_diffusers_import.py:156 drives it), fp32, within 1e-5 of the
  output's scale (as tests/test_torch_unet.py holds from_flax_params).
* The package-free safetensors reader against ``safetensors``' writer and
  the writer against its reader, exactly, in F32, F16 and BF16.
* Unknown keys, shape mismatches, two names for one key and a missing
  checkpoint raise.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.config.loader import load_config as j_load_config
from pdm_tpu.models.from_config import ddpm_from_config as j_ddpm_from_config

from pdm_tpu_torch.config.loader import load_config
from pdm_tpu_torch.models import diffusers_import as di
from pdm_tpu_torch.models.from_config import ddpm_from_config
from pdm_tpu_torch.models.unet_ddpm import UNetDDPM
from torch_port_fixtures import two_torch_threads  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
FIX = os.path.join(HERE, "fixtures")
DIFFUSERS_CONFIG = {
    "_class_name": "UNet2DModel",
    "block_out_channels": [16, 32],
    "down_block_types": ["DownBlock2D", "AttnDownBlock2D"],
    "up_block_types": ["AttnUpBlock2D", "UpBlock2D"],
    "layers_per_block": 1,
    "attention_head_dim": 8,
    "norm_num_groups": 4,
    "dropout": 0.0,
    "freq_shift": 1,
    "flip_sin_to_cos": False,
    "downsample_padding": 0,
    "num_train_timesteps": 1000,
}
LEGACY = {".to_q.": ".query.", ".to_k.": ".key.", ".to_v.": ".value.",
          ".to_out.0.": ".proj_attn."}


def fixture_sd():
    return {k: torch.from_numpy(v) for k, v in
            np.load(os.path.join(FIX, "diffusers_tiny_sd.npz")).items()}


def legacy(sd):
    out = {}
    for k, v in sd.items():
        for new, old in LEGACY.items():
            k = k.replace(new, old)
        out[k] = v
    return out


def write_checkpoint(root, fmt, sd=None, unet_subdir=False, n_train=None):
    base = os.path.join(root, "unet") if unet_subdir else root
    os.makedirs(base, exist_ok=True)
    with open(os.path.join(base, "config.json"), "w") as f:
        json.dump(DIFFUSERS_CONFIG, f)
    sd = legacy(fixture_sd()) if sd is None else sd
    if fmt == "bin":
        torch.save(sd, os.path.join(base, "diffusion_pytorch_model.bin"))
    else:
        di.write_safetensors(
            os.path.join(base, "diffusion_pytorch_model.safetensors"), sd)
    if n_train is not None:
        os.makedirs(os.path.join(root, "scheduler"))
        with open(os.path.join(root, "scheduler", "scheduler_config.json"),
                  "w") as f:
            json.dump({"num_train_timesteps": n_train}, f)
    return root


def configs(path):
    out = []
    for cfg in (j_load_config(), load_config()):
        cfg.ddpm.model_name = "diffusers"
        cfg.ddpm.precision = "f32"
        cfg.ddpm.diffusers_path = path
        out.append(cfg)
    return out


def test_legacy_names_are_in_the_fixture_copy():
    sd = legacy(fixture_sd())
    assert any(".query." in k for k in sd) and any(".proj_attn." in k for k in sd)
    assert not any(".to_q." in k or ".to_out.0." in k for k in sd)
    assert di.rename_legacy_keys(sd).keys() == fixture_sd().keys()


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
@pytest.mark.parametrize("unet_subdir", [False, True])
def test_import_loads_the_fixture_exactly(tmp_path, fmt, unet_subdir):
    root = write_checkpoint(str(tmp_path / "ckpt"), fmt, unet_subdir=unet_subdir)
    _, cfg = configs(root)
    ddpm = ddpm_from_config(cfg, device="cpu")
    assert isinstance(ddpm, UNetDDPM) and ddpm.tau_scale == 999.0
    got = ddpm.module.state_dict()
    want = fixture_sd()
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("fmt", ["bin", "safetensors"])
def test_import_forward_matches_jax(tmp_path, fmt):
    if fmt == "safetensors":
        pytest.importorskip("safetensors")
    root = write_checkpoint(str(tmp_path / "ckpt"), fmt, n_train=500)
    jcfg, cfg = configs(root)
    jddpm = j_ddpm_from_config(jcfg)
    ddpm = ddpm_from_config(cfg, device="cpu")
    assert ddpm.tau_scale == jddpm.tau_scale == 499.0
    rng = np.random.RandomState(4)
    x = rng.standard_normal((2, 3, 16, 16)).astype(np.float32)
    tau = np.array([0.1, 0.7], np.float32)
    want = np.asarray(jax.jit(jddpm.forward)(jnp.asarray(x), jnp.asarray(tau)))
    with torch.no_grad():
        got = ddpm(torch.from_numpy(x), torch.from_numpy(tau)).numpy()
    scale = float(np.abs(want).max())
    assert scale > 1e-2
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def test_bf16_import_rounds_the_weights(tmp_path):
    root = write_checkpoint(str(tmp_path / "ckpt"), "safetensors")
    _, cfg = configs(root)
    cfg.ddpm.precision = "bf16"
    ddpm = ddpm_from_config(cfg, device="cpu")
    got = ddpm.module.state_dict()
    for k, v in fixture_sd().items():
        assert torch.equal(got[k], v.to(got[k].dtype)), k


def sample_tensors():
    g = torch.Generator().manual_seed(0)
    return {
        "a.weight": torch.randn(3, 4, generator=g),
        "b": torch.randn(5, generator=g).to(torch.float16),
        "c.bias": torch.randn(2, 2, 2, generator=g).to(torch.bfloat16),
        "empty": torch.zeros(0, 3),
        "scalar": torch.tensor(1.5),
    }


def test_reader_matches_safetensors_writer(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    path = str(tmp_path / "ref.safetensors")
    want = sample_tensors()
    st.save_file(want, path, metadata={"format": "pt"})
    got = di.read_safetensors(path)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_writer_matches_safetensors_reader(tmp_path):
    st = pytest.importorskip("safetensors.torch")
    stn = pytest.importorskip("safetensors.numpy")
    path = str(tmp_path / "port.safetensors")
    want = sample_tensors()
    di.write_safetensors(path, want)
    got = st.load_file(path)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    fp = {k: v for k, v in want.items() if v.dtype != torch.bfloat16}
    di.write_safetensors(path, fp)
    got_np = stn.load_file(path)
    for k, v in fp.items():
        np.testing.assert_array_equal(got_np[k], v.numpy())


def test_reader_refuses_bad_files(tmp_path):
    path = str(tmp_path / "bad.safetensors")
    di.write_safetensors(path, {"x": torch.ones(4)})
    raw = bytearray(open(path, "rb").read())
    with open(path, "wb") as f:
        f.write(raw[:-4])  # truncated data
    with pytest.raises(ValueError, match="offsets"):
        di.read_safetensors(path)
    with pytest.raises(ValueError, match="dtype"):
        di.write_safetensors(path, {"x": torch.ones(2, dtype=torch.int64)})


def test_unknown_keys_and_shapes_raise(tmp_path):
    sd = legacy(fixture_sd())
    extra = dict(sd, **{"mid_block.attentions.0.extra.weight": torch.ones(1)})
    _, cfg = configs(write_checkpoint(str(tmp_path / "a"), "bin", sd=extra))
    with pytest.raises(RuntimeError, match="Unexpected key"):
        ddpm_from_config(cfg, device="cpu")
    wrong = dict(sd, **{"conv_in.weight": torch.ones(16, 3, 1, 1)})
    _, cfg = configs(write_checkpoint(str(tmp_path / "b"), "bin", sd=wrong))
    with pytest.raises(RuntimeError, match="size mismatch"):
        ddpm_from_config(cfg, device="cpu")
    missing = {k: v for k, v in sd.items() if k != "conv_out.bias"}
    _, cfg = configs(write_checkpoint(str(tmp_path / "c"), "bin", sd=missing))
    with pytest.raises(RuntimeError, match="Missing key"):
        ddpm_from_config(cfg, device="cpu")
    both = dict(sd, **{"down_blocks.1.attentions.0.to_q.weight":
                       sd["down_blocks.1.attentions.0.query.weight"]})
    with pytest.raises(KeyError, match="map to"):
        di.rename_legacy_keys(both)
    _, cfg = configs(str(tmp_path / "nothing"))
    with pytest.raises(FileNotFoundError, match="diffusers_path"):
        ddpm_from_config(cfg, device="cpu")
