"""Port parity: the config layer (pdm_tpu_torch.config) against the JAX
package's (pdm_tpu.config, pydantic and PyYAML).

* The YAML reader gives what ``yaml.safe_load`` gives on all 12 files and
  on a table of scalars and small documents (YAML 1.1: ``2e-4`` is a
  string, ``1.0e-4`` a float), and raises with the line on what it does
  not support.
* The port's YAML files are byte for byte the JAX package's.
* ``load_config`` on both roots, and every group file on its own, gives the
  same values (of the same types) as JAX's ``model_dump()``, and the same
  derived paths.
* Coercion from annotations matches pydantic's on a table of values: both
  accept with the same result, or both refuse.
* CLI overrides, flag types, ``flatten_config``, the dataset registry and
  the ``grad_accum`` validation, as tests/test_config.py holds JAX's.

Every comparison is exact: the loaders parse the same text.
"""

import math
import os
import typing
from dataclasses import asdict

import pytest
import yaml
from pydantic import ValidationError

from pdm_tpu.config import config as jconfig
from pdm_tpu.config import loader as jloader
from pdm_tpu.config.datasets import DatasetRegistry as JRegistry

from pdm_tpu_torch.config import config as tconfig
from pdm_tpu_torch.config import loader as tloader
from pdm_tpu_torch.config import yaml_subset
from pdm_tpu_torch.config.datasets import DatasetRegistry

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_YAML = os.path.join(ROOT, "pdm_tpu", "config", "yaml")
PORT_YAML = os.path.join(ROOT, "pdm_tpu_torch", "config", "yaml")
YAML_FILES = ["config.yaml", "high_dim_exp.yaml"] + [
    f"groups/{f}" for f in sorted(os.listdir(os.path.join(JAX_YAML, "groups")))]
ROOTS = ["config.yaml", "high_dim_exp.yaml"]
# the derived properties the artifact paths read
DERIVED_PROPERTIES = (
    "available_datasets", "ddpm_config_name", "experiment_name",
    "project_name", "checkpoint_dir", "ddpm_checkpoint_path", "samples_path",
    "forward_stats_path", "metric_stats_path", "empirical_stats_path",
    "fid_results_path",
)
GROUP_CLASSES = {
    "data_augmentation": "DataAugmentationConfig", "ddpm": "DDPMConfig",
    "ddpm_training": "DDPMTrainingConfig", "diffusion": "DiffusionConfig",
    "empirical_stats": "EmpiricalStatsConfig",
    "entropy_schedule": "EntropyScheduleConfig", "fid": "FIDConfig",
    "forward_stats": "ForwardStatsConfig", "parallel": "ParallelConfig",
    "sample": "SampleConfig",
}


def same(a, b):
    """Equal values of equal types, recursively (nan equals nan)."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return type(a) is type(b) and a == b


def test_yaml_file_list_is_complete():
    assert len(YAML_FILES) == 12


@pytest.mark.parametrize("name", YAML_FILES)
def test_yaml_copy_is_byte_identical(name):
    with open(os.path.join(JAX_YAML, name), "rb") as f:
        want = f.read()
    with open(os.path.join(PORT_YAML, name), "rb") as f:
        assert f.read() == want


@pytest.mark.parametrize("name", YAML_FILES)
def test_reader_matches_pyyaml_on_config_files(name):
    path = os.path.join(PORT_YAML, name)
    with open(path) as f:
        want = yaml.safe_load(f)
    assert same(yaml_subset.load_file(path), want)


SCALARS = [
    "2e-4", "1e-06", "- 1e-4", "1.0e-4", "1.0e+4", "1.0e4", "1.", ".5", "-.5",
    "+1.5", ".inf", "-.Inf", "+.INF", ".nan", ".NaN", "1_000.5", "1:30.5",
    "0", "-0", "+7", "017", "08", "0b101", "-0x1F", "1_000", "1:30", "12e3",
    "yes", "No", "ON", "off", "True", "FALSE", "y", "n", "tRue", "~", "null",
    "Null", "NULL", "", "'true'", '"true"', "'it''s'", '"a b"',
    "foo # comment", "foo#bar", "http://x.y/z", "a b  c", "-foo", "x:y",
    "'a # not a comment'", '"a: b"', "[0.9, 0.999]", "[]", "{}", "[a, 'b', 3]",
    "{b: 1, c: [x, 'y'], d: {e: null}}", "[1, 2, ]", "{a: }", "[[1, 2], [3]]",
    "[a.npz, b.npz]", "groups/diffusion.yaml",
]


def agrees_with_pyyaml(doc):
    """The reader gives PyYAML's result, or raises where PyYAML does."""
    try:
        want = yaml.safe_load(doc)
    except yaml.YAMLError:
        with pytest.raises(yaml_subset.YAMLSubsetError):
            yaml_subset.safe_load(doc)
        return
    assert same(yaml_subset.safe_load(doc), want)


@pytest.mark.parametrize("text", SCALARS)
def test_reader_matches_pyyaml_on_scalars(text):
    agrees_with_pyyaml(f"key: {text}")
    agrees_with_pyyaml(text)


DOCUMENTS = [
    "a:\n- x\n- y\nb: 1\n",
    "a:\n  - x\n  -   y\n",
    "a:\n  b:\n    c: 1\n  d: [1]\ne: f\n",
    "- a: 1\n  b: 2\n- c\n- - 1\n  - 2\n",
    "# header\n\n# more\nroot:   # trailing\n    groups/x.yaml\nnext: 2\n",
    "'quoted key': 1\n\"k2\": [1]\n1: one\ntrue: t\n",
    "a:\n-\n- 2\n",
    "a: 1\na: 2\n",
    "",
    "# only a comment\n",
    "  indented: 1\n  top: 2\n",
    "a: {}\nb: []\nc:\nd: ~\n",
]


@pytest.mark.parametrize("doc", DOCUMENTS)
def test_reader_matches_pyyaml_on_documents(doc):
    agrees_with_pyyaml(doc)


UNSUPPORTED = [
    ("a: &x 1\nb: *x\n", 1), ("a: !!str 1\n", 1), ("a: |\n  x\n", 1),
    ("a: >\n  x\n", 1), ("---\na: 1\n", 1), ("a: 1\n...\n", 2),
    ("a: 2001-12-14\n", 1), ("a:\n\tb: 1\n", 2), ("a: foo\n  bar\n", 2),
    ("a: [1,\n 2]\n", 1), ("? a\n: b\n", 1), ("%YAML 1.1\na: 1\n", 1),
    ("a: b: c\n", 1), ("a: 1\n  b: 2\n", 2), ("a: [x: 1]\n", 1),
    ("a:\n  - 1\n b: 2\n", 3), ("a: 'open\n", 1), ("a: <<\n", 1),
    ('a: "x\\ty"\n', 1),
]


@pytest.mark.parametrize("doc,line", UNSUPPORTED)
def test_reader_raises_with_line_on_unsupported(doc, line, tmp_path):
    path = tmp_path / "bad.yaml"
    path.write_text(doc)
    with pytest.raises(yaml_subset.YAMLSubsetError, match=f"bad.yaml:{line}:"):
        yaml_subset.load_file(str(path))


@pytest.mark.parametrize("root", ROOTS)
def test_load_config_matches_jax(root):
    want = jloader.load_config(os.path.join(JAX_YAML, root))
    got = tloader.load_config(os.path.join(PORT_YAML, root))
    assert isinstance(got, tconfig.Config)
    assert same(asdict(got), want.model_dump())
    for prop in DERIVED_PROPERTIES + ("dataset_config",):
        g, w = getattr(got, prop), getattr(want, prop)
        if prop == "dataset_config":
            g, w = g.__dict__, w.model_dump()
        assert same(g, w), prop
    assert got.diffusion.temp_range == want.diffusion.temp_range


def test_default_config_values():
    cfg = tloader.load_config()
    assert cfg.ddpm_training.learning_rate == 0.0002
    assert cfg.ddpm.unet_config["norm_eps"] == "1e-06"  # untyped: not coerced
    assert cfg.fid.min_temp == [0.0001]
    assert cfg.ddpm_training.betas == (0.9, 0.999)
    assert cfg.ddpm_training.weight_decay == 0.0
    assert isinstance(cfg.ddpm_training.weight_decay, float)
    assert cfg.parallel == tconfig.ParallelConfig()
    assert cfg.experiment_name == "cifar10_unet_eps_linear_beta_schedule"


@pytest.mark.parametrize("name", [f for f in YAML_FILES if f.startswith("groups/")])
def test_group_file_matches_jax_group(name):
    group = os.path.basename(name)[:-len(".yaml")]
    cls = GROUP_CLASSES[group]
    with open(os.path.join(JAX_YAML, name)) as f:
        want = getattr(jconfig, cls)(**yaml.safe_load(f)).model_dump()
    got = asdict(getattr(tconfig, cls).from_dict(
        yaml_subset.load_file(os.path.join(PORT_YAML, name))))
    assert same(got, want)


def test_pdm_config_env_selects_the_root(monkeypatch):
    monkeypatch.setenv("PDM_CONFIG", os.path.join(PORT_YAML, "high_dim_exp.yaml"))
    cfg = tloader.load_config()
    assert cfg.dataset_name == "anisotropic_gmm_repro"
    assert cfg.dataset_config.image_size == (100, 1)
    assert cfg.diffusion.temp_range == (1e-4, 1e4)
    assert cfg.ddpm.model_name == "true"  # "true" quoted: the string
    assert cfg.sample.n_steps == 20 and cfg.sample.n_samples == 10_000
    assert cfg.forward_stats.n_temps == 200
    assert cfg.entropy_schedule.extrapolate is True


# (group class, field, value): pydantic and the port must agree
COERCIONS = [
    ("DDPMTrainingConfig", "learning_rate", "2e-4"),
    ("DDPMTrainingConfig", "learning_rate", 1),
    ("DDPMTrainingConfig", "learning_rate", True),
    ("DDPMTrainingConfig", "learning_rate", " 3 "),
    ("DDPMTrainingConfig", "learning_rate", "abc"),
    ("DDPMTrainingConfig", "learning_rate", None),
    ("DDPMTrainingConfig", "batch_size", "128"),
    ("DDPMTrainingConfig", "batch_size", 128.0),
    ("DDPMTrainingConfig", "batch_size", 128.5),
    ("DDPMTrainingConfig", "batch_size", "5.0"),
    ("DDPMTrainingConfig", "batch_size", "1_000"),
    ("DDPMTrainingConfig", "batch_size", "0x10"),
    ("DDPMTrainingConfig", "batch_size", False),
    ("DDPMTrainingConfig", "use_wandb", "yes"),
    ("DDPMTrainingConfig", "use_wandb", "Off"),
    ("DDPMTrainingConfig", "use_wandb", "2"),
    ("DDPMTrainingConfig", "use_wandb", 1),
    ("DDPMTrainingConfig", "use_wandb", 0.0),
    ("DDPMTrainingConfig", "use_wandb", 2),
    ("DDPMTrainingConfig", "data_layout", "nhwc"),
    ("DDPMTrainingConfig", "data_layout", "NHWC"),
    ("DDPMTrainingConfig", "betas", [0.9, "0.999"]),
    ("DDPMTrainingConfig", "betas", [1, 2, 3]),
    ("DDPMTrainingConfig", "betas", "0.9"),
    ("DDPMTrainingConfig", "keep_checkpoints", None),
    ("DDPMTrainingConfig", "keep_checkpoints", "5"),
    ("DDPMTrainingConfig", "grad_accum", 0),
    ("DDPMTrainingConfig", "grad_accum", -1),
    ("DDPMTrainingConfig", "grad_accum", "4"),
    ("SampleConfig", "step_type", "heun"),
    ("SampleConfig", "step_type", "euler"),
    ("SampleConfig", "noise_schedule_path", None),
    ("FIDConfig", "min_temp", ["1e-4", 2]),
    ("FIDConfig", "n_steps", ["100", 10.0]),
    ("FIDConfig", "n_steps", 100),
    ("FIDConfig", "noise_schedule_path", [None, "a.npz"]),
    ("FIDConfig", "noise_schedule_type", ["x", 1]),
    ("ParallelConfig", "data_axis", "4"),
    ("ParallelConfig", "data_axis", None),
    ("ParallelConfig", "model_partition", "spatial"),
    ("ParallelConfig", "model_partition", "heads"),
    ("DDPMConfig", "unet_config", {"norm_eps": "1e-06", "x": [1]}),
    ("DDPMConfig", "unet_config", [1]),
    ("DDPMConfig", "model_name", 1),
    ("DDPMConfig", "model_name", "true"),
    ("EntropyScheduleConfig", "extrapolate", "t"),
    ("EmpiricalStatsConfig", "min_temp", "1e-3"),
]


@pytest.mark.parametrize("cls,field,value", COERCIONS)
def test_coercion_matches_pydantic(cls, field, value):
    base = asdict(tloader.load_config())
    group = {v: k for k, v in GROUP_CLASSES.items()}[cls]
    values = {**base[group], field: value}
    try:
        want = getattr(jconfig, cls)(**values).model_dump()
    except ValidationError:
        want = None
    if want is None:
        with pytest.raises(tconfig.ConfigError, match=field):
            getattr(tconfig, cls)(**values)
    else:
        assert same(asdict(getattr(tconfig, cls)(**values)), want)


def test_unknown_keys_ignored_and_missing_named():
    base = asdict(tloader.load_config())["diffusion"]
    assert same(asdict(tconfig.DiffusionConfig.from_dict({**base, "extra": 1})),
                jconfig.DiffusionConfig(**{**base, "extra": 1}).model_dump())
    with pytest.raises(tconfig.ConfigError, match="max_temp"):
        tconfig.DiffusionConfig.from_dict({"min_temp": 1.0})
    with pytest.raises(ValidationError):
        jconfig.DiffusionConfig(min_temp=1.0)


def test_grad_accum_validation():
    cfg = tloader.load_config()
    for bad in (0, -1):
        with pytest.raises(tconfig.ConfigError):
            tconfig.DDPMTrainingConfig(
                **{**asdict(cfg.ddpm_training), "grad_accum": bad})


ARGVS = [
    ["--ddpm_training.learning_rate", "1e-3", "--dataset_name", "mnist",
     "--no-data_augmentation.use_augmentation", "--sample.n_steps", "50"],
    ["--parallel.data_axis", "4", "--fid.noise_schedule_path", "[a.npz, b.npz]",
     "--empirical_stats.min_temp", "1e-3"],
    ["--ddpm.model_name", "true", "--ddpm.parametrization", "x0",
     "--ddpm.diffusers_path", "/tmp/x", "--parallel.model_partition", "no",
     "--fid.required", "--fid.min_temp", "[1e-4, 1.0e-3]",
     "--ddpm.unet_config", "{block_out_channels: [32, 64], dropout: 0.0}",
     "--ddpm_training.betas", "[0.5, 0.9]", "--sample.step_type", "heun",
     "--ddpm_training.keep_checkpoints", "7", "--no-fid.train"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_cli_overrides_match_jax(argv):
    want = jloader.load_config()
    jloader.update_config_from_args(
        want, jloader.parse_args_from_config(want, argv))
    got = tloader.load_config()
    tloader.update_config_from_args(
        got, tloader.parse_args_from_config(got, argv))
    assert same(asdict(got), want.model_dump())
    assert got.experiment_name == want.experiment_name


def test_cli_types_from_annotations():
    cfg = tloader.load_config()
    args = tloader.parse_args_from_config(cfg, [
        "--parallel.data_axis", "4",
        "--fid.noise_schedule_path", "[a.npz, b.npz]",
        "--empirical_stats.min_temp", "1e-3",
    ])
    tloader.update_config_from_args(cfg, args)
    assert cfg.parallel.data_axis == 4 and isinstance(cfg.parallel.data_axis, int)
    assert cfg.fid.noise_schedule_path == ["a.npz", "b.npz"]
    assert cfg.empirical_stats.min_temp == 1e-3
    assert isinstance(cfg.empirical_stats.min_temp, float)


@pytest.mark.parametrize("annotation", [
    int | None, float | None, str | None, bool | None,
    typing.Optional[int], typing.Literal["no", "on", "off"],
    typing.Literal[1, 2, 3], typing.Literal["a", 1], list,
    typing.List[float], typing.Tuple[float, float], typing.Dict[str, typing.Any],
    typing.Optional[typing.List[typing.Optional[str]]], bool, int, float, str,
])
def test_cli_kind_matches_jax(annotation):
    assert tloader._cli_kind(annotation) == jloader._cli_kind(annotation)


def test_flatten_matches_jax():
    got = tloader.flatten_config(tloader.load_config())
    want = jloader.flatten_config(jloader.load_config())
    assert list(got) == list(want)
    assert same(got, want)
    assert [k for k, _, _ in tloader._flatten_with_annotations(
        tloader.load_config())] == [k for k, _, _ in
                                    jloader._flatten_with_annotations(
                                        jloader.load_config())]


def test_with_config_injects_the_config():
    @tloader.with_config(os.path.join(PORT_YAML, "high_dim_exp.yaml"))
    def main(config, extra):
        return config.dataset_name, extra

    assert main(3) == ("anisotropic_gmm_repro", 3)


def test_registry_matches_jax():
    assert DatasetRegistry.get_dataset_names() == JRegistry.get_dataset_names()
    for name in JRegistry.get_dataset_names():
        got, want = DatasetRegistry.get(name), JRegistry.get(name)
        assert same(got.__dict__, want.model_dump()), name
        assert got.obj_size == want.obj_size and got.temp_range == want.temp_range
        assert type(got).__name__ == type(want).__name__
    with pytest.raises(KeyError) as got_err:
        DatasetRegistry.get("nope")
    with pytest.raises(KeyError) as want_err:
        JRegistry.get("nope")
    assert str(got_err.value) == str(want_err.value)
    with pytest.raises(Exception):  # frozen
        DatasetRegistry.get("cifar10").channels = 1


def test_path_contracts_follow_the_fields():
    cfg, want = tloader.load_config(), jloader.load_config()
    for c in (cfg, want):
        c.ddpm.noise_schedule_type = "entropy"
        c.entropy_schedule.min_temp = 1e-3
    assert "min_temp=0.001" in cfg.experiment_name
    for prop in DERIVED_PROPERTIES:
        assert getattr(cfg, prop) == getattr(want, prop), prop
    cfg.dataset_name = want.dataset_name = "all"
    assert cfg.available_datasets == want.available_datasets
