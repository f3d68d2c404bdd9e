"""Experiment configuration: one dataclass per config group, the root
``Config``, and the derived experiment-name and artifact-path properties
that define the pipeline's on-disk contract.

Counterpart of ``pdm_tpu/config/config.py``, with plain dataclasses in
place of pydantic models: the same eleven groups, fields, defaults and
properties, so both packages name the same checkpoints, statistics and
samples. Construction coerces each declared field from its annotation as
pydantic's lax mode does, which matters because the YAML files are read
as YAML 1.1, where ``2e-4`` (no dot) is the string "2e-4":

* ``float`` takes a bool, an int or a numeric string; ``int`` takes a
  bool, an integral float or an integer string; ``bool`` takes 0/1 and
  the words pydantic accepts ("yes", "off", "t", ...); ``str`` takes only
  strings;
* ``Optional``, ``Literal`` (a value outside it raises), ``List``,
  ``Tuple`` and nested groups (from a dict) are coerced element by
  element;
* ``Dict[str, Any]`` and ``Any`` are left as they are: ``unet_config``
  keeps ``norm_eps: 1e-06`` as the string "1e-06", as JAX's ``Config``
  does, and ``unet_from_config`` floats it.

A value that cannot be coerced raises :class:`ConfigError` (a
``ValueError``) naming the field. Keys a group does not declare are
ignored, as pydantic ignores them. Assignment after construction is not
validated (pydantic's default); the CLI types its flags from the
annotations instead (``loader.parse_args_from_config``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
import typing
from typing import Any, Dict, List, Literal, Optional, Tuple

from .datasets import BaseDatasetConfig, DatasetRegistry


class ConfigError(ValueError):
    """A config value that does not fit its field's annotation."""


_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def _to_float(v: Any) -> float:
    if isinstance(v, (bool, int, float)):
        return float(v)
    if isinstance(v, str):
        return float(v)
    raise TypeError("a valid number")


def _to_int(v: Any) -> int:
    if isinstance(v, (bool, int)):
        return int(v)
    if isinstance(v, float):
        if math.isfinite(v) and v.is_integer():
            return int(v)
        raise TypeError("an integer, got a number with a fractional part")
    if isinstance(v, str):
        try:
            return int(v)
        except ValueError:
            return _to_int(float(v))
    raise TypeError("a valid integer")


def _to_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str):
        s = v.strip().lower()
        if s in _TRUE:
            return True
        if s in _FALSE:
            return False
    raise TypeError("a valid boolean")


def _to_str(v: Any) -> str:
    if isinstance(v, str):
        return v
    raise TypeError("a valid string")


_SCALARS = {float: _to_float, int: _to_int, bool: _to_bool, str: _to_str}


def coerce(value: Any, annotation: Any) -> Any:
    """``value`` converted to ``annotation`` (see the module docstring);
    raises TypeError or ValueError when it does not fit."""
    if annotation is Any:
        return value
    if annotation in _SCALARS:
        return _SCALARS[annotation](value)
    if dataclasses.is_dataclass(annotation):  # a group (Config builds it)
        if isinstance(value, annotation):
            return value
        raise TypeError(f"a {annotation.__name__}")
    origin = typing.get_origin(annotation)
    args = typing.get_args(annotation)
    if origin is typing.Union:  # Optional[X], the only union the groups use
        (arg,) = [a for a in args if a is not type(None)]
        return None if value is None else coerce(value, arg)
    if origin is Literal:
        if value in args:
            return value
        raise TypeError(f"one of {list(args)}")
    if origin is list:
        if not isinstance(value, (list, tuple)):
            raise TypeError("a valid list")
        return [coerce(v, args[0]) for v in value]
    if origin is tuple:
        if not isinstance(value, (list, tuple)) or len(value) != len(args):
            raise TypeError(f"a tuple of {len(args)} items")
        return tuple(coerce(v, a) for v, a in zip(value, args))
    if origin is dict:
        if not isinstance(value, dict):
            raise TypeError("a valid dictionary")
        return value
    raise TypeError(f"unsupported annotation {annotation!r}")


@functools.lru_cache(maxsize=None)
def field_types(cls: type) -> Dict[str, Any]:
    """Declared annotation of each field of a config dataclass."""
    hints = typing.get_type_hints(cls)
    return {f.name: hints[f.name] for f in dataclasses.fields(cls)}


class _Group:
    """Base of the config groups: coerces every field at construction."""

    def __post_init__(self):
        for name, annotation in field_types(type(self)).items():
            value = getattr(self, name)
            try:
                object.__setattr__(self, name, coerce(value, annotation))
            except (TypeError, ValueError) as e:
                raise ConfigError(
                    f"{type(self).__name__}.{name}: {value!r} is not {e}"
                ) from None

    @classmethod
    def from_dict(cls, values: Dict[str, Any]):
        """Build from a mapping, ignoring keys the group does not declare
        (as pydantic does) and naming the first missing required one."""
        names = field_types(cls)
        missing = [f.name for f in dataclasses.fields(cls)
                   if f.name not in values
                   and f.default is dataclasses.MISSING
                   and f.default_factory is dataclasses.MISSING]
        if missing:
            raise ConfigError(f"{cls.__name__}: missing field(s) {missing}")
        return cls(**{k: v for k, v in values.items() if k in names})


def _group(cls: type) -> type:
    return dataclasses.dataclass(kw_only=True)(cls)


@_group
class DiffusionConfig(_Group):
    min_temp: float
    max_temp: float

    @property
    def temp_range(self) -> Tuple[float, float]:
        return (self.min_temp, self.max_temp)


@_group
class EntropyScheduleConfig(_Group):
    extrapolate: bool
    min_temp: float
    max_temp: float


@_group
class DDPMConfig(_Group):
    model_name: str  # unet / true / diffusers
    parametrization: str  # x0 / eps / score
    noise_schedule_type: str
    unet_config: Optional[Dict[str, Any]] = None
    precision: str = "bf16"  # f32 / bf16
    # local diffusers checkpoint dir for model_name=diffusers
    diffusers_path: Optional[str] = None


@_group
class DDPMTrainingConfig(_Group):
    batch_size: int
    total_iters: int
    learning_rate: float
    weight_decay: float
    ema_decay: float
    eval_steps: int
    warmup_steps: int
    betas: Tuple[float, float]
    grad_clip: float
    # keep this many newest complete checkpoints; null keeps every one
    keep_checkpoints: Optional[int] = 3
    grad_accum: int = 1
    use_wandb: bool = False
    data_layout: Literal["nchw", "nhwc"] = "nchw"

    def __post_init__(self):
        super().__post_init__()
        if self.grad_accum < 1:
            raise ConfigError(
                f"DDPMTrainingConfig.grad_accum: {self.grad_accum} is not "
                f">= 1")


@_group
class DataAugmentationConfig(_Group):
    use_augmentation: bool = False
    horizontal_flip: bool = False


@_group
class SampleConfig(_Group):
    n_steps: int
    step_type: Literal["ddpm", "ddim", "heun", "dpmpp_2m"]
    noise_schedule_type: str
    noise_schedule_path: Optional[str] = None
    n_samples: int
    batch_size: int
    precision: str  # full or half (bf16)
    track_states: bool = False


@_group
class ForwardStatsConfig(_Group):
    n_samples: int
    batch_size: int
    dataloader_batch_size: int
    n_temps: int
    # sweep a dataset held on the host in device-resident chunks of this
    # many points
    stream_chunk: Optional[int] = None


@_group
class EmpiricalStatsConfig(_Group):
    n_temps: int
    n_steps_per_temp: int
    batch_size: int
    min_temp: Optional[float] = None
    max_temp: Optional[float] = None


@_group
class FIDConfig(_Group):
    n_steps: List[int]
    noise_schedule_type: List[str]
    noise_schedule_path: Optional[List[Optional[str]]] = None
    min_temp: List[float]
    train: bool
    sample: bool
    samples: Optional[int] = None  # overrides dataset_config.fid_samples
    # fail when the FID feature extractor is unavailable (else warn at
    # every eval)
    required: bool = False


@_group
class ParallelConfig(_Group):
    data_axis: Optional[int] = None
    model_axis: int = 1
    model_partition: Literal["channel", "spatial"] = "channel"
    fsdp: bool = False


@_group
class Config(_Group):
    dataset_name: str
    diffusion: DiffusionConfig
    entropy_schedule: EntropyScheduleConfig
    ddpm: DDPMConfig
    ddpm_training: DDPMTrainingConfig
    data_augmentation: DataAugmentationConfig
    sample: SampleConfig
    forward_stats: ForwardStatsConfig
    empirical_stats: EmpiricalStatsConfig
    fid: FIDConfig
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    def __post_init__(self):
        # groups given as mappings go through from_dict (unknown keys
        # ignored, missing ones named) before the field coercion
        for name, annotation in field_types(type(self)).items():
            value = getattr(self, name)
            if dataclasses.is_dataclass(annotation) and isinstance(value, dict):
                object.__setattr__(self, name, annotation.from_dict(value))
        super().__post_init__()

    # ------------------------------------------------------------------

    @property
    def available_datasets(self) -> List[str]:
        if self.dataset_name == "all":
            return DatasetRegistry.get_dataset_names()
        return [self.dataset_name]

    @property
    def dataset_config(self) -> BaseDatasetConfig:
        return DatasetRegistry.get(self.dataset_name)

    @property
    def ddpm_config_name(self) -> str:
        if self.ddpm.model_name == "unet":
            return (
                f"unet_{self.ddpm.parametrization}_"
                f"{self.ddpm.noise_schedule_type}_schedule"
            )
        return self.ddpm.model_name

    @property
    def experiment_name(self) -> str:
        parts = [self.dataset_name, self.ddpm_config_name]
        if (
            self.ddpm.noise_schedule_type == "entropy"
            and self.entropy_schedule.min_temp != 1e-4
        ):
            parts.append(f"min_temp={self.entropy_schedule.min_temp}")
        return "_".join(parts)

    @property
    def project_name(self) -> str:
        return "physics-of-diffusion-models"

    @property
    def checkpoint_dir(self) -> str:
        return f"checkpoints/{self.experiment_name}"

    @property
    def ddpm_checkpoint_path(self) -> str:
        return f"{self.checkpoint_dir}/latest.txt"

    @property
    def samples_path(self) -> str:
        return "_".join(
            [
                f"samples/{self.experiment_name}",
                str(self.sample.n_steps),
                self.sample.step_type,
                "steps",
            ]
        )

    @property
    def forward_stats_path(self) -> str:
        return f"stats/{self.dataset_name}_forward.npz"

    @property
    def metric_stats_path(self) -> str:
        return f"stats/{self.dataset_name}_metric.npz"

    @property
    def empirical_stats_path(self) -> str:
        return f"stats/{self.experiment_name}_empirical.npz"

    @property
    def fid_results_path(self) -> str:
        return f"fid/{self.experiment_name}.csv"

