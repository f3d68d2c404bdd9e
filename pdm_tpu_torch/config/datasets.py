"""Dataset registry: frozen per-dataset constants and decorator registration.

Counterpart of ``pdm_tpu/config/datasets.py``, with frozen dataclasses in
place of frozen pydantic models: the same twelve datasets (eleven named
ones registered; ``BaseDatasetConfig`` is the base), the same fields and
defaults, the same ``KeyError`` text for an unknown name.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True, kw_only=True)
class BaseDatasetConfig:
    name: str
    channels: int
    image_size: Tuple[int, int]
    image_key: str = "image"
    min_temp: float
    max_temp: float
    fid_samples: int = 50_000
    diffusers_model_id: Optional[str] = None
    hf_dataset_name: Optional[str] = None
    synthetic_name: Optional[str] = None  # dispatch into utils.synthetic

    @property
    def obj_size(self) -> Tuple[int, ...]:
        return (self.channels, *self.image_size)

    @property
    def temp_range(self) -> Tuple[float, float]:
        return (self.min_temp, self.max_temp)


_REGISTRY: Dict[str, BaseDatasetConfig] = {}


class DatasetRegistry:
    """Module-level name -> frozen-config table with decorator
    registration; call sites read ``DatasetRegistry.get("cifar10")``."""

    @staticmethod
    def register(config_class: type) -> type:
        instance = config_class()
        _REGISTRY[instance.name] = instance
        return config_class

    @staticmethod
    def get(name: str) -> BaseDatasetConfig:
        try:
            return _REGISTRY[name]
        except KeyError:
            known = ", ".join(sorted(_REGISTRY))
            raise KeyError(
                f"unknown dataset {name!r}; registered datasets: {known}"
            ) from None

    @staticmethod
    def get_dataset_names() -> List[str]:
        return list(_REGISTRY)


def _dataset(cls: type) -> type:
    return DatasetRegistry.register(
        dataclasses.dataclass(frozen=True, kw_only=True)(cls))


@_dataset
class MNISTConfig(BaseDatasetConfig):
    name: str = "mnist"
    channels: int = 1
    image_size: Tuple[int, int] = (32, 32)
    min_temp: float = 1e-2
    max_temp: float = 1e4
    hf_dataset_name: Optional[str] = "mnist"


@_dataset
class CIFAR10Config(BaseDatasetConfig):
    name: str = "cifar10"
    channels: int = 3
    image_size: Tuple[int, int] = (32, 32)
    image_key: str = "img"
    min_temp: float = 1e0
    max_temp: float = 1e6
    diffusers_model_id: Optional[str] = "./checkpoints/ddpm_ema_cifar10"
    hf_dataset_name: Optional[str] = "cifar10"


@_dataset
class CIFAR100Config(BaseDatasetConfig):
    name: str = "cifar100"
    channels: int = 3
    image_size: Tuple[int, int] = (32, 32)
    image_key: str = "img"
    min_temp: float = 1e-1
    max_temp: float = 1e4
    hf_dataset_name: Optional[str] = "cifar100"


@_dataset
class FashionMNISTConfig(BaseDatasetConfig):
    name: str = "fashion_mnist"
    channels: int = 1
    image_size: Tuple[int, int] = (32, 32)
    min_temp: float = 1e-1
    max_temp: float = 1e4
    hf_dataset_name: Optional[str] = "fashion_mnist"


@_dataset
class ImageNetConfig(BaseDatasetConfig):
    name: str = "image-net"
    channels: int = 3
    image_size: Tuple[int, int] = (64, 64)
    min_temp: float = 1e-1
    max_temp: float = 1e4
    hf_dataset_name: Optional[str] = "benjamin-paine/imagenet-1k-64x64"


@_dataset
class CelebAConfig(BaseDatasetConfig):
    name: str = "celeba-hq"
    channels: int = 3
    image_size: Tuple[int, int] = (256, 256)
    min_temp: float = 1e1
    max_temp: float = 1e6
    diffusers_model_id: Optional[str] = "google/ddpm-celebahq-256"
    hf_dataset_name: Optional[str] = "student/celebA"


@_dataset
class CelebaHQ30kConfig(BaseDatasetConfig):
    name: str = "celeba-hq-256-30k"
    channels: int = 3
    image_size: Tuple[int, int] = (256, 256)
    min_temp: float = 1e2
    max_temp: float = 1e7
    diffusers_model_id: Optional[str] = "google/ddpm-ema-celebahq-256"
    hf_dataset_name: Optional[str] = "korexyz/celeba-hq-256x256"


@_dataset
class LSUNBedroomsConfig(BaseDatasetConfig):
    name: str = "lsun-bedrooms"
    channels: int = 3
    image_size: Tuple[int, int] = (256, 256)
    min_temp: float = 1e2
    max_temp: float = 1e7
    diffusers_model_id: Optional[str] = "google/ddpm-ema-bedroom-256"
    hf_dataset_name: Optional[str] = "pcuenq/lsun-bedrooms"


@_dataset
class GaussianConfig(BaseDatasetConfig):
    name: str = "gaussian"
    channels: int = 100
    image_size: Tuple[int, int] = (1, 1)
    min_temp: float = 1e-1
    max_temp: float = 1e4
    synthetic_name: Optional[str] = "gaussian"


@_dataset
class GMM1DConfig(BaseDatasetConfig):
    """The 4-mode 1-D GMM toy."""

    name: str = "gmm1d"
    channels: int = 1
    image_size: Tuple[int, int] = (1, 1)
    min_temp: float = 1e-4
    max_temp: float = 1e1
    fid_samples: int = 100
    synthetic_name: Optional[str] = "gmm1d"


@_dataset
class AnisotropicGMMConfig(BaseDatasetConfig):
    """The 100-D anisotropic GMM of the high-dimensional experiment."""

    name: str = "anisotropic_gmm_repro"
    channels: int = 1
    image_size: Tuple[int, int] = (100, 1)
    min_temp: float = 1e-4
    max_temp: float = 1e2
    fid_samples: int = 100
    synthetic_name: Optional[str] = "anisotropic_gmm"
