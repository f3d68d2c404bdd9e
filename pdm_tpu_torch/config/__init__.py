from .config import Config as Config
from .datasets import (
    BaseDatasetConfig as BaseDatasetConfig,
    DatasetRegistry as DatasetRegistry,
)
from .loader import load_config as load_config, with_config as with_config
