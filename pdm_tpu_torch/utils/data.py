"""Data layer: dataset ingest to a tensor on the card, or to host memory
with per-step gathers.

Counterpart of ``pdm_tpu/utils/data.py``. Every dataset the reference uses
fits on the card (CIFAR-10 at 32x32 is 600 MB in fp32), so the default is
the whole dataset on the device and minibatches drawn by on-device
gathers (``get_data_tensor``). Larger ones stay in host memory as
``HostResidentData``: the native runtime gathers each step's rows into a
pinned staging buffer, which is copied to the card asynchronously.

Sources, in order:
  * synthetic generators (``utils/synthetic.py``), fully offline;
  * a PDMC cache (``runtime.write_cache``: uint8 NHWC) at
    ``$PDM_DATA_CACHE/{name}_{train|test}.pdmc`` (default directory
    ``data_cache``), memory-mapped and decoded by the native runtime;
  * a Hugging Face dataset already in the local cache (no download).

Transforms match the reference: resize to the config's image size, scale
to [-1, 1], NCHW. Horizontal flips are applied per batch by the trainer.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from .. import runtime
from ..config.config import Config
from ..core.device import DeviceLike, resolve_device
from . import synthetic


def _to_hwc_u8(img, channels: int) -> np.ndarray:
    arr = np.asarray(img)
    if arr.ndim == 2:
        arr = arr[:, :, None]
    if arr.shape[-1] != channels:
        if channels == 1:
            arr = arr.mean(-1, keepdims=True).astype(np.uint8)
        else:
            arr = np.repeat(arr[:, :, :1], channels, axis=-1)
    return arr.astype(np.uint8)


def load_hf_images(
    hf_name: str,
    image_key: str,
    image_size: Tuple[int, int],
    channels: int,
    split: str = "train",
    limit: Optional[int] = None,
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(N, C, H, W) float32 in [-1, 1] (and the labels, if present) from a
    Hugging Face dataset in the local cache. ``HF_DATASETS_OFFLINE=1`` is
    in force while ``datasets`` is first imported and the load runs (the
    library reads it at import), so nothing is downloaded; the caller's
    environment is restored after. Images are resized by the native
    runtime's bilinear resize (all at once when they share a size, else
    one by one)."""
    before = os.environ.get("HF_DATASETS_OFFLINE")
    os.environ["HF_DATASETS_OFFLINE"] = "1"
    try:
        from datasets import load_dataset  # optional: only this source needs it

        try:
            ds = load_dataset(hf_name, split=split)
        except Exception as e:  # the library raises many types for a miss
            raise RuntimeError(
                f"dataset {hf_name!r} is not in the local HF cache and nothing "
                f"is downloaded. Pre-populate the cache, point "
                f"HF_DATASETS_CACHE at one, write a PDMC cache "
                f"(runtime.write_cache) under $PDM_DATA_CACHE, or use a "
                f"synthetic dataset. Original error: {type(e).__name__}: {e}"
            ) from e
    finally:
        if before is None:
            os.environ.pop("HF_DATASETS_OFFLINE", None)
        else:
            os.environ["HF_DATASETS_OFFLINE"] = before
    n = len(ds) if limit is None else min(limit, len(ds))
    labels = np.empty((n,), np.int32) if "label" in ds.column_names else None
    frames = []
    for i in range(n):
        row = ds[i]
        frames.append(_to_hwc_u8(row[image_key], channels))
        if labels is not None:
            labels[i] = row["label"]
    if len({f.shape for f in frames}) == 1:
        raw = runtime.resize_bilinear_u8(np.stack(frames), *image_size)
    else:
        raw = np.concatenate([runtime.resize_bilinear_u8(f[None], *image_size)
                              for f in frames])
    return runtime.normalize_u8_to_chw_f32(raw), labels


def pdmc_cache_path(name: str, train: bool) -> str:
    root = os.environ.get("PDM_DATA_CACHE", "data_cache")
    return os.path.join(root, f"{name}_{'train' if train else 'test'}.pdmc")


def get_data_array(
    config: Config, train: bool = True, limit: Optional[int] = None
) -> np.ndarray:
    """Host-side (N, C, H, W) float32 array of the configured dataset."""
    ds_cfg = config.dataset_config
    if ds_cfg.synthetic_name is not None:
        name = ds_cfg.synthetic_name
        if name == "gmm1d":
            return synthetic.generate_gmm_1d(1_000_000)
        if name == "anisotropic_gmm":
            samples, _, _ = synthetic.generate_anisotropic_gmm(
                dim=ds_cfg.image_size[0], n_samples=50_000
            )
            return samples
        data = synthetic.generate_dataset(name, d=ds_cfg.channels)
        return data.reshape(len(data), ds_cfg.channels, 1, 1)
    cache = pdmc_cache_path(ds_cfg.name, train)
    if os.path.exists(cache):
        raw = runtime.read_cache(cache)  # (N, H, W, C) uint8, memory-mapped
        if limit is not None:
            raw = raw[:limit]
        return runtime.normalize_u8_to_chw_f32(np.asarray(raw))
    if ds_cfg.hf_dataset_name is not None:
        imgs, _ = load_hf_images(
            ds_cfg.hf_dataset_name,
            ds_cfg.image_key,
            ds_cfg.image_size,
            ds_cfg.channels,
            split="train" if train else "test",
            limit=limit,
        )
        return imgs
    raise ValueError(f"dataset {ds_cfg.name} has no data source")


def get_data_tensor(
    config: Config, train: bool = True, limit: Optional[int] = None,
    device: DeviceLike = None,
) -> Tensor:
    """The dataset as an fp32 NCHW tensor on ``device`` (the card unless
    ``device="cpu"``)."""
    dev = resolve_device(device)
    return torch.from_numpy(
        get_data_array(config, train=train, limit=limit)).to(dev)


# ---------------------------------------------------------------------------
# host-resident path for datasets larger than the card's budget
# ---------------------------------------------------------------------------


def data_budget_bytes(device: torch.device) -> int:
    """The share of the card's memory a dataset may take on it: half, the
    rest kept for the model. 0 for the CPU (nothing to keep apart)."""
    if device.type != "cuda":
        return 0
    return torch.cuda.get_device_properties(device).total_memory // 2


class HostResidentData:
    """A dataset kept in host memory, fp32 or uint8 (decoded to [-1, 1] on
    the fly; rows keep the layout they are stored in); each step's rows
    are gathered by the native runtime and sent to ``device``.

    On the card the gather writes into one of two pinned staging buffers,
    and the copy to the card is asynchronous on the current stream; a
    buffer is gathered into again only after the event recorded behind its
    last copy has completed, so a copy in flight is never overwritten. On
    the CPU the batch is a fresh tensor.
    """

    N_STAGING = 2

    def __init__(self, data: np.ndarray, batch_size: int,
                 device: DeviceLike = None):
        self.data = data
        self.batch_size = batch_size
        self.shape = data.shape
        self.device = resolve_device(device)
        row = int(np.prod(data.shape[1:]))
        self._staging = [torch.empty((batch_size, row), dtype=torch.float32,
                                     pin_memory=True)
                         for _ in range(self.N_STAGING)
                         if self.device.type == "cuda"]
        self._copied = [None] * len(self._staging)  # events behind copies
        self._next = 0

    def __len__(self) -> int:
        return self.shape[0]

    def gather(self, idx: np.ndarray) -> np.ndarray:
        """The rows ``idx`` as fp32 (len(idx), C, H, W), in a fresh array."""
        return runtime.gather_rows(self.data, idx).reshape(
            len(idx), *self.shape[1:])

    def device_batch(self, idx: np.ndarray) -> Tensor:
        """The rows ``idx`` as a tensor on the device."""
        if len(idx) > self.batch_size or self.device.type != "cuda":
            return torch.from_numpy(self.gather(idx)).to(self.device)
        k = self._next
        self._next = (k + 1) % len(self._staging)
        if self._copied[k] is not None:
            self._copied[k].synchronize()
        staging = self._staging[k][: len(idx)]
        runtime.gather_rows(self.data, idx, staging.numpy())
        out = staging.view(len(idx), *self.shape[1:]).to(
            self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._copied[k] = event
        return out


def get_dataset_any(config: Config, batch_size: int, train: bool = True,
                    device: DeviceLike = None
                    ) -> Union[Tensor, HostResidentData]:
    """The dataset on the card when it fits half the card's memory, else a
    HostResidentData."""
    dev = resolve_device(device)
    arr = get_data_array(config, train=train)
    if dev.type != "cuda" or arr.nbytes <= data_budget_bytes(dev):
        return torch.from_numpy(arr).to(dev)
    return HostResidentData(arr, batch_size, device=dev)


def get_data_generator(
    data: Tensor, batch_size: int, generator: Optional[torch.Generator] = None
) -> Iterator[Tensor]:
    """Infinite minibatch generator over a dataset tensor: uniform indices
    with replacement from ``generator`` (seeded 0 on the data's device when
    None)."""
    if generator is None:
        generator = torch.Generator(device=data.device).manual_seed(0)
    n = data.shape[0]
    while True:
        idx = torch.randint(0, n, (batch_size,), generator=generator,
                            device=data.device)
        yield data.index_select(0, idx)


def to_uint8(images, values_range: Tuple[float, float] = (-1.0, 1.0)) -> np.ndarray:
    a, b = values_range
    if isinstance(images, Tensor):
        images = images.detach().float().cpu().numpy()
    x = np.clip(np.asarray(images), a, b)
    return ((x - a) / (b - a) * 255.0).astype(np.uint8)


def compute_dataset_average(data: Tensor) -> Tensor:
    """Mean object over the dataset."""
    return torch.mean(data, dim=0)

