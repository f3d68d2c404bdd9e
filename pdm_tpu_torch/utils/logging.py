"""Training observability: the CSV metrics logger (wandb optional), image
grids as PNG, and the periodic evaluation hook (a DDIM-100 sample grid and
FID on the EMA weights).

Counterpart of ``pdm_tpu/utils/logging.py``. ``CSVLogger`` writes the same
columns and rows for the same calls. ``save_image_grid`` writes the PNG
itself (``zlib`` and ``struct``: 8-bit gray or RGB, one IDAT, filter 0),
since PIL is not a dependency of the port; :func:`read_png` reads such a
file back. ``make_eval_fn`` samples the grid and computes FID as JAX's
hook does; when the feature extractor's weights are unavailable it warns
at every eval, or raises at construction when ``fid.required`` is true.
"""

from __future__ import annotations

import csv
import os
import struct
import time
import warnings
import zlib
from typing import Dict, Optional

import numpy as np
import torch

from ..core.device import DeviceLike, resolve_device

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


class CSVLogger:
    """Append-only CSV of (step, metric, value, time)."""

    def __init__(self, path: str, use_wandb: bool = False, run_name: str = ""):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._new = not os.path.exists(path)
        self._wandb = None
        if use_wandb:
            try:  # optional: CSV logging stays on without it
                import wandb

                wandb.init(
                    project="physics-of-diffusion-models",
                    name=run_name or None,
                    id=run_name or None,
                    resume="allow",
                )
                self._wandb = wandb
            except Exception as e:  # a sink that fails must not stop training
                warnings.warn(f"wandb unavailable ({type(e).__name__}: {e}); "
                              f"logging to {path} only", stacklevel=2)
                self._wandb = None

    def __call__(self, step: int, metrics: Dict[str, float]) -> None:
        with open(self.path, "a", newline="") as f:
            writer = csv.writer(f)
            if self._new:
                writer.writerow(["step", "metric", "value", "time"])
                self._new = False
            now = time.time()
            for k, v in metrics.items():
                writer.writerow([step, k, v, now])
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def log_images(self, step: int, tag: str, images: np.ndarray) -> None:
        """(N, C, H, W) in [-1, 1] -> wandb image panel (nothing without
        wandb)."""
        if self._wandb is None:
            return
        from .data import to_uint8

        imgs = np.transpose(to_uint8(np.asarray(images)), (0, 2, 3, 1))
        if imgs.shape[-1] == 1:
            imgs = imgs[..., 0]
        self._wandb.log(
            {tag: [self._wandb.Image(im) for im in imgs]}, step=step
        )


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """(H, W) or (H, W, 3) uint8 -> an 8-bit gray or RGB PNG."""
    image = np.ascontiguousarray(image, dtype=np.uint8)
    if image.ndim == 2:
        color = 0
    elif image.ndim == 3 and image.shape[2] == 3:
        color = 2
    else:
        raise ValueError(f"write_png takes (H, W) or (H, W, 3): {image.shape}")
    h, w = image.shape[:2]
    rows = image.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """A PNG as :func:`write_png` writes it (8-bit gray or RGB, no
    interlace, filter 0) -> (H, W) or (H, W, 3) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"not a PNG: {path}")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {kind!r} chunk of {path}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None:
        raise ValueError(f"no IHDR chunk in {path}")
    w, h, depth, color, _, _, interlace = header
    if depth != 8 or color not in (0, 2) or interlace:
        raise ValueError(f"read_png reads 8-bit gray/RGB, non-interlaced "
                         f"PNGs: depth {depth}, color {color}, interlace "
                         f"{interlace}")
    ch = 1 if color == 0 else 3
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * ch)
    if (raw[:, 0] != 0).any():
        raise ValueError(f"read_png reads rows without a filter (type 0), as "
                         f"write_png writes them: {path}")
    pixels = raw[:, 1:]
    return pixels.reshape(h, w) if ch == 1 else pixels.reshape(h, w, 3)


def image_grid(images: np.ndarray, nrow: int = 5) -> np.ndarray:
    """(N, C, H, W) in [-1, 1] -> the uint8 grid, (H', W') for one
    channel, else (H', W', C); ``nrow`` images a row."""
    from .data import to_uint8

    imgs = to_uint8(images)
    n, c, h, w = imgs.shape
    ncol = nrow
    nrows = int(np.ceil(n / ncol))
    grid = np.zeros((c, nrows * h, ncol * w), np.uint8)
    for i in range(n):
        r, col = divmod(i, ncol)
        grid[:, r * h: (r + 1) * h, col * w: (col + 1) * w] = imgs[i]
    arr = np.transpose(grid, (1, 2, 0))
    return arr[:, :, 0] if c == 1 else arr


def save_image_grid(images: np.ndarray, path: str, nrow: int = 5) -> None:
    """(N, C, H, W) in [-1, 1] -> PNG grid (1 or 3 channels)."""
    write_png(path, image_grid(images, nrow))


def make_eval_fn(
    config, reference_data, sample_dir: str = "eval_samples", logger=None,
    device: DeviceLike = None, mesh=None,
):
    """Periodic eval hook: a DDIM-100 sample of 25 images on the EMA
    weights, saved as ``sample_dir/step_{step}.png`` (and forwarded to the
    logger's wandb panel when wandb is active), then FID over
    ``fid.samples`` (else the dataset's ``fid_samples``) DDIM-100 samples
    against ``reference_data``, logged as ``fid_100_steps``. The grid
    samples at JAX's batch, ``min(500, fid_samples)``, from a generator
    seeded with the step; the FID samples at ``min(64, n_fid)`` from one
    seeded with the step + 1. The reference statistics are computed here,
    once. When the feature extractor cannot be read (no
    ``PDM_INCEPTION_WEIGHTS``, no LeNet checkpoint) the hook warns at every
    eval, or raises here when ``fid.required`` is true.

    ``mesh``: every rank builds the hook and calls it at the same steps
    (the trainer's ranks, so that none waits in the next step's gradient
    all-reduce through another's eval). Each rank steps its rows of every
    sampling batch that the 'data' axis divides (``sharded_sampler``; the
    draws are the global batch's, so the samples are one process's) and
    extracts the features of its rows (``get_compute_fid(mesh=)``); rank 0
    alone writes the grid and warns. On a mesh with a model axis it
    samples through ``partition="data"`` with the whole EMA model (the
    ranks of a model group step the same rows), whichever partition the
    trainer uses."""
    from ..diffusion.sampling import DDPMSampler
    from ..parallel.distributed import sharded_sampler
    from ..parallel.mesh import rank
    from ..schedulers.from_config import scheduler_from_config
    from .fid import get_compute_fid, get_feature_fn

    dev = resolve_device(device)
    lead = mesh is None or rank() == 0
    compute_fid, fid_error = None, None
    try:
        feature_fn, fdim = get_feature_fn(config.dataset_name, device=dev)
        compute_fid = get_compute_fid(reference_data, feature_fn, fdim,
                                      device=dev, mesh=mesh)
    except OSError as e:  # the extractor's weights are not on disk
        if config.fid.required:
            raise RuntimeError(
                f"fid.required=true but the FID feature extractor is "
                f"unavailable: {e}") from e
        fid_error = e
    if lead:
        os.makedirs(sample_dir, exist_ok=True)
    scheduler = scheduler_from_config(config, device=dev)

    def sampler(n_samples: int, batch_size: int, ema_ddpm) -> DDPMSampler:
        s = DDPMSampler(
            ddpm=ema_ddpm,
            scheduler=scheduler,
            n_steps=100,
            obj_size=config.dataset_config.obj_size,
            batch_size=batch_size,
            n_samples=n_samples,
            step_type="ddim",
            device=dev,
        )
        if mesh is not None and batch_size % mesh.shape["data"] == 0:
            s = sharded_sampler(s, mesh)
        return s

    def eval_fn(ema_ddpm, step: int) -> Dict[str, float]:
        grid_sampler = sampler(25, min(500, config.dataset_config.fid_samples),
                               ema_ddpm)
        gen = torch.Generator(device=dev).manual_seed(int(step))
        grid = grid_sampler.sample(gen)["x"]
        if lead:
            save_image_grid(grid, os.path.join(sample_dir, f"step_{step}.png"))
        if logger is not None:
            logger.log_images(step, "eval_samples", grid)
        if compute_fid is None:
            # every eval, not once: a long run must not finish quietly with
            # no quality metric
            if lead:
                warnings.warn(
                    f"[eval step {step}] FID unavailable: no quality metric "
                    f"is being recorded ({fid_error})",
                    stacklevel=2,
                )
            return {}
        n_fid = config.fid.samples or config.dataset_config.fid_samples
        gen = torch.Generator(device=dev).manual_seed(int(step) + 1)
        samples = sampler(n_fid, min(64, n_fid), ema_ddpm).sample(gen)["x"]
        return {"fid_100_steps": compute_fid(samples)}

    return eval_fn
