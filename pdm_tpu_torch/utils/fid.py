"""FID: batched feature extraction, streaming feature moments, the Frechet
distance.

Counterpart of ``pdm_tpu/utils/fid.py`` (reference ``utils/fid.py``):
streaming feature mean and full covariance, the Frechet distance through
``ops.sqrtm.trace_sqrtm_product`` (eigh, no jitter), the closure that
caches the reference statistics, LeNet features for MNIST and
InceptionV3-2048 elsewhere. Everything runs on ``device``: the card unless
``device="cpu"``.

The Inception path needs pretrained weights, read from the JAX-layout
.npz that ``PDM_INCEPTION_WEIGHTS`` names; without it
:func:`inception_feature_fn` raises ``FileNotFoundError``. The LeNet path
reads ``checkpoints/lenet_{dataset}.npz`` (``scripts.train_lenet``).
"""

from __future__ import annotations

import os
from typing import Callable, Tuple

import torch
from torch import Tensor

from ..core.device import DeviceLike, resolve_device
from ..ops.precision import matmul_fp32
from ..ops.sqrtm import trace_sqrtm_product
from ..parallel.mesh import batch_sharding

FeatureFn = Callable[[Tensor], Tensor]


# ---------------------------------------------------------------------------
# streaming feature moments
# ---------------------------------------------------------------------------


def _shifted_moment_update(carry, feats: Tensor, shift: Tensor, mask: Tensor):
    """Accumulate the first and second moments of (feats - shift) in fp32.
    With shift ~ mu the ss - n outer(mu, mu) cancellation disappears, so
    one fp32 pass matches a two-pass covariance to within rounding
    (Inception features have large nonzero means). ``mask`` (B,): 1 for a
    row that counts, 0 for padding; masked rows are zeroed before the
    sums and n counts the mask."""
    n, s, ss = carry
    feats = (feats.float() - shift) * mask[:, None]
    return (n + mask.sum(), s + feats.sum(dim=0),
            ss + matmul_fp32(feats.T, feats))


@torch.no_grad()
def feature_statistics(
    data,
    feature_fn: FeatureFn,
    feature_dim: int,
    batch_size: int = 500,
    device: DeviceLike = None,
    mesh=None,
) -> Tuple[Tensor, Tensor]:
    """(mu, Sigma) of features over ``data`` (a tensor or array, N first),
    streamed in batches moved to ``device``. Unbiased covariance (as
    torch.cov); the first batch's feature mean is the numerical shift of
    the one-pass accumulator.

    ``mesh``: each batch (rounded down to a multiple of the 'data' axis)
    splits over the axis's ranks, each extracting the features of its
    rows; a ragged last batch is padded to the multiple with zeros and
    masked out of the moments exactly. The shift is the global first
    batch's mean (its padding included, as JAX's), and the moment sums
    are all-reduced at the end (one call), so every rank returns the
    statistics."""
    dev = resolve_device(device)
    n_total = data.shape[0]
    carry = (torch.zeros((), device=dev),
             torch.zeros((feature_dim,), device=dev),
             torch.zeros((feature_dim, feature_dim), device=dev))
    shard = None
    if mesh is not None:
        n_data = mesh.shape["data"]
        batch_size = max(batch_size // n_data, 1) * n_data
        shard = batch_sharding(mesh)
    shift = None
    for i in range(0, n_total, batch_size):
        batch = torch.as_tensor(data[i:i + batch_size])
        if shard is None:
            feats = feature_fn(batch.to(dev))
            if shift is None:
                shift = feats.float().mean(dim=0)
            mask = torch.ones((feats.shape[0],), device=dev)
        else:
            b = batch.shape[0]
            pad = (-b) % n_data
            if pad:
                batch = torch.cat(
                    [batch, batch.new_zeros((pad, *batch.shape[1:]))])
            feats = feature_fn(shard.shard(batch).to(dev))
            mask = shard.shard(torch.arange(b + pad, device=dev) < b).float()
            if shift is None:
                shift = mesh.all_reduce(feats.float().sum(dim=0)) / (b + pad)
        carry = _shifted_moment_update(carry, feats, shift, mask)
    if mesh is not None:
        sums = torch.cat([t.reshape(-1) for t in carry])
        n, s, ss = mesh.all_reduce(sums).split(
            [1, feature_dim, feature_dim * feature_dim])
        carry = (n.reshape(()), s, ss.view(feature_dim, feature_dim))
    n, s, ss = carry
    mu_c = s / n  # mean of the shifted features
    sigma = (ss - n * torch.outer(mu_c, mu_c)) / (n - 1.0)
    return mu_c + shift, sigma


def frechet_distance(mu1: Tensor, sigma1: Tensor, mu2: Tensor,
                     sigma2: Tensor) -> Tensor:
    """FID = ||mu1 - mu2||^2 + tr(S1 + S2 - 2 sqrtm(S1 S2)), 0-d fp32."""
    mean_term = torch.sum(torch.square(mu1.float() - mu2.float()))
    cov_term = (torch.trace(sigma1.float()) + torch.trace(sigma2.float())
                - 2.0 * trace_sqrtm_product(sigma1, sigma2))
    return mean_term + cov_term


# ---------------------------------------------------------------------------
# feature extractors
# ---------------------------------------------------------------------------


def lenet_feature_fn(checkpoint_path: str, device: DeviceLike = None
                     ) -> Tuple[FeatureFn, int]:
    """100-dim LeNet features of MNIST-shaped (B, 1, H, W) data in
    [-1, 1], fed in as they are (reference utils/fid.py:40)."""
    from ..models.lenet import load_lenet

    dev = resolve_device(device)
    model = load_lenet(checkpoint_path, device=dev)

    @torch.no_grad()
    def fn(x: Tensor) -> Tensor:
        return model(x.to(dev, torch.float32), features_only=True)

    return fn, 100


def quantize_like_uint8(x: Tensor) -> Tensor:
    """The reference's uint8 round trip before the feature extractor
    (``inception(to_uint8(x))``; to_uint8 truncates, torchmetrics rescales
    k -> 2k/255 - 1), on the device: floor((clip(x) + 1) 127.5) 2/255 - 1."""
    k = torch.clamp(torch.floor((torch.clamp(x, -1.0, 1.0) + 1.0) * 127.5),
                    0.0, 255.0)
    return k * (2.0 / 255.0) - 1.0


def inception_feature_fn(device: DeviceLike = None) -> Tuple[FeatureFn, int]:
    """InceptionV3 pool-2048 features (FID-standard) from the weights
    ``PDM_INCEPTION_WEIGHTS`` names, generated floats and stored uint8
    data alike quantized to uint8 levels first."""
    path = os.environ.get("PDM_INCEPTION_WEIGHTS")
    if not path or not os.path.exists(path):
        raise FileNotFoundError(
            "InceptionV3 FID weights not available offline; set "
            "PDM_INCEPTION_WEIGHTS to a converted-npz path "
            "(see pdm_tpu_torch/models/inception.py) or use the LeNet path."
        )
    from ..models.inception import load_inception

    dev = resolve_device(device)
    model = load_inception(path, device=dev)

    @torch.no_grad()
    def fn(x: Tensor) -> Tensor:
        return model(quantize_like_uint8(x.to(dev, torch.float32)))

    return fn, 2048


def get_feature_fn(dataset_name: str,
                   lenet_checkpoint: str = "checkpoints/lenet_mnist.npz",
                   device: DeviceLike = None) -> Tuple[FeatureFn, int]:
    """Dataset dispatch (reference utils/fid.py:43-48): LeNet for MNIST,
    InceptionV3 otherwise."""
    if dataset_name == "mnist":
        return lenet_feature_fn(lenet_checkpoint, device=device)
    return inception_feature_fn(device=device)


# ---------------------------------------------------------------------------
# the cached-reference closure
# ---------------------------------------------------------------------------


def get_compute_fid(
    reference_data,
    feature_fn: FeatureFn,
    feature_dim: int,
    batch_size: int = 500,
    device: DeviceLike = None,
    mesh=None,
) -> Callable[[object], float]:
    """A closure over the reference statistics (reference
    utils/fid.py:77-86): data -> FID against the reference, a float.
    ``mesh`` splits the feature extraction over its 'data' axis."""
    dev = resolve_device(device)
    mu_ref, sigma_ref = feature_statistics(
        reference_data, feature_fn, feature_dim, batch_size, device=dev,
        mesh=mesh)

    def compute(data) -> float:
        mu, sigma = feature_statistics(data, feature_fn, feature_dim,
                                       batch_size, device=dev, mesh=mesh)
        return float(frechet_distance(mu_ref, sigma_ref, mu, sigma))

    return compute
