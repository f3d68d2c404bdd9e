"""Port parity: FID (ops/sqrtm.py, models/lenet.py, models/inception.py,
utils/fid.py and the eval hook's FID) against the JAX package's, on the CPU.

Tolerances:

* ``trace_sqrtm_product`` / ``frechet_distance``: the JAX package's own
  cases (tests/test_fid.py) with their tolerances against scipy, and the
  FID of a rank-deficient set with itself 0 within 1e-3; the port (float64
  eigh) within 1e-5 of scipy at full rank, and JAX's (fp32 eigh) within
  1e-4 of the port there and within 5e-3 on a rank-deficient product;
  at rank 64 of 2048 features within 1e-5 of the nuclear norm of the
  centred features' product, a reference with no eigh and no threshold.
* ``feature_statistics``: mean within 1e-5 and covariance within 1e-4
  relative / 1e-5 absolute of numpy's and of JAX's on the same features.
* LeNet: logits and features within 1e-5 of JAX's with JAX's parameters;
  the .npz bitwise in both directions; ``train_lenet`` above 0.9 accuracy
  on tests/test_fid.py's separable set, as JAX's.
* InceptionV3 with JAX's seeded random parameters: features within 1e-5
  of their scale at 75 x 75 (``resize_input=False``) and through the
  299 resize; the resize alone within 1e-6 enlarging (32 -> 299) and 1e-4
  shrinking (320 -> 299: JAX's and PyTorch's antialiasing filters sum the
  same taps in another order); the .npz bitwise both ways; the uint8 round
  trip exact.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdm_tpu.models import inception as jinc
from pdm_tpu.models import lenet as jlenet
from pdm_tpu.ops.sqrtm import trace_sqrtm_product as j_trace_sqrtm
from pdm_tpu.utils import fid as jfid

from pdm_tpu_torch.config.loader import load_config
from pdm_tpu_torch.models import inception as tinc
from pdm_tpu_torch.models import lenet as tlenet
from pdm_tpu_torch.models.base import TrueDDPM
from pdm_tpu_torch.ops.sqrtm import sqrtm_newton_schulz, trace_sqrtm_product
from pdm_tpu_torch.schedulers.analytic import LinearBetaScheduler
from pdm_tpu_torch.utils import fid as tfid
from pdm_tpu_torch.utils import logging as tlog
from torch_port_fixtures import two_torch_threads  # noqa: F401

scipy_linalg = pytest.importorskip("scipy.linalg")

T = torch.from_numpy


def random_spd(dim, seed, scale=1.0):
    rng = np.random.RandomState(seed)
    a = rng.randn(dim, dim)
    return (a @ a.T / dim + 0.1 * np.eye(dim)).astype(np.float32) * scale


def low_rank_cov(n, dim, seed):
    f = np.random.RandomState(seed).randn(n, dim).astype(np.float32)
    f -= f.mean(0, keepdims=True)
    return (f.T @ f / (n - 1)).astype(np.float32)


# ---------------------------------------------------------------------------
# sqrtm and the Frechet distance
# ---------------------------------------------------------------------------


def test_sqrtm_matches_scipy():
    a = random_spd(64, 0)
    got = sqrtm_newton_schulz(T(a), num_iters=25).numpy()
    np.testing.assert_allclose(got, scipy_linalg.sqrtm(a).real,
                               rtol=1e-3, atol=1e-3)
    b = random_spd(64, 1)
    got_tr = float(trace_sqrtm_product(T(a), T(b)))
    want_tr = np.trace(scipy_linalg.sqrtm(a @ b).real)
    np.testing.assert_allclose(got_tr, want_tr, rtol=1e-3)


def test_trace_sqrtm_rank_deficient():
    """n_samples << feature_dim: exact on the singular product with no
    jitter, FID of a set with itself 0 within 1e-3, never negative."""
    dim, n1, n2 = 256, 24, 40
    a, b = low_rank_cov(n1, dim, 5), low_rank_cov(n2, dim, 6)
    got = float(trace_sqrtm_product(T(a), T(b)))
    want = float(np.trace(scipy_linalg.sqrtm(a.astype(np.float64) @ b).real))
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)

    rng = np.random.RandomState(5)
    f1 = rng.randn(n1, dim).astype(np.float32)
    f2 = rng.randn(n2, dim).astype(np.float32) + 0.1
    mu1, mu2 = T(f1.mean(0)), T(f2.mean(0))
    s1 = T(np.cov(f1, rowvar=False).astype(np.float32))
    s2 = T(np.cov(f2, rowvar=False).astype(np.float32))
    assert float(tfid.frechet_distance(mu1, s1, mu2, s2)) >= 0.0
    for mu, s in ((mu1, s1), (mu2, s2)):
        self_fid = float(tfid.frechet_distance(mu, s, mu, s))
        assert abs(self_fid) <= 1e-3, self_fid


def test_frechet_gaussian_closed_form():
    """N(m1, s1 I) vs N(m2, s2 I) in dim d: ||m1-m2||^2 + d (sqrt(s1) -
    sqrt(s2))^2."""
    d, s1, s2 = 32, 2.0, 0.5
    fid = float(tfid.frechet_distance(torch.zeros(d), s1 * torch.eye(d),
                                      torch.full((d,), 0.5), s2 * torch.eye(d)))
    want = d * 0.25 + d * (np.sqrt(s1) - np.sqrt(s2)) ** 2
    np.testing.assert_allclose(fid, want, rtol=1e-3)


def test_trace_sqrtm_rank_64_at_inception_width():
    """65 samples of 2048 features (rank 64): the port's eigh form, its
    null space zeroed, against a reference that takes no eigenvalue and no
    threshold. With A, B the centred features over sqrt(n - 1), S1 = A^T A
    and S2 = B^T B, so tr sqrtm(S1 S2) is the nuclear norm of A B^T; with
    A = Q1 R1 and B = Q2 R2 that is the sum of the singular values of
    R1 R2^T, in float64. Within 1e-5 relative (the port's fp32 output)."""
    n, f = 65, 2048
    rng = np.random.RandomState(11)
    scales = np.exp(-np.arange(f) / 400.0)
    feats = [rng.randn(n, f) * scales + 0.5, rng.randn(n, f) * scales * 1.1]
    feats = [x.astype(np.float32) for x in feats]
    rs = [np.linalg.qr((x - x.mean(0, dtype=np.float64)) / np.sqrt(n - 1),
                       mode="r") for x in feats]
    want = np.linalg.svd(rs[0] @ rs[1].T, compute_uv=False).sum()
    covs = [T(np.cov(x, rowvar=False).astype(np.float32)) for x in feats]
    got = float(trace_sqrtm_product(*covs))
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("case,scipy_rtol,jax_rtol", [
    ("full_rank", 1e-5, 1e-4), ("rank_deficient", 1e-3, 5e-3)])
def test_trace_sqrtm_product_and_fid_match_jax(case, scipy_rtol, jax_rtol):
    """The port against scipy's float64 trace: within 1e-5 at full rank,
    1e-3 on a singular product (where scipy's Schur sqrtm itself is good to
    ~sqrt(eps) of the scale). JAX's fp32 within 1e-4 of the port at full
    rank and, on the singular product, within 5e-3, the tolerance
    tests/test_fid.py holds JAX to against scipy there (its fp32 null
    eigenvalues bias the trace)."""
    if case == "full_rank":
        a, b = random_spd(128, 2), random_spd(128, 3, scale=2.0)
    else:
        a, b = low_rank_cov(24, 256, 7), low_rank_cov(40, 256, 8)
    exact = float(np.trace(scipy_linalg.sqrtm(a.astype(np.float64) @ b).real))
    got = float(trace_sqrtm_product(T(a), T(b)))
    np.testing.assert_allclose(got, exact, rtol=scipy_rtol)
    want = float(j_trace_sqrtm(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=jax_rtol)
    mu1 = np.random.RandomState(9).randn(a.shape[0]).astype(np.float32)
    mu2 = mu1 + 0.1
    want_fid = float(jfid.frechet_distance(jnp.asarray(mu1), jnp.asarray(a),
                                           jnp.asarray(mu2), jnp.asarray(b)))
    got_fid = float(tfid.frechet_distance(T(mu1), T(a), T(mu2), T(b)))
    np.testing.assert_allclose(got_fid, want_fid, rtol=0,
                               atol=2 * jax_rtol * want)


# ---------------------------------------------------------------------------
# feature statistics
# ---------------------------------------------------------------------------


def test_feature_statistics_streaming():
    data = np.random.RandomState(2).randn(1000, 16).astype(np.float32)
    mu, sigma = tfid.feature_statistics(T(data), lambda x: x, 16,
                                        batch_size=128, device="cpu")
    np.testing.assert_allclose(mu.numpy(), data.mean(0), atol=1e-5)
    np.testing.assert_allclose(sigma.numpy(), np.cov(data.T), rtol=1e-4,
                               atol=1e-5)


def test_feature_statistics_match_jax():
    """The same features (a shared feature_fn: x -> W x + b with large
    means, as Inception's) through both packages, a ragged last batch."""
    rng = np.random.RandomState(11)
    data = rng.randn(777, 12).astype(np.float32)
    w = rng.randn(12, 24).astype(np.float32)
    b = (10.0 + rng.randn(24)).astype(np.float32)
    want_mu, want_sigma = jfid.feature_statistics(
        jnp.asarray(data), lambda x: x @ jnp.asarray(w) + jnp.asarray(b), 24,
        batch_size=100)
    got_mu, got_sigma = tfid.feature_statistics(
        data, lambda x: x @ T(w) + T(b), 24, batch_size=100, device="cpu")
    np.testing.assert_allclose(got_mu.numpy(), np.asarray(want_mu), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got_sigma.numpy(), np.asarray(want_sigma),
                               rtol=1e-4, atol=1e-5)


def test_compute_fid_closure_discriminates():
    rng = np.random.RandomState(3)
    ref = rng.randn(2000, 8).astype(np.float32)
    close = rng.randn(2000, 8).astype(np.float32)
    compute = tfid.get_compute_fid(T(ref), lambda x: x, 8, device="cpu")
    assert compute(T(close)) < 0.2
    assert compute(T(close + 2.0)) > 8.0 * 4 * 0.9  # ~ d * shift^2
    want = jfid.get_compute_fid(jnp.asarray(ref), lambda x: x, 8)(
        jnp.asarray(close))
    np.testing.assert_allclose(compute(close), want, rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# LeNet
# ---------------------------------------------------------------------------


def separable_set(n=512):
    rng = np.random.RandomState(4)
    x = rng.randn(n, 1, 8, 8).astype(np.float32)
    return x, (x.reshape(n, -1).sum(1) > 0).astype(np.int32)


@pytest.fixture(scope="module")
def jax_lenet():
    x, _ = separable_set()
    return jlenet.LeNet().init(jax.random.PRNGKey(1), jnp.asarray(x[:1]))["params"]


def test_lenet_matches_jax(jax_lenet):
    """JAX's parameters, carried across by lenet_from_flax_params."""
    x, _ = separable_set()
    model = tlenet.LeNet(in_dim=64)
    model.load_state_dict(
        tlenet.lenet_from_flax_params(jax.device_get(jax_lenet)), strict=True)
    with torch.no_grad():
        logits = model(T(x[:32])).numpy()
        feats = model(T(x[:32]), features_only=True).numpy()
    want = np.asarray(jlenet.LeNet().apply({"params": jax_lenet},
                                           jnp.asarray(x[:32])))
    want_f = np.asarray(jlenet.LeNet().apply(
        {"params": jax_lenet}, jnp.asarray(x[:32]), features_only=True))
    assert feats.shape == (32, 100)
    np.testing.assert_allclose(logits, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feats, want_f, rtol=1e-5, atol=1e-5)


def test_lenet_npz_both_directions(jax_lenet, tmp_path):
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jlenet.save_lenet(jax_lenet, jpath)
    model = tlenet.load_lenet(jpath, device="cpu")
    params = jax.device_get(jax_lenet)
    sd = model.state_dict()
    assert set(sd) == {f"{n}.{w}" for n in params for w in ("weight", "bias")}
    for name, leaves in params.items():
        assert np.array_equal(sd[f"{name}.weight"].numpy(), leaves["kernel"].T)
        assert np.array_equal(sd[f"{name}.bias"].numpy(), leaves["bias"])
    tlenet.save_lenet(model, tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "['fc_0']/['kernel']" in b.files
    _, back = jlenet.load_lenet(tpath)
    for name, leaves in params.items():
        for leaf, v in leaves.items():
            np.testing.assert_array_equal(np.asarray(back[name][leaf]), v)


def test_train_lenet_accuracy(tmp_path):
    x, y = separable_set()
    model = tlenet.train_lenet(torch.Generator().manual_seed(0), x, y,
                               batch_size=64, epochs=8, verbose=False,
                               device="cpu")
    _, acc = tlenet.evaluate_lenet(model, x, y)
    assert acc > 0.9
    with torch.no_grad():
        assert model(T(x[:10]), features_only=True).shape == (10, 100)
    path = str(tmp_path / "lenet.npz")
    tlenet.save_lenet(model, path)
    again = tlenet.load_lenet(path, device="cpu")
    with torch.no_grad():
        assert torch.equal(again(T(x[:10])), model(T(x[:10])))


# ---------------------------------------------------------------------------
# InceptionV3
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_inception():
    """JAX's parameter tree (shapes from eval_shape, no compile) filled with
    seeded values: kernels He-normal, so features stay O(1) through the 94
    ReLU layers, and BN statistics and affines away from the identity."""
    shapes = jax.eval_shape(
        lambda k: jinc.InceptionV3Features(resize_input=False).init(
            k, jnp.zeros((1, 3, 75, 75)))["params"], jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def fill(path, s):
        leaf = path[-1].key
        if leaf == "kernel":
            fan_in = int(np.prod(s.shape[:3]))
            return (rng.randn(*s.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)
        if leaf in ("bn_scale", "bn_var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.randn(*s.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def port_inception(jax_inception):
    def make(resize_input):
        m = tinc.InceptionV3Features(resize_input=resize_input)
        m.load_state_dict(tinc.inception_from_flax_params(jax_inception),
                          strict=True)
        return m.eval()

    return make


def inception_close(got, want):
    scale = float(np.abs(want).max())
    assert scale > 1e-2
    assert float(np.abs(got - want).max()) <= 1e-5 * scale


def test_inception_matches_jax_at_75(jax_inception, port_inception):
    x = np.random.RandomState(1).uniform(-1, 1, (2, 3, 75, 75)).astype(np.float32)
    want = np.asarray(jinc.InceptionV3Features(resize_input=False).apply(
        {"params": jax_inception}, jnp.asarray(x)))
    with torch.no_grad():
        got = port_inception(False)(T(x)).numpy()
    assert got.shape == (2, 2048)
    inception_close(got, want)
    n = sum(v.numel() for v in port_inception(False).state_dict().values())
    assert 20e6 < n < 25e6, n  # the torchvision trunk's ~21.8M


def test_inception_matches_jax_through_the_resize(jax_inception, port_inception):
    """One grayscale 32 x 32 image: repeated to RGB, resized to 299."""
    x = np.random.RandomState(2).uniform(-1, 1, (1, 1, 32, 32)).astype(np.float32)
    want = np.asarray(jinc.InceptionV3Features().apply(
        {"params": jax_inception}, jnp.asarray(x)))
    with torch.no_grad():
        got = port_inception(True)(T(x)).numpy()
    inception_close(got, want)


@pytest.mark.parametrize("size,tol", [(32, 1e-6), (320, 1e-4)])
def test_resize_matches_jax(size, tol):
    y = np.random.RandomState(3).uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(y), (2, 299, 299, 3),
                                       "bilinear"))
    got = tinc.resize_bilinear(T(y).permute(0, 3, 1, 2), (299, 299))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=tol)


def test_convert_torch_state_dict(port_inception):
    """A torchvision-named state dict (with fc, AuxLogits and
    num_batches_tracked) lands on the port's module, BN stats in place."""
    want = port_inception(False).state_dict()
    fake = {"fc.weight": np.zeros((1008, 2048), np.float32),
            "fc.bias": np.zeros((1008,), np.float32),
            "AuxLogits.conv0.conv.weight": np.zeros((128, 768, 1, 1), np.float32)}
    names = {v: k for k, v in tinc._TORCH_BN.items()}
    for key, v in want.items():
        *scope, leaf = key.split(".")
        if leaf == "weight":
            fake[key] = v.numpy()
        else:
            fake[".".join([*scope, "bn", names[leaf]])] = v.numpy()
            fake[".".join([*scope, "bn", "num_batches_tracked"])] = np.zeros((), np.int64)
    got = tinc.convert_torch_state_dict(fake)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_inception_npz_both_directions(jax_inception, tmp_path):
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jinc.save_inception(jax_inception, jpath)
    model = tinc.load_inception(jpath, device="cpu")
    want = tinc.inception_from_flax_params(jax_inception)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    tinc.save_inception(model, tpath)
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        assert "Mixed_5b/branch1x1/conv/kernel" in b.files
    _, back = jinc.load_inception(tpath)
    flat = jax.tree_util.tree_leaves_with_path(jax_inception)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, v in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[path]), v)


def test_uint8_round_trip_matches_jax():
    x = np.concatenate([np.linspace(-1.2, 1.2, 2001),
                        np.random.RandomState(4).uniform(-1, 1, 4000),
                        np.arange(256) * 2.0 / 255.0 - 1.0]).astype(np.float32)
    xj = jnp.asarray(x)
    k = jnp.clip(jnp.floor((jnp.clip(xj, -1.0, 1.0) + 1.0) * 127.5), 0.0, 255.0)
    want = np.asarray(k * (2.0 / 255.0) - 1.0)
    np.testing.assert_array_equal(tfid.quantize_like_uint8(T(x)).numpy(), want)


def test_inception_feature_fn_reads_the_weights(monkeypatch, tmp_path):
    monkeypatch.delenv("PDM_INCEPTION_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError, match="PDM_INCEPTION_WEIGHTS"):
        tfid.inception_feature_fn(device="cpu")
    with pytest.raises(FileNotFoundError):
        tfid.get_feature_fn("cifar10", device="cpu")
    path = str(tmp_path / "incep.npz")
    tinc.save_inception(tinc.InceptionV3Features(), path)
    monkeypatch.setenv("PDM_INCEPTION_WEIGHTS", path)
    fn, dim = tfid.get_feature_fn("cifar10", device="cpu")
    x = torch.rand(2, 3, 75, 75) * 2 - 1
    assert dim == 2048 and fn(x).shape == (2, 2048)
    model = tinc.load_inception(path, device="cpu")
    with torch.no_grad():
        assert torch.equal(fn(x), model(tfid.quantize_like_uint8(x)))


# ---------------------------------------------------------------------------
# the eval hook
# ---------------------------------------------------------------------------


def mnist_like(n, seed):
    """MNIST-shaped (n, 1, 32, 32) images on uint8 levels in [-1, 1]."""
    u8 = np.random.RandomState(seed).randint(0, 256, (n, 1, 32, 32))
    return (u8 * (2.0 / 255.0) - 1.0).astype(np.float32)


def test_eval_fn_returns_fid_with_lenet(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    os.makedirs("checkpoints")
    model = tlenet.init_lenet(tlenet.LeNet(), torch.Generator().manual_seed(0))
    tlenet.save_lenet(model, "checkpoints/lenet_mnist.npz")
    cfg = load_config()
    cfg.dataset_name = "mnist"
    cfg.ddpm.noise_schedule_type = "linear_beta"
    cfg.fid.samples = 48
    data = T(mnist_like(64, 0))
    ddpm = TrueDDPM(scheduler=LinearBetaScheduler(*cfg.diffusion.temp_range),
                    train_data=data, device="cpu")
    eval_fn = tlog.make_eval_fn(cfg, data, sample_dir="ev", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        metrics = eval_fn(ddpm, step=3)
    assert set(metrics) == {"fid_100_steps"}
    assert np.isfinite(metrics["fid_100_steps"]) and metrics["fid_100_steps"] >= 0
    assert tlog.read_png(os.path.join("ev", "step_3.png")).shape == (160, 160)
    # fid.required holds while the extractor is there
    cfg.fid.required = True
    tlog.make_eval_fn(cfg, data, sample_dir="ev", device="cpu")
    os.remove("checkpoints/lenet_mnist.npz")
    with pytest.raises(RuntimeError, match="fid.required"):
        tlog.make_eval_fn(cfg, data, sample_dir="ev", device="cpu")
