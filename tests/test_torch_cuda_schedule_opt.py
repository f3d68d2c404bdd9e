"""Schedule optimization on the card: the posterior mean's VJP kernel
(row 7b, csrc/boltzmann_moments_vjp.cu) and the gradients built on it.

Every test is `cuda`-marked and skips without an NVIDIA GPU. The file
imports torch, numpy and the port only (no JAX), so on a GPU machine it
runs from the repository root with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda_schedule_opt.py -q

Tolerances: the kernel is held to its plain version on the same card
inputs within chip_smoke.vjp_tolerance (the first-order move of the VJP
under the logits' and Grams' rounding differences), two calls bitwise
equal; gradients card against CPU on the 1-D GMM within chip_smoke's
GMM_GRAD_TOL (tests/test_torch_schedule_opt.py's, of scale); the
denoiser's gradient at temperatures 1e-2 to 10 within 2e-3 of scale,
ten times the ~2e-4 relative move of the posterior weights that its
logits' rounding (inv_temp <= 100 times a few ulp of |h| <= 10) allows.
"""

import os
import sys

import numpy as np
import pytest
import torch

from pdm_tpu_torch.diffusion.sampling import STEP_TYPES, discretize_schedule
from pdm_tpu_torch.diffusion.schedule_opt import sample_with_grid
from pdm_tpu_torch.models.base import TrueDDPM
from pdm_tpu_torch.ops import boltzmann as bz
from pdm_tpu_torch.ops import boltzmann_sweep as sw
from pdm_tpu_torch.schedulers.analytic import LogSNRScheduler
from pdm_tpu_torch.utils.synthetic import generate_gmm_1d

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from chip_smoke import (  # noqa: E402
    GMM_GRAD, GMM_GRAD_TOL, gram_rounding, kernel_gram_steps, moments_logit_error,
    top_two_gap, vjp_case, vjp_tolerance,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels build and run only on "
                    "the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (B, N, D, mode): edges in every mode; the schedule CLI's shape and D = 2,
# 3, 4 in fp32 (the small-D kernel); every case's first row at T = 1e-4,
# where p is one-hot
VJP_CASES = ([(B, N, D, mode) for mode in ("fp32", "bf16_3x", "bf16")
              for B, N, D in ((37, 1003, 5), (64, 4096, 1), (130, 5000, 64))]
             + [(1024, 100_000, 1, "fp32"), (64, 4096, 2, "fp32"), (64, 4096, 3, "fp32"),
                (64, 4096, 4, "fp32")])


@pytest.mark.cuda
@pytest.mark.parametrize("B,N,D,mode", VJP_CASES)
def test_vjp_kernel_matches_plain_on_card(cuda_device, B, N, D, mode):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    y = torch.randn(N, D, generator=g, device=cuda_device)
    x, it, s, c = vjp_case(cuda_device, g, y, B, (-4.0, 1.0))
    prep = sw.prepare_y(y, mode)
    mom = bz.boltzmann_moments(x, prep, it, s, values=y, mxu_precision=mode)
    before = bz.posterior_mean_vjp.launches
    got = bz.posterior_mean_vjp(x, prep, it, s, mom.log_z, mom.mean, c, values=y,
                                mxu_precision=mode)
    torch.cuda.synchronize()
    # the small-D kernel and the merge at D <= 4 in fp32; else the Grams,
    # the product and the merge (one segment at these shapes)
    assert bz.posterior_mean_vjp.launches == before + (2 if mode == "fp32" and D <= 4 else 3)
    again = bz.posterior_mean_vjp(x, prep, it, s, mom.log_z, mom.mean, c, values=y,
                                  mxu_precision=mode)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = bz.boltzmann_moments_reference(x, y, it, s, compute_mean=True, mxu_precision=mode)
    want = bz.posterior_mean_vjp_reference(x, y, it, s, ref.log_z, ref.mean, c,
                                           mxu_precision=mode)
    xsq, ysq, csq = (float((0.5 * (t * t).sum(1)).max()) for t in (x, y, c))
    steps = kernel_gram_steps(mode, D)
    delta = moments_logit_error(xsq, ysq, D, it.cpu().numpy(), s.cpu().numpy(), steps)
    *tols, _ = vjp_tolerance(x, y, it, s, c, mode, delta, top_two_gap(x, y, it, s),
                             2.0 * gram_rounding(2.0 * max(csq, ysq), D, steps),
                             gram_rounding(2.0 * max(xsq, ysq), D, steps))
    for a, b, t in zip(got, want, tols):
        diff = (a.double() - b.double()).abs()
        assert bool(torch.isfinite(a).all())
        assert bool((diff <= t).all()), float((diff / t).max())


@pytest.mark.cuda
def test_denoiser_gradient_on_card_matches_cpu(cuda_device):
    rng = np.random.RandomState(1)
    data = rng.randn(500, 3).astype(np.float32)
    xt = rng.randn(16, 3).astype(np.float32)
    lt = np.linspace(np.log(1e-2), np.log(10.0), 16).astype(np.float32)
    cot = rng.randn(16, 3).astype(np.float32)
    grads = {}
    for where in ("cpu", cuda_device):
        x = torch.tensor(xt, device=where, requires_grad=True)
        t = torch.tensor(lt, device=where, requires_grad=True)
        mean = bz.true_posterior_mean_x0(x, t, torch.tensor(data, device=where))
        torch.sum(mean * torch.tensor(cot, device=where)).backward()
        grads[str(where)] = (x.grad.cpu(), t.grad.cpu())
    for got, want in zip(grads[str(cuda_device)], grads["cpu"]):
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=2e-3 * float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("step_type", STEP_TYPES)
def test_schedule_gradient_on_card_matches_cpu(cuda_device, step_type):
    N, n_steps, B = GMM_GRAD
    data = generate_gmm_1d(N)
    sched = LogSNRScheduler(1e-4, 1e1)
    grid = discretize_schedule(sched, n_steps)
    rng = np.random.RandomState(19)
    x_init = torch.from_numpy(rng.standard_normal((B, 1, 1, 1)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((n_steps, B, 1, 1, 1)).astype(np.float32))
    outs = {}
    for where in ("cpu", cuda_device):
        model = TrueDDPM(sched, data, device=where)
        lt = grid.to(where).clone().requires_grad_(True)
        bz.posterior_mean_vjp.launches = 0
        x = sample_with_grid(model, lt, None, (B, 1, 1, 1), step_type,
                             x_init=x_init, noise=noise)
        (gk,) = torch.autograd.grad(torch.mean(torch.square(x)), [lt])
        outs[str(where)] = (x.detach().cpu(), gk.cpu(), bz.posterior_mean_vjp.launches)
    x_c, g_c, _ = outs["cpu"]
    x_d, g_d, launches = outs[str(cuda_device)]
    evals = 2 * n_steps - 1 if step_type == "heun" else n_steps
    assert launches == 2 * evals
    torch.testing.assert_close(x_d, x_c, rtol=0,
                               atol=GMM_GRAD_TOL[0] * float(x_c.abs().max()))
    torch.testing.assert_close(g_d, g_c, rtol=0,
                               atol=GMM_GRAD_TOL[1] * float(g_c.abs().max()))


@pytest.mark.cuda
def test_mean_under_grad_refuses_another_payload_on_card(cuda_device):
    y = torch.randn(300, 4, device=cuda_device)
    prep = sw.prepare_y(y, "fp32")
    x = torch.randn(8, 4, device=cuda_device, requires_grad=True)
    with pytest.raises(ValueError, match="ROADMAP.md"):
        bz.true_posterior_mean_x0(x, torch.zeros(8, device=cuda_device), prep,
                                  values=torch.randn(300, 2, device=cuda_device))
