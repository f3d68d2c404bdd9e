"""Matrix square roots for the Frechet distance.

Counterpart of ``pdm_tpu/ops/sqrtm.py``. :func:`trace_sqrtm_product` (the
FID path) uses the symmetric-eigh form, exact on rank-deficient
covariances (see its docstring); :func:`sqrtm_newton_schulz` is the
coupled Newton-Schulz iteration for the full square root of a
well-conditioned SPD matrix:

    Y_0 = A / ||A||_F,  Z_0 = I
    Y_{k+1} = 0.5 Y_k (3I - Z_k Y_k)
    Z_{k+1} = 0.5 (3I - Z_k Y_k) Z_k
    sqrtm(A) = Y_K * sqrt(||A||_F)

Newton-Schulz runs in fp32 with TF32 off (``precision.full_fp32_matmul``):
at TF32's 10-bit products the coupled iteration loses the small
eigenvalues. The eigh form runs in float64 (see its docstring).
"""

from __future__ import annotations

import torch
from torch import Tensor

from .precision import full_fp32_matmul


def sqrtm_newton_schulz(a: Tensor, num_iters: int = 20,
                        eps: float = 1e-10) -> Tensor:
    a = a.float()
    dim = a.shape[0]
    norm = torch.sqrt(torch.sum(a * a)) + eps
    y = a / norm
    z = torch.eye(dim, dtype=torch.float32, device=a.device)
    eye3 = 3.0 * z
    with full_fp32_matmul():
        for _ in range(num_iters):
            t = 0.5 * (eye3 - z @ y)
            y, z = y @ t, t @ z
    return y * torch.sqrt(norm)


def _above_rounding(ev: Tensor) -> Tensor:
    """Eigenvalues of a PSD matrix with those at or below its float64
    rounding level (F eps max|ev|, numpy's matrix_rank tolerance) set to
    0: the null space's eigenvalues come out as +-1e-14-ish noise, and
    their square roots would add up to a bias of the trace."""
    tol = ev.shape[-1] * torch.finfo(ev.dtype).eps * ev.abs().max()
    return torch.where(ev > tol, ev, torch.zeros_like(ev))


def trace_sqrtm_product(sigma1: Tensor, sigma2: Tensor) -> Tensor:
    """tr(sqrtm(Sigma1 @ Sigma2)) via the symmetric reformulation, fp32 out.

    Sigma1 = V diag(w) V^T (eigh), S = sqrt(Sigma1) symmetric; Sigma1
    Sigma2 shares its nonzero spectrum with the symmetric PSD S Sigma2 S,
    so

        tr sqrtm(Sigma1 Sigma2) = sum sqrt(eigvalsh(S Sigma2 S))

    with no jitter: zero eigenvalues contribute zero, so the Frechet
    distance of valid moments is not biased low at any sample count (a
    jittered Newton-Schulz on the product turned each zero eigenvalue into
    sqrt(eps) and drove FID negative at 64 samples of 2048 features).

    The decompositions and products run in float64 on the tensors' device,
    and eigenvalues at the rounding level are zeroed (``_above_rounding``).
    In fp32, as the JAX version runs them, a rank-deficient covariance's
    null eigenvalues come out at ~1e-7 of the largest, and the square
    roots of those that round positive sum to a bias: the FID of 24
    samples of 256 features with themselves is -0.59 in JAX's fp32 and
    0 within 1e-6 here (tests/test_torch_fid.py)."""
    sigma1 = sigma1.double()
    sigma2 = sigma2.double()
    w, v = torch.linalg.eigh(sigma1)
    s_half = (v * torch.sqrt(_above_rounding(w))[None, :]) @ v.T
    m = (s_half @ sigma2) @ s_half
    m = 0.5 * (m + m.T)
    ev = _above_rounding(torch.linalg.eigvalsh(m))
    return torch.sum(torch.sqrt(ev)).float()
