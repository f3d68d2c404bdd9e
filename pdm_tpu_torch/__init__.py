"""pdm_tpu_torch — the PyTorch/CUDA port of pdm_tpu for NVIDIA Hopper.

The package mirrors ``pdm_tpu``'s layout (``core/``, ``schedulers/``,
``models/``, ``ops/``, ``diffusion/``, ``stats/``, ``utils/``) so each
module's counterpart is found by path. It imports torch and numpy only;
the JAX package is the reference the port is tested against, never a
dependency.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without that argument they raise. The UNet's
spatial attention and GroupNorm(+SiLU), forward and backward, the fused
multi-temperature Boltzmann sweep and the single-temperature Boltzmann
moments (the analytic denoiser's op) run through hand-written CUDA
kernels (``csrc/``) built at first use; on CPU tensors the same wrappers
run their plain PyTorch versions.
"""

__version__ = "0.1.0"
