"""pdm_tpu_torch — the PyTorch/CUDA port of pdm_tpu for NVIDIA Hopper.

The package mirrors ``pdm_tpu``'s layout (``config/``, ``core/``,
``schedulers/``, ``models/``, ``ops/``, ``diffusion/``, ``stats/``,
``runtime/``, ``utils/``, and ``scripts/`` for the JAX ``scripts/``) so
each module's counterpart is found by path. It imports torch and numpy (and scipy in ``stats/hypersphere.py``); the
JAX package is the reference the port is tested against, never a
dependency, and neither pydantic, PyYAML, PIL nor safetensors is needed
(``config/`` reads its YAML files itself, ``utils/logging.py`` writes its
PNGs, ``models/diffusers_import.py`` reads and writes safetensors). The config path of the JAX scripts runs as
``load_config`` -> ``ddpm_from_config`` -> ``get_data_tensor`` (or a
host-resident dataset) -> ``DDPMTrainer``; the JAX scripts' entry points
are ``pdm_tpu_torch.scripts`` (``compute_stats_forward`` ->
``train_diffusion`` -> ``sample`` -> ``compute_fid``, FID from
``utils/fid.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device and without that argument they raise. The UNet's
spatial attention and GroupNorm(+SiLU), forward and backward, the fused
multi-temperature Boltzmann sweep and the single-temperature Boltzmann
moments (the analytic denoiser's op) run through hand-written CUDA
kernels (``csrc/``) built at first use; on CPU tensors the same wrappers
run their plain PyTorch versions.
"""

__version__ = "0.1.0"
