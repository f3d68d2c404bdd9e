"""Fixtures and helpers shared by the port's CPU tests (tests/test_torch_*.py).

A test module takes one by importing it by name, e.g.
``from torch_port_fixtures import two_torch_threads  # noqa: F401``.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    """The suite runs several workers on one machine; torch's default of
    one thread per core oversubscribes it and slows every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def jax_sampler_draws(key, n_steps, shape):
    """The JAX sampler's own draws for one batch (sampling.py: split for
    the initial noise, then fold_in(key, i) per step), as numpy."""
    import jax
    import jax.numpy as jnp

    key, init_key = jax.random.split(key)
    x_init = jax.random.normal(init_key, shape, dtype=jnp.float32)
    noise = jnp.stack([
        jax.random.normal(jax.random.fold_in(key, i), shape, dtype=jnp.float32)
        for i in range(n_steps)
    ])
    return np.array(x_init), np.array(noise)
