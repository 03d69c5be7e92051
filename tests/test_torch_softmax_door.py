"""R1 ``softmax_reg`` (a multinomial logistic regression written the usual
way: ``max(dim=1)``, integer arithmetic on its 1-based labels, two index
tensors) through the port's fused NUTS front door against the JAX
package's, on the CPU at a small size."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import aehmc_tpu_torch
from tests.test_torch_generic_ops import (
    F32,
    jax_softmax_reg,
    softmax_data,
    softmax_reg,
)


def _chain_mcse(x):
    """Each coordinate's mean and its MCSE from the chain means: ``x``
    ``(chains, draws, dim)``."""
    means = x.mean(1)
    return means.mean(0), means.std(0, ddof=1) / np.sqrt(x.shape[0])


def test_front_door_runs_softmax_reg_as_the_jax_package_does():
    """R1 (30 points, 3 features, 4 classes, dim 12) through the port's
    fused NUTS door and the JAX package's (``path="fused"``, its fused
    kernels in interpret mode, on ``jax.random`` streams, in 32-bit mode:
    its kernels' PRNG words are int32) from one start: finite draws and
    each coordinate's mean within 4.5 combined MCSE of the JAX run's."""
    import aehmc_tpu

    X, y = softmax_data(30, 3, 4, seed=3)
    chains, warmup, draws = 16, 30, 30
    q0 = (0.1 * np.random.default_rng(7).standard_normal((chains, 12))
          ).astype(F32)

    a = aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(3), softmax_reg(X, y, 4),
        torch.tensor(q0), draws, warmup, algorithm="nuts", path="fused",
        max_num_expansions=4)
    x64 = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    try:
        ref = aehmc_tpu.sample(jax.random.PRNGKey(3),
                               jax_softmax_reg(X, y, 4, jnp.float32),
                               jnp.asarray(q0), draws, warmup,
                               algorithm="nuts", path="fused",
                               max_num_expansions=4, interpret=True,
                               use_internal_prng=False, loop_in_kernel=False)
        jaxp = np.asarray(ref.positions)
    finally:
        jax.config.update("jax_enable_x64", x64)
    port = a.positions.numpy()
    if jaxp.shape[0] != chains:  # (draws, chains, dim)
        jaxp = np.swapaxes(jaxp, 0, 1)
    if port.shape[0] != chains:
        port = np.swapaxes(port, 0, 1)
    assert np.isfinite(port).all() and np.isfinite(jaxp).all()
    (m1, s1), (m2, s2) = _chain_mcse(port), _chain_mcse(jaxp)
    z = np.abs(m1 - m2) / np.sqrt(s1 ** 2 + s2 ** 2)
    assert z.max() < 4.5, z
