"""The port's leapfrog entry points (aehmc_tpu_torch.ops.leapfrog and
ops.fused_hmc, kernels 9 and 8) in plain form against the JAX package's lax
oracles and its interpret-mode Pallas kernels, on the same numpy inputs.

``batched_leapfrog`` equals the lax oracle bit for bit when the oracle runs
op by op (``jax.disable_jit``), every product and sum rounded on its own as
the port and its CUDA kernel round them.  Compiled, XLA on the CPU contracts
multiply-adds into fused ones, so the interpret-mode Pallas kernel is held to
1e-6 (the JAX suite's own tolerance between that kernel and its oracle).
``fused_logistic_hmc`` agrees to rtol 1e-5: its data products are float32
sums taken in another order.  The CUDA kernels' tests are in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu.ops.fused_hmc import fused_logistic_hmc_reference as jax_hmc_ref
from aehmc_tpu.ops.fused_hmc import fused_logistic_hmc_tpu
from aehmc_tpu.ops.leapfrog import batched_leapfrog_reference as jax_lf_ref
from aehmc_tpu.ops.leapfrog import batched_leapfrog_tpu
from aehmc_tpu_torch import ops
from aehmc_tpu_torch.ops.fused_hmc import fused_logistic_hmc_reference
from aehmc_tpu_torch.ops.leapfrog import batched_leapfrog_reference

F32 = np.float32


def _leapfrog_inputs(chains, dim, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(chains, dim)).astype(F32)
    p = rng.normal(size=(chains, dim)).astype(F32)
    lam = np.linspace(0.5, 2.0, dim).astype(F32)
    im = np.linspace(0.8, 1.2, dim).astype(F32)
    return q, p, lam, im


@pytest.mark.parametrize("chains", [16, 7])
@pytest.mark.parametrize("num_steps", [1, 7])
def test_batched_leapfrog_matches_jax(chains, num_steps):
    """7 chains do not divide the Pallas block of 4 (the JAX wrapper then
    falls back to its oracle; the CUDA kernel masks the edge itself)."""
    q, p, lam, im = _leapfrog_inputs(chains, 8)
    eps = jnp.asarray(0.05, jnp.float32)
    jargs = [jnp.asarray(a) for a in (q, p, lam, im)]
    with jax.disable_jit():
        q_ref, p_ref = jax_lf_ref(*jargs, eps, num_steps)
    q_pl, p_pl = batched_leapfrog_tpu(*jargs, eps, num_steps, block_chains=4,
                                      interpret=True)
    targs = [torch.tensor(a) for a in (q, p, lam, im)]
    q_t, p_t = ops.batched_leapfrog(*targs, 0.05, num_steps)
    assert torch.equal(q_t, batched_leapfrog_reference(*targs, 0.05,
                                                       num_steps)[0])
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_ref))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_ref))
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_pl), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_pl), rtol=1e-6,
                               atol=1e-6)


def test_batched_leapfrog_equals_float32_numpy_steps():
    """Each step rounds every product and sum on its own (numpy float32)."""
    q, p, lam, im = _leapfrog_inputs(5, 6, seed=3)
    eps = F32(0.1)
    half = F32(0.5) * eps
    qn, pn = q.copy(), p.copy()
    for _ in range(4):
        ph = pn - half * (lam * qn)
        qn = qn + eps * (im * ph)
        pn = ph - half * (lam * qn)
    q_t, p_t = ops.batched_leapfrog(*(torch.tensor(a) for a in (q, p, lam, im)),
                                    0.1, 4)
    np.testing.assert_array_equal(q_t.numpy(), qn)
    np.testing.assert_array_equal(p_t.numpy(), pn)


def _logistic_inputs(chains, seed=7):
    rng = np.random.default_rng(seed)
    dim, points = 8, 32
    X = (rng.normal(size=(points, dim)) / np.sqrt(dim)).astype(F32)
    y = (rng.uniform(size=points) < 0.5).astype(F32)
    q = rng.normal(size=(chains, dim)).astype(F32)
    p = rng.normal(size=(chains, dim)).astype(F32)
    im = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    return q, p, X, y, im


@pytest.mark.parametrize("chains, prior_precision", [(8, 1.0), (7, 2.5)])
def test_fused_logistic_hmc_matches_jax(chains, prior_precision):
    q, p, X, y, im = _logistic_inputs(chains)
    num_steps, eps = 5, 0.05
    jargs = [jnp.asarray(a) for a in (q, p, X, y, im)]
    q_ref, p_ref = jax_hmc_ref(*jargs, jnp.asarray(eps, jnp.float32),
                               num_steps, prior_precision)
    q_pl, p_pl = fused_logistic_hmc_tpu(*jargs, jnp.asarray(eps, jnp.float32),
                                        num_steps, prior_precision,
                                        block_chains=4, interpret=True)
    targs = [torch.tensor(a) for a in (q, p, X, y, im)]
    q_t, p_t = ops.fused_logistic_hmc(*targs, eps, num_steps, prior_precision)
    for t, j in ((q_t, q_ref), (p_t, p_ref), (q_t, q_pl), (p_t, p_pl)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)
    q_r, _ = fused_logistic_hmc_reference(*targs, eps, num_steps,
                                          prior_precision)
    assert torch.equal(q_t, q_r)


def test_fused_logistic_hmc_zero_steps_is_the_identity():
    q, p, X, y, im = _logistic_inputs(3)
    targs = [torch.tensor(a) for a in (q, p, X, y, im)]
    q_t, p_t = ops.fused_logistic_hmc(*targs, 0.1, 0)
    assert torch.equal(q_t, targs[0]) and torch.equal(p_t, targs[1])
