"""The XLA ChEES kernel (``chees.new_kernel``) against the JAX package's, and
on kernel 8's binding.

The JAX kernel draws its momenta and accept uniforms from split keys; the
port is fed the same draws as an external ``(z, u)`` pair.  Float64 on both
sides: the autograd leapfrog to 1e-12 relative, the trajectory through
``ops.logistic_integrate_fn`` (kernel 8; its plain version on the CPU,
whose gradient is the analytic ``Xᵀ(σ(Xq) − y) + q``, not autograd) to
1e-10, both to 1e-8 on a diverging trajectory (ε 5, positions 1e6), accept
decisions equal.  A seeded step is the external step fed ``ghmc_streams``
of its seed, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aehmc_tpu import chees as jchees
from aehmc_tpu import hmc as jhmc
from aehmc_tpu_torch import chees, hmc, ops
from aehmc_tpu_torch.ops.philox import ghmc_streams
from aehmc_tpu_torch.parallel import sample_sharded

CHAINS, DIM, POINTS = 12, 4, 30


def _data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(POINTS, DIM)) / np.sqrt(DIM)
    y = (rng.uniform(size=POINTS) < 0.5).astype(np.float64)
    return X, y


def _logprob(X, y, lib):
    if lib is jnp:
        Xj, yj = jnp.asarray(X), jnp.asarray(y)

        def logprob_fn(w):
            logits = Xj @ w
            return (jnp.sum(yj * logits - jax.nn.softplus(logits))
                    - 0.5 * jnp.sum(w * w))
    else:
        Xt, yt = torch.tensor(X), torch.tensor(y)

        def logprob_fn(w):
            logits = Xt @ w
            return (torch.sum(yt * logits
                              - torch.nn.functional.softplus(logits))
                    - 0.5 * torch.sum(w * w))
    return logprob_fn


def _jax_draws(key, dim):
    momentum_key, accept_key = jax.random.split(key)
    z = jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float64))(
        jax.random.split(momentum_key, CHAINS))
    u = jax.random.uniform(accept_key, (CHAINS,), jnp.float64)
    return np.array(z), np.array(u)


def _compare(jout, tout, rtol):
    (js, ji), (ts, ti) = jout, tout
    for a, b in zip(js, ts):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=rtol)
    for name in ("acceptance_probability", "proposed_position",
                 "proposed_velocity", "energy"):
        np.testing.assert_allclose(getattr(ti, name).numpy(),
                                   np.asarray(getattr(ji, name)), rtol=rtol)
    np.testing.assert_array_equal(ti.is_diverging.numpy(),
                                  np.asarray(ji.is_diverging))
    assert int(ti.num_integration_steps) == int(ji.num_integration_steps)


@pytest.mark.parametrize("eps, steps", [(0.2, 7), (0.6, 3), (5.0, 4)])
def test_chees_kernel_matches_jax(eps, steps):
    X, y = _data()
    jlp, tlp = _logprob(X, y, jnp), _logprob(X, y, torch)
    rng = np.random.default_rng(1)
    q = rng.normal(size=(CHAINS, DIM))
    imm = rng.uniform(0.5, 2.0, DIM)
    key = jax.random.PRNGKey(7)
    jstates = jax.vmap(lambda x: jhmc.new_state(x, jlp))(jnp.asarray(q))
    jout = jchees.new_kernel(jlp)(key, jstates, eps,
                                  jnp.asarray(steps, jnp.int32),
                                  jnp.asarray(imm))
    z, u = _jax_draws(key, DIM)
    tstates = hmc.new_state(torch.tensor(q), tlp)
    steps_t = torch.tensor(steps, dtype=torch.int32)
    autograd = chees.new_kernel(tlp)((z, u), tstates, eps, steps_t,
                                     torch.tensor(imm))
    # a diverging trajectory (ε 5) amplifies last-bit differences to 1e-10
    _compare(jout, autograd, 1e-12 if eps < 1 else 1e-8)
    fused = chees.new_kernel(
        tlp, integrate_fn=ops.logistic_integrate_fn(torch.tensor(X),
                                                    torch.tensor(y)))(
        (z, u), tstates, eps, steps_t, torch.tensor(imm))
    _compare(jout, fused, 1e-10 if eps < 1 else 1e-8)
    accept = autograd[1].acceptance_probability
    if eps < 1:
        assert bool((accept < 1).any()) and bool((accept > 0.2).all())
    else:
        assert bool(autograd[1].is_diverging.any())


def test_seeded_chees_step_is_the_external_step_fed_its_streams():
    X, y = _data()
    tlp = _logprob(X, y, torch)
    q = torch.tensor(np.random.default_rng(2).normal(size=(CHAINS, DIM)))
    states = hmc.new_state(q, tlp)
    kernel = chees.new_kernel(tlp)
    imm = torch.ones(DIM, dtype=torch.float64)
    z, u = ghmc_streams(99, CHAINS, DIM)
    seeded = kernel(99, states, 0.3, 5, imm)
    external = kernel((z.T.double(), u[0].double()), states, 0.3, 5, imm)
    for a, b in zip(seeded[0] + seeded[1], external[0] + external[1]):
        assert torch.equal(a, b)


def test_kernel8_binding_drives_the_pooled_chees_route():
    """``sample_sharded(algorithm="chees")`` on the kernel-8 binding runs
    (its plain version here) and follows the autograd kernel's run: the same
    randomness and trip counts, trajectories 1e-15 apart a step, which the
    adaptation amplifies about 1.8 times a step (ROADMAP.md §3, fault 3),
    so positions agree to 1e-5 after 30 + 15 steps."""
    X, y = _data()
    tlp = _logprob(X, y, torch)
    q0 = 0.1 * torch.tensor(np.random.default_rng(3).normal(
        size=(CHAINS, DIM)))
    binding = chees.new_kernel(tlp, integrate_fn=ops.logistic_integrate_fn(
        torch.tensor(X), torch.tensor(y)))

    def run(kernel_fn):
        return sample_sharded(torch.Generator().manual_seed(5), tlp, q0, 15,
                              30, algorithm="chees", initial_step_size=0.05,
                              chees_kernel_fn=kernel_fn)

    fused, plain = run(binding), run(None)
    assert fused.positions.shape == (15, CHAINS, DIM)
    assert fused.positions.dtype == torch.float64
    np.testing.assert_allclose(fused.positions.numpy(),
                               plain.positions.numpy(), rtol=1e-5, atol=1e-5)
    assert torch.equal(fused.diagnostics.num_integration_steps,
                       plain.diagnostics.num_integration_steps)
