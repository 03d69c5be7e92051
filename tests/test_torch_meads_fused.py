"""The port's fused MEADS adapters (``make_fused_meads_transition``,
``make_fused_meads_segment`` of aehmc_tpu_torch.ops.ghmc_fused) through the
plain versions of kernels 5 and 6.

- Against the JAX adapters in interpret mode with
  ``use_internal_prng=False``: the port is fed the normals and uniforms the
  JAX adapter draws from its key.  Accept decisions and divergence flags are
  equal; positions, potentials, gradients, momenta and energies agree to
  1e-5 relative (float32, sums in another order).
- Under Philox randomness the fused transition with seed ``s`` makes the
  decisions of the XLA fold transition (``torch.func`` gradients) under
  ``Key(s)``; an n-draw segment equals n transitions with the per-draw
  seeds ``s + t·DRAW_SEED_STRIDE``, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu import meads as jax_meads
from aehmc_tpu.models import logistic_regression_pg_t as jax_pg_builder
from aehmc_tpu.ops import ghmc_fused as jax_ghmc
from aehmc_tpu.types import IntegratorState as JaxState
from aehmc_tpu_torch import keys, meads
from aehmc_tpu_torch.models import logistic_regression, logistic_regression_pg_t
from aehmc_tpu_torch.ops.ghmc_fused import (
    make_fused_meads_segment,
    make_fused_meads_transition,
)
from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
from aehmc_tpu_torch.ops.philox import MASK32
from aehmc_tpu_torch.parallel import make_mesh
from aehmc_tpu_torch.types import IntegratorState

F32 = np.float32
DIM, POINTS, FOLDS, PER_FOLD = 6, 48, 4, 4
CHAINS = FOLDS * PER_FOLD
TOL = dict(rtol=1e-5, atol=1e-5)


def _models():
    _, pg_j, data_j, _ = jax_pg_builder(dim=DIM, num_points=POINTS,
                                        matmul_dtype=jnp.float32)
    _, pg_t, data_t, _ = logistic_regression_pg_t(dim=DIM, num_points=POINTS,
                                                  matmul_dtype=torch.float32,
                                                  device="cpu")
    return pg_j, data_j, pg_t, data_t


def _inputs(pg_t, data_t, seed=0):
    """Folded float32 states (numpy) with their potential and gradient, and
    per-fold hyperparameters."""
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.normal(size=(CHAINS, DIM))).astype(F32)
    p = rng.normal(size=(CHAINS, DIM)).astype(F32)
    u, g_t = pg_t(torch.tensor(q).T, *data_t)
    state = [q, p, u.reshape(-1).numpy(), g_t.T.numpy()]
    hyper = [rng.uniform(0.1, 0.4, size=FOLDS).astype(F32),
             rng.uniform(0.5, 0.95, size=FOLDS).astype(F32),
             rng.uniform(0.5, 1.5, size=(FOLDS, DIM)).astype(F32)]
    hyper[0][3] = 3.0  # one fold at a step that rejects and diverges

    def fold(a):
        return a.reshape((FOLDS, PER_FOLD) + a.shape[1:])

    jax_in = (JaxState(*(jnp.asarray(fold(a)) for a in state)),
              jax_meads.MeadsHyperparams(*(jnp.asarray(h) for h in hyper)))
    port_in = (IntegratorState(*(torch.tensor(fold(a)) for a in state)),
               meads.MeadsHyperparams(*(torch.tensor(h) for h in hyper)))
    return jax_in, port_in


def _jax_streams(key, shape):
    """The adapters' ``use_internal_prng=False`` draws from ``key``."""
    noise_key, accept_key = jax.random.split(key)
    z = jax.random.normal(noise_key, shape + (DIM,), jnp.float32)
    u = jax.random.uniform(accept_key, shape, jnp.float32)
    return torch.tensor(np.asarray(z)), torch.tensor(np.asarray(u))


def _assert_agree(port_states, port_info, ref_states, ref_info, q0):
    moved = np.any(port_states.position.numpy() != q0, axis=-1)
    moved_ref = np.any(np.asarray(ref_states.position) != q0, axis=-1)
    np.testing.assert_array_equal(moved, moved_ref)
    np.testing.assert_array_equal(port_info.is_diverging.numpy(),
                                  np.asarray(ref_info.is_diverging))
    np.testing.assert_array_equal(port_info.num_integration_steps.numpy(),
                                  np.asarray(ref_info.num_integration_steps))
    for a, b in zip(port_states, ref_states):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    for name in ("acceptance_probability", "energy"):
        np.testing.assert_allclose(getattr(port_info, name).numpy(),
                                   np.asarray(getattr(ref_info, name)), **TOL)
    return moved


def test_transition_matches_jax():
    pg_j, data_j, pg_t, data_t = _models()
    (js, jh), (ts, th) = _inputs(pg_t, data_t)
    key = jax.random.PRNGKey(3)
    ref = jax_ghmc.make_fused_meads_transition(
        None, list(data_j), block_chains=8, interpret=True,
        potential_and_grad_t=pg_j, use_internal_prng=False)(key, js, jh)
    z, u = _jax_streams(key, (CHAINS,))
    out = make_fused_meads_transition(
        None, data_t, potential_and_grad_t=pg_t,
        use_internal_prng=False)((z, u), ts, th)
    assert out[0].position.shape == (FOLDS, PER_FOLD, DIM)
    assert out[1].acceptance_probability.shape == (FOLDS, PER_FOLD)
    moved = _assert_agree(*out, *ref, ts.position.numpy())
    assert moved.any() and not moved.all()
    assert bool(out[1].is_diverging.any())


def test_segment_matches_jax():
    pg_j, data_j, pg_t, data_t = _models()
    (js, jh), (ts, th) = _inputs(pg_t, data_t, seed=1)
    key = jax.random.PRNGKey(4)
    ref_states, (ref_pos, ref_info) = jax_ghmc.make_fused_meads_segment(
        None, list(data_j), block_chains=8, interpret=True,
        potential_and_grad_t=pg_j, use_internal_prng=False)(key, js, jh, 4)
    z, u = _jax_streams(key, (4, CHAINS))
    states, (pos, info) = make_fused_meads_segment(
        None, data_t, potential_and_grad_t=pg_t,
        use_internal_prng=False)((z, u), ts, th, 4)
    assert pos.shape == (4, FOLDS, PER_FOLD, DIM)
    assert info.acceptance_probability.shape == (4, FOLDS, PER_FOLD)
    np.testing.assert_array_equal(info.is_diverging.numpy(),
                                  np.asarray(ref_info.is_diverging))
    np.testing.assert_allclose(pos.numpy(), np.asarray(ref_pos), **TOL)
    for a, b in zip(states, ref_states):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    np.testing.assert_allclose(info.energy.numpy(), np.asarray(ref_info.energy),
                               **TOL)


def test_philox_transition_makes_the_xla_fold_transitions_decisions():
    _, _, pg_t, data_t = _models()
    _, (ts, th) = _inputs(pg_t, data_t, seed=2)
    logprob_fn, _ = logistic_regression(DIM, POINTS, device="cpu")
    seed = 1234
    xla_states, xla_info = meads._make_fold_transition(logprob_fn)(
        keys.Key(seed), ts, th)
    for internal in (True, False):
        states, info = make_fused_meads_transition(
            None, data_t, potential_and_grad_t=pg_t,
            use_internal_prng=internal)(seed, ts, th)
        q0 = ts.position.numpy()
        np.testing.assert_array_equal(
            np.any(states.position.numpy() != q0, axis=-1),
            np.any(xla_states.position.numpy() != q0, axis=-1))
        np.testing.assert_array_equal(info.is_diverging.numpy(),
                                      xla_info.is_diverging.numpy())
        np.testing.assert_allclose(states.position.numpy(),
                                   xla_states.position.numpy(), **TOL)


@pytest.mark.parametrize("internal", [True, False])
def test_segment_equals_transitions_bit_for_bit(internal):
    _, _, pg_t, data_t = _models()
    _, (ts, th) = _inputs(pg_t, data_t, seed=3)
    seed = 987654
    kw = dict(potential_and_grad_t=pg_t, use_internal_prng=internal)
    seg_states, (pos, info) = make_fused_meads_segment(None, data_t, **kw)(
        seed, ts, th, 5)
    transition = make_fused_meads_transition(None, data_t, **kw)
    states = ts
    for t in range(5):
        states, step_info = transition(
            keys.Key((seed + t * DRAW_SEED_STRIDE) & MASK32), states, th)
        assert torch.equal(pos[t], states.position)
        for a, b in zip(step_info, info):
            assert torch.equal(a, b[t])
    for a, b in zip(seg_states, states):
        assert torch.equal(a, b)


def test_mesh_raises_naming_its_item():
    """A mesh shards the MEADS transition, which then needs the total
    chain count (the JAX adapter's error); the segment kernel has no shard
    adapter, in the JAX package either."""
    mesh = make_mesh(devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="needs num_chains"):
        make_fused_meads_transition(None, (), mesh=mesh)
    assert make_fused_meads_transition(None, (), mesh=mesh,
                                       num_chains=8).mesh is mesh
    with pytest.raises(ValueError, match="no shard adapter"):
        make_fused_meads_segment(None, (), mesh=mesh)
