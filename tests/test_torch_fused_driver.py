"""The port's fused warmup and driver (aehmc_tpu_torch.ops.fused_driver)
against the JAX package's ``warmup_fused`` with an interpret-mode kernel.

Both runs start from the same state and take the same randomness: the port
is fed the raw normal and uniform streams that ``_external_randomness``
draws from the keys ``warmup_fused_hooks.init`` derives.  Decisions of every
warmup transition are exactly equal; the tuned ε, M⁻¹ and final positions
agree to rtol 1e-4 (float32 chains, reductions in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu.models import logistic_regression_pg_t as jax_pg_builder
from aehmc_tpu.ops.fused_driver import _mass_sqrt as jax_mass_sqrt
from aehmc_tpu.ops.fused_driver import warmup_fused as jax_warmup_fused
from aehmc_tpu.ops.nuts_fused_small import (
    make_fused_nuts_transition_small as jax_transition,
)
from aehmc_tpu_torch.models import logistic_regression_pg_t
from aehmc_tpu_torch.ops.fused_driver import (
    _external_randomness,
    _mass_sqrt,
    sample_fused_adaptive,
    warmup_fused,
)
from aehmc_tpu_torch.ops.nuts_fused_small import make_fused_nuts_transition_small

F32 = np.float32
DIM, POINTS, CHAINS, MAX_EXP, STEPS = 6, 48, 16, 4, 30


def _jax_streams(key, num_steps, chains, dim, max_exp):
    """The raw streams of ``_external_randomness`` for every warmup step,
    from the keys ``warmup_fused_hooks.init`` derives from ``key``."""
    _, key_scan = jax.random.split(key)
    keys = jax.random.split(key_scan, num_steps)
    out = []
    for t in range(num_steps):
        k1, k2, k3, k4 = jax.random.split(keys[t], 4)
        z = jax.random.normal(k1, (chains, dim), jnp.float32)
        dirs = jnp.where(jax.random.uniform(k2, (chains, max_exp)) < 0.5,
                         -1.0, 1.0)
        ub = jax.random.uniform(k3, (chains, max_exp))
        ul = jax.random.uniform(k4, (chains, 2**max_exp))
        out.append(tuple(np.array(a, F32) for a in (z, dirs, ub, ul)))
    return out


@pytest.mark.parametrize("dense", [False, True])
def test_warmup_matches_jax_warmup_fused(dense):
    _, pg_j, data_j, _ = jax_pg_builder(dim=DIM, num_points=POINTS,
                                        matmul_dtype=jnp.float32)
    _, pg_t, data_t, _ = logistic_regression_pg_t(dim=DIM, num_points=POINTS)
    q0 = (0.1 * np.random.default_rng(0).normal(size=(CHAINS, DIM))).astype(F32)
    u0, g0 = pg_t(torch.tensor(q0).T.contiguous(), *data_t)
    u0, g0 = u0.T.contiguous(), g0.T.contiguous()
    key = jax.random.PRNGKey(7)
    common = dict(max_num_expansions=MAX_EXP, is_mass_matrix_full=dense,
                  initial_step_size=0.1, use_internal_prng=False)

    jax_stats = []
    jt = jax_transition(
        lambda q_t, *d: pg_j(q_t, *d)[0], list(data_j),
        max_num_expansions=MAX_EXP, block_chains=CHAINS, interpret=True,
        potential_and_grad_t=pg_j,
    )

    def jax_recording(*args, **kwargs):
        out = jt(*args, **kwargs)
        jax.debug.callback(lambda s: jax_stats.append(np.asarray(s)), out[3],
                           ordered=True)
        return out

    (qj, _, _), eps_j, imm_j = jax_warmup_fused(
        key, jax_recording, jnp.asarray(q0), jnp.asarray(u0.numpy()),
        jnp.asarray(g0.numpy()), STEPS, **common,
    )
    eps_j, imm_j, qj = float(eps_j), np.asarray(imm_j), np.asarray(qj)

    streams = _jax_streams(key, STEPS, CHAINS, DIM, MAX_EXP)
    port_stats = []
    pt = make_fused_nuts_transition_small(
        None, data_t, max_num_expansions=MAX_EXP, potential_and_grad_t=pg_t,
        transposed_io=True,
    )

    def port_recording(*args, **kwargs):
        out = pt(*args, **kwargs)
        port_stats.append(out[3].T.numpy())
        return out

    (qt, _, _), eps_t, imm_t = warmup_fused(
        None, port_recording, torch.tensor(q0), u0, g0, STEPS,
        streams=lambda t: streams[t], **common,
    )
    assert len(port_stats) == len(jax_stats) == STEPS
    np.testing.assert_array_equal(np.stack(port_stats)[..., 2:6],
                                  np.stack(jax_stats)[..., 2:6])
    np.testing.assert_allclose(float(eps_t), eps_j, rtol=1e-4)
    # off-diagonal covariances near 0 are held to 1e-4 of the matrix's scale
    np.testing.assert_allclose(imm_t.numpy(), imm_j, rtol=1e-4,
                               atol=1e-4 * np.abs(imm_j).max())
    # positions are O(1): 1e-4 of that scale also bounds elements near 0
    np.testing.assert_allclose(qt.numpy(), qj, rtol=1e-4, atol=1e-4)
    assert imm_t.shape == ((DIM, DIM) if dense else (DIM,))


@pytest.mark.parametrize("dense", [False, True])
def test_mass_sqrt_and_external_momentum_match_jax(dense):
    rng = np.random.default_rng(2)
    if dense:
        A = rng.normal(size=(DIM, DIM))
        imm = (A @ A.T / DIM + np.eye(DIM)).astype(F32)
    else:
        imm = rng.uniform(0.3, 2.0, size=DIM).astype(F32)
    np.testing.assert_allclose(_mass_sqrt(torch.tensor(imm)).numpy(),
                               np.asarray(jax_mass_sqrt(jnp.asarray(imm))),
                               rtol=1e-5, atol=1e-6)
    raw = (rng.normal(size=(CHAINS, DIM)).astype(F32),
           np.ones((CHAINS, MAX_EXP), F32),
           rng.uniform(size=(CHAINS, MAX_EXP)).astype(F32),
           rng.uniform(size=(CHAINS, 2**MAX_EXP)).astype(F32))
    p_t, dirs, ub, ul = _external_randomness(raw, torch.tensor(imm),
                                             torch.device("cpu"))
    ms = np.asarray(jax_mass_sqrt(jnp.asarray(imm)))
    p_ref = raw[0] @ ms.T if dense else ms * raw[0]
    np.testing.assert_allclose(p_t.T.numpy(), p_ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(ul.T, torch.tensor(raw[3]))


def _small_problem():
    _, pg, data, _ = logistic_regression_pg_t(dim=DIM, num_points=POINTS)
    gen = torch.Generator().manual_seed(1)
    return pg, data, 0.1 * torch.randn(CHAINS, DIM, generator=gen)


def test_sample_fused_adaptive_loop_in_kernel_equals_per_draw():
    pg, data, q0 = _small_problem()
    outs = []
    for loop in (True, False):
        gen = torch.Generator().manual_seed(3)
        outs.append(sample_fused_adaptive(
            gen, None, data, q0, 8, 25, potential_and_grad_t=pg,
            max_num_expansions=4, loop_in_kernel=loop,
        ))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_sample_fused_adaptive_external_randomness_from_the_generator():
    """``use_internal_prng=False`` draws the external streams from the
    generator: the same generator state gives the same run."""
    pg, data, q0 = _small_problem()
    outs = [
        sample_fused_adaptive(
            torch.Generator().manual_seed(5), None, data, q0, 6, 25,
            potential_and_grad_t=pg, max_num_expansions=4,
            use_internal_prng=False, is_mass_matrix_full=True,
        )
        for _ in range(2)
    ]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    final, positions, stats, eps, imm = outs[0]
    assert positions.shape == (6, CHAINS, DIM) and stats.shape == (6, CHAINS, 8)
    assert imm.shape == (DIM, DIM) and bool(torch.isfinite(positions).all())
    assert 0.0 < float(eps) and torch.equal(final, positions[-1])


@pytest.mark.parametrize(
    "option, item",
    [
        ("sort_by_depth", "1.5"),
        ("per_chain_step_size", "1.5"),
        ("search_initial_step_size", "1.5"),
        ("mesh", "1.12"),
        ("checkpoint_every", "1.10"),
    ],
)
def test_unported_options_name_their_roadmap_item(option, item):
    pg, data, q0 = _small_problem()
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        sample_fused_adaptive(None, None, data, q0, 2, 2,
                              potential_and_grad_t=pg, **{option: 1})


def test_loop_in_kernel_requires_internal_prng():
    pg, data, q0 = _small_problem()
    with pytest.raises(ValueError, match="internal_prng"):
        sample_fused_adaptive(None, None, data, q0, 2, 2,
                              potential_and_grad_t=pg, loop_in_kernel=True,
                              use_internal_prng=False)
