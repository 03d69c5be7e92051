"""The port's adaptation stack (aehmc_tpu_torch.algorithms, step_size,
mass_matrix, window_adaptation) against aehmc_tpu on the same numpy inputs.

float64 throughout: the pooled tree sums keep the JAX package's order, so
they are exactly equal; everything else agrees to rtol 1e-10 or better.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aehmc_tpu import algorithms as jalg
from aehmc_tpu import mass_matrix as jmm
from aehmc_tpu import window_adaptation as jwa
from aehmc_tpu.types import ChainState as JaxChainState
from aehmc_tpu.types import Diagnostics as JaxDiagnostics
from aehmc_tpu_torch import algorithms as talg
from aehmc_tpu_torch import convert
from aehmc_tpu_torch import mass_matrix as tmm
from aehmc_tpu_torch import window_adaptation as twa
from aehmc_tpu_torch.types import ChainState, Diagnostics


def _close(a, b, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=rtol)


@pytest.mark.parametrize("num_steps", [19, 30, 100, 200])
def test_build_schedule_equals_jax(num_steps):
    assert twa.build_schedule(num_steps) == jwa.build_schedule(num_steps)


@pytest.mark.parametrize("n", [1, 5, 8, 1000])
def test_pairwise_sum_equals_jax(n):
    x = np.random.default_rng(n).normal(size=(n, 3))
    np.testing.assert_array_equal(
        talg.pairwise_sum(torch.tensor(x)).numpy(),
        np.asarray(jalg.pairwise_sum(jnp.asarray(x))),
    )
    np.testing.assert_array_equal(
        talg.pairwise_mean(torch.tensor(x)).numpy(),
        np.asarray(jalg.pairwise_mean(jnp.asarray(x))),
    )


@pytest.mark.parametrize("full", [False, True])
def test_welford_update_batch_equals_jax(full):
    rng = np.random.default_rng(1)
    jinit, _, jfinal = jalg.welford_covariance(full)
    tinit, _, tfinal = talg.welford_covariance(full)
    js = jinit(4, jnp.float64)
    ts = tinit(4, torch.float64)
    for _ in range(3):
        batch = rng.normal(size=(256, 4))
        js = jalg.welford_update_batch(full)(jnp.asarray(batch), js)
        ts = talg.welford_update_batch(full)(torch.tensor(batch), ts)
    for a, b in zip(ts, js):
        _close(a, b)
    _close(tfinal(ts), jfinal(js))


def test_welford_single_updates_and_shrinkage_equal_jax():
    rng = np.random.default_rng(2)
    for full in (False, True):
        jinit, jupd, jfin = jmm.covariance_adaptation(full)
        tinit, tupd, tfin = tmm.covariance_adaptation(full)
        (_, js), (_, ts) = jinit(3, jnp.float64), tinit(3, torch.float64)
        for _ in range(7):
            x = rng.normal(size=3)
            js, ts = jupd(jnp.asarray(x), js), tupd(torch.tensor(x), ts)
        _close(tfin(ts), jfin(js))


def test_dual_averaging_equals_jax():
    jinit, jupd = jalg.dual_averaging()
    tinit, tupd = talg.dual_averaging()
    js, ts = jinit(jnp.asarray(0.3)), tinit(torch.tensor(0.3, dtype=torch.float64))
    for g in np.random.default_rng(3).normal(size=40):
        js, ts = jupd(jnp.asarray(g), js), tupd(torch.tensor(g), ts)
    for a, b in zip(ts, js):
        _close(a, b)


@pytest.mark.parametrize("full", [False, True])
def test_window_adaptation_state_machine_equals_jax(full):
    """The whole state machine on identical position/acceptance inputs, as
    the fused driver runs it (batched Welford, pooled acceptance), starting
    the port from the JAX initial state carried across by convert."""
    num_steps, chains, dim = 60, 32, 3
    rng = np.random.default_rng(4)
    positions = rng.normal(size=(num_steps, chains, dim)) * [1.0, 2.0, 0.5]
    accepts = rng.uniform(0.5, 1.0, size=(num_steps, chains))
    hooks = dict(acceptance_statistic=lambda a: a.acceptance_probability.mean(),
                 num_dims_fn=lambda x: x.shape[1])
    jinit, jupd = jwa.window_adaptation(
        num_steps, full, 0.1,
        welford_update_fn=jalg.welford_update_batch(full), **hooks,
    )
    tinit, tupd = twa.window_adaptation(
        num_steps, full, 0.1,
        welford_update_fn=talg.welford_update_batch(full), **hooks,
    )
    q0 = positions[0]
    js = jinit(JaxChainState(jnp.asarray(q0), None, None))
    ts = tinit(ChainState(torch.tensor(q0), None, None))
    for a, b in zip(ts, convert.window_adaptation_state(js, device="cpu")):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            _close(x, y)
    ts = convert.window_adaptation_state(js, device="cpu")
    for step in range(num_steps):
        jinfo = JaxDiagnostics(jnp.asarray(accepts[step]), *[None] * 5)
        tinfo = Diagnostics(torch.tensor(accepts[step]), *[None] * 5)
        js = jupd(step, js, jnp.asarray(positions[step]), jinfo)
        ts = tupd(step, ts, torch.tensor(positions[step]), tinfo)
        _close(ts.step_size, js.step_size, rtol=1e-10)
        _close(ts.inverse_mass_matrix, js.inverse_mass_matrix, rtol=1e-10)
    assert ts.inverse_mass_matrix.shape == ((dim, dim) if full else (dim,))
