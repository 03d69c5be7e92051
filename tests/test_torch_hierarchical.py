"""The port's hierarchical models (Neal's funnel, eight schools) against
aehmc_tpu.models.hierarchical, and the port's plain fused NUTS with their
potential+gradient builders against the JAX kernel in interpret mode.

Builders: float64 on both sides, the same numpy positions, 1e-12 relative
(the same operations in the same order; sums may be taken in another
order).  Gradients equal autograd of the potential to 1e-12 relative.  The
fused NUTS runs take the JAX run's own streams: decisions (stats columns
2-5) equal, positions within 5e-5, as tests/test_nuts_fused_small.py holds
the JAX package's own builders against its vjp path.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu.models import eight_schools as jax_eight_schools
from aehmc_tpu.models import eight_schools_pg_t as jax_schools_pg_builder
from aehmc_tpu.models import eight_schools_t as jax_eight_schools_t
from aehmc_tpu.models import neals_funnel as jax_funnel
from aehmc_tpu.models import neals_funnel_pg_t as jax_funnel_pg_builder
from aehmc_tpu.models import neals_funnel_t as jax_funnel_t
from aehmc_tpu.ops.nuts_fused_small import sample_fused_small as jax_sample
from aehmc_tpu_torch import convert
from aehmc_tpu_torch.models import (
    eight_schools,
    eight_schools_pg_t,
    eight_schools_t,
    funnel_pg_t,
    logistic_pg_t,
    neals_funnel,
    neals_funnel_pg_t,
    neals_funnel_t,
    schools_pg_t,
)
from aehmc_tpu_torch.ops.nuts_fused_small import (
    _check_cuda_args,
    sample_fused_small,
)

F32 = np.float32
RTOL = 1e-12


def _positions(dim, chains=5, seed=0, scale=1.0):
    return scale * np.random.default_rng(seed).normal(size=(dim, chains))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=0)


@pytest.mark.parametrize("dim", [2, 6, 10])
def test_funnel_logprob_and_potential_equal_jax(dim):
    q = _positions(dim, seed=dim)
    logprob, ex = neals_funnel(dim, device="cpu")
    logprob_j, ex_j = jax_funnel(dim)
    for c in range(q.shape[1]):
        _close(logprob(torch.tensor(q[:, c])), logprob_j(jnp.asarray(q[:, c])))
    assert ex.shape == ex_j.shape and not bool(ex.any())
    pot, _ = neals_funnel_t(dim, device="cpu")
    pot_j, _ = jax_funnel_t(dim)
    _close(pot(torch.tensor(q)), pot_j(jnp.asarray(q)))


@pytest.mark.parametrize("non_centered", [True, False])
def test_eight_schools_logprob_equals_jax(non_centered):
    q = _positions(10, seed=3)
    q[1] = np.abs(q[1])  # log tau in a sane range either way
    logprob, ex = eight_schools(non_centered, device="cpu")
    logprob_j, _ = jax_eight_schools(non_centered)
    for c in range(q.shape[1]):
        _close(logprob(torch.tensor(q[:, c])), logprob_j(jnp.asarray(q[:, c])))
    assert ex.shape == (10,)


def test_eight_schools_t_potential_equals_jax():
    q = _positions(10, seed=4)
    pot, data, ex = eight_schools_t(torch.float64, device="cpu")
    pot_j, data_j, _ = jax_eight_schools_t()
    _close(pot(torch.tensor(q), *data), pot_j(jnp.asarray(q), *data_j))
    assert ex.shape == (10,)


@pytest.mark.parametrize("model", ["funnel", "eight_schools"])
def test_pg_builders_equal_jax(model):
    if model == "funnel":
        pot, pg, data, ex = neals_funnel_pg_t(7, device="cpu")
        pot_j, pg_j, data_j, ex_j = jax_funnel_pg_builder(7)
        assert pg is funnel_pg_t and tuple(data[0].shape) == (1, 1)
    else:
        pot, pg, data, ex = eight_schools_pg_t(torch.float64, device="cpu")
        pot_j, pg_j, data_j, ex_j = jax_schools_pg_builder()
        assert pg is schools_pg_t
    dim = ex.shape[0]
    assert ex.shape == ex_j.shape
    q = _positions(dim, chains=9, seed=5)
    u, g = pg(torch.tensor(q), *data)
    u_j, g_j = pg_j(jnp.asarray(q), *data_j)
    assert tuple(u.shape) == (1, 9) and tuple(g.shape) == (dim, 9)
    _close(u, u_j)
    _close(g, g_j)
    _close(pot(torch.tensor(q), *data), pot_j(jnp.asarray(q), *data_j))


@pytest.mark.parametrize("model", ["funnel", "eight_schools"])
def test_pg_gradient_equals_autograd_of_the_potential(model):
    if model == "funnel":
        pot, pg, data, _ = neals_funnel_pg_t(8, device="cpu")
    else:
        pot, pg, data, _ = eight_schools_pg_t(torch.float64, device="cpu")
    dim = 8 if model == "funnel" else 10
    q = torch.tensor(_positions(dim, chains=6, seed=6), requires_grad=True)
    (g_auto,) = torch.autograd.grad(pot(q, *data).sum(), q)
    u, g = pg(q.detach(), *data)
    _close(u[0], pot(q.detach(), *data))
    _close(g, g_auto)


def test_eight_schools_data_equal_jax_bit_for_bit():
    """The builder's and the converter's float32 columns hold JAX's values
    exactly (small integers); the converter gives the builder's tensors."""
    _, data_j, _ = jax_eight_schools_t()
    _, data, _ = eight_schools_t(device="cpu")
    _, _, data_pg, _ = eight_schools_pg_t(device="cpu")
    converted = convert.eight_schools_data(*data_j, device="cpu")
    for a, b, c, j in zip(data, data_pg, converted, data_j):
        assert a.dtype == torch.float32 and tuple(a.shape) == (8, 1)
        np.testing.assert_array_equal(a.numpy(), np.asarray(j))
        assert torch.equal(a, b) and torch.equal(a, c)
        assert c.dtype == torch.float32 and c.is_contiguous()


def _jax_streams(key, draws, chains, dim, max_exp):
    def streams(t):
        k1, k2, k3, k4 = jax.random.split(jax.random.split(key, draws)[t], 4)
        z = jax.random.normal(k1, (chains, dim), jnp.float32)
        u_dir = jax.random.uniform(k2, (chains, max_exp))
        dirs = jnp.where(u_dir < 0.5, -1.0, 1.0)
        ub = jax.random.uniform(k3, (chains, max_exp))
        ul = jax.random.uniform(k4, (chains, 2**max_exp))
        return tuple(np.array(a, F32) for a in (z, dirs, ub, ul))

    return streams


@pytest.mark.parametrize("model", ["funnel", "eight_schools"])
def test_plain_fused_nuts_matches_jax_interpret(model):
    """The port's plain sample_fused_small with the funnel (dim 6) and
    eight-schools builders against the JAX kernel in interpret mode, fed
    the JAX run's streams, at ε 0.2 and K 4 (tests/test_nuts_fused_small.py
    :306-342)."""
    if model == "funnel":
        pot_j, pg_j, data_j, ex_j = jax_funnel_pg_builder(dim=6)
        pot, pg, data, _ = neals_funnel_pg_t(6, device="cpu")
    else:
        pot_j, pg_j, data_j, ex_j = jax_schools_pg_builder()
        pot, pg, data, _ = eight_schools_pg_t(device="cpu")
    dim = ex_j.shape[0]
    chains, draws, max_exp, eps = 16, 25, 4, 0.2
    q0 = np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(0),
                                            (chains, dim), jnp.float32))
    key = jax.random.PRNGKey(1)
    qf_j, pos_j, stats_j = jax_sample(
        key, pot_j, list(data_j), jnp.asarray(q0), draws,
        jnp.asarray(eps, jnp.float32), jnp.ones(dim, jnp.float32),
        max_num_expansions=max_exp, block_chains=chains,
        internal_prng=False, potential_and_grad_t=pg_j, _interpret=True,
    )
    qf, pos, stats = sample_fused_small(
        None, pot, data, torch.tensor(q0), draws, eps, torch.ones(dim),
        max_num_expansions=max_exp, potential_and_grad_t=pg,
        internal_prng=False,
        streams=_jax_streams(key, draws, chains, dim, max_exp),
    )
    np.testing.assert_array_equal(stats.numpy()[..., 2:6],
                                  np.asarray(stats_j)[..., 2:6])
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), rtol=5e-5,
                               atol=5e-5)
    np.testing.assert_allclose(qf.numpy(), np.asarray(qf_j), rtol=5e-5,
                               atol=5e-5)


def test_cuda_path_names_the_potentials_it_takes():
    """Kernels 1 and 2 take the three builders' potential+gradient
    functions in their hand-written functors, each with its own data; any
    other potential binds a functor generated from its traced gradient
    graph."""
    q_t = torch.zeros(10, 16)
    _, _, funnel_data, _ = neals_funnel_pg_t(10, device="cpu")
    _, _, schools_data, _ = eight_schools_pg_t(device="cpu")
    assert _check_cuda_args(funnel_pg_t, funnel_data, q_t, 0.2) == "funnel"
    assert (_check_cuda_args(schools_pg_t, schools_data, q_t, 0.2)
            == "eight_schools")
    assert _check_cuda_args(lambda q, d: funnel_pg_t(q, d), funnel_data,
                            q_t, 0.2) == "generic"
    with pytest.raises(ValueError, match="eight_schools data"):
        _check_cuda_args(schools_pg_t, funnel_data, q_t, 0.2)
    with pytest.raises(ValueError, match="logistic data"):
        _check_cuda_args(logistic_pg_t, schools_data, q_t, 0.2)
    with pytest.raises(TypeError, match="float32"):
        _check_cuda_args(funnel_pg_t, funnel_data, q_t.double(), 0.2)
