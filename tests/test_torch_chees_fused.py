"""The port's fused ChEES transition (aehmc_tpu_torch.ops.chees_fused)
against the JAX kernel in interpret mode, on the same numpy inputs.

Accept decisions and the exact stats rows (2: zero, 3: the trip count, 4:
divergent) must be equal.  q, the proposed position and the proposed
velocity agree to rtol 2e-4 and the accept probability to rtol 1e-4, the
tolerances of the JAX package's own kernel test (float32 sums in another
order).  Philox randomness is tested for determinism and for a chain's bits
not depending on the chain count or block size.  The CUDA kernel runs only
on a card: its tests are in ``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aehmc_tpu.models import logistic_regression_pg_t as jax_pg_builder
from aehmc_tpu.ops import chees_fused as jax_cf
from aehmc_tpu_torch.models import logistic_regression_pg_t
from aehmc_tpu_torch.ops.chees_fused import (
    chees_transition_plain,
    make_fused_chees_kernel,
    make_fused_chees_transition,
)
from aehmc_tpu_torch.ops.functors import HMC_CORE, card_functor
from aehmc_tpu_torch.ops.philox import ghmc_streams
from aehmc_tpu_torch.types import ChainState

F32 = np.float32
TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, chains=8, dim=6):
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.5, 2.0, size=dim).astype(F32)
    q = rng.normal(size=(chains, dim)).astype(F32)
    p = rng.normal(size=(chains, dim)).astype(F32)
    ua = rng.uniform(size=chains).astype(F32)
    U = (0.5 * np.sum(q**2 / var, axis=-1)).astype(F32)
    G = (q / var).astype(F32)
    return var, q, p, ua, U, G


def _jax_potential_t(q_t, var_col):
    return 0.5 * jnp.sum(q_t * q_t / var_col, axis=0)


def _potential_t(q_t, var_col):
    return 0.5 * torch.sum(q_t * q_t / var_col, dim=0)


def _gaussian_pg(q_t, var_col):
    return (0.5 * torch.sum(q_t * q_t / var_col, dim=0, keepdim=True),
            q_t / var_col)


def _assert_agree(port, jax_out, q0, L):
    qp_, up_, gp_, sp_, qprop_p, vprop_p = (np.asarray(a) for a in port)
    qj, uj, gj, sj, qprop_j, vprop_j = (np.asarray(a) for a in jax_out)
    np.testing.assert_array_equal(np.any(qp_ != q0, axis=1),
                                  np.any(qj != q0, axis=1))
    np.testing.assert_array_equal(sp_[:, 2:5], sj[:, 2:5])
    np.testing.assert_array_equal(sp_[:, 3], float(L))
    np.testing.assert_allclose(sp_[:, 1], sj[:, 1], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(sp_[:, 0], sj[:, 0], rtol=1e-4, atol=1e-4)
    for a, b in ((qp_, qj), (up_, uj), (gp_, gj), (qprop_p, qprop_j),
                 (vprop_p, vprop_j)):
        np.testing.assert_allclose(a, b, **TOL)


def _run_both(var, q, p, ua, U, G, im, eps, L):
    data_j = [jnp.asarray(var).reshape(-1, 1)]
    jax_out = jax_cf.make_fused_chees_transition(
        _jax_potential_t, data_j, block_chains=q.shape[0], interpret=True,
    )(jnp.asarray(q), jnp.asarray(U), jnp.asarray(G), jnp.asarray(p),
      jnp.asarray(ua), jnp.asarray(im), jnp.asarray(eps, jnp.float32),
      jnp.asarray(L, jnp.int32))
    port = make_fused_chees_transition(
        _potential_t, (torch.tensor(var).reshape(-1, 1),),
    )(torch.tensor(q), torch.tensor(U), torch.tensor(G), torch.tensor(p),
      torch.tensor(ua), torch.tensor(im), torch.tensor(eps, dtype=torch.float32),
      torch.tensor(L, dtype=torch.int32))
    return port, jax_out


@pytest.mark.parametrize("eps, L", [(0.3, 1), (0.5, 7), (0.9, 16), (25.0, 3)])
@pytest.mark.parametrize("seed", [0, 1])
def test_transition_matches_jax(eps, L, seed):
    var, q, p, ua, U, G = _inputs(seed)
    im = np.ones(q.shape[1], F32)
    port, jax_out = _run_both(var, q, p, ua, U, G, im, eps, L)
    _assert_agree(port, jax_out, q, L)
    if eps == 25.0:  # the divergent case diverges and rejects
        assert bool((port[3][:, 4] > 0.5).all())


def test_per_chain_step_size_matches_jax():
    var, q, p, ua, U, G = _inputs(3)
    im = np.ones(q.shape[1], F32)
    eps = np.random.default_rng(11).uniform(0.1, 0.9, size=q.shape[0]).astype(F32)
    port, jax_out = _run_both(var, q, p, ua, U, G, im, eps, 5)
    _assert_agree(port, jax_out, q, 5)
    # an all-equal vector is the scalar case bit for bit
    scalar, _ = _run_both(var, q, p, ua, U, G, im, F32(0.4), 5)
    vector, _ = _run_both(var, q, p, ua, U, G, im,
                          np.full(q.shape[0], 0.4, F32), 5)
    for a, b in zip(scalar, vector):
        assert torch.equal(a, b)


def test_dense_metric_matches_jax():
    rng = np.random.default_rng(7)
    chains, dim, L, eps = 8, 4, 6, 0.3
    A = rng.normal(size=(dim, dim))
    cov = (A @ A.T / dim + np.eye(dim)).astype(F32)
    prec = np.linalg.inv(cov.astype(np.float64)).astype(F32)
    q = rng.normal(size=(chains, dim)).astype(F32)
    p = rng.normal(size=(chains, dim)).astype(F32)
    ua = rng.uniform(size=chains).astype(F32)
    U = (0.5 * np.einsum("ci,ij,cj->c", q, prec, q)).astype(F32)
    G = (q @ prec).astype(F32)
    jax_out = jax_cf.make_fused_chees_transition(
        lambda q_t, m: 0.5 * jnp.sum(q_t * (m @ q_t), axis=0),
        [jnp.asarray(prec)], block_chains=chains, interpret=True,
    )(jnp.asarray(q), jnp.asarray(U), jnp.asarray(G), jnp.asarray(p),
      jnp.asarray(ua), jnp.asarray(cov), jnp.asarray(eps, jnp.float32),
      jnp.asarray(L, jnp.int32))
    port = make_fused_chees_transition(
        lambda q_t, m: 0.5 * torch.sum(q_t * (m @ q_t), dim=0),
        (torch.tensor(prec),),
    )(torch.tensor(q), torch.tensor(U), torch.tensor(G), torch.tensor(p),
      torch.tensor(ua), torch.tensor(cov), eps, L)
    _assert_agree(port, jax_out, q, L)


def test_logistic_transition_matches_jax():
    dim, points, chains, L, eps = 6, 48, 16, 8, 0.3
    _, pg_j, data_j, _ = jax_pg_builder(dim=dim, num_points=points,
                                        matmul_dtype=jnp.float32)
    _, pg_t, data_t, _ = logistic_regression_pg_t(dim=dim, num_points=points,
                                                  matmul_dtype=torch.float32,
                                                  device="cpu")
    rng = np.random.default_rng(5)
    q = (0.5 * rng.normal(size=(chains, dim))).astype(F32)
    p = rng.normal(size=(chains, dim)).astype(F32)
    ua = rng.uniform(size=chains).astype(F32)
    im = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    u0, g0 = pg_t(torch.tensor(q).T, *data_t)
    U, G = u0.reshape(-1).numpy(), g0.T.numpy()
    jax_out = jax_cf.make_fused_chees_transition(
        None, list(data_j), block_chains=8, interpret=True,
        potential_and_grad_t=pg_j,
    )(*(jnp.asarray(a) for a in (q, U, G, p, ua, im)),
      jnp.asarray(eps, jnp.float32), jnp.asarray(L, jnp.int32))
    port = make_fused_chees_transition(None, data_t, potential_and_grad_t=pg_t)(
        *(torch.tensor(a) for a in (q, U, G, p, ua, im)), eps, L)
    _assert_agree(port, jax_out, q, L)
    accepted = np.any(port[0].numpy() != q, axis=1)
    assert accepted.any()


def _gaussian_case(chains, seed=0, dim=5):
    var, q, _, _, U, G = _inputs(seed, chains=chains, dim=dim)
    return (torch.tensor(var).reshape(-1, 1), torch.tensor(q), torch.tensor(U),
            torch.tensor(G))


def test_philox_streams_are_the_ghmc_streams():
    var_col, q, U, G = _gaussian_case(16)
    im = torch.linspace(0.5, 1.5, q.shape[1])
    pot_grad = lambda q_t: _gaussian_pg(q_t, var_col)  # noqa: E731
    seeded = chees_transition_plain(q, U, G, im, 0.4, 6, pot_grad, seed=31)
    z, ua = ghmc_streams(31, 16, q.shape[1])
    external = chees_transition_plain(q, U, G, im, 0.4, 6, pot_grad,
                                      momentum=(torch.sqrt(1.0 / im)[:, None]
                                                * z).T,
                                      u_accept=ua)
    for a, b in zip(seeded, external):
        assert torch.equal(a, b)
    again = chees_transition_plain(q, U, G, im, 0.4, 6, pot_grad, seed=31)
    other = chees_transition_plain(q, U, G, im, 0.4, 6, pot_grad, seed=32)
    assert all(torch.equal(a, b) for a, b in zip(seeded, again))
    assert not torch.equal(seeded[4], other[4])


def test_a_chains_bits_do_not_depend_on_the_chain_count_or_block():
    """Philox follows the global chain index: the first 8 of 16 chains draw
    what 8 chains alone draw, and ``block_chains`` changes nothing."""
    var_col, q, U, G = _gaussian_case(16)
    im = torch.ones(q.shape[1])
    full = make_fused_chees_transition(_potential_t, (var_col,),
                                       block_chains=16)(
        q, U, G, None, None, im, 0.5, 4, seed=77)
    half = make_fused_chees_transition(_potential_t, (var_col,),
                                       block_chains=4)(
        q[:8], U[:8], G[:8], None, None, im, 0.5, 4, seed=77)
    for a, b in zip(full, half):
        assert torch.equal(a[:8], b)


def test_kernel_fn_draws_from_the_generator_or_takes_its_key():
    var_col, q, U, G = _gaussian_case(16)
    states = ChainState(q, U, G)
    im = torch.ones(q.shape[1])
    L = torch.tensor(3, dtype=torch.int32)
    for internal in (True, False):
        kernel_fn = make_fused_chees_kernel(_potential_t, (var_col,),
                                            use_internal_prng=internal)
        a = kernel_fn(torch.Generator().manual_seed(4), states, 0.5, L, im)
        b = kernel_fn(torch.Generator().manual_seed(4), states, 0.5, L, im)
        assert torch.equal(a[0].position, b[0].position)
        assert a[1].proposed_velocity.shape == q.shape
        assert a[1].num_integration_steps.dtype == torch.int32
    z = torch.randn(q.shape, generator=torch.Generator().manual_seed(0))
    u = torch.rand(16, generator=torch.Generator().manual_seed(1))
    kernel_fn = make_fused_chees_kernel(_potential_t, (var_col,),
                                        use_internal_prng=False,
                                        step_size_factors=torch.full((16,), 0.5))
    new, info = kernel_fn((z, u), states, 1.0, L, im)
    ref = make_fused_chees_transition(_potential_t, (var_col,))(
        q, U, G, z, u, im, 0.5, 3)
    assert torch.equal(new.position, ref[0]) and torch.equal(info.energy,
                                                              ref[3][:, 0])
    with pytest.raises(TypeError, match="key"):
        kernel_fn(7, states, 1.0, L, im)


def test_cuda_path_takes_the_logistic_potential_only():
    """The card's dispatch of kernel 7 (named when it took the logistic
    functor only; ``functors.card_functor`` on the HMC core): the logistic
    functor for ``logistic_pg_t``, a functor generated from the traced
    gradient graph for any other float32 potential, pre-differentiated or
    not; it raises only for what no functor takes."""
    _, pg_t, data_t, _ = logistic_regression_pg_t(dim=4, num_points=8,
                                                  matmul_dtype=torch.float32,
                                                  device="cpu")
    q_t = torch.zeros(4, 8)  # the functor is traced on a (dim, C) column

    def dispatch(pg, data, q, **kw):
        return card_functor(kw.get("potential_fn_t"), pg, data, q,
                            HMC_CORE)[0]

    var_col = torch.full((4, 1), 2.0)
    assert dispatch(_gaussian_pg, (var_col,), q_t) == "generic"
    assert dispatch(None, (var_col,), q_t,
                    potential_fn_t=_potential_t) == "generic"
    with pytest.raises(TypeError, match="float32"):
        dispatch(pg_t, data_t, q_t.double())
    with pytest.raises(ValueError, match="logistic data"):
        dispatch(pg_t, (var_col,), q_t)
    assert dispatch(pg_t, data_t, q_t) == "logistic"
