"""Per-chain step sizes in kernels 1 and 2's plain versions and in
``sample_fused_small`` (depth-sorted scheduling included), against the JAX
package's ``per_chain_eps`` kernels in interpret mode and the NumPy oracle
(port of ``tests/test_nuts_fused_small.py``'s per-chain tests).

Decisions (stats columns 2-5) are exactly equal; q, U, ∇U and the energy
agree to 1e-5 (float32 sums in another order); against the float64 oracle
positions agree to 1e-3, as the JAX kernel tests hold them.  A constant
ε vector equals the scalar run bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu.models import logistic_regression_pg_t as jax_pg_builder
from aehmc_tpu.ops.nuts_fused_small import (
    make_fused_nuts_transition_small as jax_transition,
)
from aehmc_tpu.ops.nuts_fused_small import sample_fused_small as jax_sample
from aehmc_tpu.ops.nuts_oracle import (
    nuts_transition_oracle,
    nuts_transition_oracle_generic,
)
from aehmc_tpu_torch.models import logistic_regression_pg_t
from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
from aehmc_tpu_torch.ops.nuts_fused_small import (
    _fused_sampling_call_t,
    make_fused_nuts_transition_small,
    nuts_transition_plain,
    sample_fused_small,
)
from aehmc_tpu_torch.ops.philox import MASK32, nuts_streams

F32 = np.float32


def _streams(rng, chains, dim, max_exp):
    p = rng.normal(size=(chains, dim)).astype(F32)
    dirs = np.where(rng.uniform(size=(chains, max_exp)) < 0.5, -1.0, 1.0)
    ub = rng.uniform(size=(chains, max_exp)).astype(F32)
    ul = rng.uniform(size=(chains, 2**max_exp)).astype(F32)
    return p, dirs.astype(F32), ub, ul


def _gaussian_pg(q_t, var_col):
    return (0.5 * torch.sum(q_t * q_t / var_col, dim=0, keepdim=True),
            q_t / var_col)


def _jax_gaussian_t(q_t, var_col):
    return 0.5 * jnp.sum(q_t * q_t / var_col, axis=0)


def _gaussian_case(seed, chains, dim, max_exp):
    rng = np.random.default_rng(seed)
    var = rng.uniform(0.5, 2.0, size=dim).astype(F32)
    im = np.ones(dim, F32)
    q = rng.normal(size=(chains, dim)).astype(F32)
    p, dirs, ub, ul = _streams(rng, chains, dim, max_exp)
    U = (0.5 * np.sum(q.astype(np.float64) ** 2 / var, -1)).astype(F32)
    G = (q.astype(np.float64) / var).astype(F32)
    return var, (q, U.reshape(-1, 1), G, p, dirs, ub, ul, im)


def _assert_same(out_t, out_j):
    np.testing.assert_array_equal(out_t[3][:, 2:6], out_j[3][:, 2:6])
    for a, b in zip((out_t[0], out_t[1], out_t[2], out_t[3][:, 0]),
                    (out_j[0], out_j[1], out_j[2], out_j[3][:, 0])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _assert_oracle(q_out, stats, refs):
    for i, ref in enumerate(refs):
        assert int(stats[i, 2]) == ref["num_doublings"], i
        assert int(stats[i, 3]) == ref["num_integration_steps"], i
        assert int(stats[i, 4]) == int(ref["is_diverging"]), i
        assert int(stats[i, 5]) == int(ref["is_turning"]), i
        np.testing.assert_allclose(q_out[i], ref["position"], atol=1e-3)


@pytest.mark.parametrize("seed", [5, 6])
def test_per_chain_eps_transition_matches_jax_and_oracle_gaussian(seed):
    """Every chain of one block integrates at its own ε (mirrors JAX
    ``test_small_kernel_per_chain_eps_matches_oracle``)."""
    chains, dim, max_exp = 8, 6, 4
    var, args = _gaussian_case(seed, chains, dim, max_exp)
    eps_vec = np.random.default_rng(17 + seed).uniform(
        0.05, 1.2, size=chains).astype(F32)
    port = make_fused_nuts_transition_small(
        None, [torch.tensor(var).reshape(-1, 1)], max_num_expansions=max_exp,
        potential_and_grad_t=_gaussian_pg,
    )
    out_t = [o.numpy() for o in port(*map(torch.tensor, args),
                                     torch.tensor(eps_vec))]
    jt = jax_transition(_jax_gaussian_t, [jnp.asarray(var).reshape(-1, 1)],
                        max_num_expansions=max_exp, block_chains=chains,
                        interpret=True)
    out_j = [np.asarray(o) for o in jt(*map(jnp.asarray, args),
                                        jnp.asarray(eps_vec))]
    _assert_same(out_t, out_j)
    q, _, _, p, dirs, ub, ul, im = args
    refs = [
        nuts_transition_oracle_generic(
            lambda x: 0.5 * np.sum(x * x / var), lambda x: x / var, q[i],
            p[i], im, float(eps_vec[i]), dirs[i], ub[i], ul[i], max_exp)
        for i in range(chains)
    ]
    _assert_oracle(out_t[0], out_t[3], refs)


def test_per_chain_eps_transition_matches_jax_and_oracle_logistic_dense():
    """The logistic potential and a dense M⁻¹ at a per-chain ε."""
    dim, points, chains, max_exp = 8, 64, 16, 4
    rng = np.random.default_rng(9)
    A = rng.normal(size=(dim, dim))
    imm = (A @ A.T / dim + np.eye(dim)).astype(F32)
    q = (0.3 * rng.normal(size=(chains, dim))).astype(F32)
    p, dirs, ub, ul = _streams(rng, chains, dim, max_exp)
    eps_vec = rng.uniform(0.1, 0.5, size=chains).astype(F32)
    _, pg_j, data_j, _ = jax_pg_builder(dim=dim, num_points=points,
                                        matmul_dtype=jnp.float32)
    _, pg_t, data_t, _ = logistic_regression_pg_t(dim=dim, num_points=points,
                                                  matmul_dtype=torch.float32,
                                                  device="cpu")
    u0, g0 = pg_t(torch.tensor(q).T.contiguous(), *data_t)
    args = (q, u0.numpy().reshape(-1, 1), g0.T.numpy(), p, dirs, ub, ul, imm)
    port = make_fused_nuts_transition_small(
        None, data_t, max_num_expansions=max_exp, potential_and_grad_t=pg_t)
    out_t = [o.numpy() for o in port(*map(torch.tensor, args),
                                     torch.tensor(eps_vec))]
    jt = jax_transition(lambda q_t, *d: pg_j(q_t, *d)[0], list(data_j),
                        max_num_expansions=max_exp, block_chains=chains,
                        interpret=True, potential_and_grad_t=pg_j)
    out_j = [np.asarray(o) for o in jt(*map(jnp.asarray, args),
                                        jnp.asarray(eps_vec))]
    _assert_same(out_t, out_j)
    X, y = data_t[0].numpy(), data_t[2].numpy().reshape(-1)
    refs = [
        nuts_transition_oracle(q[i], p[i], X, y, imm.astype(np.float64),
                               float(eps_vec[i]), dirs[i], ub[i], ul[i],
                               max_exp)
        for i in range(chains)
    ]
    _assert_oracle(out_t[0], out_t[3], refs)


def test_constant_eps_vector_equals_scalar():
    """A constant ε vector makes the scalar run's decisions and bits, in
    the port and in JAX (mirrors JAX
    ``test_small_kernel_per_chain_eps_all_equal_matches_scalar``)."""
    chains, dim, max_exp, eps = 8, 6, 4, 0.4
    var, args = _gaussian_case(9, chains, dim, max_exp)
    port = make_fused_nuts_transition_small(
        None, [torch.tensor(var).reshape(-1, 1)], max_num_expansions=max_exp,
        potential_and_grad_t=_gaussian_pg)
    targs = list(map(torch.tensor, args))
    scalar = port(*targs, torch.tensor(eps, dtype=torch.float32))
    vector = port(*targs, torch.full((chains,), eps))
    for a, b in zip(scalar, vector):
        assert torch.equal(a, b)
    jt = jax_transition(_jax_gaussian_t, [jnp.asarray(var).reshape(-1, 1)],
                        max_num_expansions=max_exp, block_chains=chains,
                        interpret=True)
    out_j = jt(*map(jnp.asarray, args), jnp.full((chains,), eps, jnp.float32))
    _assert_same([o.numpy() for o in vector], [np.asarray(o) for o in out_j])


def test_per_chain_eps_row_validation():
    """A per-chain ε has one entry a chain, as in the JAX builder."""
    chains, dim, max_exp = 8, 6, 4
    var, args = _gaussian_case(3, chains, dim, max_exp)
    q, U, G, *_ = map(torch.tensor, args)
    with pytest.raises(ValueError, match="5 entries for 8 chains"):
        nuts_transition_plain(q.T, U.T, G.T, torch.ones(dim), torch.ones(5),
                              lambda q_t: _gaussian_pg(q_t, torch.tensor(
                                  var).reshape(-1, 1)),
                              max_exp=max_exp, seed=1)


def test_whole_run_per_chain_eps_equals_transitions_and_oracle():
    """Kernel 2's plain version at a per-chain ε (fixed across the draws)
    equals one plain transition a draw bit for bit, and each draw makes the
    oracle's decisions on the Philox streams of its key, at its chain's ε.
    (JAX's kernel 2 has only the on-chip PRNG, with no interpret mode.)"""
    chains, dim, max_exp, draws, seed = 8, 5, 4, 4, 123456789
    var = np.linspace(0.5, 2.0, dim).astype(F32)
    var_col = torch.tensor(var).reshape(-1, 1)
    q0 = torch.tensor(np.random.default_rng(1).normal(size=(dim, chains)),
                      dtype=torch.float32)
    u0, g0 = _gaussian_pg(q0, var_col)
    eps = torch.tensor(np.random.default_rng(2).uniform(0.1, 1.0, size=chains),
                       dtype=torch.float32)
    imm = torch.ones(dim)
    pos, stats, qf, uf, gf = _fused_sampling_call_t(
        None, _gaussian_pg, (var_col,), q0, u0, g0, imm, eps, seed, draws,
        max_num_expansions=max_exp)
    q, u, g = q0, u0, g0
    for t in range(draws):
        key = (seed + t * DRAW_SEED_STRIDE) & MASK32
        q_prev = q.T.numpy().astype(np.float64)
        q, u, g, st = nuts_transition_plain(
            q, u, g, imm, eps, lambda x: _gaussian_pg(x, var_col),
            max_exp=max_exp, seed=key)
        assert torch.equal(pos[t], q) and torch.equal(stats[t], st)
        z, dirs, ub, ul = (s.T.numpy() for s in nuts_streams(key, chains, dim,
                                                              max_exp))
        refs = [
            nuts_transition_oracle_generic(
                lambda x: 0.5 * np.sum(x * x / var), lambda x: x / var,
                q_prev[i], z[i], np.ones(dim), float(eps[i]), dirs[i], ub[i],
                ul[i], max_exp)
            for i in range(chains)
        ]
        _assert_oracle(q.T.numpy(), st.T.numpy(), refs)
    assert torch.equal(qf, q) and torch.equal(uf, u) and torch.equal(gf, g)


def _jax_sample_streams(key, draws, chains, dim, max_exp):
    """The raw streams JAX's ``sample_fused_small`` draws from ``key`` with
    ``internal_prng=False``, in the standard layout."""
    out = []
    for k in jax.random.split(key, draws):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        z = jax.random.normal(k1, (chains, dim), jnp.float32)
        dirs = jnp.where(jax.random.uniform(k2, (chains, max_exp)) < 0.5,
                         -1.0, 1.0)
        ub = jax.random.uniform(k3, (chains, max_exp))
        ul = jax.random.uniform(k4, (chains, 2**max_exp))
        out.append(tuple(np.array(a, F32) for a in (z, dirs, ub, ul)))
    return out


def test_sorted_per_chain_eps_sampling_matches_jax():
    """``sample_fused_small`` with a per-chain ε and ``sort_by_depth``
    against JAX's on the same streams: the stable depth order, the ε riding
    it, the streams staying in place."""
    dim, chains, draws, max_exp = 4, 16, 6, 4
    var = np.linspace(0.5, 2.0, dim).astype(F32)
    q0 = (0.8 * np.random.default_rng(4).normal(size=(chains, dim))).astype(F32)
    eps = np.random.default_rng(6).uniform(0.2, 1.4, size=chains).astype(F32)
    key = jax.random.PRNGKey(5)
    _, pos_j, stats_j = jax_sample(
        key, _jax_gaussian_t, [jnp.asarray(var).reshape(-1, 1)],
        jnp.asarray(q0), draws, jnp.asarray(eps), jnp.ones(dim, jnp.float32),
        max_num_expansions=max_exp, block_chains=8, internal_prng=False,
        sort_by_depth=True, _interpret=True)
    streams = _jax_sample_streams(key, draws, chains, dim, max_exp)
    _, pos_t, stats_t = sample_fused_small(
        None, None, [torch.tensor(var).reshape(-1, 1)], torch.tensor(q0),
        draws, torch.tensor(eps), torch.ones(dim),
        max_num_expansions=max_exp, potential_and_grad_t=_gaussian_pg,
        internal_prng=False, sort_by_depth=True, block_chains=8,
        streams=lambda t: streams[t])
    np.testing.assert_array_equal(stats_t.numpy()[..., 2:6],
                                  np.asarray(stats_j)[..., 2:6])
    np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), atol=1e-5)
    # the sort moved chains: the depths of the first draw are not uniform
    assert len(np.unique(np.asarray(stats_j)[0, :, 2])) > 1


def test_per_chain_eps_rides_the_depth_sort():
    """Half the fleet at an ε that always diverges, half at a tiny one: the
    divergences follow the chains through the block permutation (mirrors
    JAX ``test_sample_fused_small_per_chain_eps_rides_depth_sort``), under
    Philox keys and external streams."""
    dim, chains, draws = 4, 16, 6
    var_col = torch.linspace(0.5, 2.0, dim).reshape(-1, 1)
    q0 = 0.5 * torch.randn(chains, dim,
                           generator=torch.Generator().manual_seed(4))
    eps = torch.full((chains,), 0.05)
    eps[chains // 2:] = 1e6
    for internal in (True, False):
        _, _, stats = sample_fused_small(
            torch.Generator().manual_seed(5), None, [var_col], q0, draws, eps,
            torch.ones(dim), max_num_expansions=4,
            potential_and_grad_t=_gaussian_pg, internal_prng=internal,
            sort_by_depth=True)
        div = stats[:, :, 4]
        assert bool((div[:, chains // 2:] == 1.0).all())
        assert bool((div[:, :chains // 2] == 0.0).all())


def test_sort_by_depth_refuses_the_whole_run_kernel():
    var_col = torch.ones(4, 1)
    with pytest.raises(ValueError, match="sort_by_depth"):
        sample_fused_small(torch.Generator(), None, [var_col],
                           torch.zeros(8, 4), 4, 0.5, torch.ones(4),
                           max_num_expansions=4,
                           potential_and_grad_t=_gaussian_pg,
                           sort_by_depth=True, loop_in_kernel=True)


def test_sorted_philox_run_is_deterministic_and_sorts_chains():
    """Under Philox keys the sorted run is a different run from the unsorted
    one (a chain takes the stream of its sorted place) with the same
    statistics, and one seed gives one set of bits."""
    dim, chains, draws = 4, 32, 12
    var_col = torch.linspace(0.5, 2.0, dim).reshape(-1, 1)
    q0 = 0.5 * torch.randn(chains, dim,
                           generator=torch.Generator().manual_seed(8))
    eps = torch.linspace(0.3, 1.2, chains)

    def run(sort):
        return sample_fused_small(
            torch.Generator().manual_seed(9), None, [var_col], q0, draws, eps,
            torch.ones(dim), max_num_expansions=5,
            potential_and_grad_t=_gaussian_pg, sort_by_depth=sort)

    a, b, plain = run(True), run(True), run(False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[1], plain[1])
    assert bool(torch.isfinite(a[1]).all())
    # the first draw starts from depth 0: no permutation, the same bits
    assert torch.equal(a[1][0], plain[1][0])
