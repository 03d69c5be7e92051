"""The port's fused NUTS transition (aehmc_tpu_torch.ops.nuts_fused_small)
against the JAX kernel in interpret mode and the NumPy oracle, on the same
numpy inputs.

Decisions (doublings, leaves, divergent, turning) must be exactly equal;
q, U, ∇U and the energy agree to 1e-5 (float32 reductions summed in another
order).  Against the float64 oracle positions agree to 1e-3, as the JAX
package's own kernel tests hold them.  The CUDA kernels run only on a card:
their tests are in ``test_torch_cuda.py``.
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
from aehmc_tpu_torch.models import logistic_pg_t, logistic_regression_pg_t
from aehmc_tpu_torch.ops import _build
from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
from aehmc_tpu_torch.ops.nuts_fused_small import (
    _check_cuda_args,
    _eps_row,
    _fused_sampling_call_t,
    make_fused_nuts_transition_small,
    nuts_transition_plain,
    sample_fused_small,
)
from aehmc_tpu_torch.ops.philox import MASK32, nuts_streams, philox4x32

F32 = np.float32


def _streams(rng, chains, dim, max_exp):
    p = rng.normal(size=(chains, dim)).astype(F32)
    dirs = np.where(rng.uniform(size=(chains, max_exp)) < 0.5, -1.0, 1.0)
    ub = rng.uniform(size=(chains, max_exp)).astype(F32)
    ul = rng.uniform(size=(chains, 2**max_exp)).astype(F32)
    return p, dirs.astype(F32), ub, ul


def _gaussian_potential(q_t, var_col):
    return 0.5 * torch.sum(q_t * q_t / var_col, dim=0)


def _gaussian_pg(q_t, var_col):
    return 0.5 * torch.sum(q_t * q_t / var_col, dim=0, keepdim=True), q_t / var_col


def _assert_same(stats_a, stats_b, floats_a, floats_b):
    np.testing.assert_array_equal(stats_a[:, 2:6], stats_b[:, 2:6])
    for a, b in zip(floats_a, floats_b):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _assert_oracle(q_out, stats, refs, atol=1e-3):
    for i, ref in enumerate(refs):
        assert int(stats[i, 2]) == ref["num_doublings"], i
        assert int(stats[i, 3]) == ref["num_integration_steps"], i
        assert int(stats[i, 4]) == int(ref["is_diverging"]), i
        assert int(stats[i, 5]) == int(ref["is_turning"]), i
        np.testing.assert_allclose(q_out[i], ref["position"], atol=atol)


@pytest.mark.parametrize("eps, max_exp", [(0.3, 4), (0.9, 4), (0.05, 5), (25.0, 4)])
def test_plain_transition_matches_jax_and_oracle_gaussian(eps, max_exp):
    for seed in (0, 1):
        rng = np.random.default_rng(seed)
        chains, dim = 8, 6
        var = rng.uniform(0.5, 2.0, size=dim).astype(F32)
        im = np.ones(dim, F32)
        q = rng.normal(size=(chains, dim)).astype(F32)
        p, dirs, ub, ul = _streams(rng, chains, dim, max_exp)
        U = (0.5 * np.sum(q.astype(np.float64) ** 2 / var, -1)).astype(F32)
        G = (q.astype(np.float64) / var).astype(F32)
        args = (q, U.reshape(-1, 1), G, p, dirs, ub, ul, im)

        # seed 1 differentiates the potential with autograd
        port = make_fused_nuts_transition_small(
            _gaussian_potential, [torch.tensor(var).reshape(-1, 1)],
            max_num_expansions=max_exp,
            potential_and_grad_t=_gaussian_pg if seed == 0 else None,
        )
        out_t = [o.numpy() for o in port(*map(torch.tensor, args),
                                         torch.tensor(eps, dtype=torch.float32))]

        def potential_t(q_t, var_col):
            return 0.5 * jnp.sum(q_t * q_t / var_col, axis=0)

        jt = jax_transition(
            potential_t, [jnp.asarray(var).reshape(-1, 1)],
            max_num_expansions=max_exp, block_chains=chains, interpret=True,
        )
        out_j = [np.asarray(o) for o in jt(*map(jnp.asarray, args),
                                            jnp.asarray(eps, jnp.float32))]
        _assert_same(out_t[3], out_j[3],
                     (out_t[0], out_t[1], out_t[2], out_t[3][:, 0]),
                     (out_j[0], out_j[1], out_j[2], out_j[3][:, 0]))
        refs = [
            nuts_transition_oracle_generic(
                lambda x: 0.5 * np.sum(x * x / var), lambda x: x / var,
                q[i], p[i], im, eps, dirs[i], ub[i], ul[i], max_exp,
            )
            for i in range(chains)
        ]
        _assert_oracle(out_t[0], out_t[3], refs)


@pytest.mark.parametrize("eps", [0.15, 0.4])
def test_plain_transition_matches_jax_and_oracle_logistic_dense(eps):
    dim, points, chains, max_exp = 8, 64, 16, 4
    rng = np.random.default_rng(5)
    A = rng.normal(size=(dim, dim))
    imm = (A @ A.T / dim + np.eye(dim)).astype(F32)
    q = (0.3 * rng.normal(size=(chains, dim))).astype(F32)
    p, dirs, ub, ul = _streams(rng, chains, dim, max_exp)

    _, pg_j, data_j, _ = jax_pg_builder(dim=dim, num_points=points,
                                        matmul_dtype=jnp.float32)
    _, pg_t, data_t, _ = logistic_regression_pg_t(dim=dim, num_points=points,
                                                  matmul_dtype=torch.float32,
                                                  device="cpu")
    u0, g0 = pg_t(torch.tensor(q).T.contiguous(), *data_t)
    args = (q, u0.numpy().reshape(-1, 1), g0.T.numpy(), p, dirs, ub, ul, imm)

    port = make_fused_nuts_transition_small(
        None, data_t, max_num_expansions=max_exp, potential_and_grad_t=pg_t,
    )
    out_t = [o.numpy() for o in port(*map(torch.tensor, args),
                                     torch.tensor(eps, dtype=torch.float32))]
    jt = jax_transition(
        lambda q_t, *d: pg_j(q_t, *d)[0], list(data_j),
        max_num_expansions=max_exp, block_chains=chains, interpret=True,
        potential_and_grad_t=pg_j,
    )
    out_j = [np.asarray(o) for o in jt(*map(jnp.asarray, args),
                                        jnp.asarray(eps, jnp.float32))]
    _assert_same(out_t[3], out_j[3],
                 (out_t[0], out_t[1], out_t[2], out_t[3][:, 0]),
                 (out_j[0], out_j[1], out_j[2], out_j[3][:, 0]))
    X, y = data_t[0].numpy(), data_t[2].numpy().reshape(-1)
    refs = []
    for i in range(chains):
        refs.append(nuts_transition_oracle(
            q[i], p[i], X, y, imm.astype(np.float64), eps, dirs[i], ub[i],
            ul[i], max_exp,
        ))
    _assert_oracle(out_t[0], out_t[3], refs)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("eps", [0.15, 0.4])
def test_plain_bf16_transition_matches_jax_default_builder(eps, dense):
    """Kernels 1-2's plain version with the builders' default (bfloat16)
    data against the JAX kernel in interpret mode with its default data, on
    external streams: identical decisions; q, U, ∇U and the energy within
    1e-5, as with float32 data (both round the same operands once; only the
    float32 sums' orders differ)."""
    dim, points, chains, max_exp = 8, 64, 16, 4
    rng = np.random.default_rng(7)
    if dense:
        A = rng.normal(size=(dim, dim))
        imm = (A @ A.T / dim + np.eye(dim)).astype(F32)
    else:
        imm = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    q = (0.3 * rng.normal(size=(chains, dim))).astype(F32)
    p, dirs, ub, ul = _streams(rng, chains, dim, max_exp)

    _, pg_j, data_j, _ = jax_pg_builder(dim=dim, num_points=points)
    _, pg_t, data_t, _ = logistic_regression_pg_t(dim=dim, num_points=points,
                                                  device="cpu")
    assert data_t[0].dtype == torch.bfloat16
    assert str(data_j[0].dtype) == "bfloat16"
    u0, g0 = pg_t(torch.tensor(q).T.contiguous(), *data_t)
    args = (q, u0.numpy().reshape(-1, 1), g0.T.numpy(), p, dirs, ub, ul, imm)

    port = make_fused_nuts_transition_small(
        None, data_t, max_num_expansions=max_exp, potential_and_grad_t=pg_t,
    )
    out_t = [o.numpy() for o in port(*map(torch.tensor, args),
                                     torch.tensor(eps, dtype=torch.float32))]
    jt = jax_transition(
        lambda q_t, *d: pg_j(q_t, *d)[0], list(data_j),
        max_num_expansions=max_exp, block_chains=chains, interpret=True,
        potential_and_grad_t=pg_j,
    )
    out_j = [np.asarray(o) for o in jt(*map(jnp.asarray, args),
                                        jnp.asarray(eps, jnp.float32))]
    _assert_same(out_t[3], out_j[3],
                 (out_t[0], out_t[1], out_t[2], out_t[3][:, 0]),
                 (out_j[0], out_j[1], out_j[2], out_j[3][:, 0]))
    # the bfloat16 data move the chains off the float32 posterior's path
    _, pg32, data32, _ = logistic_regression_pg_t(
        dim=dim, num_points=points, matmul_dtype=torch.float32, device="cpu")
    u32, _ = pg32(torch.tensor(q).T.contiguous(), *data32)
    assert not torch.equal(u0, u32)


@pytest.mark.parametrize(
    "word, expected",
    [
        (0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        (MASK32, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ],
)
def test_philox_known_answers(word, expected):
    w = torch.tensor(word, dtype=torch.int64)
    out = philox4x32((w, w, w, w), (word, word))
    assert tuple(int(x) for x in out) == expected


def test_philox_streams_are_per_chain():
    """A chain's streams depend on its global index only, not on how many
    chains are drawn together: the basis of block-size independence."""
    dim, max_exp = 7, 4
    full = nuts_streams(1234, 24, dim, max_exp)
    part = nuts_streams(1234, 8, dim, max_exp, chain_offset=16)
    for a, b in zip(full, part):
        assert torch.equal(a[:, 16:], b)
    z, dirs, ub, ul = full
    assert z.shape == (dim, 24) and ul.shape == (2**max_exp, 24)
    assert set(dirs.unique().tolist()) <= {-1.0, 1.0}
    assert bool((ub > 0).all() & (ub <= 1).all() & (ul > 0).all())
    assert abs(float(z.mean())) < 0.3 and abs(float(z.std()) - 1.0) < 0.3


def _logistic_case(chains=16, dim=6, points=48, seed=3):
    _, pg, data, _ = logistic_regression_pg_t(dim=dim, num_points=points,
                                              matmul_dtype=torch.float32,
                                              device="cpu")
    gen = torch.Generator().manual_seed(seed)
    q0 = 0.1 * torch.randn(chains, dim, generator=gen)
    return pg, data, q0


def test_plain_whole_run_equals_per_draw_transitions():
    pg, data, q0 = _logistic_case()
    q_t = q0.T.contiguous()
    u0, g0 = pg(q_t, *data)
    imm = torch.full((q0.shape[1],), 0.8)
    seed, draws = 987654321, 5
    for cdt in (None, torch.bfloat16):
        pos, stats, qf, uf, gf = _fused_sampling_call_t(
            None, pg, data, q_t, u0, g0, imm, 0.3, seed, draws,
            max_num_expansions=4, collect_dtype=cdt,
        )
        q, u, g = q_t, u0, g0
        for t in range(draws):
            q, u, g, st = nuts_transition_plain(
                q, u, g, imm, 0.3, lambda x: pg(x, *data), max_exp=4,
                seed=(seed + t * DRAW_SEED_STRIDE) & MASK32,
            )
            assert torch.equal(stats[t], st)
            assert torch.equal(pos[t], q.to(pos.dtype))
        assert torch.equal(qf, q) and torch.equal(uf, u) and torch.equal(gf, g)


def test_loop_in_kernel_equals_per_draw_path():
    pg, data, q0 = _logistic_case()
    outs = []
    for loop in (True, False):
        gen = torch.Generator().manual_seed(11)
        outs.append(sample_fused_small(
            gen, None, data, q0, 6, 0.3, torch.ones(q0.shape[1]),
            max_num_expansions=4, potential_and_grad_t=pg,
            loop_in_kernel=loop,
        ))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_scan_path_matches_jax_sample_fused_small():
    """Injected per-draw streams drawn from the JAX run's own keys."""
    dim, points, chains, draws, max_exp, eps = 6, 48, 16, 6, 4, 0.3
    _, pg_j, data_j, _ = jax_pg_builder(dim=dim, num_points=points,
                                        matmul_dtype=jnp.float32)
    pg, data, q0 = _logistic_case(chains, dim, points)
    key = jax.random.PRNGKey(4)
    qf_j, pos_j, stats_j = jax_sample(
        key, lambda q_t, *d: pg_j(q_t, *d)[0], list(data_j),
        jnp.asarray(q0.numpy()), draws, jnp.asarray(eps, jnp.float32),
        jnp.ones(dim, jnp.float32), max_num_expansions=max_exp,
        block_chains=chains, internal_prng=False, potential_and_grad_t=pg_j,
        _interpret=True,
    )

    def streams(t):
        k1, k2, k3, k4 = jax.random.split(jax.random.split(key, draws)[t], 4)
        z = jax.random.normal(k1, (chains, dim), jnp.float32)
        u_dir = jax.random.uniform(k2, (chains, max_exp))
        dirs = jnp.where(u_dir < 0.5, -1.0, 1.0)
        ub = jax.random.uniform(k3, (chains, max_exp))
        ul = jax.random.uniform(k4, (chains, 2**max_exp))
        return tuple(np.array(a, F32) for a in (z, dirs, ub, ul))

    qf, pos, stats = sample_fused_small(
        None, None, data, q0, draws, eps, torch.ones(dim),
        max_num_expansions=max_exp, potential_and_grad_t=pg,
        internal_prng=False, streams=streams,
    )
    np.testing.assert_array_equal(stats.numpy()[..., 2:6],
                                  np.asarray(stats_j)[..., 2:6])
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), atol=1e-5)
    np.testing.assert_allclose(qf.numpy(), np.asarray(qf_j), atol=1e-5)


def test_cuda_path_takes_only_the_logistic_kernel_potential():
    """A CUDA tensor never falls back to the plain version: the logistic
    potential takes its hand-written functor, any other binds a functor
    generated from its traced gradient graph or raises before a launch.  ε
    is a scalar or a float32 ``(chains,)`` row on the chains' device; any
    other shape or dtype raises."""
    pg, data, q0 = _logistic_case()
    q_t = q0.T.contiguous()
    chains = q_t.shape[1]
    var = (torch.ones(q_t.shape[0], 1),)
    assert _check_cuda_args(_gaussian_pg, var, q_t, 0.3) == "generic"
    with pytest.raises(NotImplementedError,
                       match=r"aten\.special_bessel_j0"):
        _check_cuda_args(None, (), q_t, 0.3,  # outside the table
                         potential_fn_t=lambda q: torch.special.bessel_j0(
                             q).sum(0))
    row = torch.linspace(0.1, 0.4, chains)
    assert _check_cuda_args(logistic_pg_t, data, q_t, row) == "logistic"
    assert torch.equal(_eps_row(row, q_t), row)
    for bad in (torch.ones(chains // 2), torch.ones(1, chains),
                torch.ones(chains, dtype=torch.float64)):
        with pytest.raises(ValueError, match="per-chain"):
            _check_cuda_args(logistic_pg_t, data, q_t, bad)
    assert _check_cuda_args(logistic_pg_t, data, q_t, 0.3) == "logistic"
    assert _eps_row(torch.tensor(0.25), q_t) is None


@pytest.mark.parametrize(
    "tensor, error",
    [
        (torch.zeros(6, 16, dtype=torch.float64), TypeError),
        (torch.zeros(16, 6), ValueError),
        (torch.zeros(16, 6).T, ValueError),
    ],
)
def test_kernel_operand_checks(tensor, error):
    with pytest.raises(error):
        _build.require_f32_cuda("q", tensor, (6, 16), tensor.device)
