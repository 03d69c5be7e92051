"""The port's standard-layout fused NUTS (aehmc_tpu_torch.ops.nuts_fused) and
the standard branch of its adaptive driver against the JAX kernel in
interpret mode and the NumPy oracle, on the same numpy inputs.

Decisions (doublings, leaves, divergent, turning) must be exactly equal and
positions agree to 1e-3 with the float64 oracle and the JAX kernel, as the
JAX package's own kernel tests hold them; with bfloat16 operands the port is
held to the JAX kernel run with bfloat16 operands.  The whole-run path
equals the per-draw path bit for bit, and with a Philox seed the standard
transition of q equals the transposed transition of qᵀ bit for bit.  The
CUDA kernels run only on a card: their tests are in ``test_torch_cuda.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu.ops import fused_driver as jax_driver
from aehmc_tpu.ops import nuts_fused as jax_nf
from aehmc_tpu.ops.nuts_oracle import (
    _logistic_grad,
    _logistic_potential,
    nuts_transition_oracle,
    nuts_transition_oracle_generic,
)
from aehmc_tpu_torch.ops import nuts_fused as nf
from aehmc_tpu_torch.ops.fused_driver import sample_fused_adaptive
from aehmc_tpu_torch.ops.nuts_fused_small import nuts_transition_plain

F32 = np.float32


def _case(seed, max_exp, chains=8, dim=8, n_points=32, scale=0.5):
    """The inputs of tests/test_nuts_fused.py:_run_case."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_points, dim)).astype(F32) / np.sqrt(dim)
    y = (rng.uniform(size=n_points) < 0.5).astype(F32)
    im = np.ones(dim, F32)
    q = rng.normal(size=(chains, dim)).astype(F32) * scale
    p = rng.normal(size=(chains, dim)).astype(F32)
    dirs = np.where(rng.uniform(size=(chains, max_exp)) < 0.5, -1.0,
                    1.0).astype(F32)
    ub = rng.uniform(size=(chains, max_exp)).astype(F32)
    ul = rng.uniform(size=(chains, 2**max_exp)).astype(F32)
    U = np.stack([_logistic_potential(q[i].astype(np.float64), X, y, 1.0)
                  for i in range(chains)]).astype(F32)
    G = np.stack([_logistic_grad(q[i].astype(np.float64), X, y, 1.0)
                  for i in range(chains)]).astype(F32)
    return X, y, im, q, p, dirs, ub, ul, U, G


def _both(case, eps, max_exp, matmul_dtype="float32"):
    X, y, im, q, p, dirs, ub, ul, U, G = case
    args = (q, U.reshape(-1, 1), G, p, dirs, ub, ul)
    jax_out = jax_nf.fused_nuts_transition(
        *map(jnp.asarray, args), jnp.asarray(X), jnp.asarray(y),
        jnp.asarray(im), eps, max_exp, block_chains=q.shape[0],
        interpret=True, matmul_dtype=getattr(jnp, matmul_dtype),
    )
    port = nf.fused_nuts_transition(
        *map(torch.tensor, args), torch.tensor(X), torch.tensor(y),
        torch.tensor(im), eps, max_exp,
        matmul_dtype=getattr(torch, matmul_dtype),
    )
    return ([o.numpy() for o in port], [np.asarray(o) for o in jax_out])


def _assert_decisions(stats_a, stats_b):
    np.testing.assert_array_equal(stats_a[:, 2:6], stats_b[:, 2:6])


REGIMES = [
    ("moderate", 0.25, 4, 0.5),
    ("deep", 0.05, 5, 0.5),
    ("turny", 0.8, 4, 0.5),
    ("divergent", 50.0, 4, 2.0),
    ("heterogeneous", 0.5, 5, 1.5),
    ("extreme", 1e8, 4, 3.0),
]


@pytest.mark.parametrize("name, eps, max_exp, scale", REGIMES)
def test_plain_transition_matches_oracle_and_jax(name, eps, max_exp, scale):
    for seed in ((9,) if name == "extreme" else (0, 1)):
        case = _case(seed, max_exp, scale=scale)
        X, y, im, q, p, dirs, ub, ul, _, _ = case
        port, ref = _both(case, eps, max_exp)
        qo, uo, go, stats = port
        assert qo.shape == q.shape and uo.shape == (8, 1) and stats.shape == (8, 8)
        _assert_decisions(stats, ref[3])
        np.testing.assert_allclose(qo, ref[0], atol=1e-3)
        np.testing.assert_allclose(stats[:, 1], ref[3][:, 1], atol=1e-3)
        for i in range(q.shape[0]):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                oracle = nuts_transition_oracle(q[i], p[i], X, y, im, eps,
                                                dirs[i], ub[i], ul[i], max_exp)
            assert int(stats[i, 2]) == oracle["num_doublings"], (seed, i)
            assert int(stats[i, 3]) == oracle["num_integration_steps"], (seed, i)
            assert int(stats[i, 4]) == int(oracle["is_diverging"]), (seed, i)
            assert int(stats[i, 5]) == int(oracle["is_turning"]), (seed, i)
            assert np.max(np.abs(qo[i] - oracle["position"])) < 1e-3, (seed, i)
            assert abs(stats[i, 1] - oracle["acceptance_probability"]) < 1e-3
        assert np.all(np.isfinite(stats))
        if name == "extreme":  # every chain diverges after one doubling
            assert np.all(stats[:, 4] == 1.0) and np.all(stats[:, 2] == 1.0)


@pytest.mark.parametrize("name, eps, max_exp, scale", REGIMES[:3])
def test_bf16_operands_match_jax_bf16(name, eps, max_exp, scale):
    for seed in (0, 1):
        case = _case(seed, max_exp, scale=scale)
        port, ref = _both(case, eps, max_exp, "bfloat16")
        _assert_decisions(port[3], ref[3])
        np.testing.assert_allclose(port[0], ref[0], atol=1e-3)
        np.testing.assert_allclose(port[1], ref[1], rtol=1e-4, atol=1e-4)
    # bfloat16 operands change the gradient, so the float32 run differs
    f32, _ = _both(case, eps, max_exp)
    assert not np.array_equal(f32[2], port[2])


def test_bf16_rounds_the_operands_only():
    """The plain bf16 potential is the float32 one on rounded operands, with
    the prior terms on the unrounded q."""
    X, y, _, q, *_ = _case(2, 4)
    data = nf._logistic_model(torch.tensor(X), torch.tensor(y), 1.0,
                              torch.bfloat16).data
    u16, g16 = nf._logistic_pot_grad(1.0, torch.bfloat16)(torch.tensor(q), *data)
    qr = torch.tensor(q).to(torch.bfloat16).float()
    logits = qr @ data[1].to(torch.bfloat16).float()
    resid = torch.sigmoid(logits) - data[2]
    g_ref = resid.to(torch.bfloat16).float() @ data[0].to(torch.bfloat16).float()
    assert torch.equal(g16, g_ref + torch.tensor(q))
    u32, _ = nf._logistic_pot_grad(1.0, torch.float32)(torch.tensor(q), *data)
    assert not torch.equal(u16, u32)
    with pytest.raises(ValueError, match="matmul_dtype"):
        nf._logistic_pot_grad(1.0, torch.float16)


def _gaussian(q, var_row):
    return 0.5 * torch.sum(q * q / var_row, dim=-1)


@pytest.mark.parametrize("eps, max_exp", [(0.3, 4), (0.9, 4), (25.0, 4)])
def test_generic_transition_with_autograd_matches_jax_and_oracle(eps, max_exp):
    rng = np.random.default_rng(4)
    chains, dim = 8, 6
    var = rng.uniform(0.5, 2.0, size=dim).astype(F32)
    im = np.ones(dim, F32)
    q = rng.normal(size=(chains, dim)).astype(F32)
    p = rng.normal(size=(chains, dim)).astype(F32)
    dirs = np.where(rng.uniform(size=(chains, max_exp)) < 0.5, -1.0,
                    1.0).astype(F32)
    ub = rng.uniform(size=(chains, max_exp)).astype(F32)
    ul = rng.uniform(size=(chains, 2**max_exp)).astype(F32)
    U = (0.5 * np.sum(q.astype(np.float64)**2 / var, -1)).astype(F32)
    G = (q.astype(np.float64) / var).astype(F32)
    args = (q, U.reshape(-1, 1), G, p, dirs, ub, ul, im)
    port = nf.make_fused_nuts_transition(
        _gaussian, (torch.tensor(var).reshape(1, -1),),
        max_num_expansions=max_exp)(*map(torch.tensor, args), eps)
    ref = jax_nf.make_fused_nuts_transition(
        lambda x, v: 0.5 * jnp.sum(x * x / v, axis=-1),
        (jnp.asarray(var).reshape(1, -1),), max_num_expansions=max_exp,
        block_chains=chains, interpret=True)(*map(jnp.asarray, args), eps)
    _assert_decisions(port[3].numpy(), np.asarray(ref[3]))
    np.testing.assert_allclose(port[0].numpy(), np.asarray(ref[0]), atol=1e-5)
    for i in range(chains):
        oracle = nuts_transition_oracle_generic(
            lambda x: 0.5 * np.sum(x * x / var), lambda x: x / var,
            q[i], p[i], im, eps, dirs[i], ub[i], ul[i], max_exp)
        assert int(port[3][i, 3]) == oracle["num_integration_steps"], i
        np.testing.assert_allclose(port[0][i].numpy(), oracle["position"],
                                   atol=1e-3)


def test_logistic_potential_is_the_logistic_transition():
    """The generic builder on ``logistic_potential`` (autograd) makes the
    logistic transition's decisions."""
    X, y, im, q, p, dirs, ub, ul, U, G = _case(1, 4)
    data = nf._logistic_model(torch.tensor(X), torch.tensor(y), 1.0,
                              torch.float32).data
    args = [torch.tensor(a) for a in (q, U.reshape(-1, 1), G, p, dirs, ub, ul,
                                      im)]
    generic = nf.make_fused_nuts_transition(nf.logistic_potential, data,
                                            max_num_expansions=4)(*args, 0.25)
    direct = nf.fused_nuts_transition(*args[:7], torch.tensor(X),
                                      torch.tensor(y), args[7], 0.25, 4)
    _assert_decisions(generic[3].numpy(), direct[3].numpy())
    np.testing.assert_allclose(generic[0].numpy(), direct[0].numpy(), atol=1e-5)
    np.testing.assert_allclose(
        nf.logistic_potential(torch.tensor(q), *data).numpy(), U, rtol=1e-5)


def test_philox_standard_transition_is_the_transposed_one_bitwise():
    X, y, im, q, *_, U, G = _case(3, 5, chains=16)
    model = nf._logistic_model(torch.tensor(X), torch.tensor(y), 1.0,
                               torch.float32)

    def pot_grad_t(x_t):  # the same function on the transposed view
        u, g = model.pot_grad(x_t.T)
        return u.reshape(1, -1), g.T

    q, U, G, im = map(torch.tensor, (q, U, G, im))
    std = nf.nuts_transition_std_plain(q, U, G, im, 0.3, model.pot_grad,
                                       max_exp=5, seed=2024)
    tr = nuts_transition_plain(q.T.contiguous(), U.reshape(1, -1),
                               G.T.contiguous(), im, 0.3, pot_grad_t,
                               max_exp=5, seed=2024)
    for a, b in zip(std, tr):
        assert torch.equal(a, b.T.reshape(a.shape))


def _logistic_run(loop, internal=True, generic=False, draws=6):
    X, y, im, q, *_ = _case(5, 4, chains=16)
    gen = torch.Generator().manual_seed(11)
    common = dict(max_num_expansions=4, internal_prng=internal,
                  loop_in_kernel=loop)
    if generic:
        data = nf._logistic_model(torch.tensor(X), torch.tensor(y), 1.0,
                                  torch.float32).data
        return nf.sample_fused(gen, nf.logistic_potential, data,
                               torch.tensor(q), draws, 0.3, torch.tensor(im),
                               **common)
    return nf.sample_fused_logistic(gen, torch.tensor(X), torch.tensor(y),
                                    torch.tensor(q), draws, 0.3,
                                    torch.tensor(im), **common)


@pytest.mark.parametrize("generic", [False, True])
def test_loop_in_kernel_equals_per_draw_path(generic):
    whole, per_draw = (_logistic_run(loop, generic=generic)
                       for loop in (True, False))
    for a, b in zip(whole, per_draw):
        assert torch.equal(a, b)
    qf, pos, stats = whole
    assert pos.shape == (6, 16, 8) and stats.shape == (6, 16, 8)
    assert torch.equal(qf, pos[-1])


def test_external_streams_match_jax_sample_fused_logistic():
    """``internal_prng=False`` with the streams the JAX loop draws from its
    keys (nuts_fused.py:1150-1160), bfloat16 operands on both sides."""
    X, y, im, q, *_ = _case(6, 4, chains=16)
    X = X.astype(F32)
    draws, max_exp, eps = 5, 4, 0.3
    key = jax.random.PRNGKey(8)
    orig = jax_nf.fused_nuts_transition

    def interpret(*args, **kwargs):
        return orig(*args, **{**kwargs, "interpret": True})

    jax_nf.fused_nuts_transition = interpret
    try:
        qf_j, pos_j, stats_j = jax_nf.sample_fused_logistic(
            key, jnp.asarray(X), jnp.asarray(y), jnp.asarray(q), draws,
            jnp.float32(eps), jnp.asarray(im), max_num_expansions=max_exp,
            block_chains=16)
    finally:
        jax_nf.fused_nuts_transition = orig

    def streams(phase, t):
        assert phase == "sample"
        k1, k2, k3, k4 = jax.random.split(jax.random.split(key, draws)[t], 4)
        z = jax.random.normal(k1, (16, 8), jnp.float32)
        dirs = jnp.where(jax.random.uniform(k2, (16, max_exp)) < 0.5, -1.0, 1.0)
        ub = jax.random.uniform(k3, (16, max_exp))
        ul = jax.random.uniform(k4, (16, 2**max_exp))
        return tuple(np.array(a, F32) for a in (z, dirs, ub, ul))

    qf, pos, stats = nf.sample_fused_logistic(
        streams, torch.tensor(X), torch.tensor(y), torch.tensor(q), draws, eps,
        torch.tensor(im), max_num_expansions=max_exp)
    np.testing.assert_array_equal(stats.numpy()[..., 2:6],
                                  np.asarray(stats_j)[..., 2:6])
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), atol=1e-3)
    np.testing.assert_allclose(qf.numpy(), np.asarray(qf_j), atol=1e-3)


def _jax_driver_streams(key, num_warmup, num_samples, chains, dim, max_exp):
    """The raw streams the JAX driver draws with ``use_internal_prng=False``:
    ``warmup_key, sample_key = split(key)``, then ``split(…)[1]`` of each
    split into per-step keys (fused_driver.py:851-967, :438-460)."""
    warmup_key, sample_key = jax.random.split(key)

    def per_step(k, n):
        out = []
        for kk in jax.random.split(jax.random.split(k)[1], n):
            k1, k2, k3, k4 = jax.random.split(kk, 4)
            z = jax.random.normal(k1, (chains, dim), jnp.float32)
            dirs = jnp.where(jax.random.uniform(k2, (chains, max_exp)) < 0.5,
                             -1.0, 1.0)
            ub = jax.random.uniform(k3, (chains, max_exp))
            ul = jax.random.uniform(k4, (chains, 2**max_exp))
            out.append(tuple(np.array(a, F32) for a in (z, dirs, ub, ul)))
        return out

    return per_step(warmup_key, num_warmup), per_step(sample_key, num_samples)


def _jax_logistic_potential(x, X, XT, y_row):
    logits = x @ XT
    sp = jnp.maximum(logits, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(logits)))
    return -jnp.sum(y_row * logits - sp, axis=-1) + 0.5 * jnp.sum(x * x, axis=-1)


def test_standard_branch_of_the_driver_matches_jax():
    X, y, _, q, *_ = _case(7, 4, chains=16, dim=6, n_points=48, scale=0.1)
    X = X.astype(F32)
    warmup, draws, max_exp = 25, 6, 4
    y_row = y.reshape(1, -1)
    key = jax.random.PRNGKey(12)
    qf_j, pos_j, stats_j, eps_j, imm_j = jax_driver.sample_fused_adaptive(
        key, _jax_logistic_potential,
        (jnp.asarray(X), jnp.asarray(X.T), jnp.asarray(y_row)),
        jnp.asarray(q), draws, warmup, max_num_expansions=max_exp,
        block_chains=16, use_internal_prng=False, interpret=True,
        initial_step_size=0.1,
    )
    w_streams, s_streams = _jax_driver_streams(key, warmup, draws, 16, 6,
                                               max_exp)
    data = (torch.tensor(X), torch.tensor(X.T).contiguous(),
            torch.tensor(y_row))
    streams = dict(warmup=w_streams, sample=s_streams)
    qf, pos, stats, eps, imm = sample_fused_adaptive(
        lambda phase, t: streams[phase][t], nf.logistic_potential, data,
        torch.tensor(q), draws, warmup, max_num_expansions=max_exp,
        use_internal_prng=False, initial_step_size=0.1, block_chains=256,
    )
    np.testing.assert_allclose(float(eps), float(eps_j), rtol=1e-4)
    np.testing.assert_allclose(imm.numpy(), np.asarray(imm_j), rtol=1e-4)
    np.testing.assert_array_equal(stats.numpy()[..., 2:6],
                                  np.asarray(stats_j)[..., 2:6])
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), atol=1e-4)
    np.testing.assert_allclose(qf.numpy(), np.asarray(qf_j), atol=1e-4)
    assert pos.shape == (draws, 16, 6) and stats.shape == (draws, 16, 8)


@pytest.mark.parametrize("option, match", [
    (dict(is_mass_matrix_full=True), "dense"),
    (dict(step_size_factors=torch.ones(16)), "step_size_factors"),
    (dict(per_chain_step_size=True), "per_chain_step_size"),
    (dict(loop_in_kernel=True), "loop_in_kernel"),
])
def test_standard_branch_rules(option, match):
    with pytest.raises(ValueError, match=match):
        sample_fused_adaptive(None, nf.logistic_potential, (), torch.zeros(16, 4),
                              2, 2, **option)


def _key_source(phase, index):
    raise AssertionError("a key source must not be read under Philox")


@pytest.mark.parametrize("call", [
    lambda: sample_fused_adaptive(_key_source, nf.logistic_potential, (),
                                  torch.zeros(16, 4), 2, 2),
    lambda: nf.sample_fused_logistic(_key_source, torch.zeros(8, 4),
                                     torch.zeros(8), torch.zeros(16, 4), 2,
                                     0.1, torch.ones(4), internal_prng=True),
    lambda: nf.sample_fused_logistic(_key_source, torch.zeros(8, 4),
                                     torch.zeros(8), torch.zeros(16, 4), 2,
                                     0.1, torch.ones(4), loop_in_kernel=True),
], ids=["driver", "internal_prng", "loop_in_kernel"])
def test_a_key_source_replays_external_streams_only(call):
    """A key source ``(phase, index) -> streams`` stands for a generator only
    with external randomness; under Philox it is refused before any draw."""
    with pytest.raises(TypeError, match="key source"):
        call()


def test_cuda_path_takes_the_logistic_potential_only():
    """The logistic potential takes the hand-written functor of kernels 3
    and 4 (``_check_card`` gives no generated one); any other binds a
    generated functor in the standard layout, or raises."""
    model = nf._generic_model(_gaussian, (torch.ones(1, 4),))
    bound = nf._check_card(model, torch.zeros(8, 4))
    assert bound.ir.layout == "std" and bound.ir.dim == 4
    solve = nf._generic_model(  # a Bessel function: outside the table
        lambda q: torch.special.bessel_j0(q).sum(1), ())
    with pytest.raises(NotImplementedError, match=r"aten\.special_bessel_j0"):
        nf._check_card(solve, torch.zeros(8, 4))
    X = torch.zeros(16, 4)
    logistic = nf._logistic_model(X, torch.zeros(16), 1.0, torch.bfloat16)
    assert logistic.card == (1.0, True)
    with pytest.raises(TypeError, match="float32"):
        nf._check_card(logistic, torch.zeros(8, 4, dtype=torch.float64))
    assert nf._generic_model(nf.logistic_potential, logistic.data).card == (
        1.0, False)
