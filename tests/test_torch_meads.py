"""The port's MEADS (aehmc_tpu_torch.meads, ghmc.new_noise_kernel) against
the JAX package, and the JAX package's MEADS gates run on the port.

Parity is in float64 on the same numpy inputs, to 1e-12 relative: the
eigenvalue estimate on both of its branches (the explicit covariance at
dim 3, the matrix-free form at dim 600), the cross-fold estimation
(including coincident chains and the degenerate fallback), the noise
kernel and the fold transition fed the JAX run's normals and uniforms, and
whole ``meads.sample`` runs at ``recompute_every`` 1 and 8 fed the JAX run's
streams through a ``(phase, index) -> (z, u)`` key source.
"""

import numpy as np
import pytest
import scipy.stats as stats
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu import ghmc as jax_ghmc
from aehmc_tpu import meads as jax_meads
from aehmc_tpu.types import IntegratorState as JaxState
from aehmc_tpu_torch import diagnostics, ghmc, meads
from aehmc_tpu_torch.metrics import PerChain
from aehmc_tpu_torch.parallel import sample_sharded
from aehmc_tpu_torch.types import IntegratorState

F64 = np.float64
RTOL = 1e-12
VAR = np.array([1.0, 4.0, 0.25])


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, F64), np.asarray(b, F64),
                               rtol=rtol, atol=atol)


def _lp_jax(q):
    return -0.5 * jnp.sum(q * q / jnp.asarray(VAR))


def _lp_torch(q):
    return -0.5 * torch.sum(q * q / torch.tensor(VAR))


@pytest.mark.parametrize("dim", [3, 600])
@pytest.mark.parametrize("center", [True, False])
def test_lmax_cov_matches_jax_on_both_branches(dim, center):
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(64, dim)) * np.linspace(0.5, 2.0, dim) + 0.3
    ref = float(jax_meads._lmax_cov(jnp.asarray(x), center=center))
    out = meads._lmax_cov(torch.tensor(x), center=center)
    assert out.shape == () and out.dtype == torch.float64
    _close(out, ref)
    # batched over a leading (fold) axis: each row is its own estimate
    stacked = meads._lmax_cov(torch.tensor(np.stack([x, 2.0 * x])),
                              center=center)
    _close(stacked, [ref, 4.0 * ref])


def _states(q, g, p=None, u=None):
    chains = q.shape[0]
    p = np.zeros_like(q) if p is None else p
    u = np.zeros(chains) if u is None else u
    return (JaxState(jnp.asarray(q), jnp.asarray(p), jnp.asarray(u),
                     jnp.asarray(g)),
            IntegratorState(torch.tensor(q), torch.tensor(p), torch.tensor(u),
                            torch.tensor(g)))


def _degenerate_inputs(rng):
    q = rng.normal(size=(32, 5))
    q[:, 1] = 0.7  # one coincident coordinate in every fold
    q[16:24] = q[16]  # fold 2 all at one point (fold 3 estimates from it)
    return q, rng.normal(size=(32, 5))


@pytest.mark.parametrize("case", ["random", "coincident", "degenerate"])
def test_estimate_hyperparams_matches_jax(case):
    rng = np.random.default_rng(1)
    if case == "random":
        q, g = rng.normal(size=(32, 5)) * 2.0, rng.normal(size=(32, 5))
    elif case == "coincident":
        q = np.tile([0.5, 2.0, -1.0, 0.0, 3.0], (32, 1))
        g = q / 2.0
    else:
        q, g = _degenerate_inputs(rng)
    js, ts = _states(q, g)
    ref = jax_meads.estimate_hyperparams(js, num_folds=4)
    out = meads.estimate_hyperparams(ts, num_folds=4)
    assert isinstance(out, meads.MeadsHyperparams)
    assert out.step_size.shape == (4,) and out.inverse_mass_matrix.shape == (
        4, 5)
    for a, b in zip(out, ref):
        _close(a, b)
    if case != "random":
        # the fallback: identity where the chains coincide, finite eps
        sigma2 = out.inverse_mass_matrix.numpy()
        assert np.all(sigma2[:, 1] == 1.0) or case == "degenerate"
        assert np.all(np.isfinite(out.step_size.numpy()))
    if case == "degenerate":
        assert np.all(out.inverse_mass_matrix.numpy()[3] == 1.0)
        assert np.all(out.inverse_mass_matrix.numpy()[:, 1] == 1.0)


def test_noise_kernel_matches_jax():
    rng = np.random.default_rng(2)
    chains, dim = 16, 3
    q, p = rng.normal(size=(chains, dim)), rng.normal(size=(chains, dim))
    noise, uniform = rng.normal(size=(chains, dim)), rng.uniform(size=chains)
    eps = rng.uniform(0.2, 1.5, size=chains)
    alpha = rng.uniform(0.1, 0.95, size=chains)
    imm = rng.uniform(0.5, 2.0, size=(chains, dim))
    eps[3] = 40.0  # a divergent proposal
    uniform[5] = 0.0  # a sure accept
    jstep = jax_ghmc.new_noise_kernel(_lp_jax, 50.0)
    jstate = jax.vmap(lambda x: jax_ghmc.new_state(
        jax.random.PRNGKey(0), x, _lp_jax))(jnp.asarray(q))
    jstate = jstate._replace(momentum=jnp.asarray(p))
    ref_state, ref_info = jax.vmap(jstep)(
        jnp.asarray(noise), jnp.asarray(uniform), jstate, jnp.asarray(eps),
        jnp.asarray(alpha), jnp.asarray(imm))
    step = ghmc.new_noise_kernel(_lp_torch, 50.0)
    tstate = ghmc.new_state(0, torch.tensor(q), _lp_torch)._replace(
        momentum=torch.tensor(p))
    out_state, out_info = step(torch.tensor(noise), torch.tensor(uniform),
                               tstate, torch.tensor(eps), torch.tensor(alpha),
                               PerChain(torch.tensor(imm)))
    for a, b in zip(out_state, ref_state):
        _close(a, b, atol=1e-14)
    for a, b in zip(out_info, ref_info):
        _close(a, b, atol=1e-14)
    assert bool(out_info.is_diverging[3])
    # a single chain with a shared diagonal metric: the same per-chain step
    one_state, _ = step(torch.tensor(noise[0]), torch.tensor(uniform[0]),
                        IntegratorState(*(x[0] for x in tstate)),
                        float(eps[0]), float(alpha[0]), torch.tensor(imm[0]))
    for a, b in zip(one_state, out_state):
        _close(a, b[0])


def _fold_inputs(rng, chains=16, dim=3):
    q = rng.normal(size=(chains, dim))
    js, ts = _states(q, q / VAR, p=rng.normal(size=(chains, dim)),
                     u=0.5 * np.sum(q * q / VAR, axis=1))
    return js, ts


def _jax_fold_streams(key, chains, dim, num_folds=4):
    """The normals and uniforms the JAX fold transition draws from ``key``,
    flat ``(chains, dim)`` and ``(chains,)``."""
    noise_key, accept_key = jax.random.split(key)
    per_fold = chains // num_folds
    z = jax.random.normal(noise_key, (num_folds, per_fold, dim), jnp.float64)
    u = jax.random.uniform(accept_key, (num_folds, per_fold), jnp.float64)
    return (torch.tensor(np.asarray(z).reshape(chains, dim)),
            torch.tensor(np.asarray(u).reshape(chains)))


def test_fold_transition_matches_jax():
    rng = np.random.default_rng(3)
    js, ts = _fold_inputs(rng)
    hyper_j = jax_meads.estimate_hyperparams(js)
    hyper_t = meads.estimate_hyperparams(ts)

    def fold(a):
        return a.reshape((4, 4) + tuple(a.shape[1:]))

    key = jax.random.PRNGKey(7)
    ref_states, ref_info = jax_meads._make_fold_transition(_lp_jax)(
        key, jax.tree_util.tree_map(fold, js), hyper_j)
    out_states, out_info = meads._make_fold_transition(_lp_torch)(
        _jax_fold_streams(key, 16, 3),
        IntegratorState(*(fold(a) for a in ts)), hyper_t)
    assert out_states.position.shape == (4, 4, 3)
    assert out_info.acceptance_probability.shape == (4, 4)
    for a, b in zip(out_states, ref_states):
        _close(a, b, atol=1e-14)
    for a, b in zip(out_info, ref_info):
        _close(a, b, atol=1e-14)


def _jax_key_source(key, chains, dim, num_warmup, num_samples, every):
    """The JAX ``meads.sample``'s streams as a port key source."""
    init_key, warm_key, sample_key = jax.random.split(key, 3)
    z0 = jax.vmap(lambda k: jax.random.normal(k, (dim,), jnp.float64))(
        jax.random.split(init_key, chains))
    init = (torch.tensor(np.asarray(z0)),
            torch.zeros(chains, dtype=torch.float64))
    if every > 1:
        num_warmup = -(-num_warmup // every) * every
        num_samples = -(-num_samples // every) * every
    phase_keys = {"warmup": jax.random.split(warm_key, num_warmup),
                  "sample": jax.random.split(sample_key, num_samples)}

    def source(phase, index):
        if phase == "init":
            return init
        return _jax_fold_streams(phase_keys[phase][index], chains, dim)

    return source


@pytest.mark.parametrize("every", [1, 8])
def test_whole_sample_follows_jax(every):
    """20 burn-in and 20 draws of 16 chains on N(0, diag(1, 4, 1/4)) fed
    the JAX run's streams: positions, diagnostics and the last
    hyperparameters equal to 1e-12 relative (1e-13 absolute where a
    coordinate is near 0)."""
    rng = np.random.default_rng(4)
    q0 = rng.normal(size=(16, 3))
    key = jax.random.PRNGKey(11)
    ref = jax_meads.sample(key, _lp_jax, jnp.asarray(q0), 20, 20,
                           recompute_every=every)
    out = meads.sample(_jax_key_source(key, 16, 3, 20, 20, every), _lp_torch,
                       torch.tensor(q0), 20, 20, recompute_every=every)
    final_ref, pos_ref, info_ref, hyper_ref = ref
    final, pos, info, hyper = out
    assert pos.shape == (20, 16, 3)
    _close(pos, pos_ref, atol=1e-13)
    for a, b in zip(final, final_ref):
        _close(a, b, atol=1e-13)
    np.testing.assert_array_equal(info.is_diverging.numpy(),
                                  np.asarray(info_ref.is_diverging))
    _close(info.acceptance_probability, info_ref.acceptance_probability,
           atol=1e-13)
    for a, b in zip(hyper, hyper_ref):
        _close(a, b)


# --- the JAX package's gates (tests/test_meads.py) on the port ----------

def _mvn_model():
    loc = np.array([0.0, 3.0])
    scale = np.array([1.0, 2.0])
    rho = 0.5
    cov = np.diag(scale**2)
    cov[0, 1] = cov[1, 0] = rho * scale[0] * scale[1]
    precision = torch.tensor(np.linalg.inv(cov))
    loc_t = torch.tensor(loc)

    def logprob_fn(q):
        d = q - loc_t
        return -0.5 * d @ precision @ d

    return (loc, scale, rho), logprob_fn


def _assert_mcse_multichain(pos, loc, scale, rho):
    """Stan-wiki MCSE z-tests with chain-aware ESS."""
    x = np.swapaxes(pos.numpy(), 0, 1)  # (chains, draws, dim)

    def gate(delta):
        ess = diagnostics.effective_sample_size(torch.tensor(delta)).numpy()
        pooled = delta.reshape((-1,) + delta.shape[2:])
        mcse = pooled.std(axis=0, ddof=1) / np.sqrt(ess)
        p = stats.norm.sf(np.abs(pooled.mean(axis=0)) / mcse)
        np.testing.assert_array_less(0.01, p)

    gate(x - loc)
    gate(np.square(x - loc) - scale**2)
    gate(np.prod(x - loc, axis=-1) / np.prod(scale) - rho)


@pytest.mark.parametrize("every", [1, 8])
def test_statistical_correctness(every):
    """The correlated 2-D MVN: MCSE z-tests on the mean, the variance and
    the correlation, per-step and amortized (JAX tests/test_meads.py:81,
    :140)."""
    (loc, scale, rho), logprob_fn = _mvn_model()
    positions = torch.tensor(np.random.default_rng(5).normal(size=(64, 2)))
    _, pos, infos, _ = meads.sample(6, logprob_fn, positions, 600, 600,
                                    recompute_every=every)
    _assert_mcse_multichain(pos, loc, scale, rho)
    assert not bool(infos.is_diverging.any())


def test_amortized_kernel_keeps_the_estimate_between_recomputations():
    """``recompute_every=3`` holds the step-0 estimate for steps 1 and 2 and
    re-estimates at step 3, where the per-step kernel differs."""
    logprob_fn = _lp_torch
    positions = torch.tensor(np.random.default_rng(0).normal(size=(16, 3)))
    carry0 = meads.init_carry(1, positions, logprob_fn)
    k_every = meads.new_kernel(logprob_fn, num_folds=4)
    k_amort = meads.new_kernel(logprob_fn, num_folds=4, recompute_every=3)
    ca, cb = carry0, carry0
    for i in range(4):
        ca, _ = k_every(10 + i, ca)
        cb, _ = k_amort(10 + i, cb)
        if i == 0:
            assert torch.equal(ca.states.position, cb.states.position)
            hyper0 = cb.hyper
        if 0 < i < 3:
            for a, b in zip(hyper0, cb.hyper):
                assert torch.equal(a, b)
    assert cb.step == 4
    assert not torch.equal(hyper0.step_size, cb.hyper.step_size)


def test_rejects_bad_fold_split():
    with pytest.raises(ValueError, match="divisible"):
        meads.sample(0, _lp_torch, torch.zeros(6, 3, dtype=torch.float64),
                     10, 10)


def test_step_size_respects_stability_limit():
    """On N(0, diag(1, 4, 1/4)) preconditioning whitens the target, so eps
    settles near the multiplier 0.5 (JAX tests/test_meads.py:103)."""
    positions = torch.tensor(np.random.default_rng(3).normal(size=(32, 3)))
    _, _, _, hyper = meads.sample(4, _lp_torch, positions, 50, 500)
    eps = hyper.step_size.numpy()
    assert np.all(eps > 0.2) and np.all(eps < 1.0), eps


def test_recovers_from_coincident_inits():
    """Every chain at one point: the fallback keeps eps finite and the fleet
    disperses (JAX tests/test_meads.py:156)."""
    (loc, scale, rho), logprob_fn = _mvn_model()
    positions = torch.tensor([[0.5, 2.0]], dtype=torch.float64).repeat(16, 1)
    _, pos, infos, hyper = meads.sample(12, logprob_fn, positions, 200, 200)
    assert bool(torch.isfinite(hyper.step_size).all())
    assert bool((hyper.step_size < 10.0).all())
    assert float(infos.is_diverging.double().mean()) < 0.05
    pooled = pos.reshape(-1, 2).numpy()
    assert np.all(pooled.std(axis=0) > 0.3)


def test_through_sample_sharded():
    """Shapes, R-hat and the folded hyperparameters' means (JAX
    tests/test_meads.py:177)."""
    (loc, scale, rho), logprob_fn = _mvn_model()
    positions = torch.tensor(np.random.default_rng(7).normal(size=(16, 2)))
    result = sample_sharded(8, logprob_fn, positions, num_samples=400,
                            num_warmup=400, algorithm="meads")
    assert result.positions.shape == (400, 16, 2)
    assert result.diagnostics.acceptance_probability.shape == (400, 16)
    rhat = diagnostics.potential_scale_reduction(
        result.positions.transpose(0, 1))
    assert np.all(np.abs(rhat.numpy() - 1.0) < 0.2)
    assert float(result.step_size) > 0
    assert result.inverse_mass_matrix.shape == (2,)


def test_segmented_sample_trims_and_rounds_segments_up():
    """10 draws at ``recompute_every`` 4: three segments, trimmed to 10;
    a key replays bit for bit."""
    positions = torch.tensor(np.random.default_rng(9).normal(size=(8, 3)))
    a = meads.sample(3, _lp_torch, positions, 10, 5, recompute_every=4)
    b = meads.sample(3, _lp_torch, positions, 10, 5, recompute_every=4)
    assert a[1].shape == (10, 8, 3)
    assert a[2].acceptance_probability.shape == (10, 8)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert torch.equal(a[1], b[1])
