"""The XLA and pooled drivers against the JAX package, and the front door's
routes.

- ``window_adaptation.run`` and ``pooled_warmup`` drive the same
  deterministic stub kernel on both sides (positions a fixed function of the
  step, acceptance a fixed function of ε, the position and M⁻¹): the ε of
  every step (the stub's reported energy) and the final ε and M⁻¹ agree to
  1e-12 in float64, with and without the initial-ε search, diagonal and
  dense, and with ``per_chain_step_size``; the chain-batched warmup of
  ``sample_chains`` against the JAX ``vmap`` of the single-chain one.
- NUTS, HMC, MALA and GHMC on the correlated 2-D MVN (ρ 0.5), a chain
  batch: means, variances and the correlation pass the reference's MCSE
  z-test (p > 0.01), MCSE from the port's ``diagnostics.mcse``.
- ``aehmc_tpu_torch.sample``'s routing table: the JAX shapes of each route
  and every error that still raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import aehmc_tpu_torch
from aehmc_tpu import window_adaptation as jwa
from aehmc_tpu.parallel import pooled as jpooled
from aehmc_tpu.types import ChainState as JChainState
from aehmc_tpu.types import Diagnostics as JDiagnostics
from aehmc_tpu_torch import diagnostics, keys, sampling, window_adaptation
from aehmc_tpu_torch.metrics import PerChain
from aehmc_tpu_torch.models import mvn
from aehmc_tpu_torch.parallel import make_mesh, pooled, sample_sharded
from aehmc_tpu_torch.types import ChainState, Diagnostics

DIM = 3
FREQ = np.array([0.37, 0.71, 1.13])
SCALE = np.array([0.5, 1.5, 3.0])


def _stub_jax(key, state, eps, imm):
    u = state.potential_energy + 1.0
    q = jnp.sin(state.potential_energy_grad + u * FREQ) * SCALE
    accept = jax.nn.sigmoid(1.5 + 0.3 * q[0] - eps + 0.1 * jnp.sum(imm))
    info = JDiagnostics(accept, jnp.asarray(0, jnp.int32), jnp.asarray(False),
                        jnp.asarray(False), eps * jnp.ones_like(accept),
                        jnp.asarray(1, jnp.int32))
    return JChainState(q, u, state.potential_energy_grad), info


def _stub_torch(key, state, eps, imm):
    u = state.potential_energy + 1.0
    q = torch.sin(state.potential_energy_grad + u[..., None] * torch.tensor(
        FREQ)) * torch.tensor(SCALE)
    accept = torch.sigmoid(1.5 + 0.3 * q[..., 0] - eps + 0.1 * torch.sum(imm))
    zeros = torch.zeros(accept.shape, dtype=torch.int32)
    info = Diagnostics(accept, zeros, zeros.bool(), zeros.bool(),
                       eps * torch.ones_like(accept), zeros + 1)
    return ChainState(q, u, state.potential_energy_grad), info


def _close(a, b, rtol=1e-12):
    """Relative ``rtol``, an entry of a matrix relative to the largest (the
    Welford outer products of a dense M⁻¹ round their small off-diagonal
    entries apart in the last bits of the largest)."""
    a, b = np.asarray(a), np.asarray(b)
    atol = rtol * np.abs(a).max() if a.ndim == 2 else 1e-300
    np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("search", [False, True])
def test_window_adaptation_run_matches_jax(full, search):
    phase = np.array([0.1, 0.5, -0.3])
    jstate = JChainState(jnp.zeros(DIM), jnp.asarray(0.0), jnp.asarray(phase))
    tstate = ChainState(torch.zeros(DIM, dtype=torch.float64),
                        torch.tensor(0.0, dtype=torch.float64),
                        torch.tensor(phase))
    kw = dict(is_mass_matrix_full=full, initial_step_size=0.3,
              search_initial_step_size=search)
    jlast, (jeps, jimm), jinfo = jwa.run(jax.random.PRNGKey(0), _stub_jax,
                                         jstate, 200, **kw)
    tlast, (teps, timm), tinfo = window_adaptation.run(0, _stub_torch, tstate,
                                                       200, **kw)
    _close(jinfo.energy, tinfo.energy)  # the step size of every step
    _close(jinfo.acceptance_probability, tinfo.acceptance_probability)
    _close(jeps, teps)
    _close(jimm, timm)
    assert timm.shape == ((DIM, DIM) if full else (DIM,))
    _close(jlast.position, tlast.position)


def _stub_torch_per_chain(key, state, eps, imm):
    """``_stub_torch`` of a batch whose chains each have their own M⁻¹."""
    assert isinstance(imm, PerChain)
    u = state.potential_energy + 1.0
    q = torch.sin(state.potential_energy_grad + u[:, None] * torch.tensor(
        FREQ)) * torch.tensor(SCALE)
    accept = torch.sigmoid(1.5 + 0.3 * q[:, 0] - eps
                           + 0.1 * imm.inverse_mass_matrix.flatten(1).sum(1))
    zeros = torch.zeros(accept.shape, dtype=torch.int32)
    info = Diagnostics(accept, zeros, zeros.bool(), zeros.bool(),
                       eps * torch.ones_like(accept), zeros + 1)
    return ChainState(q, u, state.potential_energy_grad), info


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("search", [False, True])
def test_chain_batch_warmup_matches_jax_vmap(full, search):
    """``window_adaptation.run`` of a chain batch against the JAX package's
    ``vmap`` of the single-chain warmup: each chain's step-size search, dual
    averaging and Welford estimate, to 1e-12."""
    chains = 9
    phase = np.random.default_rng(1).normal(size=(chains, DIM))
    jstates = JChainState(jnp.zeros((chains, DIM)), jnp.zeros(chains),
                          jnp.asarray(phase))
    tstates = ChainState(torch.zeros(chains, DIM, dtype=torch.float64),
                         torch.zeros(chains, dtype=torch.float64),
                         torch.tensor(phase))
    kw = dict(is_mass_matrix_full=full, initial_step_size=0.3,
              search_initial_step_size=search)
    jlast, (jeps, jimm), jinfo = jax.vmap(
        lambda k, s: jwa.run(k, _stub_jax, s, 150, **kw))(
        jax.random.split(jax.random.PRNGKey(0), chains), jstates)
    tlast, (teps, timm), tinfo = window_adaptation.run(
        0, _stub_torch_per_chain, tstates, 150, **kw)
    assert teps.shape == (chains,)
    assert timm.shape == ((chains, DIM, DIM) if full else (chains, DIM))
    _close(np.asarray(jinfo.energy).T, tinfo.energy)
    _close(jeps, teps)
    for c in range(chains):
        _close(jimm[c], timm[c])
    _close(jlast.position, tlast.position)
    if search:  # the searches stop at different probes
        assert len(set(tinfo.energy[0].tolist())) > 1


@pytest.mark.parametrize("full, per_chain, search", [
    (False, False, True), (True, False, False), (False, True, True),
])
def test_pooled_warmup_matches_jax(full, per_chain, search):
    chains = 16
    rng = np.random.default_rng(0)
    phase = rng.normal(size=(chains, DIM))
    jstates = JChainState(jnp.zeros((chains, DIM)), jnp.zeros(chains),
                          jnp.asarray(phase))
    tstates = ChainState(torch.zeros(chains, DIM, dtype=torch.float64),
                         torch.zeros(chains, dtype=torch.float64),
                         torch.tensor(phase))
    kw = dict(is_mass_matrix_full=full, initial_step_size=0.3,
              search_initial_step_size=search, per_chain_step_size=per_chain)
    jout, (jeps, jimm), jinfo = jpooled.pooled_warmup(
        jax.random.PRNGKey(0), _stub_jax, jstates, 120, **kw)
    tout, (teps, timm), tinfo = pooled.pooled_warmup(0, _stub_torch, tstates,
                                                     120, **kw)
    # the JAX driver rounds the per-chain initial and searched step sizes
    # to float32 (aehmc_tpu/parallel/pooled.py:53-55, :140); the port keeps
    # the positions' dtype
    rtol = 1e-6 if per_chain else 1e-12
    _close(jinfo.energy, tinfo.energy, rtol)
    _close(jeps, teps, rtol)
    _close(jimm, timm, rtol)
    assert teps.shape == ((chains,) if per_chain else ())
    assert teps.dtype == torch.float64


def _mcse_z(samples):
    """``|mean| / mcse`` of each column of ``samples (chains, draws, k)``."""
    x = torch.as_tensor(samples)
    err, _ = diagnostics.mcse(x)
    return (x.reshape(-1, x.shape[-1]).mean(0) / err).numpy()


@pytest.mark.parametrize("algorithm", ["nuts", "hmc", "mala", "ghmc"])
def test_kernels_sample_the_correlated_mvn(algorithm):
    """The reference's tier-3 gate (tests/test_hmc.py:24-40) on a batch of
    64 chains: means, variances and the correlation within MCSE."""
    loc, scale, rho = np.array([0.0, 3.0]), np.array([1.0, 2.0]), 0.5
    cov = np.diag(scale**2)
    cov[0, 1] = cov[1, 0] = rho * scale[0] * scale[1]
    logprob_fn = mvn(loc, cov, torch.float64, device="cpu")
    # NUTS and HMC at the reference test's ε 1.0, M⁻¹ = scale and 30 steps
    kernel = sampling.make_kernel(logprob_fn, algorithm,
                                  num_integration_steps=30, ghmc_alpha=0.5)
    eps = {"nuts": 1.0, "hmc": 1.0, "mala": 0.8, "ghmc": 0.5}[algorithm]
    imm = torch.tensor(scale if algorithm in ("nuts", "hmc") else scale**2)
    gen = torch.Generator().manual_seed(1)
    q0 = torch.tensor(loc) + torch.randn(64, 2, generator=gen,
                                         dtype=torch.float64)
    state = sampling.new_sampler_state(algorithm, keys.Key(7), q0, logprob_fn)
    draws = 400 if algorithm in ("mala", "ghmc") else 250
    _, positions, infos = sampling.sample_loop(
        keys.Key(11), lambda k, s: kernel(k, s, eps, imm), state, draws)
    x = positions[50:].transpose(0, 1).numpy()  # (chains, draws, 2)
    delta = x - loc
    quantities = np.concatenate([
        delta, delta**2 - scale**2,
        (np.prod(delta, axis=-1) / np.prod(scale) - rho)[..., None],
    ], axis=-1)
    p = stats.norm.sf(np.abs(_mcse_z(quantities)))
    assert np.all(p > 0.01), p
    assert 0.5 < float(infos.acceptance_probability.mean()) < 1.0
    assert not bool(infos.is_diverging.any())


def _lp(q):
    return -0.5 * torch.sum(q * q / torch.tensor([1.0, 4.0, 0.25]).to(q),
                            dim=-1)


def test_front_door_one_chain_runs_stan_warmup_on_the_xla_path():
    res = aehmc_tpu_torch.sample(torch.Generator().manual_seed(0),
                                 lambda q: -0.5 * torch.sum(q * q),
                                 torch.zeros(10, dtype=torch.float64), 60, 60)
    assert res.positions.shape == (60, 10)
    assert res.positions.dtype == torch.float64
    assert res.step_size.ndim == 0 and res.inverse_mass_matrix.shape == (10,)
    assert res.diagnostics.acceptance_probability.shape == (60,)
    assert res.final_state.position.shape == (10,)
    assert bool(torch.isfinite(res.positions).all())
    # a scalar position is one chain too
    one = aehmc_tpu_torch.sample(1, lambda q: -0.5 * q * q,
                                 torch.tensor(0.5, dtype=torch.float64), 20,
                                 30, algorithm="hmc",
                                 num_integration_steps=4)
    assert one.positions.shape == (20,) and one.inverse_mass_matrix.ndim == 0


@pytest.mark.parametrize("algorithm", ["nuts", "hmc", "mala", "ghmc"])
def test_front_door_xla_batch_is_independent_chains(algorithm):
    q0 = torch.zeros(3, DIM, dtype=torch.float64)
    res = aehmc_tpu_torch.sample(5, _lp, q0, 12, 25, algorithm=algorithm,
                                 path="xla", num_integration_steps=4,
                                 is_mass_matrix_full=algorithm == "nuts")
    assert res.positions.shape == (3, 12, DIM)
    assert res.step_size.shape == (3,)
    assert res.inverse_mass_matrix.shape == (
        (3, DIM, DIM) if algorithm == "nuts" else (3, DIM))
    # chain 1 of the batch is the single-chain run at chain offset 1
    alone = sampling.sample(keys.Key(5, 1), _lp, q0[1], 12, 25,
                            algorithm=algorithm, num_integration_steps=4,
                            is_mass_matrix_full=algorithm == "nuts")
    assert torch.equal(alone.positions, res.positions[1])


@pytest.mark.parametrize("algorithm", ["nuts", "hmc", "mala", "ghmc", "chees"])
def test_front_door_pooled_routes(algorithm):
    gen = torch.Generator().manual_seed(3)
    q0 = torch.randn(32, DIM, generator=gen, dtype=torch.float64)

    def run(path):
        return aehmc_tpu_torch.sample(torch.Generator().manual_seed(4), _lp,
                                      q0, 30, 40, algorithm=algorithm,
                                      path=path, num_integration_steps=5)

    res = run("pooled")
    assert res.positions.shape == (30, 32, DIM)
    for field in res.diagnostics:
        assert field.shape == (30, 32)
    assert res.step_size.ndim == 0 and res.inverse_mass_matrix.shape == (DIM,)
    assert bool(torch.isfinite(res.positions).all())
    assert torch.equal(res.positions, run("pooled").positions)
    if algorithm == "chees":  # an ensemble method's XLA route is pooled
        assert torch.equal(res.positions, run("xla").positions)
    else:
        assert torch.equal(res.positions, run("auto").positions)


def test_pooled_per_chain_step_size_and_no_warmup():
    q0 = torch.zeros(8, DIM, dtype=torch.float64)
    res = sample_sharded(0, _lp, q0, 10, 30, per_chain_step_size=True)
    assert res.step_size.shape == (8,)
    assert len(set(res.step_size.tolist())) > 1
    cold = sample_sharded(0, _lp, q0, 10, 0, algorithm="mala",
                          initial_step_size=0.2, per_chain_step_size=True,
                          is_mass_matrix_full=False)
    assert torch.equal(cold.step_size, torch.full((8,), 0.2,
                                                  dtype=torch.float64))
    assert torch.equal(cold.inverse_mass_matrix, torch.ones(DIM,
                                                            dtype=torch.float64))
    dense = sample_sharded(0, _lp, q0, 5, 0, is_mass_matrix_full=True)
    assert dense.inverse_mass_matrix.shape == (DIM, DIM)


def test_front_door_errors_name_what_still_raises():
    q2 = torch.zeros(8, DIM, dtype=torch.float64)
    with pytest.raises(ValueError, match="chain-ensemble"):
        aehmc_tpu_torch.sample(0, _lp, torch.zeros(DIM), algorithm="chees")
    with pytest.raises(ValueError, match="chain-ensemble"):
        aehmc_tpu_torch.sample(0, _lp, torch.zeros(DIM), algorithm="meads")
    with pytest.raises(ValueError, match="8 chains do not shard over 3"):
        aehmc_tpu_torch.sample(0, _lp, q2, path="pooled",
                               mesh=make_mesh(devices=[torch.device("cpu")]
                                              * 3))
    bare = aehmc_tpu_torch.sample(torch.Generator().manual_seed(0), _lp, q2,
                                  4, 6, path="fused", max_num_expansions=3)
    assert bare.positions.shape == (4, 8, DIM)  # the generic fused binding
    with pytest.raises(ValueError, match="no fused megakernel"):
        aehmc_tpu_torch.sample(0, _lp, q2, algorithm="hmc", path="fused",
                               potential_fn_t=lambda q_t: q_t.sum(0))
    with pytest.raises(ValueError, match="logprob_fn"):
        aehmc_tpu_torch.sample(0, None, q2, path="pooled")
    with pytest.raises(ValueError, match="chains, dim"):
        aehmc_tpu_torch.sample(0, _lp, torch.zeros(2, 2, DIM), path="pooled")
    with pytest.raises(ValueError, match="MALA"):
        aehmc_tpu_torch.sample(0, _lp, q2, algorithm="mala", path="pooled",
                               is_mass_matrix_full=True)
    with pytest.raises(ValueError, match="requires checkpoint_path"):
        sample_sharded(0, _lp, q2, checkpoint_every=5)
    with pytest.raises(ValueError, match="divisible"):
        sample_sharded(0, _lp, q2[:6], algorithm="meads")
    with pytest.raises(ValueError, match="Unknown algorithm"):
        sampling.make_kernel(_lp, "x")
