"""The port's ChEES adaptation (aehmc_tpu_torch.chees), its initial
step-size search, the one-call fused driver and the ``algorithm="chees"``
front door against the JAX package, on the same numpy inputs.

The drivers run the JAX kernel in interpret mode with
``use_internal_prng=False``; the port is fed the normals and uniforms the
JAX run draws from its keys (the search probes, the warmup steps and the
draws), through its ``(phase, index) -> key`` source.  Over a 60-step
warmup and 40 draws, each step started from the JAX run's state, the trip
count L must be identical and ε, h, M⁻¹ and the positions agree to rtol
1e-4 / atol 1e-4 (float32 chains, reductions in another order, and the
multiply-adds XLA contracts).  ``halton`` is bit for bit, the search result
exactly equal.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aehmc_tpu
import aehmc_tpu_torch
from aehmc_tpu import chees as jax_chees
from aehmc_tpu import step_size as jax_step_size
from aehmc_tpu.ops import chees_fused as jax_cf
from aehmc_tpu.types import ChainState as JaxChainState
from aehmc_tpu_torch import chees, convert, hmc
from aehmc_tpu_torch.ops import chees_fused
from aehmc_tpu_torch.parallel import make_mesh, sample_sharded
from aehmc_tpu_torch.step_size import find_reasonable_step_size
from aehmc_tpu_torch.types import ChainState, DualAveragingState, WelfordState

F32 = np.float32
CHAINS, DIM, WARMUP, DRAWS = 32, 5, 60, 40
VAR = np.linspace(0.5, 2.0, DIM).astype(F32)


def test_halton_is_bitwise_the_jax_sequence():
    idx = np.arange(4096)
    ref = np.asarray(jax_chees.halton(jnp.asarray(idx, jnp.int32)))
    np.testing.assert_array_equal(chees.halton(torch.tensor(idx)).numpy(), ref)
    np.testing.assert_array_equal(
        np.array([float(chees.halton(int(i))) for i in idx[:300]], F32),
        ref[:300])


def _random_info(rng, chains=64, dim=7):
    q = rng.normal(size=(chains, dim)).astype(F32)
    info = dict(
        acceptance_probability=rng.uniform(size=chains).astype(F32),
        is_diverging=np.zeros(chains, bool),
        proposed_position=(q + rng.normal(size=(chains, dim))).astype(F32),
        proposed_velocity=rng.normal(size=(chains, dim)).astype(F32),
        num_integration_steps=np.int32(3),
        energy=np.zeros(chains, F32),
    )
    info["proposed_position"][5, 2] = np.inf  # a non-finite term: weight 0
    return q, info


def test_chees_gradient_matches_jax():
    q, info = _random_info(np.random.default_rng(0))
    jax_grad = jax_chees._chees_gradient(
        jnp.asarray(q),
        jax_chees.CheesInfo(**{k: jnp.asarray(v) for k, v in info.items()}),
        jnp.float32(0.375))
    port_grad = chees._chees_gradient(
        torch.tensor(q),
        chees.CheesInfo(**{k: torch.tensor(v) for k, v in info.items()}), 0.375)
    assert np.isfinite(float(port_grad))
    np.testing.assert_allclose(float(port_grad), float(jax_grad), rtol=1e-5)


def test_adam_update_matches_jax():
    grads = np.random.default_rng(1).normal(size=12).astype(F32) * 3
    zero_j = jnp.zeros((), jnp.float32)
    state_j = jax_chees.AdamState(zero_j, zero_j, jnp.asarray(0, jnp.int32))
    zero_t = torch.zeros(())
    state_t = chees.AdamState(zero_t, zero_t, torch.tensor(0, dtype=torch.int32))
    value_j, value_t = jnp.float32(0.3), torch.tensor(0.3)
    for g in grads:
        value_j, state_j = jax_chees._adam_update(jnp.float32(g), value_j,
                                                  state_j, 0.05)
        value_t, state_t = chees._adam_update(torch.tensor(g), value_t,
                                              state_t, 0.05)
        np.testing.assert_allclose(float(value_t), float(value_j), rtol=1e-6)
    assert int(state_t.step) == int(state_j.step) == len(grads)
    np.testing.assert_allclose(float(state_t.v), float(state_j.v), rtol=1e-6)


class _Info:
    def __init__(self, acceptance_probability):
        self.acceptance_probability = acceptance_probability


def _stub_accept(eps, weights, xp):
    """A deterministic acceptance per chain, decreasing in the step size."""
    return xp.exp(-eps * weights)


@pytest.mark.parametrize("initial, accept_scale", [
    (1.0, 1.0), (0.01, 1.0), (100.0, 1.0), (0.37, 3.0), (1e30, 0.0),
])
def test_find_reasonable_step_size_equals_jax(initial, accept_scale):
    weights = np.linspace(0.5, 1.5, 16).astype(F32) * F32(accept_scale)

    def jax_step(key, state, eps, imm):
        return state, _Info(_stub_accept(eps, jnp.asarray(weights), jnp))

    def port_step(probe, state, eps, imm):
        return state, _Info(_stub_accept(eps, torch.tensor(weights), torch))

    expected = jax_step_size.find_reasonable_step_size(
        jax.random.PRNGKey(0), jax_step, None, None,
        initial_step_size=jnp.float32(initial), target_accept=0.651,
        reduce_fn=jax_chees.pairwise_mean)
    found = find_reasonable_step_size(
        port_step, None, None, initial_step_size=torch.tensor(initial),
        target_accept=0.651, reduce_fn=chees.pairwise_mean)
    assert found.dtype == torch.float32
    assert float(found) == float(expected)
    if accept_scale == 0.0:  # accept 1 forever: the doubling overflows
        assert float(found) == np.float32(1e30)


def _jax_kernel_streams(key, chains, dim):
    k1, k2 = jax.random.split(key)
    return (np.array(jax.random.normal(k1, (chains, dim), jnp.float32)),
            np.array(jax.random.uniform(k2, (chains,), jnp.float32)))


def _jax_streams(key, chains, dim, num_warmup, num_samples):
    """What the JAX ChEES drivers draw with ``use_internal_prng=False``:
    ``warmup_key, sample_key = split(key)``; the search splits its key once
    per probe (at most 32), the warmup once per step, and the draws take
    ``split(sample_key, num_samples)`` (chees.py:342-385, :566)."""
    warmup_key, sample_key = jax.random.split(key)
    key, search_key = jax.random.split(warmup_key)
    streams = {"search": [], "warmup": [], "sample": []}
    for _ in range(32):
        search_key, sub = jax.random.split(search_key)
        streams["search"].append(_jax_kernel_streams(sub, chains, dim))
    for _ in range(num_warmup):
        key, step_key = jax.random.split(key)
        streams["warmup"].append(_jax_kernel_streams(step_key, chains, dim))
    for k in jax.random.split(sample_key, num_samples):
        streams["sample"].append(_jax_kernel_streams(k, chains, dim))
    return lambda phase, i: tuple(torch.tensor(a) for a in streams[phase][i])


def _jax_pg(q_t, var_col):
    return 0.5 * jnp.sum(q_t * q_t / var_col, axis=0), q_t / var_col


def _port_pg(q_t, var_col):
    return 0.5 * torch.sum(q_t * q_t / var_col, dim=0, keepdim=True), q_t / var_col


def _record_jax_calls(monkeypatch, ordered=True):
    """Record (ε, L) of every JAX kernel call, in order.  The front door
    shards the chains over the test suite's 8 host devices, where JAX
    takes no ordered effect; its calls run in one scan, one at a time."""
    calls = []
    base = jax_cf.make_fused_chees_kernel

    def recording(*args, **kwargs):
        kernel_fn = base(*args, **kwargs)

        def wrapped(key, states, eps, num_steps, imm):
            jax.debug.callback(lambda e, n: calls.append((float(e), int(n))),
                               eps, num_steps, ordered=ordered)
            return kernel_fn(key, states, eps, num_steps, imm)

        return wrapped

    monkeypatch.setattr(jax_cf, "make_fused_chees_kernel", recording)
    return calls


def _record_port_calls(monkeypatch, module):
    calls = []
    base = chees_fused.make_fused_chees_kernel

    def recording(*args, **kwargs):
        kernel_fn = base(*args, **kwargs)

        def wrapped(key, states, eps, num_steps, imm):
            calls.append((float(eps), int(num_steps)))
            return kernel_fn(key, states, eps, num_steps, imm)

        return wrapped

    monkeypatch.setattr(module, "make_fused_chees_kernel", recording)
    return calls


# Two runs of the ChEES warmup that differ in the last bit of one sum drift
# apart: dual averaging and the trajectory-length rule amplify a relative
# difference of 1e-7 by about 1.8 a step, and a trip count L flips once
# jitter·h/ε crosses an integer (10-20 warmup steps in, on every
# configuration tried).  The JAX interpret-mode kernel contracts
# multiply-adds into FMAs (XLA's CPU compiler), the port's plain version does
# not, so whole runs agree step for step only up to there.  The step-by-step
# tests below hand both packages the same state at every warmup step and
# every draw, and hold the port to the JAX step there; the whole-run tests
# hold the composition (keys, initial states, search, schedule) to the
# first PREFIX warmup steps.
PREFIX = 6


def _q0():
    rng = np.random.default_rng(3)
    return (rng.normal(size=(CHAINS, DIM)) * np.sqrt(VAR)).astype(F32)


def _kernels():
    var_col = VAR.reshape(-1, 1)
    kj = jax_cf.make_fused_chees_kernel(
        None, [jnp.asarray(var_col)], potential_and_grad_t=_jax_pg,
        block_chains=CHAINS, interpret=True, use_internal_prng=False)
    kt = chees_fused.make_fused_chees_kernel(
        None, (torch.tensor(var_col),), potential_and_grad_t=_port_pg,
        use_internal_prng=False)
    return kj, kt


def _t(x):
    return torch.tensor(np.asarray(x))


def _port_carry(carry, keys):
    """A JAX ChEES warmup carry as the port's, with the key source
    ``keys``."""
    _, states, da, adam, log_h, wc, imm = carry
    return (keys, ChainState(*map(_t, states)),
            DualAveragingState(*map(_t, da)),
            chees.AdamState(*map(_t, adam)), _t(log_h),
            WelfordState(*map(_t, wc)), _t(imm))


def _assert_carries_agree(port, ref):
    _, states_t, da_t, adam_t, log_h_t, wc_t, imm_t = port
    _, states_j, da_j, adam_j, log_h_j, wc_j, imm_j = ref
    np.testing.assert_allclose(states_t.position.numpy(),
                               np.asarray(states_j.position), atol=1e-4)
    for a, b in ((da_t.iterates, da_j.iterates),
                 (da_t.iterates_avg, da_j.iterates_avg),
                 (log_h_t, log_h_j), (imm_t, imm_j), (wc_t.m2, wc_j.m2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    assert int(da_t.step) == int(da_j.step)
    assert int(adam_t.step) == int(adam_j.step)


def test_warmup_matches_jax_step_by_step(monkeypatch):
    """The search and each of 60 warmup steps from the JAX run's own state:
    the same trip count, and ε, h, M⁻¹ and the positions of the next state
    (Stan's schedule: slow windows and their ends are among the steps)."""
    jax_calls = _record_jax_calls(monkeypatch)
    port_calls = _record_port_calls(monkeypatch, chees_fused)
    kj, kt = _kernels()
    hooks = dict(max_num_integration_steps=64, initial_step_size=0.1)
    init_j, seg_j, _ = jax_chees.warmup_hooks(
        None, CHAINS, DIM, WARMUP, kernel_fn=kj, dtype=jnp.float32, **hooks)
    init_t, seg_t, _ = chees.warmup_hooks(
        None, CHAINS, DIM, WARMUP, kernel_fn=kt, dtype=torch.float32, **hooks)
    q0 = _q0()
    states_j = JaxChainState(jnp.asarray(q0),
                             jnp.asarray(0.5 * np.sum(q0**2 / VAR, -1)),
                             jnp.asarray(q0 / VAR))
    warmup_key = jax.random.PRNGKey(17)
    carry_j = init_j(warmup_key, states_j)
    _, search_key = jax.random.split(warmup_key)
    probes = []
    for _ in range(32):
        search_key, sub = jax.random.split(search_key)
        probes.append(_jax_kernel_streams(sub, CHAINS, DIM))
    carry_t = init_t(lambda phase, i: tuple(map(torch.tensor, probes[i])),
                     ChainState(*map(_t, states_j)))
    assert [n for _, n in port_calls] == [n for _, n in jax_calls]
    assert [e for e, _ in port_calls] == [e for e, _ in jax_calls]
    _assert_carries_agree(carry_t, carry_j)
    for step in range(WARMUP):
        _, step_key = jax.random.split(carry_j[0])
        z_u = tuple(map(torch.tensor, _jax_kernel_streams(step_key, CHAINS, DIM)))
        carry_t, _ = seg_t(_port_carry(carry_j, lambda phase, i: z_u), [step])
        carry_j, _ = seg_j(carry_j, jnp.arange(step, step + 1, dtype=jnp.int32))
        assert port_calls[-1][1] == jax_calls[-1][1], step
        np.testing.assert_allclose(port_calls[-1][0], jax_calls[-1][0],
                                   rtol=1e-6)
        _assert_carries_agree(carry_t, carry_j)
    assert len(set(n for _, n in jax_calls[-WARMUP:])) > 3  # L is jittered
    # a slow window ended and swapped its M⁻¹ in
    assert not np.array_equal(np.asarray(carry_j[6]), np.ones(DIM, F32))


def test_sampling_matches_jax_draw_by_draw(monkeypatch):
    """40 draws from a tuned state carried across with
    ``convert.chees_warmup_result``, each draw from the JAX run's previous
    state: the same trip counts, positions within 1e-4."""
    kj, kt = _kernels()
    q0 = _q0()
    tuned = jax_chees.CheesWarmupResult(
        states=JaxChainState(jnp.asarray(q0),
                             jnp.asarray(0.5 * np.sum(q0**2 / VAR, -1)),
                             jnp.asarray(q0 / VAR)),
        step_size=jnp.float32(0.63), trajectory_length=jnp.float32(3.1),
        inverse_mass_matrix=jnp.asarray(VAR * F32(0.9)))
    port = convert.chees_warmup_result(tuned, device="cpu")
    keys = jax.random.split(jax.random.PRNGKey(5), DRAWS)
    one_draw = jax.jit(lambda states, key, t: jax_chees.sample(
        None, None, states, 1, tuned.step_size, tuned.trajectory_length,
        tuned.inverse_mass_matrix, kernel_fn=kj, _keys=key[None],
        _step_offset=t))
    states_j, steps = tuned.states, []
    for t in range(DRAWS):
        z_u = tuple(map(torch.tensor, _jax_kernel_streams(keys[t], CHAINS, DIM)))
        new_j, pos_j, info_j = one_draw(states_j, keys[t],
                                        jnp.asarray(t, jnp.int32))
        new_t, pos_t, info_t = chees.sample(
            lambda phase, i: z_u, None, ChainState(*map(_t, states_j)), 1,
            port.step_size, port.trajectory_length, port.inverse_mass_matrix,
            kernel_fn=kt, _step_offset=t)
        assert int(info_t.num_integration_steps[0]) == int(
            info_j.num_integration_steps[0])
        np.testing.assert_allclose(pos_t.numpy(), np.asarray(pos_j), atol=1e-4)
        np.testing.assert_array_equal(info_t.is_diverging.numpy(),
                                      np.asarray(info_j.is_diverging))
        np.testing.assert_allclose(info_t.acceptance_probability.numpy(),
                                   np.asarray(info_j.acceptance_probability),
                                   rtol=1e-4, atol=1e-5)
        steps.append(int(info_t.num_integration_steps[0]))
        states_j = new_j
    assert len(set(steps)) > 3


def _assert_prefix_agrees(port_calls, jax_calls, num_calls):
    """The same number of kernel calls, the same trip counts and step sizes
    over the search and the first PREFIX warmup steps."""
    assert len(port_calls) == len(jax_calls) == num_calls
    probes = num_calls - WARMUP - DRAWS
    head = probes + PREFIX
    assert [n for _, n in port_calls[:head]] == [n for _, n in jax_calls[:head]]
    np.testing.assert_allclose([e for e, _ in port_calls[:head]],
                               [e for e, _ in jax_calls[:head]], rtol=1e-5)


def test_sample_fused_chees_adaptive_follows_jax(monkeypatch):
    q0 = _q0()
    key = jax.random.PRNGKey(17)
    jax_calls = _record_jax_calls(monkeypatch)
    var_j = jnp.asarray(VAR).reshape(-1, 1)
    out_j = jax_cf.sample_fused_chees_adaptive(
        key, None, [var_j], jnp.asarray(q0), DRAWS, WARMUP,
        potential_and_grad_t=_jax_pg, block_chains=CHAINS,
        use_internal_prng=False, interpret=True, max_num_integration_steps=64,
    )
    port_calls = _record_port_calls(monkeypatch, chees_fused)
    out_t = chees_fused.sample_fused_chees_adaptive(
        _jax_streams(key, CHAINS, DIM, WARMUP, DRAWS), None,
        (torch.tensor(VAR).reshape(-1, 1),), torch.tensor(q0), DRAWS, WARMUP,
        potential_and_grad_t=_port_pg, use_internal_prng=False,
        max_num_integration_steps=64,
    )
    num_calls = len(jax_calls)
    _assert_prefix_agrees(port_calls, jax_calls, num_calls)
    qf, pos, info, wres = out_t
    assert qf.shape == (CHAINS, DIM) and pos.shape == (DRAWS, CHAINS, DIM)
    assert info.num_integration_steps.shape == (DRAWS,)
    assert info.num_integration_steps.dtype == torch.int32
    assert np.asarray(out_j[2].num_integration_steps).shape == (DRAWS,)
    assert bool(torch.isfinite(pos).all())
    assert float(wres.trajectory_length) > float(wres.step_size)


def test_front_door_follows_jax(monkeypatch):
    q0 = _q0()
    key = jax.random.PRNGKey(23)
    jax_calls = _record_jax_calls(monkeypatch, ordered=False)
    var_j = jnp.asarray(VAR)
    res_j = aehmc_tpu.sample(
        key, lambda x: -0.5 * jnp.sum(x * x / var_j), jnp.asarray(q0), DRAWS,
        WARMUP, algorithm="chees", path="fused", data=(var_j.reshape(-1, 1),),
        potential_and_grad_t=_jax_pg, block_chains=CHAINS,
        use_internal_prng=False, interpret=True,
    )
    import aehmc_tpu_torch.api as port_api

    port_calls = _record_port_calls(monkeypatch, port_api)
    var_t = torch.tensor(VAR)
    res_t = aehmc_tpu_torch.sample(
        _jax_streams(key, CHAINS, DIM, WARMUP, DRAWS),
        lambda x: -0.5 * torch.sum(x * x / var_t), torch.tensor(q0),
        DRAWS, WARMUP, algorithm="chees", path="fused",
        data=(var_t.reshape(-1, 1),), potential_and_grad_t=_port_pg,
        use_internal_prng=False,
    )
    _assert_prefix_agrees(port_calls, jax_calls, len(jax_calls))
    assert port_calls[0][0] == 1.0  # the pooled driver's initial ε
    for f in res_t.diagnostics._fields:
        a, b = getattr(res_t.diagnostics, f), getattr(res_j.diagnostics, f)
        assert a.shape == np.asarray(b).shape == (DRAWS, CHAINS), f
        assert str(a.dtype).split(".")[-1] == str(np.asarray(b).dtype), f
    assert isinstance(res_t.final_state, ChainState)
    assert res_t.positions.shape == np.asarray(res_j.positions).shape


def test_moments_on_a_gaussian_under_philox():
    """The whole driver on the plain kernel with Philox randomness: healthy
    acceptance, no divergences, the posterior's moments, reproducible."""
    var = torch.tensor(VAR)
    q0 = torch.tensor(_q0())

    def run():
        return chees_fused.sample_fused_chees_adaptive(
            torch.Generator().manual_seed(9), None, (var.reshape(-1, 1),), q0,
            200, 100, potential_and_grad_t=_port_pg,
            max_num_integration_steps=64)

    qf, pos, info, wres = run()
    assert 0.5 < float(info.acceptance_probability.mean()) < 0.95
    assert int(info.is_diverging.sum()) == 0
    assert float(wres.trajectory_length) > float(wres.step_size)
    flat = pos[50:].reshape(-1, DIM).double()
    np.testing.assert_allclose(flat.mean(0).numpy(), 0.0, atol=0.3)
    np.testing.assert_allclose(flat.var(0).numpy(), VAR, rtol=0.3)
    again = run()
    assert torch.equal(pos, again[1]) and torch.equal(qf, again[0])


def test_warmup_and_sample_need_a_kernel():
    """Without ``kernel_fn`` the drivers build the XLA ChEES kernel of
    ``logprob_fn``, as the JAX drivers do: the same run as passing
    ``chees.new_kernel(logprob_fn)``."""
    def logprob_fn(x):
        return -0.5 * torch.sum(x * x / torch.tensor(VAR), dim=-1)

    q = torch.tensor(_q0())
    states = hmc.new_state(q, logprob_fn)
    kernel = chees.new_kernel(logprob_fn)
    default = chees.warmup(torch.Generator().manual_seed(3), logprob_fn,
                           states, 8)
    given = chees.warmup(torch.Generator().manual_seed(3), None, states, 8,
                         kernel_fn=kernel)
    for a, b in zip(default, given):
        assert torch.equal(torch.as_tensor(a[0] if isinstance(a, tuple)
                                           else a),
                           torch.as_tensor(b[0] if isinstance(b, tuple)
                                           else b))
    out_a = chees.sample(torch.Generator().manual_seed(4), logprob_fn,
                         states, 5, 0.3, 1.0, torch.ones(DIM))
    out_b = chees.sample(torch.Generator().manual_seed(4), None, states, 5,
                         0.3, 1.0, torch.ones(DIM), kernel_fn=kernel)
    assert torch.equal(out_a[1], out_b[1])


def test_new_state_matches_jax():
    q = _q0()
    var_j, var_t = jnp.asarray(VAR), torch.tensor(VAR)
    ref = jax.vmap(lambda x: aehmc_tpu.hmc.new_state(
        x, lambda w: -0.5 * jnp.sum(w * w / var_j)))(jnp.asarray(q))
    out = torch.func.vmap(lambda x: hmc.new_state(
        x, lambda w: -0.5 * torch.sum(w * w / var_t)))(torch.tensor(q))
    one = hmc.new_state(torch.tensor(q[0]),
                        lambda w: -0.5 * torch.sum(w * w / var_t))
    assert isinstance(out, ChainState)
    assert out.potential_energy.shape == (CHAINS,)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert torch.equal(one.potential_energy_grad, out.potential_energy_grad[0])


def test_sample_sharded_raises_for_what_is_not_ported():
    q0 = torch.zeros(8, 2)
    kw = dict(chees_kernel_fn=lambda *a: None)
    # MEADS and checkpoints are ported: what stays is the JAX driver's
    # own errors
    with pytest.raises(ValueError, match="does not compose"):
        sample_sharded(None, None, q0, algorithm="meads", checkpoint_every=5,
                       checkpoint_path="x.npz", meads_segment_fn=object())
    with pytest.raises(ValueError, match="requires an .npz"):
        sample_sharded(None, None, q0, algorithm="chees", checkpoint_every=5,
                       checkpoint_path="x", **kw)
    with pytest.raises(ValueError, match="8 chains do not shard over 3"):
        sample_sharded(None, None, q0, algorithm="chees",
                       mesh=make_mesh(devices=[torch.device("cpu")] * 3), **kw)
    with pytest.raises(ValueError, match="per_chain_step_size"):
        sample_sharded(None, None, q0, algorithm="chees",
                       per_chain_step_size=True, **kw)
    # the fused driver on a mesh: the unsharded run's bits
    def fused(mesh):
        return chees_fused.sample_fused_chees_adaptive(
            torch.Generator().manual_seed(4),
            lambda q_t, v: 0.5 * torch.sum(q_t * q_t / v, 0),
            (torch.ones(2, 1),), torch.linspace(-1, 1, 16).reshape(8, 2), 3,
            4, mesh=mesh)

    sharded = fused(make_mesh(devices=[torch.device("cpu")] * 4))
    assert torch.equal(sharded[1], fused(None)[1])


def test_convert_chees_warmup_result():
    rng = np.random.default_rng(4)
    q = rng.normal(size=(4, 3)).astype(F32)
    res = jax_chees.CheesWarmupResult(
        states=JaxChainState(jnp.asarray(q), jnp.zeros(4), jnp.asarray(q)),
        step_size=jnp.float32(0.3), trajectory_length=jnp.float32(1.5),
        inverse_mass_matrix=jnp.ones(3, jnp.float32))
    out = convert.chees_warmup_result(res, device="cpu")
    assert isinstance(out, chees.CheesWarmupResult)
    np.testing.assert_array_equal(out.states.position.numpy(), q)
    assert float(out.trajectory_length) == 1.5
    assert out.states.position.device.type == "cpu"
