"""The fused NUTS driver's step-size and scheduling options
(``per_chain_step_size``, ``per_chain_quantiles``/``per_chain_quantile_stat``,
``step_size_factors``, ``sort_by_depth``, ``search_initial_step_size``)
against the JAX package's ``fused_driver`` with an interpret-mode kernel.

Both drivers take the same randomness: the port is fed the raw normals and
uniforms JAX draws from its keys (the search's probes first, then the
warmup's, then the sampling's).  Decisions of every transition are exactly
equal; ε (scalar or per chain), M⁻¹ and positions agree to rtol 1e-4
(float32 chains, reductions in another order); ``quantile_snap`` agrees to
1e-6 relative.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aehmc_tpu.config as jax_config
from aehmc_tpu.models import logistic_regression_pg_t as jax_pg_builder
from aehmc_tpu.ops import fused_driver as jax_driver
from aehmc_tpu.ops.nuts_fused_small import (
    make_fused_nuts_transition_small as jax_transition,
)
import aehmc_tpu_torch
from aehmc_tpu_torch import config
from aehmc_tpu_torch.models import logistic_regression_pg_t
from aehmc_tpu_torch.ops import nuts_fused as nf
from aehmc_tpu_torch.ops.fused_driver import (
    _ke_batch,
    _probe_value_and_grad,
    find_reasonable_step_size_fused,
    quantile_snap,
    sample_fused_adaptive,
    warmup_fused,
    warmup_fused_hooks,
)
from aehmc_tpu_torch.ops.nuts_fused_small import (
    make_fused_nuts_transition_small,
)
from aehmc_tpu_torch.parallel import make_mesh

F32 = np.float32
DIM, POINTS, CHAINS, MAX_EXP, STEPS = 6, 48, 16, 4, 30
FACTORS = np.tile([0.5, 1.0, 1.5, 2.0], CHAINS // 4).astype(F32)


# ------------------------------------------------------------ quantile_snap

@pytest.mark.parametrize("stat", ["min", "geomean"])
@pytest.mark.parametrize("n, k", [(64, 8), (13, 4), (5, 8), (40, 1)])
def test_quantile_snap_matches_jax(stat, n, k):
    """Both stats, buckets that do not divide the chains (floor(rank·K/n)),
    more buckets than chains, and ties."""
    rng = np.random.default_rng(n + k)
    vals = np.exp(rng.normal(size=n) * 2.0 - 3.0).astype(F32)
    vals[: n // 4] = vals[0]  # a block of ties
    got = quantile_snap(torch.tensor(vals), k, stat).numpy()
    want = np.asarray(jax_driver.quantile_snap(jnp.asarray(vals), k, stat))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert len(np.unique(got)) <= k
    if stat == "min":
        np.testing.assert_array_equal(got, want)
        assert (got <= vals).all()


def test_quantile_snap_rejects_an_unknown_stat():
    with pytest.raises(ValueError, match="unknown quantile_snap stat"):
        quantile_snap(torch.ones(8), 4, "mean")


# ------------------------------------------------------------ search

@pytest.mark.parametrize("dense", [False, True])
def test_ke_batch_matches_jax(dense):
    rng = np.random.default_rng(1)
    p = rng.normal(size=(CHAINS, DIM)).astype(F32)
    if dense:
        A = rng.normal(size=(DIM, DIM))
        imm = (A @ A.T / DIM + np.eye(DIM)).astype(F32)
    else:
        imm = rng.uniform(0.5, 2.0, size=DIM).astype(F32)
    np.testing.assert_allclose(
        _ke_batch(torch.tensor(p), torch.tensor(imm)).numpy(),
        np.asarray(jax_driver._ke_batch(jnp.asarray(p), jnp.asarray(imm))),
        rtol=1e-6)


def _models():
    _, pg_j, data_j, _ = jax_pg_builder(dim=DIM, num_points=POINTS,
                                        matmul_dtype=jnp.float32)
    pot_t, pg_t, data_t, _ = logistic_regression_pg_t(
        dim=DIM, num_points=POINTS, matmul_dtype=torch.float32, device="cpu")
    return pg_j, data_j, pot_t, pg_t, data_t


@pytest.mark.parametrize("flavour", ["pg_t", "potential_fn_t", "potential_fn"])
def test_probe_value_and_grad_flavours(flavour):
    """The three potentials the drivers take give one ``(u, g)`` in the
    standard layout, equal to JAX's."""
    pg_j, data_j, pot_t, pg_t, data_t = _models()
    q = (0.3 * np.random.default_rng(2).normal(size=(CHAINS, DIM))).astype(F32)
    if flavour == "potential_fn":
        X, XT, y = data_t
        std_data = (X, XT, y.reshape(1, -1))
        vg = _probe_value_and_grad(std_data, potential_fn=nf.logistic_potential)
    else:
        vg = (_probe_value_and_grad(data_t, potential_and_grad_t=pg_t)
              if flavour == "pg_t"
              else _probe_value_and_grad(data_t, potential_fn_t=pot_t))
    u, g = vg(torch.tensor(q))
    u_j, g_j = jax_driver._probe_value_and_grad(
        [jnp.asarray(d) for d in data_j], potential_and_grad_t=pg_j)(
            jnp.asarray(q))
    assert u.shape == (CHAINS,) and g.shape == (CHAINS, DIM)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-4,
                               atol=1e-5)
    with pytest.raises(ValueError, match="no potential"):
        _probe_value_and_grad(data_t)


def _search_normals(key, chains, dim, probes=16):
    """The probes' normals of JAX ``find_reasonable_step_size``: each probe
    splits ``key, subkey``."""
    out = []
    for _ in range(probes):
        key, sub = jax.random.split(key)
        out.append(np.array(jax.random.normal(sub, (chains, dim), jnp.float32)))
    return out


@pytest.mark.parametrize("scale", [0.01, 1.0, 100.0])
def test_search_matches_jax_and_lands_on_the_scale(scale):
    """Mirrors JAX ``test_find_reasonable_step_size_fused_scales``: the
    search lands within a doubling factor of the posterior's scale, and on
    JAX's normals it finds JAX's ε."""
    def pot_j(q, s):
        return 0.5 * jnp.sum((q / s) ** 2, axis=-1)

    def pot_t(q, s):
        return 0.5 * torch.sum((q / s) ** 2, dim=-1)

    q = np.array(jax.random.normal(jax.random.PRNGKey(0), (64, 10),
                                   jnp.float32)) * F32(scale)
    key = jax.random.PRNGKey(1)
    found_j = jax_driver.find_reasonable_step_size_fused(
        key, jax_driver._probe_value_and_grad(
            [jnp.asarray(scale, jnp.float32)], potential_fn=pot_j),
        jnp.asarray(q), jnp.ones((10,), jnp.float32), initial_step_size=0.1)
    normals = _search_normals(key, 64, 10)
    vg = _probe_value_and_grad((torch.tensor(scale, dtype=torch.float32),),
                               potential_fn=pot_t)
    found = find_reasonable_step_size_fused(
        lambda i: normals[i], vg, torch.tensor(q), torch.ones(10),
        initial_step_size=0.1)
    assert found.shape == () and float(found) == float(found_j)
    assert scale / 4 < float(found) < scale * 4


def test_search_requires_a_probe():
    with pytest.raises(ValueError, match="probe_value_and_grad"):
        warmup_fused_hooks(lambda *a, **k: None, 8, 4, 40,
                           max_num_expansions=4, search_initial_step_size=True)


# ------------------------------------------------------------ warmup

def _jax_warmup_streams(key, num_steps, chains, dim, max_exp, search):
    """The raw streams of ``warmup_fused_hooks.init``: the search's key split
    off first (when searching), then the per-step keys."""
    normals = None
    if search:
        key, search_key = jax.random.split(key)
        normals = _search_normals(search_key, chains, dim)
    _, key_scan = jax.random.split(key)
    out = []
    for k in jax.random.split(key_scan, num_steps):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        z = jax.random.normal(k1, (chains, dim), jnp.float32)
        dirs = jnp.where(jax.random.uniform(k2, (chains, max_exp)) < 0.5,
                         -1.0, 1.0)
        ub = jax.random.uniform(k3, (chains, max_exp))
        ul = jax.random.uniform(k4, (chains, 2**max_exp))
        out.append(tuple(np.array(a, F32) for a in (z, dirs, ub, ul)))
    return out, normals


WARMUP_OPTIONS = {
    "per_chain": dict(per_chain_step_size=True),
    "per_chain_sorted_snapped": dict(per_chain_step_size=True,
                                     sort_by_depth=True,
                                     per_chain_quantiles=4),
    "riffled_sorted": dict(step_size_factors=FACTORS, sort_by_depth=True),
    "search": dict(search_initial_step_size=True, initial_step_size=1e-3),
    "search_per_chain_geomean": dict(
        search_initial_step_size=True, per_chain_step_size=True,
        per_chain_quantiles=3, per_chain_quantile_stat="geomean"),
}


def _as_jax(options):
    return {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
            for k, v in options.items()}


def _as_port(options):
    return {k: torch.tensor(v) if isinstance(v, np.ndarray) else v
            for k, v in options.items()}


def _port_ast(ast_j, like):
    """JAX's ``WindowAdaptationState`` as the port's, each leaf in the dtype
    of the port's own state ``like``."""
    def conv(x, ref):
        return torch.tensor(np.asarray(x)).to(ref.dtype)

    return type(like)(
        type(like.da_state)(*map(conv, ast_j.da_state, like.da_state)),
        type(like.wc_state)(*map(conv, ast_j.wc_state, like.wc_state)),
        conv(ast_j.step_size, like.step_size),
        conv(ast_j.inverse_mass_matrix, like.inverse_mass_matrix),
    )


@pytest.mark.parametrize("name", sorted(WARMUP_OPTIONS))
def test_warmup_with_options_matches_jax_step_by_step(name):
    """Each warmup step from the JAX run's own carry (the chain state, the
    adaptation state and the last depth): the transition's decisions in the
    order the kernel saw the chains (sorted runs sort alike), the
    acceptance the adaptation reads, the next ε (``(chains,)`` when per
    chain), M⁻¹ and positions; then the initial search's ε and the
    finish's snap.  Step by step, since float32 sums in another order
    drift apart over a per-chain dual-averaging run (one chain's ε feeds
    back its own acceptance unpooled) until a near-tie decision flips."""
    options = WARMUP_OPTIONS[name]
    pg_j, data_j, _, pg_t, data_t = _models()
    q0 = (0.1 * np.random.default_rng(0).normal(size=(CHAINS, DIM))).astype(F32)
    u0, g0 = pg_t(torch.tensor(q0).T.contiguous(), *data_t)
    key = jax.random.PRNGKey(7)
    search = options.get("search_initial_step_size", False)
    sort = options.get("sort_by_depth", False)
    common = dict(max_num_expansions=MAX_EXP, use_internal_prng=False,
                  initial_step_size=0.1)

    jax_stats, port_stats = [], []
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

    pt = make_fused_nuts_transition_small(
        None, data_t, max_num_expansions=MAX_EXP, potential_and_grad_t=pg_t,
        transposed_io=True,
    )

    def port_recording(*args, **kwargs):
        out = pt(*args, **kwargs)
        port_stats.append(out[3].T.numpy())
        return out

    probe_j = (jax_driver._probe_value_and_grad(
        [jnp.asarray(d) for d in data_j], potential_and_grad_t=pg_j)
        if search else None)
    j_init, j_segment, j_finish = jax_driver.warmup_fused_hooks(
        jax_recording, CHAINS, DIM, STEPS, probe_value_and_grad=probe_j,
        **{**common, **_as_jax(options)})
    streams, normals = _jax_warmup_streams(key, STEPS, CHAINS, DIM, MAX_EXP,
                                           search)
    probe_t = (_probe_value_and_grad(data_t, potential_and_grad_t=pg_t)
               if search else None)
    p_init, p_segment, p_finish = warmup_fused_hooks(
        port_recording, CHAINS, DIM, STEPS, streams=lambda t: streams[t],
        search_streams=None if normals is None else (lambda i: normals[i]),
        probe_value_and_grad=probe_t, **{**common, **_as_port(options)})

    jw = j_init(key, (jnp.asarray(q0), jnp.asarray(u0.numpy().T),
                      jnp.asarray(g0.numpy().T)))
    pw = p_init(None, (torch.tensor(q0).T.contiguous(), u0, g0))
    like = pw[1]
    # the search seats dual averaging at JAX's ε (one power of 2 of 1e-3)
    np.testing.assert_allclose(like.step_size.numpy(),
                               np.asarray(jw[1].step_size), rtol=1e-6)

    def port_carry(jw):
        (q, u, g), ast, depth = jw[:3]
        qug = tuple(torch.tensor(np.asarray(a)).T.contiguous()
                    for a in (q, u, g))
        depth = torch.tensor(np.asarray(depth)) if sort else None
        return qug, _port_ast(ast, like), depth, pw[3]

    for t in range(STEPS):
        (qug_p, ast_p, _, _), accept_p = p_segment(port_carry(jw), [t])
        jw, accept_j = j_segment(jw, jnp.arange(t, t + 1, dtype=jnp.int32))
        assert len(port_stats) == len(jax_stats) == t + 1
        np.testing.assert_array_equal(port_stats[t][:, 2:6],
                                      jax_stats[t][:, 2:6])
        np.testing.assert_allclose(accept_p.numpy(), np.asarray(accept_j),
                                   rtol=1e-5, atol=1e-6)
        # dual averaging scales the acceptance's last-bit noise by
        # sqrt(step)/gamma into log ε
        np.testing.assert_allclose(ast_p.step_size.numpy(),
                                   np.asarray(jw[1].step_size), rtol=1e-4)
        np.testing.assert_allclose(ast_p.inverse_mass_matrix.numpy(),
                                   np.asarray(jw[1].inverse_mass_matrix),
                                   rtol=1e-5)
        np.testing.assert_allclose(qug_p[0].T.numpy(), np.asarray(jw[0][0]),
                                   rtol=1e-5, atol=1e-5)
    _, (eps_p, imm_p) = p_finish(port_carry(jw))
    _, (eps_j, imm_j) = j_finish(jw)
    eps_j = np.asarray(eps_j)
    assert eps_j.shape == ((CHAINS,) if options.get("per_chain_step_size")
                           else ())
    assert tuple(eps_p.shape) == eps_j.shape
    np.testing.assert_allclose(eps_p.numpy(), eps_j, rtol=1e-6)
    if options.get("per_chain_quantiles"):
        assert len(np.unique(eps_p.numpy())) <= options["per_chain_quantiles"]
    if sort:  # the kernel saw the chains in another order than chain order
        assert len(np.unique(np.stack(jax_stats)[:-1, :, 2])) > 1


# ------------------------------------------------------------ whole driver

def _jax_driver_key_source(key, num_warmup, num_samples, search):
    """``(phase, index) -> streams`` replaying JAX
    ``sample_fused_adaptive``'s draws with ``use_internal_prng=False``."""
    warmup_key, sample_key = jax.random.split(key)
    warmup, normals = _jax_warmup_streams(warmup_key, num_warmup, CHAINS, DIM,
                                          MAX_EXP, search)
    sample, _ = _jax_warmup_streams(sample_key, num_samples, CHAINS, DIM,
                                    MAX_EXP, False)
    phases = dict(warmup=warmup, sample=sample, search=normals)
    return lambda phase, i: phases[phase][i]


DRIVER_OPTIONS = {
    "sorted_per_chain_snapped": dict(sort_by_depth=True,
                                     per_chain_step_size=True,
                                     per_chain_quantiles=4),
    "sorted_riffled_searched": dict(sort_by_depth=True,
                                    step_size_factors=FACTORS,
                                    search_initial_step_size=True),
}


@pytest.mark.parametrize("name", sorted(DRIVER_OPTIONS))
def test_sample_fused_adaptive_with_options_matches_jax(name):
    """The whole driver on JAX's keys: the search's draws, then warmup's,
    then sampling's; the tuned ε riding the sort into the draws.  Per-chain
    runs are short (12 warmup steps, dual averaging's fast stage): over
    longer ones the float32 drift that the step-by-step warmup test
    isolates flips a near-tie decision."""
    options = DRIVER_OPTIONS[name]
    pg_j, data_j, _, pg_t, data_t = _models()
    q0 = (0.1 * np.random.default_rng(3).normal(size=(CHAINS, DIM))).astype(F32)
    warmup = 12 if options.get("per_chain_step_size") else 30
    draws, key = 8, jax.random.PRNGKey(11)
    qf_j, pos_j, stats_j, eps_j, imm_j = jax_driver.sample_fused_adaptive(
        key, None, list(data_j), jnp.asarray(q0), draws, warmup,
        potential_fn_t=lambda q_t, *d: pg_j(q_t, *d)[0],
        potential_and_grad_t=pg_j, max_num_expansions=MAX_EXP,
        block_chains=CHAINS, use_internal_prng=False, interpret=True,
        **_as_jax(options))
    source = _jax_driver_key_source(
        key, warmup, draws, options.get("search_initial_step_size", False))
    qf, pos, stats, eps, imm = sample_fused_adaptive(
        source, None, data_t, torch.tensor(q0), draws, warmup,
        potential_and_grad_t=pg_t, max_num_expansions=MAX_EXP,
        use_internal_prng=False, **_as_port(options))
    np.testing.assert_array_equal(stats.numpy()[..., 2:6],
                                  np.asarray(stats_j)[..., 2:6])
    np.testing.assert_allclose(eps.numpy(), np.asarray(eps_j), rtol=1e-4)
    np.testing.assert_allclose(imm.numpy(), np.asarray(imm_j), rtol=1e-4)
    # a chain's ε 1e-4 off moves its 2**K-leaf trajectories by up to 1e-3
    atol = 1e-3 if options.get("per_chain_step_size") else 1e-4
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), atol=atol)
    np.testing.assert_allclose(qf.numpy(), np.asarray(qf_j), atol=atol)


def test_standard_branch_searches_and_sorts_as_jax():
    """The standard-layout driver (kernel 3 on the card) takes
    ``search_initial_step_size`` and ``sort_by_depth`` as JAX's does."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(POINTS, DIM)).astype(F32)
    y = (rng.uniform(size=POINTS) < 0.5).astype(F32).reshape(1, -1)
    q0 = (0.1 * rng.normal(size=(CHAINS, DIM))).astype(F32)
    warmup, draws, key = 25, 6, jax.random.PRNGKey(13)

    def pot_j(x, X, XT, y_row):
        logits = x @ XT
        sp = jnp.maximum(logits, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(logits)))
        return (-jnp.sum(y_row * logits - sp, axis=-1)
                + 0.5 * jnp.sum(x * x, axis=-1))

    options = dict(sort_by_depth=True, search_initial_step_size=True,
                   initial_step_size=1e-3)
    qf_j, pos_j, stats_j, eps_j, imm_j = jax_driver.sample_fused_adaptive(
        key, pot_j, (jnp.asarray(X), jnp.asarray(X.T), jnp.asarray(y)),
        jnp.asarray(q0), draws, warmup, max_num_expansions=MAX_EXP,
        block_chains=CHAINS, use_internal_prng=False, interpret=True,
        **options)
    source = _jax_driver_key_source(key, warmup, draws, True)
    data = (torch.tensor(X), torch.tensor(X.T).contiguous(), torch.tensor(y))
    qf, pos, stats, eps, imm = sample_fused_adaptive(
        source, nf.logistic_potential, data, torch.tensor(q0), draws, warmup,
        max_num_expansions=MAX_EXP, use_internal_prng=False, **options)
    np.testing.assert_array_equal(stats.numpy()[..., 2:6],
                                  np.asarray(stats_j)[..., 2:6])
    np.testing.assert_allclose(float(eps), float(eps_j), rtol=1e-4)
    np.testing.assert_allclose(pos.numpy(), np.asarray(pos_j), atol=1e-4)
    np.testing.assert_allclose(qf.numpy(), np.asarray(qf_j), atol=1e-4)


# ------------------------------------------------------------ checkpoints

def _sorted_run(path=None, **kw):
    _, _, _, pg_t, data_t = _models()
    q0 = 0.1 * torch.randn(CHAINS, DIM,
                           generator=torch.Generator().manual_seed(2))
    return sample_fused_adaptive(
        torch.Generator().manual_seed(19), None, data_t, q0, 12, 25,
        potential_and_grad_t=pg_t, max_num_expansions=MAX_EXP,
        sort_by_depth=True, per_chain_step_size=True,
        step_size_factors=torch.tensor(FACTORS), checkpoint_path=path, **kw)


@pytest.mark.parametrize("internal", [True, False])
def test_sorted_checkpointed_run_resumes_bitwise(tmp_path, internal):
    """The depth is in both phases' carries, so a sorted run killed in
    sampling or in warmup resumes to the uninterrupted run bit for bit
    (JAX ``test_depth_sorted_checkpoint_resume_bitwise``), and the
    checkpointed run equals the unsegmented one."""
    kw = dict(checkpoint_every=5, use_internal_prng=internal)
    full = _sorted_run(str(tmp_path / "full.npz"), **kw)
    for crash in ("_crash_after_segments", "_crash_after_warmup_segments"):
        path = str(tmp_path / f"{crash}.npz")
        assert _sorted_run(path, **{crash: 2}, **kw) is None
        resumed = _sorted_run(path, resume=True, **kw)
        for a, b in zip(full, resumed):
            assert torch.equal(a, b)
    for a, b in zip(full, _sorted_run(use_internal_prng=internal)):
        assert torch.equal(a, b)
    assert full[3].shape == (CHAINS,)


# ------------------------------------------------------------ errors, names

def test_driver_errors_are_jax_s():
    _, _, _, pg_t, data_t = _models()
    q0 = torch.zeros(CHAINS, DIM)
    run = lambda **kw: sample_fused_adaptive(  # noqa: E731
        torch.Generator(), None, data_t, q0, 2, 2, potential_and_grad_t=pg_t,
        **kw)
    with pytest.raises(ValueError, match="set per_chain_step_size=True"):
        run(per_chain_quantiles=8)
    with pytest.raises(ValueError, match="sort_by_depth is a global"):
        run(sort_by_depth=True, loop_in_kernel=True)
    with pytest.raises(ValueError, match="unknown quantile_snap stat"):
        run(per_chain_step_size=True, per_chain_quantiles=2,
            per_chain_quantile_stat="mean")
    with pytest.raises(ValueError, match=f"{CHAINS} chains do not shard"):
        run(mesh=make_mesh(devices=[torch.device("cpu")] * (CHAINS + 1)))


def test_front_door_sorts_without_an_explicit_loop_in_kernel():
    """The whole-run default gives way to ``sort_by_depth``; the options
    reach the driver through the front door."""
    _, _, _, pg_t, data_t = _models()
    q0 = 0.1 * torch.randn(CHAINS, DIM,
                           generator=torch.Generator().manual_seed(3))
    res = aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(4), None, q0, 5, 25, path="fused",
        data=data_t, potential_and_grad_t=pg_t, max_num_expansions=MAX_EXP,
        sort_by_depth=True, per_chain_step_size=True, per_chain_quantiles=2,
        search_initial_step_size=True)
    assert res.positions.shape == (5, CHAINS, DIM)
    assert res.step_size.shape == (CHAINS,)
    assert len(torch.unique(res.step_size)) <= 2
    direct = sample_fused_adaptive(
        torch.Generator().manual_seed(4), None, data_t, q0, 5, 25,
        potential_and_grad_t=pg_t, max_num_expansions=MAX_EXP,
        sort_by_depth=True, per_chain_step_size=True, per_chain_quantiles=2,
        search_initial_step_size=True)
    assert torch.equal(res.positions, direct[1])


@pytest.mark.parametrize("algorithm", ["mala", "ghmc"])
def test_front_door_forwards_the_options_on_mala_and_ghmc(algorithm):
    _, _, _, pg_t, data_t = _models()
    q0 = 0.1 * torch.randn(CHAINS, DIM,
                           generator=torch.Generator().manual_seed(3))
    res = aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(4), None, q0, 8, 25,
        algorithm=algorithm, path="fused", data=data_t,
        potential_and_grad_t=pg_t, block_chains=8, per_chain_step_size=True,
        per_chain_quantiles=4, search_initial_step_size=True,
        segment_draws=4)
    assert res.positions.shape == (8, CHAINS, DIM)
    assert res.step_size.shape == (CHAINS,)
    assert len(torch.unique(res.step_size)) <= 4
    assert bool(torch.isfinite(res.positions).all())


@pytest.mark.parametrize("name", ["DualAveragingConfig", "MassMatrixConfig",
                                  "WindowSchedule", "NutsConfig", "HmcConfig",
                                  "WarmupConfig"])
def test_config_defaults_equal_jax(name):
    ours, theirs = getattr(config, name)(), getattr(jax_config, name)()
    assert [f.name for f in dataclasses.fields(ours)] == [
        f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)


def test_root_exports_the_jax_root_s_state_types():
    from aehmc_tpu_torch.types import ProposalState, TerminationState

    assert aehmc_tpu_torch.ProposalState is ProposalState
    assert aehmc_tpu_torch.TerminationState is TerminationState
    assert {"ProposalState", "TerminationState"} <= set(aehmc_tpu_torch.__all__)


def test_front_door_sorted_run_killed_and_resumed(tmp_path):
    """A sorted, checkpointed front-door run killed in sampling returns
    None and resumes to the uninterrupted run bit for bit."""
    _, _, _, pg_t, data_t = _models()
    q0 = 0.1 * torch.randn(CHAINS, DIM,
                           generator=torch.Generator().manual_seed(5))

    def run(path, **kw):
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(6), None, q0, 12, 20, path="fused",
            data=data_t, potential_and_grad_t=pg_t,
            max_num_expansions=MAX_EXP, sort_by_depth=True,
            per_chain_step_size=True, checkpoint_every=4,
            checkpoint_path=str(path), **kw)

    full = run(tmp_path / "full.npz")
    assert run(tmp_path / "run.npz", _crash_after_segments=1) is None
    resumed = run(tmp_path / "run.npz", resume=True)
    assert torch.equal(full.positions, resumed.positions)
    assert torch.equal(full.step_size, resumed.step_size)
    for a, b in zip(full.diagnostics, resumed.diagnostics):
        assert torch.equal(a, b)
