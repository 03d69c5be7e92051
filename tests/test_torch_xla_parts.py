"""The XLA path's building blocks against the JAX package, float64 on both
sides: the metric's three forms, the integrators, the proposals and
progressive samplers fed the same uniforms, the U-turn checkpoint indices
and criterion, the subtree integrators from one start, and
RaveledParamsMap.  Floats to 1e-12 relative, integer and boolean decisions
equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aehmc_tpu import integrators as jint
from aehmc_tpu import metrics as jmetrics
from aehmc_tpu import proposals as jprop
from aehmc_tpu import termination as jterm
from aehmc_tpu import trajectory as jtraj
from aehmc_tpu import types as jtypes
from aehmc_tpu.types import ChainState as JChainState
from aehmc_tpu.types import IntegratorState as JIntegratorState
from aehmc_tpu.types import ProposalState as JProposalState
from aehmc_tpu.utils.ravel import RaveledParamsMap as JRaveledParamsMap
from aehmc_tpu_torch import integrators as tint
from aehmc_tpu_torch import metrics as tmetrics
from aehmc_tpu_torch import proposals as tprop
from aehmc_tpu_torch import termination as tterm
from aehmc_tpu_torch import trajectory as ttraj
from aehmc_tpu_torch.types import (
    ChainState,
    IntegratorState,
    ProposalState,
    integrator_to_chain_state,
)
from aehmc_tpu_torch.utils import RaveledParamsMap

RTOL = 1e-12
DIM = 3
SCALES = np.array([0.7, 1.3, 2.0])


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b.detach() if torch.is_tensor(b) else b)
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_allclose(b, a, rtol=rtol, atol=1e-300)


def _tree_close(a, b, rtol=RTOL):
    for x, y in zip(a, b):
        if isinstance(x, tuple):
            _tree_close(x, y, rtol)
        else:
            _close(x, y, rtol)


def _inverse_mass(form, rng):
    if form == "scalar":
        return np.asarray(1.7)
    if form == "diagonal":
        return rng.uniform(0.5, 2.0, DIM)
    a = rng.normal(size=(DIM, DIM))
    return a @ a.T + DIM * np.eye(DIM)


def _shape(form):
    return () if form == "scalar" else (DIM,)


# a non-Gaussian, elementwise potential (every gradient entry differs)
def _lp_jax(q):
    return -0.5 * jnp.sum(q * q / jnp.asarray(SCALES[: q.size])) - jnp.sum(
        jnp.log1p(q * q))


def _lp_torch(q):
    s = torch.tensor(SCALES[: q.numel()]).reshape(q.shape)
    return -0.5 * torch.sum(q * q / s) - torch.sum(torch.log1p(q * q))


@pytest.mark.parametrize("form", ["scalar", "diagonal", "dense"])
def test_gaussian_metric_matches_jax(form):
    rng = np.random.default_rng(0)
    imm = _inverse_mass(form, rng)
    jgen, jke, jturn = jmetrics.gaussian_metric(jnp.asarray(imm))
    tgen, tke, tturn = tmetrics.gaussian_metric(torch.tensor(imm))
    key = jax.random.PRNGKey(3)
    z = jax.random.normal(key, _shape(form), jnp.float64)
    _close(jgen(key), tgen(torch.tensor(np.asarray(z))))
    for batch in ((), (5,)) if form != "scalar" else ((),):
        p = rng.normal(size=batch + _shape(form))
        _close(jke(jnp.asarray(p)), tke(torch.tensor(p)))
        for _ in range(4):
            pl, pr, ps = (rng.normal(size=batch + _shape(form))
                          for _ in range(3))
            _close(jturn(*map(jnp.asarray, (pl, pr, ps))),
                   tturn(*map(torch.tensor, (pl, pr, ps))))


@pytest.mark.parametrize("form", ["scalar", "diagonal", "dense"])
def test_per_chain_metric_is_each_chains_own_metric(form):
    """A :class:`PerChain` inverse mass matrix gives row ``c`` of a batch
    what chain ``c``'s own matrix gives it alone (the independent warmups'
    parameters of ``sample_chains``), also against checkpoint buffers with
    a slot axis; JAX's metric of that matrix to 1e-12."""
    rng = np.random.default_rng(5)
    chains = 4
    imms = [_inverse_mass(form, rng) * (1 + 0.2 * c) for c in range(chains)]
    gen, ke, turn = tmetrics.gaussian_metric(
        tmetrics.PerChain(torch.tensor(np.stack(imms))))
    z = rng.normal(size=(chains, DIM))
    p, pl, pr, ps = (rng.normal(size=(chains, DIM)) for _ in range(4))
    slots = rng.normal(size=(3, chains, 2, DIM))
    out = (gen(torch.tensor(z)), ke(torch.tensor(p)),
           turn(*(torch.tensor(x) for x in (pl, pr, ps))),
           turn(*(torch.tensor(x) for x in slots)))
    for c, imm in enumerate(imms):
        # a scalar a chain is that chain's constant diagonal
        own = np.full(DIM, imm) if form == "scalar" else imm
        one = tmetrics.gaussian_metric(torch.tensor(own))
        jgen, jke, jturn = jmetrics.gaussian_metric(jnp.asarray(own))
        assert torch.equal(out[0][c], one[0](torch.tensor(z[c])))
        _close(jke(jnp.asarray(p[c])), out[1][c])
        assert bool(out[2][c]) == bool(jturn(*(jnp.asarray(x[c])
                                               for x in (pl, pr, ps))))
        assert torch.equal(out[3][c], one[2](*(torch.tensor(x[c])
                                               for x in slots)))
    with pytest.raises(ValueError, match="dimension"):
        tmetrics.gaussian_metric(tmetrics.PerChain(torch.ones(2, 2, 2, 2)))


def test_gaussian_metric_rejects_three_dimensions():
    with pytest.raises(ValueError, match="dimension"):
        tmetrics.gaussian_metric(torch.ones(2, 2, 2))


@pytest.mark.parametrize("name", ["velocity_verlet", "mclachlan", "yoshida"])
@pytest.mark.parametrize("form", ["diagonal", "dense"])
def test_integrator_step_matches_jax(name, form):
    rng = np.random.default_rng(1)
    imm = _inverse_mass(form, rng)
    _, jke, _ = jmetrics.gaussian_metric(jnp.asarray(imm))
    _, tke, _ = tmetrics.gaussian_metric(torch.tensor(imm))
    jstep = getattr(jint, name)(lambda q: -_lp_jax(q), jke)
    tstep = getattr(tint, name)(lambda q: -_lp_torch(q), tke)
    q, p = rng.normal(size=DIM), rng.normal(size=DIM)
    js = jint.new_integrator_state(lambda x: -_lp_jax(x), jnp.asarray(q),
                                   jnp.asarray(p))
    ts = tint.new_integrator_state(lambda x: -_lp_torch(x), torch.tensor(q),
                                   torch.tensor(p))
    _tree_close(js, ts)
    _tree_close(jtypes.integrator_to_chain_state(js),
                integrator_to_chain_state(ts))
    for eps in (0.3, -0.45):
        js, ts = jstep(js, eps), tstep(ts, eps)
        _tree_close(js, ts)
    # a batch with per-chain step sizes: each row is its own chain
    qb, pb = rng.normal(size=(4, DIM)), rng.normal(size=(4, DIM))
    eps = rng.uniform(0.1, 0.6, 4)
    tb = tstep(tint.new_integrator_state(lambda x: -_lp_torch(x),
                                         torch.tensor(qb), torch.tensor(pb)),
               torch.tensor(eps))
    for c in range(4):
        one = jstep(jint.new_integrator_state(
            lambda x: -_lp_jax(x), jnp.asarray(qb[c]), jnp.asarray(pb[c])),
            eps[c])
        _tree_close(one, IntegratorState(*(x[c] for x in tb)))


def test_integrator_autograd_drift_for_a_kinetic_energy_without_velocity():
    """A kinetic energy without the metric's ``velocity`` drifts by its
    autograd gradient, as the JAX integrators' ``jax.grad``."""
    rng = np.random.default_rng(2)
    w = rng.uniform(0.5, 2.0, DIM)
    jstep = jint.velocity_verlet(lambda q: -_lp_jax(q),
                                 lambda p: 0.25 * jnp.sum(w * p**4))
    tstep = tint.velocity_verlet(lambda q: -_lp_torch(q),
                                 lambda p: 0.25 * torch.sum(
                                     torch.tensor(w) * p**4, dim=-1))
    q, p = rng.normal(size=DIM), rng.normal(size=DIM)
    js = jint.new_integrator_state(lambda x: -_lp_jax(x), jnp.asarray(q),
                                   jnp.asarray(p))
    ts = tint.new_integrator_state(lambda x: -_lp_torch(x), torch.tensor(q),
                                   torch.tensor(p))
    _tree_close(jstep(js, 0.2), tstep(ts, 0.2))


def _proposals(rng, batch=(7,)):
    def one():
        return (rng.normal(size=batch + (DIM,)), rng.normal(size=batch),
                rng.normal(size=batch + (DIM,)), rng.normal(size=batch),
                rng.normal(size=batch) * 2.0, rng.normal(size=batch) - 1.0)

    def build(vals, mod, cs, ps):
        q, u, g, e, w, s = (mod(v) for v in vals)
        return ps(cs(q, u, g), e, w, s)

    a, b = one(), one()
    b[4][0] = -np.inf  # a -inf weight merges without NaN
    return (build(a, jnp.asarray, JChainState, JProposalState),
            build(b, jnp.asarray, JChainState, JProposalState),
            build(a, torch.tensor, ChainState, ProposalState),
            build(b, torch.tensor, ChainState, ProposalState))


def test_proposal_generator_and_samplers_match_jax():
    rng = np.random.default_rng(3)
    imm = rng.uniform(0.5, 2.0, DIM)
    _, jke, _ = jmetrics.gaussian_metric(jnp.asarray(imm))
    _, tke, _ = tmetrics.gaussian_metric(torch.tensor(imm))
    q, p = rng.normal(size=(6, DIM)), rng.normal(size=(6, DIM)) * 30
    u, g = rng.normal(size=6), rng.normal(size=(6, DIM))
    u[2] = np.nan  # NaN energy: weight -inf, divergent
    e0 = rng.normal(size=6)
    for thr in (1000.0, 1.0):
        jp, jd = jprop.proposal_generator(jke, thr)(
            jnp.asarray(e0), JIntegratorState(*map(jnp.asarray, (q, p, u, g))))
        tp, td = tprop.proposal_generator(tke, thr)(
            torch.tensor(e0), IntegratorState(*map(torch.tensor, (q, p, u, g))))
        _tree_close(jp, tp)
        _close(jd, td)
    ja, jb, ta, tb = _proposals(rng)
    uniforms = rng.uniform(size=7)
    for jf, tf in ((jprop.progressive_uniform_sampling_from_u,
                    tprop.progressive_uniform_sampling_from_u),
                   (jprop.progressive_biased_sampling_from_u,
                    tprop.progressive_biased_sampling_from_u)):
        _tree_close(jax.vmap(jf)(jnp.asarray(uniforms), ja, jb),
                    tf(torch.tensor(uniforms), ta, tb))
    # the generator forms draw the uniform the _from_u forms are given
    u = torch.rand(7, generator=torch.Generator().manual_seed(5),
                   dtype=torch.float64)
    for tf, tf_u in ((tprop.progressive_uniform_sampling,
                      tprop.progressive_uniform_sampling_from_u),
                     (tprop.progressive_biased_sampling,
                      tprop.progressive_biased_sampling_from_u)):
        _tree_close(tf_u(u, ta, tb),
                    tf(torch.Generator().manual_seed(5), ta, tb))
    do = rng.uniform(size=7) < 0.5
    _tree_close(jax.vmap(jprop.maybe_update_proposal)(jnp.asarray(do), ja, jb),
                tprop.maybe_update_proposal(torch.tensor(do), ta, tb))
    _tree_close(jax.vmap(jtraj.where_proposal)(jnp.asarray(do), ja, jb),
                ttraj.where_proposal(torch.tensor(do), ta, tb))


@pytest.mark.parametrize(
    "step, expected_idx",
    [(0, (1, 0)), (6, (3, 2)), (7, (0, 2)), (13, (2, 2)), (15, (0, 3))],
)
def test_find_storage_indices_golden_table(step, expected_idx):
    """The reference's golden table (tests/test_termination.py:63), for an
    int and a tensor step."""
    assert tterm._find_storage_indices(step) == expected_idx
    lo, hi = tterm._find_storage_indices(torch.tensor(step))
    assert (int(lo), int(hi)) == expected_idx


def test_find_storage_indices_match_jax_for_all_steps():
    steps = np.arange(4096)
    jlo, jhi = jterm._find_storage_indices(jnp.asarray(steps))
    tlo, thi = tterm._find_storage_indices(torch.tensor(steps))
    _close(jlo, tlo)
    _close(jhi, thi)
    assert [tterm._find_storage_indices(int(s)) for s in steps[:300]] == [
        (int(a), int(b)) for a, b in zip(jlo[:300], jhi[:300])]


@pytest.mark.parametrize("form", ["diagonal", "dense"])
def test_iterative_uturn_matches_jax(form):
    """Write checkpoints along a random leaf sequence and check every odd
    leaf's turning against the JAX criterion (one chain and a batch)."""
    rng = np.random.default_rng(4)
    imm = _inverse_mass(form, rng)
    jnew, jupd, jturn = jterm.iterative_uturn(
        jmetrics.gaussian_metric(jnp.asarray(imm))[2])
    tnew, tupd, tturn = tterm.iterative_uturn(
        tmetrics.gaussian_metric(torch.tensor(imm))[2])
    k = 5
    momenta = rng.normal(size=(2**k, 3, DIM)) + 0.3
    js = [jnew(jnp.zeros(DIM), k)] * 3  # one JAX state per chain
    ts = tnew(torch.zeros(3, DIM, dtype=torch.float64), k)
    assert ts.momentum_checkpoints.shape == (3, k, DIM)
    psum = np.zeros((3, DIM))
    for step in range(2**k):
        psum = psum + momenta[step]
        if step % 2:
            turning = tturn(ts, torch.tensor(psum),
                            torch.tensor(momenta[step]), step)
            for c in range(3):
                _close(jturn(js[c], jnp.asarray(psum[c]),
                             jnp.asarray(momenta[step, c]), step), turning[c])
        js = [jupd(js[c], jnp.asarray(psum[c]), jnp.asarray(momenta[step, c]),
                   step) for c in range(3)]
        ts = tupd(ts, torch.tensor(psum), torch.tensor(momenta[step]), step)
        for c in range(3):
            _close(js[c].momentum_checkpoints, ts.momentum_checkpoints[c])
            _close(js[c].momentum_sum_checkpoints,
                   ts.momentum_sum_checkpoints[c])
        assert (int(js[0].min_index), int(js[0].max_index)) == (
            ts.min_index, ts.max_index)
        # one chain, the range from the state
        single = tturn(ts._replace(
            momentum_checkpoints=ts.momentum_checkpoints[0],
            momentum_sum_checkpoints=ts.momentum_sum_checkpoints[0]),
            torch.tensor(psum[0]), torch.tensor(momenta[step, 0]))
        _close(jturn(js[0], jnp.asarray(psum[0]),
                     jnp.asarray(momenta[step, 0])), single)


def _subtree_fns(pkg_metrics, pkg_term, pkg_int, lp, imm, array):
    _, ke, turn = pkg_metrics.gaussian_metric(array(imm))
    new_ts, upd, crit = pkg_term.iterative_uturn(turn)
    return pkg_int.velocity_verlet(lambda q: -lp(q), ke), ke, new_ts, upd, crit


@pytest.mark.parametrize("paired", [False, True])
@pytest.mark.parametrize("eps, max_steps", [(0.3, 8), (0.9, 16), (2.5, 8),
                                            (40.0, 4), (0.2, 1)])
def test_subtree_integration_matches_jax(paired, eps, max_steps):
    """One subtree from one start: proposal, last state, momentum sum,
    length, divergence and termination equal the JAX integrator's."""
    rng = np.random.default_rng(5)
    imm = rng.uniform(0.5, 2.0, DIM)
    u_leaf = rng.uniform(size=2 * max_steps)
    jfns = _subtree_fns(jmetrics, jterm, jint, _lp_jax, imm, jnp.asarray)
    tfns = _subtree_fns(tmetrics, tterm, tint, _lp_torch, imm, torch.tensor)
    jbuild = jtraj.dynamic_integration_paired if paired else (
        jtraj.dynamic_integration)
    tbuild = ttraj.dynamic_integration_paired if paired else (
        ttraj.dynamic_integration)
    jfn = jbuild(*jfns, 6, 1000.0,
                 leaf_uniform_fn=lambda key, i: jnp.asarray(u_leaf)[i])
    tfn = tbuild(*tfns, 6, 1000.0, lambda i: torch.tensor(u_leaf)[..., i])
    for trial in range(3):
        q, p = rng.normal(size=DIM), rng.normal(size=DIM)
        js = jint.new_integrator_state(lambda x: -_lp_jax(x), jnp.asarray(q),
                                       jnp.asarray(p))
        ts = tint.new_integrator_state(lambda x: -_lp_torch(x),
                                       torch.tensor(q), torch.tensor(p))
        e0 = float(js.potential_energy) + float(jfns[1](js.momentum))
        direction = 1.0 if trial % 2 else -1.0
        jout = jfn(jax.random.PRNGKey(0), js, direction, max_steps, eps, e0)
        tout = tfn(ts, torch.tensor(direction, dtype=torch.float64),
                   max_steps, eps, torch.tensor(e0, dtype=torch.float64))
        _tree_close(jout, tout)


def test_raveled_params_map_matches_jax():
    rng = np.random.default_rng(6)
    params = {"w": rng.normal(size=(2, 3)), "b": np.float32(0.5),
              "n": np.int32(3), "s": rng.normal(size=4).astype(np.float32)}
    jmap = JRaveledParamsMap({k: jnp.asarray(v) for k, v in params.items()})
    tmap = RaveledParamsMap({k: torch.tensor(v) for k, v in params.items()})
    assert tmap.names == jmap.names and tmap.size == jmap.size
    assert tmap.slice_indices == [tuple(map(int, s))
                                  for s in jmap.slice_indices]
    assert str(tmap.dtype).split(".")[1] == str(jnp.dtype(jmap.dtype))
    jflat = jmap.ravel_params({k: jnp.asarray(v) for k, v in params.items()})
    tflat = tmap.ravel_params({k: torch.tensor(v) for k, v in params.items()})
    _close(jflat, tflat)
    back = tmap.unravel_params(tflat)
    for k, v in params.items():
        assert back[k].shape == np.shape(v)
        assert str(back[k].dtype).split(".")[1] == str(np.asarray(v).dtype)
        np.testing.assert_array_equal(back[k].numpy(), v)
    seq = RaveledParamsMap([torch.zeros(2), torch.zeros((), dtype=torch.int64)])
    assert seq.names == (0, 1) and seq.dtype == torch.float32
    assert repr(seq) == "RaveledParamsMap([0, 1])"
