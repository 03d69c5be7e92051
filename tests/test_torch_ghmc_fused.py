"""The port's fused GHMC (aehmc_tpu_torch.ops.ghmc_fused) and its MALA/GHMC
driver against the JAX package, on the same numpy inputs.

The JAX kernels run in interpret mode.  Accept decisions and the exact stats
rows (0, num_steps, divergent) must be equal; positions, potentials,
gradients, momenta and the float stats agree to rtol 1e-5 with atol 1e-5,
because the kinetic energy and the data products are float32 sums taken in
another order.  The port's own segment equals its transitions bit for bit.
The CUDA kernels run only on a card: their tests are in
``test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu import mala as jax_mala
from aehmc_tpu.models import logistic_regression_pg_t as jax_pg_builder
from aehmc_tpu.ops import ghmc_fused as jax_ghmc
from aehmc_tpu.ops.fused_driver import sample_fused_ghmc as jax_sample_ghmc
from aehmc_tpu_torch import convert
from aehmc_tpu_torch.models import logistic_regression_pg_t
from aehmc_tpu_torch.ops.fused_driver import (
    ghmc_sampling,
    sample_fused_ghmc,
    sample_fused_mala,
)
from aehmc_tpu_torch.ops.ghmc_fused import (
    fused_ghmc_segment,
    ghmc_segment_plain,
    ghmc_transition_plain,
    make_fused_ghmc_transition,
)
from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
from aehmc_tpu_torch.ops.philox import (
    ACCEPT,
    MASK32,
    ghmc_streams,
    nuts_streams,
    philox4x32,
    uniform_from_bits,
)

F32 = np.float32
DIM, POINTS, CHAINS = 6, 48, 16
TOL = dict(rtol=1e-5, atol=1e-5)


def _models():
    _, pg_j, data_j, _ = jax_pg_builder(dim=DIM, num_points=POINTS,
                                        matmul_dtype=jnp.float32)
    _, pg_t, data_t, _ = logistic_regression_pg_t(dim=DIM, num_points=POINTS,
                                                  matmul_dtype=torch.float32,
                                                  device="cpu")
    return pg_j, data_j, pg_t, data_t


def _state(seed, scale=0.5):
    rng = np.random.default_rng(seed)
    q = (scale * rng.normal(size=(CHAINS, DIM))).astype(F32)
    p = rng.normal(size=(CHAINS, DIM)).astype(F32)
    return rng, q, p


def _jax_transition(pg_j, data_j, **kw):
    return jax_ghmc.make_fused_ghmc_transition(
        lambda q_t, *d: pg_j(q_t, *d)[0], list(data_j), block_chains=8,
        interpret=True, potential_and_grad_t=pg_j, **kw,
    )


def _accepted(q_new, q_old):
    return np.any(np.asarray(q_new) != np.asarray(q_old), axis=-1)


def _assert_transitions_agree(port, jax_out, q0):
    qp, up, gp, pp, sp = (np.asarray(a) for a in port)
    qj, uj, gj, pj, sj = (np.asarray(a) for a in jax_out)
    np.testing.assert_array_equal(_accepted(qp, q0), _accepted(qj, q0))
    np.testing.assert_array_equal(sp[..., 2:5], sj[..., 2:5])
    np.testing.assert_allclose(sp[..., :2], sj[..., :2], **TOL)
    for a, b in ((qp, qj), (up, uj), (gp, gj), (pp, pj)):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("eps, alpha", [(0.1, 0.0), (0.3, 0.9), (5.0, 0.5)])
def test_transition_matches_jax(eps, alpha):
    pg_j, data_j, pg_t, data_t = _models()
    rng, q, p = _state(0)
    noise = rng.normal(size=(CHAINS, DIM)).astype(F32)
    ua = rng.uniform(size=CHAINS).astype(F32)
    imm = rng.uniform(0.5, 1.5, size=DIM).astype(F32)
    u0, g0 = pg_t(torch.tensor(q).T, *data_t)
    args = (u0.reshape(-1).numpy(), g0.T.numpy(), p)
    port = make_fused_ghmc_transition(None, data_t, potential_and_grad_t=pg_t)(
        torch.tensor(q), *(torch.tensor(a) for a in args), eps, alpha,
        torch.tensor(imm), noise=torch.tensor(noise), u_accept=torch.tensor(ua),
    )
    jax_out = _jax_transition(pg_j, data_j)(
        jnp.asarray(q), *(jnp.asarray(a) for a in args), eps, alpha,
        jnp.asarray(imm), noise=jnp.asarray(noise), u_accept=jnp.asarray(ua),
    )
    _assert_transitions_agree(port, jax_out, q)
    accepted = _accepted(port[0], q)
    if eps == 5.0:  # rejection (momentum flipped) and divergence are reached
        assert not accepted.all()
        assert bool((port[4][:, 4] > 0.5).any())
        np.testing.assert_array_equal(port[3].numpy()[~accepted],
                                      -(alpha * p + np.sqrt(F32(1.0 - alpha**2))
                                        * noise)[~accepted])
    else:
        assert accepted.any()


def test_transition_per_chain_parameters_match_jax():
    pg_j, data_j, pg_t, data_t = _models()
    rng, q, p = _state(1)
    noise = rng.normal(size=(CHAINS, DIM)).astype(F32)
    ua = rng.uniform(size=CHAINS).astype(F32)
    eps = rng.uniform(0.1, 0.8, size=CHAINS).astype(F32)
    alpha = rng.uniform(0.0, 0.95, size=CHAINS).astype(F32)
    imm = rng.uniform(0.5, 2.0, size=(CHAINS, DIM)).astype(F32)
    u0, g0 = pg_t(torch.tensor(q).T, *data_t)
    args = (u0.reshape(-1).numpy(), g0.T.numpy(), p, eps, alpha, imm)
    port = make_fused_ghmc_transition(None, data_t, potential_and_grad_t=pg_t)(
        torch.tensor(q), *(torch.tensor(a) for a in args),
        noise=torch.tensor(noise), u_accept=torch.tensor(ua),
    )
    jax_out = _jax_transition(pg_j, data_j)(
        jnp.asarray(q), *(jnp.asarray(a) for a in args),
        noise=jnp.asarray(noise), u_accept=jnp.asarray(ua),
    )
    _assert_transitions_agree(port, jax_out, q)


def test_segment_matches_jax():
    pg_j, data_j, pg_t, data_t = _models()
    draws = 8
    rng, q, p = _state(2)
    noise = rng.normal(size=(draws, CHAINS, DIM)).astype(F32)
    ua = rng.uniform(size=(draws, CHAINS)).astype(F32)
    imm = rng.uniform(0.5, 1.5, size=DIM).astype(F32)
    u0, g0 = pg_t(torch.tensor(q).T, *data_t)
    args = (u0.reshape(-1).numpy(), g0.T.numpy(), p)
    port = fused_ghmc_segment(None, data_t, potential_and_grad_t=pg_t)(
        torch.tensor(q), *(torch.tensor(a) for a in args), 0.4, 0.8,
        torch.tensor(imm), draws, noise=torch.tensor(noise),
        u_accept=torch.tensor(ua),
    )
    jax_out = jax_ghmc.fused_ghmc_segment(
        lambda q_t, *d: pg_j(q_t, *d)[0], list(data_j), block_chains=8,
        interpret=True, potential_and_grad_t=pg_j,
    )(jnp.asarray(q), *(jnp.asarray(a) for a in args), 0.4, 0.8,
      jnp.asarray(imm), draws, noise=jnp.asarray(noise),
      u_accept=jnp.asarray(ua))
    pos_p, st_p = (np.asarray(a) for a in port[:2])
    pos_j, st_j = (np.asarray(a) for a in jax_out[:2])
    assert pos_p.shape == (draws, CHAINS, DIM) and st_p.shape == (draws, CHAINS, 8)
    np.testing.assert_array_equal(
        _accepted(pos_p, np.concatenate([q[None], pos_p[:-1]])),
        _accepted(pos_j, np.concatenate([q[None], pos_j[:-1]])))
    np.testing.assert_array_equal(st_p[..., 2:5], st_j[..., 2:5])
    np.testing.assert_allclose(st_p[..., :2], st_j[..., :2], **TOL)
    np.testing.assert_allclose(pos_p, pos_j, **TOL)
    for a, b in zip(port[2:], jax_out[2:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("philox", [False, True])
def test_segment_equals_transitions_bitwise(philox):
    _, _, pg_t, data_t = _models()
    draws, seed = 8, 1234
    rng, q, p = _state(3)
    q_t, p_t = torch.tensor(q).T.contiguous(), torch.tensor(p).T.contiguous()
    u, g_t = pg_t(q_t, *data_t)
    noise = torch.tensor(rng.normal(size=(draws, DIM, CHAINS)).astype(F32))
    ua = torch.tensor(rng.uniform(size=(draws, CHAINS)).astype(F32))
    imm = torch.tensor(rng.uniform(0.5, 1.5, size=DIM).astype(F32))
    pot_grad = lambda x: pg_t(x, *data_t)  # noqa: E731
    rand = dict(seed=seed) if philox else dict(noise=noise, u_accept=ua)
    pos, stats, qf, uf, gf, pf = ghmc_segment_plain(
        q_t, u, g_t, p_t, 0.35, 0.8, imm, pot_grad, draws, **rand)
    state = (q_t, u, g_t, p_t)
    for t in range(draws):
        rand = (dict(seed=(seed + t * DRAW_SEED_STRIDE) & MASK32) if philox
                else dict(noise=noise[t], u_accept=ua[t]))
        *state, st = ghmc_transition_plain(*state, 0.35, 0.8, imm, pot_grad,
                                           **rand)
        assert torch.equal(pos[t], state[0]) and torch.equal(stats[t], st)
    for a, b in zip((qf, uf, gf, pf), state):
        assert torch.equal(a, b)


def test_ghmc_streams_reuse_the_momentum_layout():
    z, ua = ghmc_streams(99, 5, 7, chain_offset=3)
    zn = nuts_streams(99, 5, 7, 2, chain_offset=3)[0]
    assert torch.equal(z, zn) and z.shape == (7, 5) and ua.shape == (1, 5)
    chains = torch.arange(3, 8, dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.int64)
    word = philox4x32((chains, zero, zero + ACCEPT, zero), (99, 0))[0]
    assert torch.equal(ua[0], uniform_from_bits(word))
    assert bool(((ua > 0) & (ua <= 1)).all())


def test_one_step_accept_equals_mala_mh_ratio():
    """At α = 0 and one step the accept probability is MALA's asymmetric
    Metropolis-Hastings ratio, chain for chain (tests/test_ghmc_fused.py:438
    for the JAX kernel)."""
    rng = np.random.default_rng(3)
    chains, dim, eps = 16, 5, 0.7
    var = rng.uniform(0.3, 3.0, size=dim).astype(F32)
    imm = rng.uniform(0.5, 2.0, size=dim).astype(F32)
    q = (rng.normal(size=(chains, dim)) * np.sqrt(var)).astype(F32)

    def logprob_fn(x):
        return -0.5 * jnp.sum(x * x / var)

    kernel = jax_mala.new_kernel(logprob_fn)
    keys = jax.random.split(jax.random.PRNGKey(11), chains)

    def one(k, qi):
        state = jax_mala.new_state(qi, logprob_fn)
        _, info = kernel(k, state, jnp.float32(eps), jnp.asarray(imm))
        return info.acceptance_probability

    mala_accept = np.asarray(jax.vmap(one)(keys, jnp.asarray(q)))
    z = np.asarray(jax.vmap(
        lambda k: jax.random.normal(jax.random.split(k)[0], (dim,), jnp.float32)
    )(keys))
    var_col = torch.tensor(var).reshape(-1, 1)

    def gaussian_pg(q_t, v):
        return 0.5 * torch.sum(q_t * q_t / v, dim=0, keepdim=True), q_t / v

    transition = make_fused_ghmc_transition(None, (var_col,),
                                            potential_and_grad_t=gaussian_pg)
    u0, g0 = gaussian_pg(torch.tensor(q).T, var_col)
    stats = transition(torch.tensor(q), u0.reshape(-1), g0.T,
                       torch.zeros(chains, dim), eps, 0.0, torch.tensor(imm),
                       noise=torch.tensor(z / np.sqrt(imm)),
                       u_accept=torch.full((chains,), 0.5))[4]
    np.testing.assert_allclose(stats[:, 1].numpy(), mala_accept, rtol=1e-5,
                               atol=1e-6)


def _jax_driver_streams(key, alpha, chains, dim, num_warmup, num_samples,
                        segment_draws, search=False):
    """The raw normals and uniforms that the JAX driver draws from ``key``
    with ``use_internal_prng=False`` (fused_driver.py:1237-1294), in the
    dtypes it draws them: float32 normals (``_draw_momentum``), the warmup's
    uniforms in the default dtype (``_external_randomness``).  With
    ``search`` the warmup key first splits off the initial-ε search's, whose
    probes' normals come last in the result."""
    f32 = jnp.float32
    warmup_key, sample_key = jax.random.split(key)
    normals = []
    if search:
        warmup_key, search_key = jax.random.split(warmup_key)
        for _ in range(16):
            search_key, sub = jax.random.split(search_key)
            normals.append(np.array(jax.random.normal(sub, (chains, dim), f32)))
    _, key_scan = jax.random.split(warmup_key)
    warmup = []
    for k in jax.random.split(key_scan, num_warmup):
        k1, _, k3, _ = jax.random.split(k, 4)
        warmup.append((np.array(jax.random.normal(k1, (chains, dim), f32)),
                       np.array(jax.random.uniform(k3, (chains, 1)))[:, 0]))
    if alpha:
        _, key_scan, key_p = jax.random.split(sample_key, 3)
        momentum = np.array(jax.random.normal(key_p, (chains, dim), f32))
    else:
        _, key_scan = jax.random.split(sample_key)
        momentum = None
    segments = []
    num_segments = -(-num_samples // segment_draws)
    for k in jax.random.split(key_scan, num_segments):
        knoise, kacc = jax.random.split(k)
        z = np.stack([np.array(jax.random.normal(kk, (chains, dim), f32))
                      for kk in jax.random.split(knoise, segment_draws)])
        u = np.array(jax.random.uniform(kacc, (segment_draws, chains), f32))
        segments.append((z, u))
    if search:
        return warmup, momentum, segments, normals
    return warmup, momentum, segments


@pytest.mark.parametrize("alpha", [0.0, 0.9])
def test_driver_matches_jax_sample_fused_ghmc(alpha, monkeypatch):
    pg_j, data_j, pg_t, data_t = _models()
    num_warmup, num_samples, seg = 25, 20, 8
    q0 = (0.1 * np.random.default_rng(4).normal(size=(CHAINS, DIM))).astype(F32)
    key = jax.random.PRNGKey(21)

    jax_moves = []
    base = jax_ghmc.make_fused_ghmc_transition

    def recording(*args, **kwargs):
        tr = base(*args, **kwargs)

        def wrapped(q, *rest, **kw):
            out = tr(q, *rest, **kw)
            jax.debug.callback(lambda m: jax_moves.append(np.array(m)),
                               jnp.any(out[0] != q, axis=1), ordered=True)
            return out

        return wrapped

    monkeypatch.setattr(jax_ghmc, "make_fused_ghmc_transition", recording)
    qj, pos_j, stats_j, eps_j, imm_j = jax_sample_ghmc(
        key, lambda q_t, *d: pg_j(q_t, *d)[0], list(data_j), jnp.asarray(q0),
        num_samples, num_warmup, alpha=alpha, potential_and_grad_t=pg_j,
        block_chains=8, use_internal_prng=False, interpret=True,
        segment_draws=seg,
    )

    warmup, momentum, segments = _jax_driver_streams(
        key, alpha, CHAINS, DIM, num_warmup, num_samples, seg)
    port_moves = []
    port_base = make_fused_ghmc_transition

    def port_recording(*args, **kwargs):
        tr = port_base(*args, **kwargs)

        def wrapped(q, *rest, **kw):
            out = tr(q, *rest, **kw)
            port_moves.append(torch.any(out[0] != q, dim=0).numpy())
            return out

        return wrapped

    import aehmc_tpu_torch.ops.fused_driver as port_driver

    monkeypatch.setattr(port_driver, "make_fused_ghmc_transition",
                        port_recording)
    qt, pos_t, stats_t, eps_t, imm_t = sample_fused_ghmc(
        None, None, data_t, torch.tensor(q0), num_samples, num_warmup,
        alpha=alpha, potential_and_grad_t=pg_t, use_internal_prng=False,
        segment_draws=seg, warmup_streams=lambda t: warmup[t],
        segment_streams=lambda s: segments[s],
        momentum_z=None if momentum is None else torch.tensor(momentum),
    )
    assert len(port_moves) == len(jax_moves) == num_warmup
    np.testing.assert_array_equal(np.stack(port_moves), np.stack(jax_moves))
    pos_j, stats_j = np.asarray(pos_j), np.asarray(stats_j)
    assert pos_t.shape == pos_j.shape == (num_samples, CHAINS, DIM)
    np.testing.assert_array_equal(stats_t[..., 2:5].numpy(), stats_j[..., 2:5])
    np.testing.assert_array_equal(_accepted(pos_t[1:], pos_t[:-1]),
                                  _accepted(pos_j[1:], pos_j[:-1]))
    np.testing.assert_allclose(float(eps_t), float(eps_j), rtol=1e-4)
    np.testing.assert_allclose(imm_t.numpy(), np.asarray(imm_j), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(pos_t.numpy(), pos_j, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("alpha", [0.0, 0.9])
def test_per_chain_driver_matches_jax_sample_fused_ghmc(alpha):
    """Per-chain dual averaging from the searched ε, snapped to 4 values at
    warmup's finish, then kernels 5 and 6's plain versions at the
    ``(chains,)`` ε, against JAX's driver on its own draws.  Short warmup
    (the fast stage): over longer per-chain runs float32 sums in another
    order drift until a near-tie decision flips."""
    pg_j, data_j, pg_t, data_t = _models()
    num_warmup, num_samples, seg = 12, 16, 8
    q0 = (0.1 * np.random.default_rng(6).normal(size=(CHAINS, DIM))).astype(F32)
    key = jax.random.PRNGKey(23)
    options = dict(per_chain_step_size=True, per_chain_quantiles=4,
                   search_initial_step_size=True, initial_step_size=0.01)
    qj, pos_j, stats_j, eps_j, imm_j = jax_sample_ghmc(
        key, lambda q_t, *d: pg_j(q_t, *d)[0], list(data_j), jnp.asarray(q0),
        num_samples, num_warmup, alpha=alpha, potential_and_grad_t=pg_j,
        block_chains=8, use_internal_prng=False, interpret=True,
        segment_draws=seg, **options)
    warmup, momentum, segments, normals = _jax_driver_streams(
        key, alpha, CHAINS, DIM, num_warmup, num_samples, seg, search=True)
    qt, pos_t, stats_t, eps_t, imm_t = sample_fused_ghmc(
        None, None, data_t, torch.tensor(q0), num_samples, num_warmup,
        alpha=alpha, potential_and_grad_t=pg_t, use_internal_prng=False,
        block_chains=8, segment_draws=seg,
        warmup_streams=lambda t: warmup[t],
        segment_streams=lambda s: segments[s],
        search_streams=lambda i: normals[i],
        momentum_z=None if momentum is None else torch.tensor(momentum),
        **options)
    eps_j, pos_j, stats_j = (np.asarray(a) for a in (eps_j, pos_j, stats_j))
    assert eps_t.shape == eps_j.shape == (CHAINS,)
    assert len(np.unique(eps_t.numpy())) <= 4
    # each chain's dual averaging scales its own acceptance's last-bit noise
    # by sqrt(step)/gamma, unpooled: ε to 1e-3, and the positions with it
    np.testing.assert_allclose(eps_t.numpy(), eps_j, rtol=1e-3)
    np.testing.assert_allclose(imm_t.numpy(), np.asarray(imm_j), rtol=1e-4)
    np.testing.assert_array_equal(stats_t[..., 2:5].numpy(), stats_j[..., 2:5])
    np.testing.assert_array_equal(_accepted(pos_t[1:], pos_t[:-1]),
                                  _accepted(pos_j[1:], pos_j[:-1]))
    np.testing.assert_allclose(pos_t.numpy(), pos_j, atol=1e-3)
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-3)


def test_segmentation_does_not_change_the_draws():
    _, _, pg_t, data_t = _models()
    q0 = 0.1 * torch.randn(CHAINS, DIM, generator=torch.Generator().manual_seed(0))
    outs = [
        sample_fused_mala(torch.Generator().manual_seed(6), None, data_t, q0,
                          64, 20, potential_and_grad_t=pg_t,
                          segment_draws=seg)
        for seg in (8, 32)
    ]
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert outs[0][1].shape == (64, CHAINS, DIM)


VAR = torch.tensor([0.5, 2.0, 1.0, 4.0])


def _gaussian_pg(q_t, var_col):
    return 0.5 * torch.sum(q_t * q_t / var_col, dim=0, keepdim=True), q_t / var_col


def _gaussian_run(seed, alpha):
    gen = torch.Generator().manual_seed(seed)
    q0 = torch.randn(64, 4, generator=gen) * VAR.sqrt()
    return sample_fused_ghmc(gen, None, (VAR.reshape(-1, 1),), q0, 300, 150,
                             alpha=alpha, potential_and_grad_t=_gaussian_pg,
                             segment_draws=32)


@pytest.mark.parametrize("alpha", [0.0, 0.9])
def test_moments_and_determinism_under_philox(alpha):
    qf, pos, stats, eps, imm = _gaussian_run(5, alpha)
    assert pos.shape == (300, 64, 4) and stats.shape == (300, 64, 8)
    assert 0.05 < float(eps) < 3.0
    assert 0.3 < float(stats[:, :, 1].mean()) < 1.0
    assert bool((stats[:, :, 3] == 1.0).all())
    draws = pos[100:].reshape(-1, 4).double()
    np.testing.assert_allclose(draws.mean(0).numpy(), 0.0, atol=0.35)
    np.testing.assert_allclose(draws.var(0).numpy(), VAR.numpy(), rtol=0.35)
    qf2, pos2, *_ = _gaussian_run(5, alpha)
    assert torch.equal(qf, qf2) and torch.equal(pos, pos2)
    if alpha:  # the momentum persists: not the α = 0 run
        assert not torch.equal(pos, _gaussian_run(5, 0.0)[1])


def test_driver_errors():
    _, _, pg_t, data_t = _models()
    q0 = torch.zeros(CHAINS, DIM)
    run = lambda **kw: sample_fused_ghmc(  # noqa: E731
        torch.Generator(), None, data_t, q0, 2, 2, potential_and_grad_t=pg_t,
        **kw)
    for alpha in (-0.1, 1.0):
        with pytest.raises(ValueError, match="alpha"):
            run(alpha=alpha)
    # the JAX driver's error; the per-chain and search options run
    with pytest.raises(ValueError, match="per_chain_step_size"):
        run(per_chain_quantiles=4)
    for option in ("per_chain_step_size", "search_initial_step_size"):
        eps = run(**{option: True})[3]
        assert bool(torch.isfinite(eps).all()) and bool((eps > 0).all())
        assert eps.shape == ((CHAINS,) if option == "per_chain_step_size"
                             else ())
    with pytest.raises(TypeError, match="alpha"):
        sample_fused_mala(None, None, data_t, q0, 2, 2, alpha=0.5,
                          potential_and_grad_t=pg_t)
    state_t = (q0.T, torch.zeros(1, CHAINS), q0.T)
    with pytest.raises(ValueError, match="diagonal"):
        ghmc_sampling(None, None, data_t, state_t, 0.1, torch.eye(DIM), 2,
                      potential_and_grad_t=pg_t)
    transition = make_fused_ghmc_transition(None, data_t,
                                            potential_and_grad_t=pg_t)
    with pytest.raises(ValueError, match="dense"):
        transition(q0, torch.zeros(CHAINS), q0, q0, 0.1, 0.0,
                   torch.eye(DIM), noise=q0, u_accept=torch.zeros(CHAINS))


def test_convert_ghmc_state():
    rng = np.random.default_rng(8)
    carry = [rng.normal(size=s).astype(F32)
             for s in ((4, 3), (4, 1), (4, 3), (4, 3))]
    out = convert.ghmc_state(*(jnp.asarray(a) for a in carry), device="cpu")
    for a, b in zip(out, carry):
        assert a.device.type == "cpu"
        np.testing.assert_array_equal(a.numpy(), b)
