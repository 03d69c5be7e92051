"""The port's front door: aehmc_tpu_torch.sample(algorithm="nuts" | "mala" |
"ghmc" | "meads", path="fused") runs the plain versions on the CPU (its run
on a card is in ``test_torch_cuda.py``), a mesh shards its chains (the
sharded runs are in ``test_torch_sharded.py``; the XLA and pooled routes
are in ``test_torch_xla_sampling.py``)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import aehmc_tpu_torch
from aehmc_tpu_torch.parallel import make_mesh


VAR = torch.tensor([0.5, 1.0, 2.0, 4.0])


def _gaussian_pg(q_t, var_col):
    return (0.5 * torch.sum(q_t * q_t / var_col, dim=0, keepdim=True),
            q_t / var_col)


def _gaussian_run(seed, draws=200):
    gen = torch.Generator().manual_seed(seed)
    q0 = 0.1 * torch.randn(64, 4, generator=gen)
    return aehmc_tpu_torch.sample(
        gen, None, q0, draws, 150, algorithm="nuts", path="fused",
        data=(VAR.reshape(-1, 1),), potential_and_grad_t=_gaussian_pg,
        max_num_expansions=5,
    )


def test_front_door_shapes_dtypes_and_moments():
    res = _gaussian_run(0)
    assert isinstance(res, aehmc_tpu_torch.SampleResult)
    assert res.positions.shape == (200, 64, 4)
    assert res.final_state.shape == (64, 4)
    diag = res.diagnostics
    assert diag.acceptance_probability.shape == (200, 64)
    assert diag.num_doublings.dtype == torch.int32
    assert diag.num_integration_steps.dtype == torch.int32
    assert diag.is_turning.dtype == torch.bool
    assert diag.is_diverging.dtype == torch.bool
    assert diag.energy.dtype == torch.float32
    assert res.step_size.ndim == 0 and res.inverse_mass_matrix.shape == (4,)
    assert 0.6 < float(diag.acceptance_probability.mean()) < 0.95
    assert int(diag.is_diverging.sum()) == 0
    flat = res.positions[50:].reshape(-1, 4).numpy().astype(np.float64)
    assert np.all(np.abs(flat.mean(axis=0)) < 0.15 * np.sqrt(VAR.numpy()))
    np.testing.assert_allclose(flat.var(axis=0), VAR.numpy(), rtol=0.15)
    # the tuned diagonal metric tracks the posterior variances
    np.testing.assert_allclose(res.inverse_mass_matrix.numpy(), VAR.numpy(),
                               rtol=0.5)


def test_front_door_is_reproducible_from_the_generator():
    a, b = _gaussian_run(3, draws=5), _gaussian_run(3, draws=5)
    assert torch.equal(a.positions, b.positions)
    assert torch.equal(a.final_state, b.final_state)


def _gaussian_lp(q):
    return -0.5 * torch.sum(q * q / VAR)


@pytest.mark.parametrize("algorithm", ["hmc", "meads"])
def test_unported_algorithms_raise(algorithm):
    """HMC has no fused route, as in the JAX package (it runs on the XLA and
    pooled paths); MEADS has one: the pooled MEADS driver over the GHMC
    kernels' plain versions on the CPU."""
    if algorithm == "hmc":
        with pytest.raises(ValueError, match="no fused megakernel"):
            aehmc_tpu_torch.sample(None, lambda q: -q @ q, torch.zeros(8, 4),
                                   algorithm=algorithm, path="fused",
                                   potential_and_grad_t=_gaussian_pg)
        return
    gen = torch.Generator().manual_seed(4)
    q0 = torch.randn(8, 4, generator=gen)
    res = aehmc_tpu_torch.sample(gen, _gaussian_lp, q0, 12, 16,
                                 algorithm=algorithm, path="fused",
                                 data=(VAR.reshape(-1, 1),),
                                 potential_and_grad_t=_gaussian_pg)
    assert res.positions.shape == (12, 8, 4)
    assert res.diagnostics.acceptance_probability.shape == (12, 8)
    assert res.step_size.ndim == 0 and res.inverse_mass_matrix.shape == (4,)
    assert bool(torch.isfinite(res.positions).all())


def _ghmc_route(algorithm, seed=0, draws=40, **kw):
    gen = torch.Generator().manual_seed(seed)
    q0 = 0.1 * torch.randn(16, 4, generator=gen)
    return aehmc_tpu_torch.sample(
        gen, None, q0, draws, 30, algorithm=algorithm, path="fused",
        data=(VAR.reshape(-1, 1),), potential_and_grad_t=_gaussian_pg,
        segment_draws=16, **kw,
    )


@pytest.mark.parametrize("algorithm", ["mala", "ghmc"])
def test_mala_and_ghmc_routes_shapes_and_diagnostics(algorithm):
    res = _ghmc_route(algorithm)
    assert isinstance(res, aehmc_tpu_torch.SampleResult)
    assert res.positions.shape == (40, 16, 4) and res.final_state.shape == (16, 4)
    diag = res.diagnostics
    assert diag.acceptance_probability.shape == (40, 16)
    assert int(diag.num_doublings.abs().sum()) == 0
    assert not bool(diag.is_turning.any())
    assert bool((diag.num_integration_steps == 1).all())
    assert diag.num_integration_steps.dtype == torch.int32
    assert diag.is_diverging.dtype == torch.bool
    assert res.step_size.ndim == 0 and res.inverse_mass_matrix.shape == (4,)
    assert bool(torch.isfinite(res.positions).all())
    b = _ghmc_route(algorithm)
    assert torch.equal(res.positions, b.positions)


def _chees_route(seed=0, draws=40, **kw):
    gen = torch.Generator().manual_seed(seed)
    q0 = torch.randn(16, 4, generator=gen) * VAR.sqrt()
    return aehmc_tpu_torch.sample(
        gen, lambda x: -0.5 * torch.sum(x * x / VAR), q0, draws, 60,
        algorithm="chees", path="fused", data=(VAR.reshape(-1, 1),),
        potential_and_grad_t=_gaussian_pg, **kw,
    )


def test_chees_route_shapes_and_diagnostics():
    res = _chees_route()
    assert isinstance(res, aehmc_tpu_torch.SampleResult)
    assert res.positions.shape == (40, 16, 4)
    assert isinstance(res.final_state, aehmc_tpu_torch.ChainState)
    assert res.final_state.position.shape == (16, 4)
    assert torch.equal(res.final_state.position, res.positions[-1])
    diag = res.diagnostics
    for field in diag._fields:
        assert getattr(diag, field).shape == (40, 16), field
    assert diag.num_doublings.dtype == torch.int32
    assert int(diag.num_doublings.abs().sum()) == 0
    assert diag.is_turning.dtype == torch.bool and not bool(diag.is_turning.any())
    assert diag.is_diverging.dtype == torch.bool
    assert diag.energy.dtype == torch.float32
    steps = diag.num_integration_steps
    assert steps.dtype == torch.int32 and bool((steps >= 1).all())
    assert bool((steps == steps[:, :1]).all())  # one trip count per draw
    assert len(set(steps[:, 0].tolist())) > 2  # Halton-jittered
    assert res.step_size.ndim == 0 and res.inverse_mass_matrix.shape == (4,)
    assert bool(torch.isfinite(res.positions).all())
    assert torch.equal(res.positions, _chees_route().positions)


def test_chees_route_needs_logprob_fn_and_takes_kernel_options():
    with pytest.raises(ValueError, match="logprob_fn"):
        aehmc_tpu_torch.sample(None, None, torch.zeros(8, 4), algorithm="chees",
                               path="fused", potential_and_grad_t=_gaussian_pg)
    external = _chees_route(seed=1, draws=5, use_internal_prng=False,
                            block_chains=8, divergence_threshold=500.0)
    factors = _chees_route(seed=1, draws=5,
                           step_size_factors=torch.full((16,), 0.5))
    assert external.positions.shape == factors.positions.shape == (5, 16, 4)
    # a mesh shards the fused ChEES kernel: the unsharded run's bits
    sharded = _chees_route(seed=1, draws=5, mesh=make_mesh(
        devices=[torch.device("cpu")] * 4))
    assert torch.equal(sharded.positions,
                       _chees_route(seed=1, draws=5).positions)


def test_ghmc_alpha_is_the_momentum_persistence():
    default = _ghmc_route("ghmc", seed=2, draws=8)
    explicit = _ghmc_route("ghmc", seed=2, draws=8, ghmc_alpha=0.9)
    mala = _ghmc_route("mala", seed=2, draws=8)
    zero = _ghmc_route("ghmc", seed=2, draws=8, ghmc_alpha=0.0)
    assert torch.equal(default.positions, explicit.positions)
    assert torch.equal(mala.positions, zero.positions)
    assert not torch.equal(default.positions, mala.positions)


def test_mala_and_ghmc_route_errors():
    with pytest.raises(TypeError, match="ghmc_alpha"):
        _ghmc_route("mala", ghmc_alpha=0.5)
    with pytest.raises(ValueError, match="alpha"):
        _ghmc_route("ghmc", ghmc_alpha=1.5)
    with pytest.raises(ValueError, match="single-host"):
        _ghmc_route("mala", mesh=make_mesh(devices=[torch.device("cpu")] * 2))
    with pytest.raises(TypeError, match="unexpected"):
        _ghmc_route("mala", max_num_expansions=6)


@pytest.mark.parametrize("algorithm", ["mala", "ghmc"])
def test_alpha_on_the_mala_and_ghmc_door_is_a_pointed_type_error(algorithm):
    """``alpha=`` (not ``ghmc_alpha=``) raises naming ``ghmc_alpha``, not a
    raw "multiple values for keyword argument" ``TypeError``."""
    with pytest.raises(TypeError, match="ghmc_alpha") as err:
        _ghmc_route(algorithm, alpha=0.5)
    assert "multiple values" not in str(err.value)


@pytest.mark.parametrize("algorithm", ["mala", "ghmc"])
def test_a_dense_metric_error_names_the_sampler(algorithm):
    from aehmc_tpu_torch.ops.fused_driver import _diag_im, ghmc_sampling

    with pytest.raises(ValueError, match="MALA/GHMC warmup"):
        _diag_im(torch.eye(4), 4, "cpu", "the fused MALA/GHMC warmup")
    state = (torch.zeros(4, 8), torch.zeros(8), torch.zeros(4, 8))
    with pytest.raises(ValueError, match=f"^{algorithm.upper()} supports"):
        ghmc_sampling(torch.Generator().manual_seed(0), None,
                      (VAR.reshape(-1, 1),), state, 0.1, torch.eye(4), 8,
                      alpha=0.0 if algorithm == "mala" else 0.9,
                      potential_and_grad_t=_gaussian_pg)


@pytest.mark.parametrize("path", ["xla", "pooled"])
def test_unported_paths_raise(path):
    """The XLA and pooled paths run, MEADS on both (a chain ensemble: its
    XLA route is the pooled driver, as in the JAX package); a mesh shards
    its chains, bit for bit the unsharded run, and raises the JAX package's
    error when the chains do not split over it."""
    q0 = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    res = aehmc_tpu_torch.sample(0, _gaussian_lp, q0, 6, 6, path=path,
                                 algorithm="meads")
    assert res.positions.shape == (6, 8, 4)
    sharded = aehmc_tpu_torch.sample(
        0, _gaussian_lp, q0, 6, 6, path=path, algorithm="meads",
        mesh=make_mesh(devices=[torch.device("cpu")] * 2))
    assert torch.equal(sharded.positions, res.positions)
    # one chain: JAX's errors, by route
    match = "chain-ensemble" if path == "xla" else "chains, dim"
    with pytest.raises(ValueError, match=match):
        aehmc_tpu_torch.sample(0, _gaussian_lp, torch.zeros(4), path=path,
                               algorithm="meads")
    with pytest.raises(ValueError, match="8 chains do not shard over 3"):
        aehmc_tpu_torch.sample(None, lambda q: -q @ q, torch.zeros(8, 4),
                               path=path, algorithm="meads",
                               mesh=make_mesh(devices=[torch.device("cpu")]
                                              * 3))


def test_bare_logprob_and_bad_names():
    """A bare logprob_fn on the fused path takes the generic fused binding
    and runs NUTS, as the JAX package's front door does
    (tests/test_api.py:test_fused_nuts_generic_potential): on CPU tensors
    through the plain versions, with the stats adapted into Diagnostics."""
    gen = torch.Generator().manual_seed(3)
    q0 = torch.randn(8, 4, generator=gen)
    out = aehmc_tpu_torch.sample(gen, _gaussian_lp, q0, num_samples=30,
                                 num_warmup=50, path="fused",
                                 max_num_expansions=4)
    assert isinstance(out, aehmc_tpu_torch.SampleResult)
    assert out.positions.shape == (30, 8, 4)
    assert bool(torch.isfinite(out.positions).all())
    assert out.diagnostics.acceptance_probability.shape == (30, 8)
    assert out.diagnostics.num_integration_steps.dtype == torch.int32
    assert float(out.diagnostics.acceptance_probability.mean()) > 0.3
    assert 0.01 < float(out.step_size) < 5.0
    with pytest.raises(ValueError, match="algorithm"):
        aehmc_tpu_torch.sample(None, None, torch.zeros(8, 4), algorithm="x")
    with pytest.raises(ValueError, match="path"):
        aehmc_tpu_torch.sample(None, None, torch.zeros(8, 4), path="x")


def test_import_loads_no_jax():
    code = (
        "import sys, aehmc_tpu_torch, aehmc_tpu_torch.ops.fused_driver, "
        "aehmc_tpu_torch.convert, aehmc_tpu_torch.ops._build, "
        "aehmc_tpu_torch.chees, aehmc_tpu_torch.hmc, "
        "aehmc_tpu_torch.parallel.pooled, aehmc_tpu_torch.ops.chees_fused, "
        "aehmc_tpu_torch.ops.nuts_fused, aehmc_tpu_torch.meads, "
        "aehmc_tpu_torch.checkpoint, aehmc_tpu_torch.observability, "
        "aehmc_tpu_torch.parallel.mesh\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("algorithm", ["nuts", "mala", "ghmc", "chees"])
def test_fused_routes_take_the_builders_default_bf16_data(algorithm):
    """The fused routes on the logistic builder's default data (bfloat16
    X and Xᵀ, as the JAX builder's) run the plain bf16 versions on the CPU:
    finite draws of the right shape, and another chain path than the same
    run on float32 data (the rounded target)."""
    from aehmc_tpu_torch.models import (
        logistic_regression,
        logistic_regression_pg_t,
    )

    runs = []
    for dtype in (torch.bfloat16, torch.float32):
        pot, pg, data, _ = logistic_regression_pg_t(
            4, 32, matmul_dtype=dtype, device="cpu")
        assert data[0].dtype == dtype and data[1].dtype == dtype
        gen = torch.Generator().manual_seed(5)
        q0 = 0.1 * torch.randn(16, 4, generator=gen)
        kw = dict(data=data, potential_and_grad_t=pg, algorithm=algorithm,
                  path="fused", initial_step_size=0.1)
        logprob_fn = None
        if algorithm == "chees":
            logprob_fn = logistic_regression(4, 32, device="cpu")[0]
        else:
            kw["potential_fn_t"] = pot
        if algorithm == "nuts":
            kw["max_num_expansions"] = 4
        runs.append(aehmc_tpu_torch.sample(gen, logprob_fn, q0, 12, 20, **kw))
    bf16, f32 = runs
    assert bf16.positions.shape == (12, 16, 4)
    assert bool(torch.isfinite(bf16.positions.float()).all())
    assert not torch.equal(bf16.positions, f32.positions)


def _count_ghmc_plain_calls(monkeypatch):
    """Count the calls of kernels 6 and 5's plain versions (the launches a
    card would make); a segment's own transitions are counted apart."""
    from aehmc_tpu_torch.ops import ghmc_fused

    counts = {"segment": 0, "transition": 0, "in_segment": 0}
    segment, transition = (ghmc_fused.ghmc_segment_plain,
                           ghmc_fused.ghmc_transition_plain)

    def counting_segment(*args, **kw):
        counts["segment"] += 1
        before = counts["transition"]
        out = segment(*args, **kw)
        counts["in_segment"] += counts["transition"] - before
        return out

    def counting_transition(*args, **kw):
        counts["transition"] += 1
        return transition(*args, **kw)

    monkeypatch.setattr(ghmc_fused, "ghmc_segment_plain", counting_segment)
    monkeypatch.setattr(ghmc_fused, "ghmc_transition_plain",
                        counting_transition)
    return counts


@pytest.mark.parametrize("checkpointed", [False, True])
def test_fused_meads_takes_the_segment_or_the_transition(monkeypatch,
                                                        tmp_path,
                                                        checkpointed):
    """Without ``checkpoint_every`` the fused MEADS route runs kernel 6, one
    call a ``meads_recompute_every`` (8) segment: 2 + 2 for 16 burn-in and
    12 draws, no transition of its own; with it, kernel 5 once a draw."""
    counts = _count_ghmc_plain_calls(monkeypatch)
    gen = torch.Generator().manual_seed(1)
    q0 = torch.randn(8, 4, generator=gen)
    kw = (dict(checkpoint_every=5, checkpoint_path=str(tmp_path / "m.npz"))
          if checkpointed else {})
    res = aehmc_tpu_torch.sample(gen, _gaussian_lp, q0, 12, 16,
                                 algorithm="meads", path="fused",
                                 data=(VAR.reshape(-1, 1),),
                                 potential_and_grad_t=_gaussian_pg, **kw)
    assert res.positions.shape == (12, 8, 4)
    direct = counts["transition"] - counts["in_segment"]
    if checkpointed:
        assert counts["segment"] == 0 and direct == 12 + 16
    else:
        assert counts["segment"] == 4 and direct == 0


def _route_of(sample_fn, monkeypatch, target, path, position):
    """What a front door does with MEADS at ``path`` and ``position``: the
    algorithm and the fused adapter it hands the pooled driver, or the
    error it raises."""
    calls = []

    def record(rng, logprob_fn, initial_positions, *args, **kw):
        calls.append((kw.get("algorithm"),
                      kw.get("meads_segment_fn") is not None,
                      kw.get("meads_transition_fn") is not None))
        return "ran"

    monkeypatch.setattr(target[0], target[1], record)
    pg = {"potential_and_grad_t": position[1]} if position[1] else {}
    try:
        sample_fn(position[0], algorithm="meads", path=path, **pg)
    except ValueError as err:
        return ("ValueError", str(err).split(";")[0][:40])
    return calls[0]


# every route, a bare logprob_fn on the fused path included (the generic
# fused binding)
_MEADS_ROUTES = [(path, rank, pot)
                 for path in ("auto", "xla", "pooled", "fused")
                 for rank in (1, 2) for pot in (False, True)]


@pytest.mark.parametrize("path, rank, with_potential", _MEADS_ROUTES)
def test_meads_route_resolution_equals_jax(monkeypatch, path, rank,
                                           with_potential):
    import jax.numpy as jnp

    import aehmc_tpu
    import aehmc_tpu.parallel.pooled as jax_pooled
    from aehmc_tpu_torch import api

    shape = (8, 4) if rank == 2 else (4,)

    def jax_pg(q_t, var_col):
        return 0.5 * jnp.sum(q_t * q_t, axis=0), q_t

    jax_route = _route_of(
        lambda q, **kw: aehmc_tpu.sample(
            None, lambda x: -jnp.sum(x * x), q, 4, 4,
            data=(jnp.ones((4, 1)),), **kw),
        monkeypatch, (jax_pooled, "sample_sharded"), path,
        (jnp.zeros(shape), jax_pg if with_potential else None))
    port_route = _route_of(
        lambda q, **kw: aehmc_tpu_torch.sample(
            None, _gaussian_lp, q, 4, 4, data=(VAR.reshape(-1, 1),), **kw),
        monkeypatch, (api, "sample_sharded"), path,
        (torch.zeros(shape), _gaussian_pg if with_potential else None))
    assert port_route == jax_route


def test_fused_nuts_route_takes_checkpoints(tmp_path):
    """The front door's whole-run default gives way to the per-draw loop
    when the run is checkpointed, as the JAX front door runs it; the draws
    are the same bits."""
    plain = _gaussian_run(2, draws=12)
    gen = torch.Generator().manual_seed(2)
    q0 = 0.1 * torch.randn(64, 4, generator=gen)
    checkpointed = aehmc_tpu_torch.sample(
        gen, None, q0, 12, 150, algorithm="nuts", path="fused",
        data=(VAR.reshape(-1, 1),), potential_and_grad_t=_gaussian_pg,
        max_num_expansions=5, checkpoint_every=5,
        checkpoint_path=str(tmp_path / "nuts.npz"))
    assert torch.equal(plain.positions, checkpointed.positions)
    assert torch.equal(plain.final_state, checkpointed.final_state)
