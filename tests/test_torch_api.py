"""The port's front door: aehmc_tpu_torch.sample(algorithm="nuts" | "mala" |
"ghmc", path="fused") runs the plain versions on the CPU (its run on a card
is in ``test_torch_cuda.py``); every unported route raises
NotImplementedError (the XLA and pooled routes are in
``test_torch_xla_sampling.py``)."""

import subprocess
import sys

import numpy as np
import pytest
import torch

import aehmc_tpu_torch


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


@pytest.mark.parametrize("algorithm", ["hmc", "meads"])
def test_unported_algorithms_raise(algorithm):
    """MEADS is not ported (ROADMAP.md item 1.11); HMC is, on the XLA and
    pooled paths, and has no fused route, as in the JAX package."""
    error, match = ((ValueError, "no fused megakernel") if algorithm == "hmc"
                    else (NotImplementedError, "ROADMAP.md"))
    with pytest.raises(error, match=match):
        aehmc_tpu_torch.sample(None, lambda q: -q @ q, torch.zeros(8, 4),
                               algorithm=algorithm, path="fused",
                               potential_and_grad_t=_gaussian_pg)


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
    with pytest.raises(NotImplementedError, match="item 1.12"):
        _chees_route(draws=2, mesh=object())


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
    with pytest.raises(NotImplementedError, match="item 1.12"):
        _ghmc_route("mala", mesh=object())
    with pytest.raises(TypeError, match="unexpected"):
        _ghmc_route("mala", max_num_expansions=6)


@pytest.mark.parametrize("path", ["xla", "pooled"])
def test_unported_paths_raise(path):
    """The XLA and pooled paths run; what of them is not ported raises,
    naming its ROADMAP.md item: MEADS (1.11) and a mesh (1.12)."""
    with pytest.raises(NotImplementedError, match="item 1.11"):
        aehmc_tpu_torch.sample(None, lambda q: -q @ q, torch.zeros(8, 4),
                               path=path, algorithm="meads")
    with pytest.raises(NotImplementedError, match="item 1.12"):
        aehmc_tpu_torch.sample(None, lambda q: -q @ q, torch.zeros(8, 4),
                               path=path, mesh=object())


def test_bare_logprob_and_bad_names():
    """A bare logprob_fn on the fused path needs the generic fused binding
    (ROADMAP.md item 1.10); on the default path it runs pooled."""
    with pytest.raises(NotImplementedError, match="item 1.10"):
        aehmc_tpu_torch.sample(None, lambda q: -q @ q, torch.zeros(8, 4),
                               path="fused")
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
        "aehmc_tpu_torch.ops.nuts_fused\n"
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
