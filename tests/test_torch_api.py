"""The port's front door: aehmc_tpu_torch.sample(algorithm="nuts",
path="fused") runs the plain versions on the CPU (its run on a card is in
``test_torch_cuda.py``); every unported route raises NotImplementedError."""

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


@pytest.mark.parametrize("algorithm", ["hmc", "chees", "meads", "ghmc", "mala"])
def test_unported_algorithms_raise(algorithm):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        aehmc_tpu_torch.sample(None, None, torch.zeros(8, 4), algorithm=algorithm,
                               path="fused", potential_and_grad_t=_gaussian_pg)


@pytest.mark.parametrize("path", ["xla", "pooled"])
def test_unported_paths_raise(path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        aehmc_tpu_torch.sample(None, lambda q: -q @ q, torch.zeros(8, 4),
                               path=path)


def test_bare_logprob_and_bad_names():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        aehmc_tpu_torch.sample(None, lambda q: -q @ q, torch.zeros(8, 4))
    with pytest.raises(ValueError, match="algorithm"):
        aehmc_tpu_torch.sample(None, None, torch.zeros(8, 4), algorithm="x")
    with pytest.raises(ValueError, match="path"):
        aehmc_tpu_torch.sample(None, None, torch.zeros(8, 4), path="x")


def test_import_loads_no_jax():
    code = (
        "import sys, aehmc_tpu_torch, aehmc_tpu_torch.ops.fused_driver, "
        "aehmc_tpu_torch.convert, aehmc_tpu_torch.ops._build\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
