"""The port's R-hat and ESS against aehmc_tpu.diagnostics on the same draws
(float64; the FFTs and sorts are different code, so rtol 1e-8)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aehmc_tpu import diagnostics as jd
from aehmc_tpu_torch import diagnostics as td


def _draws(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape)
    # AR(1) along the draw axis so the ESS is well below the draw count
    for t in range(1, shape[1]):
        x[:, t] = 0.7 * x[:, t - 1] + x[:, t]
    return x


@pytest.mark.parametrize("shape", [(4, 200), (4, 201, 3)])
@pytest.mark.parametrize(
    "name, kwargs",
    [
        ("potential_scale_reduction", {}),
        ("potential_scale_reduction", {"rank_normalized": True}),
        ("effective_sample_size", {}),
        ("effective_sample_size", {"rank_normalized": False}),
        ("tail_effective_sample_size", {}),
    ],
)
def test_diagnostic_equals_jax(name, kwargs, shape):
    x = _draws(shape)
    ours = getattr(td, name)(torch.tensor(x), **kwargs).numpy()
    ref = np.asarray(getattr(jd, name)(jnp.asarray(x), **kwargs))
    np.testing.assert_allclose(ours, ref, rtol=1e-8)


def test_mcse_equals_jax():
    x = _draws((4, 200, 3), seed=1)
    mc, ess = td.mcse(torch.tensor(x))
    mc_j, ess_j = jd.mcse(jnp.asarray(x))
    np.testing.assert_allclose(mc.numpy(), np.asarray(mc_j), rtol=1e-8)
    np.testing.assert_allclose(ess.numpy(), np.asarray(ess_j), rtol=1e-8)


@pytest.mark.parametrize("ar", [0.7, -0.9])
def test_summary_equals_jax(ar):
    """Every column; at ar −0.9 (antithetic draws) the raw ESS passes the
    draw count and both ESS columns are capped at chains × draws."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 200, 3))
    for t in range(1, 200):
        x[:, t] = ar * x[:, t - 1] + x[:, t]
    ours = td.summary(torch.tensor(x))
    ref = jd.summary(jnp.asarray(x))
    assert sorted(ours) == sorted(ref)
    for key in ref:
        np.testing.assert_allclose(ours[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-8, err_msg=key)
    if ar < 0:
        assert float(td.effective_sample_size(torch.tensor(x)).max()) > 800
        assert float(ours["ess_bulk"].max()) == 800


@pytest.mark.parametrize("shape, draw_axis", [((200, 4, 3), 0),
                                              ((4, 200, 3), 1),
                                              ((200, 1), 0)])
def test_to_inference_data_dict_equals_jax(shape, draw_axis):
    from aehmc_tpu.types import Diagnostics as JaxDiagnostics
    from aehmc_tpu_torch.types import Diagnostics

    x = _draws(shape, seed=3)
    stat_shape = shape[:-1]
    rng = np.random.default_rng(4)
    fields = dict(
        acceptance_probability=rng.uniform(size=stat_shape),
        num_doublings=rng.integers(0, 6, size=stat_shape).astype(np.int32),
        is_turning=rng.uniform(size=stat_shape) < 0.5,
        is_diverging=rng.uniform(size=stat_shape) < 0.1,
        energy=rng.normal(size=stat_shape),
        num_integration_steps=rng.integers(1, 64, size=stat_shape).astype(
            np.int32),
    )
    ours = td.to_inference_data_dict(
        torch.tensor(x), Diagnostics(**{k: torch.tensor(v)
                                        for k, v in fields.items()}),
        draw_axis=draw_axis)
    ref = jd.to_inference_data_dict(
        jnp.asarray(x), JaxDiagnostics(**{k: jnp.asarray(v)
                                          for k, v in fields.items()}),
        draw_axis=draw_axis)
    assert ours.keys() == ref.keys()
    for group in ref:
        assert list(ours[group]) == list(ref[group])
        for key, val in ref[group].items():
            assert isinstance(ours[group][key], np.ndarray)
            assert ours[group][key].dtype == np.asarray(val).dtype
            np.testing.assert_array_equal(ours[group][key], np.asarray(val))
    named = td.to_inference_data_dict(torch.tensor(x), param_names=[
        f"w{i}" for i in range(shape[-1])], draw_axis=draw_axis)
    assert list(named) == ["posterior"]
    assert list(named["posterior"]) == [f"w{i}" for i in range(shape[-1])]
