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
