"""The port's flagship model and state converter against aehmc_tpu."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aehmc_tpu.models import logistic_regression as jax_logistic
from aehmc_tpu.models import logistic_regression_data as jax_data
from aehmc_tpu.models import logistic_regression_pg_t as jax_pg_builder
from aehmc_tpu_torch import convert
from aehmc_tpu_torch.models import (
    logistic_regression,
    logistic_regression_data,
    logistic_regression_pg_t,
)


@pytest.mark.parametrize("dim, points", [(100, 1000), (8, 64)])
def test_logistic_data_bit_identical(dim, points):
    X, y = logistic_regression_data(dim, points, device="cpu")
    Xj, yj = jax_data(dim, points)
    assert X.dtype == torch.float32 and y.dtype == torch.float32
    np.testing.assert_array_equal(X.numpy(), np.asarray(Xj))
    np.testing.assert_array_equal(y.numpy(), np.asarray(yj))


def test_pg_t_equals_jax_float32():
    dim, points, chains = 16, 200, 24
    pot, pg, data, ex = logistic_regression_pg_t(dim, points, device="cpu")
    pot_j, pg_j, data_j, _ = jax_pg_builder(dim, points,
                                            matmul_dtype=jnp.float32)
    q_t = np.random.default_rng(0).normal(size=(dim, chains)).astype(np.float32)
    u, g = pg(torch.tensor(q_t), *data)
    uj, gj = pg_j(jnp.asarray(q_t), *data_j)
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(pot(torch.tensor(q_t), *data).numpy(),
                               np.asarray(pot_j(jnp.asarray(q_t), *data_j)),
                               rtol=1e-5)
    assert ex.shape == (dim,)


def test_logprob_equals_jax():
    logprob, q0 = logistic_regression(10, 100, device="cpu")
    logprob_j, _ = jax_logistic(10, 100)
    w = np.random.default_rng(1).normal(size=10).astype(np.float32)
    np.testing.assert_allclose(float(logprob(torch.tensor(w))),
                               float(logprob_j(jnp.asarray(w))), rtol=1e-5)
    assert torch.equal(q0, torch.zeros(10))


def test_bf16_operands_not_ported_yet():
    with pytest.raises(NotImplementedError, match="1.4"):
        logistic_regression_pg_t(8, 64, matmul_dtype=torch.bfloat16,
                                 device="cpu")


def test_convert_carries_data_state_and_parameters():
    _, _, data_j, _ = jax_pg_builder(8, 64, matmul_dtype=jnp.float32)
    X, XT, y = convert.model_data(*[np.asarray(d) for d in data_j],
                                  device="cpu")
    _, _, data_t, _ = logistic_regression_pg_t(8, 64, device="cpu")
    for a, b in zip((X, XT, y), data_t):
        assert torch.equal(a, b) and a.is_contiguous()
    rng = np.random.default_rng(2)
    q, u, g = (rng.normal(size=s).astype(np.float32)
               for s in ((5, 8), (5, 1), (5, 8)))
    for a, b in zip(convert.chain_state(jnp.asarray(q), jnp.asarray(u),
                                        jnp.asarray(g), device="cpu"),
                    (q, u, g)):
        np.testing.assert_array_equal(a.numpy(), b)
    eps, imm = convert.tuned_parameters(jnp.asarray(0.5, jnp.float32),
                                        jnp.ones(8, jnp.float32), device="cpu")
    assert eps.dtype == torch.float32 and eps.ndim == 0 and imm.shape == (8,)


@pytest.mark.parametrize("build", [
    lambda **kw: logistic_regression_data(8, 64, **kw)[0],
    lambda **kw: logistic_regression(8, 64, **kw)[1],
    lambda **kw: logistic_regression_pg_t(8, 64, **kw)[2][0],
    lambda **kw: convert.to_tensor(np.ones(3, np.float32), **kw),
    lambda **kw: convert.ghmc_state(*[np.ones((2, 3), np.float32)] * 4,
                                    **kw)[3],
])
def test_builders_and_converters_default_to_the_card(build):
    """With no ``device=`` the tensors go to the card: on a machine without
    one that raises, and ``device="cpu"`` is the explicit way to the host."""
    assert build(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert build().device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            build()
