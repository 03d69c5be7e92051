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
    pot, pg, data, ex = logistic_regression_pg_t(
        dim, points, matmul_dtype=torch.float32, device="cpu")
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


def _bf16_f64(a):
    """float64 copy of ``a`` rounded to bfloat16 (nearest even)."""
    return torch.tensor(np.asarray(a, np.float32)).to(torch.bfloat16).double()


@pytest.mark.parametrize("dim, points", [(100, 1000), (8, 64)])
def test_default_builder_returns_the_reference_bf16_data(dim, points):
    """With no matmul_dtype both builders return X and Xᵀ rounded to
    bfloat16 (nearest even), bit for bit, and y_col float32."""
    _, _, data, _ = logistic_regression_pg_t(dim, points, device="cpu")
    _, _, data_j, _ = jax_pg_builder(dim, points)
    for a, b in zip(data[:2], data_j[:2]):
        assert a.dtype == torch.bfloat16 and str(b.dtype) == "bfloat16"
        assert a.is_contiguous()
        np.testing.assert_array_equal(a.view(torch.int16).numpy(),
                                      np.asarray(b).view(np.int16))
    assert data[2].dtype == torch.float32
    np.testing.assert_array_equal(data[2].numpy(), np.asarray(data_j[2]))
    with pytest.raises(ValueError, match="matmul_dtype"):
        logistic_regression_pg_t(dim, points, matmul_dtype=torch.float16,
                                 device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_bf16_potential_and_gradient_equal_jax_default(seed):
    """The port's potential and gradient with the default (bfloat16) data
    against the JAX builder's defaults, and both against float64 sums of the
    same rounded operands (q and σ − y rounded once, products exact).
    Tolerances: float32 sums of 200 terms, relative 2e-5 (potential) and
    absolute 2e-5 (gradient); σ − y rounds from each side's float32
    logits, so the gradient against float64 allows one bfloat16 step of a
    residual (2^-9) times the data's largest |x| per point that moves."""
    dim, points, chains = 16, 200, 24
    pot, pg, data, _ = logistic_regression_pg_t(dim, points, device="cpu")
    pot_j, pg_j, data_j, _ = jax_pg_builder(dim, points)
    q_t = np.random.default_rng(seed).normal(
        scale=0.5, size=(dim, chains)).astype(np.float32)
    u, g = pg(torch.tensor(q_t), *data)
    uj, gj = pg_j(jnp.asarray(q_t), *data_j)
    assert u.dtype == torch.float32 and g.dtype == torch.float32
    np.testing.assert_allclose(u.numpy(), np.asarray(uj), rtol=2e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(pot(torch.tensor(q_t), *data).numpy(),
                               np.asarray(pot_j(jnp.asarray(q_t), *data_j)),
                               rtol=2e-5)
    # float64 of the rounded operands
    X64, y64 = _bf16_f64(data_j[0]), torch.tensor(np.asarray(data_j[2]),
                                                  dtype=torch.float64)
    q64 = torch.tensor(q_t, dtype=torch.float64)
    logits = X64 @ _bf16_f64(q_t)
    sp = torch.clamp(logits, min=0) + torch.log1p(torch.exp(-logits.abs()))
    u64 = -(y64 * logits - sp).sum(0, keepdim=True) + 0.5 * (q64 * q64).sum(
        0, keepdim=True)
    resid = torch.sigmoid(logits) - y64
    g64 = X64.T @ _bf16_f64(resid.float().numpy()) + q64
    np.testing.assert_allclose(u.double().numpy(), u64.numpy(), rtol=2e-5)
    step = 2.0 ** -9 * float(X64.abs().max())
    np.testing.assert_allclose(g.double().numpy(), g64.numpy(), rtol=0,
                               atol=2e-5 + 2 * step)
    # the prior terms read the unrounded q: bf16 data differ from float32
    # data by the rounding of X, q and σ − y only
    _, pg32, data32, _ = logistic_regression_pg_t(
        dim, points, matmul_dtype=torch.float32, device="cpu")
    u32, _ = pg32(torch.tensor(q_t), *data32)
    assert 0 < float((u - u32).abs().max()) < 0.05 * float(u32.abs().max())


def test_convert_carries_data_state_and_parameters():
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        _, _, data_j, _ = jax_pg_builder(8, 64, matmul_dtype=jdt)
        X, XT, y = convert.model_data(*[np.asarray(d) for d in data_j],
                                      device="cpu")
        _, _, data_t, _ = logistic_regression_pg_t(8, 64, matmul_dtype=tdt,
                                                   device="cpu")
        for a, b in zip((X, XT, y), data_t):
            assert a.dtype == b.dtype and a.is_contiguous()
            assert torch.equal(a, b)
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


# ---- the other builders of aehmc_tpu.models, in float64 on both sides:
# the same operations in the same order, so 1e-12 relative

def _close64(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=1e-12, atol=0)


def test_linear_regression_equals_jax():
    from aehmc_tpu.models import linear_regression as jax_linear
    from aehmc_tpu_torch.models import linear_regression

    logprob, ex = linear_regression(500, dtype=torch.float64, device="cpu")
    logprob_j, ex_j = jax_linear(500)
    for q in np.random.default_rng(7).normal(size=(4, 2)):
        _close64(logprob(torch.tensor(q)), logprob_j(jnp.asarray(q)))
    assert ex.shape == ex_j.shape and not bool(ex.any())


def test_logistic_regression_t_equals_jax():
    from aehmc_tpu.models import logistic_regression_t as jax_logistic_t
    from aehmc_tpu_torch.models import logistic_regression_t

    pot, data, ex = logistic_regression_t(12, 80, device="cpu")
    pot_j, data_j, _ = jax_logistic_t(12, 80)
    for a, b in zip(data, data_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    q_t = np.random.default_rng(8).normal(size=(12, 5))
    _close64(pot(torch.tensor(q_t), *data), pot_j(jnp.asarray(q_t), *data_j))
    assert ex.shape == (12,)


@pytest.mark.parametrize("name", ["std_normal", "normal", "mvn",
                                  "correlated_mvn"])
def test_gaussian_builders_equal_jax(name):
    import aehmc_tpu.models as jm
    import aehmc_tpu_torch.models as tm

    rng = np.random.default_rng(9)
    dim = 4
    if name == "std_normal":
        ours, ref = tm.std_normal(), jm.std_normal()
    elif name == "normal":
        ours, ref = tm.normal(1.5, 0.7), jm.normal(1.5, 0.7)
    elif name == "mvn":
        a = rng.normal(size=(dim, dim))
        cov, loc = a @ a.T + dim * np.eye(dim), rng.normal(size=dim)
        ours = tm.mvn(loc, cov, torch.float64, device="cpu")
        ref = jm.mvn(loc, cov, jnp.float64)
    else:
        ours = tm.correlated_mvn(dim, 0.3, torch.float64, device="cpu")
        ref = jm.correlated_mvn(dim, 0.3, jnp.float64)
    for q in rng.normal(size=(3, dim)):
        _close64(ours(torch.tensor(q)), ref(jnp.asarray(q)))
