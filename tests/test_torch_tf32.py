"""Float32-accurate data products on the tensor cores ("3×TF32"), emulated in
numpy on the CPU: the evidence behind the bound ``chip_smoke.py`` puts on
the logistic gradient's two data products (their FLOP at 495 / 3 TFLOP/s on
an H100) and behind the tolerance it holds the kernels' gradients to (within
4× of the plain float32 version's error against float64).

TF32 keeps 10 bits of mantissa, so one TF32 product a float32 product loses
about three decimal digits.  Splitting each float32 operand x into
``hi = cvt.rna.tf32(x)`` and ``lo = cvt.rna.tf32(x − hi)`` and adding three
products, lo·hi, hi·lo and hi·hi, keeps float32 accuracy, provided each
``mma`` k-step's sum is added to a float32 accumulator rounded to nearest
(the tensor cores' own accumulation does not round to nearest, so over a
long K its error grows past float32's).  Here ``cvt.rna`` is emulated by
bit masking and each k-step
of 8 as an exactly rounded sum added to a float32 accumulator.  A
non-finite operand must reach only the hi·hi product, or inf and NaN do not
come out where float32 arithmetic puts them.
"""

import numpy as np
import pytest
import torch

from aehmc_tpu_torch.models.regression import (
    logistic_pg_t,
    logistic_regression_data,
)

KSTEP = 8      # the k depth of mma.sync.m16n8k8
RATIO = 4.0    # chip_smoke.py:GRAD_ERR_RATIO


def tf32(x):
    """cvt.rna.tf32.f32: round the float32 mantissa to 10 bits, ties away
    from zero; inf and NaN unchanged."""
    x = np.asarray(x, dtype=np.float32)
    u = x.view(np.uint32)
    r = ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return np.where(np.isfinite(x), r, x).astype(np.float32)


def split(x):
    """(hi, hf, lo) of a 3×TF32 operand: hf is hi where it is finite, else
    0, and lo is then 0."""
    x = np.asarray(x, dtype=np.float32)
    hi = tf32(x)
    fin = np.isfinite(hi)
    with np.errstate(invalid="ignore"):
        lo = np.where(fin, tf32(x - hi), np.float32(0))
    return hi, np.where(fin, hi, np.float32(0)), lo


def mma_matmul(a, b, three=True, finite_mask=True):
    """a (M, K) @ b (K, N) as a tensor-core kernel runs it: k-steps of 8 in
    order, each product's sum over the step rounded once into float32
    accumulators; 3×TF32 (lo·hf, hi·lo, hi·hi) or one TF32 product."""
    ahi, _, alo = split(a)
    bhi, bhf, blo = split(b)
    if not finite_mask:
        bhf = bhi
    terms = [(alo, bhf), (ahi, blo), (ahi, bhi)] if three else [(ahi, bhi)]
    c = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    with np.errstate(invalid="ignore", over="ignore"):
        for k in range(0, a.shape[1], KSTEP):
            for x, y in terms:
                step = x[:, k:k + KSTEP].astype(np.float64) @ \
                    y[k:k + KSTEP].astype(np.float64)
                c = (c + step.astype(np.float32)).astype(np.float32)
    return c


def grad_emulated(X, y, q, three):
    """∇U of the logistic posterior at q (dim, chains) in float32 with
    TF32 products (three a product, or one)."""
    logits = mma_matmul(X, q, three)
    r = (np.float32(1) / (np.float32(1) + np.exp(-logits)) - y[:, None])
    return (mma_matmul(X.T.copy(), r.astype(np.float32), three) + q).astype(
        np.float32)


def grad64(X, y, q):
    X, q = X.astype(np.float64), q.astype(np.float64)
    return X.T @ (1.0 / (1.0 + np.exp(-(X @ q))) - y[:, None]) + q


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0**-11, 1.0 + 2.0**-10),   # a tie rounds away from zero
    (-(1.0 + 2.0**-11), -(1.0 + 2.0**-10)),
    (1.0 + 2.0**-12, 1.0),
    (1.0 + 3 * 2.0**-12, 1.0 + 2.0**-10),
    (np.inf, np.inf),
    (-np.inf, -np.inf),
])
def test_tf32_rounding_is_cvt_rna(x, want):
    assert tf32(np.float32(x)) == np.float32(want)


def test_hi_plus_lo_keeps_21_bits():
    x = np.random.default_rng(0).normal(size=10_000).astype(np.float32)
    hi, _, lo = split(x)
    rel = np.abs((hi.astype(np.float64) + lo) - x) / np.abs(x)
    assert rel.max() <= 2.0**-21
    assert np.abs(hi - x).max() > 0  # one TF32 value alone does not


@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_three_tf32_products_keep_float32_accuracy(scale):
    """On the flagship posterior (100-d, 1,000 points) at 16 chains."""
    X, y = (t.numpy() for t in logistic_regression_data(100, 1000,
                                                       device="cpu"))
    q = (scale * np.random.default_rng(1).normal(size=(100, 16))).astype(
        np.float32)
    exact = grad64(X, y, q)
    qt, Xt = torch.from_numpy(q), torch.from_numpy(X)
    plain = logistic_pg_t(qt, Xt, Xt.T.contiguous(),
                          torch.from_numpy(y).reshape(-1, 1))[1].numpy()
    err_plain = np.abs(plain - exact).max()
    err3 = np.abs(grad_emulated(X, y, q, True) - exact).max()
    err1 = np.abs(grad_emulated(X, y, q, False) - exact).max()
    assert 0 < err_plain < 1e-4
    assert err3 <= RATIO * err_plain, (err3, err_plain)
    assert err1 > RATIO * err_plain, (err1, err_plain)


def test_non_finite_q_reaches_only_the_hi_product():
    """A row of q with +inf, −inf and NaN: the logits' non-finite pattern is
    float32's only with the correction products' hi masked to 0."""
    rng = np.random.default_rng(2)
    X = (rng.normal(size=(37, 24)) / 5).astype(np.float32)
    q = rng.normal(size=(24, 8)).astype(np.float32)
    q[3, 1], q[5, 2], q[7, 3] = np.inf, -np.inf, np.nan
    with np.errstate(invalid="ignore", over="ignore"):
        want = X @ q
    got = mma_matmul(X, q)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(np.isposinf(got), np.isposinf(want))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5)
    # without the mask, lo(x)·inf takes the sign of x − hi(x): NaN where the
    # float32 product is ±inf
    unmasked = mma_matmul(X, q, finite_mask=False)
    assert np.isnan(unmasked).sum() > np.isnan(want).sum()
