"""Regression posteriors: Bayesian logistic regression, the flagship, and
the 1-D linear regression of the reference's benchmark notebook (port of
:mod:`aehmc_tpu.models.regression`).

The data come from numpy, so both packages get bit-identical ``X, y``.  The
builders put them on the card unless the caller passes ``device="cpu"``.
:func:`logistic_pg_t` is the plain PyTorch potential and gradient in the
transposed ``(dim, chains)`` layout; the CUDA NUTS kernels recognise it by
identity and compute the same two data products in their own body.
"""

from typing import Callable, Tuple

import numpy as np
import torch


def linear_regression(
    num_points: int = 10_000, true_scale: float = 1.0, seed: int = 8927,
    dtype=torch.float32, device="cuda",
) -> Tuple[Callable, torch.Tensor]:
    """1-D linear regression posterior over ``[weight, log_sigma]``: 10k
    points, a normal prior on the weight, a Gamma(2, 2) noise scale sampled
    in log space.  The data come from numpy as the JAX builder's, held in
    ``dtype``.  Returns ``(logprob_fn, example_position)``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, size=num_points)
    y = 3.0 * X + rng.normal(0.0, true_scale, size=num_points)
    X = torch.as_tensor(X, dtype=dtype, device=device)
    y = torch.as_tensor(y, dtype=dtype, device=device)

    def logprob_fn(q):
        w, log_sigma = q[0], q[1]
        sigma = torch.exp(log_sigma)
        lp = -0.5 * (w / 10.0) ** 2
        lp = lp + 2.0 * log_sigma - 2.0 * sigma
        resid = y - w * X
        return lp - num_points * log_sigma - 0.5 * torch.sum(
            torch.square(resid)) / torch.square(sigma)

    return logprob_fn, torch.zeros(2, dtype=dtype, device=device)


def logistic_regression_data(
    dim: int = 100, num_points: int = 1_000, seed: int = 42, device="cuda"
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The synthetic ``(X (points, dim), y (points,))`` dataset, float32."""
    rng = np.random.default_rng(seed)
    X = rng.normal(0.0, 1.0, size=(num_points, dim)) / np.sqrt(dim)
    true_w = rng.normal(0.0, 1.0, size=dim)
    logits = X @ true_w
    y = (rng.uniform(size=num_points) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.float32
    )
    return (
        torch.as_tensor(X.astype(np.float32), device=device),
        torch.as_tensor(y, device=device),
    )


def _softplus(logits: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logits, min=0.0) + torch.log1p(torch.exp(-torch.abs(logits)))


def logistic_regression(
    dim: int = 100, num_points: int = 1_000, seed: int = 42, device="cuda"
) -> Tuple[Callable, torch.Tensor]:
    """``(logprob_fn, example_position)`` for one chain: ``logprob_fn(w)`` is
    the Bernoulli log-likelihood plus a standard-normal prior."""
    X, y = logistic_regression_data(dim, num_points, seed, device)

    def logprob_fn(w):
        logits = X @ w
        return torch.sum(y * logits - _softplus(logits)) - 0.5 * torch.sum(w * w)

    return logprob_fn, torch.zeros(dim, dtype=torch.float32, device=device)


def logistic_regression_t(
    dim: int = 100, num_points: int = 1_000, seed: int = 42, device="cuda"
):
    """:func:`logistic_regression` as a transposed batched potential
    ``potential_t(q_t, X, y_col)`` of ``q_t (dim, chains)``, the float32
    dataset as data.  Returns ``(potential_t, data, example_position)``."""
    X, y = logistic_regression_data(dim, num_points, seed, device)

    def potential_t(q_t, Xv, y_c):
        logits = Xv.to(q_t.dtype) @ q_t
        loglik = torch.sum(y_c * logits - _softplus(logits), dim=0)
        return -loglik + 0.5 * torch.sum(q_t * q_t, dim=0)

    return potential_t, (X, y.reshape(-1, 1)), torch.zeros(dim, device=device)


def _logits(q_t, Xv):
    """``X q_t``, float32.  With bfloat16 data (the builder's bfloat16
    operands) q is rounded to bfloat16 once and each product of two
    bfloat16 values is exact in float32, the sums float32, as the JAX
    builder's ``dot_general(..., preferred_element_type=float32)``."""
    if Xv.dtype == torch.bfloat16:
        return Xv.to(q_t.dtype) @ q_t.to(torch.bfloat16).to(q_t.dtype)
    return Xv @ q_t


def logistic_potential_t(q_t, Xv, XTv, y_c):
    """Potential ``(chains,)`` of the ``(dim, chains)`` batch ``q_t``; the
    prior term on the unrounded q."""
    logits = _logits(q_t, Xv)
    return -torch.sum(y_c * logits - _softplus(logits), dim=0) + 0.5 * torch.sum(
        q_t * q_t, dim=0
    )


def logistic_pg_t(q_t, Xv, XTv, y_c):
    """Potential ``(1, chains)`` and gradient ``(dim, chains)`` of ``q_t``:
    ``logits = X q_t``, ``grad = Xᵀ (σ(logits) − y) + q_t``.  With bfloat16
    data q and σ − y are rounded to bfloat16 for the two products, which
    are exact in float32 and summed in float32; the prior terms use the
    unrounded q."""
    logits = _logits(q_t, Xv)
    u = -torch.sum(y_c * logits - _softplus(logits), dim=0, keepdim=True) + (
        0.5 * torch.sum(q_t * q_t, dim=0, keepdim=True)
    )
    resid = torch.sigmoid(logits) - y_c
    if XTv.dtype == torch.bfloat16:
        resid, XTv = resid.to(torch.bfloat16).to(q_t.dtype), XTv.to(q_t.dtype)
    return u, XTv @ resid + q_t


def logistic_regression_pg_t(
    dim: int = 100,
    num_points: int = 1_000,
    seed: int = 42,
    matmul_dtype=torch.bfloat16,
    device="cuda",
):
    """``(potential_t, potential_and_grad_t, data, example_position)`` with
    ``data = (X, Xᵀ, y_col)``, as the JAX builder returns them: ``X`` and
    ``Xᵀ`` in ``matmul_dtype`` (bfloat16 by default, rounded to nearest
    even; float32 keeps the data exact), ``y_col`` float32.  The products'
    operands are then ``matmul_dtype`` values with float32 sums."""
    if matmul_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(
            "matmul_dtype is torch.float32 or torch.bfloat16, got "
            f"{matmul_dtype}"
        )
    X, y = logistic_regression_data(dim, num_points, seed, device)
    data = (X.to(matmul_dtype), X.T.contiguous().to(matmul_dtype),
            y.reshape(-1, 1))
    example = torch.zeros(dim, dtype=torch.float32, device=device)
    return logistic_potential_t, logistic_pg_t, data, example
