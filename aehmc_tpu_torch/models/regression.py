"""Bayesian logistic regression, the flagship posterior (port of
:mod:`aehmc_tpu.models.regression`).

The data come from numpy, so both packages get bit-identical ``X, y``.
:func:`logistic_pg_t` is the plain PyTorch potential and gradient in the
transposed ``(dim, chains)`` layout; the CUDA NUTS kernels recognise it by
identity and compute the same two data products in their own body.
"""

from typing import Callable, Tuple

import numpy as np
import torch


def logistic_regression_data(
    dim: int = 100, num_points: int = 1_000, seed: int = 42, device=None
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
    dim: int = 100, num_points: int = 1_000, seed: int = 42, device=None
) -> Tuple[Callable, torch.Tensor]:
    """``(logprob_fn, example_position)`` for one chain: ``logprob_fn(w)`` is
    the Bernoulli log-likelihood plus a standard-normal prior."""
    X, y = logistic_regression_data(dim, num_points, seed, device)

    def logprob_fn(w):
        logits = X @ w
        return torch.sum(y * logits - _softplus(logits)) - 0.5 * torch.sum(w * w)

    return logprob_fn, torch.zeros(dim, dtype=torch.float32, device=device)


def logistic_potential_t(q_t, Xv, XTv, y_c):
    """Potential ``(chains,)`` of the ``(dim, chains)`` batch ``q_t``."""
    logits = Xv @ q_t
    return -torch.sum(y_c * logits - _softplus(logits), dim=0) + 0.5 * torch.sum(
        q_t * q_t, dim=0
    )


def logistic_pg_t(q_t, Xv, XTv, y_c):
    """Potential ``(1, chains)`` and gradient ``(dim, chains)`` of ``q_t``:
    ``logits = X q_t``, ``grad = Xᵀ (σ(logits) − y) + q_t``."""
    logits = Xv @ q_t
    u = -torch.sum(y_c * logits - _softplus(logits), dim=0, keepdim=True) + (
        0.5 * torch.sum(q_t * q_t, dim=0, keepdim=True)
    )
    resid = torch.sigmoid(logits) - y_c
    return u, XTv @ resid + q_t


def logistic_regression_pg_t(
    dim: int = 100,
    num_points: int = 1_000,
    seed: int = 42,
    matmul_dtype=torch.float32,
    device=None,
):
    """``(potential_t, potential_and_grad_t, data, example_position)`` with
    ``data = (X, Xᵀ, y_col)``, as the JAX builder returns them.

    Only float32 operands are ported; bf16 operands are ROADMAP item 1.4.
    """
    if matmul_dtype != torch.float32:
        raise NotImplementedError(
            "bf16 matmul operands are not ported yet (ROADMAP.md, item 1.4)"
        )
    X, y = logistic_regression_data(dim, num_points, seed, device)
    data = (X, X.T.contiguous(), y.reshape(-1, 1))
    example = torch.zeros(dim, dtype=torch.float32, device=device)
    return logistic_potential_t, logistic_pg_t, data, example
