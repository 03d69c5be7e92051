"""Gaussian targets, the reference's test posteriors (port of
:mod:`aehmc_tpu.models.gaussian`).  Each ``logprob_fn`` takes one position
and returns a scalar in its dtype; only :func:`mvn` holds tensors, on the
card unless the caller passes ``device="cpu"``.
"""

import math
from typing import Callable

import numpy as np
import torch

from aehmc_tpu_torch.models.hierarchical import norm_logpdf


def std_normal() -> Callable:
    """Standard normal in any dimension: ``log p(q) = −½ Σ q²``."""

    def logprob_fn(q):
        return -0.5 * torch.sum(torch.square(q))

    return logprob_fn


def normal(loc: float = 1.0, scale: float = 2.0) -> Callable:
    """Univariate normal, the reference's warmup and stability target;
    ``loc`` and ``scale`` stay Python floats, so the log-density is in the
    position's dtype."""

    def logprob_fn(q):
        return torch.sum(norm_logpdf(q, loc, scale))

    return logprob_fn


def mvn(loc, cov, dtype=torch.float32, device="cuda") -> Callable:
    """Multivariate normal with dense covariance, its constants in
    ``dtype`` (float32 by default, as the JAX builder's without x64)."""
    loc = torch.as_tensor(np.asarray(loc), dtype=dtype, device=device)
    cov = torch.as_tensor(np.asarray(cov), dtype=dtype, device=device)
    chol = torch.linalg.cholesky(cov)
    log_det = 2.0 * torch.sum(torch.log(torch.diagonal(chol)))
    dim = loc.shape[0]
    norm_const = -0.5 * (dim * math.log(2.0 * math.pi) + log_det)

    def logprob_fn(q):
        delta = q - loc
        z = torch.linalg.solve_triangular(chol, delta[:, None],
                                          upper=False)[:, 0]
        return norm_const - 0.5 * torch.dot(z, z)

    return logprob_fn


def correlated_mvn(dim: int = 25, rho: float = 0.5, dtype=torch.float32,
                   device="cuda") -> Callable:
    """Equicorrelated MVN (unit variances, correlation ``rho``): the
    reference's MCSE gate at dim 2 and the dense-metric target at dim 25."""
    cov = np.full((dim, dim), rho)
    np.fill_diagonal(cov, 1.0)
    return mvn(np.zeros(dim), cov, dtype, device)


__all__ = ["std_normal", "normal", "mvn", "correlated_mvn"]
