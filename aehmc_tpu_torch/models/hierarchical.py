"""Hierarchical targets that stress the tree-doubling control flow: Neal's
funnel and eight schools (port of :mod:`aehmc_tpu.models.hierarchical`).

Each builder keeps the JAX builder's return contract and its order of
operations, so the two agree to round-off in float64.  The ``_pg_t``
builders return module-level potential+gradient functions,
:func:`funnel_pg_t` and :func:`schools_pg_t`: the CUDA NUTS kernels 1 and 2
recognise them by identity and compute the same potential and gradient in
their body (``csrc/hierarchical_pg.cuh``).  Tensors go to the card unless
the caller passes ``device="cpu"``.
"""

import math
from typing import Callable, Tuple

import torch

# the eight schools' observed effects and their standard errors
SCHOOLS_Y = (28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0)
SCHOOLS_SIGMA = (15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0)


def norm_logpdf(x, loc, scale):
    """``jax.scipy.stats.norm.logpdf`` in its own order:
    ``(log(2π σ²) + (x − μ)²/σ²) / −2``."""
    x = torch.as_tensor(x)
    loc = torch.as_tensor(loc, dtype=x.dtype, device=x.device)
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    scale_sqrd = torch.square(scale)
    log_normalizer = torch.log(2 * math.pi * scale_sqrd)
    quadratic = torch.square(x - loc) / scale_sqrd
    return (log_normalizer + quadratic) / -2


def neals_funnel(dim: int = 10, device="cuda") -> Tuple[Callable, torch.Tensor]:
    """Neal's funnel: ``v ~ N(0, 3)``, ``x_i | v ~ N(0, exp(v/2))``.
    Position layout ``q = [v, x_1, ..., x_{dim-1}]``; returns
    ``(logprob_fn, example_position)``."""

    def logprob_fn(q):
        v, x = q[0], q[1:]
        lp_v = norm_logpdf(v, 0.0, 3.0)
        lp_x = torch.sum(norm_logpdf(x, 0.0, torch.exp(0.5 * v)))
        return lp_v + lp_x

    return logprob_fn, torch.zeros(dim, device=device)


def _schools(dtype, device):
    y = torch.tensor(SCHOOLS_Y, dtype=dtype, device=device)
    sigma = torch.tensor(SCHOOLS_SIGMA, dtype=dtype, device=device)
    return y, sigma


def eight_schools(non_centered: bool = True, device="cuda"):
    """The eight-schools hierarchical model (Rubin 1981).  Position layout
    ``q = [mu, log_tau, theta_1..theta_8]``, theta the standardized effects
    when ``non_centered``; returns ``(logprob_fn, example_position)``."""

    def logprob_fn(q):
        y, sigma = _schools(q.dtype, q.device)
        mu, log_tau = q[0], q[1]
        tau = torch.exp(log_tau)
        theta_raw = q[2:]
        lp = norm_logpdf(mu, 0.0, 5.0)
        lp = lp + norm_logpdf(log_tau, 0.0, 5.0) + log_tau
        if non_centered:
            lp = lp + torch.sum(norm_logpdf(theta_raw, 0.0, 1.0))
            theta = mu + tau * theta_raw
        else:
            theta = theta_raw
            lp = lp + torch.sum(norm_logpdf(theta, mu, tau))
        return lp + torch.sum(norm_logpdf(y, theta, sigma))

    return logprob_fn, torch.zeros(10, device=device)


def neals_funnel_t(dim: int = 10, device="cuda"):
    """Neal's funnel as a transposed batched potential: ``potential_t(q_t)``
    takes ``(dim, chains)`` and returns ``(chains,)``.  Returns
    ``(potential_t, example_position)``."""

    def potential_t(q_t):
        v, x = q_t[0:1, :], q_t[1:, :]
        neg_lp_v = 0.5 * (v / 3.0) ** 2
        neg_lp_x = (torch.sum(0.5 * x * x / torch.exp(v), dim=0, keepdim=True)
                    + (dim - 1) * 0.5 * v)
        return (neg_lp_v + neg_lp_x)[0]

    return potential_t, torch.zeros(dim, device=device)


def schools_potential_t(q_t, y_col, sig2_col):
    """Non-centred eight schools, transposed: ``(chains,)`` potentials of
    ``q_t (10, chains)`` with rows ``[mu, log_tau, theta_raw_1..8]``."""
    mu, log_tau, theta_raw = q_t[0:1, :], q_t[1:2, :], q_t[2:, :]
    tau = torch.exp(log_tau)
    neg_lp = 0.5 * (mu / 5.0) ** 2
    neg_lp = neg_lp + 0.5 * (log_tau / 5.0) ** 2 - log_tau
    neg_lp = neg_lp + torch.sum(0.5 * theta_raw * theta_raw, dim=0,
                                keepdim=True)
    theta = mu + tau * theta_raw
    neg_lp = neg_lp + torch.sum(0.5 * (y_col - theta) ** 2 / sig2_col, dim=0,
                                keepdim=True)
    return neg_lp[0]


def eight_schools_t(dtype=torch.float32, device="cuda"):
    """Non-centred eight schools as a transposed batched potential
    ``potential_t(q_t, y_col, sig2_col)``; the observations and their
    variances are the data ``(y_col (8, 1), sig2_col (8, 1))`` in ``dtype``.
    Returns ``(potential_t, data, example_position)``."""
    y, sigma = _schools(dtype, device)
    data = (y[:, None], (sigma ** 2)[:, None])
    return schools_potential_t, data, torch.zeros(10, device=device)


def funnel_potential_t(q_t, _dummy):
    """The funnel's ``(chains,)`` potentials of ``q_t (d, chains)``; the
    dummy data row is unused."""
    d = q_t.shape[0]
    v, x = q_t[0:1, :], q_t[1:, :]
    return (0.5 * (v / 3.0) ** 2
            + torch.sum(0.5 * x * x * torch.exp(-v), dim=0, keepdim=True)
            + (d - 1) * 0.5 * v)[0]


def funnel_pg_t(q_t, _dummy):
    """The funnel's potential ``(1, chains)`` and gradient ``(d, chains)``
    of ``q_t (d, chains)``, d from q:
    ``U = (v/3)²/2 + Σx²e⁻ᵛ/2 + (d−1)v/2``, ``∂U/∂v = v/9 − Σx²e⁻ᵛ/2 +
    (d−1)/2``, ``∂U/∂x = x e⁻ᵛ``.  The CUDA NUTS kernels take it by
    identity (functor ``FunnelPG``)."""
    d = q_t.shape[0]
    v, x = q_t[0:1, :], q_t[1:, :]
    e = torch.exp(-v)
    sumsq = torch.sum(x * x, dim=0, keepdim=True)
    u = 0.5 * (v / 3.0) ** 2 + 0.5 * sumsq * e + (d - 1) * 0.5 * v
    gv = v / 9.0 - 0.5 * sumsq * e + (d - 1) * 0.5
    return u, torch.cat([gv, x * e], dim=0)


def schools_pg_t(q_t, y_col, sig2_col):
    """Non-centred eight schools' potential ``(1, chains)`` and gradient
    ``(10, chains)``: with θ = μ + τ θ_raw, τ = e^{log τ}, r = (θ − y)/σ²,
    ``∂U/∂μ = μ/25 + Σr``, ``∂U/∂log τ = log τ/25 − 1 + τ Σ r θ_raw``,
    ``∂U/∂θ_raw = θ_raw + τ r``.  The CUDA NUTS kernels take it by identity
    (functor ``EightSchoolsPG``)."""
    mu, log_tau, theta_raw = q_t[0:1, :], q_t[1:2, :], q_t[2:, :]
    tau = torch.exp(log_tau)
    theta = mu + tau * theta_raw
    resid = (theta - y_col) / sig2_col
    u = (0.5 * (mu / 5.0) ** 2 + 0.5 * (log_tau / 5.0) ** 2 - log_tau
         + torch.sum(0.5 * theta_raw * theta_raw, dim=0, keepdim=True)
         + torch.sum(0.5 * (y_col - theta) ** 2 / sig2_col, dim=0,
                     keepdim=True))
    g_mu = mu / 25.0 + torch.sum(resid, dim=0, keepdim=True)
    g_lt = (log_tau / 25.0 - 1.0
            + tau * torch.sum(resid * theta_raw, dim=0, keepdim=True))
    g_tr = theta_raw + tau * resid
    return u, torch.cat([g_mu, g_lt, g_tr], dim=0)


def neals_funnel_pg_t(dim: int = 10, device="cuda"):
    """Neal's funnel for the pre-differentiated fused path:
    ``(potential_t, potential_and_grad_t, data, example_position)`` with a
    (1, 1) dummy data row, as the JAX builder returns them."""
    data = (torch.zeros((1, 1), dtype=torch.float32, device=device),)
    return (funnel_potential_t, funnel_pg_t, data,
            torch.zeros(dim, device=device))


def eight_schools_pg_t(dtype=torch.float32, device="cuda"):
    """Non-centred eight schools for the pre-differentiated fused path:
    ``(potential_t, potential_and_grad_t, data, example_position)``, the
    data and density of :func:`eight_schools_t`."""
    potential_t, data, example = eight_schools_t(dtype, device)
    return potential_t, schools_pg_t, data, example


__all__ = ["neals_funnel", "eight_schools", "neals_funnel_t",
           "eight_schools_t", "neals_funnel_pg_t", "eight_schools_pg_t",
           "funnel_potential_t", "funnel_pg_t", "schools_potential_t",
           "schools_pg_t"]
