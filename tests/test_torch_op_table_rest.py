"""The potential compiler's everyday ops on the CPU: ``xlogy`` and
``log_sigmoid`` (torch.distributions' Poisson, Gamma, Beta, Dirichlet,
Bernoulli and NegativeBinomial), the special functions (``atan2``,
``erfinv``, ``logit``, the modified Bessel functions, ``polygamma``,
``mvlgamma``), vector norms, ``logcumsumexp``, ``cummax``/``cummin``,
``linalg.cross``, ``cdist``, the LU family (``inv``, ``lu_factor``,
``lu_unpack``, ``lu_solve``, ``det``, ``cholesky_inverse``), QR, the SVD
(``svd``, ``svdvals``, ``pinv``, ``lstsq``), the matrix exponential, the
scatters by a per-chain index and the write under a mask that depends on
q.

- Four potentials carry them, plain torch logprobs with float64 and ``jnp``
  twins, their data made from a seed with numpy, at small sizes
  (``chip_smoke.py`` keeps its own copies at full width): U1 ``zip_radon``
  (a zero-inflated Poisson varying-intercept regression on the radon
  layout, written with torch.distributions), U2 ``cox_lung`` (the Cox
  partial likelihood through ``logcumsumexp``), U3 ``ctmc_cav`` (a
  four-state illness-death model through ``matrix_exp``) and U4
  ``ppca_qr`` (probabilistic PCA with QR loadings, through ``inv`` and
  ``det``); and the test-only cases, a potential of a few ops each.
- For each: the plain back end against float64 autograd and ``jax.vjp``;
  the emitted functor, compiled with g++ (``tests/test_torch_generic_pg.py``'s
  harness, with CUDA's ``erfinvf`` stood in by glibc's ``erf`` and Newton's
  method), against the plain back end; kernels 1, 5 and 7 through their
  plain versions with the plain back end as the potential against the JAX
  kernels in interpret mode, on external randomness.
- The fused front door on U1, U2 and U3; ``LowRankMultivariateNormal``
  binds (its strided diagonal write once failed in vmap); a read through a
  mask that depends on q stays refused by both packages; and each
  ``torch.distributions`` family named binds, its plain gradient equal to
  float64 autograd.
"""

import math
import shutil

import numpy as np
import pytest
import torch
import torch.distributions as dist
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import jax.scipy.special as jss
from jax.scipy.linalg import expm as jax_expm

from aehmc_tpu.api import _generic_fused_binding as jax_binding
from aehmc_tpu.ops import chees_fused as jax_cf
from aehmc_tpu.ops import ghmc_fused as jax_ghmc
from aehmc_tpu.ops.nuts_fused_small import (
    make_fused_nuts_transition_small as jax_transition,
)
import aehmc_tpu_torch
from aehmc_tpu_torch.api import _generic_fused_binding
from aehmc_tpu_torch.ops import chees_fused, generic_pg, ghmc_fused
from aehmc_tpu_torch.ops.nuts_fused_small import nuts_transition_plain

F32 = np.float32
LOG_2PI = math.log(2.0 * math.pi)


def _t(a, device="cpu"):
    return torch.as_tensor(a, device=device)


def _jnormal(x, loc, scale):
    return -0.5 * ((x - loc) / scale) ** 2 - jnp.log(scale) - 0.5 * LOG_2PI


# ------------------------------------------------------- the potentials ---

def zip_data(num_obs=40, num_counties=6, seed=0):
    """U1's data: each observation's county (every county seen, the rest
    of the sizes skewed, as the radon survey's), a floor indicator and
    counts from a zero-inflated Poisson (a quarter structural zeros)."""
    rng = np.random.default_rng(seed)
    extra = rng.multinomial(num_obs - num_counties,
                            rng.dirichlet(np.full(num_counties, 0.5)))
    county = np.repeat(np.arange(num_counties), 1 + extra)
    floor = (rng.uniform(size=num_obs) < 0.17).astype(np.float64)
    alpha = rng.normal(0.8, 0.5, num_counties)
    rate = np.exp(alpha[county] - 0.6 * floor)
    y = np.where(rng.uniform(size=num_obs) < 0.25, 0, rng.poisson(rate))
    return county.astype(np.int64), floor.astype(F32), y.astype(F32)


def zip_radon(county, floor, y, num_counties, device="cpu"):
    """U1: log-rate alpha_county + beta floor with county intercepts alpha
    = mu + z / sqrt(prec) (non-centred: z ~ Normal(0, 1)), prec ~ Gamma(2,
    2) (on log prec, with its Jacobian), a zero-inflation logit zl: P(0) =
    pi + (1 - pi) Poisson(0), P(y > 0) = (1 - pi) Poisson(y), written with
    torch.distributions (Poisson, Bernoulli(logits=), Gamma, Normal),
    logsigmoid and logsumexp; q = (z (J), mu, log prec, beta, zl)."""
    c, f, Y = (_t(a, device) for a in (county, floor, y))
    J = num_counties

    def logprob_fn(q):
        z, mu, log_prec, beta, zl = (q[:J], q[J], q[J + 1], q[J + 2],
                                     q[J + 3])
        alpha = mu + z * torch.exp(-0.5 * log_prec)
        pois = dist.Poisson(torch.exp(alpha[c] + beta * f)).log_prob(Y)
        log_pi = F.logsigmoid(zl)
        log_1m = dist.Bernoulli(logits=zl).log_prob(
            torch.zeros((), dtype=q.dtype, device=device))
        at_zero = torch.logsumexp(torch.stack(
            [log_pi.expand_as(pois), log_1m + pois]), 0)
        ll = torch.where(Y == 0, at_zero, log_1m + pois).sum()
        two = torch.tensor(2.0, dtype=q.dtype, device=device)
        lp = dist.Gamma(two, two).log_prob(torch.exp(log_prec)) + log_prec
        lp = lp + dist.Normal(0.0, 1.0).log_prob(z).sum()
        return ll + lp + dist.Normal(0.0, 5.0).log_prob(mu) \
            + dist.Normal(0.0, 5.0).log_prob(beta) \
            + dist.Normal(0.0, 2.0).log_prob(zl)

    return logprob_fn


def jax_zip_radon(county, floor, y, num_counties, dtype=jnp.float64):
    f, Y = jnp.asarray(floor, dtype), jnp.asarray(y, dtype)
    J = num_counties
    zero = np.asarray(y) == 0

    def logprob_fn(q):
        z, mu, log_prec, beta, zl = (q[:J], q[J], q[J + 1], q[J + 2],
                                     q[J + 3])
        prec = jnp.exp(log_prec)
        alpha = mu + z * jnp.exp(-0.5 * log_prec)
        rate = jnp.exp(alpha[county] + beta * f)
        pois = jss.xlogy(Y, rate) - rate - jss.gammaln(Y + 1.0)
        log_pi, log_1m = jax.nn.log_sigmoid(zl), jax.nn.log_sigmoid(-zl)
        at_zero = jnp.logaddexp(log_pi, log_1m + pois)
        ll = jnp.sum(jnp.where(zero, at_zero, log_1m + pois))
        lp = 2.0 * math.log(2.0) + jss.xlogy(1.0, prec) - 2.0 * prec \
            - jss.gammaln(2.0) + log_prec
        lp = lp + jnp.sum(_jnormal(z, 0.0, 1.0))
        return ll + lp + _jnormal(mu, 0.0, 5.0) + _jnormal(beta, 0.0, 5.0) \
            + _jnormal(zl, 0.0, 2.0)

    return logprob_fn


def cox_data(num_obs=30, num_cov=3, seed=0):
    """U2's data: covariates and event indicators sorted by time,
    descending (continuous times: no ties), about 72% events."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((num_obs, num_cov))
    beta = rng.normal(0.0, 0.5, num_cov)
    t = rng.exponential(1.0 / np.exp(X @ beta))
    cens = rng.exponential(2.6, num_obs)
    time, event = np.minimum(t, cens), (t <= cens).astype(np.float64)
    order = np.argsort(-time)
    return X[order].astype(F32), event[order].astype(F32)


def cox_lung(X, event, device="cpu"):
    """U2: the Cox partial likelihood (Breslow; no ties), each event's risk
    set the patients still at risk, log sum exp(eta) over them a
    logcumsumexp over the times sorted descending; Normal(0, 1) priors."""
    Xt, Et = _t(X, device), _t(event, device)

    def logprob_fn(q):
        eta = Xt @ q
        ll = torch.sum(Et * (eta - torch.logcumsumexp(eta, 0)))
        return ll + dist.Normal(0.0, 1.0).log_prob(q).sum()

    return logprob_fn


def jax_cox_lung(X, event, dtype=jnp.float64):
    Xj, Ej = jnp.asarray(X, dtype), jnp.asarray(event, dtype)

    def logprob_fn(q):
        eta = Xj @ q
        ll = jnp.sum(Ej * (eta - jax.lax.cumlogsumexp(eta, axis=0)))
        return ll + jnp.sum(_jnormal(q, 0.0, 1.0))

    return logprob_fn


# the CAV model's transitions (msm's Q): well -> mild, well -> dead,
# mild -> well, mild -> severe, mild -> dead, severe -> mild, severe -> dead
CAV_FROM = np.array([0, 0, 1, 1, 1, 2, 2])
CAV_TO = np.array([1, 3, 0, 2, 3, 1, 3])
CAV_RATES = np.array([0.10, 0.04, 0.25, 0.14, 0.08, 0.10, 0.30])
# U3's log rates are capped at 10 (e^10 a year): torch's matrix_exp on the
# card never returns from a matrix of infinite norm (its number of
# squarings is an int64 of +inf), and exp(q) overflows on a divergent
# trajectory
CAV_LOG_RATE_MAX = 10.0


def _generator(rates):
    Q = np.zeros((4, 4))
    Q[CAV_FROM, CAV_TO] = rates
    return Q - np.diag(Q.sum(1))


def ctmc_data(num_intervals=4, num_obs=200, seed=0):
    """U3's data: distinct intervals (years) and transition counts (the
    interval, the alive state left, the state reached) drawn from the
    model."""
    import scipy.linalg

    rng = np.random.default_rng(seed)
    dt = np.sort(rng.choice(np.arange(1, 61) * 0.05, num_intervals,
                            replace=False))
    Q = _generator(CAV_RATES)
    counts = np.zeros((num_intervals, 3, 4))
    which = rng.integers(0, num_intervals, num_obs)
    start = rng.choice(3, num_obs, p=[0.6, 0.25, 0.15])
    for k in range(num_intervals):
        P = scipy.linalg.expm(Q * dt[k])
        for i in range(3):
            m = int(np.sum((which == k) & (start == i)))
            counts[k, i] = rng.multinomial(m, P[i] / P[i].sum())
    return dt.astype(F32), counts.astype(F32)


def ctmc_cav(dt, counts, device="cpu"):
    """U3: the illness-death model's generator from 7 log rates, P(dt) =
    matrix_exp(Q dt) at each interval, the log-likelihood sum counts log
    P over the alive states left; Normal(-2, 1) priors."""
    Dt, Ct = _t(dt, device), _t(counts, device)
    rows, cols = _t(CAV_FROM, device), _t(CAV_TO, device)

    def logprob_fn(q):
        Q = torch.zeros(4, 4, dtype=q.dtype, device=device)
        Q[rows, cols] = torch.exp(torch.clamp(q, max=CAV_LOG_RATE_MAX))
        Q = Q - torch.diag(Q.sum(1))
        P = torch.linalg.matrix_exp(Q * Dt[:, None, None])
        return torch.sum(Ct * torch.log(P[:, :3, :])) \
            + dist.Normal(-2.0, 1.0).log_prob(q).sum()

    return logprob_fn


def jax_ctmc_cav(dt, counts, dtype=jnp.float64):
    Dt, Ct = jnp.asarray(dt, dtype), jnp.asarray(counts, dtype)

    def logprob_fn(q):
        Q = jnp.zeros((4, 4), dtype).at[CAV_FROM, CAV_TO].set(
            jnp.exp(jnp.minimum(q, CAV_LOG_RATE_MAX)))
        Q = Q - jnp.diag(Q.sum(1))
        P = jax.vmap(jax_expm)(Q * Dt[:, None, None])
        return jnp.sum(Ct * jnp.log(P[:, :3, :])) \
            + jnp.sum(_jnormal(q, -2.0, 1.0))

    return logprob_fn


def ppca_data(num_obs=40, num_dim=5, rank=2, seed=0):
    """U4's data: the scatter matrix Y^T Y of rows from a rank-``rank``
    PPCA (variances 9, 4, 2, noise sd 0.5), and the anchor W0: twice the
    scatter's leading eigenvectors, each with its largest component
    positive."""
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((num_dim, rank)))
    lam = np.array([9.0, 4.0, 2.0])[:rank]
    Y = (rng.standard_normal((num_obs, rank)) * np.sqrt(lam)) @ V.T \
        + 0.5 * rng.standard_normal((num_obs, num_dim))
    S = Y.T @ Y
    _, E = np.linalg.eigh(S)
    E = E[:, ::-1][:, :rank]
    E = E * np.sign(E[np.abs(E).argmax(0), np.arange(rank)])
    return S.astype(F32), (2.0 * E).astype(F32), num_obs


def ppca_qr(S, W0, num_obs, device="cpu"):
    """U4: probabilistic PCA with orthonormal loadings U, the Q of
    torch.linalg.qr(W0 + W) (after Nirwan and Bertschinger 2019; the anchor
    W0 keeps the sign modes of U's columns apart), C = U diag(lam) U^T +
    sigma^2 I, the log-likelihood -N/2 log det C - tr(C^-1 S)/2 through
    torch.linalg.inv and torch.det; q = (W (D K), log lam (K), log sigma),
    Normal(0, 1) and Normal(0, 2) priors.  C does not depend on the signs
    of U's columns."""
    St, Wt = _t(S, device), _t(W0, device)
    D, K = Wt.shape

    def logprob_fn(q):
        U = torch.linalg.qr(q[:D * K].reshape(D, K) + Wt).Q
        lam = torch.exp(q[D * K:D * K + K])
        C = (U * lam) @ U.T + torch.exp(2.0 * q[-1]) * torch.eye(
            D, dtype=q.dtype, device=device)
        ll = -0.5 * num_obs * torch.log(torch.det(C)) \
            - 0.5 * torch.sum(torch.linalg.inv(C) * St)
        return ll + dist.Normal(0.0, 1.0).log_prob(q[:D * K]).sum() \
            + dist.Normal(0.0, 2.0).log_prob(q[D * K:]).sum()

    return logprob_fn


def jax_ppca_qr(S, W0, num_obs, dtype=jnp.float64):
    Sj, Wj = jnp.asarray(S, dtype), jnp.asarray(W0, dtype)
    D, K = W0.shape

    def logprob_fn(q):
        U = jnp.linalg.qr(q[:D * K].reshape(D, K) + Wj)[0]
        lam = jnp.exp(q[D * K:D * K + K])
        C = (U * lam) @ U.T + jnp.exp(2.0 * q[-1]) * jnp.eye(D, dtype=dtype)
        ll = -0.5 * num_obs * jnp.log(jnp.linalg.det(C)) \
            - 0.5 * jnp.sum(jnp.linalg.inv(C) * Sj)
        return ll + jnp.sum(_jnormal(q[:D * K], 0.0, 1.0)) \
            + jnp.sum(_jnormal(q[D * K:], 0.0, 2.0))

    return logprob_fn


# ----------------------------------------------- the test-only cases ---

def special(w, device="cpu"):
    """atan2, erfinv, logit (eps None and a number), a von Mises
    likelihood through i0e (its gradient i1e), i0, i1, digamma (its
    gradient polygamma(1)), polygamma(1) (its gradient polygamma(2)) and
    xlog1py; q of 6."""
    W = _t(w, device)

    def logprob_fn(q):
        a = torch.atan2(q[0], q[1] + 3.0) ** 2
        b = torch.erfinv(0.875 * torch.tanh(q[2])) ** 2
        p = torch.sigmoid(q[3])
        c = torch.logit(p) ** 2 + torch.logit(p, eps=1e-3) ** 2
        kappa = torch.exp(q[4])
        vm = torch.sum(kappa * torch.cos(W - q[5])) - W.shape[0] * (
            torch.log(torch.special.i0e(kappa)) + kappa)
        bessel = torch.special.i0(q[5]) + torch.special.i1(q[4])
        x = torch.exp(q[:3]) + 0.5
        gam = torch.sum(torch.digamma(x)) + torch.sum(torch.polygamma(1, x))
        xl = torch.sum(torch.special.xlog1py(W[:3], torch.exp(q[:3])))
        return vm - a - b - 0.125 * c + 0.125 * (gam - bessel + xl) \
            - 0.5 * torch.sum(q * q)

    return logprob_fn


def jax_special(w, dtype=jnp.float64):
    W = jnp.asarray(w, dtype)

    def logit(p, eps=None):
        if eps is not None:
            p = jnp.clip(p, eps, 1.0 - eps)
        return jnp.log(p / (1.0 - p))

    def logprob_fn(q):
        a = jnp.arctan2(q[0], q[1] + 3.0) ** 2
        b = jss.erfinv(0.875 * jnp.tanh(q[2])) ** 2
        p = jax.nn.sigmoid(q[3])
        c = logit(p) ** 2 + logit(p, 1e-3) ** 2
        kappa = jnp.exp(q[4])
        vm = jnp.sum(kappa * jnp.cos(W - q[5])) - W.shape[0] * (
            jnp.log(jss.i0e(kappa)) + kappa)
        bessel = jss.i0(q[5]) + jss.i1(q[4])
        x = jnp.exp(q[:3]) + 0.5
        gam = jnp.sum(jss.digamma(x)) + jnp.sum(jss.polygamma(1, x))
        xl = jnp.sum(jss.xlog1py(W[:3], jnp.exp(q[:3])))
        return vm - a - b - 0.125 * c + 0.125 * (gam - bessel + xl) \
            - 0.5 * jnp.sum(q * q)

    return logprob_fn


def scans(xa, device="cpu"):
    """Vector norms (ord 2, 1, inf, -inf, 3, 0.5; a dim with keepdim),
    linalg.cross, cummax and cummin, and an ARD GP through torch.cdist on
    scaled inputs (p 2; p 1 and 3 beside it); q of 8."""
    Xa = _t(xa, device)
    n = Xa.shape[0]

    def logprob_fn(q):
        v = q[:6].reshape(2, 3)
        norms = torch.linalg.vector_norm(q[:6]) \
            + torch.linalg.vector_norm(q[:6], 1) \
            + torch.linalg.vector_norm(q[:6], float("inf")) \
            + torch.linalg.vector_norm(q[:6], -float("inf")) \
            + torch.linalg.vector_norm(q[:6], 3.0) \
            + torch.linalg.vector_norm(q[:6] + 2.0, 0.5) \
            + torch.linalg.vector_norm(v, 2, dim=1, keepdim=True).sum()
        cr = torch.sum(torch.linalg.cross(v[0], v[1]) * torch.tensor(
            [1.0, -2.0, 0.5], dtype=q.dtype, device=device))
        cm = torch.sum(torch.cummax(q, 0).values) \
            - torch.sum(torch.cummin(q, 0).values)
        Z = Xa / torch.exp(q[6:8])
        K = torch.exp(-0.5 * torch.cdist(Z, Z) ** 2) + 0.125 * torch.eye(
            n, dtype=q.dtype, device=device)
        gp = -torch.logdet(K) \
            + 0.015625 * torch.sum(torch.cdist(Z, Z, p=1.0)) \
            - 0.015625 * torch.sum(torch.cdist(Z, Z[:3], p=3.0))
        return gp + 0.25 * cr + 0.1875 * cm - 0.125 * norms \
            - 0.5 * torch.sum(q * q)

    return logprob_fn


def jax_scans(xa, dtype=jnp.float64):
    Xa = jnp.asarray(xa, dtype)
    n = xa.shape[0]

    def cdist(a, b, p):
        """torch.cdist, its gradient 0 where a distance is 0 (torch's)."""
        d = jnp.abs(a[:, None, :] - b[None, :, :])
        s = jnp.sum(d ** p, -1)
        pos = s > 0
        return jnp.where(pos, jnp.where(pos, s, 1.0) ** (1.0 / p), 0.0)

    def logprob_fn(q):
        v = q[:6].reshape(2, 3)
        a = jnp.abs(q[:6])
        norms = jnp.sqrt(jnp.sum(q[:6] ** 2)) + jnp.sum(a) + jnp.max(a) \
            + jnp.min(a) + jnp.sum(a ** 3) ** (1 / 3) \
            + jnp.sum(jnp.abs(q[:6] + 2.0) ** 0.5) ** 2.0 \
            + jnp.sum(jnp.sqrt(jnp.sum(v * v, 1)))
        cr = jnp.sum(jnp.cross(v[0], v[1]) * jnp.array([1.0, -2.0, 0.5],
                                                        dtype))
        cm = jnp.sum(jax.lax.cummax(q, axis=0)) \
            - jnp.sum(jax.lax.cummin(q, axis=0))
        Z = Xa / jnp.exp(q[6:8])
        K = jnp.exp(-0.5 * cdist(Z, Z, 2.0) ** 2) + 0.125 * jnp.eye(n,
                                                                  dtype=dtype)
        gp = -jnp.linalg.slogdet(K)[1] + 0.015625 * jnp.sum(cdist(Z, Z, 1.0)) \
            - 0.015625 * jnp.sum(cdist(Z, Z[:3], 3.0))
        return gp + 0.25 * cr + 0.1875 * cm - 0.125 * norms \
            - 0.5 * jnp.sum(q * q)

    return logprob_fn


def lu_family(m, b, device="cpu"):
    """lu_factor and lu_solve (plain and adjoint), lu_unpack, det, inv and
    cholesky_inverse of matrices that depend on q; q of 3."""
    M, B = _t(m, device), _t(b, device)

    def logprob_fn(q):
        A = M + 0.25 * torch.outer(q, q) + torch.diag(0.1875 * q)
        LU, piv = torch.linalg.lu_factor(A)
        x1 = torch.linalg.lu_solve(LU, piv, B)
        x2 = torch.linalg.lu_solve(LU, piv, B, adjoint=True)
        P, L, U = torch.lu_unpack(LU, piv)
        S = A @ A.T + torch.eye(3, dtype=q.dtype, device=device)
        ci = torch.cholesky_inverse(torch.linalg.cholesky(S))
        return -0.5 * torch.sum(x1 * x1) - 0.25 * torch.sum(x2 * x2) \
            - 0.125 * torch.sum((P @ L @ U) * M) - 0.0625 * torch.sum(L * U) \
            + 0.1875 * torch.det(A) \
            - 0.125 * torch.sum(torch.linalg.inv(A) ** 2) \
            - 0.1875 * torch.sum(ci * M) - 0.5 * torch.sum(q * q)

    return logprob_fn


def jax_lu_family(m, b, dtype=jnp.float64):
    M, B = jnp.asarray(m, dtype), jnp.asarray(b, dtype)

    def logprob_fn(q):
        A = M + 0.25 * jnp.outer(q, q) + jnp.diag(0.1875 * q)
        lu, piv = jax.scipy.linalg.lu_factor(A)
        x1 = jax.scipy.linalg.lu_solve((lu, piv), B)
        x2 = jax.scipy.linalg.lu_solve((lu, piv), B, trans=1)
        P, L, U = jax.scipy.linalg.lu(A)
        S = A @ A.T + jnp.eye(3, dtype=dtype)
        ci = jnp.linalg.inv(S)
        return -0.5 * jnp.sum(x1 * x1) - 0.25 * jnp.sum(x2 * x2) \
            - 0.125 * jnp.sum((P @ L @ U) * M) - 0.0625 * jnp.sum(L * U) \
            + 0.1875 * jnp.linalg.det(A) \
            - 0.125 * jnp.sum(jnp.linalg.inv(A) ** 2) \
            - 0.1875 * jnp.sum(ci * M) - 0.5 * jnp.sum(q * q)

    return logprob_fn


def svd_family(m, y, device="cpu"):
    """svdvals, the SVD used where its signs cancel (U Vh, U diag(s) U^T),
    a wide matrix's SVD, pinv and lstsq of a tall full-rank matrix that
    depends on q; q of 3."""
    M, Y = _t(m, device), _t(y, device)

    def logprob_fn(q):
        A = M + torch.outer(torch.ones(M.shape[0], dtype=q.dtype,
                                       device=device), 0.25 * q)
        s = torch.linalg.svdvals(A)
        U, S, Vh = torch.linalg.svd(A, full_matrices=False)
        Uw, Sw, Vhw = torch.linalg.svd(A.T, full_matrices=False)
        polar = torch.sum((U @ Vh) * M) + torch.sum((Uw @ Vhw) * M.T)
        proj = torch.sum(((U * S) @ U.T) * (M @ M.T))
        x = torch.linalg.lstsq(A, Y).solution
        return torch.sum(torch.log(s)) + 0.125 * polar - 0.015625 * proj \
            - 0.125 * torch.sum(torch.linalg.pinv(A) ** 2) \
            - 0.5 * torch.sum(x * x) + 0.0625 * torch.sum(Sw) \
            - 0.5 * torch.sum(q * q)

    return logprob_fn


def jax_svd_family(m, y, dtype=jnp.float64):
    M, Y = jnp.asarray(m, dtype), jnp.asarray(y, dtype)

    def logprob_fn(q):
        A = M + jnp.outer(jnp.ones(M.shape[0], dtype), 0.25 * q)
        s = jnp.linalg.svd(A, compute_uv=False)
        U, S, Vh = jnp.linalg.svd(A, full_matrices=False)
        Uw, Sw, Vhw = jnp.linalg.svd(A.T, full_matrices=False)
        polar = jnp.sum((U @ Vh) * M) + jnp.sum((Uw @ Vhw) * M.T)
        proj = jnp.sum(((U * S) @ U.T) * (M @ M.T))
        x = jnp.linalg.lstsq(A, Y)[0]
        return jnp.sum(jnp.log(s)) + 0.125 * polar - 0.015625 * proj \
            - 0.125 * jnp.sum(jnp.linalg.pinv(A) ** 2) \
            - 0.5 * jnp.sum(x * x) + 0.0625 * jnp.sum(Sw) \
            - 0.5 * jnp.sum(q * q)

    return logprob_fn


def families_data(seed=3):
    """The families' data: a Dirichlet's concentration, a Beta draw,
    negative-binomial and geometric counts, a multinomial count vector
    (one zero), a low-rank normal's point."""
    rng = np.random.default_rng(seed)
    return dict(conc=rng.uniform(1.0, 3.0, 4).astype(F32),
                beta_x=np.array([0.3, 0.7], F32),
                nb=rng.integers(0, 9, 5).astype(F32),
                geo=np.array([0.0, 1.0, 4.0], F32),
                mult=np.array([3.0, 0.0, 2.0], F32),
                lr=rng.standard_normal(3).astype(F32))


FAMILIES_DIM = 23


def families(d, device="cpu"):
    """torch.distributions: a Dirichlet on a StickBreakingTransform of q
    (with its log-Jacobian), Beta, NegativeBinomial(logits=),
    Geometric(logits=), Multinomial(logits=) and LowRankMultivariateNormal
    whose parameters depend on q; q of 23."""
    t = {k: _t(v, device) for k, v in d.items()}

    def logprob_fn(q):
        sb = dist.transforms.StickBreakingTransform()
        x = sb(q[0:3])
        lp = dist.Dirichlet(t["conc"]).log_prob(x) \
            + sb.log_abs_det_jacobian(q[0:3], x)
        lp = lp + dist.Beta(torch.exp(q[3]), torch.exp(q[4])).log_prob(
            t["beta_x"]).sum()
        lp = lp + dist.NegativeBinomial(torch.exp(q[5]), logits=q[6]).log_prob(
            t["nb"]).sum()
        lp = lp + dist.Geometric(logits=q[7]).log_prob(t["geo"]).sum()
        lp = lp + dist.Multinomial(5, logits=q[8:11]).log_prob(t["mult"])
        lp = lp + dist.LowRankMultivariateNormal(
            q[11:14], q[14:20].reshape(3, 2), torch.exp(q[20:23])).log_prob(
            t["lr"])
        return lp - 0.5 * torch.sum(q * q)

    return logprob_fn


def jax_families(d, dtype=jnp.float64):
    t = {k: jnp.asarray(v, dtype) for k, v in d.items()}

    def stick(x):
        k = x.shape[0]
        z = jax.nn.sigmoid(x - jnp.log(k + 1.0 - jnp.arange(1, k + 1)))
        zc = jnp.cumprod(1.0 - z)
        y = jnp.concatenate([z, jnp.ones(1, dtype)]) * jnp.concatenate(
            [jnp.ones(1, dtype), zc])
        xs = x - jnp.log(k + 1.0 - jnp.arange(1, k + 1))
        return y, jnp.sum(-xs + jax.nn.log_sigmoid(xs) + jnp.log(y[:-1]))

    def dirichlet(c, x):
        return jnp.sum(jss.xlogy(c - 1.0, x)) + jss.gammaln(jnp.sum(c)) \
            - jnp.sum(jss.gammaln(c))

    def logprob_fn(q):
        x, ld = stick(q[0:3])
        lp = dirichlet(t["conc"], x) + ld
        a, b = jnp.exp(q[3]), jnp.exp(q[4])
        bx = t["beta_x"]
        lp = lp + jnp.sum(jss.xlogy(a - 1.0, bx) + jss.xlogy(b - 1.0, 1 - bx)
                          + jss.gammaln(a + b) - jss.gammaln(a)
                          - jss.gammaln(b))
        r, nb = jnp.exp(q[5]), t["nb"]
        lp = lp + jnp.sum(r * jax.nn.log_sigmoid(-q[6])
                          + nb * jax.nn.log_sigmoid(q[6])
                          + jss.gammaln(r + nb) - jss.gammaln(1.0 + nb)
                          - jss.gammaln(r))
        p = jax.nn.sigmoid(q[7])
        lp = lp + jnp.sum(t["geo"] * jnp.log1p(-p) + jnp.log(p))
        logits = q[8:11] - jax.scipy.special.logsumexp(q[8:11])
        mult = t["mult"]
        lp = lp + jss.gammaln(jnp.sum(mult) + 1.0) \
            - jnp.sum(jss.gammaln(mult + 1.0)) + jnp.sum(logits * mult)
        W = q[14:20].reshape(3, 2)
        C = W @ W.T + jnp.diag(jnp.exp(q[20:23]))
        L = jnp.linalg.cholesky(C)
        z = jax.scipy.linalg.solve_triangular(L, t["lr"] - q[11:14],
                                              lower=True)
        lp = lp - 0.5 * jnp.sum(z * z) - jnp.sum(jnp.log(jnp.diagonal(L))) \
            - 1.5 * LOG_2PI
        return lp - 0.5 * jnp.sum(q * q)

    return logprob_fn


LKJ_L = np.linalg.cholesky(np.array([[1.0, 0.3, -0.2], [0.3, 1.0, 0.1],
                                     [-0.2, 0.1, 1.0]]))


def lkj_concentration(L, device="cpu"):
    """LKJCholesky(3, exp(q0)) at a fixed factor: its normaliser through
    mvlgamma of a concentration that depends on q; q of 2."""
    Lt = _t(L.astype(F32), device)

    def logprob_fn(q):
        return dist.LKJCholesky(3, torch.exp(q[0])).log_prob(Lt) \
            + q[0] - 0.5 * torch.sum(q * q)

    return logprob_fn


def jax_lkj_concentration(L, dtype=jnp.float64):
    Lj = jnp.asarray(L.astype(F32), dtype)
    K = 3

    def logprob_fn(q):
        conc = jnp.exp(q[0])
        order = jnp.arange(2, K + 1, dtype=dtype)
        order = 2.0 * (conc - 1.0) + K - order
        unnorm = jnp.sum(order * jnp.log(jnp.diagonal(Lj)[1:]))
        dm1 = K - 1
        alpha = conc + 0.5 * dm1
        denom = jss.gammaln(alpha) * dm1
        numer = jss.multigammaln(alpha - 0.5, dm1)
        pi_const = 0.5 * dm1 * math.log(math.pi)
        return unnorm - (pi_const + numer - denom) + q[0] \
            - 0.5 * jnp.sum(q * q)

    return logprob_fn


def chain_scatters(base, device="cpu"):
    """Reducing scatters (amax without the base, mean with it) by a
    per-chain index of several entries that repeat, (argmax(q[:3]) + [0,
    1, 2, 1, 0]) % 3, and a writing scatter by one of distinct entries that
    is no sort's permutation, (argmax(q[:3]) + [0, 2, 1]) % 3 (with a
    duplicate the packages' gradients differ:
    test_a_writing_scatter_keeps_the_last_of_a_duplicate); q of 5."""
    b = _t(base, device)

    def logprob_fn(q):
        am = torch.argmax(q[:3], 0, keepdim=True)
        k = (am + torch.tensor([0, 1, 2, 1, 0], device=device)) % 3
        r1 = b.scatter_reduce(0, k, 2.0 * q, "amax", include_self=False)
        r2 = b.scatter_reduce(0, k, q, "mean")
        w = b.scatter(0, (am + torch.tensor([0, 2, 1], device=device)) % 3,
                      q[2:])
        return -0.5 * torch.sum(r1 * r1) - 0.5 * torch.sum(r2 * r2) \
            - 0.5 * torch.sum(w * w) - 0.125 * torch.sum(q * q)

    return logprob_fn


def jax_chain_scatters(base, dtype=jnp.float64):
    b = jnp.asarray(base, dtype)
    off = np.array([0, 1, 2, 1, 0])

    def logprob_fn(q):
        k = (jnp.argmax(q[:3]) + off) % 3
        hit = jnp.zeros(3, dtype).at[k].add(1.0)
        r1 = jnp.where(hit > 0, jnp.full(3, -jnp.inf, dtype).at[k].max(
            2.0 * q), b)
        r2 = (b + jnp.zeros(3, dtype).at[k].add(q)) / (hit + 1.0)
        w = b.at[(jnp.argmax(q[:3]) + np.array([0, 2, 1])) % 3].set(q[2:])
        return -0.5 * jnp.sum(r1 * r1) - 0.5 * jnp.sum(r2 * r2) \
            - 0.5 * jnp.sum(w * w) - 0.125 * jnp.sum(q * q)

    return logprob_fn


# ----------------------------------------------------------- the cases ---

def _f64(*arrays):
    return [a.astype(np.float64) if isinstance(a, np.ndarray)
            and a.dtype == F32 else a for a in arrays]


def _cases():
    """name -> (torch logprob, float64 twin, the jnp twin as a function of
    a dtype, dim), at the CPU widths."""
    zc, zf, zy = zip_data()
    cX, cE = cox_data()
    dt, counts = ctmc_data()
    S, W0, N = ppca_data()
    rng = np.random.default_rng(7)
    w = rng.uniform(-math.pi, math.pi, 8).astype(F32)
    xa = rng.standard_normal((6, 2)).astype(F32)
    m = np.array([[2.0, 0.5, 0.1], [0.3, 0.1, 1.5], [0.2, 1.8, 0.4]], F32)
    b = np.array([[1.0, 0.5], [2.0, -1.0], [0.5, 0.3]], F32)
    ms = (rng.standard_normal((5, 3)) + 2.0 * np.eye(5, 3)).astype(F32)
    ys = rng.standard_normal((5, 2)).astype(F32)
    fam = families_data()
    base = np.array([0.5, 1.0, 1.5], F32)
    return {
        "zip_radon": (zip_radon(zc, zf, zy, 6),
                      zip_radon(*_f64(zc, zf, zy), 6),
                      lambda dt_: jax_zip_radon(zc, zf, zy, 6, dt_), 10),
        "cox_lung": (cox_lung(cX, cE), cox_lung(*_f64(cX, cE)),
                     lambda dt_: jax_cox_lung(cX, cE, dt_), 3),
        "ctmc_cav": (ctmc_cav(dt, counts), ctmc_cav(*_f64(dt, counts)),
                     lambda dt_: jax_ctmc_cav(dt, counts, dt_), 7),
        "ppca_qr": (ppca_qr(S, W0, N), ppca_qr(*_f64(S, W0), N),
                    lambda dt_: jax_ppca_qr(S, W0, N, dt_), 13),
        "special": (special(w), special(*_f64(w)),
                    lambda dt_: jax_special(w, dt_), 6),
        "scans": (scans(xa), scans(*_f64(xa)),
                  lambda dt_: jax_scans(xa, dt_), 8),
        "lu_family": (lu_family(m, b), lu_family(*_f64(m, b)),
                      lambda dt_: jax_lu_family(m, b, dt_), 3),
        "svd_family": (svd_family(ms, ys), svd_family(*_f64(ms, ys)),
                       lambda dt_: jax_svd_family(ms, ys, dt_), 3),
        "families": (families(fam),
                     families({k: v.astype(np.float64)
                               for k, v in fam.items()}),
                     lambda dt_: jax_families(fam, dt_), FAMILIES_DIM),
        "lkj_concentration": (lkj_concentration(LKJ_L),
                              lkj_concentration(LKJ_L),
                              lambda dt_: jax_lkj_concentration(LKJ_L, dt_),
                              2),
        "chain_scatters": (chain_scatters(base),
                           chain_scatters(base.astype(np.float64)),
                           lambda dt_: jax_chain_scatters(base, dt_), 5),
    }


def _summed(cases):
    """One case of the given ones' potentials on consecutive slices of q,
    their logprobs summed."""
    dims = [c[3] for c in cases]
    starts = np.cumsum([0] + dims)

    def summed(lps, zero):
        def logprob_fn(q):
            return sum((lp(q[a:a + d]) for lp, a, d in zip(lps, starts, dims)),
                       zero(q))
        return logprob_fn

    return (summed([c[0] for c in cases], lambda q: 0.0),
            summed([c[1] for c in cases], lambda q: 0.0),
            lambda dt_: summed([c[2](dt_) for c in cases], lambda q: 0.0),
            int(starts[-1]))


CASES = _cases()
U_CASES = ("zip_radon", "cox_lung", "ctmc_cav", "ppca_qr")
# kernels 5 and 7 run on U1-U4 and on the test-only cases summed (one JAX
# kernel trace for them all)
CASES["op_everyday"] = _summed([CASES[n] for n in sorted(CASES)
                                if n not in U_CASES])
_BOUND = {}


def _bound(name):
    """The front door's binding of a case and its bound functor (cached:
    one trace a case)."""
    if name not in _BOUND:
        lp, _, _, dim = CASES[name]
        pot, rows = _generic_fused_binding(lp, dim)
        bound = generic_pg.bind(pot, rows, dim)
        _BOUND[name] = (pot, tuple(rows), bound,
                        generic_pg.all_operands(
                            bound.ir, bound.operands(rows, "cpu")))
    return _BOUND[name]


def _positions(name, chains, seed, scale=0.3):
    """Positions of a case, tie-free (continuous draws): U3's log rates
    near the data's, the chain scatters' first three apart."""
    dim = CASES[name][3]
    rng = np.random.default_rng(seed)
    q = scale * rng.standard_normal((dim, chains))
    if name == "ctmc_cav":
        q += np.log(CAV_RATES)[:, None]
    if name == "zip_radon":
        q[6] += 0.8  # mu near the data's
    return q


def _assert_rel(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


# Limits of the plain back end (run in float64) against float64 autograd
# and jax.vjp: 1e-10 relative to the largest value; the IR holds the
# constants torch.distributions computes as Python floats rounded to
# float32, as the card holds them (6e-8 relative, 1e-7), for the cases
# written with it, and so for erfinv's backward (sqrt(pi) / 2) in
# "special"; against JAX, whose expm is Pade 13 (torch's Taylor 18),
# whose QR and SVD run other LAPACK paths, 1e-8.
FLOAT64_RTOL = {"zip_radon": 1e-7, "families": 1e-7, "lkj_concentration":
                1e-7, "cox_lung": 1e-7, "ctmc_cav": 1e-7, "ppca_qr": 1e-7,
                "special": 1e-7}
JAX_RTOL = {"ctmc_cav": 1e-7, "ppca_qr": 1e-7, "svd_family": 1e-8}
# Limits of the emitted functor (float32) against its plain back end: 1e-5
# of the largest value; the matrix exponential (torch's CPU products in
# another order, and a Taylor polynomial of degree 18 around them) and the
# SVD (one-sided Jacobi against LAPACK's) 1e-4.
EMITTED_RTOL = {"ctmc_cav": 1e-4, "svd_family": 1e-4, "ppca_qr": 1e-4}


# ---------------------------------------------------- the plain back end --

ONE_CASES = sorted(n for n in CASES if n != "op_everyday")


@pytest.mark.parametrize("name", ONE_CASES)
def test_plain_back_end_matches_autograd_and_jax_vjp(name):
    _, lp64, jax_lp, dim = CASES[name]
    pot, rows, bound, operands = _bound(name)
    q_t = _positions(name, 4, 0)
    u, g = generic_pg.run_plain(bound.ir, torch.tensor(q_t), operands)
    u_ref, g_ref = [], []
    for c in range(q_t.shape[1]):
        qc = torch.tensor(q_t[:, c], requires_grad=True)
        v = lp64(qc)
        (gc,) = torch.autograd.grad(v, qc)
        u_ref.append(-v.item())
        g_ref.append(-gc.numpy())
    rtol = FLOAT64_RTOL.get(name, 1e-10)
    _assert_rel(u.numpy().reshape(-1), u_ref, rtol)
    _assert_rel(g.numpy(), np.array(g_ref).T, rtol)
    f = jax_lp(jnp.float64)
    u_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(f), in_axes=1))(
        jnp.asarray(q_t))
    rtol = max(rtol, JAX_RTOL.get(name, 0.0))
    _assert_rel(u.numpy().reshape(-1), -np.asarray(u_j), rtol)
    _assert_rel(g.numpy(), -np.asarray(g_j).T, rtol)


_ERFINVF = r'''
#include <limits>
// CUDA's erfinvf, stood in by glibc's erf and Newton's method in double
inline float erfinvf(float y) {
  if (!(y > -1.f && y < 1.f))
    return y == -1.f ? -std::numeric_limits<float>::infinity()
         : y == 1.f ? std::numeric_limits<float>::infinity()
         : std::numeric_limits<float>::quiet_NaN();
  const double d = y, a = 0.147, ln = std::log((1.0 - d) * (1.0 + d));
  const double t = 2.0 / (3.14159265358979323846 * a) + ln / 2.0;
  double x = std::sqrt(std::sqrt(t * t - ln / a) - t);
  if (d < 0) x = -x;
  for (int i = 0; i < 6; ++i)
    x -= (std::erf(x) - d) / (1.1283791670955126 * std::exp(-x * x));
  return (float)x;
}
'''


def _emulate(source, operands, q, work, monkeypatch):
    import tests.test_torch_generic_pg as harness

    monkeypatch.setattr(harness, "_MOCK", harness._MOCK + _ERFINVF)
    return harness._emulate(source, operands, q, work)


@pytest.mark.parametrize("name", ONE_CASES)
def test_emitted_functor_computes_its_plain_version(name, tmp_path,
                                                    monkeypatch):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emitted functor for the CPU")
    _, _, bound, operands = _bound(name)
    q = _positions(name, 3, 11).T.astype(F32)
    u, g = generic_pg.run_plain(bound.ir, torch.tensor(q.T), operands)
    ue, ge = _emulate(bound.source, operands, q, tmp_path, monkeypatch)
    rtol = EMITTED_RTOL.get(name, 1e-5)
    _assert_rel(ue, u.numpy().reshape(-1), rtol)
    _assert_rel(ge, g.numpy().T, rtol)


# ------------------------------------ kernels 1, 5 and 7 against the JAX ones

CHAINS = 8
_JAX = {}


def _jax_twin(name):
    """The JAX package's binding of a case's float32 twin (cached)."""
    if name not in _JAX:
        _, _, jax_lp, dim = CASES[name]
        pot, rows = jax_binding(jax_lp(jnp.float32), dim)
        _JAX[name] = (pot, list(rows))
    return _JAX[name]


def _start(name, seed):
    _, _, bound, operands = _bound(name)

    def pg(q_t, *_data):
        return generic_pg.run_plain(bound.ir, q_t, operands)

    q = _positions(name, CHAINS, seed).T.astype(F32)
    u, g_t = pg(torch.tensor(q).T.contiguous())
    return pg, q, u, g_t


# The floats the kernels return, the port's against JAX's, both float32,
# from one state and one set of random numbers: 1e-5 relative and absolute
# (a few ulp of the energies and gradients: the packages' sum orders,
# factorisations and special functions differ there), every decision
# equal.
TOL = dict(rtol=1e-5, atol=1e-5)
Q_ATOL = 1e-5
# U3's and U4's energies are sums of a few hundred logs of products of
# matrices (expm: Taylor 18 against Pade 13; inv and det: LU orders), U1's
# energy ~110 (an ulp 7.6e-6) a sum of 40 terms in another order, the
# test-only cases' sum holds SVDs (one-sided Jacobi against LAPACK's) and
# special functions (Cephes's series against XLA's), and an acceptance
# probability carries the energy's error: 1e-4
KERNEL_TOL = {"ctmc_cav": dict(rtol=1e-4, atol=1e-4),
              "ppca_qr": dict(rtol=1e-4, atol=1e-4),
              "zip_radon": dict(rtol=1e-4, atol=1e-4),
              "op_everyday": dict(rtol=1e-4, atol=1e-4)}
KERNEL_CASES = [*U_CASES, "op_everyday"]


def _moved(q_new, q_old):
    return np.any(np.asarray(q_new) != np.asarray(q_old), axis=-1)


def _assert_agree(port, jax_out, q0, tol):
    qp, qj = np.asarray(port[0]), np.asarray(jax_out[0])
    np.testing.assert_array_equal(_moved(qp, q0), _moved(qj, q0))
    sp, sj = np.asarray(port[4]), np.asarray(jax_out[4])
    np.testing.assert_array_equal(sp[..., 2:5], sj[..., 2:5])
    np.testing.assert_allclose(sp[..., :2], sj[..., :2], **tol)
    np.testing.assert_allclose(qp, qj, rtol=0, atol=Q_ATOL)
    for a, b in zip(port[1:4], jax_out[1:4]):
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


# kernel 1 on U1-U4 only: the JAX kernel 1 traced in interpret mode on the
# summed test-only cases takes 30 s (kernels 5 and 7 take them, and phase
# 56 holds kernel 1 on them against its plain version on the card)
@pytest.mark.parametrize("name", U_CASES)
def test_kernel_1_plain_matches_jax_interpret(name):
    eps, max_exp = 0.02, 2
    pg, q, u0, g0 = _start(name, 1)
    dim = q.shape[1]
    rng = np.random.default_rng(2)
    p = rng.normal(size=(CHAINS, dim)).astype(F32)
    dirs = np.where(rng.uniform(size=(CHAINS, max_exp)) < 0.5, -1.0,
                    1.0).astype(F32)
    ub = rng.uniform(size=(CHAINS, max_exp)).astype(F32)
    ul = rng.uniform(size=(CHAINS, 2**max_exp)).astype(F32)
    im = np.full(dim, 0.8, F32)
    out = nuts_transition_plain(
        torch.tensor(q.T), u0, g0, torch.tensor(im), eps, pg,
        max_exp=max_exp, momentum=torch.tensor(p.T.copy()),
        directions=torch.tensor(dirs.T.copy()),
        u_bias=torch.tensor(ub.T.copy()), u_leaf=torch.tensor(ul.T.copy()))
    out = [o.numpy().T for o in out]
    jax_pot, jax_rows = _jax_twin(name)
    jt = jax_transition(jax_pot, jax_rows, max_num_expansions=max_exp,
                        block_chains=CHAINS, interpret=True)
    ref = [np.asarray(o) for o in jt(
        jnp.asarray(q), jnp.asarray(u0.numpy().reshape(-1, 1)),
        jnp.asarray(g0.numpy().T), jnp.asarray(p), jnp.asarray(dirs),
        jnp.asarray(ub), jnp.asarray(ul), jnp.asarray(im),
        jnp.asarray(eps, jnp.float32))]
    tol = KERNEL_TOL.get(name, TOL)
    np.testing.assert_array_equal(out[3][:, 2:6], ref[3][:, 2:6])
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=Q_ATOL)
    for a, b in zip((out[1], out[2], out[3][:, 0]),
                    (ref[1], ref[2], ref[3][:, 0])):
        np.testing.assert_allclose(a, b, **tol)
    assert (out[3][:, 3] > 1).any()  # trees of more than one leaf


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_5_plain_matches_jax_interpret(name):
    pg, q, u, g_t = _start(name, 5)
    dim = q.shape[1]
    rng = np.random.default_rng(6)
    p = rng.normal(size=(CHAINS, dim)).astype(F32)
    noise = rng.normal(size=(CHAINS, dim)).astype(F32)
    ua = rng.uniform(size=CHAINS).astype(F32)
    imm = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    eps, alpha = 0.02, 0.8
    u, g = u.reshape(-1).numpy(), g_t.T.contiguous().numpy()
    port = ghmc_fused.make_fused_ghmc_transition(
        None, (), potential_and_grad_t=pg)(
        torch.tensor(q), torch.tensor(u), torch.tensor(g), torch.tensor(p),
        eps, alpha, torch.tensor(imm), noise=torch.tensor(noise),
        u_accept=torch.tensor(ua))
    jax_pot, jax_rows = _jax_twin(name)
    jax_out = jax_ghmc.make_fused_ghmc_transition(
        jax_pot, jax_rows, block_chains=CHAINS, interpret=True)(
        jnp.asarray(q), jnp.asarray(u), jnp.asarray(g), jnp.asarray(p), eps,
        alpha, jnp.asarray(imm), noise=jnp.asarray(noise),
        u_accept=jnp.asarray(ua))
    _assert_agree(port, jax_out, q, KERNEL_TOL.get(name, TOL))
    assert _moved(port[0], q).any()


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_kernel_7_plain_matches_jax_interpret(name):
    pg, q, u, g_t = _start(name, 7)
    dim = q.shape[1]
    rng = np.random.default_rng(8)
    p = rng.normal(size=(CHAINS, dim)).astype(F32)
    ua = rng.uniform(size=CHAINS).astype(F32)
    im = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    eps = rng.uniform(0.01, 0.02, size=CHAINS).astype(F32)
    steps = 3
    u, g = u.reshape(-1).numpy(), g_t.T.contiguous().numpy()
    port = chees_fused.make_fused_chees_transition(
        None, (), potential_and_grad_t=pg)(
        torch.tensor(q), torch.tensor(u), torch.tensor(g), torch.tensor(p),
        torch.tensor(ua), torch.tensor(im), torch.tensor(eps), steps)
    jax_pot, jax_rows = _jax_twin(name)
    jax_out = jax_cf.make_fused_chees_transition(
        jax_pot, jax_rows, block_chains=CHAINS, interpret=True)(
        jnp.asarray(q), jnp.asarray(u), jnp.asarray(g), jnp.asarray(p),
        jnp.asarray(ua), jnp.asarray(im), jnp.asarray(eps),
        jnp.asarray(steps, jnp.int32))
    reorder = (lambda o: (o[0], o[1], o[2], None, o[3]))
    _assert_agree(reorder(port), reorder(jax_out), q,
                  KERNEL_TOL.get(name, TOL))
    for a, b in zip(port[4:], jax_out[4:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=Q_ATOL)


# --------------------------------------------------------- the front door --

@pytest.mark.parametrize("name", ["zip_radon", "cox_lung", "ctmc_cav"])
def test_front_door_runs_on_the_fused_path(name):
    """U1, U2 and U3 through the fused NUTS door on a bare logprob: finite
    draws, two runs with one seed equal bit for bit."""
    lp, _, _, dim = CASES[name]
    q0 = torch.tensor(_positions(name, 8, 3, 0.1).T, dtype=torch.float32)

    def run():
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(4), lp, q0, 5, 5,
            algorithm="nuts", path="fused", max_num_expansions=3)

    a, b = run(), run()
    assert a.positions.shape == (5, 8, dim)
    assert torch.isfinite(a.positions).all()
    assert torch.equal(a.positions, b.positions)


# --------------------------------------- rules that both packages keep ---

def test_low_rank_normal_binds():
    """LowRankMultivariateNormal writes its capacitance's diagonal through a
    flat strided view (``K.view(-1, m * m)[:, ::m + 1] += 1``), which the
    functionalized binding re-ran as a slice_scatter with an int64-max end
    that vmap rejected (``invalid size, possible overflow?``): it binds,
    and its plain potential and gradient equal float64 autograd."""
    loc = torch.tensor([0.1, -0.2, 0.3, 0.0])
    x = torch.tensor([0.5, 0.1, -0.4, 0.2])

    def lp(q):
        return dist.LowRankMultivariateNormal(
            loc, q[:12].reshape(4, 3), torch.exp(q[12:16])).log_prob(x)

    pot, rows = _generic_fused_binding(lp, 16)
    bound = generic_pg.bind(pot, rows, 16)
    q = 0.3 * np.random.default_rng(5).standard_normal((16, 3))
    u, g = generic_pg.run_plain(bound.ir, torch.tensor(q),
                                generic_pg.all_operands(
                                    bound.ir, bound.operands(rows, "cpu")))
    for c in range(3):
        qc = torch.tensor(q[:, c], requires_grad=True)
        v = dist.LowRankMultivariateNormal(
            loc.double(), qc[:12].reshape(4, 3),
            torch.exp(qc[12:16])).log_prob(x.double())
        (gc,) = torch.autograd.grad(v, qc)
        _assert_rel(u[0, c].item(), -v.item(), 1e-7)
        _assert_rel(g[:, c].numpy(), -gc.numpy(), 1e-7)


def test_a_read_through_a_mask_that_depends_on_q_is_refused_by_both():
    """``x[q > 0]`` has a shape that depends on the values: JAX raises
    NonConcreteBooleanIndexError, the port NotImplementedError saying that
    neither package takes it; a write under such a mask that keeps the
    shape (``x[q > 0] = 0``) binds, as ``where``."""
    def lp(q):
        return -0.5 * torch.sum(q[q > 0] ** 2)

    pot, rows = _generic_fused_binding(lp, 4)
    with pytest.raises(NotImplementedError, match="neither package") as err:
        generic_pg.bind(pot, rows, 4)
    assert "1.10c" not in str(err.value)
    with pytest.raises(jax.errors.NonConcreteBooleanIndexError):
        jax_binding(lambda q: -0.5 * jnp.sum(q[q > 0] ** 2), 4)

    def write(q):
        v = q.clone()
        v[q > 0] = 0.0
        return -0.5 * torch.sum(v * v)

    pot, rows = _generic_fused_binding(write, 4)
    bound = generic_pg.bind(pot, rows, 4)
    assert "where" in {n.op for n in bound.ir.nodes}
    q = torch.tensor([[0.5, -1.0, 2.0, -0.3]]).T
    u, g = generic_pg.run_plain(bound.ir, q, bound.operands(rows, "cpu"))
    assert u.item() == pytest.approx(0.5 * (1.0 + 0.09))
    np.testing.assert_allclose(g.reshape(-1).numpy(), [0.0, -1.0, 0.0, -0.3])


def test_a_writing_scatter_keeps_the_last_of_a_duplicate():
    """A writing scatter by a per-chain index with a duplicate: the last
    value in index order wins (torch's CPU scatter writes in that order),
    and the gradient is torch's traced one (the gather of the output's
    gradient, which reaches every duplicate; JAX's reaches the winner
    only: PARITY_TORCH.md, "differs, on purpose")."""
    b = torch.tensor([0.5, 1.0, 1.5])

    def lp(q):
        k = (torch.argmax(q[:3], 0, keepdim=True)
             + torch.tensor([0, 1, 2, 1, 0])) % 3
        return -0.5 * torch.sum(b.scatter(0, k, q) ** 2)

    pot, rows = _generic_fused_binding(lp, 5)
    bound = generic_pg.bind(pot, rows, 5)
    assert "scatter_put" in {n.op for n in bound.ir.nodes}
    q = torch.tensor([[2.0, 0.1, 0.3, -0.7, 0.9]]).T  # k = [0, 1, 2, 1, 0]
    u, g = generic_pg.run_plain(bound.ir, q, bound.operands(rows, "cpu"))
    assert u.item() == pytest.approx(0.5 * (0.9 ** 2 + 0.7 ** 2 + 0.3 ** 2))
    qc = q[:, 0].clone().requires_grad_(True)
    (g_ref,) = torch.autograd.grad(lp(qc), qc)
    np.testing.assert_array_equal(g.reshape(-1).numpy(), -g_ref.numpy())


# ------------------------------------------------- the families that bind --

def _families():
    """name -> (logprob of q, dim): torch.distributions' families named in
    the op table's reopening, each with parameters that depend on q."""
    y = torch.tensor([0.0, 1.0, 3.0, 2.0])
    L3 = torch.tensor(LKJ_L, dtype=torch.float32)
    sb = dist.transforms.StickBreakingTransform()

    def dirichlet_sb(q):
        x = sb(q[:3])
        return dist.Dirichlet(torch.tensor([1.5, 2.0, 1.0, 3.0])).log_prob(
            x) + sb.log_abs_det_jacobian(q[:3], x)

    return {
        "Poisson": (lambda q: dist.Poisson(torch.exp(q)).log_prob(y).sum(),
                    4),
        "Gamma": (lambda q: dist.Gamma(torch.exp(q[:2]), 2.0).log_prob(
            torch.exp(q[2:])).sum(), 4),
        "Beta": (lambda q: dist.Beta(torch.exp(q[0]),
                                     torch.exp(q[1])).log_prob(
            torch.sigmoid(q[2])), 3),
        "Dirichlet": (lambda q: dist.Dirichlet(torch.exp(q)).log_prob(
            torch.tensor([0.2, 0.3, 0.5])), 3),
        "Dirichlet_stick_breaking": (dirichlet_sb, 3),
        "Bernoulli_logits": (lambda q: dist.Bernoulli(logits=q).log_prob(
            torch.tensor([0.0, 1.0, 1.0, 0.0])).sum(), 4),
        "NegativeBinomial_logits": (
            lambda q: dist.NegativeBinomial(torch.exp(q[0]),
                                            logits=q[1:]).log_prob(y).sum(),
            5),
        "LowRankMultivariateNormal": (
            lambda q: dist.LowRankMultivariateNormal(
                q[:3], q[3:9].reshape(3, 2), torch.exp(q[9:12])).log_prob(
                torch.tensor([0.1, 0.2, 0.3])), 12),
        "LKJCholesky_concentration": (
            lambda q: dist.LKJCholesky(3, torch.exp(q[0])).log_prob(L3), 1),
        "Geometric": (lambda q: dist.Geometric(logits=q).log_prob(
            y).sum(), 4),
        "Multinomial": (lambda q: dist.Multinomial(6, logits=q).log_prob(
            torch.tensor([1.0, 0.0, 5.0])), 3),
        "StudentT": (lambda q: dist.StudentT(torch.exp(q[0]) + 1.0, q[1],
                                             torch.exp(q[2])).log_prob(
            y).sum(), 3),
        "VonMises": (lambda q: dist.VonMises(q[0], torch.exp(q[1])).log_prob(
            torch.tensor([0.3, -0.4])).sum(), 2),
        "Binomial": (lambda q: dist.Binomial(5, logits=q).log_prob(y).sum(),
                     4),
        "Categorical": (lambda q: dist.Categorical(logits=q).log_prob(
            torch.tensor([0, 2, 1])).sum(), 3),
        "Exponential": (lambda q: dist.Exponential(torch.exp(q)).log_prob(
            y + 0.5).sum(), 4),
        "HalfCauchy": (lambda q: dist.HalfCauchy(torch.exp(q)).log_prob(
            y + 0.5).sum(), 4),
        "LogNormal": (lambda q: dist.LogNormal(q[0], torch.exp(q[1])).log_prob(
            y + 0.5).sum(), 2),
        "Laplace": (lambda q: dist.Laplace(q[0], torch.exp(q[1])).log_prob(
            y).sum(), 2),
        "Wishart": (lambda q: dist.Wishart(
            torch.tensor(4.0), scale_tril=torch.diag(torch.exp(q))).log_prob(
            torch.tensor([[2.0, 0.3], [0.3, 1.0]])), 2),
    }


FAMILIES = _families()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_distributions_bind(family):
    """Each family binds through the front door's binding and the
    compiler's trace, and its plain potential and gradient equal float64
    autograd of the same logprob (its float32 constants, as the card holds
    them, within 1e-6 relative)."""
    lp, dim = FAMILIES[family]
    pot, rows = _generic_fused_binding(lp, dim)
    traced = generic_pg.trace_potential(pot, rows, dim)
    operands = generic_pg.all_operands(traced.ir, (*rows, *traced.constants))
    q = 0.3 * np.random.default_rng(9).standard_normal((dim, 3))
    u, g = generic_pg.run_plain(traced.ir, torch.tensor(q), operands)
    torch.set_default_dtype(torch.float64)
    try:
        for c in range(3):
            qc = torch.tensor(q[:, c], requires_grad=True)
            with generic_pg.no_validation():
                v = lp(qc)
            (gc,) = torch.autograd.grad(v, qc)
            _assert_rel(u[0, c].item(), -v.item(), 1e-6)
            _assert_rel(g[:, c].numpy(), -gc.numpy(), 1e-6)
    finally:
        torch.set_default_dtype(torch.float32)
