"""The last of the potential compiler's op table on the CPU: Cholesky
factors, log-determinants, symmetric eigendecompositions, sorts, top-k,
cumulative products and products, ``scatter_reduce``, the structural ops
(``eye``, diagonals, triangles, constant padding), values of the data
folded on the host, and integer arithmetic on a per-chain index.

- The six potentials that carry these ops, plain torch logprobs (some
  written with ``torch.distributions``) with float64 and ``jnp`` twins,
  their data made from a seed with numpy: S1 ``gp_se64`` (a Gaussian
  process's marginal likelihood through a Cholesky factor), S2
  ``gp_se64_logdet`` (the same through ``logdet`` and ``linalg.solve``),
  S3 ``lkj_slopes`` (varying intercepts and slopes under an LKJ prior on
  their correlation's Cholesky factor, ``torch.distributions``), S4
  ``ordinal_sorted`` (ordered-logistic regression with sorted cut-points),
  S5 ``matrix_log_cov`` (a normal whose covariance is the matrix
  exponential of a symmetric A(q), through ``eigh``) and S6 ``lts_topk``
  (least-trimmed-squares regression through ``topk``), at small sizes; and
  the test-only cases of ``scatter_reduce`` and per-chain index arithmetic.
  ``chip_smoke.py`` keeps its own copy of the torch ones at full width.
- For each: the plain back end against float64 autograd and ``jax.vjp``;
  the emitted functor, compiled with g++ (``tests/test_torch_generic_pg.py``'s
  harness), against the plain back end.
- Kernels 1, 5 and 7, through their plain versions with the plain back end
  as the potential, against the JAX kernels in interpret mode on external
  randomness: decisions equal, floats within the stated limits.
- The fused front door on S1 and S4, and every fused algorithm's on S5;
  a factor that is not positive definite gives NaN and a divergent
  transition in both packages; a mask that depends on q is refused by
  both; ``torch.distributions`` binds with its validation off and the
  caller's setting restored.
"""

import math
import shutil

import numpy as np
import pytest
import torch
import torch.distributions as dist

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln, multigammaln

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


# ------------------------------------------------------- the potentials ---

GP_JITTER = 1e-6
LKJ_NOISE = 2.0   # S3's residual sd (chip_smoke.py's)


def gp_data(num_points=12, seed=0):
    """S1/S2's regression data: sorted inputs on [-5, 5] and a smooth
    function plus noise of sd 0.3 (float32)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-5.0, 5.0, num_points))
    y = np.sin(x) + 0.5 * np.cos(2.0 * x) + 0.3 * rng.standard_normal(
        num_points)
    return x.astype(F32), y.astype(F32)


def gp_se(x, y, logdet=False, device="cpu"):
    """S1 (S2 with ``logdet``): a GP's marginal likelihood, squared-
    exponential kernel plus noise, q = (log alpha, log rho, log sigma) with
    N(0, 1), N(0, 1), N(-1, 1) priors (Stan Users Guide, "Fitting a
    Gaussian process": cholesky_decompose and multi_normal_cholesky; S2
    writes the same density with logdet and a general solve)."""
    X, Y = (torch.as_tensor(a, device=device) for a in (x, y))
    n = X.shape[0]

    def logprob_fn(q):
        alpha, rho, sigma = torch.exp(q[0]), torch.exp(q[1]), torch.exp(q[2])
        d = (X[:, None] - X[None, :]) / rho
        K = alpha * alpha * torch.exp(-0.5 * d * d) + (
            sigma * sigma + GP_JITTER) * torch.eye(n, dtype=X.dtype,
                                                   device=device)
        if logdet:
            ll = -0.5 * torch.dot(Y, torch.linalg.solve(K, Y)) \
                - 0.5 * torch.logdet(K)
        else:
            L = torch.linalg.cholesky(K)
            z = torch.linalg.solve_triangular(L, Y[:, None], upper=False)
            ll = -0.5 * torch.sum(z * z) - torch.sum(torch.log(
                torch.diagonal(L)))
        return ll - 0.5 * (q[0] ** 2 + q[1] ** 2 + (q[2] + 1.0) ** 2)

    return logprob_fn


def jax_gp_se(x, y, logdet=False, dtype=jnp.float64):
    X, Y = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    n = X.shape[0]

    def logprob_fn(q):
        alpha, rho, sigma = jnp.exp(q[0]), jnp.exp(q[1]), jnp.exp(q[2])
        d = (X[:, None] - X[None, :]) / rho
        K = alpha * alpha * jnp.exp(-0.5 * d * d) + (
            sigma * sigma + GP_JITTER) * jnp.eye(n, dtype=dtype)
        if logdet:
            ll = -0.5 * jnp.dot(Y, jnp.linalg.solve(K, Y)) \
                - 0.5 * jnp.linalg.slogdet(K)[1]
        else:
            L = jnp.linalg.cholesky(K)
            z = jax.scipy.linalg.solve_triangular(L, Y, lower=True)
            ll = -0.5 * jnp.sum(z * z) - jnp.sum(jnp.log(jnp.diagonal(L)))
        return ll - 0.5 * (q[0] ** 2 + q[1] ** 2 + (q[2] + 1.0) ** 2)

    return logprob_fn


def lkj_data(num_coef=3, num_groups=4, num_obs=24, seed=0):
    """S3's data: group of each observation (int64), covariates with an
    intercept column (float32), responses (float32), from the model with
    an LKJ(2) correlation of the groups' coefficients."""
    rng = np.random.default_rng(seed)
    K, J, N = num_coef, num_groups, num_obs
    A = rng.standard_normal((K, K))
    S = A @ A.T + K * np.eye(K)
    d = 1.0 / np.sqrt(np.diag(S))
    L = np.linalg.cholesky(S * d[:, None] * d[None, :])
    tau = np.exp(rng.normal(-0.5, 0.3, K))
    mu = rng.normal(0.0, 1.0, K)
    beta = mu + (rng.standard_normal((J, K)) @ L.T) * tau
    group = np.arange(N) % J
    x = np.concatenate([np.ones((N, 1)), rng.standard_normal((N, K - 1))], 1)
    y = (x * beta[group]).sum(1) + LKJ_NOISE * rng.standard_normal(N)
    return group.astype(np.int64), x.astype(F32), y.astype(F32)


def lkj_slopes(group, x, y, num_groups, device="cpu"):
    """S3: non-centred varying intercepts and slopes, beta_j = mu + diag(tau)
    L z_j, L ~ LKJCholesky(K, 2) through CorrCholeskyTransform, z_j ~
    MultivariateNormal(0, scale_tril=I), y ~ Normal(x . beta_group, sigma)
    (Stan Users Guide, "Multivariate priors for hierarchical models"),
    written with torch.distributions; q = (mu (K), log tau (K), the
    factor's K(K-1)/2 unconstrained values, z (J K), log sigma)."""
    g, X, Y = (torch.as_tensor(a, device=device) for a in (group, x, y))
    K, J = X.shape[1], num_groups
    m = K * (K - 1) // 2

    def logprob_fn(q):
        mu, log_tau = q[:K], q[K:2 * K]
        raw, z = q[2 * K:2 * K + m], q[2 * K + m:2 * K + m + J * K]
        log_sigma = q[-1]
        corr = dist.transforms.CorrCholeskyTransform()
        L = corr(raw)
        lp = dist.LKJCholesky(K, torch.tensor(2.0, dtype=q.dtype,
                                              device=device)).log_prob(L) \
            + corr.log_abs_det_jacobian(raw, L)
        Z = z.reshape(J, K)
        lp = lp + dist.MultivariateNormal(
            torch.zeros(K, dtype=q.dtype, device=device),
            scale_tril=torch.eye(K, dtype=q.dtype, device=device)).log_prob(
            Z).sum()
        beta = mu + (Z @ L.T) * torch.exp(log_tau)
        eta = torch.sum(X * beta[g], -1)
        lp = lp + dist.Normal(eta, torch.exp(log_sigma)).log_prob(Y).sum()
        return lp + dist.Normal(0.0, 5.0).log_prob(mu).sum() \
            + dist.Normal(0.0, 1.0).log_prob(log_tau).sum() \
            + dist.Normal(0.0, 1.0).log_prob(log_sigma)

    return logprob_fn


def _jax_corr_cholesky(raw, K, dtype):
    """torch's CorrCholeskyTransform and its log-Jacobian, in jnp."""
    eps = float(np.finfo(np.float32 if dtype == jnp.float32
                         else np.float64).eps)
    x = jnp.clip(jnp.tanh(raw), -1 + eps, 1 - eps)
    rows, cols = np.tril_indices(K, -1)
    r = jnp.zeros((K, K), dtype).at[rows, cols].set(x)
    z1m = jnp.cumprod(jnp.sqrt(1.0 - r * r), -1)
    pad = jnp.concatenate([jnp.ones((K, 1), dtype), z1m[:, :-1]], 1)
    y = (r + jnp.eye(K, dtype=dtype)) * pad
    y1m = 1.0 - jnp.cumsum(y * y, -1)
    rows2, cols2 = np.tril_indices(K, -2)
    stick = 0.5 * jnp.sum(jnp.log(y1m[rows2, cols2]))
    tanh_ld = -2.0 * jnp.sum(raw + jax.nn.softplus(-2.0 * raw)
                             - math.log(2.0))
    return y, stick + tanh_ld


def jax_lkj_slopes(group, x, y, num_groups, dtype=jnp.float64):
    X, Y = jnp.asarray(x, dtype), jnp.asarray(y, dtype)
    K, J = x.shape[1], num_groups
    m = K * (K - 1) // 2
    conc = 2.0
    alpha = conc + 0.5 * (K - 1)
    log_norm = 0.5 * (K - 1) * math.log(math.pi) + float(multigammaln(
        alpha - 0.5, K - 1)) - float(gammaln(alpha)) * (K - 1)
    order = jnp.asarray(2.0 * (conc - 1.0) + K - np.arange(2, K + 1), dtype)

    def normal(v, loc, scale):
        return -0.5 * ((v - loc) / scale) ** 2 - jnp.log(scale) \
            - 0.5 * math.log(2 * math.pi)

    def logprob_fn(q):
        mu, log_tau = q[:K], q[K:2 * K]
        raw, z = q[2 * K:2 * K + m], q[2 * K + m:2 * K + m + J * K]
        log_sigma = q[-1]
        L, log_jac = _jax_corr_cholesky(raw, K, dtype)
        lp = jnp.sum(order * jnp.log(jnp.diagonal(L)[1:])) - log_norm \
            + log_jac
        Z = z.reshape(J, K)
        lp = lp + jnp.sum(normal(Z, 0.0, 1.0))
        beta = mu + (Z @ L.T) * jnp.exp(log_tau)
        eta = jnp.sum(X * beta[group], -1)
        lp = lp + jnp.sum(normal(Y, eta, jnp.exp(log_sigma)))
        return lp + jnp.sum(normal(mu, 0.0, 5.0)) \
            + jnp.sum(normal(log_tau, 0.0, 1.0)) + normal(log_sigma, 0.0, 1.0)

    return logprob_fn


def ordinal_data(num_obs=40, num_pred=3, seed=0):
    """S4's data: predictors (float32) and 5 ordered categories 1..5
    (int64) from an ordered-logistic model."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((num_obs, num_pred))
    beta = rng.normal(0.0, 1.0, num_pred)
    cuts = np.array([-1.5, -0.5, 0.5, 1.5])
    latent = X @ beta + rng.logistic(size=num_obs)
    y = 1 + np.searchsorted(cuts, latent)
    return X.astype(F32), y.astype(np.int64)


def ordinal_sorted(X, y, device="cpu"):
    """S4: ordered-logistic regression (Stan Users Guide, "Ordered logistic
    regression"), 5 categories, the cut-points torch.sort of 4 free values;
    q = (beta (P), c_raw (4)), N(0, 2.5) and N(0, 5) priors; the
    likelihood read at each observation's category."""
    Xt, yt = (torch.as_tensor(a, device=device) for a in (X, y))
    N, P = Xt.shape

    def logprob_fn(q):
        beta, c = q[:P], torch.sort(q[P:P + 4]).values
        cum = torch.sigmoid(c[None, :] - (Xt @ beta)[:, None])
        cum = torch.cat([torch.zeros(N, 1, dtype=q.dtype, device=device), cum,
                         torch.ones(N, 1, dtype=q.dtype, device=device)], 1)
        p = cum[:, 1:] - cum[:, :-1]
        ll = torch.log(p[torch.arange(N, device=device), yt - 1]).sum()
        return ll - 0.5 * torch.sum((beta / 2.5) ** 2) \
            - 0.5 * torch.sum((q[P:P + 4] / 5.0) ** 2)

    return logprob_fn


def jax_ordinal_sorted(X, y, dtype=jnp.float64):
    Xj, yj = jnp.asarray(X, dtype), jnp.asarray(y)
    N, P = X.shape

    def logprob_fn(q):
        beta, c = q[:P], jnp.sort(q[P:P + 4])
        cum = jax.nn.sigmoid(c[None, :] - (Xj @ beta)[:, None])
        cum = jnp.concatenate([jnp.zeros((N, 1), dtype), cum,
                               jnp.ones((N, 1), dtype)], 1)
        p = cum[:, 1:] - cum[:, :-1]
        ll = jnp.log(p[jnp.arange(N), yj - 1]).sum()
        return ll - 0.5 * jnp.sum((beta / 2.5) ** 2) \
            - 0.5 * jnp.sum((q[P:P + 4] / 5.0) ** 2)

    return logprob_fn


def mlc_data(num_dim=3, num_rows=20, seed=0):
    """S5's rows (float32): a normal of mean N(0, 1) and covariance
    V diag(exp(lam)) V^T with well separated log-eigenvalues."""
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((num_dim, num_dim)))
    lam = np.linspace(-1.0, 1.0, num_dim)
    cov = (V * np.exp(lam)) @ V.T
    mu = rng.standard_normal(num_dim)
    Y = mu + rng.standard_normal((num_rows, num_dim)) @ np.linalg.cholesky(
        cov).T
    return Y.astype(F32)


def matrix_log_cov(Y, device="cpu"):
    """S5: a normal with covariance exp(A), A symmetric from q (the matrix-
    logarithm parametrisation of Leonard and Hsu, 1992): Sigma^-1 = V
    exp(-Lambda) V^T and log det Sigma = sum(Lambda) from eigh(A); q = (mu
    (K), A's lower triangle (K(K+1)/2)), N(0, 10) and N(0, 1) priors."""
    Yt = torch.as_tensor(Y, device=device)
    n, K = Yt.shape
    rows, cols = (torch.as_tensor(a, device=device)
                  for a in np.tril_indices(K))

    def logprob_fn(q):
        mu, a = q[:K], q[K:]
        A = torch.zeros(K, K, dtype=q.dtype, device=device)
        A[rows, cols] = a
        A[cols, rows] = a
        lam, V = torch.linalg.eigh(A)
        prec = (V * torch.exp(-lam)) @ V.T
        R = Yt - mu
        return -0.5 * torch.sum((R @ prec) * R) - 0.5 * n * torch.sum(lam) \
            - 0.5 * torch.sum((mu / 10.0) ** 2) - 0.5 * torch.sum(a * a)

    return logprob_fn


def jax_matrix_log_cov(Y, dtype=jnp.float64):
    Yj = jnp.asarray(Y, dtype)
    n, K = Y.shape
    rows, cols = np.tril_indices(K)

    def logprob_fn(q):
        mu, a = q[:K], q[K:]
        A = jnp.zeros((K, K), dtype).at[rows, cols].set(a).at[cols, rows].set(a)
        lam, V = jnp.linalg.eigh(A)
        prec = (V * jnp.exp(-lam)) @ V.T
        R = Yj - mu
        return -0.5 * jnp.sum((R @ prec) * R) - 0.5 * n * jnp.sum(lam) \
            - 0.5 * jnp.sum((mu / 10.0) ** 2) - 0.5 * jnp.sum(a * a)

    return logprob_fn


def lts_data(num_points=30, num_pred=5, seed=0):
    """S6's design and responses (float32), a tenth of them outliers."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((num_points, num_pred))
    beta = rng.normal(0.0, 1.0, num_pred)
    y = X @ beta + 0.5 * rng.standard_normal(num_points)
    bad = rng.choice(num_points, num_points // 10, replace=False)
    y[bad] += rng.choice([-1.0, 1.0], bad.size) * 8.0
    return X.astype(F32), y.astype(F32)


def lts_topk(X, y, h, device="cpu"):
    """S6: least trimmed squares (Rousseeuw 1984) as a likelihood: the h
    smallest squared residuals through torch.topk(largest=False), scale
    sigma; q = (beta (P), log sigma), N(0, 5) and N(0, 1) priors."""
    Xt, yt = (torch.as_tensor(a, device=device) for a in (X, y))
    P = Xt.shape[1]

    def logprob_fn(q):
        beta, log_sigma = q[:P], q[P]
        r2 = (yt - Xt @ beta) ** 2
        kept = torch.topk(r2, h, largest=False).values
        return -0.5 * torch.sum(kept) * torch.exp(-2.0 * log_sigma) \
            - h * log_sigma - 0.5 * torch.sum((beta / 5.0) ** 2) \
            - 0.5 * log_sigma ** 2

    return logprob_fn


def jax_lts_topk(X, y, h, dtype=jnp.float64):
    Xj, yj = jnp.asarray(X, dtype), jnp.asarray(y, dtype)
    P = X.shape[1]

    def logprob_fn(q):
        beta, log_sigma = q[:P], q[P]
        r2 = (yj - Xj @ beta) ** 2
        kept = -jax.lax.top_k(-r2, h)[0]
        return -0.5 * jnp.sum(kept) * jnp.exp(-2.0 * log_sigma) \
            - h * log_sigma - 0.5 * jnp.sum((beta / 5.0) ** 2) \
            - 0.5 * log_sigma ** 2

    return logprob_fn


# ----------------------------------------------- the test-only cases ---

SR_GROUPS, SR_ENTRIES, SR_DIM = 6, 40, 4


def sred_data(seed=6):
    """A 40-entry index into 6 groups (each group hit), the design of the
    scattered values and the base (float32)."""
    rng = np.random.default_rng(seed)
    idx = np.concatenate([np.arange(SR_GROUPS), rng.integers(
        0, SR_GROUPS, SR_ENTRIES - SR_GROUPS)])
    A = rng.standard_normal((SR_ENTRIES, SR_DIM))
    base = rng.uniform(0.5, 1.5, SR_GROUPS)
    return idx.astype(np.int64), A.astype(F32), base.astype(F32)


SR_KINDS = [(r, i) for r in ("sum", "mean", "amax", "amin")
            for i in (True, False)]


def sred(idx, A, base, kinds):
    """``scatter_reduce`` by a data index of values that depend on q, for
    each ``(reduce, include_self)`` of ``kinds``."""
    it, At, bt = (torch.as_tensor(a) for a in (idx, A, base))

    def logprob_fn(q):
        s = At @ q
        lp = -0.5 * torch.sum(q * q)
        for reduce, include_self in kinds:
            out = bt.scatter_reduce(0, it, s, reduce=reduce,
                                    include_self=include_self)
            lp = lp - 0.5 * torch.sum(out * out)
        return lp

    return logprob_fn


def jax_sred(idx, A, base, kinds, dtype=jnp.float64):
    Aj, bj = jnp.asarray(A, dtype), jnp.asarray(base, dtype)
    counts = np.bincount(idx, minlength=SR_GROUPS)

    def one(s, reduce, include_self):
        if reduce in ("sum", "mean"):
            tot = jnp.zeros_like(bj).at[idx].add(s)
            if include_self:
                tot = tot + bj
            return tot / (counts + include_self) if reduce == "mean" else tot
        fill = {"prod": 1.0, "amax": -jnp.inf, "amin": jnp.inf}[reduce]
        at = (bj if include_self else jnp.full_like(bj, fill)).at[idx]
        return {"prod": at.multiply, "amax": at.max, "amin": at.min}[
            reduce](s)

    def logprob_fn(q):
        s = Aj @ q
        lp = -0.5 * jnp.sum(q * q)
        for reduce, include_self in kinds:
            out = one(s, reduce, include_self)
            lp = lp - 0.5 * jnp.sum(out * out)
        return lp

    return logprob_fn


W4 = np.array([1.0, 2.5, -1.0, 0.5], F32)
M34 = (np.arange(12.0).reshape(3, 4) / 7.0 - 0.8).astype(F32)


def chain_index(W, M):
    """Integer arithmetic on per-chain indices: ``w[(argmax(q[:4]) + 1) %
    4]`` (the index kept 1-d: torch's Python indexing reads a 0-d index
    tensor as an int, which no trace takes) and ``M[i, j]`` with i, j the
    indices of a maximum and a minimum."""
    Wt, Mt = torch.as_tensor(W), torch.as_tensor(M)

    def logprob_fn(q):
        k = (torch.argmax(q[:4], dim=0, keepdim=True) + 1) % 4
        i = torch.argmax(q[4:7], dim=0, keepdim=True)
        j = torch.argmin(q[:4], dim=0, keepdim=True) * 2 - 3
        return torch.sum(Wt[k] * q[0] + Mt[i, j] * q[4]) \
            - 0.5 * torch.sum(q * q)

    return logprob_fn


def jax_chain_index(W, M, dtype=jnp.float64):
    Wj, Mj = jnp.asarray(W, dtype), jnp.asarray(M, dtype)

    def logprob_fn(q):
        k = (jnp.argmax(q[:4]) + 1) % 4
        i = jnp.argmax(q[4:7])
        j = jnp.argmin(q[:4]) * 2 - 3
        return Wj[k] * q[0] + Mj[i, j] * q[4] - 0.5 * jnp.sum(q * q)

    return logprob_fn


def sort_bitonic(lin):
    """A sort of 40 values (descending) and a top-5: longer than a warp, so
    the functor runs its bitonic network."""
    lt = torch.as_tensor(lin)

    def logprob_fn(q):
        return -0.5 * torch.sum((torch.sort(q, descending=True).values - lt)
                                ** 2) + torch.topk(q, 5).values.sum()

    return logprob_fn


def jax_sort_bitonic(lin, dtype=jnp.float64):
    lj = jnp.asarray(lin, dtype)

    def logprob_fn(q):
        return -0.5 * jnp.sum((-jnp.sort(-q) - lj) ** 2) \
            + jax.lax.top_k(q, 5)[0].sum()

    return logprob_fn


def eigvalsh(M):
    """The eigenvalues alone of a symmetric matrix that depends on q."""
    Mt = torch.as_tensor(M)

    def logprob_fn(q):
        return -0.5 * torch.sum(torch.linalg.eigvalsh(
            Mt + torch.outer(q, q)) ** 2)

    return logprob_fn


def jax_eigvalsh(M, dtype=jnp.float64):
    Mj = jnp.asarray(M, dtype)

    def logprob_fn(q):
        return -0.5 * jnp.sum(jnp.linalg.eigvalsh(Mj + jnp.outer(q, q)) ** 2)

    return logprob_fn


# ----------------------------------------------------------- the cases ---

def _s_cases():
    """name -> (torch logprob, float64 twin, jnp twin builder of a dtype,
    dim), at the CPU widths."""
    x, y = gp_data(12, seed=1)
    g, X3, Y3 = lkj_data(3, 4, 24, seed=2)
    Xo, yo = ordinal_data(40, 3, seed=3)
    Ym = mlc_data(3, 20, seed=4)
    Xl, yl = lts_data(30, 5, seed=5)

    def f64(*arrays):
        return [a.astype(np.float64) if a.dtype == F32 else a for a in arrays]

    return {
        "gp_se64": (gp_se(x, y), gp_se(*f64(x, y)),
                    lambda dt: jax_gp_se(x, y, False, dt), 3),
        "gp_se64_logdet": (gp_se(x, y, True), gp_se(*f64(x, y), True),
                           lambda dt: jax_gp_se(x, y, True, dt), 3),
        "lkj_slopes": (lkj_slopes(g, X3, Y3, 4),
                       lkj_slopes(*f64(g, X3, Y3), 4),
                       lambda dt: jax_lkj_slopes(g, X3, Y3, 4, dt), 22),
        "ordinal_sorted": (ordinal_sorted(Xo, yo),
                           ordinal_sorted(*f64(Xo, yo)),
                           lambda dt: jax_ordinal_sorted(Xo, yo, dt), 7),
        "matrix_log_cov": (matrix_log_cov(Ym), matrix_log_cov(*f64(Ym)),
                           lambda dt: jax_matrix_log_cov(Ym, dt), 9),
        "lts_topk": (lts_topk(Xl, yl, 24), lts_topk(*f64(Xl, yl), 24),
                     lambda dt: jax_lts_topk(Xl, yl, 24, dt), 6),
    }


def _op_cases():
    idx, A, base = sred_data()
    out = {}
    for kinds, name in [([k], f"sred_{k[0]}_{'self' if k[1] else 'noself'}")
                        for k in SR_KINDS] + [(SR_KINDS, "sred_all")]:
        out[name] = (sred(idx, A, base, kinds),
                     sred(idx, A.astype(np.float64), base.astype(np.float64),
                          kinds),
                     (lambda k: lambda dt: jax_sred(idx, A, base, k, dt))(
                         kinds), SR_DIM)
    lin = np.linspace(-2.0, 2.0, 40).astype(F32).astype(np.float64)
    out["sort_bitonic"] = (sort_bitonic(lin.astype(F32)), sort_bitonic(lin),
                           lambda dt: jax_sort_bitonic(lin, dt), 40)
    M = (2.0 * np.eye(3) + 0.2).astype(F32)
    out["eigvalsh"] = (eigvalsh(M), eigvalsh(M.astype(np.float64)),
                       lambda dt: jax_eigvalsh(M, dt), 3)
    out["chain_index"] = (chain_index(W4, M34),
                          chain_index(W4.astype(np.float64),
                                      M34.astype(np.float64)),
                          lambda dt: jax_chain_index(W4, M34, dt), 7)
    return out


S_CASES = _s_cases()
CASES = {**S_CASES, **_op_cases()}
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
    """Tie-free positions of a case (S5's and the per-chain index's are
    distinct by construction of a continuous draw)."""
    dim = CASES[name][3]
    rng = np.random.default_rng(seed)
    q = scale * rng.standard_normal((dim, chains))
    if name in ("gp_se64", "gp_se64_logdet"):
        q[2] -= 1.0  # log sigma near its prior mean
    return q


def _assert_rel(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


# Limits of the plain back end (run in float64) against float64 autograd
# and jax.vjp: 1e-10 relative to the largest value, but S3's IR holds the
# constants torch.distributions computes as Python floats (LKJ's 0.5 (K -
# 1) log pi and its normaliser, the Jacobian's log 2, Normal's 0.5 log 2
# pi) rounded to float32, as the card holds them: 6e-8 relative, 1e-7.
FLOAT64_RTOL = {"lkj_slopes": 1e-7}
# Limits of the emitted functor (float32) against its plain back end: 1e-5
# of the largest value; S4's likelihood is the log of differences of
# sigmoids near each other (p ~ 1e-2), where torch's CPU sigmoid and
# CUDA's 1/(1 + expf(-x)) a few ulp apart become 1e-5 of p and its
# gradient 1/p: 1e-4.
EMITTED_RTOL = {"ordinal_sorted": 1e-4}


# ---------------------------------------------------- the plain back end --

@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_back_end_matches_autograd_and_jax_vjp(name):
    _, lp64, jax_lp, dim = CASES[name]
    pot, rows, bound, operands = _bound(name)
    q_t = _positions(name, 5, 0)
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
    _assert_rel(u.numpy().reshape(-1), -np.asarray(u_j), rtol)
    _assert_rel(g.numpy(), -np.asarray(g_j).T, rtol)


# the emitted functor: every case once, the scatter_reduce variants in one
# functor (sred_all) rather than a compile each
EMITTED_CASES = sorted(n for n in CASES
                       if not n.startswith("sred_") or n == "sred_all")


@pytest.mark.parametrize("name", EMITTED_CASES)
def test_emitted_functor_computes_its_plain_version(name, tmp_path):
    from tests.test_torch_generic_pg import _emulate

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emitted functor for the CPU")
    _, _, bound, operands = _bound(name)
    q = _positions(name, 4, 11).T.astype(F32)
    u, g = generic_pg.run_plain(bound.ir, torch.tensor(q.T), operands)
    ue, ge = _emulate(bound.source, operands, q, tmp_path)
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


def _streams(rng, chains, dim, max_exp):
    p = rng.normal(size=(chains, dim)).astype(F32)
    dirs = np.where(rng.uniform(size=(chains, max_exp)) < 0.5, -1.0, 1.0)
    ub = rng.uniform(size=(chains, max_exp)).astype(F32)
    ul = rng.uniform(size=(chains, 2**max_exp)).astype(F32)
    return p, dirs.astype(F32), ub, ul


def _start(name, seed):
    """Kernel inputs: tie-free positions ``(chains, dim)`` and the plain
    back end's potential and gradient there."""
    _, _, bound, operands = _bound(name)

    def pg(q_t, *_data):
        return generic_pg.run_plain(bound.ir, q_t, operands)

    q = _positions(name, CHAINS, seed).T.astype(F32)
    u, g_t = pg(torch.tensor(q).T.contiguous())
    return pg, q, u, g_t


# The floats the kernels return, the port's against JAX's, both float32,
# from one state and one set of random numbers: 1e-5 relative and
# absolute (a few ulp of the energies and gradients, which the two
# packages' sum orders and factorisations leave), every decision equal.
TOL = dict(rtol=1e-5, atol=1e-5)
Q_ATOL = 1e-5


def _moved(q_new, q_old):
    return np.any(np.asarray(q_new) != np.asarray(q_old), axis=-1)


def _assert_agree(port, jax_out, q0, tol):
    """Decisions equal (q moved, stats rows 2-4), q within Q_ATOL, the
    other floats within ``tol``; ``(q, u, g, p or None, stats)``."""
    qp, qj = np.asarray(port[0]), np.asarray(jax_out[0])
    np.testing.assert_array_equal(_moved(qp, q0), _moved(qj, q0))
    sp, sj = np.asarray(port[4]), np.asarray(jax_out[4])
    np.testing.assert_array_equal(sp[..., 2:5], sj[..., 2:5])
    np.testing.assert_allclose(sp[..., :2], sj[..., :2], **tol)
    np.testing.assert_allclose(qp, qj, rtol=0, atol=Q_ATOL)
    for a, b in zip(port[1:4], jax_out[1:4]):
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("name", sorted(S_CASES))
def test_kernel_1_plain_matches_jax_interpret(name):
    eps, max_exp = 0.05, 3
    pg, q, u0, g0 = _start(name, 1)
    dim = q.shape[1]
    rng = np.random.default_rng(2)
    p, dirs, ub, ul = _streams(rng, CHAINS, dim, max_exp)
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
    np.testing.assert_array_equal(out[3][:, 2:6], ref[3][:, 2:6])
    np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=Q_ATOL)
    for a, b in zip((out[1], out[2], out[3][:, 0]),
                    (ref[1], ref[2], ref[3][:, 0])):
        np.testing.assert_allclose(a, b, **TOL)
    assert (out[3][:, 3] > 1).any()  # trees of more than one leaf


@pytest.mark.parametrize("name", sorted(S_CASES))
def test_kernel_5_plain_matches_jax_interpret(name):
    pg, q, u, g_t = _start(name, 5)
    dim = q.shape[1]
    rng = np.random.default_rng(6)
    p = rng.normal(size=(CHAINS, dim)).astype(F32)
    noise = rng.normal(size=(CHAINS, dim)).astype(F32)
    ua = rng.uniform(size=CHAINS).astype(F32)
    imm = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    eps, alpha = 0.05, 0.8
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
    _assert_agree(port, jax_out, q, TOL)
    assert _moved(port[0], q).any()


@pytest.mark.parametrize("name", sorted(S_CASES))
def test_kernel_7_plain_matches_jax_interpret(name):
    pg, q, u, g_t = _start(name, 7)
    dim = q.shape[1]
    rng = np.random.default_rng(8)
    p = rng.normal(size=(CHAINS, dim)).astype(F32)
    ua = rng.uniform(size=CHAINS).astype(F32)
    im = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    eps = rng.uniform(0.02, 0.05, size=CHAINS).astype(F32)
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
    _assert_agree(reorder(port), reorder(jax_out), q, TOL)
    for a, b in zip(port[4:], jax_out[4:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=Q_ATOL)


# --------------------------------------------------------- the front door --

@pytest.mark.parametrize("name", ["gp_se64", "ordinal_sorted"])
def test_front_door_runs_on_the_fused_path(name):
    """S1 and S4 through the fused NUTS door on a bare logprob: finite
    draws, two runs with one seed equal bit for bit."""
    lp, _, _, dim = CASES[name]
    q0 = torch.tensor(_positions(name, 8, 3).T, dtype=torch.float32)

    def run():
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(4), lp, q0, 6, 6,
            algorithm="nuts", path="fused", max_num_expansions=3)

    a, b = run(), run()
    assert a.positions.shape == (6, 8, dim)
    assert torch.isfinite(a.positions).all()
    assert torch.equal(a.positions, b.positions)


@pytest.mark.parametrize("algorithm", ["nuts", "mala", "ghmc", "chees",
                                       "meads"])
def test_every_fused_algorithm_binds_the_eigendecomposition(algorithm):
    """S5 (``eigh``) through each fused front door on a bare logprob:
    bound, finite draws."""
    lp, _, _, dim = CASES["matrix_log_cov"]
    q0 = torch.tensor(_positions("matrix_log_cov", 8, 5).T,
                      dtype=torch.float32)
    res = aehmc_tpu_torch.sample(torch.Generator().manual_seed(6), lp, q0, 6,
                                 6, algorithm=algorithm, path="fused")
    assert res.positions.shape == (6, 8, dim)
    assert torch.isfinite(res.positions).all()


# --------------------------------------- rules that both packages keep ---

def test_a_factor_that_is_not_positive_definite_is_nan_and_divergent():
    """S1 at alpha e^6, rho e^4, sigma e^-20: K is numerically singular and
    its float32 Cholesky meets a pivot that is not positive.  Both
    packages' factors are NaN (the port's over the whole factor, never
    raising), so is the potential, and a kernel-1 step that lands there is
    divergent in both and leaves the chain where it was."""
    name = "gp_se64"
    _, _, bound, operands = _bound(name)
    bad = np.array([6.0, 4.0, -20.0])
    u, g = generic_pg.run_plain(bound.ir, torch.tensor(bad[:, None],
                                                       dtype=torch.float32),
                                operands)
    assert torch.isnan(u).all()
    jax_lp = CASES[name][2](jnp.float32)
    assert np.isnan(float(jax_lp(jnp.asarray(bad, jnp.float32))))
    node = next(i for i, n in enumerate(bound.ir.nodes) if n.op == "chol")
    K = torch.ones(1, 12, 12).add_(torch.eye(12) * 1e-9).unsqueeze(-1)
    L = generic_pg._plain_node(bound.ir.nodes[node], [K - 1.0],
                               torch.float32, torch.device("cpu"))
    assert torch.isnan(L).all()  # the whole factor
    # kernel 1 from finite starts; the momentum carries chains 0-3 there
    pg, q, u0, g0 = _start(name, 9)
    p = np.zeros((CHAINS, 3), F32)
    p[:4] = (bad - q[:4]) / 1.0
    rng = np.random.default_rng(10)
    _, dirs, ub, ul = _streams(rng, CHAINS, 3, 2)
    dirs[:] = 1.0
    im = np.ones(3, F32)
    out = nuts_transition_plain(
        torch.tensor(q.T), u0, g0, torch.tensor(im), 1.0, pg, max_exp=2,
        momentum=torch.tensor(p.T.copy()),
        directions=torch.tensor(dirs.T.copy()),
        u_bias=torch.tensor(ub.T.copy()), u_leaf=torch.tensor(ul.T.copy()))
    out = [o.numpy().T for o in out]
    jax_pot, jax_rows = _jax_twin(name)
    ref = [np.asarray(o) for o in jax_transition(
        jax_pot, jax_rows, max_num_expansions=2, block_chains=CHAINS,
        interpret=True)(
        jnp.asarray(q), jnp.asarray(u0.numpy().reshape(-1, 1)),
        jnp.asarray(g0.numpy().T), jnp.asarray(p), jnp.asarray(dirs),
        jnp.asarray(ub), jnp.asarray(ul), jnp.asarray(im),
        jnp.asarray(1.0, jnp.float32))]
    for o in (out, ref):
        assert (o[3][:4, 4] == 1.0).all()  # divergent
        np.testing.assert_array_equal(o[0][:4], q[:4])
        assert np.isfinite(o[0]).all()
    np.testing.assert_array_equal(out[3][:, 2:6], ref[3][:, 2:6])


def test_a_mask_that_depends_on_q_is_refused_by_both_packages():
    """``x[q > 0]`` has a shape that depends on the values: JAX raises
    NonConcreteBooleanIndexError, the port NotImplementedError saying that
    neither package takes it (not a gap of its op table)."""
    def lp(q):
        return -0.5 * torch.sum(q[q > 0] ** 2)

    pot, rows = _generic_fused_binding(lp, 4)
    with pytest.raises(NotImplementedError, match="neither package") as err:
        generic_pg.bind(pot, rows, 4)
    assert "1.10c" not in str(err.value)
    with pytest.raises(jax.errors.NonConcreteBooleanIndexError):
        jax_binding(lambda q: -0.5 * jnp.sum(q[q > 0] ** 2), 4)


@pytest.mark.parametrize("validate", [True, False])
def test_distributions_bind_with_validation_off_and_the_setting_restored(
        validate):
    """S3, written with torch.distributions, binds whatever the caller's
    validation setting, which is the same afterwards."""
    before = dist.Distribution._validate_args
    try:
        dist.Distribution.set_default_validate_args(validate)
        g, X3, Y3 = lkj_data(3, 4, 24, seed=2)
        pot, rows = _generic_fused_binding(lkj_slopes(g, X3, Y3, 4), 22)
        assert dist.Distribution._validate_args is validate
        generic_pg.bind(pot, rows, 22)
        assert dist.Distribution._validate_args is validate
    finally:
        dist.Distribution.set_default_validate_args(before)


# ------------------------------------------ what the host folds and keeps --

def test_a_value_of_the_data_alone_is_folded_and_rebuilt():
    """A Cholesky factor of a data covariance is a derived float row
    (float64 on the host, rounded once), evaluated again when the data
    change; the card's IR holds no factorisation."""
    S = torch.tensor([[2.0, 0.3, 0.1], [0.3, 1.5, 0.2], [0.1, 0.2, 1.0]])

    def lp(q):
        L = torch.linalg.cholesky(S)
        z = torch.linalg.solve_triangular(L, q[:, None], upper=False)
        return -0.5 * torch.sum(z * z) - torch.log(torch.diagonal(L)).sum()

    pot, rows = _generic_fused_binding(lp, 3)
    bound = generic_pg.bind(pot, rows, 3)
    assert "chol" not in {n.op for n in bound.ir.nodes}
    assert "f" in bound.ir.data_kinds[bound.ir.num_base_data:]
    q = torch.randn(3, 4, generator=torch.Generator().manual_seed(1))
    for _ in range(2):
        ops = bound.operands(rows, "cpu")
        L64 = torch.linalg.cholesky(S.double())
        np.testing.assert_array_equal(ops[-1].numpy(), L64.float().numpy())
        u, _ = generic_pg.run_plain(bound.ir, q, ops)
        np.testing.assert_allclose(u.reshape(-1).numpy(),
                                   pot(q, *rows).numpy(), rtol=1e-6)
        S[0, 0] = 3.0  # in place: the next launch's row is rebuilt


def test_a_reducing_product_binds_in_a_potential_and_grad():
    """``scatter_reduce(reduce="prod")``: torch's own backward reads a value
    on the host (a check for several zeros), so no trace of its gradient
    exists; a potential_and_grad_t that writes its gradient binds, and its
    emitted functor computes its plain version."""
    from tests.test_torch_generic_pg import _emulate

    idx, A, base = sred_data()
    it, At, bt = (torch.as_tensor(a) for a in (idx, A, base))

    def pg(q_t):
        s = At @ q_t  # (40, C), away from 0
        out = bt[:, None].expand(-1, s.shape[1]).scatter_reduce(
            0, it[:, None].expand_as(s), s, reduce="prod")
        g_s = -(out * out)[it] / s
        return 0.5 * torch.sum(out * out, 0), At.T @ g_s

    traced = generic_pg.trace_potential(pg, (), SR_DIM, with_grad=False)
    assert "scatter_reduce" in {n.op for n in traced.ir.nodes}
    rng = np.random.default_rng(12)
    q = (0.2 * rng.standard_normal((SR_DIM, 3))).astype(F32)
    u, g = generic_pg.run_plain(traced.ir, torch.tensor(q),
                                traced.constants)
    u_ref, g_ref = pg(torch.tensor(q))
    _assert_rel(u.numpy().reshape(-1), u_ref.numpy(), 1e-6)
    _assert_rel(g.numpy(), g_ref.numpy(), 1e-6)
    if shutil.which("g++") is not None:
        import pathlib
        import tempfile

        with tempfile.TemporaryDirectory() as d:
            ue, ge = _emulate(generic_pg.emit_cuda(traced.ir),
                              generic_pg.all_operands(traced.ir,
                                                      traced.constants),
                              q.T, pathlib.Path(d))
        _assert_rel(ue, u.numpy().reshape(-1), 1e-5)
        _assert_rel(ge, g.numpy().T, 1e-5)


def test_a_per_chain_index_out_of_range_wraps_then_clamps(monkeypatch):
    """A per-chain index past its axis is clamped (JAX's gather), a
    negative one wrapped first, where torch raises: the functor's rule,
    traced at q = 0 (indices in range) and evaluated where they are not
    (the check that chains stay apart, which runs torch itself on random
    positions, is switched off for it)."""
    w = torch.tensor([1.0, 2.0, 3.0, 4.0])

    def lp(q):
        k = torch.argmax(q[:4], dim=0, keepdim=True)
        return torch.sum(w[k + 3] + w[-2 * k - 1]) * q[0]

    monkeypatch.setattr(generic_pg, "_check_chains_apart", lambda *a: None)
    pot, rows = _generic_fused_binding(lp, 4)
    bound = generic_pg.bind(pot, rows, 4)
    q = torch.tensor([[0.5, 3.0, 1.0, 0.0], [0.5, 0.0, 1.0, 3.0]]).T
    u, _ = generic_pg.run_plain(bound.ir, q, bound.operands(rows, "cpu"))
    # k 1: w[4 -> 3] + w[-3 -> 1]; k 3: w[6 -> 3] + w[-7 -> -3 -> 0]
    assert u.reshape(-1).tolist() == [-(4.0 + 2.0) * 0.5, -(4.0 + 1.0) * 0.5]
    wj = jnp.asarray(w.numpy())

    def jax_lp(q):
        k = jnp.argmax(q[:4])
        return (wj[k + 3] + wj[-2 * k - 1]) * q[0]

    u_j = -jax.vmap(jax_lp)(jnp.asarray(q.numpy().T))
    np.testing.assert_array_equal(np.asarray(u_j), u.reshape(-1).numpy())
