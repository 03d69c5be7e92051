"""The potential compiler's op table (families A-D and the scans) on the
CPU, beyond the per-case checks of ``test_torch_generic_pg.py``.

- The four test potentials, plain torch logprobs with a ``jnp`` twin here,
  data made from a seed with numpy: P1 ``mvn25_chol``
  (``models.correlated_mvn(25, 0.5)`` as a bare logprob), P2
  ``hier_negbin`` (a varying-intercept negative-binomial regression,
  non-centred, at the radon study's sizes: 919 observations in 85
  counties, dim 89), P3 ``mixture4`` (four Gaussian components in 2-d,
  softmax weights, dim 12) and P4 ``probit100`` (probit regression on the
  flagship's ``logistic_regression_data`` design through ``log_ndtr``);
  and the three of the rest of the table, written as users write them: R1
  ``softmax_reg`` (multinomial logistic regression, labels 1..K,
  ``max(dim=1)``, ``[arange(N), y - 1]``), R2 ``weibull_mice`` (Weibull
  regression with right censoring after BUGS "Mice": ``isnan``, bool
  masks, an indexed assignment, a tensor exponent) and R3 ``sur_solve`` (a
  seemingly-unrelated regression through ``torch.linalg.solve`` of a
  matrix that depends on q).  ``chip_smoke.py`` keeps its own copy of the
  torch ones.
- Kernels 1, 5 and 7, through their plain versions with the generated
  functor's plain back end as the potential, against the JAX kernels in
  interpret mode on the twins, on external randomness: P1, P2 and R1-R3
  (small sizes), every decision equal, floats within 1e-5.
- The front door on ``models.correlated_mvn(4, 0.5)`` on ``path="fused"``
  for nuts, mala, ghmc, chees and meads: finite draws, two runs with one
  seed equal bit for bit, and the binding's potential and gradient equal to
  the JAX package's binding of the JAX model within 1e-5.
- Index data: an index outside its axis raises ``IndexError`` at bind and
  at a launch's operands; changed index values are read anew (never a stale
  int32 row); each device keeps its own row; int64 counts beside int64
  indices.
- A scatter-add sums in input order: the emitted functor's gradient of a
  pure gather equals the plain back end's bit for bit.
- Derived index rows: a data mask is read anew when the data change, and a
  mask of another count raises; a writing scatter with a duplicate index
  and an index out of range after arithmetic raise at bind; integer
  arithmetic and masks that depend on q stay refused; ``max(dim=)`` sends
  a tie's gradient to the first maximum, as torch does.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln, log_ndtr

import aehmc_tpu.models as jax_models
from aehmc_tpu.api import _generic_fused_binding as jax_binding
from aehmc_tpu.ops import chees_fused as jax_cf
from aehmc_tpu.ops import ghmc_fused as jax_ghmc
from aehmc_tpu.ops.nuts_fused_small import (
    make_fused_nuts_transition_small as jax_transition,
)
import aehmc_tpu_torch
from aehmc_tpu_torch.api import _generic_fused_binding
from aehmc_tpu_torch.models import correlated_mvn, logistic_regression_data
from aehmc_tpu_torch.ops import chees_fused, generic_pg, ghmc_fused
from aehmc_tpu_torch.ops.nuts_fused_small import nuts_transition_plain

F32 = np.float32


# ------------------------------------------------------- the potentials ---

def negbin_data(num_obs=919, num_groups=85, seed=0):
    """Counts of a varying-intercept negative-binomial regression: county
    of each observation (int64), a covariate (float32), counts (int64)."""
    rng = np.random.default_rng(seed)
    group = rng.integers(0, num_groups, num_obs)
    x = rng.standard_normal(num_obs).astype(F32)
    z = rng.standard_normal(num_groups)
    eta = 1.0 + 0.5 * z[group] + 0.4 * x
    phi = 5.0
    y = rng.negative_binomial(phi, phi / (phi + np.exp(eta)))
    return group.astype(np.int64), x, y.astype(np.int64)


def hier_negbin(group, x, y, num_groups, device="cpu", log_phi_prior=(1.0,
                                                                      1.0)):
    """log p of (z (G), mu, log_sd, b, log_phi): the county intercepts are
    mu + exp(log_sd) z, gathered by county; NB(y | exp(eta), phi) without
    its constant lgamma(y + 1).  log_phi ~ N(1, 1) keeps phi moderate: near
    phi = 1e6 lgamma(y + phi) - lgamma(phi) is float32 rounding noise
    (``log_phi_prior``: its mean and sd; fault G's runs take (0, 2))."""
    phi_mean, phi_sd = log_phi_prior
    g = torch.as_tensor(group, device=device)
    xt = torch.as_tensor(x, device=device)
    yt = torch.as_tensor(y, device=device)
    G = num_groups

    def logprob_fn(q):
        z, mu, log_sd, b, log_phi = q[:G], q[G], q[G + 1], q[G + 2], q[G + 3]
        phi = torch.exp(log_phi)
        eta = mu + torch.exp(log_sd) * z[g] + b * xt
        log_denom = torch.logaddexp(log_phi, eta)
        ll = torch.sum(torch.lgamma(yt + phi) - torch.lgamma(phi)
                       + phi * (log_phi - log_denom)
                       + yt * (eta - log_denom))
        return ll - 0.5 * torch.sum(z * z) - 0.5 * (mu / 5.0) ** 2 \
            - 0.5 * log_sd ** 2 - 0.5 * (b / 2.0) ** 2 \
            - 0.5 * ((log_phi - phi_mean) / phi_sd) ** 2

    return logprob_fn


def jax_hier_negbin(group, x, y, num_groups, dtype=jnp.float64,
                    log_phi_prior=(1.0, 1.0)):
    G = num_groups
    phi_mean, phi_sd = log_phi_prior
    xj, yj = jnp.asarray(x, dtype), jnp.asarray(y)

    def logprob_fn(q):
        z, mu, log_sd, b, log_phi = q[:G], q[G], q[G + 1], q[G + 2], q[G + 3]
        phi = jnp.exp(log_phi)
        eta = mu + jnp.exp(log_sd) * z[group] + b * xj
        log_denom = jnp.logaddexp(log_phi, eta)
        ll = jnp.sum(gammaln(yj + phi) - gammaln(phi)
                     + phi * (log_phi - log_denom) + yj * (eta - log_denom))
        return ll - 0.5 * jnp.sum(z * z) - 0.5 * (mu / 5.0) ** 2 \
            - 0.5 * log_sd ** 2 - 0.5 * (b / 2.0) ** 2 \
            - 0.5 * ((log_phi - phi_mean) / phi_sd) ** 2

    return logprob_fn


def mixture_data(num_points=1000, seed=0):
    rng = np.random.default_rng(seed)
    centers = 2.5 * np.array([[-1, -1], [1, -1], [-1, 1], [1, 1]], float)
    labels = rng.choice(4, num_points, p=[0.1, 0.2, 0.3, 0.4])
    return (centers[labels] + rng.standard_normal((num_points, 2))).astype(F32)


def mixture4(points, device="cpu"):
    """Four unit-variance Gaussians in 2-d, weights a softmax of logits:
    q = 8 means then 4 logits."""
    P = torch.as_tensor(points, device=device)

    def logprob_fn(q):
        mus, logits = q[:8].reshape(4, 2), q[8:12]
        d = P[:, None, :] - mus[None, :, :]
        ll = torch.logsumexp(torch.log_softmax(logits, 0)
                             - 0.5 * torch.sum(d * d, -1), 1)
        return torch.sum(ll) - 0.5 * torch.sum(mus * mus) / 9.0 \
            - 0.5 * torch.sum(logits * logits)

    return logprob_fn


def jax_mixture4(points):
    P = jnp.asarray(points, jnp.float64)

    def logprob_fn(q):
        mus, logits = q[:8].reshape(4, 2), q[8:12]
        d = P[:, None, :] - mus[None, :, :]
        ll = jax.nn.logsumexp(jax.nn.log_softmax(logits, 0)
                              - 0.5 * jnp.sum(d * d, -1), 1)
        return jnp.sum(ll) - 0.5 * jnp.sum(mus * mus) / 9.0 \
            - 0.5 * jnp.sum(logits * logits)

    return logprob_fn


def probit(X, y):
    """Probit regression, N(0, 1) prior: y log Phi(Xq) + (1 - y) log
    Phi(-Xq)."""

    def logprob_fn(q):
        z = X @ q
        return torch.sum(y * torch.special.log_ndtr(z)
                         + (1.0 - y) * torch.special.log_ndtr(-z)) \
            - 0.5 * torch.sum(q * q)

    return logprob_fn


def jax_probit(X, y):
    Xj, yj = jnp.asarray(X.numpy(), jnp.float64), jnp.asarray(y.numpy(),
                                                              jnp.float64)

    def logprob_fn(q):
        z = Xj @ q
        return jnp.sum(yj * log_ndtr(z) + (1.0 - yj) * log_ndtr(-z)) \
            - 0.5 * jnp.sum(q * q)

    return logprob_fn


def softmax_data(num_points=1000, num_features=20, num_classes=5, seed=0):
    """R1's design (float32) and labels 1..K (int64, as R and Stan hold
    them), drawn from a multinomial logit with N(0, 1) weights."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((num_points, num_features)).astype(F32)
    W = rng.standard_normal((num_features, num_classes))
    logits = X @ W / np.sqrt(num_features)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    u = rng.uniform(size=(num_points, 1))
    y = 1 + np.minimum((u > np.cumsum(p, 1)).sum(1), num_classes - 1)
    return X, y.astype(np.int64)


def softmax_reg(X, y, num_classes, device="cpu"):
    """R1: multinomial logistic regression, W (features, classes) from q,
    N(0, 1) prior, the log-sum-exp by hand after the row maximum, the
    log-likelihood read at ``[arange(N), y - 1]``."""
    Xt = torch.as_tensor(X, device=device)
    yt = torch.as_tensor(y, device=device)
    N, P = Xt.shape

    def logprob_fn(q):
        logits = Xt @ q.reshape(P, num_classes)
        m = logits.max(dim=1, keepdim=True).values
        lse = m + torch.log(torch.sum(torch.exp(logits - m), dim=1,
                                      keepdim=True))
        ll = (logits - lse)[torch.arange(N, device=device), yt - 1].sum()
        return ll - 0.5 * torch.sum(q * q)

    return logprob_fn


def jax_softmax_reg(X, y, num_classes, dtype=jnp.float64):
    Xj, yj = jnp.asarray(X, dtype), jnp.asarray(y)
    N, P = X.shape

    def logprob_fn(q):
        logits = Xj @ q.reshape(P, num_classes)
        m = jnp.max(logits, axis=1, keepdims=True)
        lse = m + jnp.log(jnp.sum(jnp.exp(logits - m), axis=1,
                                  keepdims=True))
        ll = (logits - lse)[jnp.arange(N), yj - 1].sum()
        return ll - 0.5 * jnp.sum(q * q)

    return logprob_fn


def weibull_data(num_groups=4, per_group=20, seed=0):
    """R2's mice (after BUGS Examples Vol. 1, "Mice"): group (int64),
    failure times (float32, NaN where censored) and censoring times, from
    S(t) = exp(-exp(beta_g) t^r), r 1.5."""
    rng = np.random.default_rng(seed)
    group = np.repeat(np.arange(num_groups), per_group)
    beta = rng.normal(-4.0, 0.5, num_groups)
    r = 1.5
    t = (-np.log(rng.uniform(size=group.size)) / np.exp(beta[group])) ** (
        1.0 / r)
    c = rng.uniform(10.0, 30.0, group.size)
    t = np.where(t > c, np.nan, t)
    return group.astype(np.int64), t.astype(F32), c.astype(F32)


def weibull_mice(group, t, c, num_groups, device="cpu"):
    """R2: Weibull regression with right censoring, q = (beta (G), log r);
    ``obs = ~isnan(t)``, an indexed assignment of each mouse's term,
    N(0, 10) priors on beta, N(0, 1) on log r."""
    g, tt, ct = (torch.as_tensor(a, device=device) for a in (group, t, c))
    G, M = num_groups, len(group)

    def logprob_fn(q):
        beta, log_r = q[:G], q[G]
        r = torch.exp(log_r)
        obs = ~torch.isnan(tt)
        ll = torch.zeros(M, dtype=q.dtype, device=device)
        ll[obs] = log_r + (r - 1.0) * torch.log(tt[obs]) + beta[g[obs]] \
            - torch.exp(beta[g[obs]]) * tt[obs] ** r
        ll[~obs] = -torch.exp(beta[g[~obs]]) * ct[~obs] ** r
        return ll.sum() - 0.5 * torch.sum((beta / 10.0) ** 2) \
            - 0.5 * log_r ** 2

    return logprob_fn


def jax_weibull_mice(group, t, c, num_groups, dtype=jnp.float64):
    tj, cj = jnp.asarray(t, dtype), jnp.asarray(c, dtype)
    G = num_groups

    def logprob_fn(q):
        beta, log_r = q[:G], q[G]
        r = jnp.exp(log_r)
        obs = ~jnp.isnan(tj)
        ts = jnp.where(obs, tj, 1.0)
        b = beta[group]
        ll = jnp.where(obs, log_r + (r - 1.0) * jnp.log(ts) + b
                       - jnp.exp(b) * ts ** r, -jnp.exp(b) * cj ** r)
        return ll.sum() - 0.5 * jnp.sum((beta / 10.0) ** 2) \
            - 0.5 * log_r ** 2

    return logprob_fn


def sur_data(num_eq=10, num_obs=200, num_reg=5, seed=0):
    """R3's seemingly-unrelated regression: X (N, K, p), Y (N, K) float32,
    and the fixed correlation Omega (K, K), from the model's own draws."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((num_eq, num_eq))
    S = A @ A.T + num_eq * np.eye(num_eq)
    d = 1.0 / np.sqrt(np.diag(S))
    omega = S * d[:, None] * d[None, :]
    X = rng.standard_normal((num_obs, num_eq, num_reg))
    beta = rng.standard_normal((num_eq, num_reg))
    tau = np.exp(rng.normal(0.0, 0.3, num_eq))
    sigma = tau[:, None] * tau[None, :] * omega
    eps = rng.standard_normal((num_obs, num_eq)) @ np.linalg.cholesky(
        sigma).T
    Y = (X * beta).sum(-1) + eps
    return X.astype(F32), Y.astype(F32), omega.astype(F32)


def sur_solve(X, Y, omega, device="cpu"):
    """R3: q = (beta (K, p), log tau (K)), Sigma = tau tau^T * Omega, the
    Gaussian log-likelihood through a general solve, N(0, 1) priors."""
    Xt, Yt, Om = (torch.as_tensor(a, device=device) for a in (X, Y, omega))
    N, K, P = Xt.shape

    def logprob_fn(q):
        beta, log_tau = q[:K * P].reshape(K, P), q[K * P:]
        tau = torch.exp(log_tau)
        Sigma = tau[:, None] * tau[None, :] * Om
        R = Yt - torch.sum(Xt * beta, -1)
        return -0.5 * (R.T * torch.linalg.solve(Sigma, R.T)).sum() \
            - N * log_tau.sum() - 0.5 * torch.sum(q * q)

    return logprob_fn


def jax_sur_solve(X, Y, omega, dtype=jnp.float64):
    Xj, Yj, Om = (jnp.asarray(a, dtype) for a in (X, Y, omega))
    N, K, P = X.shape

    def logprob_fn(q):
        beta, log_tau = q[:K * P].reshape(K, P), q[K * P:]
        tau = jnp.exp(log_tau)
        Sigma = tau[:, None] * tau[None, :] * Om
        R = Yj - jnp.sum(Xj * beta, -1)
        return -0.5 * (R.T * jnp.linalg.solve(Sigma, R.T)).sum() \
            - N * log_tau.sum() - 0.5 * jnp.sum(q * q)

    return logprob_fn


def mvn_rows_twin(rows):
    """The JAX twin of the binding of ``models.correlated_mvn``: its data
    rows (loc, the Cholesky factor, the normalising constant), told apart by
    their sizes."""
    by_size = {r.shape[1]: r for r in rows}
    dim = min(s for s in by_size if s > 1)

    def split(rs):
        by = {r.shape[1]: r for r in rs}
        return by[dim].reshape(dim), by[dim * dim].reshape(dim, dim), \
            by[1].reshape(())

    def jax_pot(q_t, *rs):
        loc, chol, const = split(rs)
        z = jax.scipy.linalg.solve_triangular(chol, q_t - loc[:, None],
                                              lower=True)
        return -(const - 0.5 * jnp.sum(z * z, axis=0))

    def reference(q_t):
        loc, chol, const = (t.double() for t in split(rows))
        z = torch.linalg.solve_triangular(chol, q_t - loc[:, None],
                                          upper=False)
        return -(const - 0.5 * torch.sum(z * z, dim=0))

    assert len(by_size) == 3
    return jax_pot, reference


def _bound_case(lp, jax_lp, dim, lp64=None):
    """A CASES entry of a bare logprob through the generic binding: the
    JAX twin and the float64 reference vmap their own logprobs."""
    pot, rows = _generic_fused_binding(lp, dim)

    def jax_pot(q_t, *_rows):
        return -jax.vmap(jax_lp, in_axes=1)(q_t)

    def reference(q_t):  # functionalized: vmap refuses in-place writes
        return -torch.func.vmap(torch.func.functionalize(lp64), in_dims=1)(q_t)

    return pot, tuple(rows), dim, "t", jax_pot, reference


def p1_case(dim=25):
    pot, rows = _generic_fused_binding(
        correlated_mvn(dim, 0.5, device="cpu"), dim)
    jax_pot, reference = mvn_rows_twin(rows)
    return pot, tuple(rows), dim, "t", jax_pot, reference


def p2_case(num_obs=40, num_groups=6):
    group, x, y = negbin_data(num_obs, num_groups, seed=1)
    lp64 = hier_negbin(group, x.astype(np.float64), y, num_groups)
    return _bound_case(hier_negbin(group, x, y, num_groups),
                       jax_hier_negbin(group, x, y, num_groups),
                       num_groups + 4, lp64)


def p3_case(num_points=50):
    pts = mixture_data(num_points, seed=2)
    return _bound_case(mixture4(pts), jax_mixture4(pts), 12,
                       mixture4(pts.astype(np.float64)))


def p4_case(dim=5, num_points=12):
    X, y = logistic_regression_data(dim, num_points, device="cpu")
    return _bound_case(probit(X, y), jax_probit(X, y), dim,
                       probit(X.double(), y.double()))


def r1_case(num_points=30, num_features=3, num_classes=4):
    X, y = softmax_data(num_points, num_features, num_classes, seed=3)
    return _bound_case(softmax_reg(X, y, num_classes),
                       jax_softmax_reg(X, y, num_classes),
                       num_features * num_classes,
                       softmax_reg(X.astype(np.float64), y, num_classes))


def r2_case(num_groups=2, per_group=6):
    group, t, c = weibull_data(num_groups, per_group, seed=4)
    return _bound_case(weibull_mice(group, t, c, num_groups),
                       jax_weibull_mice(group, t, c, num_groups),
                       num_groups + 1,
                       weibull_mice(group, t.astype(np.float64),
                                    c.astype(np.float64), num_groups))


def r3_case(num_eq=3, num_obs=12, num_reg=2):
    X, Y, omega = sur_data(num_eq, num_obs, num_reg, seed=5)
    return _bound_case(sur_solve(X, Y, omega), jax_sur_solve(X, Y, omega),
                       num_eq * (num_reg + 1),
                       sur_solve(*(a.astype(np.float64) for a in (X, Y,
                                                                  omega))))


CASES = {"mvn25_chol": p1_case, "hier_negbin": p2_case,
         "mixture4": p3_case, "probit100": p4_case,
         "softmax_reg": r1_case, "weibull_mice": r2_case,
         "sur_solve": r3_case}


def _traced(name):
    fn, data, dim, *_ = CASES[name]()
    traced = generic_pg.trace_potential(fn, data, dim)
    return fn, data, dim, traced, (*data, *traced.constants)


# ------------------------------------------ the full-width bindings bind --

@pytest.mark.parametrize("name", sorted(CASES))
def test_each_test_potential_binds_at_full_width(name):
    """P1 at dim 25, P2 at 919 observations in 85 counties, P3 over 1,000
    points, P4 on the 1,000 x 100 design, R1 over 1,000 points, 20
    features and 5 classes, R2 on 80 mice, R3 at 10 equations, 200
    observations and 5 regressors: bound, emitted, and the plain back end
    finite, its gradient equal to float32 autograd's."""
    if name == "mvn25_chol":
        lp, dim = correlated_mvn(25, 0.5, device="cpu"), 25
    elif name == "hier_negbin":
        group, x, y = negbin_data()
        lp, dim = hier_negbin(group, x, y, 85), 89
    elif name == "mixture4":
        lp, dim = mixture4(mixture_data()), 12
    elif name == "softmax_reg":
        lp, dim = softmax_reg(*softmax_data(), 5), 100
    elif name == "weibull_mice":
        lp, dim = weibull_mice(*weibull_data(), 4), 5
    elif name == "sur_solve":
        lp, dim = sur_solve(*sur_data()), 60
    else:
        X, y = logistic_regression_data(100, 1000, device="cpu")
        lp, dim = probit(X, y), 100
    pot, rows = _generic_fused_binding(lp, dim)
    bound = generic_pg.bind(pot, rows, dim)
    assert "struct GenericPG" in bound.source
    q = 0.1 * torch.randn(dim, 6, generator=torch.Generator().manual_seed(0))
    u, g = generic_pg.run_plain(bound.ir, q, bound.operands(rows, "cpu"))
    qr = q.clone().requires_grad_(True)
    u_ref = pot(qr, *rows)
    (g_ref,) = torch.autograd.grad(u_ref.sum(), qr)
    assert torch.isfinite(u).all() and torch.isfinite(g).all()
    np.testing.assert_allclose(u.reshape(-1).numpy(),
                               u_ref.detach().reshape(-1).numpy(),
                               rtol=1e-5, atol=1e-5 * float(
                                   u_ref.abs().max()))
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), rtol=1e-4,
                               atol=1e-4 * float(g_ref.abs().max()))


# ------------------------------------ kernels 1, 5 and 7 against the JAX ones

def _jax_twin(name, rows):
    """The JAX kernels' potential and data: P1's twin on the port's own
    rows; the JAX package's binding of P2's twin (float32 data)."""
    if name == "mvn25_chol":
        jax_pot, _ = mvn_rows_twin(rows)
        return jax_pot, [jnp.asarray(r.numpy()) for r in rows]
    if name == "hier_negbin":
        group, x, y = negbin_data(40, 6, seed=1)
        jax_lp, dim = jax_hier_negbin(group, x, y, 6, jnp.float32), 10
    elif name == "softmax_reg":
        X, y = softmax_data(30, 3, 4, seed=3)
        jax_lp, dim = jax_softmax_reg(X, y, 4, jnp.float32), 12
    elif name == "weibull_mice":
        group, t, c = weibull_data(2, 6, seed=4)
        jax_lp, dim = jax_weibull_mice(group, t, c, 2, jnp.float32), 3
    else:
        X, Y, omega = sur_data(3, 12, 2, seed=5)
        jax_lp, dim = jax_sur_solve(X, Y, omega, jnp.float32), 9
    jax_pot, jax_rows = jax_binding(jax_lp, dim)
    return jax_pot, list(jax_rows)


def _streams(rng, chains, dim, max_exp):
    p = rng.normal(size=(chains, dim)).astype(F32)
    dirs = np.where(rng.uniform(size=(chains, max_exp)) < 0.5, -1.0, 1.0)
    ub = rng.uniform(size=(chains, max_exp)).astype(F32)
    ul = rng.uniform(size=(chains, 2**max_exp)).astype(F32)
    return p, dirs.astype(F32), ub, ul


CHAINS = 8
TOL = dict(rtol=1e-5, atol=1e-5)
# P2's limits.  Its potential sums 40 lgamma values of size up to ~50 (ulp
# 4e-6), and its log-phi gradient row 40 terms of size ~10 that cancel to
# ~0.3: torch's and XLA's float32 lgamma/digamma a few ulp apart, and two
# sum orders, leave ~5e-5 in u, the energy and exp(-dH), and ~40 x 10 x
# 1e-7 x 3 = 1.2e-4 in that row; so P2's floats other than q are held to
# 1e-4 relative and 2e-4 absolute (q and every decision as P1's).
TOLS = {"mvn25_chol": TOL, "hier_negbin": dict(rtol=1e-4, atol=2e-4),
        "softmax_reg": TOL, "weibull_mice": TOL, "sur_solve": TOL}
KERNEL_CASES = ["mvn25_chol", "hier_negbin", "softmax_reg", "weibull_mice",
                "sur_solve"]


@pytest.mark.parametrize("name", KERNEL_CASES)
@pytest.mark.parametrize("eps, max_exp", [(0.2, 4), (0.05, 5)])
def test_generated_kernel_1_plain_matches_jax_interpret(name, eps, max_exp):
    fn, data, dim, traced, operands = _traced(name)
    rng = np.random.default_rng(int(eps * 100) + max_exp)
    q = (0.3 * rng.normal(size=(CHAINS, dim))).astype(F32)
    p, dirs, ub, ul = _streams(rng, CHAINS, dim, max_exp)
    im = np.full(dim, 0.8, F32)
    u0, g0 = generic_pg.run_plain(traced.ir, torch.tensor(q.T), operands)

    def pg(q_t):
        return generic_pg.run_plain(traced.ir, q_t, operands)

    out = nuts_transition_plain(
        torch.tensor(q.T), u0, g0, torch.tensor(im), eps, pg,
        max_exp=max_exp, momentum=torch.tensor(p.T.copy()),
        directions=torch.tensor(dirs.T.copy()),
        u_bias=torch.tensor(ub.T.copy()), u_leaf=torch.tensor(ul.T.copy()))
    out = [o.numpy().T for o in out]
    jax_pot, jax_rows = _jax_twin(name, data)
    jt = jax_transition(jax_pot, jax_rows, max_num_expansions=max_exp,
                        block_chains=CHAINS, interpret=True)
    ref = [np.asarray(o) for o in jt(
        jnp.asarray(q), jnp.asarray(u0.numpy().reshape(-1, 1)),
        jnp.asarray(g0.numpy().T), jnp.asarray(p), jnp.asarray(dirs),
        jnp.asarray(ub), jnp.asarray(ul), jnp.asarray(im),
        jnp.asarray(eps, jnp.float32))]
    np.testing.assert_array_equal(out[3][:, 2:6], ref[3][:, 2:6])
    np.testing.assert_allclose(out[0], ref[0], **TOL)
    for a, b in zip((out[1], out[2], out[3][:, 0]),
                    (ref[1], ref[2], ref[3][:, 0])):
        np.testing.assert_allclose(a, b, **TOLS[name])


def _hmc_start(name, seed):
    fn, data, dim, traced, operands = _traced(name)

    def pg(q_t, *_data):
        return generic_pg.run_plain(traced.ir, q_t, operands)

    rng = np.random.default_rng(seed)
    q = (0.3 * rng.normal(size=(CHAINS, dim))).astype(F32)
    u, g_t = pg(torch.tensor(q).T.contiguous())
    jax_pot, jax_rows = _jax_twin(name, data)
    return (pg, jax_pot, jax_rows, dim, rng, q, u.reshape(-1).numpy(),
            g_t.T.contiguous().numpy())


def _moved(q_new, q_old):
    return np.any(np.asarray(q_new) != np.asarray(q_old), axis=-1)


def _assert_agree(port, jax_out, q0, tol=TOL):
    """Decisions equal (q moved, stats rows 2-4), q and the other outputs
    within 1e-5; ``(q, u, g, p or None, stats)``."""
    qp, qj = np.asarray(port[0]), np.asarray(jax_out[0])
    np.testing.assert_array_equal(_moved(qp, q0), _moved(qj, q0))
    sp, sj = np.asarray(port[4]), np.asarray(jax_out[4])
    np.testing.assert_array_equal(sp[..., 2:5], sj[..., 2:5])
    np.testing.assert_allclose(sp[..., :2], sj[..., :2], **tol)
    np.testing.assert_allclose(qp, qj, rtol=0, atol=1e-5)
    for a, b in zip(port[1:4], jax_out[1:4]):
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_generated_kernel_5_plain_matches_jax_interpret(name):
    pg, jax_pot, jax_rows, dim, rng, q, u, g = _hmc_start(name, 5)
    p = rng.normal(size=(CHAINS, dim)).astype(F32)
    noise = rng.normal(size=(CHAINS, dim)).astype(F32)
    ua = rng.uniform(size=CHAINS).astype(F32)
    imm = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    eps, alpha = 0.1, 0.8
    port = ghmc_fused.make_fused_ghmc_transition(
        None, (), potential_and_grad_t=pg)(
        torch.tensor(q), torch.tensor(u), torch.tensor(g), torch.tensor(p),
        eps, alpha, torch.tensor(imm), noise=torch.tensor(noise),
        u_accept=torch.tensor(ua))
    jax_out = jax_ghmc.make_fused_ghmc_transition(
        jax_pot, jax_rows, block_chains=CHAINS, interpret=True)(
        jnp.asarray(q), jnp.asarray(u), jnp.asarray(g), jnp.asarray(p), eps,
        alpha, jnp.asarray(imm), noise=jnp.asarray(noise),
        u_accept=jnp.asarray(ua))
    _assert_agree(port, jax_out, q, TOLS[name])
    assert _moved(port[0], q).any()


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_generated_kernel_7_plain_matches_jax_interpret(name):
    pg, jax_pot, jax_rows, dim, rng, q, u, g = _hmc_start(name, 7)
    p = rng.normal(size=(CHAINS, dim)).astype(F32)
    ua = rng.uniform(size=CHAINS).astype(F32)
    im = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    eps = rng.uniform(0.05, 0.15, size=CHAINS).astype(F32)
    steps = 3
    port = chees_fused.make_fused_chees_transition(
        None, (), potential_and_grad_t=pg)(
        torch.tensor(q), torch.tensor(u), torch.tensor(g), torch.tensor(p),
        torch.tensor(ua), torch.tensor(im), torch.tensor(eps), steps)
    jax_out = jax_cf.make_fused_chees_transition(
        jax_pot, jax_rows, block_chains=CHAINS, interpret=True)(
        jnp.asarray(q), jnp.asarray(u), jnp.asarray(g), jnp.asarray(p),
        jnp.asarray(ua), jnp.asarray(im), jnp.asarray(eps),
        jnp.asarray(steps, jnp.int32))
    reorder = (lambda o: (o[0], o[1], o[2], None, o[3]))
    _assert_agree(reorder(port), reorder(jax_out), q, TOLS[name])
    for a, b in zip(port[4:], jax_out[4:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=1e-5)


# --------------------------------------------------------- the front door --

@pytest.mark.parametrize("algorithm", ["nuts", "mala", "ghmc", "chees",
                                       "meads"])
def test_front_door_runs_the_package_mvn_on_the_fused_path(algorithm):
    lp = correlated_mvn(4, 0.5, device="cpu")
    q0 = 0.3 * torch.randn(16, 4, generator=torch.Generator().manual_seed(1))

    def run():
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(3), lp, q0, 20, 20,
            algorithm=algorithm, path="fused")

    a, b = run(), run()
    assert a.positions.shape == (20, 16, 4)
    assert torch.isfinite(a.positions).all()
    assert torch.equal(a.positions, b.positions)


def test_the_mvn_binding_equals_jax():
    """The port's binding of ``models.correlated_mvn(4, 0.5)`` and the JAX
    package's of its own: potential and gradient within 1e-5 on the same
    positions."""
    pot, rows = _generic_fused_binding(correlated_mvn(4, 0.5, device="cpu"),
                                       4)
    jax_pot, jax_rows = jax_binding(
        jax_models.correlated_mvn(4, 0.5, jnp.float32), 4)
    q_t = (0.7 * np.random.default_rng(9).standard_normal((4, 6))).astype(F32)
    bound = generic_pg.bind(pot, rows, 4)
    u, g = generic_pg.run_plain(bound.ir, torch.tensor(q_t),
                                bound.operands(rows, "cpu"))
    u_j, vjp = jax.vjp(lambda q: jax_pot(q, *jax_rows), jnp.asarray(q_t))
    (g_j,) = vjp(jnp.ones_like(u_j))
    np.testing.assert_allclose(u.numpy().reshape(-1), np.asarray(u_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------------ index data --

def _gather_lp(idx, w):
    def logprob_fn(q):
        return torch.sum(w * q[idx]) - 0.5 * torch.sum(q * q)
    return logprob_fn


def test_an_index_outside_its_axis_raises_at_bind_and_at_a_launch():
    idx = torch.tensor([0, 3, -1, 2, 3])
    w = torch.linspace(0.5, 1.5, 5)
    pot, rows = _generic_fused_binding(_gather_lp(idx, w), 4)
    bound = generic_pg.bind(pot, rows, 4)
    assert bound.ir.index_bounds() == {next(
        j for j, r in enumerate(rows) if r.dtype == torch.int64): 4}
    bad = [r.clone() for r in rows]
    for r in bad:
        if r.dtype == torch.int64:
            r[0, 1] = 4
    with pytest.raises(IndexError):
        generic_pg.bind(pot, bad, 4)
    with pytest.raises(IndexError):
        bound.operands(bad, "cpu")
    for r in bad:
        if r.dtype == torch.int64:
            r[0, 1] = -5
    with pytest.raises(IndexError):
        bound.operands(bad, "cpu")


def test_changed_index_values_are_read_anew():
    idx = torch.tensor([0, 3, -1, 2, 3])
    w = torch.linspace(0.5, 1.5, 5)
    pot, rows = _generic_fused_binding(_gather_lp(idx, w), 4)
    bound = generic_pg.bind(pot, rows, 4)
    q = torch.randn(4, 3, generator=torch.Generator().manual_seed(2))
    first = bound.operands(rows, "cpu")
    u1, g1 = generic_pg.run_plain(bound.ir, q, first)
    assert any(o.dtype == torch.int32 for o in first)
    assert bound.operands(rows, "cpu")[0] is first[0]  # unchanged: cached
    idx[1] = 1  # in place: the binding's row is a view of idx
    again = bound.operands(rows, "cpu")
    row = next(o for o in again if o.dtype == torch.int32)
    assert row.tolist() == [[0, 1, -1, 2, 3]]
    u2, g2 = generic_pg.run_plain(bound.ir, q, again)
    u_ref = pot(q, *rows)
    np.testing.assert_allclose(u2.reshape(-1).numpy(), u_ref.numpy(),
                               rtol=1e-6)
    assert not torch.equal(g1, g2)
    assert generic_pg.bind(pot, rows, 4) is bound  # one trace, new values
    idx[1] = 7
    with pytest.raises(IndexError):
        bound.operands(rows, "cpu")


def test_each_device_keeps_its_int_row_and_the_cache_holds_no_tensor():
    """A mesh's shards each launch on their own device: every device keeps
    its own row (the meta device stands in for a second card), and the
    cache refers to the caller's tensor only weakly."""
    import gc

    idx = torch.tensor([0, 3, -1, 2, 3])
    pot, rows = _generic_fused_binding(_gather_lp(idx, torch.ones(5)), 4)
    bound = generic_pg.bind(pot, rows, 4)
    j = next(j for j, r in enumerate(rows) if r.dtype == torch.int64)
    data = [r.clone() for r in rows]
    on_cpu = bound.operands(data, "cpu")[j]
    on_meta = bound.operands(data, "meta")[j]
    assert on_meta.device.type == "meta" and on_meta.dtype == torch.int32
    assert bound.operands(data, "cpu")[j] is on_cpu
    assert bound.operands(data, "meta")[j] is on_meta
    ref = bound._rows[(j, torch.device("meta"))][0]
    assert ref() is data[j]
    del data
    gc.collect()
    assert ref() is None


def test_integer_data_that_is_not_an_index_converts_to_float():
    counts = torch.tensor([3, 0, 7, 2], dtype=torch.int64)

    def lp(q):
        return torch.sum(counts * q - torch.exp(q))

    pot, rows = _generic_fused_binding(lp, 4)
    bound = generic_pg.bind(pot, rows, 4)
    assert bound.ir.index_bounds() == {}
    assert "float" in {n.op for n in bound.ir.nodes}
    q = 0.3 * torch.randn(4, 2, generator=torch.Generator().manual_seed(4))
    u, g = generic_pg.run_plain(bound.ir, q, bound.operands(rows, "cpu"))
    np.testing.assert_allclose(g.numpy(),
                               (torch.exp(q) - counts[:, None]).numpy(),
                               rtol=1e-6)


def test_integer_arithmetic_is_outside_the_table():
    """Integer arithmetic binds on data alone (evaluated on the host) and,
    since the last of the op table, on a value that depends on q (max.dim's
    index: a per-chain integer on the card); a read through a mask that
    depends on q stays refused, by both packages."""
    idx = torch.tensor([0, 1, 2])

    def on_data(q):
        return torch.sum(q[idx + 1])

    pot, rows = _generic_fused_binding(on_data, 4)
    generic_pg.bind(pot, rows, 4)

    def on_q(q):
        return q[q.reshape(2, 2).max(dim=1).indices + 1].sum()

    pot, rows = _generic_fused_binding(on_q, 4)
    bound = generic_pg.bind(pot, rows, 4)
    q = torch.tensor([[0.1, 0.7, 0.5, -0.2], [0.9, 0.3, -0.4, 0.6]]).T
    u, _ = generic_pg.run_plain(bound.ir, q, bound.operands(rows, "cpu"))
    np.testing.assert_array_equal(u.reshape(-1).numpy(),
                                  pot(q, *rows).numpy())

    def mask_on_q(q):
        return -0.5 * torch.sum(q[q > 0] ** 2)

    pot, rows = _generic_fused_binding(mask_on_q, 4)
    with pytest.raises(NotImplementedError, match=r"bool mask.*neither"):
        generic_pg.bind(pot, rows, 4)


def test_a_mask_of_data_is_read_anew_and_a_new_count_raises():
    """A bool mask of data becomes a derived index row at bind, evaluated
    again when the data change (``_version``); a mask that then selects
    another count than the traced one raises, the traced shape being
    wrong."""
    t = torch.tensor([1.0, float("nan"), 2.0, 3.0, float("nan")])

    def lp(q):
        seen = ~torch.isnan(t)
        return -0.5 * torch.sum((q[seen] - t[seen]) ** 2)

    pot, rows = _generic_fused_binding(lp, 5)
    bound = generic_pg.bind(pot, rows, 5)
    assert bound.ir.derived
    q = torch.randn(5, 3, generator=torch.Generator().manual_seed(3))
    u1, _ = generic_pg.run_plain(bound.ir, q, bound.operands(rows, "cpu"))
    np.testing.assert_allclose(u1.reshape(-1).numpy(), pot(q, *rows).numpy(),
                               rtol=1e-6)
    t[1], t[2] = 4.0, float("nan")  # the same count, other positions
    u2, _ = generic_pg.run_plain(bound.ir, q, bound.operands(rows, "cpu"))
    np.testing.assert_allclose(u2.reshape(-1).numpy(), pot(q, *rows).numpy(),
                               rtol=1e-6)
    assert not torch.equal(u1, u2)
    t[4] = 5.0  # four values seen where three were traced
    with pytest.raises(ValueError, match="another count"):
        bound.operands(rows, "cpu")
    with pytest.raises(ValueError, match="another count"):
        generic_pg.bind(pot, rows, 5)


@pytest.mark.parametrize("algorithm, path", [("nuts", "pooled"),
                                             ("meads", "fused")])
def test_an_in_place_logprob_runs_where_the_chains_are_vmapped(algorithm,
                                                               path):
    """R2 assigns into a tensor it makes (``ll[obs] = ...``), which vmap
    refuses: the routes that vmap the logprob itself (the pooled XLA route,
    MEADS's states) batch it functionalized; finite draws."""
    group, t, c = weibull_data(2, 6, seed=4)
    q0 = 0.1 * torch.randn(8, 3, generator=torch.Generator().manual_seed(2))
    q0[:, :2] -= 4.0
    res = aehmc_tpu_torch.sample(torch.Generator().manual_seed(3),
                                 weibull_mice(group, t, c, 2), q0, 8, 8,
                                 algorithm=algorithm, path=path)
    assert torch.isfinite(res.positions).all()


def test_a_writing_scatter_with_a_duplicate_index_raises_at_bind():
    idx = torch.tensor([0, 2, 2])

    def lp(q):
        v = torch.zeros(4)
        v[idx] = torch.exp(q[:3])
        return torch.sum(v) - 0.5 * torch.sum(q * q)

    pot, rows = _generic_fused_binding(lp, 4)
    with pytest.raises(ValueError, match="duplicate"):
        generic_pg.bind(pot, rows, 4)
    idx[2] = 1  # no duplicate: binds; a duplicate again raises at a launch
    bound = generic_pg.bind(pot, rows, 4)
    idx[2] = 0
    with pytest.raises(ValueError, match="duplicate"):
        bound.operands(rows, "cpu")


def test_an_index_out_of_range_after_arithmetic_raises_at_bind():
    y = torch.tensor([1, 3, 2])  # 1-based labels of 3 classes

    def lp(q):
        return torch.sum(q.reshape(3, 3)[torch.arange(3), y - 1])

    pot, rows = _generic_fused_binding(lp, 9)
    bound = generic_pg.bind(pot, rows, 9)
    y[1] = 4  # y - 1 = 3 lies outside the axis of 3
    with pytest.raises(IndexError):
        bound.operands(rows, "cpu")
    with pytest.raises(IndexError):
        generic_pg.bind(pot, rows, 9)


def test_max_dim_sends_a_tie_gradient_to_the_first_index():
    """torch's rule, which the compiler keeps: ``max(dim=)``'s backward sends
    the whole gradient to the first maximum (JAX splits a tie evenly, so
    the JAX comparisons run on tie-free positions)."""
    def pot(q_t):
        return torch.sum(q_t.reshape(2, 3, -1).max(dim=1).values, 0)

    traced = generic_pg.trace_potential(pot, (), 6)
    q = torch.tensor([[1.0, 2.0, 1.0, -1.0, 0.5, 0.5]]).T  # ties in each row
    u, g = generic_pg.run_plain(traced.ir, q, ())
    assert u.item() == 2.5
    assert g.reshape(-1).tolist() == [0.0, 1.0, 0.0, 0.0, 1.0, 0.0]
    qr = q.clone().requires_grad_(True)
    (g_ref,) = torch.autograd.grad(pot(qr).sum(), qr)
    assert torch.equal(g, g_ref)


def test_a_scatter_sums_in_input_order_bit_for_bit(tmp_path):
    """``sum(w * q[idx])``: its gradient is a scatter-add of data, each
    output's values summed in input order by the emitted functor and by
    torch's ``index_put(accumulate=True)`` on the CPU alike."""
    import shutil

    from tests.test_torch_generic_pg import _emulate
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emitted functor for the CPU")
    rng = np.random.default_rng(8)
    idx = torch.tensor(rng.integers(-7, 7, 200))
    w = torch.tensor(rng.standard_normal(200).astype(F32))

    def pot(q_t, idx, w):
        return -torch.sum(w[:, None] * q_t[idx], 0)

    traced = generic_pg.trace_potential(pot, (idx, w), 7)
    assert "scatter_add" in {n.op for n in traced.ir.nodes}
    q = rng.standard_normal((3, 7)).astype(F32)
    _, g = generic_pg.run_plain(traced.ir, torch.tensor(q.T), (idx, w))
    # the derived rows after the data: the scatter's preimage row
    operands = generic_pg.all_operands(traced.ir, (idx, w))
    _, ge = _emulate(generic_pg.emit_cuda(traced.ir), operands, q, tmp_path)
    np.testing.assert_array_equal(ge, g.numpy().T)
    assert math.isfinite(float(ge.sum()))


def test_the_workspace_counts_a_solution_a_scatter_and_a_scan():
    """Each sequential node (a triangular solve's solution, a scatter-add's
    output, a cumulative sum) takes its floats in the chain's workspace,
    so the launch plan's shared-or-global choice counts them."""
    _, _, _, traced, _ = _traced("mvn25_chol")
    for name, op in (("mvn25_chol", "trsolve"), ("hier_negbin",
                                                 "scatter_add")):
        ir = _traced(name)[3].ir
        sched = generic_pg.schedule(ir)
        nodes = [i for i, n in enumerate(ir.nodes) if n.op == op]
        assert nodes and all(i in sched.slots for i in nodes)
        assert sched.workspace >= sum(math.prod(ir.nodes[i].shape)
                                      for i in nodes)

    def scan(q_t):
        return 0.5 * torch.sum(torch.cumsum(q_t, 0) ** 2, 0)

    ir = generic_pg.trace_potential(scan, (), 5).ir
    sched = generic_pg.schedule(ir)
    assert any(n.op == "cumsum" and i in sched.slots
               for i, n in enumerate(ir.nodes))


def test_generic_data_keeps_integers_and_makes_floats_float32():
    from aehmc_tpu_torch.convert import generic_data

    group, x, y = negbin_data(40, 6, seed=1)
    g, xt, yt, chol = generic_data(
        (group.astype(np.int32), x.astype(np.float64), y,
         np.eye(3, dtype=np.float64)), device="cpu")
    assert (g.dtype, xt.dtype, yt.dtype, chol.dtype) == (
        torch.int64, torch.float32, torch.int64, torch.float32)
    lp = hier_negbin(g, xt, yt, 6)
    pot, rows = _generic_fused_binding(lp, 10)
    bound = generic_pg.bind(pot, rows, 10)
    q = 0.2 * torch.randn(10, 3, generator=torch.Generator().manual_seed(6))
    u, _ = generic_pg.run_plain(bound.ir, q, bound.operands(rows, "cpu"))
    ref = -torch.stack([hier_negbin(group, x, y, 6)(q[:, c])
                        for c in range(3)])
    np.testing.assert_allclose(u.reshape(-1).numpy(), ref.numpy(),
                               rtol=1e-5)
