"""The potential compiler (aehmc_tpu_torch.ops.generic_pg) on the CPU.

- The plain back end (``run_plain``, the generated functor's plain
  version) against torch autograd in float64 and against ``jax.vjp`` of the
  JAX twin in float64, both to 1e-10 relative, on the repo's potentials and
  the JAX benchmark cells' (logistic with data and by closure, dense MVN,
  Neal's funnel, eight schools, linear regression through the generic
  binding, the ``nuts_fused_generic_10k`` standard-layout potential), a
  case a family of the op table (general and broadcast triangular solves,
  ``max``/``min`` with indices, ``isnan``, ``gather``/``scatter``, index
  arithmetic and several index tensors, ``pow``, masks and indexed
  assignment) and the test potentials of ``test_torch_generic_ops.py``.
- The errors: an op outside the table (a sort, an eigendecomposition), a
  potential that mixes chains, data that are not float32.
- ``emit_cuda`` is deterministic, names every data operand and stores the
  workspace the plain back end reports.
- The emitted functor itself, compiled for the CPU with g++ against a
  32-thread emulation of one warp (``__syncwarp`` a barrier, ``warp_sum``
  the same butterfly), against the plain back end in float32 to 1e-5.
- Kernels 1 and 3 on a generated functor, through their plain versions on
  external randomness, against the JAX kernels in interpret mode: decisions
  equal, floats within 1e-5.
- The port's generic fused binding against the JAX package's.
"""

import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu.api import _generic_fused_binding as jax_binding
from aehmc_tpu.ops.nuts_fused import (
    make_fused_nuts_transition as jax_std_transition,
)
from aehmc_tpu.ops.nuts_fused_small import (
    make_fused_nuts_transition_small as jax_transition,
)
from aehmc_tpu_torch.api import _generic_fused_binding
from aehmc_tpu_torch.models import (
    eight_schools_t,
    funnel_pg_t,
    linear_regression,
    logistic_pg_t,
    logistic_regression,
    logistic_regression_data,
    mvn,
    neals_funnel_pg_t,
    schools_pg_t,
)
from aehmc_tpu_torch.models.hierarchical import (
    funnel_potential_t,
    schools_potential_t,
)
from aehmc_tpu_torch.models.regression import _softplus, logistic_potential_t
from aehmc_tpu_torch.ops import LAUNCHES, _build, generic_pg
from aehmc_tpu_torch.ops import nuts_fused as nf
from aehmc_tpu_torch.ops.launch_plan import (
    generic_geometry,
    generic_workspace_floats,
    generic_workspace_shared,
    launch_plan,
)
from aehmc_tpu_torch.ops.nuts_fused_small import (
    _check_cuda_args,
    make_fused_nuts_transition_small,
    nuts_transition_plain,
)
from tests.test_torch_generic_ops import CASES as OP_CASES

F32 = np.float32
DIM, POINTS, CHAINS = 5, 12, 8


# ------------------------------------------------------------- the cases --

def _logistic_data():
    X, y = logistic_regression_data(DIM, POINTS, device="cpu")
    return X, y


def _jax_softplus(x):
    return jnp.maximum(x, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(x)))


def _logistic_case():
    X, y = _logistic_data()
    data = (X, X.T.contiguous(), y.reshape(-1, 1))

    def jax_pot(q_t, Xv, XTv, y_c):
        logits = Xv @ q_t
        return -jnp.sum(y_c * logits - _jax_softplus(logits), axis=0) + \
            0.5 * jnp.sum(q_t * q_t, axis=0)

    return logistic_potential_t, data, DIM, "t", jax_pot


def _wide_case():
    """The logistic potential at 40 dims and 13 points: X·q sums rows longer
    than a warp into fewer than 32 outputs, so the warp takes 8 outputs at
    a time with a ragged tail of 5."""
    X, y = logistic_regression_data(40, 13, device="cpu")
    data = (X, X.T.contiguous(), y.reshape(-1, 1))
    return logistic_potential_t, data, 40, "t", _logistic_case()[4]


def _closure_case():
    X, y = _logistic_data()
    y_col = y.reshape(-1, 1)

    def pot(q_t):
        logits = X @ q_t
        return -torch.sum(y_col * logits - _softplus(logits), dim=0) + \
            0.5 * torch.sum(q_t * q_t, dim=0)

    Xj, yj = jnp.asarray(X.numpy()), jnp.asarray(y_col.numpy())

    def jax_pot(q_t):
        logits = Xj @ q_t
        return -jnp.sum(yj * logits - _jax_softplus(logits), axis=0) + \
            0.5 * jnp.sum(q_t * q_t, axis=0)

    X64, y64 = X.double(), y_col.double()

    def reference(q_t):
        logits = X64 @ q_t
        return -torch.sum(y64 * logits - _softplus(logits), dim=0) + \
            0.5 * torch.sum(q_t * q_t, dim=0)

    return pot, (), DIM, "t", jax_pot, reference


def _mvn_case():
    dim = 6
    cov = np.full((dim, dim), 0.5, F32)
    np.fill_diagonal(cov, 1.0)
    prec = np.linalg.inv(cov.astype(np.float64)).astype(F32)

    def pot(q_t, P):
        return 0.5 * torch.sum(q_t * (P @ q_t), dim=0)

    def jax_pot(q_t, P):
        return 0.5 * jnp.sum(q_t * (P @ q_t), axis=0)

    return pot, (torch.tensor(prec),), dim, "t", jax_pot


def _funnel_case():
    def jax_pot(q_t, _dummy):
        v, x = q_t[0:1], q_t[1:]
        return (0.5 * (v / 3.0) ** 2
                + jnp.sum(0.5 * x * x * jnp.exp(-v), axis=0, keepdims=True)
                + (q_t.shape[0] - 1) * 0.5 * v)[0]

    _, _, data, _ = neals_funnel_pg_t(10, device="cpu")
    return funnel_potential_t, data, 10, "t", jax_pot


def _schools_case():
    def jax_pot(q_t, y_col, sig2_col):
        mu, log_tau, theta_raw = q_t[0:1], q_t[1:2], q_t[2:]
        tau = jnp.exp(log_tau)
        neg = 0.5 * (mu / 5.0) ** 2 + 0.5 * (log_tau / 5.0) ** 2 - log_tau
        neg = neg + jnp.sum(0.5 * theta_raw * theta_raw, axis=0,
                            keepdims=True)
        theta = mu + tau * theta_raw
        neg = neg + jnp.sum(0.5 * (y_col - theta) ** 2 / sig2_col, axis=0,
                            keepdims=True)
        return neg[0]

    _, data, _ = eight_schools_t(device="cpu")
    return schools_potential_t, data, 10, "t", jax_pot


def _linreg_case():
    lp, _ = linear_regression(num_points=40, device="cpu")
    pot, data = _generic_fused_binding(lp, 2)
    X, y = (d.reshape(-1) for d in data)
    Xj, yj = jnp.asarray(X.numpy(), jnp.float64), jnp.asarray(y.numpy(),
                                                              jnp.float64)

    def jax_lp(q):
        w, log_sigma = q[0], q[1]
        sigma = jnp.exp(log_sigma)
        lpv = -0.5 * (w / 10.0) ** 2 + 2.0 * log_sigma - 2.0 * sigma
        resid = yj - w * Xj
        return lpv - 40 * log_sigma - 0.5 * jnp.sum(
            jnp.square(resid)) / jnp.square(sigma)

    jax_pot, _ = jax_binding(jax_lp, 2)
    X64, y64 = X.double(), y.double()

    def torch_lp(q):  # float64 throughout, as jax_lp
        w, log_sigma = q[0], q[1]
        sigma = torch.exp(log_sigma)
        lpv = -0.5 * (w / 10.0) ** 2 + 2.0 * log_sigma - 2.0 * sigma
        resid = y64 - w * X64
        return lpv - 40 * log_sigma - 0.5 * torch.sum(
            torch.square(resid)) / torch.square(sigma)

    def reference(q_t):
        return -torch.func.vmap(torch_lp, in_dims=1)(q_t)

    return (pot, tuple(data), 2, "t",
            lambda q_t, *rows: jax_pot(q_t, *rows), reference)


def _cell_case():
    """The nuts_fused_generic_10k potential (benchmarks/run.py:669-675),
    standard layout."""
    X, y = _logistic_data()

    def pot(q, Xv, y_row):
        logits = q @ Xv.T
        sp = torch.clamp(logits, min=0.0) + torch.log1p(
            torch.exp(-torch.abs(logits)))
        return -torch.sum(y_row * logits - sp, dim=-1) + \
            0.5 * torch.sum(q * q, dim=-1)

    def jax_pot(q, Xv, y_row):
        logits = q @ Xv.T
        sp = jnp.maximum(logits, 0.0) + jnp.log1p(jnp.exp(-jnp.abs(logits)))
        return -jnp.sum(y_row * logits - sp, axis=-1) + \
            0.5 * jnp.sum(q * q, axis=-1)

    return pot, (X, y), DIM, "std", jax_pot


# -- one case a family of the op table

def _lower_upper(dim, seed):
    rng = np.random.default_rng(seed)
    M = 0.3 * rng.standard_normal((dim, dim)) + 2.0 * np.eye(dim)
    return torch.tensor(np.tril(M), dtype=torch.float32), \
        torch.tensor(np.triu(M.T), dtype=torch.float32)


def _trsolve_case():
    """A: triangular solves, lower and upper, left and right, unit diagonal,
    and ``cholesky_solve`` in both triangles."""
    dim = 6
    L, U = _lower_upper(dim, 3)

    def pot(q_t, L, U):
        a = torch.linalg.solve_triangular(L, q_t, upper=False)
        b = torch.linalg.solve_triangular(U, q_t, upper=True,
                                          unitriangular=True)
        c = torch.linalg.solve_triangular(L.T, q_t.T, upper=True,
                                          left=False).T
        d = torch.cholesky_solve(q_t, L)
        e = torch.cholesky_solve(q_t, U, upper=True)
        return 0.5 * torch.sum(a * a + b * b, 0) + 0.25 * torch.sum(
            c * c, 0) + 0.5 * torch.sum(q_t * (d + e), 0)

    def jax_pot(q_t, L, U):
        sl = jax.scipy.linalg.solve_triangular
        a = sl(L, q_t, lower=True)
        b = sl(U, q_t, lower=False, unit_diagonal=True)
        c = sl(L, q_t, lower=True)  # x L^T = q^T is L x^T = q
        d = jax.scipy.linalg.cho_solve((L, True), q_t)
        e = jax.scipy.linalg.cho_solve((U, False), q_t)
        return 0.5 * jnp.sum(a * a + b * b, 0) + 0.25 * jnp.sum(c * c, 0) \
            + 0.5 * jnp.sum(q_t * (d + e), 0)

    return pot, (L, U), dim, "t", jax_pot


def _special_case():
    """B: lgamma (digamma in its gradient), erf, erfc, erfcx, log_ndtr
    (both branches), atan, logaddexp."""
    dim = 5
    y = torch.tensor([[0.0], [3.0], [1.0], [7.0], [2.0]])

    def pot(q_t, y):  # constants exact in float32, as the card holds them
        s = torch.exp(0.25 * q_t)
        u = torch.lgamma(y + s) - torch.lgamma(s) + torch.erf(0.5 * q_t) \
            + torch.erfc(0.75 * q_t) + torch.special.log_ndtr(1.5 * q_t - 0.5) \
            + 0.125 * torch.special.erfcx(0.375 * q_t + 1.0) \
            + torch.atan(q_t) + torch.logaddexp(q_t, 0.5 * q_t * q_t - 1.0)
        return -torch.sum(u, 0) + 0.5 * torch.sum(q_t * q_t, 0)

    def jax_pot(q_t, y):
        sp = jax.scipy.special
        s = jnp.exp(0.25 * q_t)
        u = sp.gammaln(y + s) - sp.gammaln(s) + sp.erf(0.5 * q_t) \
            + sp.erfc(0.75 * q_t) + sp.log_ndtr(1.5 * q_t - 0.5) \
            + 0.125 * jnp.exp((0.375 * q_t + 1.0) ** 2) \
            * sp.erfc(0.375 * q_t + 1.0) \
            + jnp.arctan(q_t) + jnp.logaddexp(q_t, 0.5 * q_t * q_t - 1.0)
        return -jnp.sum(u, 0) + 0.5 * jnp.sum(q_t * q_t, 0)

    return pot, (y,), dim, "t", jax_pot


def _reductions_case():
    """C: logsumexp, log_softmax, softmax and stack along an axis."""
    dim = 6
    w = torch.linspace(0.2, 1.2, dim).reshape(-1, 1)

    def pot(q_t, w):
        st = torch.stack([q_t, 0.5 * q_t * q_t], 0)
        return torch.logsumexp(q_t, 0) - torch.sum(
            w * torch.log_softmax(q_t, 0), 0) + torch.sum(
            torch.softmax(q_t, 0) ** 2, 0) + 0.125 * torch.sum(
            torch.logsumexp(st, 0), 0) + 0.5 * torch.sum(q_t * q_t, 0)

    def jax_pot(q_t, w):
        st = jnp.stack([q_t, 0.5 * q_t * q_t], 0)
        lse = jax.nn.logsumexp
        return lse(q_t, 0) - jnp.sum(w * jax.nn.log_softmax(q_t, 0), 0) \
            + jnp.sum(jax.nn.softmax(q_t, 0) ** 2, 0) \
            + 0.125 * jnp.sum(lse(st, 0), 0) + 0.5 * jnp.sum(q_t * q_t, 0)

    return pot, (w,), dim, "t", jax_pot


def _gather_case():
    """D: ``q[idx]`` and ``index_select`` with repeated and negative
    indices, their scatter-adds in the gradient."""
    dim = 6
    rng = np.random.default_rng(4)
    idx = torch.tensor(rng.integers(-dim, dim, 11))
    sel = torch.tensor([5, 0, 0, 2, 3])
    w = torch.tensor(rng.uniform(0.5, 1.5, (11, 1)).astype(F32))

    def pot(q_t, idx, sel, w):
        g = q_t[idx]
        s = torch.index_select(q_t, 0, sel)
        return 0.5 * torch.sum(w * g * g, 0) + torch.sum(
            torch.log1p(torch.exp(s)), 0) + 0.5 * torch.sum(q_t * q_t, 0)

    def jax_pot(q_t, idx, sel, w):
        g = q_t[idx]
        s = q_t[sel]
        return 0.5 * jnp.sum(w * g * g, 0) + jnp.sum(jnp.log1p(jnp.exp(s)),
                                                      0) \
            + 0.5 * jnp.sum(q_t * q_t, 0)

    return pot, (idx, sel, w), dim, "t", jax_pot


def _scans_case():
    """cumsum, flip, amax, var, and bmm over two batches."""
    dim = 6
    rng = np.random.default_rng(6)
    B = torch.tensor(rng.standard_normal((2, 3, 3)).astype(F32))
    ramp = torch.arange(dim, dtype=torch.float32).reshape(-1, 1)

    def pot(q_t, B, ramp):
        cs = torch.cumsum(q_t, 0)
        fl = torch.flip(q_t, (0,))
        prod = torch.bmm(B, q_t.reshape(2, 3, -1))
        return 0.5 * torch.sum(cs * cs, 0) + torch.sum(fl * ramp, 0) \
            + torch.amax(q_t, 0) + torch.var(q_t, 0) \
            + 0.5 * torch.sum(prod * prod, (0, 1))

    def jax_pot(q_t, B, ramp):
        cs = jnp.cumsum(q_t, 0)
        fl = jnp.flip(q_t, 0)
        prod = jnp.matmul(B, q_t.reshape(2, 3, -1))
        return 0.5 * jnp.sum(cs * cs, 0) + jnp.sum(fl * ramp, 0) \
            + jnp.max(q_t, 0) + jnp.var(q_t, 0, ddof=1) \
            + 0.5 * jnp.sum(prod * prod, (0, 1))

    return pot, (B, ramp), dim, "t", jax_pot


# -- the rest of the op table (item 1.10c)

def _solve_case():
    """``torch.linalg.solve`` on a matrix of data (right sides the chains'
    columns) and on a matrix that depends on q (a vector right side a
    chain), and ``left=False``; the matrices need row swaps."""
    dim = 4
    rng = np.random.default_rng(12)
    M = torch.tensor(rng.standard_normal((dim, dim)).astype(F32))

    def pot(q_t, M):
        a = torch.linalg.solve(M, q_t)
        A = M + 0.25 * q_t.T[:, :, None] * q_t.T[:, None, :]  # (C, n, n)
        b = torch.linalg.solve(A, torch.sin(q_t.T))           # (C, n)
        c = torch.linalg.solve(M.T, q_t.T, left=False)
        return 0.125 * torch.sum(a * a, 0) + torch.sum(b * q_t.T, 1) \
            + 0.0625 * torch.sum(c * c, 1) + 0.5 * torch.sum(q_t * q_t, 0)

    def jax_pot(q_t, M):
        a = jnp.linalg.solve(M, q_t)
        A = M + 0.25 * q_t.T[:, :, None] * q_t.T[:, None, :]
        b = jnp.linalg.solve(A, jnp.sin(q_t.T)[..., None])[..., 0]
        c = jnp.linalg.solve(M, q_t).T  # x M^T = q^T is M x^T = q
        return 0.125 * jnp.sum(a * a, 0) + jnp.sum(b * q_t.T, 1) \
            + 0.0625 * jnp.sum(c * c, 1) + 0.5 * jnp.sum(q_t * q_t, 0)

    return pot, (M,), dim, "t", jax_pot


def _maxmin_case():
    """``max(dim=)`` and ``min(dim=)``, their values and indices (tie-free
    positions), ``amin``, ``argmax``."""
    dim = 6
    w = torch.linspace(0.5, 1.5, 3).reshape(-1, 1)

    def pot(q_t, w):
        M = q_t.reshape(2, 3, -1)
        hi, i = M.max(dim=1)
        lo = M.min(dim=0, keepdim=True)
        return torch.sum(hi * hi, 0) + torch.sum(w * lo.values[0] ** 2, 0) \
            + 0.125 * torch.sum(i.float(), 0) \
            + 0.25 * torch.sum(lo.indices.float(), (0, 1)) \
            + torch.amin(q_t, 0) + 0.375 * torch.argmax(q_t, 0).float() \
            + 0.5 * torch.sum(q_t * q_t, 0)

    def jax_pot(q_t, w):
        M = q_t.reshape(2, 3, -1)
        hi, i = jnp.max(M, 1), jnp.argmax(M, 1)
        lo, li = jnp.min(M, 0), jnp.argmin(M, 0)
        return jnp.sum(hi * hi, 0) + jnp.sum(w * lo ** 2, 0) \
            + 0.125 * jnp.sum(i, 0) + 0.25 * jnp.sum(li, 0) \
            + jnp.min(q_t, 0) + 0.375 * jnp.argmax(q_t, 0) \
            + 0.5 * jnp.sum(q_t * q_t, 0)

    return pot, (w,), dim, "t", jax_pot


def _isnan_case():
    """``isnan`` on data (NaN where a value is missing) and on q."""
    dim = 5
    y = torch.tensor([[1.5], [float("nan")], [-0.5], [float("nan")], [2.0]])

    def pot(q_t, y):
        seen = ~torch.isnan(y)
        yc = torch.where(seen, y, 0.0)
        return 0.5 * torch.sum(seen * (q_t - yc) ** 2, 0) \
            + torch.sum(torch.isnan(torch.log(q_t + 0.5)).float(), 0) \
            + 0.125 * torch.sum(q_t * q_t, 0)

    def jax_pot(q_t, y):
        seen = ~jnp.isnan(y)
        yc = jnp.where(seen, y, 0.0)
        return 0.5 * jnp.sum(seen * (q_t - yc) ** 2, 0) \
            + jnp.sum(jnp.isnan(jnp.log(q_t + 0.5)), 0) \
            + 0.125 * jnp.sum(q_t * q_t, 0)

    return pot, (y,), dim, "t", jax_pot


def _gather_scatter_case():
    """``torch.gather`` along an axis by an index of data, a writing
    ``torch.scatter`` (no duplicate) and ``scatter_add`` (duplicates, in
    input order)."""
    dim = 12
    idx = torch.tensor([[2, 0], [3, 3], [1, 2]])
    put = torch.tensor([[1, 3], [0, 2], [2, 0]])
    w = torch.linspace(0.5, 1.5, 12).reshape(3, 4, 1)

    def pot(q_t, idx, put, w):
        M = q_t.reshape(3, 4, -1)
        C = M.shape[-1]
        g = torch.gather(M, 1, idx[..., None].expand(3, 2, C))
        s = torch.scatter(torch.zeros_like(M), 1,
                          put[..., None].expand(3, 2, C), torch.exp(g))
        a = torch.scatter_add(w.expand(3, 4, C).clone(), 1,
                              idx[..., None].expand(3, 2, C), g * g)
        return torch.sum(s * M, (0, 1)) + 0.5 * torch.sum(a * a, (0, 1))

    def jax_pot(q_t, idx, put, w):
        M = q_t.reshape(3, 4, -1)
        C = M.shape[-1]
        rows = jnp.arange(3)[:, None]
        g = M[rows, idx]
        s = jnp.zeros_like(M).at[rows, put].set(jnp.exp(g))
        a = jnp.broadcast_to(w, (3, 4, C)).at[rows, idx].add(g * g)
        return jnp.sum(s * M, (0, 1)) + 0.5 * jnp.sum(a * a, (0, 1))

    return pot, (idx, put, w), dim, "t", jax_pot


def _index_arith_case():
    """Integer arithmetic on index data (``idx + 1``, ``i * K + j``, ``//``,
    ``%``) and two index tensors (``x[i, j]``, ``x[arange(n), y - 1]``)."""
    dim = 12
    i = torch.tensor([0, 2, 1, 2, 0])
    j = torch.tensor([3, 1, 0, 2, 3])
    y = torch.tensor([1, 4, 2, 3])  # labels 1..4

    def pot(q_t, i, j, y):
        M = q_t.reshape(3, 4, -1)
        a = q_t[(i * 4 + j) // 2 + 1]
        b = M[i, j]
        c = M[torch.arange(3), y[:3] - 1]
        d = q_t[(j * 5) % 7]
        return 0.5 * torch.sum(a * a, 0) + torch.sum(torch.exp(0.375 * b), 0) \
            + torch.sum(c * c * c, 0) + torch.sum(torch.sin(d), 0)

    def jax_pot(q_t, i, j, y):
        M = q_t.reshape(3, 4, -1)
        a = q_t[(i * 4 + j) // 2 + 1]
        b = M[i, j]
        c = M[jnp.arange(3), y[:3] - 1]
        d = q_t[(j * 5) % 7]
        return 0.5 * jnp.sum(a * a, 0) + jnp.sum(jnp.exp(0.375 * b), 0) \
            + jnp.sum(c * c * c, 0) + jnp.sum(jnp.sin(d), 0)

    return pot, (i, j, y), dim, "t", jax_pot


def _pow_case():
    """``pow`` with a tensor exponent (a positive base of data, a base of
    q; a zero base pins torch's ``where(base == 0 & exp >= 0, 0, ...)``
    in the exponent's gradient) and with a scalar base (``2 ** q``)."""
    dim = 4
    t = torch.tensor([[0.5], [2.0], [0.0], [3.0]])

    def pot(q_t, t):
        r = torch.exp(0.375 * q_t)
        return torch.sum(t ** r, 0) + torch.sum(2 ** q_t, 0) \
            + 0.125 * torch.sum(torch.exp(q_t) ** torch.sin(q_t), 0) \
            + 0.5 * torch.sum(q_t * q_t, 0)

    def jax_pot(q_t, t):
        r = jnp.exp(0.375 * q_t)
        return jnp.sum(t ** r, 0) + jnp.sum(2.0 ** q_t, 0) \
            + 0.125 * jnp.sum(jnp.exp(q_t) ** jnp.sin(q_t), 0) \
            + 0.5 * jnp.sum(q_t * q_t, 0)

    return pot, (t,), dim, "t", jax_pot


def _masks_case():
    """A bool mask of data (``x[mask]``), an indexed assignment through it
    and through an index (``v[mask] = a``, ``v[idx] = a``, no
    accumulate)."""
    dim = 6
    m = torch.tensor([1, 0, 2, 1, 0, 3])  # a mask where m > 0
    idx = torch.tensor([4, 1])

    def pot(q_t, m, idx):
        m = m.bool()
        v = torch.zeros_like(q_t)
        v[m] = torch.exp(0.5 * q_t[m])
        v[~m] = q_t[~m] ** 2
        v[idx] = 3.0 * q_t[idx]
        return torch.sum(v, 0) + 0.5 * torch.sum(q_t * q_t, 0)

    def jax_pot(q_t, m, idx):
        v = jnp.where(m[:, None] > 0, jnp.exp(0.5 * q_t), q_t ** 2)
        v = v.at[idx].set(3.0 * q_t[idx])
        return jnp.sum(v, 0) + 0.5 * jnp.sum(q_t * q_t, 0)

    return pot, (m, idx), dim, "t", jax_pot


def _trsolve_bcast_case():
    """A triangular solve whose batch of factors (3, 1) broadcasts against
    the right sides' (1, 2): the solution's batch (3, 2)."""
    dim = 6
    rng = np.random.default_rng(13)
    L = torch.tensor(np.tril(0.375 * rng.standard_normal((3, 1, 3, 3))
                             + 2.0 * np.eye(3)).astype(F32))

    def pot(q_t, L):
        B = q_t.reshape(1, 2, 3, -1)
        X = torch.linalg.solve_triangular(L, B, upper=False)
        return 0.5 * torch.sum(X * X, (0, 1, 2)) + 0.5 * torch.sum(q_t * q_t,
                                                                   0)

    def jax_pot(q_t, L):
        B = q_t.reshape(1, 2, 3, -1)
        shape = (3, 2, 3, B.shape[-1])
        X = jax.scipy.linalg.solve_triangular(
            jnp.broadcast_to(L, (3, 2, 3, 3)), jnp.broadcast_to(B, shape),
            lower=True)
        return 0.5 * jnp.sum(X * X, (0, 1, 2)) + 0.5 * jnp.sum(q_t * q_t, 0)

    return pot, (L,), dim, "t", jax_pot


CASES = {
    "logistic": _logistic_case, "logistic_wide": _wide_case,
    "logistic_closure": _closure_case,
    "dense_mvn": _mvn_case, "funnel": _funnel_case,
    "eight_schools": _schools_case, "linear_regression": _linreg_case,
    "generic_10k": _cell_case,
    # the op table's families (A-D, then the scans) and the four test
    # potentials at small sizes (tests/test_torch_generic_ops.py)
    "op_trsolve": _trsolve_case, "op_special": _special_case,
    "op_reductions": _reductions_case, "op_gather": _gather_case,
    "op_scans": _scans_case,
    # the rest of the table: general solves, max/min with indices, isnan,
    # gather and scatter, index arithmetic, pow, masks, broadcast factors
    "op_solve": _solve_case, "op_maxmin": _maxmin_case,
    "op_isnan": _isnan_case, "op_gather_scatter": _gather_scatter_case,
    "op_index_arith": _index_arith_case, "op_pow": _pow_case,
    "op_masks": _masks_case, "op_trsolve_bcast": _trsolve_bcast_case,
    **OP_CASES,
}

# Limits of the emitted functor against its plain back end (float32): 1e-5
# of the largest value for every case.  B's special functions are CUDA's or
# transcriptions of ATen's float formulas (digamma: the one torch runs on
# the card), a few ulp (<= 5e-7 relative) from torch's CPU ones each, so
# 1e-5 holds for them too.
EMITTED_RTOL = 1e-5
# Limits of the plain back end (run in float64) against float64 autograd
# and jax.vjp: 1e-10, but where a gradient formula holds an irrational
# constant (erf's 2/sqrt(pi), log_ndtr's sqrt(2 pi), var's 2/(n - 1), the
# log 2 of 2 ** q's gradient) the IR keeps it in float32, as the card does:
# 6e-8 relative rounding.
FLOAT64_RTOL = {"op_special": 1e-7, "op_scans": 1e-7, "op_pow": 1e-7}


def _case(name):
    """``(fn, data, dim, layout, jax_pot, reference)``: the potential, its
    data, the JAX twin, and a float64 torch potential of ``q_t`` (autograd's
    reference)."""
    fn, data, dim, layout, jax_pot, *reference = CASES[name]()
    if not reference:
        d64 = [d.double() if d.is_floating_point() else d for d in data]
        if layout == "std":
            reference = [lambda q_t: fn(q_t.T, *d64)]
        else:
            reference = [lambda q_t: fn(q_t, *d64)]
    return fn, data, dim, layout, jax_pot, reference[0]


def _traced(name):
    fn, data, dim, layout, jax_pot, _ = _case(name)
    traced = generic_pg.trace_potential(fn, data, dim, layout=layout)
    return fn, data, dim, layout, jax_pot, traced


def _positions(dim, chains=7, seed=0, scale=0.7):
    rng = np.random.default_rng(seed)
    return scale * rng.standard_normal((dim, chains))


def _assert_rel(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


# ---------------------------------------------------- the plain back end --

@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_back_end_matches_autograd_and_jax_vjp(name):
    fn, data, dim, layout, jax_pot, traced = _traced(name)
    q_t = _positions(dim)
    operands = (*data, *traced.constants)
    stats = {}
    u, g = generic_pg.run_plain(traced.ir, torch.tensor(q_t), operands, stats)
    assert stats["workspace_floats"] == generic_pg.schedule(traced.ir).workspace
    # torch autograd of the potential in float64
    q64 = torch.tensor(q_t, requires_grad=True)
    u_ref = _case(name)[-1](q64)
    (g_ref,) = torch.autograd.grad(u_ref.sum(), q64)
    rtol = FLOAT64_RTOL.get(name, 1e-10)
    _assert_rel(u.numpy().reshape(-1), u_ref.detach().numpy().reshape(-1),
                rtol)
    _assert_rel(g.numpy(), g_ref.numpy(), rtol)
    # jax.vjp of the JAX twin, float64
    jd = [jnp.asarray(d.numpy(), jnp.float64) if d.is_floating_point()
          else jnp.asarray(d.numpy()) for d in data]
    if layout == "std":
        u_j, vjp = jax.vjp(lambda q: jax_pot(q, *jd), jnp.asarray(q_t.T))
        (g_j,) = vjp(jnp.ones_like(u_j))
        g_j = np.asarray(g_j).T
    else:
        u_j, vjp = jax.vjp(lambda q: jax_pot(q, *jd), jnp.asarray(q_t))
        (g_j,) = vjp(jnp.ones_like(u_j))
    _assert_rel(u.numpy().reshape(-1), np.asarray(u_j).reshape(-1), rtol)
    _assert_rel(g.numpy(), np.asarray(g_j), rtol)


@pytest.mark.parametrize("pg, builder", [
    (logistic_pg_t, "logistic"), (funnel_pg_t, "funnel"),
    (schools_pg_t, "eight_schools")])
def test_a_potential_and_grad_is_traced_as_it_stands(pg, builder):
    """``potential_and_grad_t`` is traced with no gradient of its own: the
    plain back end computes what it computes."""
    data = {"logistic": _logistic_case, "funnel": _funnel_case,
            "eight_schools": _schools_case}[builder]()[1]
    dim = 10 if builder != "logistic" else DIM
    traced = generic_pg.trace_potential(pg, data, dim, with_grad=False)
    q_t = torch.tensor(_positions(dim, seed=3))
    u, g = generic_pg.run_plain(traced.ir, q_t, (*data, *traced.constants))
    u_ref, g_ref = pg(q_t, *[d.double() for d in data])
    _assert_rel(u.numpy().reshape(-1), u_ref.numpy().reshape(-1), 1e-12)
    _assert_rel(g.numpy(), g_ref.numpy(), 1e-12)


def test_long_rows_into_few_outputs_take_the_warp_per_output():
    traced = _traced("logistic_wide")[-1]
    text = generic_pg.emit_cuda(traced.ir)
    assert "for (int o0 = 0; o0 < 13; o0 += 8)" in text
    # the 8 sums' butterflies at once, sum u stored by lane 4u unless
    # past the 13th (a ragged tail recomputes the last output)
    assert "gpg_warp_sums<8>(acc, lane)" in text
    assert "lane % 4 == 0 && o0 + (lane / 4) < 13" in text
    assert "gpg_imin(o0 + 5, 12)" in text


def test_closed_over_tensors_become_data_operands():
    fn, data, dim, layout, _, traced = _traced("logistic_closure")
    X, y = _logistic_data()
    shapes = traced.ir.data_shapes
    assert traced.ir.num_caller_data == 0 and len(traced.constants) == 2
    assert sorted(shapes) == sorted([tuple(X.shape), (POINTS, 1)])
    assert {"aten.mm.default", "aten.t.default"} <= set(traced.ops)


# ----------------------------------------------------------- the errors ---

def test_an_op_outside_the_table_raises_naming_it():
    """Bessel functions of the first kind stay outside the table: each
    raises naming its aten op and the roadmap item."""
    with pytest.raises(NotImplementedError,
                       match=r"aten\.special_bessel_j0.*1\.10c"):
        generic_pg.trace_potential(
            lambda q_t: torch.special.bessel_j0(q_t).sum(0), (), 4)

    def bessel_lp(q):
        return -0.5 * torch.sum(torch.special.bessel_j1(q) ** 2)

    pot, data = _generic_fused_binding(bessel_lp, 3)
    with pytest.raises(NotImplementedError, match="special_bessel_j1"):
        generic_pg.trace_potential(pot, data, 3)
    # the package's own mvn binds: its triangular solve is in the table
    mvn_lp = mvn(np.zeros(3), np.eye(3) + 0.2, device="cpu")
    pot, data = _generic_fused_binding(mvn_lp, 3)
    assert "aten.linalg_solve_triangular.default" in \
        generic_pg.trace_potential(pot, data, 3).ops


def test_a_potential_that_mixes_chains_raises():
    def mixing(q_t):
        return 0.5 * torch.sum(q_t * q_t, dim=0) + q_t.mean()

    with pytest.raises(ValueError, match="mixes chains"):
        generic_pg.trace_potential(mixing, (), 4)


def test_non_float32_raises_at_the_card_check():
    fn, data, dim, *_ = _mvn_case()
    q_t = torch.zeros(dim, 16)
    with pytest.raises(TypeError, match="float32"):
        _check_cuda_args(None, data, q_t.double(), 0.3, potential_fn_t=fn)
    with pytest.raises(TypeError, match="float32"):
        _check_cuda_args(None, (data[0].double(),), q_t, 0.3,
                         potential_fn_t=fn)
    model = nf._generic_model(_cell_case()[0], _logistic_data())
    with pytest.raises(TypeError, match="float32"):
        nf._check_card(model, torch.zeros(16, DIM, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):
        generic_pg.bind(fn, (data[0].to(torch.bfloat16),), dim)


def test_the_card_check_binds_a_generated_functor():
    """Any potential without a hand-written functor binds one, traced once
    per function and data signature."""
    fn, data, dim, *_ = _mvn_case()
    q_t = torch.zeros(dim, 16)
    assert _check_cuda_args(None, data, q_t, 0.3, potential_fn_t=fn) == \
        "generic"
    assert generic_pg.bind(fn, data, dim) is generic_pg.bind(fn, data, dim)
    model = nf._generic_model(_cell_case()[0], _logistic_data())
    bound = nf._check_card(model, torch.zeros(16, DIM))
    assert bound.ir.layout == "std" and bound.workspace > 0
    assert {"nuts_transition_generic", "nuts_sampling_generic",
            "nuts_transition_std_generic",
            "nuts_sampling_std_generic"} <= set(LAUNCHES)


# ---------------------------------------------------------- the emitter ---

@pytest.mark.parametrize("name", ["logistic", "logistic_closure",
                                  "generic_10k", "funnel"])
def test_emit_cuda_is_deterministic_and_names_every_operand(name):
    traced = _traced(name)[-1]
    again = _traced(name)[-1]
    text = generic_pg.emit_cuda(traced.ir)
    assert text == generic_pg.emit_cuda(again.ir)
    assert traced.ir.key() == again.ir.key()
    assert _build.generated_path(text) == _build.generated_path(
        generic_pg.emit_cuda(again.ir))
    geo = generic_pg.geometry_of(traced.ir)
    for j in range(len(traced.ir.data_shapes)):  # read in place or resident
        if geo.kind(j) == "resident":
            assert f"R{j} = S.res + " in text
            assert f"make_resident(S, {j}, " in text
        else:
            assert f"D{j} = data.ptr[{j}];" in text
    stats = {}
    dim = traced.ir.dim
    generic_pg.run_plain(traced.ir, torch.zeros(dim, 2),
                         (*_traced(name)[1], *traced.constants), stats)
    assert f"static constexpr int W = {stats['workspace_floats']};" in text
    assert "struct GenericPG" in text and "fmaf" in text or "mm" not in {
        n.op for n in traced.ir.nodes}


def test_launch_plan_of_a_generated_functor():
    geo = generic_geometry(100, 2_100)
    big = launch_plan("nuts", 100, 6, 10_240, functor="generic",
                      geometry=geo)
    assert (big.points, big.row_stride, big.chains) == (0, 0, 8)
    assert not generic_workspace_shared(100, 2_100) and not geo.ws_shared
    assert generic_workspace_floats(geo, big.blocks) == \
        big.blocks * 8 * 2_100
    geo = generic_geometry(25, 50)
    small = launch_plan("nuts", 25, 10, 512, functor="generic", geometry=geo)
    assert generic_workspace_shared(25, 50) and geo.ws_shared
    assert generic_workspace_floats(geo, small.blocks) == 0
    assert small.smem == 4 * (17 * 8 * 28 + 8 + 8 * 50)


def test_a_build_without_nvcc_raises():
    if shutil.which("nvcc"):
        pytest.skip("nvcc is present: the build would run")
    text = generic_pg.emit_cuda(_traced("dense_mvn")[-1].ir)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.load_generated(text)


# ------------------------------------------ the emitted code, on the CPU --

_MOCK = r'''
#pragma once
#include <barrier>
#include <cmath>
#include <cstring>
#define __device__
#define __forceinline__ inline
#define __restrict__
// one block: 8 warps of 32 threads, a barrier a warp (__syncwarp and the
// shuffles) and one for the block (__syncthreads)
namespace emu {
inline std::barrier<>* warp[8];
inline std::barrier<>* block;
inline float vals[256];
}
struct Idx { int x; };
inline thread_local Idx threadIdx{0};
inline Idx blockIdx{0};
inline void __syncwarp() { emu::warp[threadIdx.x / 32]->arrive_and_wait(); }
inline void __syncthreads() { emu::block->arrive_and_wait(); }
inline float __ldg(const float* p) { return *p; }
inline int __ldg(const int* p) { return *p; }
// CUDA's erfcxf (exp(x^2) erfc(x)), from glibc's double functions
inline float erfcxf(float x) {
  const double d = x;
  if (d < 25.0) return (float)(std::exp(d * d) * std::erfc(d));
  return (float)(0.56418958354775628695 / d *
                 (1.0 - 0.5 / (d * d) + 0.75 / (d * d * d * d)));
}
inline float __int_as_float(unsigned v) {
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}
namespace aehmc {
struct Geometry { int blocks, points, row_stride, smem, chains; };
constexpr unsigned FULL = 0xffffffffu;
constexpr int NT = 256;
// the asynchronous copy: a plain copy, landed when issued; the wait and the
// block barrier after it (chunk_ready) then order it as on the card
inline void gpg_copy4(float* dst, const float* src) {
  std::memcpy(dst, src, 4);
}
inline void gpg_copy_commit() {}
inline void gpg_copy_wait() {}
// the warp's shuffles through the warp's shared slots and its barrier
inline float __shfl_down_sync(unsigned, float v, int o) {
  const int lane = threadIdx.x % 32, base = threadIdx.x - lane;
  emu::vals[threadIdx.x] = v;
  __syncwarp();
  const float other = lane + o < 32 ? emu::vals[base + lane + o] : v;
  __syncwarp();
  return other;
}
inline float __shfl_xor_sync(unsigned, float v, int o) {
  emu::vals[threadIdx.x] = v;
  __syncwarp();
  const float other = emu::vals[threadIdx.x ^ o];
  __syncwarp();
  return other;
}
inline float __shfl_sync(unsigned, float v, int src) {
  emu::vals[threadIdx.x] = v;
  __syncwarp();
  const float out = emu::vals[threadIdx.x - threadIdx.x % 32 + src];
  __syncwarp();
  return out;
}
// __shfl_down_sync's butterfly, then lane 0's value to every lane
inline float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return __shfl_sync(FULL, v, 0);
}
}  // namespace aehmc
'''

_MAIN = r'''
#include <cstdio>
#include <deque>
#include <thread>
#include <vector>
#include "generic_pg.cuh"
using namespace aehmc;
#include "functor.cu"
// C chains in blocks of 8 (the last padded with its first chain): each
// block's 256 threads copy the resident operands (request), meet at the
// block barrier, and call the functor once
int main() {
  int C, n;
  if (fread(&C, 4, 1, stdin) != 1 || fread(&n, 4, 1, stdin) != 1) return 2;
  std::vector<std::vector<float>> data(n);
  GenericPG pg = {};
  pg.data.n = n;
  for (int j = 0; j < n; ++j) {  // 4-byte words: float32 or int32 rows
    long long len;
    if (fread(&len, 8, 1, stdin) != 1) return 2;
    data[j].resize(len);
    if (fread(data[j].data(), 4, len, stdin) != (size_t)len) return 2;
    pg.data.ptr[j] = data[j].data();
    pg.data.len[j] = len;
  }
  const int W = GenericPG::W > 0 ? GenericPG::W : 1;
  std::vector<float> global(8 * W, NAN);
  std::vector<float> smem(8 + GenericPG::RES_FLOATS +
                          2 * GenericPG::TILE_FLOATS + 8 * W +
                          8 * GenericPG::FS_FLOATS, NAN);
  pg.ws_global = global.data();
  if (!pg.fits(GenericPG::DIM, Geometry{1, GenericPG::TILE_ROWS,
                                        GenericPG::TILE_STRIDE, 1, 8}))
    return 3;
  const int dim = GenericPG::DIM, ds = (dim + 3) / 4 * 4;
  std::vector<float> q(8 * ds, 0.f), g(8 * ds, NAN);
  std::deque<std::barrier<>> warps;
  for (int w = 0; w < 8; ++w) emu::warp[w] = &warps.emplace_back(32);
  std::barrier<> block(256);
  emu::block = &block;
  const auto S = GenericPG::carve_scratch(smem.data(), ds);
  for (int c0 = 0; c0 < C; c0 += 8) {
    const int nc = C - c0 < 8 ? C - c0 : 8;
    for (int c = 0; c < nc; ++c)
      if (fread(q.data() + c * ds, 4, dim, stdin) != (size_t)dim) return 2;
    for (int c = nc; c < 8; ++c)
      std::memcpy(q.data() + c * ds, q.data(), 4 * dim);
    std::vector<std::thread> threads;
    for (int t = 0; t < 256; ++t)
      threads.emplace_back([&, t] {
        threadIdx.x = t;
        pg.request(S);
        __syncthreads();
        pg(S, dim, ds, q.data(), g.data());
      });
    for (auto& t : threads) t.join();
    for (int c = 0; c < nc; ++c) {
      fwrite(&S.nu[c], 4, 1, stdout);
      fwrite(g.data() + c * ds, 4, dim, stdout);
    }
  }
  return 0;
}
'''


_COMPILED = {}  # functor text -> its emulation's executable, a session


def _emulate(source, operands, q, work):
    """(u (C,), g (C, dim)) of the emitted functor compiled for the CPU,
    one block emulated by 256 threads: 8 warps, 8 chains at a time (a text
    compiled once a session)."""
    exe = _COMPILED.get(source)
    if exe is None or not exe.exists():
        (work / "hierarchical_pg.cuh").write_text(_MOCK)
        shutil.copy(_build.CSRC / "generic_pg.cuh", work / "generic_pg.cuh")
        (work / "functor.cu").write_text(source)
        (work / "main.cpp").write_text(_MAIN)
        exe = work / "emulated"
        subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                        "-pthread", "-I", str(work), "-o", str(exe),
                        str(work / "main.cpp")], check=True,
                       capture_output=True, timeout=300)
        _COMPILED[source] = exe
    q = np.ascontiguousarray(q, F32)
    blob = [np.int32(q.shape[0]).tobytes(), np.int32(len(operands)).tobytes()]
    for d in operands:
        kind = np.int32 if d.dtype in generic_pg.INT_DTYPES else F32
        d = np.ascontiguousarray(d.numpy(), kind).reshape(-1)
        blob += [np.int64(d.size).tobytes(), d.tobytes()]
    blob.append(q.tobytes())
    out = subprocess.run([str(exe)], input=b"".join(blob), check=True,
                         capture_output=True, timeout=120).stdout
    res = np.frombuffer(out, F32).reshape(q.shape[0], q.shape[1] + 1)
    return res[:, 0], res[:, 1:]


@pytest.mark.parametrize("name", sorted(CASES))
def test_emitted_functor_computes_its_plain_version(name, tmp_path):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to compile the emitted functor for the CPU")
    _, data, dim, _, _, traced = _traced(name)
    operands = generic_pg.all_operands(traced.ir, (*data, *traced.constants))
    q = _positions(dim, chains=5, seed=11).T.astype(F32)
    u, g = generic_pg.run_plain(traced.ir, torch.tensor(q.T), operands)
    ue, ge = _emulate(generic_pg.emit_cuda(traced.ir), operands, q, tmp_path)
    _assert_rel(ue, u.numpy().reshape(-1), EMITTED_RTOL)
    _assert_rel(ge, g.numpy().T, EMITTED_RTOL)


# ------------------------------------- kernels 1 and 3 against the JAX ones

def _streams(rng, chains, dim, max_exp):
    p = rng.normal(size=(chains, dim)).astype(F32)
    dirs = np.where(rng.uniform(size=(chains, max_exp)) < 0.5, -1.0, 1.0)
    ub = rng.uniform(size=(chains, max_exp)).astype(F32)
    ul = rng.uniform(size=(chains, 2**max_exp)).astype(F32)
    return p, dirs.astype(F32), ub, ul


def _assert_same(stats_a, stats_b, floats_a, floats_b):
    np.testing.assert_array_equal(stats_a[:, 2:6], stats_b[:, 2:6])
    for a, b in zip(floats_a, floats_b):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _jax_logistic_lp():
    X, y = _logistic_data()
    Xj, yj = jnp.asarray(X.numpy()), jnp.asarray(y.numpy())

    def jax_lp(w):
        logits = Xj @ w
        return jnp.sum(yj * logits - _jax_softplus(logits)) - 0.5 * jnp.sum(
            w * w)

    return jax_lp


@pytest.mark.parametrize("eps, max_exp", [(0.3, 4), (0.05, 5), (2.5, 4)])
def test_generated_kernel_1_plain_matches_jax_interpret(eps, max_exp):
    """Kernel 1's plain version with the generated functor's plain back end
    as its potential, on the front door's binding of the logistic logprob,
    against the JAX kernel tracing the JAX binding of the same logprob in
    interpret mode."""
    lp, _ = logistic_regression(DIM, POINTS, device="cpu")
    pot, rows = _generic_fused_binding(lp, DIM)
    traced = generic_pg.trace_potential(pot, rows, DIM)
    operands = (*rows, *traced.constants)
    dim = DIM
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
    jax_pot, jax_rows = jax_binding(_jax_logistic_lp(), DIM)
    jt = jax_transition(jax_pot, jax_rows, max_num_expansions=max_exp,
                        block_chains=CHAINS, interpret=True)
    ref = [np.asarray(o) for o in jt(
        jnp.asarray(q), jnp.asarray(u0.numpy().reshape(-1, 1)),
        jnp.asarray(g0.numpy().T), jnp.asarray(p), jnp.asarray(dirs),
        jnp.asarray(ub), jnp.asarray(ul), jnp.asarray(im),
        jnp.asarray(eps, jnp.float32))]
    _assert_same(out[3], ref[3], (out[0], out[1], out[2], out[3][:, 0]),
                 (ref[0], ref[1], ref[2], ref[3][:, 0]))


@pytest.mark.parametrize("eps, max_exp", [(0.3, 4), (0.9, 4)])
def test_generated_kernel_3_plain_matches_jax_interpret(eps, max_exp):
    """Kernel 3's plain version with the generated functor of the
    nuts_fused_generic_10k potential against the JAX standard-layout kernel
    in interpret mode (its in-kernel vjp)."""
    fn, data, dim, _, jax_pot, traced = _traced("generic_10k")
    operands = (*data, *traced.constants)
    rng = np.random.default_rng(7 + max_exp)
    q = (0.3 * rng.normal(size=(CHAINS, dim))).astype(F32)
    p, dirs, ub, ul = _streams(rng, CHAINS, dim, max_exp)
    im = np.full(dim, 0.8, F32)

    def pg(qs):
        u, g = generic_pg.run_plain(traced.ir, qs.T.contiguous(), operands)
        return u.reshape(-1, 1), g.T

    u0, g0 = pg(torch.tensor(q))
    out = nf.nuts_transition_std_plain(
        torch.tensor(q), u0, g0, torch.tensor(im), eps, pg, max_exp=max_exp,
        momentum=torch.tensor(p), directions=torch.tensor(dirs),
        u_bias=torch.tensor(ub), u_leaf=torch.tensor(ul))
    out = [o.numpy() for o in out]
    jt = jax_std_transition(
        jax_pot, [jnp.asarray(d.numpy()) for d in data],
        max_num_expansions=max_exp, block_chains=CHAINS, interpret=True)
    ref = [np.asarray(o) for o in jt(
        jnp.asarray(q), jnp.asarray(u0.numpy()), jnp.asarray(g0.numpy()),
        jnp.asarray(p), jnp.asarray(dirs), jnp.asarray(ub), jnp.asarray(ul),
        jnp.asarray(im), eps)]
    _assert_same(out[3], ref[3], (out[0], out[1], out[2], out[3][:, 0]),
                 (ref[0], ref[1], ref[2], ref[3][:, 0]))


def test_generic_transition_through_the_public_builder():
    """``make_fused_nuts_transition_small`` on a potential_fn_t with no
    hand-written functor runs its plain version on CPU tensors (autograd),
    as the generated functor's plain back end computes it."""
    fn, data, dim, _, _, traced = _traced("dense_mvn")
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.normal(size=(dim, CHAINS)), dtype=torch.float32)
    streams = [torch.tensor(s.T.copy()) for s in _streams(rng, CHAINS, dim, 4)]
    u0, g0 = generic_pg.run_plain(traced.ir, q, data)
    imm = torch.full((dim,), 0.9)
    auto = make_fused_nuts_transition_small(
        fn, data, max_num_expansions=4, transposed_io=True)(
            q, u0, g0, *streams, imm, 0.4)
    plain = nuts_transition_plain(
        q, u0, g0, imm, 0.4, lambda x: generic_pg.run_plain(traced.ir, x,
                                                            data),
        max_exp=4, momentum=streams[0], directions=streams[1],
        u_bias=streams[2], u_leaf=streams[3])
    _assert_same(auto[3].numpy().T, plain[3].numpy().T,
                 [a.numpy() for a in auto[:3]], [b.numpy() for b in plain[:3]])


# ------------------------------------------------ the generic fused binding

def test_generic_fused_binding_equals_jax():
    """The port's binding of a per-chain logprob and the JAX package's:
    the same data rows (the closed-over tensors, flat) and the same
    potential on the same positions."""
    lp, _ = logistic_regression(DIM, POINTS, device="cpu")
    pot, rows = _generic_fused_binding(lp, DIM)
    jax_pot, jax_rows = jax_binding(_jax_logistic_lp(), DIM)
    assert sorted(tuple(r.shape) for r in rows) == sorted(
        tuple(r.shape) for r in jax_rows)
    q_t = _positions(DIM, chains=6, seed=9).astype(F32)
    port = pot(torch.tensor(q_t), *rows).numpy()
    ref = np.asarray(jax_pot(jnp.asarray(q_t), *jax_rows))
    np.testing.assert_allclose(port, ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="data rows"):
        pot(torch.tensor(q_t))
