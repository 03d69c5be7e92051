"""The generated functor's matrix exponential, thin SVD and QR (the
``mexp``, ``svd`` and ``qr`` nodes, ``csrc/generic_pg.cuh``: ``gpg_mexp``,
``gpg_svd``, ``gpg_qr``), on the CPU.

Each node runs in a functor traced as it stands (its "gradient" rows the
node's results, so every element is seen), compiled with g++ against the
emulation of a whole block (``tests/test_torch_generic_pg.py``: 8 warps of
32 threads, ``__syncwarp`` a 32-thread barrier):

- ``mexp`` at n = 4 (two matrices a warp pass, a pass of one at the end of
  an odd batch), 8 and 40 (a lane takes a second element): a matrix in each
  of ATen's six degree intervals, one beyond the last (s > 0 squarings), one
  with a NaN and one with an infinite element, against the plain back end
  (ATen's CPU ``matrix_exp`` in float32), float64 ``torch.linalg.matrix_exp``
  and ``jax.scipy.linalg.expm`` in float64;
- ``svd`` at 10 x 10, 13 x 3 and 40 x 40 (Brent and Luk's parallel order, a
  group of lanes a column pair): a random matrix, a rank-deficient one and
  one with a repeated singular value, against float64 ``torch.linalg.svd``
  and JAX's on what the sign rule does not touch: the singular values, U Vᵀ
  (full rank) and U diag(s) Uᵀ;
- ``qr`` at 10 x 3, 13 x 5 and 40 x 40 against the plain back end and JAX's
  QR in float64 (LAPACK's signs on both sides);
- U3 ``ctmc_cav`` and U4 ``ppca_qr`` whole at chip_smoke.py's sizes (20
  intervals of 2,846 transitions; 500 observations of 10 dimensions, rank
  3), their emitted gradients against ``jax.grad`` in float64.

``tests/test_torch_dense_nodes_bits.py`` holds the bit-for-bit checks
against the one-matrix bodies the redesign replaced.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.scipy.linalg import expm as jax_expm

from aehmc_tpu_torch.api import _generic_fused_binding
from aehmc_tpu_torch.ops import generic_pg
from tests import test_torch_op_table_rest as rest
from tests.test_torch_dense_linalg import needs_gxx
from tests.test_torch_generic_pg import _assert_rel, _emulate

F32 = np.float32
CHAINS = 3

# one matrix a degree interval of ATen's mexp for float (its 1-norm against
# 1.19e-7, 5.98e-4, 5.12e-2, 0.580, 1.46, 3.01), one beyond the last (s 2),
# then a NaN and an infinite element
MEXP_NORMS = (5e-8, 2e-4, 0.02, 0.3, 1.0, 2.5, 12.0)
MEXP_THETA = (1.192092800768788e-07, 5.978858893805233e-04,
              5.116619363445086e-02, 5.800524627688768e-01,
              1.461661507209034e+00, 3.010066362817634e+00)
MEXP_BATCH = len(MEXP_NORMS) + 2
# the emitted exponential against the plain back end: ATen's CPU mexp
# computes the same polynomials with BLAS products (other sums), so the two
# float32 results differ by float32 rounding grown by the squarings,
# relative to the matrix's largest element
MEXP_PLAIN_RTOL = 1e-5
# against float64 (torch and JAX): float32's Taylor polynomials and
# squarings, the same bound
MEXP_F64_RTOL = 1e-5
# the SVD's singular values, U Vᵀ and U diag(s) Uᵀ against float64, scaled
# to the largest element: one-sided Jacobi in float32 to sqrt(m) eps, a
# polar factor whose conditioning is the gap of the two smallest singular
# values (at least 0.25 here)
SVD_F64_RTOL = 3e-5
# Q and R against float64 JAX: Householder in float32 on well-conditioned
# matrices
QR_F64_RTOL = 5e-6
# U3 and U4 whole against jax.grad in float64, relative to the largest
# element: the float32 gradient through 40 exponentials of 20 intervals,
# and through a QR, LUs and an SVD, is some 2e-5 from float64 (the plain
# back end's as the emitted one's), and the two float32 ones as far apart
WHOLE_RTOL = 1e-4


def _mexp_degree(norm):
    """ATen's degree interval of a 1-norm (0-5), or 6 beyond the last."""
    for k, theta in enumerate(MEXP_THETA[:5]):
        if norm <= theta if k < 4 else norm < theta:
            return k
    return 5 if np.ceil(np.log2(norm / MEXP_THETA[5])) <= 0 else 6


def mexp_case(n, chains=CHAINS, seed=0):
    """(pg, dim, q (chains, dim)): a functor whose rows are
    ``matrix_exp`` of MEXP_BATCH n x n matrices read from q, one a norm of
    MEXP_NORMS, then one with a NaN and one with an infinite element."""
    dim = MEXP_BATCH * n * n

    def pg(q_t):
        A = q_t.T.contiguous().reshape(-1, MEXP_BATCH, n, n)
        g = torch.linalg.matrix_exp(A).reshape(-1, dim).T
        return g.sum(0), g

    rng = np.random.default_rng(seed)
    q = np.zeros((chains, MEXP_BATCH, n, n))
    for c in range(chains):
        for b in range(MEXP_BATCH):
            M = rng.standard_normal((n, n))
            norm = MEXP_NORMS[b] if b < len(MEXP_NORMS) else 1.0
            q[c, b] = M * norm / np.abs(M).sum(0).max()
    q = q.astype(F32)
    q[:, -2, 1, 0] = np.nan
    q[:, -1, 0, 1] = np.inf
    return pg, dim, q.reshape(chains, dim)


def svd_case(m, n, chains=CHAINS, seed=1):
    """(pg, dim, q): rows s, U Vᵀ and U diag(s) Uᵀ of the thin SVD of an m
    x n matrix read from q's first m n rows; chain 0 random, chain 1 of
    rank n - 1, chain 2 with singular values 3, 2, 2, 1.5, ... (a repeated
    one)."""
    dim = n + m * n + m * m

    def pg(q_t):
        A = q_t.T.contiguous()[:, :m * n].reshape(-1, m, n)
        U, S, Vh = torch.linalg.svd(A, full_matrices=False)
        out = torch.cat([S, (U @ Vh).reshape(-1, m * n),
                         ((U * S[:, None, :]) @ U.mT).reshape(-1, m * m)], 1)
        return out.sum(1), out.T

    rng = np.random.default_rng(seed)
    q = np.zeros((chains, dim))
    mats = [rng.standard_normal((m, n))]
    low = rng.standard_normal((m, n))
    low[:, -1] = low[:, :-1] @ rng.standard_normal(n - 1)
    mats.append(low)
    U, _ = np.linalg.qr(rng.standard_normal((m, n)))
    V, _ = np.linalg.qr(rng.standard_normal((n, n)))
    s = np.concatenate([[3.0, 2.0, 2.0], np.linspace(1.5, 0.5, n - 3)])[:n]
    mats.append((U * s) @ V.T)
    for c in range(chains):
        q[c, :m * n] = mats[c % 3].reshape(-1)
    return pg, dim, q.astype(F32)


def qr_case(m, n, chains=CHAINS, seed=2):
    """(pg, dim, q): rows Q and R of the reduced QR of an m x n matrix read
    from q's first m n rows (well conditioned: a random matrix plus twice
    I's first n columns)."""
    dim = m * n + n * n

    def pg(q_t):
        A = q_t.T.contiguous()[:, :m * n].reshape(-1, m, n)
        Q, R = torch.linalg.qr(A)
        out = torch.cat([Q.reshape(-1, m * n), R.reshape(-1, n * n)], 1)
        return out.sum(1), out.T

    rng = np.random.default_rng(seed)
    q = np.zeros((chains, dim))
    for c in range(chains):
        q[c, :m * n] = (rng.standard_normal((m, n))
                        + 2.0 * np.eye(m, n)).reshape(-1)
    return pg, dim, q.astype(F32)


_TRACED = {}


def traced(kind, *shape):
    """The IR of a functor-level case, its operands and q (one trace a
    case)."""
    if (kind, shape) not in _TRACED:
        pg, dim, q = {"mexp": mexp_case, "svd": svd_case,
                      "qr": qr_case}[kind](*shape)
        tr = generic_pg.trace_potential(pg, (), dim, with_grad=False)
        _TRACED[kind, shape] = (tr.ir, generic_pg.all_operands(
            tr.ir, tr.constants), q)
    return _TRACED[kind, shape]


def run(kind, shape, work, source=None):
    """(q, plain g (chains, dim), emulated g) of a functor-level case."""
    ir, operands, q = traced(kind, *shape)
    _, g = generic_pg.run_plain(ir, torch.tensor(q.T), operands)
    source = generic_pg.emit_cuda(ir) if source is None else source
    work.mkdir(parents=True, exist_ok=True)
    _, ge = _emulate(source, operands, q, work)
    return q, g.numpy().T, ge


# ----------------------------------------------- the bodies on one warp --
# A node's body called directly by the 32 threads of one emulated warp on
# a buffer the test fills (the functor's dim, which the NUTS rows bound,
# does not hold a 40 x 40 matrix's results); REFERENCE, the one-matrix
# bodies the redesign replaced (tests/test_torch_dense_nodes_bits.py), is
# compiled beside them
_BODY_MAIN = r"""
#include <cstdio>
#include <deque>
#include <thread>
#include <vector>
#include "generic_pg.cuh"
using namespace aehmc;
%s
int main() {
  int n;
  if (fread(&n, 4, 1, stdin) != 1) return 2;
  std::vector<float> buf(n);
  if (fread(buf.data(), 4, n, stdin) != (size_t)n) return 2;
  std::deque<std::barrier<>> warps;
  emu::warp[0] = &warps.emplace_back(32);
  std::vector<std::thread> threads;
  for (int t = 0; t < 32; ++t)
    threads.emplace_back([&, t] {
      threadIdx.x = t;
      const int lane = t;
      float* w = buf.data();
      %s
    });
  for (auto& t : threads) t.join();
  fwrite(buf.data(), 4, n, stdout);
  return 0;
}
"""
_BODIES = {}  # harness text -> executable, a session


def body_run(call, buf, work, extra=""):
    """The buffer after the 32 lanes of one warp ran ``call`` (C++ over
    ``float* w``, ``int lane``) on it."""
    import shutil
    import subprocess

    import tests.test_torch_generic_pg as harness
    from aehmc_tpu_torch.ops import _build

    text = _BODY_MAIN % (extra, call)
    exe = _BODIES.get(text)
    if exe is None or not exe.exists():
        work.mkdir(parents=True, exist_ok=True)
        (work / "hierarchical_pg.cuh").write_text(harness._MOCK)
        shutil.copy(_build.CSRC / "generic_pg.cuh", work / "generic_pg.cuh")
        (work / "main.cpp").write_text(text)
        exe = work / "body"
        subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                        "-pthread", "-I", str(work), "-o", str(exe),
                        str(work / "main.cpp")], check=True,
                       capture_output=True, timeout=300)
        _BODIES[text] = exe
    buf = np.ascontiguousarray(buf, F32).reshape(-1)
    out = subprocess.run([str(exe)], input=np.int32(buf.size).tobytes()
                         + buf.tobytes(), check=True, capture_output=True,
                         timeout=300).stdout
    return np.frombuffer(out, F32)


def mexp_inputs(n, seed=0):
    """MEXP_BATCH n x n matrices: mexp_case's first chain."""
    return mexp_case(n, chains=1, seed=seed)[2].reshape(MEXP_BATCH, n, n)


def mexp_bodies(n, work, reference=""):
    """(inputs, gpg_mexp's results in passes of _mexp_group matrices[, the
    reference one-matrix body's])."""
    A = mexp_inputs(n)
    nn, B = n * n, MEXP_BATCH
    G = generic_pg._mexp_group(n, B)
    passes = -(-B // G)
    scr = B * nn  # each pass's scratch after the outputs
    buf = np.full(scr + passes * G * 10 * nn, np.nan, F32)
    for b in range(B):
        p, g = divmod(b, G)
        at = scr + (p * G + g) * 10 * nn
        buf[at:at + nn] = A[b].reshape(-1)
    call = (f"for (int b = 0; b < {B}; b += {G}) gpg_mexp<{n}, {G}>(w + b * "
            f"{nn}, w + {scr} + b * {10 * nn}, b + {G} <= {B} ? {G} : {B} - "
            "b, lane);")
    if reference:
        ref = buf.size  # the reference's outputs, then 11 n^2 a matrix
        tail = np.full(B * nn + B * 11 * nn, np.nan, F32)
        for b in range(B):
            at = B * nn + b * 11 * nn + nn
            tail[at:at + nn] = A[b].reshape(-1)
        buf = np.concatenate([buf, tail])
        call += (f"\n      for (int b = 0; b < {B}; ++b) ref_mexp(w + {ref} + "
                 f"b * {nn}, w + {ref + B * nn} + b * {11 * nn}, {n}, lane);")
    out = body_run(call, buf, work, reference)
    got = out[:B * nn].reshape(B, n, n)
    if not reference:
        return A, got
    ref = out[buf.size - B * nn - B * 11 * nn:][:B * nn].reshape(B, n, n)
    return A, got, ref


def svd_inputs(m, n, seed=1):
    """svd_case's three matrices: random, rank n - 1, a repeated singular
    value."""
    q = svd_case(m, n, seed=seed)[2]
    return q[:, :m * n].reshape(CHAINS, m, n)


def svd_bodies(m, n, work):
    """(inputs, U (m x n), s, V of gpg_svd on each)."""
    A = svd_inputs(m, n)
    size = (m + 1 + n) * n + m * n + n * n + n
    buf = np.full(CHAINS * size, np.nan, F32)
    for c in range(CHAINS):
        at = c * size + (m + 1 + n) * n
        buf[at:at + m * n] = A[c].reshape(-1)
    w0 = (m + 1 + n) * n
    call = (f"for (int c = 0; c < {CHAINS}; ++c) gpg_svd<{m}, {n}, false>("
            f"w + c * {size}, w + c * {size} + {w0}, w + c * {size} + "
            f"{w0 + m * n}, w + c * {size} + {w0 + m * n + n * n}, lane);")
    out = body_run(call, buf, work).reshape(CHAINS, size)
    U = out[:, :m * n].reshape(CHAINS, m, n)
    s = out[:, m * n:(m + 1) * n]
    V = out[:, (m + 1) * n:(m + 1 + n) * n].reshape(CHAINS, n, n)
    return A, U, s, V


def qr_inputs(m, n, seed=2):
    return qr_case(m, n, seed=seed)[2][:, :m * n].reshape(CHAINS, m, n)


def qr_bodies(m, n, work, reference=""):
    """(inputs, Q over R of gpg_qr on each[, of the reference body])."""
    A = qr_inputs(m, n)
    size = (m + n) * n + m * n + n
    bodies = 2 if reference else 1
    buf = np.full(bodies * CHAINS * size, np.nan, F32)
    for k in range(bodies * CHAINS):
        at = k * size + (m + n) * n
        buf[at:at + m * n] = A[k % CHAINS].reshape(-1)
    w0 = (m + n) * n
    call = (f"for (int c = 0; c < {CHAINS}; ++c) gpg_qr<{m}, {n}>(w + c * "
            f"{size}, w + c * {size} + {w0}, w + c * {size} + "
            f"{w0 + m * n}, lane);")
    if reference:
        call += (f"\n      for (int c = {CHAINS}; c < {2 * CHAINS}; ++c) "
                 f"ref_qr(w + c * {size}, w + c * {size} + {w0}, w + c * "
                 f"{size} + {w0 + m * n}, {m}, {n}, lane);")
    out = body_run(call, buf, work, reference).reshape(bodies * CHAINS, size)
    F = out[:, :(m + n) * n].reshape(bodies * CHAINS, m + n, n)
    return (A, F[:CHAINS]) if not reference else (A, F[:CHAINS], F[CHAINS:])


def _rel_to_max(a, b, rtol, what):
    """|a - b| within rtol of b's largest element, NaN where b is."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=what)
    ok = ~np.isnan(b)
    scale = np.abs(b[ok]).max()
    err = np.abs(a[ok] - b[ok]).max() / scale
    assert err <= rtol, f"{what}: {err:.3g} of the largest element"


# ------------------------------------------------------------- mexp --

def test_mexp_cases_cover_every_degree():
    """The cases' norms fall in each of ATen's six degree intervals and
    beyond the last, at every size."""
    for n in (4, 8, 40):
        A = mexp_inputs(n).astype(np.float64)
        norms = np.abs(A).sum(axis=1).max(axis=1)
        degrees = {_mexp_degree(x) for x in norms[:len(MEXP_NORMS)]}
        assert degrees == set(range(7)), (n, degrees)
        assert not np.isfinite(norms[-2:]).any()


def _hold_mexp(A, E, what):
    """Each finite matrix's exponential against ATen's CPU mexp in float32
    (the plain back end's), float64 torch and JAX's expm in float64; NaN
    everywhere for a NaN or infinite element, as ATen's."""
    finite = len(MEXP_NORMS)
    At = torch.tensor(A)
    P = torch.linalg.matrix_exp(At).numpy()
    T64 = torch.linalg.matrix_exp(At.double()).numpy()
    J64 = np.asarray(jax.vmap(jax_expm)(jnp.asarray(A[:finite],
                                                    jnp.float64)))
    assert np.isnan(E[finite:]).all() and np.isnan(P[finite:]).all(), what
    for b in range(finite):
        at = f"{what}, norm {MEXP_NORMS[b]}"
        _rel_to_max(E[b], P[b], MEXP_PLAIN_RTOL, at + " (plain)")
        _rel_to_max(E[b], T64[b], MEXP_F64_RTOL, at + " (torch)")
        _rel_to_max(E[b], J64[b], MEXP_F64_RTOL, at + " (JAX)")


@needs_gxx
@pytest.mark.parametrize("n", [4, 8, 40])
def test_mexp_body_against_plain_torch64_and_jax(n, tmp_path):
    """gpg_mexp on the batch, in passes of _mexp_group matrices (two at 4,
    the last pass of the odd batch one), against ATen's CPU result, float64
    torch and JAX, relative to each matrix's largest element."""
    A, E = mexp_bodies(n, tmp_path)
    _hold_mexp(A, E, f"n {n}")


@needs_gxx
def test_mexp_functor_against_plain_torch64_and_jax(tmp_path):
    """The emitted node (its passes' argument copies, the body) at n = 4
    in a functor of three chains, against the plain back end and float64."""
    q, g, ge = run("mexp", (4,), tmp_path)
    for c in range(CHAINS):
        A = q[c].reshape(MEXP_BATCH, 4, 4)
        _hold_mexp(A, ge[c].reshape(MEXP_BATCH, 4, 4), f"chain {c}")
        np.testing.assert_array_equal(np.isnan(ge[c]), np.isnan(g[c]))


# -------------------------------------------------------------- svd --

def _hold_svd(A, U, s, V, what):
    """The singular values (descending), U Vᵀ (not for a rank-deficient
    matrix, whose U is not unique) and U diag(s) Uᵀ against float64 torch
    and JAX, relative to each one's largest element."""
    c = len(A)
    A64 = A.astype(np.float64)
    Ut, St, Vht = torch.linalg.svd(torch.tensor(A64), full_matrices=False)
    t64 = [St.numpy(), (Ut @ Vht).numpy(),
           ((Ut * St[:, None, :]) @ Ut.mT).numpy()]
    Uj, Sj, Vhj = jnp.linalg.svd(jnp.asarray(A64), full_matrices=False)
    j64 = [np.asarray(Sj), np.asarray(Uj @ Vhj),
           np.asarray((Uj * Sj[:, None, :]) @ jnp.swapaxes(Uj, 1, 2))]
    got = [s, U @ np.swapaxes(V, 1, 2), (U * s[:, None, :]) @ np.swapaxes(
        U, 1, 2)]
    for k in range(c):
        for i, name in enumerate(("s", "U Vᵀ", "U diag(s) Uᵀ")):
            if k % 3 == 1 and i == 1:
                continue
            at = f"{what}, matrix {k}, {name}"
            _rel_to_max(got[i][k], t64[i][k], SVD_F64_RTOL, at + " (torch)")
            _rel_to_max(got[i][k], j64[i][k], SVD_F64_RTOL, at + " (JAX)")
    assert (np.diff(s, axis=1) <= 0).all(), what


@needs_gxx
@pytest.mark.parametrize("m,n", [(10, 10), (13, 3), (40, 40)])
def test_svd_body_against_torch64_and_jax(m, n, tmp_path):
    """gpg_svd (a group of lanes a column pair: 4 lanes at 10 columns, 16
    at 3 with a column that pairs with nothing, 1 at 40) on a random, a
    rank-deficient and a repeated-singular-value matrix."""
    A, U, s, V = svd_bodies(m, n, tmp_path)
    _hold_svd(A, U, s, V, f"{m} x {n}")
    # each column of U has its largest component positive
    big = np.take_along_axis(U, np.abs(U).argmax(1)[:, None, :], 1)
    assert (big[s[:, None, :] > 0] > 0).all()


@needs_gxx
def test_svd_functor_against_torch64_and_jax(tmp_path):
    """The emitted node at 10 x 10 (U4's) in a functor of three chains."""
    q, _, ge = run("svd", (10, 10), tmp_path)
    m = n = 10
    A = q[:, :m * n].reshape(CHAINS, m, n)
    U_Vt = ge[:, n:n + m * n].reshape(CHAINS, m, n)
    USUt = ge[:, n + m * n:].reshape(CHAINS, m, m)
    Ut, St, Vht = torch.linalg.svd(torch.tensor(A.astype(np.float64)),
                                   full_matrices=False)
    for c in range(CHAINS):
        _rel_to_max(ge[c, :n], St[c].numpy(), SVD_F64_RTOL, f"s {c}")
        if c != 1:
            _rel_to_max(U_Vt[c], (Ut @ Vht)[c].numpy(), SVD_F64_RTOL,
                        f"U Vᵀ {c}")
        _rel_to_max(USUt[c], ((Ut * St[:, None, :]) @ Ut.mT)[c].numpy(),
                    SVD_F64_RTOL, f"U diag(s) Uᵀ {c}")


# --------------------------------------------------------------- qr --

@needs_gxx
@pytest.mark.parametrize("m,n", [(10, 3), (13, 5), (40, 40)])
def test_qr_body_against_plain_and_jax(m, n, tmp_path):
    """gpg_qr's Q and R against the plain back end (LAPACK's geqrf and
    orgqr in float32, the same signs) and JAX's QR in float64."""
    A, F = qr_bodies(m, n, tmp_path)
    Q, R = torch.linalg.qr(torch.tensor(A))
    _assert_rel(F, torch.cat([Q, R], 1).numpy(), QR_F64_RTOL)
    Qj, Rj = jnp.linalg.qr(jnp.asarray(A.astype(np.float64)))
    _assert_rel(F, np.concatenate([np.asarray(Qj), np.asarray(Rj)], 1),
                QR_F64_RTOL)


@needs_gxx
def test_qr_functor_against_plain_and_jax(tmp_path):
    """The emitted node at 10 x 3 (U4's) in a functor of three chains."""
    q, g, ge = run("qr", (10, 3), tmp_path)
    _assert_rel(ge, g, QR_F64_RTOL)
    A = q[:, :30].reshape(CHAINS, 10, 3).astype(np.float64)
    Qj, Rj = jnp.linalg.qr(jnp.asarray(A))
    _assert_rel(ge, np.concatenate([np.asarray(Qj).reshape(CHAINS, -1),
                                    np.asarray(Rj).reshape(CHAINS, -1)], 1),
                QR_F64_RTOL)


# ------------------------------------------------------ U3, U4 whole --

def _whole(name):
    """(the IR, its operands, the JAX float64 logprob, dim) of U3 or U4 at
    chip_smoke.py's sizes."""
    if name == "ctmc_cav":
        data = rest.ctmc_data(num_intervals=20, num_obs=2846)
        lp, jlp, dim = rest.ctmc_cav(*data), rest.jax_ctmc_cav(*data), 7
    else:
        S, W0, N = rest.ppca_data(num_obs=500, num_dim=10, rank=3)
        lp, jlp, dim = rest.ppca_qr(S, W0, N), rest.jax_ppca_qr(S, W0, N), 34
    pot, rows = _generic_fused_binding(lp, dim)
    tr = generic_pg.trace_potential(pot, rows, dim)
    return tr.ir, generic_pg.all_operands(tr.ir, (*rows, *tr.constants)), \
        jlp, dim


def whole_positions(name, dim, chains=8, seed=11):
    """q (dim, chains) at phase 56's state: 0.1·N(0, 1), U3's at its data's
    log rates."""
    q = 0.1 * np.random.default_rng(seed).standard_normal((dim, chains))
    if name == "ctmc_cav":
        q += np.log(rest.CAV_RATES)[:, None]
    return q.astype(F32)


@needs_gxx
@pytest.mark.parametrize("name", ["ctmc_cav", "ppca_qr"])
def test_whole_potential_against_jax_vjp(name, tmp_path):
    """U3's and U4's emitted potentials and gradients, 8 chains at phase
    56's state, against jax.grad in float64 and the plain back end."""
    ir, operands, jlp, dim = _whole(name)
    q = whole_positions(name, dim)
    ue, ge = _emulate(generic_pg.emit_cuda(ir), operands, q.T, tmp_path)
    _, g = generic_pg.run_plain(ir, torch.tensor(q), operands)
    _assert_rel(ge, g.numpy().T, WHOLE_RTOL)
    vg = jax.vmap(jax.value_and_grad(jlp))(jnp.asarray(q.T, jnp.float64))
    _assert_rel(-ue, np.asarray(vg[0]), WHOLE_RTOL)
    _assert_rel(-ge, np.asarray(vg[1]), WHOLE_RTOL)
