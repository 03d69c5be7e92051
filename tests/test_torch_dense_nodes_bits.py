"""The generated functor's matrix exponential and QR keep their bits
through the redesign, on the CPU (the g++ emulation of
``tests/test_torch_dense_nodes.py``'s one-warp harness and of a whole
block).

``gpg_mexp`` became a template on the matrix's size that runs several
matrices of a batch a warp pass (two 4 x 4), each with its own degree, in
nine phases; ``gpg_qr`` a template on its sizes with the same loops.
Every element keeps its terms and their order, so both equal, bit for
bit, the bodies with runtime sizes they replaced (``REFERENCE``, kept here
as they were, renamed ``ref_*``):

- the bodies on each matrix of tests/test_torch_dense_nodes.py's cases (every
  degree interval, squarings, a NaN and an infinite element; n = 4, 8, 40),
  and on its QR cases (10 x 3, 13 x 5, 40 x 40);
- the emitted nodes against the emitter's one-matrix loop they replaced, in
  a functor: the n = 4 case, the 10 x 3 QR, and U3 ``ctmc_cav`` whole (a
  batch of 20 4 x 4 exponentials and one of 20 8 x 8).

The SVD's bits change (Brent and Luk's order rotates other pairs first);
its tolerances are in tests/test_torch_dense_nodes.py.
"""

import numpy as np
import pytest

from aehmc_tpu_torch.ops import generic_pg
from tests.test_torch_dense_linalg import _bits, needs_gxx
from tests.test_torch_dense_nodes import (
    _whole,
    mexp_bodies,
    qr_bodies,
    run,
    traced,
    whole_positions,
)
from tests.test_torch_generic_pg import _emulate

# the one-matrix bodies the redesign replaced (csrc/generic_pg.cuh before
# it), renamed
REFERENCE = r"""
// ---- dense kernels of the factorisation nodes: one warp a matrix, in the
// chain's workspace, every lane calling (each ends in a __syncwarp)

// C = A B of n x n matrices, a lane an element of C, fmaf along k in order
__device__ inline void ref_mat_mul(float* C, const float* A, const float* B,
                                   int n, int lane) {
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e % n;
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc = fmaf(A[i * n + k], B[k * n + j], acc);
    C[e] = acc;
  }
  __syncwarp();
}
// out = sum_i coef[i] M_i (M_i at M + i n^2), in order from 0, as ATen's
// _compute_linear_combination; out may not be among the M_i
__device__ inline void ref_mat_comb(float* out, const float* M,
                                    const float* coef, int count, int n,
                                    int lane) {
  for (int e = lane; e < n * n; e += 32) {
    float acc = 0.f;
    for (int i = 0; i < count; ++i) acc = fmaf(coef[i], M[i * n * n + e], acc);
    out[e] = acc;
  }
  __syncwarp();
}
// out = a + b elementwise (out may be a or b)
__device__ inline void ref_mat_add(float* out, const float* a, const float* b,
                                   int n, int lane) {
  for (int e = lane; e < n * n; e += 32) out[e] = a[e] + b[e];
  __syncwarp();
}
// torch.linalg.matrix_exp of the n x n matrix at M + n^2 (ATen's mexp for
// float: the 1-norm picks Bader, Blanes and Casas's Taylor polynomial of
// degree 1, 2, 4, 8, 12 or 18, against ATen's float thresholds; beyond the
// last, A / 2^s and s squarings), into out; M holds 11 n^2 floats: I, A,
// A^2, A^3 (A^4), A^6 (A^8), five combinations and a product's buffer.  A
// NaN norm gives NaN, as ATen's (no interval takes it), and so does an
// infinite one (ATen's scale is then an int64 of +inf, whose squarings on
// the card never end)
__device__ GPG_NOINLINE inline void ref_mexp(float* out, float* M, int n,
                                             int lane) {
  const int nn = n * n;
  float* I = M;
  float* A = M + nn;
  float* A2 = M + 2 * nn;
  float* A3 = M + 3 * nn;
  float* A6 = M + 4 * nn;
  float* B = M + 5 * nn;
  float* T = M + 10 * nn;
  float norm = 0.f;
  for (int j = lane; j < n; j += 32) {
    float col = 0.f;
    for (int i = 0; i < n; ++i) col = col + fabsf(A[i * n + j]);
    norm = gpg_max(norm, col);
  }
  norm = gpg_warp_max(norm);
  for (int e = lane; e < nn; e += 32) I[e] = e / n == e % n ? 1.f : 0.f;
  __syncwarp();
  if (!(norm <= 3.4e38f)) {  // NaN or infinite: no degree or scale takes it
    for (int e = lane; e < nn; e += 32) out[e] = __int_as_float(0x7fc00000);
    __syncwarp();
    return;
  }
  const float theta[] = {1.192092800768788e-07f, 5.978858893805233e-04f,
                         5.116619363445086e-02f, 5.800524627688768e-01f,
                         1.461661507209034e+00f, 3.010066362817634e+00f};
  if (norm <= theta[0]) {
    const float c[] = {1.f, 1.f};
    ref_mat_comb(out, I, c, 2, n, lane);
    return;
  }
  ref_mat_mul(A2, A, A, n, lane);
  if (norm <= theta[1]) {
    const float c[] = {1.f, 1.f, 0.5f};
    ref_mat_comb(out, I, c, 3, n, lane);
    return;
  }
  if (norm <= theta[2]) {
    const float c[] = {1.f / 2.f, 1.f / 6.f, 1.f / 24.f};
    ref_mat_comb(B, I, c, 3, n, lane);
    ref_mat_mul(A3, A2, B, n, lane);
    const float d[] = {1.f, 1.f, 0.f, 1.f};
    ref_mat_comb(out, I, d, 4, n, lane);
    return;
  }
  if (norm <= theta[3]) {  // A3 holds A^4, A6 A^8
    const float x[] = {GPG_T8_X1, GPG_T8_X2};
    ref_mat_comb(B, A, x, 2, n, lane);
    ref_mat_mul(A3, A2, B, n, lane);
    const float u[] = {GPG_T8_X3, 1.f};
    ref_mat_comb(B, A2, u, 2, n, lane);
    const float v[] = {GPG_T8_X4, GPG_T8_X5, GPG_T8_X6, GPG_T8_X7};
    ref_mat_comb(B + nn, I, v, 4, n, lane);
    ref_mat_mul(A6, B, B + nn, n, lane);
    const float d[] = {1.f, 1.f, GPG_T8_Y2, 0.f, 1.f};
    ref_mat_comb(out, I, d, 5, n, lane);
    return;
  }
  ref_mat_mul(A3, A, A2, n, lane);
  if (norm < theta[4]) {
    const float b[4][4] = {
        {9.0198e-16f, 0.46932117595418237389f, -0.20099424927047284052f,
         -0.04623946134063071740f},
        {5.31597895759871264183f, 1.19926790417132231573f,
         0.01179296240992997031f, 0.01108844528519167989f},
        {0.18188869982170434744f, 0.05502798439925399070f,
         0.09351590770535414968f, 0.00610700528898058230f},
        {-2.0861320e-13f, -0.13181061013830184015f,
         -0.02027855540589259079f, -0.00675951846863086359f}};
    for (int i = 0; i < 4; ++i) ref_mat_comb(B + i * nn, I, b[i], 4, n, lane);
    ref_mat_mul(T, B + 3 * nn, B + 3 * nn, n, lane);
    ref_mat_add(B + 2 * nn, B + 2 * nn, T, n, lane);
    ref_mat_add(B + nn, B + nn, B + 2 * nn, n, lane);
    ref_mat_mul(T, B + nn, B + 2 * nn, n, lane);
    ref_mat_add(out, B, T, n, lane);
    return;
  }
  // degree 18 on A / 2^s, s = max(0, ceil(log2(norm / theta_18)))
  const float sc = ceilf(log2f(norm / theta[5]));
  const int s = sc > 0.f ? (int)sc : 0;
  if (s > 0) {
    const float div = ldexpf(1.f, s);
    for (int e = lane; e < nn; e += 32) A[e] = A[e] / div;
    __syncwarp();
    ref_mat_mul(A2, A, A, n, lane);
    ref_mat_mul(A3, A, A2, n, lane);
  }
  ref_mat_mul(A6, A3, A3, n, lane);
  const float b[5][5] = {
      {0.f, -1.00365581030144618291e-01f, -8.02924648241156932449e-03f,
       -8.92138498045658237863e-04f, 0.f},
      {0.f, 3.97849749499645077844e-01f, 1.36783778460411720168e+00f,
       4.98289622525382669416e-01f, -6.37898194594723280150e-04f},
      {-1.09676396052962061844e+01f, 1.68015813878906206114e+00f,
       5.71779846478865511061e-02f, -6.98210122488052056106e-03f,
       3.34975017086070470649e-05f},
      {-9.04316832390810593223e-02f, -6.76404519071381882256e-02f,
       6.75961301770459654925e-02f, 2.95552570429315521194e-02f,
       -1.39180257516060693404e-05f},
      {0.f, 0.f, -9.23364619367118555360e-02f, -1.69364939002081722752e-02f,
       -1.40086798182036094347e-05f}};
  for (int i = 0; i < 5; ++i) ref_mat_comb(B + i * nn, I, b[i], 5, n, lane);
  ref_mat_mul(T, B, B + 4 * nn, n, lane);
  ref_mat_add(B + 3 * nn, B + 3 * nn, T, n, lane);
  ref_mat_add(B + 2 * nn, B + 2 * nn, B + 3 * nn, n, lane);
  ref_mat_mul(T, B + 2 * nn, B + 3 * nn, n, lane);
  ref_mat_add(out, B + nn, T, n, lane);
  for (int p = 0; p < s; ++p) {
    ref_mat_mul(T, out, out, n, lane);
    for (int e = lane; e < nn; e += 32) out[e] = T[e];
    __syncwarp();
  }
}
// the reduced QR of the m x n (m >= n) matrix in W: Householder
// reflections with LAPACK's geqrf convention (beta = -sign(alpha) ||x||,
// tau = (beta - alpha) / beta, none where x below the diagonal is 0), then
// Q as orgqr forms it (H_0 ... H_{n-1} applied to I's first n columns,
// the last first); out holds Q (m x n) over R (n x n); tau n floats
__device__ GPG_NOINLINE inline void ref_qr(float* out, float* W, float* tau,
                                           int m, int n, int lane) {
  for (int k = 0; k < n; ++k) {
    float s = 0.f;
    for (int r = k + 1 + lane; r < m; r += 32)
      s = fmaf(W[r * n + k], W[r * n + k], s);
    s = warp_sum(s);
    const float alpha = W[k * n + k];
    float beta = alpha, tk = 0.f, scal = 1.f;
    if (s > 0.f) {
      beta = -copysignf(sqrtf(fmaf(alpha, alpha, s)), alpha);
      tk = (beta - alpha) / beta;
      scal = 1.f / (alpha - beta);
    }
    __syncwarp();  // every lane has read alpha
    for (int r = k + 1 + lane; r < m; r += 32) W[r * n + k] *= scal;
    if (lane == 0) {
      W[k * n + k] = beta;
      tau[k] = tk;
    }
    __syncwarp();
    for (int j = k + 1 + lane; j < n; j += 32) {
      float w = W[k * n + j];
      for (int r = k + 1; r < m; ++r) w = fmaf(W[r * n + k], W[r * n + j], w);
      w = w * tk;
      W[k * n + j] -= w;
      for (int r = k + 1; r < m; ++r)
        W[r * n + j] = fmaf(-w, W[r * n + k], W[r * n + j]);
    }
    __syncwarp();
  }
  for (int e = lane; e < n * n; e += 32) {
    const int i = e / n, j = e % n;
    out[(m + i) * n + j] = j >= i ? W[i * n + j] : 0.f;
  }
  for (int e = lane; e < m * n; e += 32) out[e] = e / n == e % n ? 1.f : 0.f;
  __syncwarp();
  for (int k = n - 1; k >= 0; --k) {
    for (int j = k + lane; j < n; j += 32) {
      float w = out[k * n + j];
      for (int r = k + 1; r < m; ++r) w = fmaf(W[r * n + k], out[r * n + j], w);
      w = w * tau[k];
      out[k * n + j] -= w;
      for (int r = k + 1; r < m; ++r)
        out[r * n + j] = fmaf(-w, W[r * n + k], out[r * n + j]);
    }
    __syncwarp();
  }
}
"""


def _one_matrix_mexp(self, nid, lines):
    """The emitter's matrix exponential before the redesign: a matrix a
    warp pass, its argument copied into the scratch's second matrix (11
    n^2 floats: the identity first)."""
    n = self.ir.nodes[nid]
    size = n.shape[-1]
    base = self.sched.slots[nid]
    w0 = base + generic_pg._numel(n.shape)
    scope = generic_pg._Scope(self)
    i, j = generic_pg._unflatten(generic_pg.Ix("e", size * size),
                                 (size, size))
    v = self.value(n.args[0], (self._arg_batch(nid), i, j), scope)
    body = [f"for (int e = lane; e < {size * size}; e += 32) {{",
            *("  " + line for line in scope.lines),
            f"  ws[{w0 + size * size} + e] = {v};", "}", "__syncwarp();",
            f"ref_mexp(ws + {base} + b * {size * size}, ws + {w0}, "
            f"{size}, lane);"]
    self._batch_loop(nid, lines, body)


def _one_matrix_qr(self, nid, lines):
    """The emitter's QR before the redesign, runtime sizes."""
    _, m, k = self.ir.nodes[self.ir.nodes[nid].args[0]].shape
    self._dense(nid, lines, lambda out, w: (
        f"ref_qr({out}, {w}, {w} + {m * k}, {m}, {k}, lane);"), m, k)


def _parent_text(ir, monkeypatch):
    """The functor of ``ir`` as the emitter wrote it before the redesign,
    its bodies prepended."""
    scratch = generic_pg._scratch

    def parent_scratch(ir_, n):
        if n.op == "mexp":
            return 11 * n.shape[-1] ** 2
        return scratch(ir_, n)

    with monkeypatch.context() as m:
        m.setattr(generic_pg, "_scratch", parent_scratch)
        m.setattr(generic_pg._Emitter, "mexp", _one_matrix_mexp)
        m.setattr(generic_pg._Emitter, "qr", _one_matrix_qr)
        return REFERENCE + generic_pg.emit_cuda(ir)


@needs_gxx
@pytest.mark.parametrize("n", [4, 8, 40])
def test_mexp_body_keeps_the_one_matrix_bits(n, tmp_path):
    """gpg_mexp<n, G> in passes of G matrices equals ref_mexp a matrix at
    a time, bit for bit, on every matrix (NaN's bits included)."""
    _, got, ref = mexp_bodies(n, tmp_path, REFERENCE)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@needs_gxx
@pytest.mark.parametrize("m,n", [(10, 3), (13, 5), (40, 40)])
def test_qr_body_keeps_the_runtime_size_bits(m, n, tmp_path):
    """gpg_qr<m, n> equals ref_qr (its sizes runtime values), bit for
    bit."""
    _, got, ref = qr_bodies(m, n, tmp_path, REFERENCE)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@needs_gxx
@pytest.mark.parametrize("case", ["mexp_4", "qr_10x3", "ctmc_cav"])
def test_emitted_nodes_keep_the_parent_bits(case, tmp_path, monkeypatch):
    """The emitted functor equals, bit for bit, the one the emitter wrote
    before the redesign (a matrix a pass, runtime sizes), on a functor-level
    case and on U3 whole (its potential and gradient at 8 chains)."""
    if case == "ctmc_cav":
        ir, operands, _, dim = _whole(case)
        q = whole_positions(case, dim).T
        new = generic_pg.emit_cuda(ir)
        parent = _parent_text(ir, monkeypatch)
        assert "gpg_mexp<4, 2>" in new and "gpg_mexp<8, 1>" in new
        for d in ("new", "parent"):
            (tmp_path / d).mkdir()
        got = _emulate(new, operands, q, tmp_path / "new")
        want = _emulate(parent, operands, q, tmp_path / "parent")
    else:
        kind, shape = ("mexp", (4,)) if case == "mexp_4" else ("qr", (10, 3))
        ir = traced(kind, *shape)[0]
        parent = _parent_text(ir, monkeypatch)
        got = run(kind, shape, tmp_path / "new")[2:]
        want = run(kind, shape, tmp_path / "parent", parent)[2:]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(_bits(a), _bits(b))
