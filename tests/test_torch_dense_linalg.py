"""The generated functor's dense linear algebra above a warp's width, on
the CPU.

The emitted functor's Cholesky factor, triangular solves, LU solves,
log-determinants and LU factors (``ops/generic_pg.py``: ``chol``,
``trsolve``, ``lusolve``, ``slogdet``, ``lufactor``), compiled with g++
against the emulation of a whole block (``tests/test_torch_generic_pg.py``:
8 warps of 32 threads, ``__syncwarp`` a 32-thread barrier), 8 chains at
once, at n = 40 and n = 64 points, where a lane takes a second row or
column (``r += 32``):

- S1 ``gp_se64`` (a Cholesky factor, one-column solves on the factor and
  through its transpose, 64-column solves through its transpose) and S2
  ``gp_se64_logdet`` (LU solves of one and of n columns, a log-determinant),
  a case of triangular solves of n right sides on a data factor (lower, and
  upper through a transpose) and of one (upper, stored as such), and a case
  of ``lu_factor`` with ``lu_solve``, each against the plain back end, with
  the dense nodes' matrices in a factor scratch in shared memory and in the
  workspace, whichever the geometry's rule would choose;
- S1 and S2 at 64 points against ``jax.vjp`` in float64;
- the geometry of S1's and S2's factor scratch and its rule.

``tests/test_torch_dense_linalg_bits.py`` holds the same cases' bit-for-bit
checks of the orders of terms the redesign keeps.
"""

import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu_torch.api import _generic_fused_binding
from aehmc_tpu_torch.ops import generic_pg
from aehmc_tpu_torch.ops import launch_plan as lp
from tests.test_torch_generic_pg import EMITTED_RTOL, _assert_rel, _emulate
from tests.test_torch_op_table_last import gp_data, gp_se, jax_gp_se

F32 = np.float32

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="needs g++ to compile the functor")

# S1 and S2 at 64 points against jax.vjp in float64: the emulated float32
# Cholesky, LU and substitutions of a 64 x 64 kernel matrix whose condition
# number at 0.3·N(0, 1) starts is about 1e2, so about 1e2 float32 ulp
JAX_RTOL = 1e-4


TRI_DIM = 4


def _tri_t(q_t, L, U, W, V, C):
    """Triangular solves of a chain's n right sides B = W + sum_k q_k V_k
    (lower on L, and upper on Lᵀ through a transpose) and of one, C q
    (upper on U, stored upper); ``q_t`` is (TRI_DIM, chains)."""
    n = L.shape[0]
    B = W + (q_t.T @ V.reshape(TRI_DIM, n * n)).reshape(-1, n, n)
    X = torch.linalg.solve_triangular(L, B, upper=False)
    Y = torch.linalg.solve_triangular(L.T, B, upper=True)
    z = torch.linalg.solve_triangular(U, C @ q_t, upper=True)
    return 0.5 * (torch.sum(X * X, dim=(1, 2)) + torch.sum(Y * Y, dim=(1, 2))
                  + torch.sum(z * z, dim=0))


def _tri_data(n, seed=3):
    rng = np.random.default_rng(seed)
    L = np.tril(0.3 * rng.standard_normal((n, n)) / np.sqrt(n), -1) \
        + np.diag(1.0 + rng.uniform(size=n))
    W = 0.5 * rng.standard_normal((n, n))
    V = 0.5 * rng.standard_normal((TRI_DIM, n, n))
    C = rng.standard_normal((n, TRI_DIM))
    return tuple(torch.tensor(a, dtype=torch.float32)
                 for a in (L, np.ascontiguousarray(L.T), W, V, C))


def _lu_t(q_t, M):
    """getrf and getrs of a matrix that depends on q, and its
    log-determinant: a chain's A = M + diag(q)."""
    A = M + torch.diag_embed(q_t.T)
    LU, piv = torch.linalg.lu_factor(A)
    z = torch.linalg.lu_solve(LU, piv, q_t.T[:, :, None])
    return 0.5 * torch.sum(z * z, dim=(1, 2)) \
        - 0.1 * torch.linalg.slogdet(A)[1]


def _lu_data(n, seed=4):
    """M = 3 Q D: Q a random orthogonal matrix (its LU pivots), D diagonal
    in [1, 2], so M + diag(q) is well conditioned at small q."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (torch.tensor(3.0 * Q * (1.0 + rng.uniform(size=n)),
                         dtype=torch.float32),)


def _case(name, n):
    """(potential, its data, dim) of a case at n."""
    if name in ("gp_se64", "gp_se64_logdet"):
        x, y = gp_data(n, seed=1)
        pot, rows = _generic_fused_binding(
            gp_se(x, y, logdet=name == "gp_se64_logdet"), 3)
        return pot, tuple(rows), 3
    if name == "tri":
        return _tri_t, _tri_data(n), TRI_DIM
    return _lu_t, _lu_data(n), n


_TRACED = {}


def _traced(name, n):
    if (name, n) not in _TRACED:
        pot, data, dim = _case(name, n)
        _TRACED[name, n] = (generic_pg.trace_potential(pot, data, dim),
                            data, dim)
    return _TRACED[name, n]


def _run(name, n, tmp_path, source=None, chains=8, seed=11):
    """(q, plain u, g, emulated u, g) of ``chains`` chains at
    0.3·N(0, 1)."""
    traced, data, dim = _traced(name, n)
    ir = traced.ir
    operands = generic_pg.all_operands(ir, (*data, *traced.constants))
    rng = np.random.default_rng(seed)
    q = (0.3 * rng.standard_normal((chains, dim))).astype(F32)
    u, g = generic_pg.run_plain(ir, torch.tensor(q.T), operands)
    source = generic_pg.emit_cuda(ir) if source is None else source
    tmp_path.mkdir(exist_ok=True)
    ue, ge = _emulate(source, operands, q, tmp_path)
    return q, u.numpy().reshape(-1), g.numpy().T, ue, ge


def _ops(name, n):
    return {nd.op for nd in _traced(name, n)[0].ir.nodes}


def _bits(a):
    return np.ascontiguousarray(a, F32).view(np.uint32)


CASES = ["gp_se64", "gp_se64_logdet", "tri", "lu"]


def _place(monkeypatch, shared):
    """The dense nodes' matrices in a factor scratch wherever one block
    holds it (``shared``), or in the workspace, whatever the geometry's
    rule would choose."""
    one_block = lp.generic_factor_shared

    def rule(dim, factor, fixed=0, lu=False):
        return shared and one_block(dim, factor, fixed, True)
    monkeypatch.setattr(lp, "generic_factor_shared", rule)


@needs_gxx
@pytest.mark.parametrize("shared", [True, False],
                         ids=["factor_scratch", "workspace"])
@pytest.mark.parametrize("n", [40, 64])
@pytest.mark.parametrize("name", CASES)
def test_dense_nodes_against_plain(name, n, shared, tmp_path, monkeypatch):
    """Each case's emitted functor against the plain back end at
    EMITTED_RTOL, its dense nodes in the factor scratch or, with the
    scratch refused, in the workspace."""
    _place(monkeypatch, shared)
    traced, _, dim = _traced(name, n)
    ir = traced.ir
    source = generic_pg.emit_cuda(ir)
    fs = int(source.split("FS_FLOATS = ")[1].split(";")[0])
    # the nodes whose matrices one block holds (tri at 64: its 64-column
    # solves' factor and 64 columns of solutions a lane pair do not fit)
    fit = [f for f in map(lambda i: generic_pg._factor_need(ir, i),
                          range(len(ir.nodes)))
           if lp.generic_factor_shared(dim, f, 0, True)]
    assert fs == (max(fit) if shared and fit else 0)
    assert fs > 0 or not shared or (name, n) == ("tri", 64)
    want = {"gp_se64": {"chol", "trsolve"},
            "gp_se64_logdet": {"lusolve", "slogdet"},
            "tri": {"trsolve"}, "lu": {"lufactor", "lusolve", "slogdet"}}
    assert want[name] <= _ops(name, n)
    _, u, g, ue, ge = _run(name, n, tmp_path, source)
    _assert_rel(ue, u, EMITTED_RTOL)
    _assert_rel(ge, g, EMITTED_RTOL)


@needs_gxx
def test_solve_orientations_at_64(tmp_path):
    """The triangular case at 64: its n-column solves a lane a column (no
    butterfly), its one-column solve on the factor stored upper row by row
    (the lanes along the row, a ``warp_sum`` a row), and the one-column
    solves of the backward through a transpose a column at a time (the
    lanes down the stored rows, a shuffle a column)."""
    ir = _traced("tri", 64)[0].ir
    solves = [nd for nd in ir.nodes if nd.op == "trsolve"]
    assert {nd.shape[-1] for nd in solves} == {1, 64}
    source = generic_pg.emit_cuda(ir)
    assert "for (int c0 = 0; c0 < 64; c0 += 64) {" in source
    assert "acc = warp_sum(acc);" in source
    assert "__shfl_sync(FULL, x" in source
    _, u, g, ue, ge = _run("tri", 64, tmp_path, source)
    _assert_rel(ge, g, EMITTED_RTOL)


@needs_gxx
@pytest.mark.parametrize("name", ["gp_se64", "gp_se64_logdet"])
def test_s1_s2_at_64_points_against_jax_vjp(name, tmp_path):
    """S1 and S2 at 64 points: the emulated functor's potential and
    gradient against JAX's value and gradient of the same density in
    float64 (the potential is minus the log density)."""
    q, _, _, ue, ge = _run(name, 64, tmp_path)
    x, y = gp_data(64, seed=1)
    lp = jax_gp_se(x, y, logdet=name == "gp_se64_logdet")
    ju, jg = jax.vmap(jax.value_and_grad(lp))(jnp.asarray(q, jnp.float64))
    _assert_rel(ue, -np.asarray(ju), JAX_RTOL)
    _assert_rel(ge, -np.asarray(jg), JAX_RTOL)


@pytest.mark.parametrize("name,factor", [("gp_se64", 64 * 65),
                                         ("gp_se64_logdet",
                                          64 * 65 + 64 + 32 * 64)])
def test_factor_scratch_geometry(name, factor, monkeypatch):
    """S1's and S2's working matrices at 64 points take more than two NUTS
    blocks an SM leave.  S2, which factors LUs, keeps them in the factor
    scratch (its LU solve's factor at stride 65, its 64 pivots and a warp's
    32 columns of solutions) at one block an SM, within the block's limit,
    for kernels 1-4 and 5-7 alike; S1 (a Cholesky factor and solves) keeps
    them in the workspace at two blocks an SM, and takes the scratch only
    when asked, for its factor (a 64-column solve's factor and 64 columns
    of solutions a lane pair do not fit one block)."""
    ir = _traced(name, 64)[0].ir
    lu = name == "gp_se64_logdet"
    geo = generic_pg.geometry_of(ir)
    assert geo.factor_floats == (factor if lu else 0) and not geo.ws_shared
    _place(monkeypatch, True)
    geo = generic_pg.geometry_of(ir)
    assert geo.factor_floats == factor
    for core, k in (("nuts", 4), ("hmc", 0)):
        plan = lp.launch_plan(core, 3, k, 1024, functor="generic",
                              geometry=geo)
        rows = lp.CORES[core][0] * 8 * lp.state_stride(3)
        assert plan.smem == 4 * (rows + geo.scratch_floats())
        assert plan.smem <= lp.SMEM_LIMIT
        assert not lp.two_blocks_fit(plan.smem) or core == "hmc"
    _place(monkeypatch, False)
    glob = generic_pg.geometry_of(ir)
    assert glob.factor_floats == 0
    plan = lp.launch_plan("nuts", 3, 4, 1024, functor="generic",
                          geometry=glob)
    assert lp.two_blocks_fit(plan.smem)


def test_factor_scratch_takes_the_largest_that_fits():
    """The geometry takes the largest of the nodes' needs that fits: with
    an LU, one NUTS block; without, two (a node that needs more works in
    the workspace); none where the workspace itself is shared."""
    needs = (400, 4_000, 6_000, 60_000)
    assert lp.generic_geometry(3, 100_000, (), {}, needs,
                               lu=True).factor_floats == 6_000
    assert lp.generic_geometry(3, 100_000, (), {}, needs).factor_floats \
        == 400
    assert lp.generic_geometry(3, 100_000, (), {}, ()).factor_floats == 0
    small = lp.generic_geometry(3, 50, (), {}, (4_000,), lu=True)
    assert small.ws_shared and small.factor_floats == 0

