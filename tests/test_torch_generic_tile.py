"""The generated functor's data tile and resident operands, on the CPU.

- The launch plan's geometry of a generated functor
  (``launch_plan.generic_geometry``): which operands are resident, which
  are streamed through the tile, its rows a chunk (a multiple of 32), its
  odd row stride, the block's shared memory and blocks an SM, and where the
  workspace goes, at the flagship's shapes and at P1-P4's.
- The emitted, tiled functor compiled with g++ against the emulation of a
  whole block (``tests/test_torch_generic_pg.py:_emulate``: 8 warps of 32
  threads, ``__syncthreads`` a 256-thread barrier, the asynchronous copy a
  plain copy that the wait and the barrier order), 8 chains at once,
  against the plain back end in float32 (``generic_pg.run_plain``) at the
  emulation tests' tolerance: the flagship's traced logistic (1,000 x 100,
  its X streamed, y resident; also against JAX), P2 and P4 at full width,
  an operand whose last chunk is ragged with one lane a row (the odd
  stride's case), two streamed operands in one gradient, a resident
  factor read inside a triangular solve, and a factorisation that reads its
  operand from global memory.
- Block barriers: every ``chunk_ready`` of an emitted functor sits at its
  top level, and the emitter refuses to put one in a loop whose trip count
  depends on a chain's values.
"""

import re
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu_torch.api import _generic_fused_binding
from aehmc_tpu_torch.models import correlated_mvn, logistic_regression_data
from aehmc_tpu_torch.ops import generic_pg
from aehmc_tpu_torch.ops import launch_plan as lp
from tests.test_torch_generic_ops import (
    hier_negbin,
    jax_probit,
    mixture4,
    mixture_data,
    negbin_data,
    probit,
)
from tests.test_torch_generic_pg import EMITTED_RTOL, _assert_rel, _emulate

F32 = np.float32

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="needs g++ to compile the functor")


def _flagship_t(points=1000, dim=100):
    """The flagship's potential with X and y closed over, as a user's bare
    function (chip_smoke.py: generic_potentials' flagship_t)."""
    X, y = logistic_regression_data(dim, points, device="cpu")
    y_col = y.reshape(-1, 1)

    def pot_t(q_t):
        logits = X @ q_t
        return (-torch.sum(y_col * logits - torch.nn.functional.softplus(
            logits), dim=0) + 0.5 * torch.sum(q_t * q_t, dim=0))

    return pot_t, X, y


def _logistic_t(q_t, Xd, yd):
    logits = Xd @ q_t
    return (-torch.sum(yd * logits - torch.nn.functional.softplus(logits),
                       dim=0) + 0.5 * torch.sum(q_t * q_t, dim=0))


def _two_designs_t(q_t, X1, X2, yd):
    """Two streamed designs in one gradient: logits X1 q[:d1] + X2 q[d1:]."""
    d1 = X1.shape[1]
    logits = X1 @ q_t[:d1] + X2 @ q_t[d1:]
    return (-torch.sum(yd * logits - torch.nn.functional.softplus(logits),
                       dim=0) + 0.5 * torch.sum(q_t * q_t, dim=0))


def _solve_t(q_t, A):
    """A factorisation on a data operand too large to be resident: z =
    A⁻¹ q by LU with partial pivoting, U = ½ |z|² + ½ |q|²."""
    z = torch.linalg.solve(A, q_t)
    return 0.5 * torch.sum(z * z, dim=0) + 0.5 * torch.sum(q_t * q_t, dim=0)


def _design(points, dim, seed, scale=0.3):
    rng = np.random.default_rng(seed)
    X = torch.tensor(scale * rng.standard_normal((points, dim)),
                     dtype=torch.float32)
    y = torch.tensor((rng.uniform(size=(points, 1)) < 0.5).astype(F32))
    return X, y


def _emulated_vs_plain(bound, data, dim, tmp_path, chains=8, seed=11,
                       scale=0.3):
    """The emulated block's potentials and gradients of ``chains`` chains
    against the plain back end's, at EMITTED_RTOL; returns them."""
    operands = generic_pg.all_operands(bound.ir, (*data, *bound.constants))
    rng = np.random.default_rng(seed)
    q = (scale * rng.standard_normal((chains, dim))).astype(F32)
    u, g = generic_pg.run_plain(bound.ir, torch.tensor(q.T), operands)
    ue, ge = _emulate(bound.source, operands, q, tmp_path)
    _assert_rel(ue, u.numpy().reshape(-1), EMITTED_RTOL)
    _assert_rel(ge, g.numpy().T, EMITTED_RTOL)
    return q, ue, ge


def _top_level_barriers(source):
    """Every line of the functor's body that waits for a chunk opens a
    chunk loop at the body's top level (indent 4: the loop, 6: its wait),
    or in a window pass's loop over its windows (indent 4: that loop, 6:
    the chunk loop, 8: the wait): loops with fixed trip counts."""
    body = source[source.index("operator()"):]
    for m in re.finditer(r"^( *)chunk_ready\(\);$", body, re.M):
        before = body[:m.start()].rstrip().splitlines()
        assert before[-1].strip().startswith("for (int ch = 0; ch < "), \
            before[-1]
        if len(m.group(1)) == 8:
            outer = next(ln for ln in reversed(before[:-1])
                         if ln.startswith("    for ("))
            assert outer.startswith("    for (int gi = 0; gi < "), outer
        else:
            assert len(m.group(1)) == 6, m.group(0)


# ------------------------------------------------------- the geometry ----

def test_flagship_geometry():
    """The flagship's traced functor (dim 100, 1,000 x 100 X, y): y
    resident, X streamed 64 rows a chunk at an odd row stride of 101, two
    NUTS blocks an SM, the 2,100-float workspace in global memory; the HMC
    plan takes the same geometry with its 8 rows."""
    pot_t, _, _ = _flagship_t()
    bound = generic_pg.bind(pot_t, (), 100)
    geo = bound.geometry
    assert [geo.kind(j) for j in range(2)] == ["streamed", "resident"]
    assert geo.streamed == ((0, 100, 101),) and geo.points == 64
    assert geo.row_stride % 2 == 1 and geo.points % 32 == 0
    assert geo.tile_floats == 64 * 101 and geo.resident_floats == 1000
    assert not geo.ws_shared and geo.workspace == 2100
    nuts = lp.launch_plan("nuts", 100, 6, 10_240, functor="generic",
                          geometry=geo)
    hmc = lp.launch_plan("hmc", 100, 0, 10_240, functor="generic",
                         geometry=geo)
    extra = 8 + 1000 + 2 * 64 * 101
    assert nuts.smem == 4 * (17 * 8 * 100 + extra) == 110_144
    assert hmc.smem == 4 * (8 * 8 * 100 + extra)
    assert lp.two_blocks_fit(nuts.smem) and lp.two_blocks_fit(hmc.smem)
    assert (nuts.points, nuts.row_stride) == (hmc.points, hmc.row_stride) \
        == (64, 101)
    assert lp.generic_workspace_floats(geo, nuts.blocks) == \
        nuts.blocks * 8 * 2100
    for name in ("TILE_ROWS = 64", "TILE_STRIDE = 101", "TILE_FLOATS = 6464",
                 "RES_FLOATS = 1000", "WS_SHARED = false"):
        assert name in bound.source


@pytest.mark.parametrize("name,dim,want", [
    ("mvn25_chol", 25, dict(resident=3, streamed=0, ws_shared=True)),
    ("hier_negbin", 89, dict(resident=None, streamed=0, ws_shared=False)),
    ("mixture4", 12, dict(resident=None, streamed=0, ws_shared=None)),
    ("probit100", 100, dict(resident=1, streamed=1, ws_shared=False)),
])
def test_op_table_geometries(name, dim, want):
    """P1-P4 at full width: P1's rows (its 25 x 25 factor among them), P2's
    index and count rows and P3's 1,000 points resident, P4's 1,000 x 100
    design streamed at 64 rows a chunk and its y resident, every plan two
    blocks an SM."""
    if name == "mvn25_chol":
        lp_fn = correlated_mvn(25, 0.5, device="cpu")
    elif name == "hier_negbin":
        group, x, y = negbin_data()
        lp_fn = hier_negbin(group, x, y, 85)
    elif name == "mixture4":
        lp_fn = mixture4(mixture_data())
    else:
        X, y = logistic_regression_data(100, 1000, device="cpu")
        lp_fn = probit(X, y)
    pot, rows = _generic_fused_binding(lp_fn, dim)
    bound = generic_pg.bind(pot, rows, dim)
    geo = bound.geometry
    kinds = [geo.kind(j) for j in range(len(bound.ir.data_shapes))]
    n_res = kinds.count("resident")
    assert n_res == (want["resident"] if want["resident"] is not None
                     else len(kinds))
    assert kinds.count("streamed") == want["streamed"]
    if want["ws_shared"] is not None:
        assert geo.ws_shared == want["ws_shared"]
    if geo.streamed:
        assert geo.points == 64 and geo.row_stride == 101
    else:
        assert (geo.points, geo.row_stride, geo.tile_floats) == (0, 0, 0)
    for core, k in (("nuts", 6), ("hmc", 0)):
        plan = lp.launch_plan(core, dim, k, 4096, functor="generic",
                              geometry=geo)
        assert lp.two_blocks_fit(plan.smem), (core, plan.smem)
        assert (plan.points, plan.row_stride) == (geo.points,
                                                  geo.row_stride)
    offs = [off for _, off, _ in geo.resident]
    assert all(off % 4 == 0 for off in offs) and offs == sorted(offs)


@pytest.mark.parametrize("dim,row,points,two", [
    (10, 10, 128, True), (100, 100, 64, True), (40, 64, 128, True),
    (200, 200, 64, False), (250, 250, 32, False)])
def test_tile_rows_and_odd_stride(dim, row, points, two):
    """The most rows (128, 64, 32) with which two NUTS blocks fit (where
    none does, one block up to the block's limit), a row stride that is
    the row rounded up to an odd number of words, and the block's shared
    memory exactly the rows, potentials and two buffers."""
    geo = lp.generic_geometry(dim, 0, (100_000,), {0: row})
    assert geo.points == points and geo.streamed == ((0, row, row | 1),)
    assert geo.row_stride % 2 == 1
    assert geo.tile_floats == 4 * -(-points * (row | 1) // 4)
    smem = lp.smem_bytes("nuts", dim, 0, functor="generic", geometry=geo)
    assert smem == 4 * (17 * 8 * lp.state_stride(dim) + 8
                        + 2 * geo.tile_floats)
    assert lp.two_blocks_fit(smem) == two and smem <= lp.SMEM_LIMIT
    if points < 128:  # twice the rows do not fit where these do
        bigger = 2 * 4 * (4 * -(-2 * points * (row | 1) // 4))
        more = smem - 8 * geo.tile_floats + bigger
        assert (not lp.two_blocks_fit(more)) if two else \
            more > lp.SMEM_LIMIT


def test_operands_left_in_global_memory():
    """At dim 400 the NUTS rows (217,632 bytes) leave no room for a 32-row
    tile of 401-word rows: the operand stays in global memory, with no
    tile.  Beyond the block's limit, the geometry raises with the bytes it
    needs."""
    geo = lp.generic_geometry(400, 0, (400_000,), {0: 400})
    assert geo.kind(0) == "global" and geo.points == 0
    assert geo.tile_floats == 0 and geo.row_stride == 0
    with pytest.raises(ValueError, match="bytes of shared memory"):
        lp.generic_geometry(1000, 0, (), {})


def test_residents_smallest_first_and_workspace_after():
    """Operands go resident smallest first while two NUTS blocks still fit
    beside the smallest tile the streamable rest needs, at 4-float offsets;
    the workspace goes to shared memory only where two blocks still fit
    with it too."""
    geo = lp.generic_geometry(25, 50, (625, 25, 1, 30_000), {3: 100})
    assert [j for j, *_ in geo.resident] == [2, 1, 0]
    assert [off for _, off, _ in geo.resident] == [0, 4, 32]
    assert geo.kind(3) == "streamed" and geo.ws_shared
    big = lp.generic_geometry(25, 5000, (625, 25, 1, 30_000), {3: 100})
    assert not big.ws_shared
    assert big.resident == geo.resident


# ------------------------------------------- the emulated, tiled functor --

@needs_gxx
def test_flagship_tiled_functor_against_plain_and_jax(tmp_path):
    """The flagship's traced functor, X streamed in 16 chunks of 64 rows
    (the last 40) through both products (X·q one warp-each pass, Xᵀr one
    chunk-major sum pass), y resident: 8 chains at once against the plain
    back end, and against JAX's value and gradient of the same potential."""
    pot_t, X, y = _flagship_t()
    bound = generic_pg.bind(pot_t, (), 100)
    assert bound.source.count("for (int ch = 0; ch < 16; ++ch)") == 2
    assert "R1[" in bound.source and "__ldg(D0" not in bound.source
    _top_level_barriers(bound.source)
    q, ue, ge = _emulated_vs_plain(bound, (), 100, tmp_path)
    Xj, yj = jnp.asarray(X.numpy()), jnp.asarray(y.numpy())

    def jax_u(w):
        logits = Xj @ w
        return -jnp.sum(yj * logits - jax.nn.softplus(logits)) + 0.5 * \
            jnp.sum(w * w)

    ju, jg = jax.vmap(jax.value_and_grad(jax_u))(jnp.asarray(q))
    _assert_rel(ue, np.asarray(ju), 1e-4)
    _assert_rel(ge, np.asarray(jg), 1e-4)


@needs_gxx
@pytest.mark.parametrize("name", ["hier_negbin", "probit100"])
def test_op_table_tiled_functor(name, tmp_path):
    """P2 (919 observations, 85 counties: its index, covariate and count
    rows resident; the scatter-add of its gather's backward) and P4 (its
    1,000 x 100 design streamed by X·q, and by the warp-each backward
    product, whose lanes sum along the rows, 4 windows of 25 columns at a
    time) at full width, 8 chains at once against the plain back end."""
    if name == "hier_negbin":
        group, x, y = negbin_data()
        lp_fn, dim = hier_negbin(group, x, y, 85), 89
    else:
        X, y = logistic_regression_data(100, 1000, device="cpu")
        lp_fn, dim = probit(X, y), 100
    pot, rows = _generic_fused_binding(lp_fn, dim)
    bound = generic_pg.bind(pot, rows, dim)
    if name == "probit100":
        assert bound.geometry.kind(0) == "streamed"
        assert "__ldg(D0" not in bound.source
        assert "for (int gi = 0; gi < 4; ++gi)" in bound.source
        assert "fill<100, 25, 25>" in bound.source
    else:
        assert not bound.geometry.streamed and "__ldg(" not in bound.source
    _top_level_barriers(bound.source)
    _emulated_vs_plain(bound, rows, dim, tmp_path, scale=0.1)


@needs_gxx
def test_probit_tiled_functor_against_jax(tmp_path):
    """P4's emulated gradient against JAX's (float64) on the same design."""
    X, y = logistic_regression_data(100, 1000, device="cpu")
    pot, rows = _generic_fused_binding(probit(X, y), 100)
    bound = generic_pg.bind(pot, rows, 100)
    q, ue, ge = _emulated_vs_plain(bound, rows, 100, tmp_path, scale=0.1)
    ju, jg = jax.vmap(jax.value_and_grad(jax_probit(X, y)))(
        jnp.asarray(q, jnp.float64))
    _assert_rel(ue, -np.asarray(ju), 1e-4)
    _assert_rel(ge, -np.asarray(jg), 1e-4)


@needs_gxx
def test_ragged_last_chunk_one_lane_a_row(tmp_path):
    """At dim 10 over 3,000 points X·q runs one lane a row (the sum of 10
    terms in each lane), chunked 128 rows at a time, the last chunk 56
    rows, the lanes of a warp reading 32 rows 11 words apart; the backward
    product sums along the rows in the warp's lanes, its 10 outputs one
    window."""
    X, y = _design(3000, 10, seed=3)
    bound = generic_pg.bind(_logistic_t, (X, y), 10)
    geo = bound.geometry
    assert geo.streamed == ((0, 10, 11),) and geo.points == 128
    assert 3000 % geo.points == 56
    assert "for (int i = c0 + lane; i < c1; i += 32)" in bound.source
    assert "T[(i - c0) * 11 + k]" in bound.source
    _top_level_barriers(bound.source)
    _emulated_vs_plain(bound, (X, y), 10, tmp_path, chains=13)


@needs_gxx
def test_two_streamed_operands_in_one_gradient(tmp_path):
    """Two 1,500 x 40 designs, each streamed: X1·q and X2·q two passes, the
    two backward products two sum passes of one group, the call's 48 fills
    in one sequence through the two buffers."""
    X1, y = _design(1500, 40, seed=4)
    X2, _ = _design(1500, 40, seed=5)
    bound = generic_pg.bind(_two_designs_t, (X1, X2, y), 80)
    geo = bound.geometry
    assert [geo.kind(j) for j in range(3)] == ["streamed", "streamed",
                                               "resident"]
    assert geo.points == 128 and geo.row_stride == 41
    assert "; 48 tile fills a call)" in bound.source
    assert bound.source.count("chunk_ready();") == 4
    _top_level_barriers(bound.source)
    _emulated_vs_plain(bound, (X1, X2, y), 80, tmp_path)


@needs_gxx
def test_resident_factor_read_inside_a_triangular_solve(tmp_path):
    """P1 (the package's correlated MVN at dim 25): its rows, the 25 x 25
    Cholesky factor among them, resident and read from shared memory by the
    row-by-row substitution, no tile."""
    pot, rows = _generic_fused_binding(correlated_mvn(25, 0.5, device="cpu"),
                                       25)
    bound = generic_pg.bind(pot, rows, 25)
    assert all(bound.geometry.kind(j) == "resident"
               for j in range(len(bound.ir.data_shapes)))
    assert "__ldg(" not in bound.source and "chunk_ready" not in bound.source
    _emulated_vs_plain(bound, rows, 25, tmp_path, chains=10)


@needs_gxx
def test_factorisation_keeps_global_reads(tmp_path):
    """A general solve on a 120 x 120 data matrix, too large to be resident
    beside the NUTS rows at dim 120: its LU reads the operand from global
    memory (``__ldg``), inside loops whose pivots depend on the values, and
    no tile or block barrier is emitted for it."""
    rng = np.random.default_rng(6)
    A = torch.tensor(np.eye(120) * 3.0 + 0.2 * rng.standard_normal(
        (120, 120)), dtype=torch.float32)
    bound = generic_pg.bind(_solve_t, (A,), 120)
    assert bound.geometry.kind(0) == "global"
    assert "__ldg(D0" in bound.source and "chunk_ready" not in bound.source
    assert "lusolve" in bound.source.splitlines()[2]
    _emulated_vs_plain(bound, (A,), 120, tmp_path)


def test_emission_refuses_a_barrier_in_a_value_dependent_loop():
    """The emitter places a chunk's wait and block barrier only in a group
    whose loops have fixed trip counts (a loop or warp-each group at the
    functor's top level); asked for one in a factorisation's group, whose
    pivots depend on the chain's values, it raises."""
    rng = np.random.default_rng(6)
    A = torch.tensor(np.eye(40) * 3.0 + 0.2 * rng.standard_normal((40, 40)),
                     dtype=torch.float32)
    traced = generic_pg.trace_potential(_solve_t, (A,), 40)
    geo = lp.generic_geometry(40, generic_pg.schedule(traced.ir).workspace,
                              (1600,), {0: 40})
    em = generic_pg._Emitter(traced.ir, generic_pg.schedule(traced.ir), geo)
    em.plan()
    sig = next(sig for sig, _ in em.groups() if sig[0] == "lusolve")
    with pytest.raises(ValueError, match="block barrier inside 'lusolve'"):
        em.chunk_loop(sig, 0, [], [])


_SUMS_MAIN = r'''
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>
#include "generic_pg.cuh"
using namespace aehmc;
// warp 0's 32 lanes: N values each, from stdin; each lane writes the
// value gpg_warp_sums returns, then warp_sum of each value in turn
template <int N>
void run(const std::vector<float>& in, float* out) {
  std::vector<std::thread> lanes;
  for (int l = 0; l < 32; ++l)
    lanes.emplace_back([&, l] {
      threadIdx.x = l;
      float v[N];
      for (int u = 0; u < N; ++u) v[u] = in[l * N + u];
      out[l] = gpg_warp_sums<N>(v, l);
      for (int u = 0; u < N; ++u)
        out[32 + u * 32 + l] = warp_sum(in[l * N + u]);
    });
  for (auto& t : lanes) t.join();
}
int main() {
  std::barrier<> w(32), b(256);
  for (int i = 0; i < 8; ++i) emu::warp[i] = &w;
  emu::block = &b;
  int n;
  if (fread(&n, 4, 1, stdin) != 1) return 2;
  std::vector<float> in(32 * n), out(32 + 32 * n);
  if (fread(in.data(), 4, in.size(), stdin) != in.size()) return 2;
  switch (n) {
    case 1: run<1>(in, out.data()); break;
    case 2: run<2>(in, out.data()); break;
    case 4: run<4>(in, out.data()); break;
    case 8: run<8>(in, out.data()); break;
    case 16: run<16>(in, out.data()); break;
    case 32: run<32>(in, out.data()); break;
    default: return 3;
  }
  fwrite(out.data(), 4, out.size(), stdout);
  return 0;
}
'''


@needs_gxx
def test_butterflies_at_once_equal_warp_sum_bit_for_bit(tmp_path):
    """``gpg_warp_sums<N>`` (the butterflies of N sums at once that the
    warp-each products and window passes end in) leaves sum u in lanes
    (32 / N) u .. (32 / N)(u + 1) - 1 equal bit for bit to ``warp_sum`` of
    the u-th values, on values spanning 12 binades of both signs."""
    import subprocess

    from aehmc_tpu_torch.ops import _build
    from tests.test_torch_generic_pg import _MOCK

    (tmp_path / "hierarchical_pg.cuh").write_text(_MOCK)
    shutil.copy(_build.CSRC / "generic_pg.cuh", tmp_path / "generic_pg.cuh")
    (tmp_path / "main.cpp").write_text(_SUMS_MAIN)
    exe = tmp_path / "sums"
    subprocess.run(["g++", "-std=c++20", "-O1", "-ffp-contract=off",
                    "-pthread", "-I", str(tmp_path), "-o", str(exe),
                    str(tmp_path / "main.cpp")], check=True,
                   capture_output=True, timeout=300)
    rng = np.random.default_rng(19)
    for n in (1, 2, 4, 8, 16, 32):
        vals = (rng.standard_normal((32, n))
                * 2.0 ** rng.integers(-6, 6, (32, n))).astype(F32)
        blob = np.int32(n).tobytes() + vals.tobytes()
        out = np.frombuffer(subprocess.run(
            [str(exe)], input=blob, check=True, capture_output=True,
            timeout=60).stdout, F32)
        together, each = out[:32], out[32:].reshape(n, 32)
        per = 32 // n
        for u in range(n):
            got = together[u * per:(u + 1) * per]
            assert np.array_equal(got.view(np.uint32),
                                  np.full(per, each[u, 0]).astype(
                                      F32).view(np.uint32)), (n, u)
