"""The generated functor's scatter-add through the host's preimage row, on
the CPU (the g++ emulation of a whole block, ``_emulate`` of
tests/test_torch_generic_pg.py).

A scatter-add whose index the host knows (a data operand, or a row derived
from the data: R1's flat positions ``[n, y_n - 1]``) carries the host's
preimage row of the flat positions its values land on (offsets, then the
values by output, each output's in input order).  Each output's lane
starts from its base, adds the values the row lists for it in that order
and stores once; its values, which no lane now reads twice, need not be
stored.  Every lane used to walk every value, the owning lane adding it to
its output in the workspace (``_scan`` below: the emitter's method as it
was, kept as the reference, with the values it stored).  A sum in input
order is the scan's order, so:

- each case below (repeated indices, an output no value lands on,
  negative indices, a scatter along axis 1 of a ``(1, 30, 4)`` base as
  S3's, R1's flat positions, more outputs than the 32 lanes; R2, S4 and
  ``op_extras``'s scatter_reduce at the CPU widths) equals the scan bit
  for bit, in two emulated functors (a compile for each group of cases);
- P2 ``hier_negbin``, S3 ``lkj_slopes`` and U1 ``zip_radon`` at their
  chip_smoke.py widths equal the scan bit for bit, their emitted functor
  holds to the plain back end within 1e-5 of the largest value and to
  ``jax.vjp`` in float64 within 1e-4 (float32 sums of 600-919 terms), and
  their plain back end in float64 to ``jax.vjp`` in float64 within 1e-10
  (1e-7 where the IR holds torch.distributions' constants rounded to
  float32, as tests/test_torch_op_table_last.py and _rest.py state);
- new index values rebuild the row (new sums), and an index outside its
  axis still raises ``IndexError``;
- a scatter-add by an index computed on the card keeps the scan.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu_torch.api import _generic_fused_binding
from aehmc_tpu_torch.ops import generic_pg
from aehmc_tpu_torch.ops.generic_pg import Ix, _flatten, _numel, _Scope, \
    _unflatten
from tests.test_torch_dense_linalg import _bits, needs_gxx
from tests.test_torch_generic_ops import (
    hier_negbin,
    jax_hier_negbin,
    negbin_data,
    softmax_data,
    softmax_reg,
    weibull_data,
    weibull_mice,
)
from tests.test_torch_generic_pg import _emulate
from tests.test_torch_op_table_last import (
    SR_KINDS,
    jax_lkj_slopes,
    lkj_data,
    lkj_slopes,
    ordinal_data,
    ordinal_sorted,
    sred,
    sred_data,
)
from tests.test_torch_op_table_rest import jax_zip_radon, zip_data, zip_radon

F32 = np.float32


# ------------------------------------------- the scan, kept as reference --

def _scan(self, nid, lines, update="+="):
    """The emitter's scatter_add before the preimage row (its fourth
    argument unread): the base, lane-strided (output o in lane o % 32);
    then every lane walks the values in input order and the lane that owns
    each one's output adds it."""
    n = self.ir.nodes[nid]
    base, index, values = n.args[:3]
    axis = n.params[0]
    out = _numel(n.shape)
    vshape = self.ir.nodes[values].shape
    rank = len(self.ir.nodes[index].shape)
    init = _Scope(self)
    v = self.value(base, _unflatten(Ix("o", out), n.shape), init)
    lines.append(f"for (int o = lane; o < {out}; o += 32) {{")
    lines.extend("  " + line for line in init.lines)
    lines.append(f"  {self.slot(nid, Ix('o', out))} = {v};")
    lines.append("}")
    scan = _Scope(self)
    t = _unflatten(Ix("t", _numel(vshape)), vshape)
    k = self.value(index, t[axis:axis + rank], scan)
    length = n.shape[axis]
    o = _flatten((*t[:axis], Ix(f"gpg_wrap({k}, {length})", length),
                  *t[axis + rank:]), n.shape)
    scan.lines.append(f"const int o = {o.expr};")
    val = self.value(values, t, scan)
    scan.lines.append(f"if (o % 32 == lane) {self.slot(nid, Ix('o', out))}"
                      f" {update} {val};")
    lines.append(f"for (int t = 0; t < {_numel(vshape)}; ++t) {{")
    lines.extend("  " + line for line in scan.lines)
    lines.append("}")
    lines.append("__syncwarp();")


def _scan_reads(n):
    """The nodes whose values every lane read before: every scatter-add's."""
    return n.op in ("scatter_add", "scatter_put", "scatter_reduce_chain",
                    "sortidx")


def _scan_text(ir, monkeypatch):
    """The functor of ``ir`` as the emitter wrote it with the scan."""
    with monkeypatch.context() as m:
        m.setattr(generic_pg._Emitter, "scatter_add", _scan)
        m.setattr(generic_pg, "_every_lane_reads", _scan_reads)
        return generic_pg.emit_cuda(ir), generic_pg.schedule(ir).workspace


def _preimage_nodes(ir):
    return [n for n in ir.nodes if n.op == "scatter_add" and len(n.args) == 4]


def _assert_rel(a, b, rtol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1.0)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * scale)


# ------------------------------------------------------ the small cases --

def _gathered(idx, n, seed):
    """Potential of q (n) through ``q[idx]`` (idx int64, any values in [-n,
    n)): its gradient adds a value at each index, the backward's
    scatter-add."""
    rng = np.random.default_rng(seed)
    k = torch.as_tensor(idx)
    w = torch.as_tensor(rng.uniform(0.5, 1.5, len(idx)).astype(F32))
    y = torch.as_tensor(rng.standard_normal(len(idx)).astype(F32))

    def lp(q):
        return -0.5 * torch.sum(w * (q[k] - y) ** 2) - 0.05 * torch.sum(q * q)
    return lp, n


def _axis1(num_groups=30, num_coef=4, num_obs=90, seed=3):
    """S3's shape: coefficients Z (1, 30, 4) read along axis 1 by each
    observation's group (``Z[:, g]``), the backward a scatter-add along
    axis 1 of a (1, 30, 4) base."""
    rng = np.random.default_rng(seed)
    g = torch.as_tensor(rng.integers(0, num_groups, num_obs))
    X = torch.as_tensor(rng.standard_normal((num_obs, num_coef)).astype(F32))
    y = torch.as_tensor(rng.standard_normal(num_obs).astype(F32))
    dim = num_groups * num_coef

    def lp(q):
        Z = q.reshape(1, num_groups, num_coef)
        eta = torch.sum(Z[:, g] * X, -1)
        return -0.5 * torch.sum((eta - y) ** 2) - 0.5 * torch.sum(q * q)
    return lp, dim


def _small_cases():
    """name -> (logprob, dim): the scatter-add's shape in each name, then
    R2, S4 and ``op_extras``'s scatter_reduce at the CPU widths of
    tests/test_torch_generic_ops.py and _op_table_last.py."""
    rng = np.random.default_rng(0)
    r1_X, r1_y = softmax_data(40, 3, 5, seed=3)
    return {
        "repeated": _gathered(rng.integers(0, 6, 40), 6, 1),
        "empty_output": _gathered(np.array([0, 2, 2, 5, 0, 2, 7, 5]), 9, 2),
        "negative": _gathered(rng.integers(-8, 8, 30), 8, 3),
        "axis1": _axis1(),
        "r1_flat_positions": (softmax_reg(r1_X, r1_y, 5), 15),
        "outputs_past_32_lanes": _gathered(rng.integers(0, 70, 200), 70, 4),
        "r2_weibull_mice": (weibull_mice(*weibull_data(2, 6, seed=4), 2), 3),
        "s4_ordinal_sorted": (ordinal_sorted(*ordinal_data(40, 3, seed=3)),
                              7),
        "op_extras_scatter_reduce": (sred(*sred_data(), SR_KINDS), 4),
    }


SMALL = _small_cases()
# the cases in two functors, each within the data table's 32 operands
GROUPS = (tuple(SMALL)[:6], tuple(SMALL)[6:])
# the emulated functor against its plain back end: 1e-5 of the largest
# value; S4's 1e-4 (tests/test_torch_op_table_last.py: CUDA's and torch's
# CPU sigmoid a few ulp apart under the log of their differences), and u,
# the sum of its functor's cases, with it
SMALL_RTOL = {"s4_ordinal_sorted": 1e-4}
_SUMMED = {}


def _summed(group):
    """The cases of ``group`` on consecutive slices of q, their potentials
    summed: one functor (a compile) for them all; ``{bound, operands,
    starts}``."""
    if group not in _SUMMED:
        dims = [SMALL[n][1] for n in group]
        starts = dict(zip(group, np.cumsum([0] + dims)))
        lps = [SMALL[n][0] for n in group]

        def lp(q):
            return sum(f(q[a:a + d]) for f, a, d in
                       zip(lps, starts.values(), dims))
        dim = int(sum(dims))
        pot, rows = _generic_fused_binding(lp, dim)
        bound = generic_pg.bind(pot, rows, dim)
        _SUMMED[group] = dict(bound=bound, starts=starts,
                              operands=generic_pg.all_operands(
                                  bound.ir, bound.operands(rows, "cpu")))
    return _SUMMED[group]


def _emulate_both(source, scan, operands, q, work):
    """``_emulate`` of the functor and of its scan text, the two g++ builds
    at once."""
    def one(text, sub):
        (work / sub).mkdir(parents=True, exist_ok=True)
        return _emulate(text, operands, q, work / sub)
    with ThreadPoolExecutor(2) as pool:
        runs = [pool.submit(one, text, sub)
                for text, sub in ((source, "new"), (scan, "scan"))]
        return [r.result() for r in runs]


_RUNS = {}


@needs_gxx
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_preimage_scatter_keeps_the_scan_bits(name, tmp_path,
                                                  monkeypatch):
    group = next(g for g in GROUPS if name in g)
    s = _summed(group)
    bound, operands = s["bound"], s["operands"]
    dim = bound.ir.dim
    assert len(_preimage_nodes(bound.ir)) >= len(group)
    assert "if (o % 32 == lane)" not in bound.source
    scan, scan_ws = _scan_text(bound.ir, monkeypatch)
    assert "if (o % 32 == lane)" in scan
    assert bound.workspace < scan_ws  # the values no longer stored
    q = (0.5 * np.random.default_rng(5).standard_normal((6, dim))).astype(
        F32)
    if group not in _RUNS:  # one run of each summed functor a session
        _RUNS[group] = _emulate_both(bound.source, scan, operands, q,
                                     tmp_path)
    (u, g), (u0, g0) = _RUNS[group]
    a = int(s["starts"][name])
    d = SMALL[name][1]
    np.testing.assert_array_equal(_bits(u), _bits(u0))
    np.testing.assert_array_equal(_bits(g[:, a:a + d]), _bits(g0[:, a:a + d]))
    up, gp = generic_pg.run_plain(bound.ir, torch.tensor(q.T), operands)
    _assert_rel(u, up.numpy().reshape(-1),
                max(SMALL_RTOL.get(n, 1e-5) for n in group))
    _assert_rel(g[:, a:a + d], gp.numpy().T[:, a:a + d],
                SMALL_RTOL.get(name, 1e-5))


# ----------------------------------------------------- the whole functors --

def _whole_cases():
    """name -> (logprob, float64 twin, jnp twin of a dtype, dim, start), at
    chip_smoke.py's widths."""
    group, x, y = negbin_data()
    g3, X3, Y3 = lkj_data(4, 30, 600, seed=2)
    zc, zf, zy = zip_data(919, 85, seed=0)
    start = np.zeros(89)
    start[[86, 87]] = [0.8, 1.4]  # U1's mu and log precision near the data's
    return {
        "hier_negbin": (hier_negbin(group, x, y, 85),
                        hier_negbin(group, x.astype(np.float64), y, 85),
                        lambda dt: jax_hier_negbin(group, x, y, 85, dt), 89,
                        None),
        "lkj_slopes": (lkj_slopes(g3, X3, Y3, 30),
                       lkj_slopes(g3, X3.astype(np.float64),
                                  Y3.astype(np.float64), 30),
                       lambda dt: jax_lkj_slopes(g3, X3, Y3, 30, dt), 135,
                       None),
        "zip_radon": (zip_radon(zc, zf, zy, 85),
                      zip_radon(zc, zf.astype(np.float64),
                                zy.astype(np.float64), 85),
                      lambda dt: jax_zip_radon(zc, zf, zy, 85, dt), 89,
                      start)}


WHOLE = _whole_cases()
# the plain back end in float64 against jax.vjp in float64: 1e-10, or 1e-7
# where the IR holds torch.distributions' Python-float constants rounded to
# float32 (S3, U1)
FLOAT64_RTOL = {"hier_negbin": 1e-10, "lkj_slopes": 1e-7, "zip_radon": 1e-7}
_WHOLE = {}


def _whole(name):
    if name not in _WHOLE:
        lp, lp64, jax_lp, dim, start = WHOLE[name]
        pot, rows = _generic_fused_binding(lp, dim)
        bound = generic_pg.bind(pot, rows, dim)
        q = 0.1 * np.random.default_rng(7).standard_normal((8, dim))
        if start is not None:
            q += start
        q = q.astype(F32).astype(np.float64)  # the card's positions
        _WHOLE[name] = (bound, generic_pg.all_operands(
            bound.ir, bound.operands(rows, "cpu")), q)
    return _WHOLE[name]


_JAX = {}


def _jax_value_and_grad(name):
    """(u, g) of jax.vjp in float64 at the case's positions (once)."""
    if name not in _JAX:
        f = WHOLE[name][2](jnp.float64)
        u, g = jax.jit(jax.vmap(jax.value_and_grad(f)))(
            jnp.asarray(_whole(name)[2]))
        _JAX[name] = (-np.asarray(u), -np.asarray(g))
    return _JAX[name]


@needs_gxx
@pytest.mark.parametrize("name", sorted(WHOLE))
def test_a_whole_functor_keeps_the_scan_bits_and_holds_to_jax(
        name, tmp_path, monkeypatch):
    bound, operands, q64 = _whole(name)
    assert _preimage_nodes(bound.ir)
    q = q64.astype(F32)
    scan, _ = _scan_text(bound.ir, monkeypatch)
    (u, g), (u0, g0) = _emulate_both(bound.source, scan, operands, q,
                                     tmp_path)
    np.testing.assert_array_equal(_bits(u), _bits(u0))
    np.testing.assert_array_equal(_bits(g), _bits(g0))
    up, gp = generic_pg.run_plain(bound.ir, torch.tensor(q.T), operands)
    _assert_rel(u, up.numpy().reshape(-1), 1e-5)
    _assert_rel(g, gp.numpy().T, 1e-5)
    uj, gj = _jax_value_and_grad(name)
    _assert_rel(u, uj, 1e-4)
    _assert_rel(g, gj, 1e-4)


@pytest.mark.parametrize("name", sorted(WHOLE))
def test_a_whole_functor_plain_float64_matches_jax_vjp(name):
    bound, operands, q = _whole(name)
    u, g = generic_pg.run_plain(bound.ir, torch.tensor(q.T), operands)
    uj, gj = _jax_value_and_grad(name)
    _assert_rel(u.numpy().reshape(-1), uj, FLOAT64_RTOL[name])
    _assert_rel(g.numpy().T, gj, FLOAT64_RTOL[name])


# ------------------------------------------------- new values, the bounds --

@needs_gxx
def test_new_index_values_rebuild_the_preimage(tmp_path):
    """In place new values of the index: the next launch's preimage row is
    rebuilt and the emulated functor (the same text) gives the new sums;
    an index outside its axis raises ``IndexError``."""
    idx = torch.tensor([0, 3, -1, 2, 3, 3, 0])
    w = torch.linspace(0.5, 1.5, 7)

    def lp(q):
        return torch.sum(w * torch.sin(q[idx])) - 0.5 * torch.sum(q * q)

    pot, rows = _generic_fused_binding(lp, 5)
    bound = generic_pg.bind(pot, rows, 5)
    (node,) = _preimage_nodes(bound.ir)
    pre_j = bound.ir.nodes[node.args[3]].params[0]
    q = (0.4 * np.random.default_rng(3).standard_normal((4, 5))).astype(F32)
    rows_before = None
    for values in ([0, 3, -1, 2, 3, 3, 0], [4, 4, -5, 1, 1, 0, 4]):
        idx[:] = torch.tensor(values)
        operands = bound.operands(rows, "cpu")
        row = operands[pre_j].tolist()
        assert row != rows_before
        rows_before = row
        wrapped = [v % 5 for v in values]
        counts = np.bincount(wrapped, minlength=5)
        assert row[:6] == [0, *np.cumsum(counts).tolist()]
        assert row[6:] == sorted(range(7), key=lambda e: (wrapped[e], e))
        u, g = _emulate(bound.source, operands, q, tmp_path)
        qt = torch.tensor(q, requires_grad=True)
        ref = -torch.stack([lp(qt[c]) for c in range(4)])
        (g_ref,) = torch.autograd.grad(ref.sum(), qt)
        _assert_rel(u, ref.detach().numpy(), 1e-6)
        _assert_rel(g, g_ref.numpy(), 1e-6)
    for bad in (5, -6):
        idx[2] = bad
        with pytest.raises(IndexError):
            bound.operands(rows, "cpu")


# -------------------------------------------------- an index of the card --

@needs_gxx
def test_an_index_computed_on_the_card_keeps_the_scan(tmp_path):
    """cummax's backward adds its gradient at the per-chain indices of the
    running maxima: a scatter-add by an index computed on the card, which
    every lane still walks."""
    def lp(q):
        return torch.cummax(q, 0).values.sum() - 0.5 * torch.sum(q * q)

    pot, rows = _generic_fused_binding(lp, 6)
    bound = generic_pg.bind(pot, rows, 6)
    scatters = [n for n in bound.ir.nodes if n.op == "scatter_add"]
    assert scatters and not _preimage_nodes(bound.ir)
    assert "if (o % 32 == lane)" in bound.source
    q = np.random.default_rng(4).standard_normal((5, 6)).astype(F32)
    operands = generic_pg.all_operands(bound.ir, bound.operands(rows, "cpu"))
    u, g = _emulate(bound.source, operands, q, tmp_path)
    up, gp = generic_pg.run_plain(bound.ir, torch.tensor(q.T), operands)
    _assert_rel(u, up.numpy().reshape(-1), 1e-6)
    _assert_rel(g, gp.numpy().T, 1e-6)
