"""The generated functor's dense linear algebra: what its redesign keeps
bit for bit, on the CPU (the g++ emulation of a block,
``tests/test_torch_dense_linalg.py``'s cases and harness).

- The factorisations' trailing update, the lanes along the rows, equal bit
  for bit to the lanes down the rows it replaced (the same terms of each
  element in the same order);
- S2's LU shared by the nodes on the same matrix equal bit for bit to four
  separate factorisations;
- a product of two workspace matrices, tiled, equal bit for bit to one
  output a lane at a time, and the several-column solves' blocks of rows
  and columns equal bit for bit to one row and column at a time.
"""

import numpy as np
import pytest

from aehmc_tpu_torch.ops import generic_pg
from tests.test_torch_dense_linalg import (
    _bits,
    _place,
    _run,
    _traced,
    needs_gxx,
)
from tests.test_torch_generic_pg import EMITTED_RTOL, _assert_rel


def _rank_one_down_the_rows(M, size, mult, lower=False):
    """Step k's trailing update as it was emitted before: row r in lane
    r % 32, ``fmaf`` along the row, each element's terms in the order of
    k."""
    stop = "j <= r" if lower else f"j < {size}"
    return [f"for (int r = k + 1 + lane; r < {size}; r += 32) {{",
            f"  const float l = {M('r', 'k')};",
            f"  for (int j = k + 1; {stop}; ++j)",
            f"    {M('r', 'j')} = fmaf(-l, {mult('j')}, {M('r', 'j')});",
            "}"]


@needs_gxx
@pytest.mark.parametrize("shared", [True, False],
                         ids=["factor_scratch", "workspace"])
@pytest.mark.parametrize("name", ["gp_se64", "gp_se64_logdet", "lu"])
def test_factorisations_keep_their_bits(name, shared, tmp_path,
                                        monkeypatch):
    """``chol`` and ``_lu_factor`` with the lanes along the rows (each
    column's multiplier in a register, eight rows loaded before they are
    stored) equal, bit for bit, the same functor whose trailing update runs
    the lanes down the rows as before: each element takes the same terms
    in the same order of k."""
    _place(monkeypatch, shared)
    ir = _traced(name, 64)[0].ir
    along = generic_pg.emit_cuda(ir)
    with monkeypatch.context() as m:
        m.setattr(generic_pg, "_rank_one", _rank_one_down_the_rows)
        down = generic_pg.emit_cuda(ir)
    assert along != down and "for (int rb = k + 1;" in along
    *_, ue, ge = _run(name, 64, tmp_path / "along", along)
    *_, ud, gd = _run(name, 64, tmp_path / "down", down)
    np.testing.assert_array_equal(_bits(ue), _bits(ud))
    np.testing.assert_array_equal(_bits(ge), _bits(gd))


@needs_gxx
@pytest.mark.parametrize("n", [40, 64])
def test_shared_lu_equals_separate_factorisations(n, tmp_path, monkeypatch):
    """S2 factors K for its solve and its log-determinant, and Kᵀ for the
    two solves of its backward: the functor factors each matrix once (two
    LUs, the second node of each reading the first's factors and pivots)
    and equals, bit for bit, the functor that factors four times."""
    ir = _traced("gp_se64_logdet", n)[0].ir
    users = generic_pg._lu_owners(ir)
    assert len(users) == 2 and len(set(users.values())) == 2
    shared = generic_pg.emit_cuda(ir)
    with monkeypatch.context() as m:
        m.setattr(generic_pg, "_lu_owners", lambda ir: {})
        separate = generic_pg.emit_cuda(ir)
    assert shared.count("float top = fabsf(") == 2
    assert separate.count("float top = fabsf(") == 4
    *_, ua, ga = _run("gp_se64_logdet", n, tmp_path / "shared", shared)
    *_, ub, gb = _run("gp_se64_logdet", n, tmp_path / "separate", separate)
    np.testing.assert_array_equal(_bits(ua), _bits(ub))
    np.testing.assert_array_equal(_bits(ga), _bits(gb))


@needs_gxx
def test_tiled_workspace_product_keeps_its_bits(tmp_path, monkeypatch):
    """S1's 64 x 64 x 64 product of two workspace matrices, two rows of
    outputs a lane with their terms' loads issued eight at a time, equals
    bit for bit the loop of one output a lane (each output's sum over k in
    the same order)."""
    ir = _traced("gp_se64", 64)[0].ir
    tiled = generic_pg.emit_cuda(ir)
    with monkeypatch.context() as m:
        m.setattr(generic_pg._Emitter, "ws_product", lambda self, nid: False)
        plain = generic_pg.emit_cuda(ir)
    assert "for (int r0 = 0; r0 < 64; r0 += 2) {" in tiled
    assert "r0 += 2" not in plain
    *_, ut, gt = _run("gp_se64", 64, tmp_path / "tiled", tiled)
    *_, up, gq = _run("gp_se64", 64, tmp_path / "plain", plain)
    np.testing.assert_array_equal(_bits(ut), _bits(up))
    np.testing.assert_array_equal(_bits(gt), _bits(gq))


@needs_gxx
@pytest.mark.parametrize("shared", [True, False],
                         ids=["factor_scratch", "workspace"])
@pytest.mark.parametrize("name,n", [("tri", 64), ("tri", 37),
                                    ("gp_se64", 64)])
def test_solve_blocks_keep_their_bits(name, n, shared, tmp_path,
                                      monkeypatch):
    """The several-column solves, two columns a lane and two rows at once
    (each matrix and solution element loaded once for both), equal bit for
    bit the solves of one column and one row at a time: each solution's
    sum takes the same terms in the same order.  At 37 the columns end
    inside a group and the last row is solved alone."""
    _place(monkeypatch, shared)
    ir = _traced(name, n)[0].ir
    blocks = generic_pg.emit_cuda(ir)
    with monkeypatch.context() as m:
        m.setattr(generic_pg, "SOLVE_COLUMNS", 1)
        m.setattr(generic_pg, "SOLVE_ROWS", 1)
        single = generic_pg.emit_cuda(ir)
    assert "acc1_1 = fmaf(" in blocks and "acc1_1" not in single
    *_, ua, ga = _run(name, n, tmp_path / "blocks", blocks)
    *_, ub, gb = _run(name, n, tmp_path / "single", single)
    np.testing.assert_array_equal(_bits(ua), _bits(ub))
    np.testing.assert_array_equal(_bits(ga), _bits(gb))
    _, u, g, _, _ = _run(name, n, tmp_path / "plain", blocks)
    _assert_rel(ga, g, EMITTED_RTOL)
