"""Any potential on the HMC core (kernels 5, 6 and 7) of the port, on the
CPU.

- The plain kernels 5 (``make_fused_ghmc_transition``), 6
  (``fused_ghmc_segment``) and 7 (``make_fused_chees_transition``), each
  with ``generic_pg.run_plain`` of a traced potential (the generated
  functor's plain version) as the potential, against the JAX kernels in
  interpret mode on the same potential written in ``jnp``: the diagonal
  Gaussian of ``tests/test_ghmc_fused.py``, Neal's funnel and eight schools
  (``aehmc_tpu.models.hierarchical``).  External randomness, float32, the
  same numpy inputs.  Decisions (accepted, the stats rows 2-4) equal; q
  within 1e-5 absolute, the other outputs within 1e-5 (rtol and atol): the
  port's plain back end and the JAX vjp sum in other orders.
- The card's dispatch (``ops.functors.card_functor``) of the NUTS core
  (kernels 1 and 2) and of the HMC core (kernels 5-7): the logistic functor
  in both, the funnel's and eight schools' in the NUTS core and the
  generated functor in the HMC core, and its raises.
- The launch plan of the HMC core for each functor: a generated functor's
  workspace in shared or global memory as the functor was emitted
  (``WS_SHARED``, decided with the NUTS core's rows), never decided again
  with the HMC core's; the hierarchical functors refused.
- The build's template and signature tables name every new entry point, and
  a build without ``nvcc`` raises.
- The front door on a bare ``logprob_fn`` (the generic fused binding) on
  ``algorithm="mala"|"ghmc"|"chees"|"meads", path="fused"``, on CPU tensors.

The CUDA instantiations run only on a card: their gates are in
``test_torch_cuda.py``.
"""

import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aehmc_tpu.models import eight_schools_pg_t as jax_schools_pg_builder
from aehmc_tpu.models import neals_funnel_pg_t as jax_funnel_pg_builder
from aehmc_tpu.ops import chees_fused as jax_cf
from aehmc_tpu.ops import ghmc_fused as jax_ghmc
import aehmc_tpu_torch
from aehmc_tpu_torch.models import (
    eight_schools_pg_t,
    funnel_pg_t,
    logistic_pg_t,
    logistic_regression_pg_t,
    neals_funnel_pg_t,
    schools_pg_t,
)
from aehmc_tpu_torch.ops import LAUNCHES, _build, chees_fused, generic_pg
from aehmc_tpu_torch.ops import ghmc_fused
from aehmc_tpu_torch.ops import launch_plan as lp
from aehmc_tpu_torch.ops.functors import HMC_CORE, NUTS_CORE, card_functor

F32 = np.float32
CHAINS = 16
Q_ATOL = 1e-5
TOL = dict(rtol=1e-5, atol=1e-5)
GAUSS_VAR = np.linspace(0.5, 2.0, 6).astype(F32)


def _gauss_t(q_t, var_col):
    return 0.5 * torch.sum(q_t * q_t / var_col, dim=0)


def _jax_gauss_t(q_t, var_col):  # tests/test_ghmc_fused.py:80
    return 0.5 * jnp.sum(q_t * q_t / var_col, axis=0)


def _potentials(name):
    """(port potential_t, port data, JAX potential_t, JAX data, dim, q
    scale) of one of the three potentials."""
    if name == "gaussian":
        var_col = GAUSS_VAR.reshape(-1, 1)
        return (_gauss_t, (torch.tensor(var_col),), _jax_gauss_t,
                [jnp.asarray(var_col)], GAUSS_VAR.size, 1.0)
    if name == "funnel":
        pot, _, data, _ = neals_funnel_pg_t(6, device="cpu")
        pot_j, _, data_j, _ = jax_funnel_pg_builder(dim=6)
        return pot, data, pot_j, list(data_j), 6, 0.5
    pot, _, data, _ = eight_schools_pg_t(device="cpu")
    pot_j, _, data_j, _ = jax_schools_pg_builder()
    return pot, data, pot_j, list(data_j), 10, 0.5


def _generated(pot, data, dim):
    """The traced potential's plain back end as a ``potential_and_grad_t``
    (the generated functor's plain version)."""
    traced = generic_pg.trace_potential(pot, data, dim)

    def pg(q_t, *d):
        return generic_pg.run_plain(traced.ir, q_t, (*d, *traced.constants))

    return pg


def _start(name, seed):
    pot, data, pot_j, data_j, dim, scale = _potentials(name)
    pg = _generated(pot, data, dim)
    rng = np.random.default_rng(seed)
    q = (scale * rng.normal(size=(CHAINS, dim))).astype(F32)
    u, g_t = pg(torch.tensor(q).T.contiguous(), *data)
    return (pg, data, pot_j, data_j, dim, rng, q,
            u.reshape(-1).numpy(), g_t.T.contiguous().numpy())


def _moved(q_new, q_old):
    return np.any(np.asarray(q_new) != np.asarray(q_old), axis=-1)


def _assert_agree(port, jax_out, q0):
    """Decisions equal, q within Q_ATOL, the rest within TOL; ``port`` and
    ``jax_out`` are ``(q, u, g, p or None, stats (…, 8), …)``."""
    qp, qj = np.asarray(port[0]), np.asarray(jax_out[0])
    np.testing.assert_array_equal(_moved(qp, q0), _moved(qj, q0))
    sp, sj = np.asarray(port[4]), np.asarray(jax_out[4])
    np.testing.assert_array_equal(sp[..., 2:5], sj[..., 2:5])
    np.testing.assert_allclose(sp[..., :2], sj[..., :2], **TOL)
    np.testing.assert_allclose(qp, qj, rtol=0, atol=Q_ATOL)
    for a, b in zip(port[1:4], jax_out[1:4]):
        if a is not None:
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


POTENTIALS = ["gaussian", "funnel", "eight_schools"]


@pytest.mark.parametrize("name", POTENTIALS)
def test_plain_kernel_5_on_a_generated_functor_matches_jax(name):
    pg, data, pot_j, data_j, dim, rng, q, u, g = _start(name, 5)
    p = rng.normal(size=(CHAINS, dim)).astype(F32)
    noise = rng.normal(size=(CHAINS, dim)).astype(F32)
    ua = rng.uniform(size=CHAINS).astype(F32)
    imm = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    eps, alpha = (0.3, 0.8) if name != "funnel" else (0.15, 0.8)
    port = ghmc_fused.make_fused_ghmc_transition(
        None, data, potential_and_grad_t=pg)(
        torch.tensor(q), torch.tensor(u), torch.tensor(g), torch.tensor(p),
        eps, alpha, torch.tensor(imm), noise=torch.tensor(noise),
        u_accept=torch.tensor(ua))
    jax_out = jax_ghmc.make_fused_ghmc_transition(
        pot_j, data_j, block_chains=8, interpret=True)(
        jnp.asarray(q), jnp.asarray(u), jnp.asarray(g), jnp.asarray(p), eps,
        alpha, jnp.asarray(imm), noise=jnp.asarray(noise),
        u_accept=jnp.asarray(ua))
    _assert_agree(port, jax_out, q)
    assert _moved(port[0], q).any()


@pytest.mark.parametrize("name", POTENTIALS)
def test_plain_kernel_6_on_a_generated_functor_matches_jax(name):
    pg, data, pot_j, data_j, dim, rng, q, u, g = _start(name, 6)
    draws = 6
    p = rng.normal(size=(CHAINS, dim)).astype(F32)
    noise = rng.normal(size=(draws, CHAINS, dim)).astype(F32)
    ua = rng.uniform(size=(draws, CHAINS)).astype(F32)
    imm = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    eps = 0.25 if name != "funnel" else 0.12
    port = ghmc_fused.fused_ghmc_segment(
        None, data, potential_and_grad_t=pg)(
        torch.tensor(q), torch.tensor(u), torch.tensor(g), torch.tensor(p),
        eps, 0.9, torch.tensor(imm), draws, noise=torch.tensor(noise),
        u_accept=torch.tensor(ua))
    jax_out = jax_ghmc.fused_ghmc_segment(
        pot_j, data_j, block_chains=8, interpret=True)(
        jnp.asarray(q), jnp.asarray(u), jnp.asarray(g), jnp.asarray(p), eps,
        0.9, jnp.asarray(imm), draws, noise=jnp.asarray(noise),
        u_accept=jnp.asarray(ua))
    pos_p, st_p = (np.asarray(a) for a in port[:2])
    pos_j, st_j = (np.asarray(a) for a in jax_out[:2])
    assert pos_p.shape == (draws, CHAINS, dim) and st_p.shape == (
        draws, CHAINS, 8)
    prev = np.concatenate([q[None], pos_p[:-1]])
    np.testing.assert_array_equal(
        _moved(pos_p, prev),
        _moved(pos_j, np.concatenate([q[None], pos_j[:-1]])))
    np.testing.assert_array_equal(st_p[..., 2:5], st_j[..., 2:5])
    np.testing.assert_allclose(st_p[..., :2], st_j[..., :2], **TOL)
    np.testing.assert_allclose(pos_p, pos_j, rtol=0, atol=Q_ATOL)
    for a, b in zip(port[2:], jax_out[2:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("name", POTENTIALS)
def test_plain_kernel_7_on_a_generated_functor_matches_jax(name):
    pg, data, pot_j, data_j, dim, rng, q, u, g = _start(name, 7)
    p = rng.normal(size=(CHAINS, dim)).astype(F32)
    ua = rng.uniform(size=CHAINS).astype(F32)
    im = rng.uniform(0.5, 1.5, size=dim).astype(F32)
    eps = rng.uniform(0.1, 0.3, size=CHAINS).astype(F32)
    steps = 3
    port = chees_fused.make_fused_chees_transition(
        None, data, potential_and_grad_t=pg)(
        torch.tensor(q), torch.tensor(u), torch.tensor(g), torch.tensor(p),
        torch.tensor(ua), torch.tensor(im), torch.tensor(eps), steps)
    jax_out = jax_cf.make_fused_chees_transition(
        pot_j, data_j, block_chains=CHAINS, interpret=True)(
        jnp.asarray(q), jnp.asarray(u), jnp.asarray(g), jnp.asarray(p),
        jnp.asarray(ua), jnp.asarray(im), jnp.asarray(eps),
        jnp.asarray(steps, jnp.int32))
    # (q, u, g, stats, q_proposed, v_proposed): no momentum out
    reorder = (lambda o: (o[0], o[1], o[2], None, o[3]))
    _assert_agree(reorder(port), reorder(jax_out), q)
    np.testing.assert_array_equal(np.asarray(port[3])[:, 3], float(steps))
    for a, b in zip(port[4:], jax_out[4:]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=Q_ATOL)


# ------------------------------------------------------------ dispatch ----

def _gaussian_pg(q_t, var_col):
    return (0.5 * torch.sum(q_t * q_t / var_col, dim=0, keepdim=True),
            q_t / var_col)


CORES = {"nuts": NUTS_CORE, "hmc": HMC_CORE}


def _dispatch(core, pg, data, q_t, potential_fn_t=None):
    """The functor ``card_functor`` picks in ``core``'s kernels, chains
    ``q_t (dim, C)``."""
    return card_functor(potential_fn_t, pg, data, q_t, CORES[core])[0]


@pytest.mark.parametrize("module", sorted(CORES))
def test_card_dispatch_names_each_functor(module):
    """Both cores hold the logistic functor; the funnel and eight schools
    run on their hand-written functors in the NUTS core and on a generated
    functor (traced from ``funnel_pg_t`` / ``schools_pg_t``) in the HMC
    core; any other float32 potential on a generated functor in both."""
    _, pg_l, data_l, _ = logistic_regression_pg_t(
        dim=4, num_points=8, matmul_dtype=torch.float32, device="cpu")
    _, _, data_f, _ = neals_funnel_pg_t(6, device="cpu")
    _, _, data_s, _ = eight_schools_pg_t(device="cpu")
    var_col = (torch.tensor(GAUSS_VAR[:4]).reshape(-1, 1),)
    nuts = module == "nuts"
    assert _dispatch(module, pg_l, data_l, torch.zeros(4, 16)) == "logistic"
    assert _dispatch(module, funnel_pg_t, data_f, torch.zeros(6, 16)) == (
        "funnel" if nuts else "generic")
    assert _dispatch(module, schools_pg_t, data_s, torch.zeros(10, 16)) == (
        "eight_schools" if nuts else "generic")
    # any other float32 potential: pre-differentiated, or differentiated in
    # the trace, or a hand-written model not named by identity
    assert _dispatch(module, _gaussian_pg, var_col,
                     torch.zeros(4, 16)) == "generic"
    assert _dispatch(module, None, var_col, torch.zeros(4, 16),
                     potential_fn_t=_gauss_t) == "generic"
    assert _dispatch(module, lambda q, d: funnel_pg_t(q, d), data_f,
                     torch.zeros(6, 16)) == "generic"


@pytest.mark.parametrize("module", sorted(CORES))
def test_card_dispatch_raises_only_for_what_no_functor_takes(module):
    var_col = (torch.tensor(GAUSS_VAR[:4]).reshape(-1, 1),)
    with pytest.raises(NotImplementedError,
                       match=r"aten\.special_bessel_j0.*1\.10c"):
        _dispatch(module, None, (), torch.zeros(4, 16),  # no rule
                  potential_fn_t=lambda q_t: torch.special.bessel_j0(
                      q_t).sum(0))
    with pytest.raises(TypeError, match="float32"):
        _dispatch(module, _gaussian_pg, var_col,
                  torch.zeros(4, 16, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):
        _dispatch(module, _gaussian_pg, (var_col[0].double(),),
                  torch.zeros(4, 16))
    with pytest.raises(ValueError, match="mixes chains"):
        _dispatch(module, None, (), torch.zeros(4, 16),
                  potential_fn_t=lambda q_t: (q_t * q_t).sum(0) + q_t.mean())
    with pytest.raises(ValueError, match="logistic data"):
        _dispatch(module, logistic_pg_t, var_col, torch.zeros(4, 16))


# --------------------------------------------------------- launch plan ----

@pytest.mark.parametrize("functor", ["funnel", "eight_schools", "generic"])
@pytest.mark.parametrize("dim,chains", [(10, 8192), (10, 2048), (6, 13),
                                        (25, 2048), (100, 10_240)])
def test_hmc_plan_of_a_functor_without_x(functor, dim, chains):
    """A generated functor: no tile, 8 chains a block, the HMC core's 8 rows
    a chain, the block's potentials and the functor's workspace (here in
    shared memory: W = 16) beside them.  The HMC core holds no hierarchical
    functor (the funnel and eight schools run there on a generated one):
    its plan refuses them, the NUTS plan takes them."""
    if functor != "generic":
        with pytest.raises(ValueError, match="NUTS kernels only"):
            lp.launch_plan("hmc", dim, 0, chains, functor=functor)
        nuts = lp.launch_plan("nuts", dim, 6, chains, functor=functor)
        assert (nuts.points, nuts.row_stride, nuts.chains) == (0, 0, 8)
        return
    work = 16
    geo = lp.generic_geometry(dim, work)
    for x_dtype in (torch.float32, torch.bfloat16):
        plan = lp.launch_plan("hmc", dim, 0, chains, x_dtype,
                              functor=functor, geometry=geo)
        assert (plan.points, plan.row_stride, plan.chains) == (0, 0, 8)
        assert plan.blocks == -(-chains // 8)
        assert plan.smem == 4 * (8 * 8 * lp.state_stride(dim) + 8 + 8 * work)
    assert plan.smem < lp.launch_plan("nuts", dim, 6, chains, functor=functor,
                                      geometry=geo).smem


def test_hmc_plan_follows_the_workspace_the_functor_was_emitted_with():
    """At dim 10 a workspace of 3,450 floats a chain fits two HMC blocks an
    SM in shared memory but not two NUTS blocks: the functor is emitted with
    it global (WS_SHARED false), so the HMC plan leaves it out of shared
    memory and the wrapper allocates the global buffer for the HMC grid."""
    dim, work, chains = 10, 3450, 1000
    hmc_alone = 4 * (8 * 8 * lp.state_stride(dim) + 8 + 8 * work)
    assert lp.two_blocks_fit(hmc_alone)
    assert not lp.generic_workspace_shared(dim, work)
    geo = lp.generic_geometry(dim, work)
    assert not geo.ws_shared
    plan = lp.launch_plan("hmc", dim, 0, chains, functor="generic",
                          geometry=geo)
    assert plan.smem == 4 * (8 * 8 * lp.state_stride(dim) + 8)
    assert lp.generic_workspace_floats(geo, plan.blocks) == \
        plan.blocks * 8 * work


@pytest.mark.parametrize("points", [4, 3000])
def test_hmc_plan_of_real_generated_functors(points):
    """Two emitted functors, a small one whose workspace the NUTS plan puts
    in shared memory and the logistic posterior at 3,000 points, whose
    workspace it puts in global memory: the HMC plan's shared memory holds
    the workspace exactly when the functor's text says WS_SHARED, beside
    the functor's resident operands and tile buffers."""
    dim = 10
    rng = np.random.default_rng(points)
    X = torch.tensor(rng.normal(size=(points, dim)).astype(F32))
    y_col = torch.tensor((rng.uniform(size=(points, 1)) < 0.5).astype(F32))

    def logistic_t(q_t, Xd, yd):
        logits = Xd @ q_t
        return (-torch.sum(yd * logits - torch.nn.functional.softplus(logits),
                           dim=0) + 0.5 * torch.sum(q_t * q_t, dim=0))

    bound = generic_pg.bind(logistic_t, (X, y_col), dim)
    shared = "WS_SHARED = true" in bound.source
    assert shared == (points == 4)
    geo = bound.geometry
    assert shared == geo.ws_shared == lp.generic_workspace_shared(
        dim, bound.workspace, geo.fixed_floats)
    plan = lp.launch_plan("hmc", dim, 0, CHAINS, functor="generic",
                          geometry=geo)
    rows = 4 * (8 * 8 * lp.state_stride(dim) + 8 + geo.fixed_floats)
    assert plan.smem == rows + (4 * 8 * bound.workspace if shared else 0)
    assert f"RES_FLOATS = {geo.resident_floats};" in bound.source
    floats = lp.generic_workspace_floats(geo, plan.blocks)
    assert floats == (0 if shared else plan.blocks * 8 * bound.workspace)


# --------------------------------------------------------------- build ----

# the entry points of kernels 5-7: on LogisticPGT, and on a generated
# functor
_HMC_ENTRY_POINTS = {
    "ghmc_fused.cu": ("ghmc_transition_launch", "ghmc_segment_launch",
                      "ghmc_blocks_per_sm"),
    "chees_fused.cu": ("chees_transition_launch", "chees_blocks_per_sm"),
    "hmc_generic.cu": ("ghmc_transition_generic_launch",
                       "ghmc_segment_generic_launch",
                       "chees_transition_generic_launch",
                       "hmc_generic_blocks_per_sm"),
}


def _c_params(text, name):
    """The parameter count of the C function ``name`` defined in ``text``."""
    m = re.search(rf"\bint {name}\(([^)]*)\)\s*{{", text)
    assert m, f"{name} is not defined"
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("source", sorted(_HMC_ENTRY_POINTS))
def test_every_new_entry_point_is_in_its_source_and_signature_table(source):
    text = (_build.CSRC / source).read_text()
    table = (_build.GENERIC_SIGNATURES if source in _build.GENERIC_TEMPLATES
             else _build.SIGNATURES[source])
    for name in _HMC_ENTRY_POINTS[source]:
        assert name in table, name
        assert _c_params(text, name) == len(table[name]), name
    # the launch counts of every instantiation, and no hierarchical one
    kernels = ("ghmc_transition", "ghmc_segment", "chees_transition")
    assert all(k + s in LAUNCHES for k in kernels for s in ("", "_generic"))
    assert not any(k + s in LAUNCHES for k in kernels
                   for s in ("_funnel", "_eight_schools"))
    assert "_pot_" not in text


def test_a_generated_library_holds_both_templates(tmp_path, monkeypatch):
    """One nvcc a functor text compiles the NUTS and the HMC templates into
    one library, keyed on both; without nvcc the build raises."""
    assert _build.GENERIC_TEMPLATES == ("nuts_generic.cu", "hmc_generic.cu")
    text = generic_pg.bind(_gauss_t, (torch.ones(4, 1),), 4).source
    if shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.load_generated(text)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc-stand-in")
    commands = []

    class Refused:
        def __init__(self, cmd, **_):
            commands.append(cmd)
            self.returncode = 1

        def communicate(self):
            return "refused", None

    monkeypatch.setattr(_build.subprocess, "Popen", Refused)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.load_generated(text)
    (cmd,) = commands
    assert [c for c in cmd if c.endswith(".cu") and "/csrc/" in c] == [
        str(_build.CSRC / t) for t in _build.GENERIC_TEMPLATES]
    assert (tmp_path / _build.generated_path(text).name.replace(
        "libgeneric_", "generic_").replace(".so", ".cu")).read_text() == text


def test_a_generated_library_is_looked_up_by_its_text(monkeypatch):
    """The wrappers look the library up at every launch: after the first
    load the lookup neither hashes the headers again (reading them from
    disk cost 2.2 ms a launch on the card's host) nor builds."""
    text = generic_pg.bind(_gauss_t, (torch.ones(4, 1),), 4).source
    paths, builds = [], []
    real_path = _build.generated_path
    monkeypatch.setattr(_build, "_generated_libs", {})
    monkeypatch.setattr(_build, "generated_path",
                        lambda t: paths.append(t) or real_path(t))
    monkeypatch.setattr(_build, "_build_missing",
                        lambda *a: builds.append(a))

    class Library:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            return type("Fn", (), {})()

    monkeypatch.setattr(_build.ctypes, "CDLL", Library)
    lib = _build.load_generated(text)
    assert _build.load_generated(text) is lib
    assert len(paths) == 1 and len(builds) == 1
    assert lib.path == str(real_path(text))


# --------------------------------------------------------- front door -----

VAR = torch.tensor([0.5, 1.0, 1.5, 2.0])


def _logprob(x):  # a bare logprob: no transposed potential, no data
    return -0.5 * torch.sum(x * x / VAR)


def _bare(algorithm, seed=0, draws=30, **kw):
    gen = torch.Generator().manual_seed(seed)
    q0 = torch.randn(16, 4, generator=gen)
    return aehmc_tpu_torch.sample(gen, _logprob, q0, draws, 40,
                                  algorithm=algorithm, path="fused", **kw)


@pytest.mark.parametrize("algorithm", ["mala", "ghmc", "chees", "meads"])
def test_front_door_on_a_bare_logprob_fn(algorithm):
    """The generic fused binding on the HMC-core routes (tests/test_api.py:
    96-230): finite draws of (draws, chains, dim), per-draw diagnostics,
    acceptance above 0.3; the same seed gives the same draws."""
    kw = dict(ghmc_alpha=0.7) if algorithm == "ghmc" else {}
    res = _bare(algorithm, **kw)
    assert isinstance(res, aehmc_tpu_torch.SampleResult)
    assert res.positions.shape == (30, 16, 4)
    assert bool(torch.isfinite(res.positions).all())
    acc = res.diagnostics.acceptance_probability
    assert acc.shape == (30, 16)
    assert res.diagnostics.num_integration_steps.dtype == torch.int32
    assert float(acc.mean()) > 0.3
    assert float(res.positions[:, :, 0].std()) > 0.0
    assert torch.equal(res.positions, _bare(algorithm, **kw).positions)
