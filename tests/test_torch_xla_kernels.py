"""The XLA-path kernels (NUTS, HMC, MALA, GHMC) against the JAX package.

- ``nuts.new_externalized_kernel`` against JAX's, fed the same momentum,
  directions and uniforms, over scalar, diagonal and dense ``M⁻¹``, K 4-8
  and both leaf loops, with the reference's stability boundary (ε 3.9
  against 4.1 on N(1, 2²)): float64, 1e-12 relative, decisions equal; and
  against the NumPy oracle ``aehmc_tpu/ops/nuts_oracle.py``.
- HMC, MALA and GHMC fed JAX's own normals and uniforms (the draws of the
  JAX kernels' split keys), 1e-12 relative.
- A seeded step equals the externalized step fed the key's Philox streams,
  bit for bit (``nuts_streams`` for NUTS, ``ghmc_streams`` for MALA and
  GHMC).
- The XLA NUTS step at K 10 on Neal's funnel against kernel 1's plain
  version from one Philox seed (the deepest trees), float32.
- Batch invariance: chain ``c`` run alone (``Key(seed, c)``) equals row
  ``c`` of a 37-chain batch bit for bit, for all four kernels.  ATen's CPU
  kernels evaluate transcendental functions with SIMD code in full vector
  lanes and with the scalar code in a tensor's tail, so a value can differ
  in its last bit with its place in a tensor; the check runs in a process
  with ``ATEN_CPU_CAPABILITY=default``, where both are the scalar code.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aehmc_tpu import ghmc as jghmc
from aehmc_tpu import hmc as jhmc
from aehmc_tpu import mala as jmala
from aehmc_tpu import nuts as jnuts
from aehmc_tpu.models import normal as jnormal
from aehmc_tpu.ops.nuts_oracle import nuts_transition_oracle
from aehmc_tpu_torch import ghmc, hmc, keys, mala, metrics, nuts
from aehmc_tpu_torch.models import normal
from aehmc_tpu_torch.ops.philox import ghmc_streams, nuts_streams

RTOL = 1e-12
DIM = 3
SCALES = np.array([0.7, 1.3, 2.0])
ROOT = Path(__file__).resolve().parents[1]


def _lp_jax(q):
    return -0.5 * jnp.sum(q * q / SCALES) - jnp.sum(jnp.log1p(0.3 * q * q))


def _lp_torch(q):
    return (-0.5 * torch.sum(q * q / torch.tensor(SCALES), dim=-1)
            - torch.sum(torch.log1p(0.3 * q * q), dim=-1))


def _close(a, b):
    a, b = np.asarray(a), b.numpy()
    if a.dtype.kind in "biu":
        np.testing.assert_array_equal(b, a)
    else:
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=1e-300)


def _all_close(jout, tout):
    for ja, ta in zip(jout, tout):
        if isinstance(ja, tuple):
            _all_close(ja, ta)
        else:
            _close(ja, ta)


def _nuts_case(rng, chains, shape, k):
    return (rng.normal(size=(chains,) + shape),
            rng.normal(size=(chains,) + shape),
            np.where(rng.uniform(size=(chains, k)) < 0.5, -1.0, 1.0),
            rng.uniform(size=(chains, k)), rng.uniform(size=(chains, 2**k)))


def _run_externalized(jlp, tlp, imm, eps, k, paired, case):
    q, p, dirs, ub, ul = case
    jk = jnuts.new_externalized_kernel(jlp, k, paired_leaves=paired)
    jout, jinfo = jax.jit(jax.vmap(
        lambda q, p, d, b, l: jk(jnuts.new_state(q, jlp), p, d, b, l,
                                 jnp.asarray(eps), jnp.asarray(imm))))(
        *map(jnp.asarray, case))
    tk = nuts.new_externalized_kernel(tlp, k, paired_leaves=paired)
    tout, tinfo = tk(nuts.new_state(torch.tensor(q), tlp),
                     *map(torch.tensor, (p, dirs, ub, ul)), eps,
                     torch.tensor(imm))
    _all_close(jout, tout)
    _all_close(jinfo, tinfo)
    return tinfo


@pytest.mark.parametrize("form, k, paired", [
    ("diagonal", 5, True), ("diagonal", 8, False), ("dense", 6, True),
    ("dense", 4, False), ("scalar", 4, True), ("scalar", 7, False),
])
def test_externalized_nuts_matches_jax(form, k, paired):
    rng = np.random.default_rng(k + 10 * paired)
    if form == "scalar":
        # one scalar chain at a time: the scalar metric's position is ()
        jlp, tlp = jnormal(1.0, 2.0), normal(1.0, 2.0)
        imm = np.asarray(1.3)
        jk = jax.jit(jnuts.new_externalized_kernel(jlp, k,
                                                   paired_leaves=paired))
        for eps in (0.4, 1.7, 3.0):
            q, p, dirs, ub, ul = _nuts_case(rng, 1, (), k)
            jout = jk(jnuts.new_state(jnp.asarray(q[0]), jlp),
                      *map(jnp.asarray, (p[0], dirs[0], ub[0], ul[0])), eps,
                      jnp.asarray(imm))
            tk = nuts.new_externalized_kernel(tlp, k, paired_leaves=paired)
            tout = tk(nuts.new_state(torch.tensor(q[0]), tlp),
                      *map(torch.tensor, (p[0], dirs[0], ub[0], ul[0])), eps,
                      torch.tensor(imm))
            _all_close(jout, tout)
        return
    if form == "diagonal":
        imm = rng.uniform(0.5, 2.0, DIM)
    else:
        a = rng.normal(size=(DIM, DIM))
        imm = a @ a.T / DIM + np.eye(DIM)
    info = _run_externalized(_lp_jax, _lp_torch, imm, 0.6, k, paired,
                             _nuts_case(rng, 24, (DIM,), k))
    assert bool(info.is_turning.any())  # the U-turn ends most trees
    assert int(info.num_doublings.max()) >= 3


@pytest.mark.parametrize("paired", [True, False])
@pytest.mark.parametrize("eps, diverges", [(3.9, False), (4.1, None),
                                           (1e3, True)])
def test_externalized_nuts_stability_boundary(eps, diverges, paired):
    """N(1, 2²) integrates stably iff ε < 2σ.  Just past the boundary
    (4.1) the leapfrog's amplification is -1.55 a step, so the trajectory
    U-turns at its second leaf before |ΔE| reaches the threshold (the sign
    flips every step), and at 1e3 the first leaf diverges.  The port flags
    what JAX flags, and no position is ever non-finite."""
    rng = np.random.default_rng(7)
    jlp, tlp = jnormal(1.0, 2.0), normal(1.0, 2.0)
    k = 6
    jk = jax.jit(jnuts.new_externalized_kernel(jlp, k, paired_leaves=paired))
    tk = nuts.new_externalized_kernel(tlp, k, paired_leaves=paired)
    flags = []
    for _ in range(6):
        q, p, dirs, ub, ul = _nuts_case(rng, 1, (), k)
        jout, jinfo = jk(jnuts.new_state(jnp.asarray(q[0]), jlp),
                         *map(jnp.asarray, (p[0], dirs[0], ub[0], ul[0])),
                         eps, jnp.asarray(1.0))
        tout, tinfo = tk(nuts.new_state(torch.tensor(q[0]), tlp),
                         *map(torch.tensor, (p[0], dirs[0], ub[0], ul[0])),
                         eps, torch.tensor(1.0, dtype=torch.float64))
        _all_close(jout, tout)
        _all_close(jinfo, tinfo)
        flags.append(bool(tinfo.is_diverging))
        assert bool(torch.isfinite(tout.position))
    if diverges is not None:
        assert any(flags) == diverges


def test_externalized_nuts_matches_the_numpy_oracle():
    """The oracle's logistic posterior, per chain (both leaf loops)."""
    rng = np.random.default_rng(8)
    dim, points, k = 5, 24, 5
    X = rng.normal(size=(points, dim)) / np.sqrt(dim)
    y = (rng.uniform(size=points) < 0.5).astype(np.float64)
    Xt, yt = torch.tensor(X), torch.tensor(y)

    def logprob_fn(w):
        logits = Xt @ w
        return (torch.sum(yt * logits - torch.nn.functional.softplus(logits))
                - 0.5 * torch.sum(w * w))

    for paired in (True, False):
        tk = nuts.new_externalized_kernel(logprob_fn, k, paired_leaves=paired)
        for eps in (0.3, 0.9):
            q, p, dirs, ub, ul = _nuts_case(rng, 4, (dim,), k)
            for c in range(4):
                out, info = tk(nuts.new_state(torch.tensor(q[c]), logprob_fn),
                               *map(torch.tensor, (p[c], dirs[c], ub[c],
                                                   ul[c])),
                               eps, torch.ones(dim, dtype=torch.float64))
                ref = nuts_transition_oracle(q[c], p[c], X, y, np.ones(dim),
                                             eps, dirs[c], ub[c], ul[c], k)
                assert int(info.num_doublings) == ref["num_doublings"]
                assert (int(info.num_integration_steps)
                        == ref["num_integration_steps"])
                assert bool(info.is_diverging) == ref["is_diverging"]
                assert bool(info.is_turning) == ref["is_turning"]
                np.testing.assert_allclose(out.position.numpy(),
                                           ref["position"], atol=1e-8)
                assert float(info.acceptance_probability) == pytest.approx(
                    ref["acceptance_probability"], abs=1e-8)


def _jax_normals_uniforms(keys_, shape):
    """What the JAX kernels draw from each chain's key: ``split`` into a
    normal key and a uniform key (HMC, MALA, GHMC and ChEES alike)."""
    z, u = [], []
    for key in keys_:
        nk, uk = jax.random.split(key)
        z.append(np.asarray(jax.random.normal(nk, shape, jnp.float64)))
        u.append(float(jax.random.uniform(uk, (), jnp.float64)))
    return np.array(z), np.array(u)


@pytest.mark.parametrize("name", ["hmc", "mala", "ghmc"])
def test_one_step_kernels_match_jax(name):
    rng = np.random.default_rng(9)
    chains = 9
    q = rng.normal(size=(chains, DIM))
    imm = rng.uniform(0.5, 2.0, DIM)
    eps = rng.uniform(0.2, 0.9, chains)
    jkeys = jax.random.split(jax.random.PRNGKey(5), chains)
    z, u = _jax_normals_uniforms(jkeys, (DIM,))
    jimm, timm = jnp.asarray(imm), torch.tensor(imm)
    if name == "ghmc":
        p0 = rng.normal(size=(chains, DIM))
        jk = jghmc.new_kernel(_lp_jax, num_integration_steps=3)
        jstates = jax.vmap(lambda q, p: jnuts.new_state(q, _lp_jax))(
            jnp.asarray(q), jnp.asarray(p0))
        jstates = jghmc.IntegratorState(jstates.position, jnp.asarray(p0),
                                        jstates.potential_energy,
                                        jstates.potential_energy_grad)
        jout = jax.vmap(lambda k, s, e: jk(k, s, e, 0.8, jimm))(
            jkeys, jstates, jnp.asarray(eps))
        tk = ghmc.new_kernel(_lp_torch, num_integration_steps=3)
        tstate = ghmc.new_state(0, torch.tensor(q), _lp_torch)._replace(
            momentum=torch.tensor(p0))
        tout = tk((z, u), tstate, torch.tensor(eps), 0.8, timm)
    else:
        jk = {"hmc": lambda lp: (lambda k, s, e, m: jhmc.new_kernel(lp)(
            k, s, e, m, 7)), "mala": jmala.new_kernel}[name](_lp_jax)
        jstates = jax.vmap(lambda q: jhmc.new_state(q, _lp_jax))(
            jnp.asarray(q))
        jout = jax.vmap(lambda k, s, e: jk(k, s, e, jimm))(
            jkeys, jstates, jnp.asarray(eps))
        tstate = hmc.new_state(torch.tensor(q), _lp_torch)
        if name == "hmc":
            tout = hmc.new_kernel(_lp_torch)((z, u), tstate,
                                             torch.tensor(eps), timm, 7)
        else:
            tout = mala.new_kernel(_lp_torch)((z, u), tstate,
                                              torch.tensor(eps), timm)
    _all_close(jout, tout)
    accept = tout[1].acceptance_probability
    assert bool((accept < 1).any()) and bool((accept > 0).any())


def test_mala_rejects_a_dense_preconditioner():
    state = hmc.new_state(torch.zeros(2, dtype=torch.float64),
                          lambda q: -torch.sum(q * q))
    with pytest.raises(ValueError, match="diagonal"):
        mala.new_kernel(lambda q: -torch.sum(q * q))(0, state, 0.1,
                                                     torch.eye(2))


def _seeded_against_externalized(seed, position_t, k=6):
    """NUTS seeded by ``seed`` against the externalized step fed
    ``nuts_streams(seed)``, one batch."""
    imm = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)
    state = nuts.new_state(position_t, _lp_torch)
    out1, info1 = nuts.new_kernel(_lp_torch, k)(seed, state, 0.8, imm)
    z, dirs, ub, ul = nuts_streams(seed, position_t.shape[0], DIM, k)
    momentum = metrics.gaussian_metric(imm)[0](z.T.double())
    out2, info2 = nuts.new_externalized_kernel(_lp_torch, k)(
        state, momentum, dirs.T.double(), ub.T.double(), ul.T.double(), 0.8,
        imm)
    for a, b in zip(out1 + info1, out2 + info2):
        assert torch.equal(a, b)
    return info1


def test_seeded_steps_equal_the_externalized_steps_fed_their_streams():
    rng = np.random.default_rng(10)
    q = torch.tensor(rng.normal(size=(33, DIM)) * 2.0)
    info = _seeded_against_externalized(2024, q)
    # deep enough that the doublings past the eagerly drawn four read the
    # leaf stream drawn a doubling at a time
    info = _seeded_against_externalized(77, q, k=7)
    del info
    deep = nuts.new_kernel(_lp_torch, 7)(
        5, nuts.new_state(q, _lp_torch), 0.05,
        torch.ones(DIM, dtype=torch.float64))[1]
    assert int(deep.num_doublings.max()) >= 5
    # MALA and GHMC: the key's z and u are ghmc_streams'
    imm = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)
    z, u = ghmc_streams(31, 33, DIM)
    ext = (z.T.double(), u[0].double())
    state = hmc.new_state(q, _lp_torch)
    for a, b in zip(mala.new_kernel(_lp_torch)(31, state, 0.4, imm),
                    mala.new_kernel(_lp_torch)(ext, state, 0.4, imm)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    gstate = ghmc.new_state(3, q, _lp_torch)
    gk = ghmc.new_kernel(_lp_torch)
    for a, b in zip(gk(31, gstate, 0.4, 0.7, imm),
                    gk(ext, gstate, 0.4, 0.7, imm)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    # GHMC's initial momentum is the key's normals under M
    z3, _ = ghmc_streams(3, 33, DIM)
    assert torch.equal(gstate.momentum, z3.T.double())


BATCH_SCRIPT = textwrap.dedent("""
    import torch
    from aehmc_tpu_torch import ghmc, hmc, keys, mala, nuts
    S = torch.tensor([0.7, 1.3, 2.0], dtype=torch.float64)

    def lp(q):
        return (-0.5 * torch.sum(q * q / S, dim=-1)
                - torch.sum(torch.log1p(0.3 * q * q), dim=-1))

    gen = torch.Generator().manual_seed(0)
    q = 1.5 * torch.randn(37, 3, generator=gen, dtype=torch.float64)
    q[5] = 40.0  # a chain that diverges: its lane must not leak
    imm = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)
    eps = 0.3 + torch.rand(37, generator=gen, dtype=torch.float64)
    kernels = {
        "nuts": (nuts.new_kernel(lp, 6), lambda k, s, e: (s, e, imm)),
        "nuts_single": (nuts.new_kernel(lp, 6, paired_leaves=False),
                        lambda k, s, e: (s, e, imm)),
        "hmc": (hmc.new_kernel(lp), lambda k, s, e: (s, e, imm, 5)),
        "mala": (mala.new_kernel(lp), lambda k, s, e: (s, e, imm)),
        "ghmc": (ghmc.new_kernel(lp), lambda k, s, e: (s, e, 0.6, imm)),
    }
    for name, (kernel, args) in kernels.items():
        init = (ghmc.new_state if name == "ghmc" else
                (lambda key, x, f: hmc.new_state(x, f)))
        batch = init(keys.Key(9, 0), q, lp)
        for step in range(3):
            seed = 100 + step
            batch_out, batch_info = kernel(keys.Key(seed, 0),
                                           *args(None, batch, eps))
            for c in range(37):
                alone = init(keys.Key(9, c), q[c], lp) if step == 0 else one[c]
                out, info = kernel(keys.Key(seed, c),
                                   *args(None, alone, eps[c]))
                for a, b in zip(tuple(out) + tuple(info),
                                tuple(batch_out) + tuple(batch_info)):
                    assert torch.equal(a, b[c]), (name, step, c)
                if step == 0 and c == 0:
                    one = [None] * 37
                one[c] = out
            batch = batch_out
        diverged = bool(batch_info.is_diverging[5]) if hasattr(
            batch_info, "is_diverging") else None
        print(name, "ok", diverged)
""")


def test_chain_alone_equals_its_row_of_a_batch():
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", BATCH_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count(" ok ") == 5, out.stdout


def test_keys_split_and_offsets():
    a, b = keys.split(keys.Key(5, 3))
    assert a.chain_offset == b.chain_offset == 3 and a.seed != b.seed
    assert keys.split(5, 4) == keys.split(keys.Key(5), 4)
    gen = torch.Generator().manual_seed(1)
    assert isinstance(keys.as_key(gen), keys.Key)
    with pytest.raises(TypeError, match="key"):
        keys.as_key(1.5)



def test_xla_nuts_at_depth_10_on_the_funnel_agrees_with_kernel_1():
    """The deepest trees (up to 1,023 leaves: the paired loop's epilogue
    and checkpoint slots 5-9): one XLA NUTS step at K 10 on Neal's funnel
    (autograd gradients of ``neals_funnel``) against kernel 1's plain
    version with the ``FunnelPG`` functor's potential, float32 from N(0, 1)
    at ε 0.005, one Philox seed: decisions equal on at least 99% of chains,
    positions within 1e-3 on those (chip_smoke phase 21 holds kernel 1
    itself on the card)."""
    from aehmc_tpu_torch.models import neals_funnel, neals_funnel_pg_t
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs

    dim, chains, seed, eps = 10, 48, 1805, 0.005
    q_t = torch.tensor(np.random.default_rng(seed).standard_normal(
        (dim, chains)), dtype=torch.float32)
    lp, _ = neals_funnel(dim, device="cpu")
    _, pg, data, _ = neals_funnel_pg_t(dim, device="cpu")
    imm = torch.ones(dim)
    out, info = nuts.new_kernel(lp, 10)(
        seed, nuts.new_state(q_t.T.contiguous(), lp), eps, imm)
    u0, g0 = pg(q_t, *data)
    qk, _, _, stats = nfs.nuts_transition_plain(
        q_t, u0, g0, imm, eps, lambda x: pg(x, *data), max_exp=10, seed=seed)
    same = ((info.num_doublings == stats[2].to(torch.int32))
            & (info.num_integration_steps == stats[3].to(torch.int32))
            & (info.is_diverging == (stats[4] > 0.5))
            & (info.is_turning == (stats[5] > 0.5)))
    assert float(same.float().mean()) >= 0.99
    assert float((out.position - qk.T)[same].abs().max()) <= 1e-3
    doublings = info.num_doublings
    assert int(doublings.max()) == 10 and int((doublings >= 8).sum()) >= 24
