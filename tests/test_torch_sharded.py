"""The port's sharded kernels and drivers (``mesh=``) against the unsharded
port and against the JAX package's ``shard_fused_*`` adapters.

Sizes are the JAX tests' (tests/test_fused_sharded.py): 32 chains, dim 4,
K 3, blocks of 4, the diagonal Gaussian potential.  The port runs on CPU
meshes that name the CPU 8 or 4 times (the plain versions, shard after
shard); JAX on the 8 virtual devices of tests/conftest.py with its
interpret-mode kernels.

- Sharded against unsharded port: bit for bit (the Philox counter carries
  the global chain index, and the Gaussian's arithmetic for a chain does
  not depend on the batch width).  XLA NUTS evaluates ``log1p``, whose
  SIMD lanes and scalar tail can differ in the last bit on the CPU, so its
  pooled runs are checked in a process with ``ATEN_CPU_CAPABILITY=default``
  (as tests/test_torch_xla_kernels.py checks a chain against its batch).
- Sharded port against sharded JAX, with the same external randomness: the
  decisions equal, floats to rtol 1e-4 (float32 sums in another order, the
  tolerance of tests/test_torch_fused_driver.py).
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aehmc_tpu.ops import chees_fused as jax_chees
from aehmc_tpu.ops import fused_driver as jax_driver
from aehmc_tpu.ops import ghmc_fused as jax_ghmc
from aehmc_tpu.ops import nuts_fused as jax_nf
from aehmc_tpu.ops import nuts_fused_small as jax_nfs
from aehmc_tpu.parallel import mesh as jax_mesh
import aehmc_tpu_torch
from aehmc_tpu_torch.ops import chees_fused, fused_driver, ghmc_fused
from aehmc_tpu_torch.ops import nuts_fused, nuts_fused_small
from aehmc_tpu_torch.parallel import (
    make_mesh,
    make_multislice_mesh,
    sample_sharded,
)

CHAINS, DIM, K, BLK = 32, 4, 3, 4
VAR = np.linspace(0.5, 2.0, DIM).astype(np.float32)
VAR_COL = torch.tensor(VAR).reshape(-1, 1)
RTOL = 1e-4
ROOT = Path(__file__).resolve().parents[1]
CPU = [torch.device("cpu")]
MESHES = {
    "dev8": lambda: make_mesh(devices=CPU * 8),
    "dev4": lambda: make_mesh(devices=CPU * 4),
    "slice2x4": lambda: make_multislice_mesh(2, devices=CPU * 8),
}


def _pot_t(q_t, var_col):
    return 0.5 * torch.sum(q_t * q_t / var_col, dim=0)


def _pg_t(q_t, var_col):
    return (0.5 * torch.sum(q_t * q_t / var_col, dim=0, keepdim=True),
            q_t / var_col)


def _pot_std(q, var_row):
    return 0.5 * torch.sum(q * q / var_row, dim=-1)


def _jax_pot_t(q_t, var_col):
    return 0.5 * jnp.sum(q_t * q_t / var_col, axis=0)


def _inputs(seed):
    """numpy inputs of one transition of every kernel: the state, the NUTS
    streams, the GHMC/ChEES noise and accept uniforms, ε and α rows."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(CHAINS, DIM)).astype(np.float32)
    U = (0.5 * np.sum(q.astype(np.float64) ** 2 / VAR, -1)).astype(np.float32)
    G = (q / VAR).astype(np.float32)
    p = rng.normal(size=(CHAINS, DIM)).astype(np.float32)
    dirs = np.where(rng.uniform(size=(CHAINS, K)) < 0.5, -1.0,
                    1.0).astype(np.float32)
    ub = rng.uniform(size=(CHAINS, K)).astype(np.float32)
    ul = rng.uniform(size=(CHAINS, 2**K)).astype(np.float32)
    noise = rng.normal(size=(CHAINS, DIM)).astype(np.float32)
    ua = rng.uniform(size=CHAINS).astype(np.float32)
    eps = rng.uniform(0.2, 0.6, size=CHAINS).astype(np.float32)
    alpha = rng.uniform(0.0, 0.9, size=CHAINS).astype(np.float32)
    return dict(q=q, U=U, G=G, p=p, dirs=dirs, ub=ub, ul=ul, noise=noise,
                ua=ua, eps=eps, alpha=alpha, im=np.ones(DIM, np.float32),
                imm_c=np.ones((CHAINS, DIM), np.float32))


# kernel -> (port transition, port shard adapter, its arguments from the
# inputs (external randomness, or a Philox seed when ``seed``), the stats'
# place in the outputs and their decision columns)
def _nuts_args(x, seed, u_col):
    u = x["U"].reshape(-1, 1) if u_col else x["U"]
    rand = ((None,) * 4 if seed else (x["p"], x["dirs"], x["ub"], x["ul"]))
    return (x["q"], u, x["G"], *rand, x["im"], 0.4)


KERNELS = {
    1: dict(
        port=lambda: nuts_fused_small.make_fused_nuts_transition_small(
            _pot_t, (VAR_COL,), max_num_expansions=K),
        jax=lambda: jax_nfs.make_fused_nuts_transition_small(
            _jax_pot_t, [jnp.asarray(VAR).reshape(-1, 1)],
            max_num_expansions=K, block_chains=BLK, interpret=True),
        port_shard=fused_driver.shard_fused_transition,
        jax_shard=jax_driver.shard_fused_transition,
        args=lambda x, seed: _nuts_args(x, seed, False),
        stats=3, decisions=slice(2, 6)),
    3: dict(
        port=lambda: nuts_fused.make_fused_nuts_transition(
            _pot_std, (torch.tensor(VAR).reshape(1, -1),),
            max_num_expansions=K),
        jax=lambda: jax_nf.make_fused_nuts_transition(
            lambda x, v: 0.5 * jnp.sum(x * x / v, axis=-1),
            (jnp.asarray(VAR).reshape(1, -1),), max_num_expansions=K,
            block_chains=BLK, interpret=True),
        port_shard=fused_driver.shard_fused_transition,
        jax_shard=jax_driver.shard_fused_transition,
        args=lambda x, seed: _nuts_args(x, seed, True),
        stats=3, decisions=slice(2, 6)),
    5: dict(
        port=lambda: ghmc_fused.make_fused_ghmc_transition(_pot_t, (VAR_COL,)),
        jax=lambda: jax_ghmc.make_fused_ghmc_transition(
            _jax_pot_t, [jnp.asarray(VAR).reshape(-1, 1)],
            block_chains=BLK, interpret=True),
        port_shard=ghmc_fused.shard_fused_ghmc_transition,
        jax_shard=jax_ghmc.shard_fused_ghmc_transition,
        args=lambda x, seed: (x["q"], x["U"], x["G"], x["p"], x["eps"],
                              x["alpha"], x["imm_c"]),
        kwargs=lambda x, seed: ({} if seed else
                                dict(noise=x["noise"], u_accept=x["ua"])),
        stats=4, decisions=slice(3, 5)),
    7: dict(
        port=lambda: chees_fused.make_fused_chees_transition(
            _pot_t, (VAR_COL,)),
        jax=lambda: jax_chees.make_fused_chees_transition(
            _jax_pot_t, [jnp.asarray(VAR).reshape(-1, 1)],
            block_chains=BLK, interpret=True),
        port_shard=chees_fused.shard_fused_chees_transition,
        jax_shard=jax_chees.shard_fused_chees_transition,
        args=lambda x, seed: (x["q"], x["U"], x["G"],
                              None if seed else x["p"],
                              None if seed else x["ua"], x["im"], x["eps"],
                              5),
        stats=3, decisions=slice(3, 5)),
}


def _torch(a):
    return torch.tensor(a) if isinstance(a, np.ndarray) else a


def _call(fn, kernel, x, seed=None):
    spec = KERNELS[kernel]
    args = [_torch(a) for a in spec["args"](x, seed)]
    kw = {k: _torch(v) for k, v in spec.get("kwargs", lambda *_: {})(
        x, seed).items()}
    if seed is not None:
        kw["seed"] = seed
    return fn(*args, **kw)


def _assert_bitwise(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.shape == y.shape and torch.equal(x, y)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_sharded_transition_is_the_unsharded_one_bitwise(kernel, mesh):
    """External randomness and a Philox seed, ε per chain (kernels 5 and 7)
    or scalar."""
    spec = KERNELS[kernel]
    tr = spec["port"]()
    sharded = spec["port_shard"](tr, MESHES[mesh](), CHAINS, BLK)
    x = _inputs(kernel)
    for seed in (None, 12345):
        _assert_bitwise(_call(tr, kernel, x, seed),
                        _call(sharded, kernel, x, seed))


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_a_shard_at_offset_o_is_columns_o_of_the_whole(kernel):
    """Under a Philox seed, the chains [o, o+n) run alone at chain_offset o
    are those chains of the whole batch's transition."""
    spec = KERNELS[kernel]
    tr = spec["port"]()
    x = _inputs(kernel + 10)
    whole = _call(tr, kernel, x, seed=777)
    lo, hi = 12, 20
    part = {k: (v[lo:hi] if isinstance(v, np.ndarray) and v.ndim
                and v.shape[0] == CHAINS else v) for k, v in x.items()}
    args = [_torch(a) for a in spec["args"](part, 777)]
    got = tr(*args, seed=777, chain_offset=lo)
    for a, b in zip(got, whole):
        assert torch.equal(a, b[lo:hi])
    # another offset draws other streams
    other = tr(*args, seed=777, chain_offset=0)
    assert not torch.equal(other[0], got[0])


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_sharded_transition_matches_jax_shard_adapter(kernel):
    """On the 8-device meshes, the port's sharded transition and JAX's
    ``shard_fused_*`` on the same external randomness: decisions equal,
    floats to rtol 1e-4."""
    spec = KERNELS[kernel]
    x = _inputs(kernel + 20)
    port = _call(spec["port_shard"](spec["port"](), MESHES["dev8"](),
                                    CHAINS, BLK), kernel, x)
    jax_sharded = spec["jax_shard"](spec["jax"](), jax_mesh.make_mesh(8),
                                    CHAINS, BLK)
    args = [jnp.asarray(a) for a in spec["args"](x, None)]
    kw = {k: jnp.asarray(v) for k, v in spec.get("kwargs", lambda *_: {})(
        x, None).items()}
    ref = jax.jit(lambda *a: jax_sharded(*a, **kw))(*args)
    s = spec["stats"]
    np.testing.assert_array_equal(port[s].numpy()[:, spec["decisions"]],
                                  np.asarray(ref[s])[:, spec["decisions"]])
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy().reshape(np.shape(b)),
                                   np.asarray(b), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_sharded_transition_rejects_bad_tiling(kernel):
    """The JAX adapters' errors (tests/test_fused_sharded.py:107): the chains
    do not split over the devices, or the block does not tile a shard."""
    spec = KERNELS[kernel]
    tr = spec["port"]()
    with pytest.raises(ValueError, match="do not shard"):
        spec["port_shard"](tr, MESHES["dev8"](), CHAINS + 4, BLK)
    with pytest.raises(ValueError, match="does not tile"):
        spec["port_shard"](tr, MESHES["dev8"](), CHAINS, 3)


# ------------------------------------------------------ the NUTS driver ----

def _q0(seed=2, dtype=np.float32):
    return 0.3 * np.random.default_rng(seed).normal(
        size=(CHAINS, DIM)).astype(dtype)


def _adaptive(mesh, **kw):
    kw.setdefault("potential_fn_t", _pot_t)
    return fused_driver.sample_fused_adaptive(
        torch.Generator().manual_seed(7), None, (VAR_COL,),
        torch.tensor(_q0()), 6, 10, max_num_expansions=K,
        initial_step_size=0.4, mesh=mesh, **kw)


ADAPTIVE_OPTIONS = {
    "philox": {},
    "external": dict(use_internal_prng=False),
    "loop_in_kernel": dict(loop_in_kernel=True),
    "per_chain_sorted": dict(per_chain_step_size=True, sort_by_depth=True,
                             per_chain_quantiles=3),
    "riffled_search": dict(step_size_factors=torch.linspace(0.8, 1.2, CHAINS),
                           search_initial_step_size=True),
    # kernel 3's driver: the standard-layout potential alone
    "standard_layout": dict(potential_fn_t=None),
}


@pytest.mark.parametrize("option", sorted(ADAPTIVE_OPTIONS))
def test_sample_fused_adaptive_on_a_mesh_is_the_unsharded_run(option):
    """ε, M⁻¹, the draws, stats and final positions bit for bit, on each of
    the three meshes."""
    kw = dict(ADAPTIVE_OPTIONS[option])
    data = (VAR_COL,)
    if option == "standard_layout":
        data = (torch.tensor(VAR).reshape(1, -1),)

    def run(mesh):
        return fused_driver.sample_fused_adaptive(
            torch.Generator().manual_seed(7), _pot_std, data,
            torch.tensor(_q0()), 6, 10, max_num_expansions=K,
            initial_step_size=0.4, mesh=mesh,
            **{"potential_fn_t": _pot_t, **kw})

    base = run(None)
    for name in sorted(MESHES):
        _assert_bitwise(base, run(MESHES[name]()))


def test_sample_fused_adaptive_checkpointed_on_a_mesh(tmp_path):
    """The checkpointed run on a mesh holds the joined state: a run killed
    after one segment and resumed (on another mesh shape) equals the
    unsharded uninterrupted one."""
    kw = dict(checkpoint_every=4, sort_by_depth=True)
    base = _adaptive(None, **kw, checkpoint_path=str(tmp_path / "a.npz"))
    path = str(tmp_path / "b.npz")
    assert _adaptive(MESHES["dev8"](), **kw, checkpoint_path=path,
                     _crash_after_segments=1) is None
    _assert_bitwise(base, _adaptive(MESHES["slice2x4"](), **kw,
                                    checkpoint_path=path, resume=True))


def test_warmup_through_the_sharded_transition_matches_jax():
    """The port's ``warmup_fused`` through ``shard_fused_transition`` against
    JAX's ``warmup_fused`` through its ``shard_fused_transition`` on the 8
    virtual devices, fed the same streams: ε and M⁻¹ to rtol 1e-4, the
    last step's decisions equal (test_torch_fused_driver.py's gate)."""
    steps = 12
    q0 = _q0(3)
    u0 = (0.5 * np.sum(q0.astype(np.float64) ** 2 / VAR, -1)).astype(
        np.float32).reshape(-1, 1)
    g0 = (q0 / VAR).astype(np.float32)
    key = jax.random.PRNGKey(4)
    jax_tr = jax_driver.shard_fused_transition(
        KERNELS[1]["jax"](), jax_mesh.make_mesh(8), CHAINS, BLK)
    (qj, _, _), eps_j, imm_j = jax_driver.warmup_fused(
        key, jax_tr, jnp.asarray(q0), jnp.asarray(u0), jnp.asarray(g0),
        steps, max_num_expansions=K, initial_step_size=0.4,
        use_internal_prng=False)
    # the raw streams of the JAX warmup's _external_randomness
    _, key_scan = jax.random.split(key)
    raw = []
    for k in jax.random.split(key_scan, steps):
        k1, k2, k3, k4 = jax.random.split(k, 4)
        raw.append(tuple(np.asarray(a, np.float32) for a in (
            jax.random.normal(k1, (CHAINS, DIM), jnp.float32),
            jnp.where(jax.random.uniform(k2, (CHAINS, K)) < 0.5, -1.0, 1.0),
            jax.random.uniform(k3, (CHAINS, K)),
            jax.random.uniform(k4, (CHAINS, 2**K)))))
    tr = fused_driver.shard_fused_transition(
        nuts_fused_small.make_fused_nuts_transition_small(
            _pot_t, (VAR_COL,), max_num_expansions=K, transposed_io=True),
        MESHES["dev8"](), CHAINS, BLK, transposed_io=True)
    (qp, _, _), eps_p, imm_p = fused_driver.warmup_fused(
        None, tr, torch.tensor(q0), torch.tensor(u0), torch.tensor(g0),
        steps, max_num_expansions=K, initial_step_size=0.4,
        use_internal_prng=False,
        streams=lambda t: tuple(torch.tensor(a) for a in raw[t]))
    np.testing.assert_allclose(float(eps_p), float(eps_j), rtol=RTOL)
    np.testing.assert_allclose(imm_p.numpy(), np.asarray(imm_j), rtol=RTOL)
    np.testing.assert_allclose(qp.numpy(), np.asarray(qj), rtol=RTOL,
                               atol=RTOL)


# ------------------------------------------------------ pooled drivers ----

def _lp(q):
    return -0.5 * torch.sum(q * q / torch.tensor(VAR, dtype=q.dtype))


POOLED = {
    "hmc": dict(num_integration_steps=4),
    "mala": {},
    "ghmc": {},
    "chees": {},
    "meads": dict(meads_recompute_every=3),
}


def _pooled(algorithm, mesh, **kw):
    q0 = torch.tensor(_q0(4, np.float64))
    rng = (torch.Generator().manual_seed(3) if algorithm == "chees" else 3)
    return sample_sharded(rng, _lp, q0, 6, 8, algorithm=algorithm,
                          initial_step_size=0.3, mesh=mesh,
                          **POOLED[algorithm], **kw)


def _assert_results_bitwise(a, b):
    assert torch.equal(a.positions, b.positions)
    _assert_bitwise(tuple(a.final_state), tuple(b.final_state))
    _assert_bitwise(tuple(a.diagnostics), tuple(b.diagnostics))
    assert torch.equal(a.step_size, b.step_size)
    assert torch.equal(a.inverse_mass_matrix, b.inverse_mass_matrix)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("algorithm", sorted(POOLED))
def test_sample_sharded_on_a_mesh_is_the_unsharded_run(algorithm, mesh):
    _assert_results_bitwise(_pooled(algorithm, None),
                            _pooled(algorithm, MESHES[mesh]()))


@pytest.mark.parametrize("algorithm", sorted(POOLED))
def test_sample_sharded_on_a_mesh_resumes(tmp_path, algorithm):
    """Checkpointed under a mesh, killed after one segment, resumed with
    another seed: the unsharded uninterrupted run, bit for bit."""
    kw = dict(checkpoint_every=3)
    base = _pooled(algorithm, None, **kw,
                   checkpoint_path=str(tmp_path / "a.npz"))
    path = str(tmp_path / "b.npz")
    assert _pooled(algorithm, MESHES["dev4"](), **kw, checkpoint_path=path,
                   _crash_after_segments=1) is None
    _assert_results_bitwise(base, _pooled(algorithm, MESHES["dev4"](), **kw,
                                          checkpoint_path=path, resume=True))


POOLED_NUTS_SCRIPT = textwrap.dedent("""
    import tempfile
    import numpy as np, torch
    from aehmc_tpu_torch.parallel import (make_mesh, make_multislice_mesh,
                                          sample_sharded)
    var = torch.tensor(np.linspace(0.5, 2.0, 4))
    lp = lambda q: -0.5 * torch.sum(q * q / var)
    q0 = torch.tensor(0.3 * np.random.default_rng(4).normal(size=(32, 4)))
    cpu = [torch.device("cpu")]

    def run(mesh, **kw):
        return sample_sharded(3, lp, q0, 6, 8, initial_step_size=0.3,
                              max_num_expansions=3, mesh=mesh, **kw)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(
            (a.positions, a.step_size, a.inverse_mass_matrix,
             *a.final_state, *a.diagnostics),
            (b.positions, b.step_size, b.inverse_mass_matrix,
             *b.final_state, *b.diagnostics)))

    base = run(None)
    for name, mesh in (("dev8", make_mesh(devices=cpu * 8)),
                       ("dev4", make_mesh(devices=cpu * 4)),
                       ("slice2x4", make_multislice_mesh(2, devices=cpu * 8))):
        print(name, "ok" if same(base, run(mesh)) else "DIFFERENT")
    with tempfile.TemporaryDirectory() as d:
        kw = dict(checkpoint_every=3, checkpoint_path=d + "/c.npz")
        assert run(make_mesh(devices=cpu * 4), _crash_after_segments=1,
                   **kw) is None
        resumed = run(make_mesh(devices=cpu * 4), resume=True, **kw)
        print("resumed", "ok" if same(base, resumed) else "DIFFERENT")
""")


def test_sample_sharded_nuts_on_a_mesh_is_the_unsharded_run():
    """XLA NUTS on the three meshes, and checkpointed on one and resumed,
    against the unsharded run, in a process whose ATen runs its scalar
    code in every lane."""
    env = dict(os.environ, ATEN_CPU_CAPABILITY="default",
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", POOLED_NUTS_SCRIPT], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count(" ok") == 4, out.stdout


def test_sample_sharded_takes_the_fused_kernels_on_a_mesh():
    """A fused ChEES kernel or MEADS transition built with ``mesh=`` runs as
    it is; one built without it is sharded by the driver; either way the
    unsharded run's bits.  The segment kernel has no shard adapter."""
    mesh = MESHES["dev4"]()
    q0 = torch.tensor(_q0(5))

    def chees(kernel_fn, m):
        return sample_sharded(torch.Generator().manual_seed(1), _lp, q0, 4, 6,
                              algorithm="chees", mesh=m,
                              chees_kernel_fn=kernel_fn)

    def kernel(**kw):
        return chees_fused.make_fused_chees_kernel(
            None, (VAR_COL,), potential_and_grad_t=_pg_t, **kw)

    base = chees(kernel(), None)
    _assert_results_bitwise(base, chees(kernel(), mesh))
    _assert_results_bitwise(base, chees(kernel(mesh=mesh, num_chains=CHAINS),
                                        mesh))

    def meads(transition_fn, m):
        return sample_sharded(5, _lp, q0, 4, 6, algorithm="meads", mesh=m,
                              meads_transition_fn=transition_fn)

    def transition(**kw):
        return ghmc_fused.make_fused_meads_transition(
            None, (VAR_COL,), potential_and_grad_t=_pg_t, **kw)

    base = meads(transition(), None)
    _assert_results_bitwise(base, meads(transition(), mesh))
    _assert_results_bitwise(base, meads(
        transition(mesh=mesh, num_chains=CHAINS), mesh))
    with pytest.raises(ValueError, match="no shard adapter"):
        sample_sharded(5, _lp, q0, 4, 6, algorithm="meads", mesh=mesh,
                       meads_segment_fn=ghmc_fused.make_fused_meads_segment(
                           None, (VAR_COL,), potential_and_grad_t=_pg_t))


def test_fused_chees_driver_on_a_mesh_is_the_unsharded_run():
    def run(mesh):
        return chees_fused.sample_fused_chees_adaptive(
            torch.Generator().manual_seed(2), None, (VAR_COL,),
            torch.tensor(_q0(6)), 4, 8, potential_and_grad_t=_pg_t,
            mesh=mesh)

    base = run(None)
    for name in ("dev8", "slice2x4"):
        out = run(MESHES[name]())
        assert torch.equal(base[0], out[0]) and torch.equal(base[1], out[1])
        _assert_bitwise(tuple(base[2]), tuple(out[2]))
        assert torch.equal(base[3].step_size, out[3].step_size)


# ---------------------------------------------------------- front door ----

@pytest.mark.parametrize("algorithm", ["nuts", "chees", "meads"])
def test_front_door_fused_routes_on_a_mesh(algorithm):
    """The fused NUTS, ChEES and MEADS routes take the mesh; MEADS then runs
    its per-draw transition kernel, so it is held against the unsharded
    driver on that kernel."""
    kw = dict(algorithm=algorithm, path="fused", data=(VAR_COL,),
              potential_and_grad_t=_pg_t)
    gen = lambda: torch.Generator().manual_seed(8)  # noqa: E731
    q0 = torch.tensor(_q0(7))
    if algorithm == "meads":
        base = sample_sharded(
            gen(), _lp, q0, 6, 8, algorithm="meads", meads_recompute_every=8,
            meads_transition_fn=ghmc_fused.make_fused_meads_transition(
                None, (VAR_COL,), potential_and_grad_t=_pg_t))
        meshes = ("dev8",)
    else:
        base = aehmc_tpu_torch.sample(gen(), _lp, q0, 6, 8, **kw)
        meshes = ("dev4", "slice2x4")
    for name in meshes:
        _assert_results_bitwise(base, aehmc_tpu_torch.sample(
            gen(), _lp, q0, 6, 8, mesh=MESHES[name](), **kw))


def test_front_door_mesh_errors():
    """Fused MALA and GHMC are single-host (the JAX package's error); the
    kernel adapters need the total chain count; a mesh the chains do not
    split over raises."""
    q0 = torch.tensor(_q0(8))
    mesh = MESHES["dev8"]()
    for algorithm in ("mala", "ghmc"):
        with pytest.raises(ValueError, match="single-host"):
            aehmc_tpu_torch.sample(0, _lp, q0, 2, 2, algorithm=algorithm,
                                   path="fused", data=(VAR_COL,),
                                   potential_and_grad_t=_pg_t, mesh=mesh)
    with pytest.raises(ValueError, match="requires num_chains"):
        chees_fused.make_fused_chees_kernel(None, (VAR_COL,), mesh=mesh)
    with pytest.raises(ValueError, match="do not shard"):
        aehmc_tpu_torch.sample(torch.Generator().manual_seed(0), _lp,
                               q0[:12], 2, 2, path="fused", data=(VAR_COL,),
                               potential_and_grad_t=_pg_t, mesh=mesh)


# ------------------------------------------------- the C entry points ----

def _c_params(text, name):
    """The parameter count of the C function ``name`` defined in ``text``."""
    import re

    m = re.search(rf"\bint {name}\(([^)]*)\)\s*{{", text)
    assert m, f"{name} is not defined"
    return len([p for p in m.group(1).split(",") if p.strip()])


@pytest.mark.parametrize("source", ["chees_fused.cu", "fused_hmc.cu",
                                    "generated", "ghmc_fused.cu",
                                    "leapfrog.cu", "nuts_fused.cu",
                                    "nuts_fused_small.cu"])
def test_every_entry_point_takes_the_chain_offset_after_its_seed(source):
    """Each C launcher has the parameter count of its ctypes signature, and
    every one that takes a Philox seed takes ``chain0`` right after it, but
    the GHMC segment's (kernel 6, never sharded: no chain offset)."""
    import re

    from aehmc_tpu_torch.ops import _build

    if source == "generated":
        text = "".join((_build.CSRC / t).read_text()
                       for t in _build.GENERIC_TEMPLATES)
        table = _build.GENERIC_SIGNATURES
    else:
        text = (_build.CSRC / source).read_text()
        table = _build.SIGNATURES[source]
    for name, argtypes in table.items():
        assert _c_params(text, name) == len(argtypes), name
    seeds = len(re.findall(r"unsigned int seed,", text))
    offsets = len(re.findall(r"unsigned int seed,\s*unsigned int chain0,",
                             text))
    segments = len(re.findall(r"unsigned int seed,\s*int num_draws,", text))
    assert seeds == offsets + segments
    assert segments == (1 if source in ("ghmc_fused.cu", "generated") else 0)
    # kernels 8 and 9 draw no randomness; every other launcher takes a key
    launchers = [n for n in table if n.endswith("_launch")]
    assert seeds == (0 if source in ("fused_hmc.cu", "leapfrog.cu")
                     else len(launchers))
