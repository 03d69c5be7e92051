"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without an NVIDIA GPU: a
CUDA kernel has no CPU mode.  This file imports no JAX, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Decisions (NUTS: doublings, leaves, divergent, turning; GHMC and ChEES:
accepted, divergent) must be equal; positions agree to 1e-4 (float32
products summed in another order than the plain version's matmuls).  With
bfloat16 operands (the model builder's default data) an f32 difference in
the last bit can move a bfloat16 rounding by one step (2^-8 relative) in one
operand of the gradient, so every kernel's positions agree to 1e-2 there.
The whole-run NUTS kernels equal one launch per draw bit for bit, the
standard-layout transition of q the transposed one of qᵀ, the GHMC segment
kernel its transitions, and the batched leapfrog kernel its plain version.

The XLA path on the card: one NUTS step from a Philox seed against kernel
1 fed the same seed, on the logistic posterior and at depth 10 on Neal's
funnel, and one XLA ChEES step on kernel 8 against the autograd leapfrog
(chip_smoke phases 20, 21 and 23 at test size), decisions equal on at
least 99% of chains.

The logistic functor's gradient at a kernel's own q_out is held against
float64, within 4× of the plain float32 gradient's error there (the bound
any float32-accurate product order meets, 3×TF32 included:
tests/test_torch_tf32.py), and rows of q with ±inf and NaN give the plain
version's non-finite pattern.
"""

import numpy as np
import pytest
import torch

import aehmc_tpu_torch
from aehmc_tpu_torch.models import logistic_regression_pg_t
from aehmc_tpu_torch.ops import LAUNCHES, reset_launch_counts
from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
from aehmc_tpu_torch.ops.nuts_fused_small import (
    _fused_sampling_call_t,
    make_fused_nuts_transition_small,
    nuts_transition_plain,
)
from aehmc_tpu_torch.ops.ghmc_fused import (
    ghmc_segment_cuda,
    ghmc_transition_cuda,
    ghmc_transition_plain,
)
from aehmc_tpu_torch.ops import (
    chees_fused,
    fused_driver,
    fused_hmc,
    ghmc_fused,
    nuts_fused,
)
from aehmc_tpu_torch.ops._build import load_kernels
from aehmc_tpu_torch.ops.fused_driver import sample_fused_adaptive
from aehmc_tpu_torch.ops.fused_hmc import fused_logistic_hmc_reference
from aehmc_tpu_torch.ops.launch_plan import launch_plan
from aehmc_tpu_torch.ops.leapfrog import batched_leapfrog_reference
from aehmc_tpu_torch.ops.philox import MASK32

DIM, POINTS, CHAINS, MAX_EXP = 8, 64, 64, 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(device, dense):
    _, pg, data, _ = logistic_regression_pg_t(
        DIM, POINTS, matmul_dtype=torch.float32, device=device)
    rng = np.random.default_rng(0)
    q_t = torch.tensor(0.1 * rng.normal(size=(DIM, CHAINS)),
                       dtype=torch.float32, device=device)
    if dense:
        A = rng.normal(size=(DIM, DIM))
        imm = A @ A.T / DIM + np.eye(DIM)
    else:
        imm = np.full(DIM, 0.9)
    imm = torch.tensor(imm, dtype=torch.float32, device=device)
    u0, g0 = pg(q_t, *data)
    ext = dict(
        momentum=rng.normal(size=(DIM, CHAINS)),
        directions=np.where(rng.uniform(size=(MAX_EXP, CHAINS)) < 0.5, -1.0, 1.0),
        u_bias=rng.uniform(size=(MAX_EXP, CHAINS)),
        u_leaf=rng.uniform(size=(2**MAX_EXP, CHAINS)),
    )
    ext = {k: torch.tensor(v, dtype=torch.float32, device=device)
           for k, v in ext.items()}
    return pg, data, q_t, u0, g0, imm, ext


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("philox", [False, True])
def test_cuda_transition_matches_plain(cuda_device, dense, philox):
    pg, data, q_t, u0, g0, imm, ext = _case(cuda_device, dense)
    streams = dict(seed=77) if philox else ext
    kern = make_fused_nuts_transition_small(
        None, data, max_num_expansions=MAX_EXP, potential_and_grad_t=pg,
        transposed_io=True,
    )(q_t, u0, g0, ext["momentum"], ext["directions"], ext["u_bias"],
      ext["u_leaf"], imm, 0.3, seed=streams.get("seed"))
    plain = nuts_transition_plain(
        q_t, u0, g0, imm, 0.3, lambda x: pg(x, *data), max_exp=MAX_EXP,
        **streams,
    )
    torch.cuda.synchronize()
    np.testing.assert_array_equal(kern[3][2:6].cpu(), plain[3][2:6].cpu())
    for a, b in zip(kern[:3], plain[:3]):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [False, True])
def test_cuda_whole_run_equals_per_draw_launches(cuda_device, dense):
    pg, data, q_t, u0, g0, imm, _ = _case(cuda_device, dense)
    draws = 4
    pos, stats, qf, uf, gf = _fused_sampling_call_t(
        None, pg, data, q_t, u0, g0, imm, 0.3, 5, draws,
        max_num_expansions=MAX_EXP,
    )
    transition = make_fused_nuts_transition_small(
        None, data, max_num_expansions=MAX_EXP, potential_and_grad_t=pg,
        transposed_io=True,
    )
    q, u, g = q_t, u0, g0
    for t in range(draws):
        q, u, g, st = transition(q, u, g, None, None, None, None, imm, 0.3,
                                 seed=(5 + t * DRAW_SEED_STRIDE) & MASK32)
        assert torch.equal(st, stats[t]) and torch.equal(q, pos[t])
    assert torch.equal(q, qf) and torch.equal(u, uf) and torch.equal(g, gf)


@pytest.mark.gpu
def test_cuda_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    pg, data, q_t, u0, g0, imm, _ = _case(cuda_device, False)
    transition = make_fused_nuts_transition_small(  # bessel_j0: no rule
        lambda q, *d: torch.special.bessel_j0(q).sum(0), data,
        max_num_expansions=MAX_EXP, transposed_io=True,
    )
    with pytest.raises(NotImplementedError, match=r"aten\.special_bessel_j0"):
        transition(q_t, u0, g0, None, None, None, None, imm, 0.3, seed=1)
    transition = make_fused_nuts_transition_small(
        None, data, max_num_expansions=MAX_EXP, potential_and_grad_t=pg,
        transposed_io=True,
    )
    with pytest.raises(ValueError, match="contiguous"):
        transition(q_t.T.contiguous().T, u0, g0, None, None, None, None, imm,
                   0.3, seed=1)
    with pytest.raises(TypeError, match="float32"):
        transition(q_t.double(), u0, g0, None, None, None, None, imm, 0.3,
                   seed=1)


@pytest.mark.gpu
def test_front_door_on_the_card_runs_both_kernels(cuda_device):
    pot, pg, data, _ = logistic_regression_pg_t(dim=16, num_points=128,
                                                matmul_dtype=torch.float32,
                                                device=cuda_device)
    gen = torch.Generator().manual_seed(0)
    q0 = (0.1 * torch.randn(256, 16, generator=gen)).to(cuda_device)
    reset_launch_counts()
    res = aehmc_tpu_torch.sample(
        gen, None, q0, 50, 30, data=data, potential_fn_t=pot,
        potential_and_grad_t=pg, collect_dtype=torch.bfloat16,
    )
    assert LAUNCHES == {"nuts_transition": 30, "nuts_sampling": 1,
                        "nuts_transition_funnel": 0,
                        "nuts_sampling_funnel": 0,
                        "nuts_transition_eight_schools": 0,
                        "nuts_sampling_eight_schools": 0,
                        "nuts_transition_generic": 0,
                        "nuts_sampling_generic": 0,
                        "nuts_transition_std": 0, "nuts_sampling_std": 0,
                        "nuts_transition_std_generic": 0,
                        "nuts_sampling_std_generic": 0,
                        "chees_transition": 0, "ghmc_transition": 0,
                        "ghmc_segment": 0,
                        "chees_transition_generic": 0,
                        "ghmc_transition_generic": 0,
                        "ghmc_segment_generic": 0,
                        "fused_logistic_hmc": 0, "batched_leapfrog": 0}
    assert res.positions.dtype == torch.bfloat16 and res.positions.is_cuda
    assert bool(torch.isfinite(res.positions.float()).all())


def _ghmc_case(device, per_chain):
    _, pg, data, _ = logistic_regression_pg_t(
        DIM, POINTS, matmul_dtype=torch.float32, device=device)
    rng = np.random.default_rng(1)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    q_t = f32(0.3 * rng.normal(size=(DIM, CHAINS)))
    p_t = f32(rng.normal(size=(DIM, CHAINS)))
    u0, g0 = pg(q_t, *data)
    if per_chain:
        params = (f32(rng.uniform(0.2, 0.8, size=CHAINS)),
                  f32(rng.uniform(0.0, 0.95, size=CHAINS)),
                  f32(rng.uniform(0.5, 1.5, size=(CHAINS, DIM))))
    else:
        params = (0.5, 0.9, f32(np.full(DIM, 0.8)))
    ext = dict(noise=f32(rng.normal(size=(DIM, CHAINS))),
               u_accept=f32(rng.uniform(size=(1, CHAINS))))
    return pg, data, (q_t, u0, g0, p_t), params, ext


@pytest.mark.gpu
@pytest.mark.parametrize("per_chain", [False, True])
@pytest.mark.parametrize("philox", [False, True])
def test_cuda_ghmc_transition_matches_plain(cuda_device, per_chain, philox):
    pg, data, state, params, ext = _ghmc_case(cuda_device, per_chain)
    rand = dict(seed=91) if philox else ext
    kern = ghmc_transition_cuda(*state, *params, data, **rand)
    plain = ghmc_transition_plain(*state, *params, lambda x: pg(x, *data),
                                  **rand)
    torch.cuda.synchronize()
    moved_k = (kern[0] != state[0]).any(dim=0)
    moved_p = (plain[0] != state[0]).any(dim=0)
    assert torch.equal(moved_k, moved_p) and bool(moved_k.any())
    assert torch.equal(kern[4][2:5], plain[4][2:5])
    for a, b in zip(kern, plain):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("philox", [False, True])
def test_cuda_ghmc_segment_equals_transition_launches(cuda_device, philox):
    pg, data, state, params, _ = _ghmc_case(cuda_device, True)
    draws, seed = 5, 17
    rng = np.random.default_rng(2)
    noise = torch.tensor(rng.normal(size=(draws, DIM, CHAINS)),
                         dtype=torch.float32, device=cuda_device)
    ua = torch.tensor(rng.uniform(size=(draws, CHAINS)), dtype=torch.float32,
                      device=cuda_device)
    rand = dict(seed=seed) if philox else dict(noise=noise, u_accept=ua)
    pos, stats, *final = ghmc_segment_cuda(*state, *params, data, draws,
                                           **rand)
    for t in range(draws):
        rand = (dict(seed=(seed + t * DRAW_SEED_STRIDE) & MASK32) if philox
                else dict(noise=noise[t].contiguous(), u_accept=ua[t]))
        *state, st = ghmc_transition_cuda(*state, *params, data, **rand)
        assert torch.equal(st, stats[t]) and torch.equal(state[0], pos[t])
    for a, b in zip(final, state):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("chains", [64, 13])
def test_cuda_leapfrog_kernels_match_plain(cuda_device, chains):
    rng = np.random.default_rng(3)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda_device)

    q, p = f32(rng.normal(size=(chains, DIM))), f32(rng.normal(size=(chains, DIM)))
    lam, im = f32(np.linspace(0.5, 2.0, DIM)), f32(np.linspace(0.8, 1.2, DIM))
    reset_launch_counts()
    out = aehmc_tpu_torch.ops.batched_leapfrog(q, p, lam, im, 0.05, 7)
    ref = batched_leapfrog_reference(q, p, lam, im, 0.05, 7)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])
    X, y = logistic_regression_pg_t(DIM, POINTS, matmul_dtype=torch.float32,
                                    device=cuda_device)[2][::2]
    out = aehmc_tpu_torch.ops.fused_logistic_hmc(q, p, X, y.reshape(-1), im,
                                                 0.05, 5, 2.0)
    ref = fused_logistic_hmc_reference(q, p, X, y.reshape(-1), im, 0.05, 5,
                                       2.0)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)
    assert LAUNCHES["batched_leapfrog"] == 1
    assert LAUNCHES["fused_logistic_hmc"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["mala", "ghmc"])
def test_front_door_mala_and_ghmc_on_the_card(cuda_device, algorithm):
    pot, pg, data, _ = logistic_regression_pg_t(dim=16, num_points=128,
                                                matmul_dtype=torch.float32,
                                                device=cuda_device)
    gen = torch.Generator().manual_seed(0)
    q0 = (0.1 * torch.randn(256, 16, generator=gen)).to(cuda_device)
    reset_launch_counts()
    res = aehmc_tpu_torch.sample(
        gen, None, q0, 50, 30, algorithm=algorithm, path="fused", data=data,
        potential_fn_t=pot, potential_and_grad_t=pg, segment_draws=16,
    )
    assert LAUNCHES["ghmc_transition"] == 30 and LAUNCHES["ghmc_segment"] == 4
    assert res.positions.shape == (50, 256, 16) and res.positions.is_cuda
    assert bool(torch.isfinite(res.positions).all())


def _std_case(device, chains=13):
    """A ragged block of the standard layout: 13 chains, 8 a block."""
    _, pg, data, _ = logistic_regression_pg_t(
        DIM, POINTS, matmul_dtype=torch.float32, device=device)
    rng = np.random.default_rng(4)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    q = f32(0.3 * rng.normal(size=(chains, DIM)))
    u_t, g_t = pg(q.T.contiguous(), *data)
    ext = dict(momentum=f32(rng.normal(size=(chains, DIM))),
               directions=f32(np.where(rng.uniform(size=(chains, MAX_EXP)) < 0.5,
                                       -1.0, 1.0)),
               u_bias=f32(rng.uniform(size=(chains, MAX_EXP))),
               u_leaf=f32(rng.uniform(size=(chains, 2**MAX_EXP))))
    return pg, data, q, u_t.reshape(-1), g_t.T.contiguous(), ext


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("philox", [False, True])
@pytest.mark.parametrize("num_steps", [1, 6])
def test_cuda_chees_transition_matches_plain(cuda_device, dense, philox,
                                             num_steps):
    pg, data, q, u, g, ext = _std_case(cuda_device)
    rng = np.random.default_rng(5)
    if dense:
        A = rng.normal(size=(DIM, DIM))
        imm = A @ A.T / DIM + np.eye(DIM)
        eps = torch.tensor(rng.uniform(0.2, 0.5, size=13), dtype=torch.float32,
                           device=cuda_device)
    else:
        imm, eps = np.full(DIM, 0.8), 0.4
    imm = torch.tensor(imm, dtype=torch.float32, device=cuda_device)
    rand = (dict(seed=33) if philox else
            dict(momentum=ext["momentum"], u_accept=ext["u_bias"][:, 0].contiguous()))
    steps = torch.full((), num_steps, dtype=torch.int32, device=cuda_device)
    reset_launch_counts()
    kern = chees_fused.chees_transition_cuda(q, u, g, imm, eps, steps, data,
                                             **rand)
    plain = chees_fused.chees_transition_plain(
        q, u, g, imm, eps, num_steps, lambda x: pg(x, *data), **rand)
    torch.cuda.synchronize()
    assert LAUNCHES["chees_transition"] == 1
    moved_k, moved_p = ((o[0] != q).any(dim=1) for o in (kern, plain))
    assert torch.equal(moved_k, moved_p) and bool(moved_k.any())
    assert torch.equal(kern[3][:, 2:5], plain[3][:, 2:5])
    assert bool((kern[3][:, 3] == num_steps).all())
    for a, b in zip(kern, plain):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("philox", [False, True])
def test_cuda_standard_nuts_transition_matches_plain(cuda_device, bf16, philox):
    pg, data, q, u, g, ext = _std_case(cuda_device)
    X, y = data[0], data[2].reshape(-1)
    mdt = torch.bfloat16 if bf16 else torch.float32
    streams = dict(seed=71) if philox else ext
    full = {**dict.fromkeys(("momentum", "directions", "u_bias", "u_leaf")),
            **streams}
    imm = torch.full((DIM,), 0.9, device=cuda_device)
    reset_launch_counts()
    kern = nuts_fused.fused_nuts_transition(
        q, u.reshape(-1, 1), g, full["momentum"], full["directions"],
        full["u_bias"], full["u_leaf"], X, y, imm, 0.3, MAX_EXP,
        matmul_dtype=mdt, seed=streams.get("seed"))
    model = nuts_fused._logistic_model(X, y, 1.0, mdt)
    plain = nuts_fused.nuts_transition_std_plain(
        q, u, g, imm, 0.3, model.pot_grad,
        max_exp=MAX_EXP, **streams)
    torch.cuda.synchronize()
    assert LAUNCHES["nuts_transition_std"] == 1
    np.testing.assert_array_equal(kern[3][:, 2:6].cpu(), plain[3][:, 2:6].cpu())
    tol = 1e-2 if bf16 else 1e-4
    for a, b in zip(kern[:3], plain[:3]):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True])
def test_cuda_standard_kernels_are_the_transposed_ones_and_the_whole_run(
        cuda_device, bf16):
    pg, data, q, u, g, _ = _std_case(cuda_device)
    imm = torch.full((DIM,), 0.9, device=cuda_device)
    model = nuts_fused._logistic_model(data[0], data[2].reshape(-1), 1.0,
                                       torch.bfloat16 if bf16 else torch.float32)
    if not bf16:  # kernel 3 on q is kernel 1 on qᵀ
        std = nuts_fused.nuts_transition_std_cuda(
            q, u, g, imm, 0.3, model.data, max_exp=MAX_EXP, seed=8)
        tr = make_fused_nuts_transition_small(
            None, data, max_num_expansions=MAX_EXP, potential_and_grad_t=pg,
            transposed_io=True)(q.T.contiguous(), u.reshape(1, -1),
                                g.T.contiguous(), None, None, None, None, imm,
                                0.3, seed=8)
        for a, b in zip(std, tr):
            assert torch.equal(a, b.T.reshape(a.shape))
    draws, seed = 4, 19
    pos, stats, *final = nuts_fused.nuts_sampling_std_cuda(
        q, u, g, imm, 0.3, model.data, seed, draws, max_exp=MAX_EXP,
        card=model.card)
    state = (q, u.reshape(-1, 1), g)
    for t in range(draws):
        *state, st = nuts_fused.nuts_transition_std_cuda(
            *state, imm, 0.3, model.data, max_exp=MAX_EXP, card=model.card,
            seed=(seed + t * DRAW_SEED_STRIDE) & MASK32)
        assert torch.equal(st, stats[t]) and torch.equal(state[0], pos[t])
    for a, b in zip(final, state):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_front_door_chees_and_standard_driver_on_the_card(cuda_device):
    pot, pg, data, _ = logistic_regression_pg_t(dim=16, num_points=128,
                                                matmul_dtype=torch.float32,
                                                device=cuda_device)
    X = data[0]

    def logprob_fn(w):
        logits = X @ w
        return (torch.sum(data[2].reshape(-1) * logits
                          - torch.nn.functional.softplus(logits))
                - 0.5 * torch.sum(w * w))

    gen = torch.Generator().manual_seed(0)
    q0 = (0.1 * torch.randn(256, 16, generator=gen)).to(cuda_device)
    reset_launch_counts()
    res = aehmc_tpu_torch.sample(
        gen, logprob_fn, q0, 40, 30, algorithm="chees", path="fused",
        data=data, potential_and_grad_t=pg)
    probes = LAUNCHES["chees_transition"] - 70
    assert 1 <= probes <= 32
    assert res.positions.shape == (40, 256, 16) and res.positions.is_cuda
    assert bool(torch.isfinite(res.positions).all())
    reset_launch_counts()
    out = sample_fused_adaptive(
        gen, nuts_fused.logistic_potential,
        (X, data[1], data[2].reshape(1, -1)), q0, 20, 30,
        max_num_expansions=MAX_EXP)
    assert LAUNCHES["nuts_transition_std"] == 50
    assert out[1].shape == (20, 256, 16) and bool(torch.isfinite(out[1]).all())


def _ragged_state(device, dim, points, chains, seed):
    _, pg, data, _ = logistic_regression_pg_t(
        dim, points, matmul_dtype=torch.float32, device=device)
    rng = np.random.default_rng(seed)
    q = torch.tensor(0.3 * rng.normal(size=(chains, dim)), dtype=torch.float32,
                     device=device)
    u_t, g_t = pg(q.T.contiguous(), *data)
    return pg, data, q, u_t.reshape(-1), g_t.T.contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("chains", [1, 9, 17])
@pytest.mark.parametrize("dim", [8, 13])
def test_cuda_ragged_chain_counts_match_plain(cuda_device, chains, dim):
    """Kernels 7 and 3 on chain counts that leave the last block part-filled,
    and at a dim whose rows of X the wrapper pads to 16 bytes."""
    pg, data, q, u, g = _ragged_state(cuda_device, dim, POINTS, chains, 6)
    imm = torch.full((dim,), 0.9, device=cuda_device)
    steps = torch.full((), 4, dtype=torch.int32, device=cuda_device)
    kern = chees_fused.chees_transition_cuda(q, u, g, imm, 0.3, steps, data,
                                             seed=5)
    plain = chees_fused.chees_transition_plain(
        q, u, g, imm, 0.3, 4, lambda x: pg(x, *data), seed=5)
    torch.cuda.synchronize()
    assert torch.equal(kern[3][:, 2:5], plain[3][:, 2:5])
    for a, b in zip(kern, plain):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)
    model = nuts_fused._logistic_model(data[0], data[2].reshape(-1), 1.0,
                                       torch.float32)
    kern = nuts_fused.nuts_transition_std_cuda(q, u, g, imm, 0.3, model.data,
                                               max_exp=MAX_EXP, seed=6)
    plain = nuts_fused.nuts_transition_std_plain(q, u, g, imm, 0.3,
                                                 model.pot_grad,
                                                 max_exp=MAX_EXP, seed=6)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(kern[3][:, 2:6].cpu(), plain[3][:, 2:6].cpu())
    for a, b in zip(kern[:3], plain[:3]):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_nuts_core_at_the_shared_memory_edge(cuda_device):
    """K 6 at dim 392, the widest the NUTS core takes (an 8-point tile,
    228 KB a block; the checkpoints are in the global buffer)."""
    dim, k = 392, 6
    pg, data, q, u, g = _ragged_state(cuda_device, dim, POINTS, 12, 7)
    imm = torch.full((dim,), 0.9, device=cuda_device)
    model = nuts_fused._logistic_model(data[0], data[2].reshape(-1), 1.0,
                                       torch.float32)
    kern = nuts_fused.nuts_transition_std_cuda(q, u, g, imm, 0.05, model.data,
                                               max_exp=k, seed=8)
    plain = nuts_fused.nuts_transition_std_plain(q, u, g, imm, 0.05,
                                                 model.pot_grad, max_exp=k,
                                                 seed=8)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(kern[3][:, 2:6].cpu(), plain[3][:, 2:6].cpu())
    for a, b in zip(kern[:3], plain[:3]):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_cuda_hmc_core_with_a_small_tile_of_x(cuda_device):
    """At dim 700 the HMC core's tile of X holds 16 points."""
    dim = 700
    pg, data, q, u, g = _ragged_state(cuda_device, dim, POINTS, 9, 9)
    imm = torch.full((dim,), 0.5, device=cuda_device)
    steps = torch.full((), 3, dtype=torch.int32, device=cuda_device)
    kern = chees_fused.chees_transition_cuda(q, u, g, imm, 0.02, steps, data,
                                             seed=10)
    plain = chees_fused.chees_transition_plain(
        q, u, g, imm, 0.02, 3, lambda x: pg(x, *data), seed=10)
    torch.cuda.synchronize()
    assert torch.equal(kern[3][:, 2:5], plain[3][:, 2:5])
    for a, b in zip(kern, plain):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)


def _grad64(data, q_t):
    X, XT, y = (d.double() for d in data)
    q = q_t.double()
    return XT @ (torch.sigmoid(X @ q) - y) + q


def _assert_gradient_near_float64(pg, data, q_t, g_t):
    """The kernel's gradient at its own q_out against float64: within 4× of
    the plain float32 gradient's error there (plus 1e-6 relative, for the
    shapes where float32 is nearly exact)."""
    exact = _grad64(data, q_t)
    err = float((g_t.double() - exact).abs().max())
    err_plain = float((pg(q_t, *data)[1].double() - exact).abs().max())
    assert err <= 4 * err_plain + 1e-6 * (1 + float(exact.abs().max())), (
        err, err_plain)


@pytest.mark.gpu
@pytest.mark.parametrize("points", [1000, 37])
@pytest.mark.parametrize("core,dim", [("nuts", d)
                                      for d in (1, 7, 100, 101, 224, 392)]
                         + [("hmc", d) for d in (1, 7, 100, 101, 700)])
def test_cuda_functor_gradient_against_float64(cuda_device, core, dim, points):
    """Kernel 1 (the NUTS core, 128 to 8 points a tile, at the shared-memory
    edge at dim 392) and kernel 5 (the HMC core, 16 points at dim 700), at
    point counts no chunk of X divides."""
    from aehmc_tpu_torch.ops.nuts_fused_small import nuts_transition_cuda

    _, pg, data, _ = logistic_regression_pg_t(
        dim, points, matmul_dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(dim + points)
    q_t = torch.tensor(0.3 * rng.normal(size=(dim, 13)), dtype=torch.float32,
                       device=cuda_device)
    u0, g0 = pg(q_t, *data)
    imm = torch.full((dim,), 0.5, device=cuda_device)
    eps = 0.02 / max(1.0, dim / 100)
    if core == "nuts":
        q, _, g, _ = nuts_transition_cuda(q_t, u0, g0, imm, eps, data,
                                          max_exp=6, seed=dim)
    else:
        p0 = torch.tensor(rng.normal(size=(dim, 13)), dtype=torch.float32,
                          device=cuda_device)
        q, _, g, _, _ = ghmc_transition_cuda(q_t, u0, g0, p0, eps, 0.0, imm,
                                             data, seed=dim)
    torch.cuda.synchronize()
    assert bool((q != q_t).any())  # some chains moved: g is the kernel's
    _assert_gradient_near_float64(pg, data, q, g)


@pytest.mark.gpu
@pytest.mark.parametrize("dim", [7, 100])
def test_cuda_non_finite_rows_of_q_match_plain(cuda_device, dim):
    """Kernel 7 from rows of q holding +inf, −inf and NaN: the clipped
    gradients at the proposals (in the proposed velocities) and the proposed
    positions have the plain version's non-finite pattern."""
    _, pg, data, _ = logistic_regression_pg_t(
        dim, 37, matmul_dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(11)
    q = torch.tensor(0.3 * rng.normal(size=(13, dim)), dtype=torch.float32,
                     device=cuda_device)
    q[1, 3 % dim], q[2, 5 % dim], q[3, 0] = np.inf, -np.inf, np.nan
    q[4, :] = np.inf
    u = torch.zeros(13, device=cuda_device)
    g = torch.zeros(13, dim, device=cuda_device)
    imm = torch.full((dim,), 0.9, device=cuda_device)
    kern = chees_fused.chees_transition_cuda(q, u, g, imm, 0.1, 2, data, seed=4)
    plain = chees_fused.chees_transition_plain(q, u, g, imm, 0.1, 2,
                                               lambda x: pg(x, *data), seed=4)
    torch.cuda.synchronize()
    for a, b in zip(kern, plain):
        a, b = a.cpu(), b.cpu()
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isposinf(a), torch.isposinf(b))
        assert torch.equal(torch.isneginf(a), torch.isneginf(b))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("points", [1000, 37])
@pytest.mark.parametrize("dim", [7, 100])
def test_cuda_bf16_operands_match_plain_bf16(cuda_device, dim, points):
    """Kernel 3 with bfloat16 operands held to its plain bf16 version at
    1e-2, at point counts no chunk of X divides."""
    _, _, data, _ = logistic_regression_pg_t(
        dim, points, matmul_dtype=torch.float32, device=cuda_device)
    rng = np.random.default_rng(12)
    q = torch.tensor(0.3 * rng.normal(size=(13, dim)), dtype=torch.float32,
                     device=cuda_device)
    model = nuts_fused._logistic_model(data[0], data[2].reshape(-1), 1.0,
                                       torch.bfloat16)
    u, g = model.pot_grad(q)
    imm = torch.full((dim,), 0.9, device=cuda_device)
    kern = nuts_fused.nuts_transition_std_cuda(
        q, u.reshape(-1), g, imm, 0.05, model.data, max_exp=MAX_EXP,
        card=model.card, seed=13)
    plain = nuts_fused.nuts_transition_std_plain(
        q, u.reshape(-1), g, imm, 0.05, model.pot_grad, max_exp=MAX_EXP,
        seed=13)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(kern[3][:, 2:6].cpu(), plain[3][:, 2:6].cpu())
    for a, b in zip(kern[:3], plain[:3]):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-2, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("points", [1000, 37])
@pytest.mark.parametrize("max_exp", [1, 14])
@pytest.mark.parametrize("dim,chains", [(1, 9), (7, 17), (100, 8), (104, 13),
                                        (240, 9), (392, 17)])
def test_cuda_nuts_tile_matches_plain(cuda_device, dim, chains, max_exp,
                                      points):
    """Kernel 1 through the NUTS core's X tile (128 points at dim 100, 64 at
    104, 8 at 392, the plan's largest) at K 1 and 14, ragged chain counts
    and point counts no chunk divides: decisions equal to the plain
    version's, q within 1e-4, and the gradient at q_out near float64."""
    from aehmc_tpu_torch.ops.nuts_fused_small import nuts_transition_cuda

    pg, data, q, u, g = _ragged_state(cuda_device, dim, points, chains, dim)
    q_t, g_t, u_t = q.T.contiguous(), g.T.contiguous(), u.reshape(1, -1)
    imm = torch.full((dim,), 0.5, device=cuda_device)
    eps = 0.05 / max(1.0, dim / 100)
    kern = nuts_transition_cuda(q_t, u_t, g_t, imm, eps, data,
                                max_exp=max_exp, seed=dim + max_exp)
    plain = nuts_transition_plain(q_t, u_t, g_t, imm, eps,
                                  lambda x: pg(x, *data), max_exp=max_exp,
                                  seed=dim + max_exp)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(kern[3][2:6].cpu(), plain[3][2:6].cpu())
    for a, b in zip(kern[:3], plain[:3]):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)
    _assert_gradient_near_float64(pg, data, kern[0], kern[2])


def _bf16_case(device, dim=DIM, points=POINTS, chains=CHAINS):
    """The model builder's default (bfloat16) data and a chain state."""
    _, pg, data, _ = logistic_regression_pg_t(dim, points, device=device)
    assert data[0].dtype == torch.bfloat16
    rng = np.random.default_rng(21)
    q_t = torch.tensor(0.3 * rng.normal(size=(dim, chains)),
                       dtype=torch.float32, device=device)
    u, g = pg(q_t, *data)
    return pg, data, q_t, u, g


@pytest.mark.gpu
@pytest.mark.parametrize("points", [POINTS, 37])
@pytest.mark.parametrize("dim", [DIM, 13, 100])
def test_cuda_bf16_nuts_kernels_match_plain_bf16(cuda_device, dim, points):
    """Kernels 1 and 2 on the builder's default bfloat16 data: kernel 1
    against its plain bf16 version (decisions on >= 99% of chains, q within
    1e-2 on those), kernel 2 against per-draw launches of kernel 1 bit for
    bit."""
    pg, data, q_t, u, g = _bf16_case(cuda_device, dim, points)
    imm = torch.full((dim,), 0.9, device=cuda_device)
    kern = make_fused_nuts_transition_small(
        None, data, max_num_expansions=MAX_EXP, potential_and_grad_t=pg,
        transposed_io=True)(q_t, u, g, None, None, None, None, imm, 0.1,
                            seed=31)
    plain = nuts_transition_plain(q_t, u, g, imm, 0.1, lambda x: pg(x, *data),
                                  max_exp=MAX_EXP, seed=31)
    torch.cuda.synchronize()
    same = (kern[3][2:6] == plain[3][2:6]).all(dim=0)
    assert float(same.float().mean()) >= 0.99
    for a, b in zip(kern[:3], plain[:3]):
        np.testing.assert_allclose(a[..., same].cpu(), b[..., same].cpu(),
                                   rtol=1e-2, atol=1e-2)
    draws = 3
    pos, stats, qf, uf, gf = _fused_sampling_call_t(
        None, pg, data, q_t, u, g, imm, 0.1, 9, draws,
        max_num_expansions=MAX_EXP)
    transition = make_fused_nuts_transition_small(
        None, data, max_num_expansions=MAX_EXP, potential_and_grad_t=pg,
        transposed_io=True)
    q, uu, gg = q_t, u, g
    for t in range(draws):
        q, uu, gg, st = transition(q, uu, gg, None, None, None, None, imm, 0.1,
                                   seed=(9 + t * DRAW_SEED_STRIDE) & MASK32)
        assert torch.equal(st, stats[t]) and torch.equal(q, pos[t])
    assert torch.equal(q, qf) and torch.equal(uu, uf) and torch.equal(gg, gf)


@pytest.mark.gpu
@pytest.mark.parametrize("philox", [False, True])
def test_cuda_bf16_ghmc_kernels_match_plain_bf16(cuda_device, philox):
    """Kernels 5 and 6 on the builder's default bfloat16 data: kernel 5
    against its plain bf16 version, kernel 6 against per-draw launches of
    kernel 5 bit for bit."""
    pg, data, q_t, u, g = _bf16_case(cuda_device)
    rng = np.random.default_rng(22)
    p_t = torch.tensor(rng.normal(size=(DIM, CHAINS)), dtype=torch.float32,
                       device=cuda_device)
    rand = dict(seed=41) if philox else dict(
        noise=torch.tensor(rng.normal(size=(DIM, CHAINS)),
                           dtype=torch.float32, device=cuda_device),
        u_accept=torch.tensor(rng.uniform(size=(1, CHAINS)),
                              dtype=torch.float32, device=cuda_device))
    imm = torch.full((DIM,), 0.9, device=cuda_device)
    kern = ghmc_transition_cuda(q_t, u, g, p_t, 0.2, 0.5, imm, data, **rand)
    plain = ghmc_transition_plain(q_t, u, g, p_t, 0.2, 0.5, imm,
                                  lambda x: pg(x, *data), **rand)
    torch.cuda.synchronize()
    moved_k, moved_p = ((o[0] != q_t).any(dim=0) for o in (kern, plain))
    same = (moved_k == moved_p) & (kern[4][4] == plain[4][4])
    assert float(same.float().mean()) >= 0.99
    for a, b in zip(kern[:4], plain[:4]):
        np.testing.assert_allclose(a[..., same].cpu(), b[..., same].cpu(),
                                   rtol=1e-2, atol=1e-2)
    if not philox:
        return
    draws = 4
    pos, stats, *final = ghmc_segment_cuda(q_t, u, g, p_t, 0.2, 0.5, imm, data,
                                           draws, seed=41)
    state = (q_t, u, g, p_t)
    for t in range(draws):
        *state, st = ghmc_transition_cuda(
            *state, 0.2, 0.5, imm, data,
            seed=(41 + t * DRAW_SEED_STRIDE) & MASK32)
        assert torch.equal(st, stats[t]) and torch.equal(state[0], pos[t])
    for a, b in zip(final, state):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [False, True])
def test_cuda_bf16_chees_kernel_matches_plain_bf16(cuda_device, dense):
    """Kernel 7 on the builder's default bfloat16 data against its plain
    bf16 version, and against kernel 5 at α 0 bit for bit (same Philox
    streams)."""
    pg, data, q_t, u, g = _bf16_case(cuda_device)
    q, gs = q_t.T.contiguous(), g.T.contiguous()
    if dense:
        A = np.random.default_rng(23).normal(size=(DIM, DIM))
        imm = torch.tensor(A @ A.T / DIM + np.eye(DIM), dtype=torch.float32,
                           device=cuda_device)
    else:
        imm = torch.full((DIM,), 0.9, device=cuda_device)
    steps = torch.full((), 3, dtype=torch.int32, device=cuda_device)
    kern = chees_fused.chees_transition_cuda(q, u.reshape(-1), gs, imm, 0.2,
                                             steps, data, seed=51)
    plain = chees_fused.chees_transition_plain(
        q, u.reshape(-1), gs, imm, 0.2, 3, lambda x: pg(x, *data), seed=51)
    torch.cuda.synchronize()
    moved_k, moved_p = ((o[0] != q).any(dim=1) for o in (kern, plain))
    same = (moved_k == moved_p) & (kern[3][:, 4] == plain[3][:, 4])
    assert float(same.float().mean()) >= 0.99
    for i in (0, 2, 4, 5):
        np.testing.assert_allclose(kern[i][same].cpu(), plain[i][same].cpu(),
                                   rtol=1e-2, atol=1e-2)
    if dense:
        return
    k5 = ghmc_transition_cuda(q_t, u, g, torch.zeros_like(g), 0.2, 0.0, imm,
                              data, num_steps=3, seed=51)
    assert torch.equal(kern[0], k5[0].T)


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["nuts", "mala", "ghmc", "chees"])
def test_front_door_fused_routes_run_bf16_data_on_the_card(cuda_device,
                                                           algorithm):
    """The fused routes of the front door on the builder's default
    (bfloat16) data launch their kernels and give finite draws."""
    pot, pg, data, _ = logistic_regression_pg_t(dim=16, num_points=128,
                                                device=cuda_device)
    gen = torch.Generator().manual_seed(0)
    q0 = (0.1 * torch.randn(256, 16, generator=gen)).to(cuda_device)
    kw = dict(data=data, potential_fn_t=pot, potential_and_grad_t=pg,
              algorithm=algorithm, path="fused")
    logprob_fn = None
    if algorithm == "chees":
        from aehmc_tpu_torch.models import logistic_regression

        logprob_fn, _ = logistic_regression(16, 128, device=cuda_device)
        kw.pop("potential_fn_t")
    reset_launch_counts()
    res = aehmc_tpu_torch.sample(gen, logprob_fn, q0, 40, 30, **kw)
    launched = {k: v for k, v in LAUNCHES.items() if v}
    expected = {"nuts": {"nuts_transition", "nuts_sampling"},
                "mala": {"ghmc_transition", "ghmc_segment"},
                "ghmc": {"ghmc_transition", "ghmc_segment"},
                "chees": {"chees_transition"}}[algorithm]
    assert set(launched) == expected
    assert res.positions.is_cuda
    assert bool(torch.isfinite(res.positions.float()).all())


# ---- kernels 5-7 (8 chains a block, X requested at block entry and across
# gradients, the state moved in and out by the whole block) and kernel 8 (16
# chains a block up to dim 144)

def _hmc_case(device, dim, chains, x_dtype=torch.float32, points=1000,
                seed=31):
    """A (chains, dim) state on the logistic posterior with X in
    ``x_dtype``, its transposed copies, and a momentum."""
    _, pg, data, _ = logistic_regression_pg_t(dim, points,
                                              matmul_dtype=x_dtype,
                                              device=device)
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    q = f32(0.1 * rng.normal(size=(chains, dim)))
    q_t = q.T.contiguous()
    u_t, g_t = pg(q_t, *data)
    p_t = f32(rng.normal(size=(dim, chains)))
    return pg, data, q, q_t, u_t, g_t, p_t


def _decisions_and_q(moved_k, moved_p, div_k, div_p, qk, qp, atol):
    """Decisions (moved, divergent) equal on >= 99% of chains (all of them
    below 100 chains), q within ``atol`` on those; ``qk``, ``qp`` are
    (dim, C)."""
    same = (moved_k == moved_p) & (div_k == div_p)
    assert float(same.float().mean()) >= 0.99
    if same.numel() < 100:
        assert bool(same.all())
    assert float((qk - qp).abs()[:, same].max()) <= atol


def _check_hmc_kernels(device, dim, chains, x_dtype):
    """Kernels 5 (α 0.5, Philox), 6 (3 draws), 7 (L 3) and 8 (L 4, float32
    X) against their plain versions at ``chains`` chains."""
    assert launch_plan("hmc", dim, 0, chains, x_dtype).chains == 8
    assert launch_plan("fused_hmc", dim, 0, chains).chains == (
        16 if dim <= 144 else 8)
    atol = 1e-2 if x_dtype == torch.bfloat16 else 1e-3
    pg, data, q, q_t, u_t, g_t, p_t = _hmc_case(device, dim, chains,
                                                  x_dtype)
    pot_grad = lambda x: pg(x, *data)  # noqa: E731
    imm = torch.full((dim,), 0.8, device=device)
    state = (q_t, u_t, g_t, p_t)
    kern = ghmc_transition_cuda(*state, 0.1, 0.5, imm, data, seed=51)
    plain = ghmc_transition_plain(*state, 0.1, 0.5, imm, pot_grad, seed=51)
    torch.cuda.synchronize()
    _decisions_and_q((kern[0] != q_t).any(0), (plain[0] != q_t).any(0),
                     kern[4][4], plain[4][4], kern[0], plain[0], atol)
    pos, stats, *_ = ghmc_segment_cuda(*state, 0.1, 0.5, imm, data, 3,
                                       seed=52)
    pos_p, stats_p, *_ = ghmc_fused.ghmc_segment_plain(
        *state, 0.1, 0.5, imm, pot_grad, 3, seed=52)
    torch.cuda.synchronize()
    prev_k, prev_p = q_t, q_t
    for t in range(3):
        _decisions_and_q((pos[t] != prev_k).any(0), (pos_p[t] != prev_p).any(0),
                         stats[t][4], stats_p[t][4], pos[t], pos_p[t], atol)
        prev_k, prev_p = pos[t], pos_p[t]
    steps = torch.full((), 3, dtype=torch.int32, device=device)
    u, g = u_t.reshape(-1), g_t.T.contiguous()
    kern = chees_fused.chees_transition_cuda(q, u, g, imm, 0.1, steps, data,
                                             seed=53)
    plain = chees_fused.chees_transition_plain(q, u, g, imm, 0.1, 3, pot_grad,
                                               seed=53)
    torch.cuda.synchronize()
    _decisions_and_q((kern[0] != q).any(1), (plain[0] != q).any(1),
                     kern[3][:, 4], plain[3][:, 4], kern[0].T, plain[0].T,
                     atol)
    X, y = data[0], data[2].reshape(-1)
    p = p_t.T.contiguous()
    out = fused_hmc.fused_logistic_hmc_cuda(q, p, X, y, imm, 0.05, 4)
    ref = fused_logistic_hmc_reference(q, p, X, y, imm, 0.05, 4)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("chains", [1, 15, 16, 17, 10_245])
def test_cuda_hmc_kernels_and_16_chain_leapfrog_match_plain(cuda_device,
                                                            chains):
    """Float32 dim 100, the flagship's shape: kernels 5-7 at 8 chains a
    block, kernel 8 at 16, the last block ragged but at 16."""
    _check_hmc_kernels(cuda_device, 100, chains, torch.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("dim,x_dtype", [
    (101, torch.float32), (100, torch.bfloat16), (120, torch.bfloat16),
    (121, torch.bfloat16)])
def test_cuda_hmc_kernels_at_other_dims_and_bf16_data(cuda_device, dim,
                                                      x_dtype):
    """Rows of the state and of X past 16 bytes' multiples, and the
    bfloat16 data, ``logistic_regression_pg_t``'s default (kernel 8 widens X
    to float32)."""
    _check_hmc_kernels(cuda_device, dim, 17, x_dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dim,expect", [(144, 16), (145, 8)])
def test_cuda_fused_leapfrog_at_its_chain_edge(cuda_device, dim, expect):
    """The last dim at 16 chains a block and the first at 8."""
    assert launch_plan("fused_hmc", dim, 0, 33).chains == expect
    _, data, q, _, _, _, p_t = _hmc_case(cuda_device, dim, 33, points=300)
    X, y = data[0], data[2].reshape(-1)
    imm = torch.full((dim,), 0.7, device=cuda_device)
    p = p_t.T.contiguous()
    out = fused_hmc.fused_logistic_hmc_cuda(q, p, X, y, imm, 0.03, 6, 1.5)
    ref = fused_logistic_hmc_reference(q, p, X, y, imm, 0.03, 6, 1.5)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.cpu(), b.cpu(), rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_cuda_sibling_identities_with_early_requests(cuda_device, x_dtype):
    """Kernel 6 equals one launch of kernel 5 per draw and kernel 7 equals
    kernel 5 at α 0, bit for bit, on 33 chains, with ε and α given as host
    scalars (launch arguments) to kernels 5 and 6."""
    _, data, q, q_t, u_t, g_t, p_t = _hmc_case(cuda_device, 100, 33,
                                                 x_dtype)
    imm = torch.full((100,), 0.8, device=cuda_device)
    state = (q_t, u_t, g_t, p_t)
    draws, seed = 3, 61
    pos, stats, *final = ghmc_segment_cuda(*state, 0.1, 0.7, imm, data, draws,
                                           seed=seed)
    for t in range(draws):
        *state, st = ghmc_transition_cuda(
            *state, 0.1, 0.7, imm, data,
            seed=(seed + t * DRAW_SEED_STRIDE) & MASK32)
        assert torch.equal(st, stats[t]) and torch.equal(state[0], pos[t])
    for a, b in zip(final, state):
        assert torch.equal(a, b)
    steps = torch.full((), 4, dtype=torch.int32, device=cuda_device)
    k7 = chees_fused.chees_transition_cuda(q, u_t.reshape(-1),
                                           g_t.T.contiguous(), imm, 0.1,
                                           steps, data, seed=62)
    k5 = ghmc_transition_cuda(q_t, u_t, g_t, torch.zeros_like(g_t), 0.1, 0.0,
                              imm, data, num_steps=4, seed=62)
    torch.cuda.synchronize()
    assert torch.equal(k7[0], k5[0].T) and torch.equal(k7[2], k5[2].T)
    assert torch.equal(k7[3][:, :5], k5[4][:5].T)
    # per-chain rows of ε and α give the bits of the host scalars
    rows = [torch.full((33,), v, device=cuda_device) for v in (0.1, 0.7)]
    by_row = ghmc_transition_cuda(q_t, u_t, g_t, p_t, *rows, imm, data,
                                  seed=63)
    by_scalar = ghmc_transition_cuda(q_t, u_t, g_t, p_t, 0.1, 0.7, imm, data,
                                     seed=63)
    for a, b in zip(by_row, by_scalar):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_hmc_instantiations_hold_two_blocks_per_sm(cuda_device):
    """Kernels 5-7 at the plan's 8 chains and kernel 8's 16-chain
    instantiation, at the plan's shared memory for the flagship and kernel
    8's edge dim, hold two blocks per SM (the occupancy API)."""
    ghmc = load_kernels("ghmc_fused.cu")
    chees = load_kernels("chees_fused.cu")
    leap = load_kernels("fused_hmc.cu")
    for x_dtype in (torch.float32, torch.bfloat16):
        plan = launch_plan("hmc", 100, 0, 10_240, x_dtype)
        bf = int(x_dtype == torch.bfloat16)
        counts = [ghmc.ghmc_blocks_per_sm(seg, bf, plan.chains, plan.smem)
                  for seg in (0, 1)]
        counts += [chees.chees_blocks_per_sm(dense, bf, plan.chains,
                                             plan.smem) for dense in (0, 1)]
        assert min(counts) >= 2, (x_dtype, counts)
    for dim in (100, 144):
        plan = launch_plan("fused_hmc", dim, 0, 10_240)
        assert plan.chains == 16
        assert leap.fused_hmc_blocks_per_sm(16, plan.smem) >= 2, dim
    # a chain count the kernels were not built for is refused
    assert ghmc.ghmc_blocks_per_sm(0, 0, 16, plan.smem) == -1


# ---- kernel 9 redesigned (float4 columns fixed per thread, several rows a
# thread, a scalar path for other dims and unaligned rows) and kernels 1
# and 2 with the hierarchical functors (no X tile)

@pytest.mark.gpu
@pytest.mark.parametrize("dim, chains", [(100, 10_240), (100, 41), (100, 1),
                                         (7, 145), (7, 3), (1, 1025),
                                         (4, 257), (1028, 9)])
def test_cuda_batched_leapfrog_equals_plain_bit_for_bit(cuda_device, dim,
                                                        chains):
    """At the float4 path (dim % 4 == 0), the scalar path and across the
    rows a block takes (40 at dim 100, 144 at dim 7, 1,024 at dim 1)."""
    rng = np.random.default_rng(dim + chains)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda_device)

    q, p = (f32(rng.normal(size=(chains, dim))) for _ in range(2))
    lam, im = f32(rng.uniform(0.5, 2.0, dim)), f32(rng.uniform(0.8, 1.2, dim))
    for steps in (0, 1, 10):
        out = aehmc_tpu_torch.ops.batched_leapfrog(q, p, lam, im, 0.05, steps)
        ref = batched_leapfrog_reference(q, p, lam, im, 0.05, steps)
        assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


@pytest.mark.gpu
def test_cuda_batched_leapfrog_rows_not_16_byte_aligned(cuda_device):
    """Contiguous operands that start 4 bytes past a 16-byte boundary take
    the scalar path, bit for bit."""
    rng = np.random.default_rng(5)
    chains, dim = 333, 100
    buf = torch.tensor(rng.normal(size=2 * chains * dim + 1),
                       dtype=torch.float32, device=cuda_device)
    q = buf[1:1 + chains * dim].view(chains, dim)
    p = buf[1 + chains * dim:].view(chains, dim)
    assert q.data_ptr() % 16 and q.is_contiguous()
    lam = torch.linspace(0.5, 2.0, dim, device=cuda_device)
    im = torch.linspace(0.8, 1.2, dim, device=cuda_device)
    out = aehmc_tpu_torch.ops.batched_leapfrog(q, p, lam, im, 0.1, 6)
    ref = batched_leapfrog_reference(q, p, lam, im, 0.1, 6)
    assert torch.equal(out[0], ref[0]) and torch.equal(out[1], ref[1])


def _hier_case(device, model, chains=256, seed=0):
    from aehmc_tpu_torch.models import eight_schools_pg_t, neals_funnel_pg_t

    if model == "funnel":
        pot, pg, data, ex = neals_funnel_pg_t(10, device=device)
    else:
        pot, pg, data, ex = eight_schools_pg_t(device=device)
    dim = ex.shape[0]
    rng = np.random.default_rng(seed)
    q_t = torch.tensor(rng.normal(size=(dim, chains)), dtype=torch.float32,
                       device=device)
    u0, g0 = pg(q_t, *data)
    return pot, pg, data, q_t, u0, g0


def _same_decisions_share(sk, sp):
    shape = (sk[..., 2:6, :] == sp[..., 2:6, :]).all(dim=-2)
    energy = (sk[..., 0, :] - sp[..., 0, :]).abs() <= 1e-5 * sp[..., 0, :].abs(
    ).clamp(min=1.0)
    same = shape & energy
    while same.ndim > 1:
        same = same.all(dim=0)
    return same


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["funnel", "eight_schools"])
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("philox", [False, True])
def test_cuda_hierarchical_transition_matches_plain(cuda_device, model,
                                                    dense, philox):
    """Kernel 1 with FunnelPG / EightSchoolsPG against the plain transition
    at ε 0.2 and K 4: decisions equal on ≥ 99% of chains, q and ∇U within
    1e-4 on those (expf against torch.exp and another sum order)."""
    _, pg, data, q_t, u0, g0 = _hier_case(cuda_device, model)
    dim, chains = q_t.shape
    rng = np.random.default_rng(1)
    if dense:
        A = rng.normal(size=(dim, dim))
        imm = A @ A.T / dim + np.eye(dim)
    else:
        imm = np.full(dim, 0.9)
    imm = torch.tensor(imm, dtype=torch.float32, device=cuda_device)
    k = 4
    ext = {n: torch.tensor(v, dtype=torch.float32, device=cuda_device)
           for n, v in dict(
               momentum=rng.normal(size=(dim, chains)),
               directions=np.where(rng.uniform(size=(k, chains)) < 0.5, -1.0,
                                   1.0),
               u_bias=rng.uniform(size=(k, chains)),
               u_leaf=rng.uniform(size=(2**k, chains))).items()}
    streams = dict(seed=99) if philox else ext
    reset_launch_counts()
    kern = make_fused_nuts_transition_small(
        None, data, max_num_expansions=k, potential_and_grad_t=pg,
        transposed_io=True,
    )(q_t, u0, g0, ext["momentum"], ext["directions"], ext["u_bias"],
      ext["u_leaf"], imm, 0.2, seed=streams.get("seed"))
    plain = nuts_transition_plain(q_t, u0, g0, imm, 0.2,
                                  lambda x: pg(x, *data), max_exp=k,
                                  **streams)
    torch.cuda.synchronize()
    assert LAUNCHES[f"nuts_transition_{model}"] == 1
    assert LAUNCHES["nuts_transition"] == 0
    same = _same_decisions_share(kern[3], plain[3])
    assert float(same.float().mean()) >= 0.99
    for a, b in zip(kern[:3], plain[:3]):
        np.testing.assert_allclose(a[..., same].cpu(), b[..., same].cpu(),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["funnel", "eight_schools"])
def test_cuda_hierarchical_whole_run_equals_per_draw_launches(cuda_device,
                                                              model):
    """Kernel 2 with each functor equals one launch of kernel 1 per draw bit
    for bit, at a chain count off the block (13), with a bfloat16 store that
    is the rounding of the float32 one; each draw agrees with the plain
    transition from the kernel's own state."""
    _, pg, data, q_t, u0, g0 = _hier_case(cuda_device, model, chains=13)
    imm = torch.full((q_t.shape[0],), 0.8, device=cuda_device)
    draws, k = 5, 6
    pos, stats, qf, uf, gf = _fused_sampling_call_t(
        None, pg, data, q_t, u0, g0, imm, 0.2, 7, draws,
        max_num_expansions=k,
    )
    pos16 = _fused_sampling_call_t(
        None, pg, data, q_t, u0, g0, imm, 0.2, 7, draws,
        max_num_expansions=k, collect_dtype=torch.bfloat16)[0]
    assert torch.equal(pos16, pos.to(torch.bfloat16))
    transition = make_fused_nuts_transition_small(
        None, data, max_num_expansions=k, potential_and_grad_t=pg,
        transposed_io=True,
    )
    q, u, g = q_t, u0, g0
    for t in range(draws):
        seed = (7 + t * DRAW_SEED_STRIDE) & MASK32
        plain = nuts_transition_plain(q, u, g, imm, 0.2,
                                      lambda x: pg(x, *data), max_exp=k,
                                      seed=seed)
        q, u, g, st = transition(q, u, g, None, None, None, None, imm, 0.2,
                                 seed=seed)
        assert torch.equal(st, stats[t]) and torch.equal(q, pos[t])
        same = _same_decisions_share(st, plain[3])
        assert float(same.float().mean()) >= 0.99
        np.testing.assert_allclose(q[:, same].cpu(), plain[0][:, same].cpu(),
                                   rtol=1e-4, atol=1e-4)
    assert torch.equal(q, qf) and torch.equal(u, uf) and torch.equal(g, gf)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["funnel", "eight_schools"])
def test_front_door_runs_the_hierarchical_models_on_the_card(cuda_device,
                                                             model):
    pot, pg, data, q_t, _, _ = _hier_case(cuda_device, model)
    gen = torch.Generator().manual_seed(3)
    reset_launch_counts()
    res = aehmc_tpu_torch.sample(
        gen, None, 0.1 * q_t.T.contiguous(), 30, 40, algorithm="nuts",
        path="fused", data=data, potential_fn_t=pot, potential_and_grad_t=pg,
        max_num_expansions=8, target_acceptance_rate=0.85)
    launched = {k: v for k, v in LAUNCHES.items() if v}
    assert launched == {f"nuts_transition_{model}": 40,
                        f"nuts_sampling_{model}": 1}
    assert res.positions.is_cuda
    assert bool(torch.isfinite(res.positions).all())


@pytest.mark.gpu
def test_cuda_hierarchical_kernels_refuse_a_tile_and_wrong_data(cuda_device):
    """The launchers check the functor's own geometry and data: a plan with
    an X tile, or eight schools' data of another length, never launch."""
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs

    _, pg, data, q_t, u0, g0 = _hier_case(cuda_device, "eight_schools",
                                          chains=16)
    imm = torch.full((10,), 0.8, device=cuda_device)
    with pytest.raises(ValueError, match="shape"):
        nfs.nuts_transition_cuda(q_t, u0, g0, imm, 0.2, (data[0][:7],
                                                         data[1][:7]),
                                 max_exp=4, seed=1,
                                 potential_and_grad_t=pg)
    lib = load_kernels("nuts_fused_small.cu")
    plan = launch_plan("nuts", 10, 4, 16, functor="eight_schools")
    ops, dense, ms, _ = nfs._cuda_operands(q_t, u0, g0, imm, data, 4,
                                           "eight_schools")
    outs = [torch.empty_like(q_t), torch.empty_like(u0), torch.empty_like(g0),
            torch.empty((8, 16), device=cuda_device)]
    for points, stride in ((128, 12), (0, 0)):
        J = 8 if points else 7
        err = lib.nuts_transition_pot_launch(
            ops["q"].data_ptr(), ops["u"].data_ptr(), ops["g"].data_ptr(),
            None, None, None, None, 1, 1, 0, 2, ops["y"].data_ptr(),
            ops["s2"].data_ptr(), J, ops["im"].data_ptr(), None, 0, 0.2,
            None, 1000.0, 10, 16, 4, *(o.data_ptr() for o in outs),
            ops["ck"].data_ptr(), plan.blocks, points, stride, plan.smem, 8,
            torch.cuda.current_stream().cuda_stream)
        assert err != 0
        assert b"invalid" in lib.error_string(err)


@pytest.mark.gpu
def test_cuda_hierarchical_instantiations_hold_two_blocks_per_sm(cuda_device):
    lib = load_kernels("nuts_fused_small.cu")
    for model, name in ((1, "funnel"), (2, "eight_schools")):
        plan = launch_plan("nuts", 10, 10, 8192, functor=name)
        for sampling in (0, 1):
            assert lib.nuts_pot_blocks_per_sm(model, sampling, plan.smem) >= 2
    assert lib.nuts_pot_blocks_per_sm(3, 0, 6560) == -1


def _xla_logistic(device):
    """The flagship's model at test size, float32 data: the XLA path's
    ``logprob_fn`` and the fused kernels' builder on the same data."""
    from aehmc_tpu_torch.models import logistic_regression
    logprob_fn, _ = logistic_regression(DIM, POINTS, device=device)
    _, pg, data, _ = logistic_regression_pg_t(
        DIM, POINTS, matmul_dtype=torch.float32, device=device)
    return logprob_fn, pg, data


@pytest.mark.gpu
def test_xla_nuts_step_on_the_card_agrees_with_kernel_1(cuda_device):
    """chip_smoke phase 20 at test size: one Philox seed fed to the XLA
    NUTS step (autograd gradients, sigmoid-form sampling) and to kernel 1
    (logit form, its functor's gradient): decisions equal on at least 99%
    of chains, positions within 1e-3 on those."""
    from aehmc_tpu_torch import nuts
    from aehmc_tpu_torch.ops.nuts_fused_small import nuts_transition_cuda
    logprob_fn, pg, data = _xla_logistic(cuda_device)
    gen = torch.Generator().manual_seed(20)
    q = (0.3 * torch.randn(512, DIM, generator=gen)).to(cuda_device)
    imm = torch.full((DIM,), 0.8, device=cuda_device)
    out, info = nuts.new_kernel(logprob_fn, MAX_EXP)(
        2020, nuts.new_state(q, logprob_fn), 0.4, imm)
    q_t = q.T.contiguous()
    u0, g0 = pg(q_t, *data)
    qk, _, _, stats = nuts_transition_cuda(q_t, u0, g0, imm, 0.4, data,
                                           max_exp=MAX_EXP, seed=2020)
    same = ((info.num_doublings == stats[2].to(torch.int32))
            & (info.num_integration_steps == stats[3].to(torch.int32))
            & (info.is_diverging == (stats[4] > 0.5))
            & (info.is_turning == (stats[5] > 0.5)))
    assert float(same.float().mean()) >= 0.99
    assert float((out.position - qk.T)[same].abs().max()) <= 1e-3
    assert int(info.num_doublings.max()) >= 2


@pytest.mark.gpu
def test_xla_chees_step_on_kernel_8_agrees_with_the_autograd_leapfrog(
        cuda_device):
    """chip_smoke phase 23 at test size: ``chees.new_kernel`` with
    ``integrate_fn`` bound to kernel 8 against the autograd leapfrog, from
    the same Philox seed; kernel 8 launches once a step, and a float64 call
    raises rather than fall back."""
    from aehmc_tpu_torch import chees, hmc, ops
    from aehmc_tpu_torch.models import logistic_regression_data
    logprob_fn, _, _ = _xla_logistic(cuda_device)
    X, y = logistic_regression_data(DIM, POINTS, device=cuda_device)
    gen = torch.Generator().manual_seed(23)
    q = (0.3 * torch.randn(300, DIM, generator=gen)).to(cuda_device)
    states = hmc.new_state(q, logprob_fn)
    imm = torch.full((DIM,), 0.8, device=cuda_device)
    steps = torch.tensor(10, dtype=torch.int32, device=cuda_device)
    fused = chees.new_kernel(logprob_fn,
                             integrate_fn=ops.logistic_integrate_fn(X, y))
    reset_launch_counts()
    kf, fi = fused(77, states, 0.3, steps, imm)
    assert LAUNCHES["fused_logistic_hmc"] == 1
    ka, ai = chees.new_kernel(logprob_fn)(77, states, 0.3, steps, imm)
    moved_f = (kf.position != q).any(dim=1)
    moved_a = (ka.position != q).any(dim=1)
    same = moved_f == moved_a
    assert float(same.float().mean()) >= 0.99
    assert float((kf.position - ka.position)[same].abs().max()) <= 1e-3
    assert 0.2 < float(ai.acceptance_probability.mean()) < 1.0
    with pytest.raises(TypeError, match="float32"):
        ops.logistic_integrate_fn(X, y)(q.double(), q.double(), 0.3, 10,
                                        imm.double())


@pytest.mark.gpu
def test_xla_nuts_at_depth_10_on_the_funnel_agrees_with_kernel_1(
        cuda_device):
    """chip_smoke phase 21's deep-tree check at test size: one XLA NUTS
    step at K 10 on Neal's funnel (autograd gradients) against kernel 1
    with the ``FunnelPG`` functor, one Philox seed, ε 0.005 from N(0, 1)
    (trees up to 1,023 leaves: the paired loop's epilogue, checkpoint slots
    5-9): decisions equal on at least 99% of chains, positions within 1e-3
    on those."""
    from aehmc_tpu_torch import nuts
    from aehmc_tpu_torch.models import neals_funnel, neals_funnel_pg_t
    from aehmc_tpu_torch.ops.nuts_fused_small import nuts_transition_cuda
    dim, chains, seed, eps = 10, 256, 1805, 0.005
    q_t = torch.tensor(np.random.default_rng(seed).standard_normal(
        (dim, chains)), dtype=torch.float32, device=cuda_device)
    lp, _ = neals_funnel(dim, device=cuda_device)
    _, pg, data, _ = neals_funnel_pg_t(dim, device=cuda_device)
    imm = torch.ones(dim, device=cuda_device)
    out, info = nuts.new_kernel(lp, 10)(
        seed, nuts.new_state(q_t.T.contiguous(), lp), eps, imm)
    u0, g0 = pg(q_t, *data)
    qk, _, _, stats = nuts_transition_cuda(q_t, u0, g0, imm, eps, data,
                                           max_exp=10, seed=seed,
                                           potential_and_grad_t=pg)
    same = ((info.num_doublings == stats[2].to(torch.int32))
            & (info.num_integration_steps == stats[3].to(torch.int32))
            & (info.is_diverging == (stats[4] > 0.5))
            & (info.is_turning == (stats[5] > 0.5)))
    assert float(same.float().mean()) >= 0.99
    assert float((out.position - qk.T)[same].abs().max()) <= 1e-3
    assert int(info.num_doublings.max()) == 10


def _meads_fold_case(device, chains=256, seed=24):
    """Folded MEADS states on the flagship model at test size and their
    per-fold hyperparameters (the estimator's own)."""
    from aehmc_tpu_torch import meads
    logprob_fn, pg, data = _xla_logistic(device)
    gen = torch.Generator().manual_seed(seed)
    q = (0.3 * torch.randn(chains, DIM, generator=gen)).to(device)
    states = meads.init_states(seed, q, logprob_fn)
    hyper = meads.estimate_hyperparams(states)
    folded = type(states)(*(a.reshape((4, chains // 4) + a.shape[1:])
                            for a in states))
    return logprob_fn, pg, data, folded, hyper


@pytest.mark.gpu
def test_cuda_ghmc_kernels_at_fold_tiled_hyperparameters(cuda_device):
    """Kernels 5 and 6 fed MEADS's per-chain ε, α and (chains, dim) M⁻¹
    (each fold's repeated for its chains) against their plain versions,
    one Philox seed: decisions equal on at least 99% of chains, positions
    within 1e-4 on those; the segment equals its transitions bit for bit."""
    from aehmc_tpu_torch.ops.ghmc_fused import _meads_operands
    _, pg, data, folded, hyper = _meads_fold_case(cuda_device)
    (q, u, g, p), (eps, alpha, imm) = _meads_operands(folded, hyper)
    state = (q.T.contiguous(), u.reshape(1, -1), g.T.contiguous(),
             p.T.contiguous())
    pot_grad = lambda q_t: pg(q_t, *data)  # noqa: E731
    kern = ghmc_transition_cuda(*state, eps, alpha, imm, data, seed=2424)
    plain = ghmc_transition_plain(*state, eps, alpha, imm, pot_grad,
                                  seed=2424)
    moved_k = (kern[0] != state[0]).any(dim=0)
    same = ((moved_k == (plain[0] != state[0]).any(dim=0))
            & (kern[4][4] == plain[4][4]))
    assert float(same.float().mean()) >= 0.99 and bool(moved_k.any())
    assert float((kern[0] - plain[0])[:, same].abs().max()) <= 1e-4
    pos, stats, *final = ghmc_segment_cuda(*state, eps, alpha, imm, data, 8,
                                           seed=2424)
    st = state
    for t in range(8):
        *st, s = ghmc_transition_cuda(
            *st, eps, alpha, imm, data,
            seed=(2424 + t * DRAW_SEED_STRIDE) & MASK32)
        assert torch.equal(s, stats[t]) and torch.equal(st[0], pos[t])
    assert all(torch.equal(a, b) for a, b in zip(final, st))


@pytest.mark.gpu
def test_cuda_fused_meads_follows_the_xla_route(cuda_device):
    """MEADS with kernel 5 as its fold transition against the XLA fold
    transition, one key per draw: the kernel draws the XLA transition's
    Philox streams, so accept decisions agree on at least 99% of
    chain-draws over 10 burn-in and 10 draws; the front door's fused route
    launches kernel 6 once a segment."""
    from aehmc_tpu_torch import meads
    from aehmc_tpu_torch.ops.ghmc_fused import make_fused_meads_transition
    logprob_fn, pg, data = _xla_logistic(cuda_device)
    gen = torch.Generator().manual_seed(25)
    q = (0.3 * torch.randn(256, DIM, generator=gen)).to(cuda_device)
    fused = make_fused_meads_transition(None, data, potential_and_grad_t=pg)
    reset_launch_counts()
    out_f = meads.sample(7, logprob_fn, q, 10, 10, transition_fn=fused)
    assert LAUNCHES["ghmc_transition"] == 20
    out_x = meads.sample(7, logprob_fn, q, 10, 10)
    moved_f = torch.cat([q[None], out_f[1]]).diff(dim=0).ne(0).any(dim=-1)
    moved_x = torch.cat([q[None], out_x[1]]).diff(dim=0).ne(0).any(dim=-1)
    assert float((moved_f[1:] == moved_x[1:]).float().mean()) >= 0.99
    reset_launch_counts()
    res = aehmc_tpu_torch.sample(torch.Generator().manual_seed(26), logprob_fn,
                                 q, 16, 16, algorithm="meads", path="fused",
                                 data=data, potential_and_grad_t=pg)
    assert LAUNCHES["ghmc_segment"] == 4 and LAUNCHES["ghmc_transition"] == 0
    assert res.positions.shape == (16, 256, DIM)
    assert bool(torch.isfinite(res.positions).all())


@pytest.mark.gpu
def test_cuda_meads_checkpoint_resumes_bit_for_bit(cuda_device, tmp_path):
    """The checkpointed fused MEADS route (kernel 5 a draw) killed after one
    sampling segment and resumed equals the uninterrupted run bit for bit:
    the kernels reduce in a fixed order (no atomics)."""
    logprob_fn, pg, data = _xla_logistic(cuda_device)
    gen = torch.Generator().manual_seed(27)
    q = (0.3 * torch.randn(256, DIM, generator=gen)).to(cuda_device)

    def run(path, **kw):
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(28), logprob_fn, q, 20, 10,
            algorithm="meads", path="fused", data=data,
            potential_and_grad_t=pg, checkpoint_every=5,
            checkpoint_path=str(path), **kw)

    reset_launch_counts()
    full = run(tmp_path / "full.npz")
    assert LAUNCHES["ghmc_transition"] == 30
    assert run(tmp_path / "run.npz", _crash_after_segments=2) is None
    resumed = run(tmp_path / "run.npz", resume=True)
    assert torch.equal(full.positions, resumed.positions)
    for a, b in zip(full.final_state, resumed.final_state):
        assert torch.equal(a, b)
    for a, b in zip(full.diagnostics, resumed.diagnostics):
        assert torch.equal(a, b)


def _per_chain_case(device, model, chains):
    """A chain batch of ``model`` (the logistic posterior in float32, or
    Neal's funnel) with external streams and a per-chain ε row."""
    if model == "logistic":
        _, pg, data, _ = logistic_regression_pg_t(
            DIM, POINTS, matmul_dtype=torch.float32, device=device)
        dim, lo, hi = DIM, 0.1, 0.6
    else:
        from aehmc_tpu_torch.models import neals_funnel_pg_t
        _, pg, data, _ = neals_funnel_pg_t(10, device=device)
        dim, lo, hi = 10, 0.05, 0.4
    rng = np.random.default_rng(3)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    q_t = f32(0.3 * rng.normal(size=(dim, chains)))
    u0, g0 = pg(q_t, *data)
    ext = dict(
        momentum=f32(rng.normal(size=(dim, chains))),
        directions=f32(np.where(rng.uniform(size=(MAX_EXP, chains)) < 0.5,
                                -1.0, 1.0)),
        u_bias=f32(rng.uniform(size=(MAX_EXP, chains))),
        u_leaf=f32(rng.uniform(size=(2**MAX_EXP, chains))),
    )
    eps = f32(rng.uniform(lo, hi, size=chains))
    return pg, data, (q_t, u0, g0), f32(np.full(dim, 0.9)), ext, eps


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["logistic", "funnel"])
@pytest.mark.parametrize("chains", [CHAINS, 13])
@pytest.mark.parametrize("philox", [False, True])
def test_cuda_per_chain_eps_transition_matches_plain(cuda_device, model,
                                                     chains, philox):
    """Kernel 1 reads each chain's ε from the row (13 chains: the grid's
    padded tail reads none), as the plain version does: decisions equal on
    every chain (logistic) or ≥ 99% (the funnel's expf), q within 1e-4."""
    pg, data, state, imm, ext, eps = _per_chain_case(cuda_device, model,
                                                     chains)
    streams = dict(seed=91) if philox else ext
    kern = make_fused_nuts_transition_small(
        None, data, max_num_expansions=MAX_EXP, potential_and_grad_t=pg,
        transposed_io=True,
    )(*state, ext["momentum"], ext["directions"], ext["u_bias"],
      ext["u_leaf"], imm, eps, seed=streams.get("seed"))
    plain = nuts_transition_plain(*state, imm, eps, lambda x: pg(x, *data),
                                  max_exp=MAX_EXP, **streams)
    torch.cuda.synchronize()
    same = _same_decisions_share(kern[3], plain[3])
    assert float(same.float().mean()) >= (1.0 if model == "logistic" else 0.99)
    np.testing.assert_allclose(kern[0][:, same].cpu(), plain[0][:, same].cpu(),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["logistic", "funnel"])
def test_cuda_per_chain_eps_whole_run_equals_launches_and_scalar(cuda_device,
                                                                 model):
    """Kernel 2 at a per-chain ε equals one kernel-1 launch a draw bit for
    bit; a constant ε vector gives both kernels the scalar run's bits."""
    pg, data, (q_t, u0, g0), imm, _, eps = _per_chain_case(cuda_device,
                                                           model, CHAINS)
    draws = 4
    transition = make_fused_nuts_transition_small(
        None, data, max_num_expansions=MAX_EXP, potential_and_grad_t=pg,
        transposed_io=True)
    pos, stats, qf, uf, gf = _fused_sampling_call_t(
        None, pg, data, q_t, u0, g0, imm, eps, 5, draws,
        max_num_expansions=MAX_EXP)
    q, u, g = q_t, u0, g0
    for t in range(draws):
        q, u, g, st = transition(q, u, g, None, None, None, None, imm, eps,
                                 seed=(5 + t * DRAW_SEED_STRIDE) & MASK32)
        assert torch.equal(st, stats[t]) and torch.equal(q, pos[t])
    assert torch.equal(q, qf) and torch.equal(u, uf) and torch.equal(g, gf)
    const = torch.full((CHAINS,), 0.3, device=cuda_device)
    for step in (
        lambda e: transition(q_t, u0, g0, None, None, None, None, imm, e,
                             seed=17),
        lambda e: _fused_sampling_call_t(None, pg, data, q_t, u0, g0, imm, e,
                                         17, draws,
                                         max_num_expansions=MAX_EXP),
    ):
        for a, b in zip(step(0.3), step(const)):
            assert torch.equal(a, b)


@pytest.mark.gpu
def test_cuda_per_chain_eps_row_must_be_float32_chains(cuda_device):
    """A per-chain ε on the card is a float32 (chains,) tensor on the card;
    it never reaches the plain version."""
    pg, data, state, imm, _, eps = _per_chain_case(cuda_device, "logistic",
                                                   CHAINS)
    transition = make_fused_nuts_transition_small(
        None, data, max_num_expansions=MAX_EXP, potential_and_grad_t=pg,
        transposed_io=True)
    for bad in (eps[:-1], eps.double(), eps.cpu()):
        with pytest.raises(ValueError, match="per-chain"):
            transition(*state, None, None, None, None, imm, bad, seed=3)
    reset_launch_counts()
    transition(*state, None, None, None, None, imm, eps, seed=3)
    assert LAUNCHES["nuts_transition"] == 1


@pytest.mark.gpu
def test_front_door_sorted_per_chain_runs_on_kernel_1(cuda_device):
    """``sort_by_depth`` with per-chain dual averaging and the snap through
    the front door: every warmup step and draw one launch of kernel 1, none
    of kernel 2; one seed gives one set of bits."""
    from aehmc_tpu_torch.models import neals_funnel_pg_t

    pot, pg, data, _ = neals_funnel_pg_t(10, device=cuda_device)
    q0 = (0.1 * torch.randn(256, 10, generator=torch.Generator().manual_seed(
        1))).to(cuda_device)

    def run():
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(2), None, q0, 20, 30, path="fused",
            data=data, potential_fn_t=pot, potential_and_grad_t=pg,
            max_num_expansions=8, sort_by_depth=True,
            per_chain_step_size=True, per_chain_quantiles=4,
            search_initial_step_size=True)

    reset_launch_counts()
    a = run()
    assert LAUNCHES["nuts_transition_funnel"] == 50
    assert LAUNCHES["nuts_sampling_funnel"] == 0
    assert a.step_size.shape == (256,) and a.step_size.is_cuda
    assert len(torch.unique(a.step_size)) <= 4
    b = run()
    assert torch.equal(a.positions, b.positions)
    assert bool(torch.isfinite(a.positions).all())


# ---- kernels 1-4 on a functor generated from the potential's traced
# gradient graph (ops/generic_pg.py): a potential with no hand-written
# functor, its plain version (generic_pg.run_plain), and the hand-written
# logistic functor on the same posterior

def _generic_potential(q_t, Xv, y_col):
    logits = Xv @ q_t
    return (-torch.sum(y_col * logits - torch.nn.functional.softplus(logits),
                       dim=0) + 0.5 * torch.sum(q_t * q_t, dim=0))


def _std_potential(q, Xv, y_col):
    return _generic_potential(q.T, Xv, y_col)


def _assert_kernel_matches(kern, ref, atol=1e-4):
    np.testing.assert_array_equal(kern[3][..., 2:6, :].cpu(),
                                  ref[3][..., 2:6, :].cpu())
    np.testing.assert_allclose(kern[0].cpu(), ref[0].cpu(), rtol=atol,
                               atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("philox", [False, True])
def test_cuda_generic_kernel_1_matches_plain_and_the_logistic_functor(
        cuda_device, dense, philox):
    from aehmc_tpu_torch.ops import generic_pg

    pg, data, q_t, u0, g0, imm, ext = _case(cuda_device, dense)
    gdata = (data[0], data[2])
    streams = dict(seed=77) if philox else ext
    reset_launch_counts()
    kern = make_fused_nuts_transition_small(
        _generic_potential, gdata, max_num_expansions=MAX_EXP,
        transposed_io=True,
    )(q_t, u0, g0, ext["momentum"], ext["directions"], ext["u_bias"],
      ext["u_leaf"], imm, 0.3, seed=streams.get("seed"))
    assert LAUNCHES["nuts_transition_generic"] == 1
    bound = generic_pg.bind(_generic_potential, gdata, DIM,
                            device=cuda_device)
    ops_ = bound.operands(gdata, cuda_device)
    plain = nuts_transition_plain(
        q_t, u0, g0, imm, 0.3,
        lambda x: generic_pg.run_plain(bound.ir, x, ops_), max_exp=MAX_EXP,
        **streams)
    hand = nuts_transition_plain(q_t, u0, g0, imm, 0.3,
                                 lambda x: pg(x, *data), max_exp=MAX_EXP,
                                 **streams)
    torch.cuda.synchronize()
    _assert_kernel_matches(kern, plain)
    _assert_kernel_matches(kern, hand)


@pytest.mark.gpu
def test_cuda_generic_kernel_2_equals_per_draw_launches(cuda_device):
    _, data, q_t, u0, g0, imm, _ = _case(cuda_device, False)
    gdata = (data[0], data[2])
    draws = 4
    reset_launch_counts()
    pos, stats, qf, uf, gf = _fused_sampling_call_t(
        _generic_potential, None, gdata, q_t, u0, g0, imm, 0.3, 5, draws,
        max_num_expansions=MAX_EXP)
    assert LAUNCHES["nuts_sampling_generic"] == 1
    transition = make_fused_nuts_transition_small(
        _generic_potential, gdata, max_num_expansions=MAX_EXP,
        transposed_io=True)
    q, u, g = q_t, u0, g0
    for t in range(draws):
        q, u, g, st = transition(q, u, g, None, None, None, None, imm, 0.3,
                                 seed=(5 + t * DRAW_SEED_STRIDE) & MASK32)
        assert torch.equal(st, stats[t]) and torch.equal(q, pos[t])
    assert torch.equal(q, qf) and torch.equal(u, uf) and torch.equal(g, gf)


@pytest.mark.gpu
def test_cuda_generic_kernels_3_and_4_match_plain(cuda_device):
    _, data, q_t, u0, g0, imm, ext = _case(cuda_device, False)
    gdata = (data[0], data[2])
    q = q_t.T.contiguous()
    model = nuts_fused._generic_model(_std_potential, gdata)
    u, g = model.pot_grad(q)
    ext_s = [v.T.contiguous() for v in ext.values()]
    reset_launch_counts()
    kern = nuts_fused._transition(model, q, u, g, *ext_s, imm, 0.3,
                                  max_exp=MAX_EXP, divergence_threshold=1e3)
    plain = nuts_fused.nuts_transition_std_plain(
        q, u, g, imm, 0.3, model.pot_grad, max_exp=MAX_EXP,
        momentum=ext_s[0], directions=ext_s[1], u_bias=ext_s[2],
        u_leaf=ext_s[3])
    torch.cuda.synchronize()
    assert LAUNCHES["nuts_transition_std_generic"] == 1
    _assert_kernel_matches([x.T for x in kern], [x.T for x in plain])
    pos, stats, qf, _, _ = nuts_fused._fused_sampling_call(
        model, q, u, g, imm, 0.3, 9, 3, max_num_expansions=MAX_EXP)
    assert LAUNCHES["nuts_sampling_std_generic"] == 1
    qs, us, gs = q, u, g
    for t in range(3):
        qs, us, gs, st = nuts_fused._transition(
            model, qs, us, gs, None, None, None, None, imm, 0.3,
            max_exp=MAX_EXP, divergence_threshold=1000.0,
            seed=(9 + t * DRAW_SEED_STRIDE) & MASK32)
        assert torch.equal(st, stats[t]) and torch.equal(qs, pos[t])
    assert torch.equal(qs, qf)


# ---- kernels 5-7 on a generated functor: the funnel's and eight schools'
# hand-written torch functions (funnel_pg_t, schools_pg_t) traced as the
# wrappers trace them, the logistic posterior as a plain torch potential,
# and eight schools' potential differentiated in the trace: each against
# its plain version with the potential's own torch function or
# generic_pg.run_plain, decisions equal on >= 99% of chains, positions
# within 1e-4 on those

def _hmc_functor_case(device, functor, chains=24):
    """(the kernel's potential keywords, data, plain pot_grad, q_t (dim, C),
    the launch count's name suffix) of ``functor``."""
    from aehmc_tpu_torch.models import eight_schools_pg_t, neals_funnel_pg_t
    from aehmc_tpu_torch.ops import generic_pg

    if functor in ("funnel", "eight_schools"):
        pot, pg, data, q_t, _, _ = _hier_case(device, functor, chains=chains)
        return (dict(potential_and_grad_t=pg), data,
                lambda x: pg(x, *data), 0.5 * q_t, "_generic")
    if functor == "generic_schools":
        pot, _, data, _ = eight_schools_pg_t(device=device)
        q_t = 0.5 * _hier_case(device, "eight_schools", chains=chains)[3]
    else:
        _, _, data, _ = logistic_regression_pg_t(
            DIM, POINTS, matmul_dtype=torch.float32, device=device)
        pot, data = _generic_potential, (data[0], data[2])
        q_t = torch.tensor(0.1 * np.random.default_rng(3).normal(
            size=(DIM, chains)), dtype=torch.float32, device=device)
    bound = generic_pg.bind(pot, data, q_t.shape[0], device=device)
    ops_ = bound.operands(data, device)
    return (dict(potential_and_grad_t=None, potential_fn_t=pot), data,
            lambda x: generic_pg.run_plain(bound.ir, x, ops_), q_t,
            "_generic")


HMC_FUNCTORS = ["funnel", "eight_schools", "generic", "generic_schools"]


def _hmc_agree(q0, kern_q, plain_q, kern_s, plain_s, atol=1e-4):
    """GHMC/ChEES decisions (moved, divergent, the kept energy to 1e-5
    relative) equal on >= 99% of chains; positions within ``atol`` there.
    q and stats in the (dim, C) / (8, C) layout."""
    energy = (kern_s[0] - plain_s[0]).abs() <= 1e-5 * plain_s[0].abs().clamp(
        min=1.0)
    same = (((kern_q != q0).any(dim=0) == (plain_q != q0).any(dim=0))
            & (kern_s[4] == plain_s[4]) & energy)
    assert float(same.float().mean()) >= 0.99
    np.testing.assert_allclose(kern_q[:, same].cpu(), plain_q[:, same].cpu(),
                               rtol=atol, atol=atol)
    return same


@pytest.mark.gpu
@pytest.mark.parametrize("functor", HMC_FUNCTORS)
@pytest.mark.parametrize("philox", [False, True])
def test_cuda_ghmc_kernels_on_each_functor_match_plain(cuda_device, functor,
                                                       philox):
    """Kernel 5 against its plain version at α 0.8 (per-chain ε), and kernel
    6 equal to its kernel-5 launches bit for bit, each draw against the
    plain transition from the kernel's own state."""
    pot_kw, data, plain_pg, q_t, suffix = _hmc_functor_case(cuda_device,
                                                            functor)
    dim, chains = q_t.shape
    rng = np.random.default_rng(4)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda_device)

    u0, g0 = plain_pg(q_t)
    p0 = f32(rng.normal(size=(dim, chains)))
    eps = f32(rng.uniform(0.05, 0.15, size=chains))
    imm = f32(rng.uniform(0.7, 1.3, size=dim))
    ext = dict(noise=f32(rng.normal(size=(dim, chains))),
               u_accept=f32(rng.uniform(size=(1, chains))))
    rand = dict(seed=55) if philox else ext
    state = (q_t, u0, g0, p0)
    reset_launch_counts()
    kern = ghmc_transition_cuda(*state, eps, 0.8, imm, data, **pot_kw, **rand)
    plain = ghmc_transition_plain(*state, eps, 0.8, imm, plain_pg, **rand)
    torch.cuda.synchronize()
    assert LAUNCHES["ghmc_transition" + suffix] == 1
    assert LAUNCHES["ghmc_transition"] == 0
    _hmc_agree(q_t, kern[0], plain[0], kern[4], plain[4])
    draws, seed = 4, 23
    pos, stats, *final = ghmc_segment_cuda(*state, eps, 0.8, imm, data,
                                           draws, seed=seed, **pot_kw)
    assert LAUNCHES["ghmc_segment" + suffix] == 1
    st = state
    for t in range(draws):
        key = (seed + t * DRAW_SEED_STRIDE) & MASK32
        plain_t = ghmc_transition_plain(*st, eps, 0.8, imm, plain_pg,
                                        seed=key)
        *st, s_t = ghmc_transition_cuda(*st, eps, 0.8, imm, data, seed=key,
                                        **pot_kw)
        assert torch.equal(s_t, stats[t]) and torch.equal(st[0], pos[t])
        _hmc_agree(pos[t - 1] if t else q_t, st[0], plain_t[0], s_t,
                   plain_t[4])
    for a, b in zip(final, st):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("functor", HMC_FUNCTORS)
@pytest.mark.parametrize("dense", [False, True])
def test_cuda_chees_kernel_on_each_functor_matches_plain(cuda_device,
                                                         functor, dense):
    """Kernel 7 (L 5, per-chain ε, diagonal or dense M⁻¹, Philox) against
    its plain version, and at α 0 against kernel 5 on the same functor:
    the same decisions."""
    pot_kw, data, plain_pg, q_t, suffix = _hmc_functor_case(cuda_device,
                                                            functor)
    dim, chains = q_t.shape
    rng = np.random.default_rng(6)
    if dense:
        A = rng.normal(size=(dim, dim))
        imm = 0.5 * (A @ A.T / dim + np.eye(dim))
    else:
        imm = rng.uniform(0.5, 1.0, size=dim)
    imm = torch.tensor(imm, dtype=torch.float32, device=cuda_device)
    eps = torch.tensor(rng.uniform(0.03, 0.1, size=chains),
                       dtype=torch.float32, device=cuda_device)
    u_t, g_t = plain_pg(q_t)
    q, u, g = q_t.T.contiguous(), u_t.reshape(-1), g_t.T.contiguous()
    steps = torch.full((), 5, dtype=torch.int32, device=cuda_device)
    reset_launch_counts()
    kern = chees_fused.chees_transition_cuda(q, u, g, imm, eps, steps, data,
                                             seed=41, **pot_kw)
    plain = chees_fused.chees_transition_plain(
        q, u, g, imm, eps, 5, plain_pg, seed=41)
    torch.cuda.synchronize()
    assert LAUNCHES["chees_transition" + suffix] == 1
    assert LAUNCHES["chees_transition"] == 0
    same = _hmc_agree(q_t, kern[0].T, plain[0].T, kern[3].T, plain[3].T)
    for a, b in zip(kern[4:], plain[4:]):
        np.testing.assert_allclose(a[same].cpu(), b[same].cpu(), rtol=1e-4,
                                   atol=1e-4)
    if not dense:  # kernel 7 is kernel 5 at α 0 with no momentum carried
        k5 = ghmc_transition_cuda(q_t, u_t, g_t, torch.zeros_like(g_t), eps,
                                  0.0, imm, data, num_steps=5, seed=41,
                                  **pot_kw)
        assert torch.equal(kern[0].T, k5[0]) and torch.equal(
            kern[3][:, 4], k5[4][4])


@pytest.mark.gpu
def test_cuda_hmc_functor_instantiations_hold_two_blocks_per_sm(cuda_device):
    """Kernels 5-7 on the generated functors of the logistic posterior and
    of the funnel's and eight schools' hand-written torch functions."""
    from aehmc_tpu_torch.ops import generic_pg

    _, _, data, _ = logistic_regression_pg_t(DIM, POINTS,
                                             matmul_dtype=torch.float32,
                                             device=cuda_device)
    cases = [(_generic_potential, (data[0], data[2]), DIM, True)]
    for name in ("funnel", "eight_schools"):
        _, pg, hier_data, q_t, _, _ = _hier_case(cuda_device, name)
        cases.append((pg, hier_data, q_t.shape[0], False))
    for fn, fn_data, dim, with_grad in cases:
        bound = generic_pg.bind(fn, fn_data, dim, with_grad=with_grad,
                                device=cuda_device)
        plan = launch_plan("hmc", dim, 0, 8192, functor="generic",
                           geometry=bound.geometry)
        lib = bound.library()
        for kernel, dense in ((5, 0), (6, 0), (7, 0), (7, 1)):
            assert lib.hmc_generic_blocks_per_sm(kernel, dense,
                                                 plan.smem) >= 2
        assert lib.hmc_generic_blocks_per_sm(8, 0, plan.smem) == -1


@pytest.mark.gpu
@pytest.mark.parametrize("algorithm", ["mala", "ghmc", "chees", "meads"])
def test_front_door_on_a_bare_logprob_fn_takes_the_generated_functor(
        cuda_device, algorithm):
    """A bare logprob_fn on the fused MALA, GHMC, ChEES and MEADS routes
    binds the generated functor: only the _generic counts move, the same
    seed gives the same draws, the acceptance is above 0.3 after a warmup
    that adapts (150 steps, as chip_smoke's phase 41: the plain route on
    these inputs accepts 0.75-0.99, but 0.03 after 30 steps) and the
    hand-written logistic route's at the same settings and seed to 0.05."""
    from aehmc_tpu_torch.models import logistic_regression

    logprob_fn, _ = logistic_regression(DIM, POINTS, device=cuda_device)
    pot, pg, data, _ = logistic_regression_pg_t(
        DIM, POINTS, matmul_dtype=torch.float32, device=cuda_device)
    q0 = torch.tensor(0.1 * np.random.default_rng(9).normal(
        size=(CHAINS, DIM)), dtype=torch.float32, device=cuda_device)

    def run(**binding):
        reset_launch_counts()
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(8), logprob_fn, q0, 24, 150,
            algorithm=algorithm, path="fused", **binding)

    res = run()
    launched = {k: v for k, v in LAUNCHES.items() if v}
    assert launched and all(k.endswith("_generic") for k in launched)
    assert bool(torch.isfinite(res.positions).all())
    assert torch.equal(res.positions, run().positions)
    hand = run(data=data, potential_fn_t=pot, potential_and_grad_t=pg)
    assert not any(k.endswith("_generic") for k, v in LAUNCHES.items() if v)
    accept, hand_accept = (float(r.diagnostics.acceptance_probability.mean())
                           for r in (res, hand))
    assert accept > 0.3
    assert abs(accept - hand_accept) < 0.05


# ------------------------------------------------------ chain offsets ----

def _four_shards(device):
    from aehmc_tpu_torch.parallel import make_mesh

    return make_mesh(devices=[device] * 4)


def _sharded_case(device, kernel):
    """``(whole, sharded)`` callables of kernel 1, 2, 5 or 7 under a Philox
    seed at the test's widths, the sharded one over a mesh that names the
    card four times (16 chains a shard, at offsets 0, 16, 32, 48)."""
    from aehmc_tpu_torch.parallel.mesh import chain_shards, map_shards

    mesh = _four_shards(device)
    if kernel in (1, 2):
        pg, data, q_t, u0, g0, imm, _ = _case(device, False)
        if kernel == 1:
            tr = make_fused_nuts_transition_small(
                None, data, max_num_expansions=MAX_EXP,
                potential_and_grad_t=pg, transposed_io=True)
            sharded = fused_driver.shard_fused_transition(
                tr, mesh, CHAINS, 8, transposed_io=True)
            return (lambda: tr(q_t, u0, g0, None, None, None, None, imm, 0.3,
                               seed=91),
                    lambda: sharded(q_t, u0, g0, None, None, None, None, imm,
                                    0.3, seed=91))

        def run(q, u, g, chain_offset=0):
            return _fused_sampling_call_t(
                None, pg, data, q, u, g, imm, 0.3, 91, 4,
                max_num_expansions=MAX_EXP, chain_offset=chain_offset)

        def shards():
            return map_shards(
                lambda s: run(*(s.take(x, -1) for x in (q_t, u0, g0)),
                              chain_offset=s.start),
                chain_shards(mesh, CHAINS), device, -1)

        return lambda: run(q_t, u0, g0), shards
    if kernel == 5:
        pg, data, state, params, _ = _ghmc_case(device, True)
        tr = ghmc_fused.make_fused_ghmc_transition(
            None, data, potential_and_grad_t=pg, transposed_io=True)
        sharded = ghmc_fused.shard_fused_ghmc_transition(
            tr, mesh, CHAINS, 8, transposed_io=True)
        return (lambda: tr(*state, *params, seed=91),
                lambda: sharded(*state, *params, seed=91))
    pg, data, q, u, g, _ = _std_case(device, chains=CHAINS)
    imm = torch.full((DIM,), 0.8, device=device)
    tr = chees_fused.make_fused_chees_transition(
        None, data, potential_and_grad_t=pg)
    sharded = chees_fused.shard_fused_chees_transition(tr, mesh, CHAINS, 8)
    return (lambda: tr(q, u, g, None, None, imm, 0.4, 5, seed=91),
            lambda: sharded(q, u, g, None, None, imm, 0.4, 5, seed=91))


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", [1, 2, 5, 7])
def test_cuda_sharded_kernels_equal_the_whole_launch(cuda_device, kernel):
    """Four shards on the one card, each launched at its chain offset,
    joined in chain order: the whole launch's outputs bit for bit, four
    launches of the kernel."""
    whole, sharded = _sharded_case(cuda_device, kernel)
    name = {1: "nuts_transition", 2: "nuts_sampling", 5: "ghmc_transition",
            7: "chees_transition"}[kernel]
    reset_launch_counts()
    want = whole()
    assert LAUNCHES[name] == 1
    reset_launch_counts()
    got = sharded()
    torch.cuda.synchronize()
    assert LAUNCHES[name] == 4
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)


# ---- the op table (ROADMAP item 1.10c): kernels 1, 5 and 7 on generated
# functors that need a triangular solve, a gather by integer index data and
# its scatter-add, the special functions and the axis reductions, each
# against its plain version (generic_pg.run_plain) from one Philox seed

def _op_table_logprob(name, device):
    """A bare logprob of the op table's test potentials at test size, and
    its dim."""
    from aehmc_tpu_torch.models import correlated_mvn

    rng = np.random.default_rng(15)
    if name == "mvn":
        return correlated_mvn(6, 0.5, device=device), 6
    if name == "negbin":
        # overdispersed counts of mean 3 under NB(y | 3, s): the posterior
        # keeps s = exp(q) moderate, away from where lgamma(y + s) -
        # lgamma(s) cancels to float32 rounding noise
        idx = torch.tensor(rng.integers(-8, 8, 40), device=device)
        y = torch.tensor(rng.negative_binomial(2, 0.4, 40), device=device)

        def lp(q):
            s = torch.exp(q[idx])
            log_denom = torch.log(s + 3.0)
            return torch.sum(torch.lgamma(y + s) - torch.lgamma(s)
                             + s * (q[idx] - log_denom)
                             + y * (np.log(3.0) - log_denom)) \
                - 0.5 * torch.sum(q * q)
        return lp, 8
    if name == "mixture":
        pts = torch.tensor(rng.standard_normal((30, 2)).astype(np.float32),
                           device=device)

        def lp(q):
            mus, logits = q[:4].reshape(2, 2), q[4:6]
            d = pts[:, None, :] - mus[None]
            return torch.sum(torch.logsumexp(torch.log_softmax(logits, 0)
                                             - 0.5 * torch.sum(d * d, -1),
                                             1)) - 0.5 * torch.sum(q * q)
        return lp, 6
    X = torch.tensor(rng.standard_normal((20, 5)).astype(np.float32),
                     device=device)
    y = torch.tensor((rng.uniform(size=20) < 0.5).astype(np.float32),
                     device=device)

    def lp(q):
        z = X @ q
        return torch.sum(y * torch.special.log_ndtr(z) + (1.0 - y)
                         * torch.special.log_ndtr(-z)) - 0.5 * torch.sum(q * q)
    return lp, 5


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mvn", "negbin", "mixture", "probit"])
def test_cuda_kernels_1_5_7_on_the_op_table_functors(cuda_device, name):
    """At ε 0.2, as the generated functors' gates: decisions as chip_smoke
    reads them, the tree (stats rows 2-5) and the selected proposal's
    energy to 1e-5."""
    from aehmc_tpu_torch.api import _generic_fused_binding
    from aehmc_tpu_torch.ops import generic_pg
    from aehmc_tpu_torch.ops.nuts_fused_small import nuts_transition_cuda

    lp, dim = _op_table_logprob(name, cuda_device)
    pot, rows = _generic_fused_binding(lp, dim, cuda_device)
    bound = generic_pg.bind(pot, rows, dim, device=cuda_device)
    ops_ = bound.operands(rows, cuda_device)

    def plain(x):
        return generic_pg.run_plain(bound.ir, x, ops_)

    chains = 256
    q_t = torch.tensor(0.3 * np.random.default_rng(5).normal(
        size=(dim, chains)), dtype=torch.float32, device=cuda_device)
    u0, g0 = plain(q_t)
    imm = torch.full((dim,), 0.9, device=cuda_device)
    gkw = dict(potential_and_grad_t=None, potential_fn_t=pot)
    kern = nuts_transition_cuda(q_t, u0, g0, imm, 0.2, rows, max_exp=4,
                                seed=7, **gkw)
    ref = nuts_transition_plain(q_t, u0, g0, imm, 0.2, plain, max_exp=4,
                                seed=7)
    same = (kern[3][2:6] == ref[3][2:6]).all(dim=0) & (
        (kern[3][0] - ref[3][0]).abs()
        <= 1e-5 * ref[3][0].abs().clamp(min=1.0))
    assert float(same.float().mean()) >= 0.99
    np.testing.assert_allclose(kern[0][:, same].cpu(), ref[0][:, same].cpu(),
                               rtol=1e-4, atol=1e-4)
    p0 = torch.randn(dim, chains, generator=torch.Generator().manual_seed(2)
                     ).to(cuda_device)
    kern = ghmc_transition_cuda(q_t, u0, g0, p0, 0.2, 0.0, imm, rows,
                                seed=8, **gkw)
    ref = ghmc_transition_plain(q_t, u0, g0, p0, 0.2, 0.0, imm, plain,
                                seed=8)
    _hmc_agree(q_t, kern[0], ref[0], kern[4], ref[4])
    qs, gs = q_t.T.contiguous(), g0.T.contiguous()
    kern = chees_fused.chees_transition_cuda(
        qs, u0.reshape(-1), gs, imm, 0.2, torch.full(
            (), 5, dtype=torch.int32, device=cuda_device), rows, seed=9,
        **gkw)
    ref = chees_fused.chees_transition_plain(qs, u0.reshape(-1), gs, imm, 0.2,
                                             5, plain, seed=9)
    _hmc_agree(q_t, kern[0].T, ref[0].T, kern[3].T, ref[3].T)
