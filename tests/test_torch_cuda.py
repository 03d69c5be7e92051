"""The port's CUDA NUTS kernels against their plain PyTorch versions, on the
card.  Every test here is marked ``gpu`` and skips without an NVIDIA GPU: a
CUDA kernel has no CPU mode.  This file imports no JAX, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_cuda.py

Decisions (doublings, leaves, divergent, turning) must be equal; positions
agree to 1e-4 (float32 products summed in another order than the plain
version's matmuls).  The whole-run kernel equals one launch per draw bit for
bit.
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
from aehmc_tpu_torch.ops.philox import MASK32

DIM, POINTS, CHAINS, MAX_EXP = 8, 64, 64, 5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _case(device, dense):
    _, pg, data, _ = logistic_regression_pg_t(DIM, POINTS, device=device)
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
    transition = make_fused_nuts_transition_small(
        None, data, max_num_expansions=MAX_EXP,
        potential_and_grad_t=lambda q, *d: pg(q, *d), transposed_io=True,
    )
    with pytest.raises(NotImplementedError, match="logistic"):
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
                                                device=cuda_device)
    gen = torch.Generator().manual_seed(0)
    q0 = (0.1 * torch.randn(256, 16, generator=gen)).to(cuda_device)
    reset_launch_counts()
    res = aehmc_tpu_torch.sample(
        gen, None, q0, 50, 30, data=data, potential_fn_t=pot,
        potential_and_grad_t=pg, collect_dtype=torch.bfloat16,
    )
    assert LAUNCHES == {"nuts_transition": 30, "nuts_sampling": 1}
    assert res.positions.dtype == torch.bfloat16 and res.positions.is_cuda
    assert bool(torch.isfinite(res.positions.float()).all())
