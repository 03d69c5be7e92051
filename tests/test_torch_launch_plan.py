"""The launch plan of the port's CUDA kernels (``ops/launch_plan.py``), on the
CPU: every shape the earlier kernels took still fits the 227 KB of shared
memory a block can use, the grid covers ragged chain counts with whole
blocks, a shape that does not fit raises ``ValueError`` before any launch,
and X reaches the kernels in rows of a 16-byte multiple, zero past dim."""

import math

import numpy as np
import pytest
import torch

from aehmc_tpu_torch.ops import launch_plan as lp

LIMIT_FLOATS = lp.SMEM_LIMIT // 4


def _earlier_fits(core, ds, max_exp):
    """Whether the previous kernels took a row stride of ds floats: their
    blocks kept the core's rows, 2 more rows of scratch, a 256 x 8 buffer
    and 8 potentials in shared memory."""
    rows = {"nuts": 17 + 2 * max_exp, "hmc": 8, "fused_hmc": 3}[core]
    return (rows + 2) * 8 * ds + 8 * 256 + 8 <= LIMIT_FLOATS


@pytest.mark.parametrize("core,max_exp", [("nuts", k) for k in range(1, 15)]
                         + [("hmc", 0), ("fused_hmc", 0)])
def test_every_shape_the_earlier_kernels_took_fits(core, max_exp):
    taken = [dim for dim in range(1, 1500)
             if _earlier_fits(core, 4 * math.ceil(dim / 4), max_exp)]
    assert taken, "the earlier kernels took some dim"
    for dim in taken:
        plan = lp.launch_plan(core, dim, max_exp, 10_240)
        assert plan.smem <= lp.SMEM_LIMIT
        assert plan.smem == lp.smem_bytes(core, dim, max_exp, plan.points)
        assert plan.points in lp.POINTS
    if core == "nuts" and max_exp == 6:
        assert max(taken) == 224


def test_the_flagship_takes_full_chunks():
    nuts = lp.launch_plan("nuts", 100, 6, 10_240)
    hmc = lp.launch_plan("hmc", 100, 0, 10_240)
    assert (nuts.points, hmc.points) == (128, 128)
    assert (nuts.row_stride, hmc.row_stride) == (100, 100)
    # two blocks a SM (228 KB) at the flagship, both cores
    assert 2 * (nuts.smem + 1024) <= 228 * 1024
    assert 2 * (hmc.smem + 1024) <= 228 * 1024
    assert lp.launch_plan("hmc", 700, 0, 9).points == 16


@pytest.mark.parametrize("chains,blocks", [(1, 1), (8, 1), (9, 2),
                                           (10_240, 1280), (10_245, 1281),
                                           (10_248, 1281)])
def test_the_grid_covers_ragged_chain_counts_with_whole_blocks(chains, blocks):
    for core, max_exp in (("nuts", 6), ("hmc", 0), ("fused_hmc", 0)):
        plan = lp.launch_plan(core, 100, max_exp, chains)
        assert plan.blocks == blocks
        assert plan.blocks * lp.CHAINS_PER_BLOCK >= chains
        assert (plan.blocks - 1) * lp.CHAINS_PER_BLOCK < chains
        assert plan.args() == (plan.blocks, plan.points, plan.row_stride,
                               plan.smem)


@pytest.mark.parametrize("core,dim,max_exp", [("nuts", 300, 6),
                                              ("nuts", 160, 14),
                                              ("hmc", 3000, 0),
                                              ("fused_hmc", 8000, 0)])
def test_a_shape_too_large_raises_naming_the_limit(core, dim, max_exp):
    with pytest.raises(ValueError, match=str(lp.SMEM_LIMIT)):
        lp.launch_plan(core, dim, max_exp, 64)


@pytest.mark.parametrize("args", [("nuts", 100, 0, 64), ("nuts", 100, 15, 64),
                                  ("hmc", 0, 0, 64), ("hmc", 100, 0, 0),
                                  ("leapfrog", 100, 0, 64)])
def test_arguments_out_of_range_raise(args):
    with pytest.raises(ValueError):
        lp.launch_plan(*args)


@pytest.mark.parametrize("dim", [1, 3, 4, 7, 100, 101])
def test_rows_of_x_are_padded_to_16_bytes_with_zeros(dim):
    stride = lp.row_stride(dim)
    assert stride % 4 == 0 and dim <= stride < dim + 4
    X = torch.tensor(np.random.default_rng(dim).normal(size=(5, dim)),
                     dtype=torch.float32)
    rows = lp.data_rows(X, stride)
    assert rows.shape == (5, stride) and rows.is_contiguous()
    assert torch.equal(rows[:, :dim], X)
    assert not bool(rows[:, dim:].any())
    assert (rows is X) == (stride == dim)
