"""The launch plan of the port's CUDA kernels (``ops/launch_plan.py``), on the
CPU: every shape the earlier kernels took still fits the 227 KB of shared
memory a block can use, the NUTS core's shared memory no longer grows with
K (its checkpoints live in a global buffer) and keeps two blocks per SM
where a tile allows it, the fused leapfrog kernel takes 16 chains a block
wherever two such blocks fit with a 128-point tile and the NUTS and HMC
cores always 8 (a choice of the core, dim and X's type alone), the grid
covers ragged chain counts with whole blocks, a shape that does not fit
raises ``ValueError`` before any launch, and X reaches the kernels in rows
of a 16-byte multiple (4 floats or 8 bfloat16 values), zero past dim."""

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
        for x_dtype in (torch.float32, torch.bfloat16):
            plan = lp.launch_plan(core, dim, max_exp, 10_240, x_dtype)
            assert plan.smem <= lp.SMEM_LIMIT
            assert plan.smem == lp.smem_bytes(core, dim, plan.points, x_dtype,
                                              plan.chains)
            assert plan.points in lp.POINTS
            assert plan.chains == lp.chains_per_block(core, dim, x_dtype)
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
    """``blocks`` is the count at 8 chains a block (NUTS, the HMC core, the
    fused leapfrog kernel at dim 145); at 16 (the fused leapfrog kernel at
    dim 100) it is ceil(chains / 16)."""
    for core, max_exp, dim in (("nuts", 6, 100), ("hmc", 0, 100),
                               ("fused_hmc", 0, 100), ("fused_hmc", 0, 145)):
        plan = lp.launch_plan(core, dim, max_exp, chains)
        per_block = 16 if (core, dim) == ("fused_hmc", 100) else 8
        assert plan.chains == per_block
        assert plan.blocks == (blocks if per_block == 8
                               else math.ceil(chains / 16))
        assert plan.blocks * plan.chains >= chains
        assert (plan.blocks - 1) * plan.chains < chains
        assert plan.args() == (plan.blocks, plan.points, plan.row_stride,
                               plan.smem, plan.chains)


@pytest.mark.parametrize("core,dim,max_exp", [("nuts", 400, 6),
                                              ("nuts", 400, 14),
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


def _parent_nuts_max_dim(max_exp):
    """The largest dim the NUTS kernels took before their checkpoints left
    shared memory: 17 + 2K rows a chain, the scratch, no tile."""
    return max(dim for dim in range(1, 1500)
               if 4 * ((17 + 2 * max_exp) * 8 * lp.state_stride(dim)
                       + lp.scratch_floats(8)) <= lp.SMEM_LIMIT)


@pytest.mark.parametrize("max_exp", range(1, 15))
def test_nuts_smem_at_the_flagship_does_not_grow_with_k(max_exp):
    """17 rows x 8 chains x 100 floats + the functor's scratch + a 128-point
    float32 tile: 54,400 + 6,192 + 51,200 bytes, two blocks per SM."""
    plan = lp.launch_plan("nuts", 100, max_exp, 10_240)
    assert (plan.points, plan.smem) == (128, 111_792)
    assert 2 * (plan.smem + 1024) <= 233_472
    assert lp.two_blocks_fit(plan.smem)
    bf = lp.launch_plan("nuts", 100, max_exp, 10_240, torch.bfloat16)
    # bfloat16: the tile's rows are 104 values of 2 bytes, plus q's rounded
    # rows (8 x 100 floats)
    assert (bf.points, bf.row_stride) == (128, 104)
    assert bf.smem == 54_400 + 6_192 + 3_200 + 128 * 104 * 2


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("max_exp", [1, 6, 14])
def test_nuts_points_are_the_largest_with_two_blocks_per_sm(max_exp, x_dtype):
    for dim in range(1, 393):
        if not _fits("nuts", dim, max_exp, x_dtype):
            # bfloat16's rounded rows of q take a little room from the tile
            assert x_dtype == torch.bfloat16 and dim > 376
            continue
        plan = lp.launch_plan("nuts", dim, max_exp, 64, x_dtype)
        two = [pts for pts in lp.POINTS
               if lp.two_blocks_fit(lp.smem_bytes("nuts", dim, pts, x_dtype))]
        one = [pts for pts in lp.POINTS
               if lp.smem_bytes("nuts", dim, pts, x_dtype) <= lp.SMEM_LIMIT]
        assert plan.points == (two or one)[0], dim
    # dim 100 keeps 128 points and two blocks; just past it the tile halves
    # to keep two blocks
    assert lp.launch_plan("nuts", 104, max_exp, 64).points == 64
    assert lp.two_blocks_fit(lp.launch_plan("nuts", 104, max_exp, 64).smem)


@pytest.mark.parametrize("max_exp", [6, 14])
def test_nuts_takes_every_dim_it_took_before(max_exp):
    largest = max(dim for dim in range(1, 1500)
                  if _fits("nuts", dim, max_exp))
    assert largest >= _parent_nuts_max_dim(max_exp)
    assert _parent_nuts_max_dim(max_exp) == {6: 240, 14: 156}[max_exp]
    # the tile is the limit now, at every K: 8 points at dim 392
    assert largest == 392
    assert lp.launch_plan("nuts", 392, max_exp, 64).points == 8


def _fits(core, dim, max_exp, x_dtype=torch.float32):
    try:
        lp.launch_plan(core, dim, max_exp, 64, x_dtype)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("dim,max_exp,chains", [(100, 6, 10_240),
                                                (100, 14, 10_245),
                                                (7, 1, 9), (392, 14, 64)])
def test_the_checkpoint_buffer_holds_2k_rows_a_chain(dim, max_exp, chains):
    blocks = lp.launch_plan("nuts", dim, max_exp, chains).blocks
    floats = lp.checkpoint_floats(dim, max_exp, blocks)
    assert floats == blocks * 2 * max_exp * 8 * lp.state_stride(dim)
    # a chain's slot row is 16-byte aligned
    assert lp.state_stride(dim) % 4 == 0
    if (dim, max_exp, chains) == (100, 6, 10_240):
        assert floats * 4 == 49_152_000  # 1,280 blocks x 12 rows x 8 x 400 B


@pytest.mark.parametrize("dim", [1, 3, 7, 8, 100, 101])
def test_bf16_rows_of_x_are_padded_to_8_elements_with_zeros(dim):
    stride = lp.row_stride(dim, torch.bfloat16)
    assert stride % 8 == 0 and dim <= stride < dim + 8
    X = torch.tensor(np.random.default_rng(dim).normal(size=(5, dim)),
                     dtype=torch.float32)
    rows = lp.data_rows(X, stride, torch.bfloat16)
    assert rows.dtype == torch.bfloat16 and rows.is_contiguous()
    assert rows.shape == (5, stride)
    # rounded once, to nearest even, as X.to(torch.bfloat16)
    assert torch.equal(rows[:, :dim], X.to(torch.bfloat16))
    assert not bool(rows[:, dim:].any())
    # a bfloat16 X passes through unrounded again
    Xb = X.to(torch.bfloat16)
    again = lp.data_rows(Xb, stride, torch.bfloat16)
    assert torch.equal(again[:, :dim], Xb)
    assert (again is Xb) == (stride == dim)


# ---- chains a block (16 for the fused leapfrog kernel where two such
# blocks fit; 8 for the NUTS and HMC cores)

def _fused_hmc_edge():
    """The largest dim at which two 16-chain blocks of kernel 8 fit on an SM
    with a 128-point float32 tile, from the byte count written out: 3 rows
    of 16 chains and a row of M⁻¹, the functor's scratch (two 128 x 12
    residual tiles 16 floats apart, 16 potentials, the barrier and its
    counts), the tile."""
    scratch = (128 * 12 + 16) + 128 * 12 + 16 + 4
    best = 0
    for dim in range(1, 400):
        ds = 4 * math.ceil(dim / 4)
        smem = 4 * ((3 * 16 + 1) * ds + scratch) + 128 * ds * 4
        if 2 * (smem + 1024) <= 233_472:
            best = dim
    return best


def test_the_flagship_fused_leapfrog_block_takes_16_chains():
    """Float32 dim 100: 3 rows x 16 chains + a row of M⁻¹ (19,600 B), the
    functor's scratch at 16 chains (12,432 B), a 128-point tile (51,200 B):
    83,232 B, two blocks per SM, 640 blocks for 10,240 chains."""
    plan = lp.launch_plan("fused_hmc", 100, 0, 10_240)
    assert (plan.chains, plan.points, plan.smem) == (16, 128, 83_232)
    assert lp.scratch_floats(16) * 4 == 12_432
    assert lp.two_blocks_fit(plan.smem) and plan.blocks == 640


@pytest.mark.parametrize("dim,chains", [(1, 16), (100, 16), (101, 16),
                                        (143, 16), (144, 16), (145, 8),
                                        (148, 8), (700, 8)])
def test_the_fused_leapfrog_takes_16_chains_up_to_the_two_block_edge(dim,
                                                                     chains):
    assert _fused_hmc_edge() == 144
    plan = lp.launch_plan("fused_hmc", dim, 0, 10_240)
    assert plan.chains == chains
    if chains == 16:
        assert plan.points == 128 and lp.two_blocks_fit(plan.smem)
    else:  # at 8 chains it takes the largest tile that fits a block
        fits = [pts for pts in lp.POINTS
                if lp.smem_bytes("fused_hmc", dim, pts) <= lp.SMEM_LIMIT]
        assert plan.points == fits[0]


@pytest.mark.parametrize("chains", [1, 9, 10_240, 10_245])
@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_chains_a_block_depend_on_core_dim_and_dtype_only(chains, x_dtype):
    """A chain's bits must not depend on how many chains run: the plan gives
    every chain count the chains a block, tile and shared memory of the
    flagship's count, and ceil(C / chains) blocks."""
    for core, max_exp in (("nuts", 6), ("hmc", 0), ("fused_hmc", 0)):
        for dim in (7, 100, 101, 120, 121, 144, 145, 392):
            try:
                ref = lp.launch_plan(core, dim, max_exp, 10_240, x_dtype)
            except ValueError:
                continue
            plan = lp.launch_plan(core, dim, max_exp, chains, x_dtype)
            assert (plan.chains, plan.points, plan.smem, plan.row_stride) == (
                ref.chains, ref.points, ref.smem, ref.row_stride)
            assert plan.chains == lp.chains_per_block(core, dim, x_dtype)
            assert plan.blocks == math.ceil(chains / plan.chains)


@pytest.mark.parametrize("core", ["nuts", "hmc"])
def test_the_nuts_and_hmc_cores_always_take_8_chains(core):
    """NUTS: its 17 rows a chain leave no room for 16; the HMC core (kernels
    5-7): 16 chains a block were measured slower at 10,240 chains."""
    max_exp = 6 if core == "nuts" else 0
    for x_dtype in (torch.float32, torch.bfloat16):
        for dim in range(1, 393, 7):
            assert lp.chains_per_block(core, dim, x_dtype) == 8
            if _fits(core, dim, max_exp, x_dtype):
                assert lp.launch_plan(core, dim, max_exp, 100,
                                      x_dtype).chains == 8
    # the HMC core at the flagship: 8 rows x 8 chains, the scratch, the tile
    plan = lp.launch_plan("hmc", 100, 0, 10_240)
    assert (plan.chains, plan.points, plan.smem) == (8, 128, 82_992)


@pytest.mark.parametrize("functor", ["funnel", "eight_schools"])
@pytest.mark.parametrize("dim,chains", [(10, 8192), (10, 2048), (6, 13),
                                        (1, 1), (300, 64)])
def test_a_functor_without_x_has_no_tile(functor, dim, chains):
    """The hierarchical functors read no data matrix: no tile (points and
    row stride 0), 8 chains a block, and shared memory for the NUTS rows and
    the block's 8 potentials only, whatever X's type and K."""
    for x_dtype in (torch.float32, torch.bfloat16):
        for max_exp in (1, 10, 14):
            plan = lp.launch_plan("nuts", dim, max_exp, chains, x_dtype,
                                  functor=functor)
            assert (plan.points, plan.row_stride, plan.chains) == (0, 0, 8)
            assert plan.blocks == math.ceil(chains / 8)
            assert plan.smem == 4 * (17 * 8 * lp.state_stride(dim) + 8)
    assert plan.smem < lp.launch_plan("nuts", dim, 10, chains).smem


@pytest.mark.parametrize("args, match", [
    (("hmc", 10, 0, 64), "NUTS kernels only"),
    (("fused_hmc", 10, 0, 64), "NUTS kernels only"),
    (("nuts", 10, 15, 64), "max_num_expansions"),
    (("nuts", 2000, 10, 64), "shared memory"),
])
def test_a_functor_without_x_raises_outside_the_nuts_kernels(args, match):
    with pytest.raises(ValueError, match=match):
        lp.launch_plan(*args, functor="funnel")
    with pytest.raises(ValueError, match="unknown functor"):
        lp.launch_plan("nuts", 10, 6, 64, functor="mvn")
