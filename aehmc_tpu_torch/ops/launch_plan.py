"""The launch plan of the CUDA kernels on the logistic functor, the single
source of their geometry.

A block holds 8 chains, one warp each.  Its shared memory holds the core's
rows of ``dim`` floats per chain (padded to a multiple of 4), then the
functor's scratch (the tile of residuals σ(X q) − y, the potentials and an
mbarrier), with bfloat16 operands the rows of q rounded once per gradient,
and a tile of ``points`` rows of X that one thread bulk-copies per chunk
(``csrc/logistic_pg.cuh``).  The NUTS core keeps its 2K U-turn checkpoint
rows per chain in a global buffer of :func:`checkpoint_floats` floats, so
its shared memory does not grow with K.  X is read in rows of
``row_stride`` elements, 16 bytes' worth (4 floats or 8 bfloat16 values),
zero past ``dim``.

:func:`launch_plan` picks the largest tile with which two blocks fit on one
SM (NUTS; the HMC cores take the largest that fits a block), or, where none
does, the largest that fits one block, and raises ``ValueError`` before any
launch for a shape that does not fit; the wrappers pass its numbers to the C
launchers.
"""

import math
from dataclasses import dataclass

import torch

SMEM_LIMIT = 232_448  # bytes of shared memory a block can use (H100)
SM_SMEM = 233_472     # bytes of shared memory an SM has (H100)
BLOCK_RESERVE = 1_024  # bytes the runtime reserves per resident block
CHAINS_PER_BLOCK = 8
POINTS = (128, 64, 32, 16, 8)  # points a chunk, the largest that fits first
SCRATCH_FLOATS = 128 * 12 + 8 + 4  # csrc/logistic_pg.cuh:SCRATCH_FLOATS
MAX_EXP = 14                       # the NUTS core's checkpoint slots
# core -> (rows of dim floats per chain besides the functor's, whether the
# plan prefers two blocks per SM to a larger tile)
CORES = {"nuts": (17, True), "hmc": (8, False), "fused_hmc": (3, False)}
# X's element type -> bytes
X_BYTES = {torch.float32: 4, torch.bfloat16: 2}


def core_rows(core: str) -> int:
    """Rows of ``dim`` floats per chain that ``core`` keeps in shared
    memory: NUTS 17 (edges, proposals, momentum sums and scratch), the HMC
    core 8, the fused leapfrog kernel 3."""
    return CORES[core][0]


def state_stride(dim: int) -> int:
    """A row of the chain state in shared memory: dim floats rounded up to a
    multiple of 4."""
    return 4 * math.ceil(dim / 4)


def row_stride(dim: int, x_dtype=torch.float32) -> int:
    """X's row stride in elements: dim rounded up to 16 bytes' worth (a
    multiple of 4 floats or 8 bfloat16 values)."""
    per16 = 16 // X_BYTES[x_dtype]
    return per16 * math.ceil(dim / per16)


def smem_bytes(core: str, dim: int, points: int,
               x_dtype=torch.float32) -> int:
    """Bytes of dynamic shared memory a block of ``core`` takes with a tile
    of ``points`` rows of X in ``x_dtype``."""
    ds = state_stride(dim)
    rows = core_rows(core) * CHAINS_PER_BLOCK * ds
    qb = CHAINS_PER_BLOCK * ds if x_dtype == torch.bfloat16 else 0
    tile = points * row_stride(dim, x_dtype) * X_BYTES[x_dtype]
    return 4 * (rows + SCRATCH_FLOATS + qb) + tile


def two_blocks_fit(smem: int) -> bool:
    """Whether two blocks of ``smem`` bytes fit on one SM."""
    return 2 * (smem + BLOCK_RESERVE) <= SM_SMEM


def checkpoint_floats(dim: int, max_exp: int, blocks: int) -> int:
    """Floats of the NUTS checkpoint buffer: (blocks, 2, K, 8, ds)."""
    return blocks * 2 * max_exp * CHAINS_PER_BLOCK * state_stride(dim)


@dataclass(frozen=True)
class LaunchPlan:
    blocks: int      # of 8 chains; the last one masks chains past the end
    points: int      # points a chunk of X (the tile's rows)
    row_stride: int  # elements a row of X as the kernel reads it
    smem: int        # bytes of dynamic shared memory a block

    def args(self):
        """The ints every launcher takes before its stream."""
        return (self.blocks, self.points, self.row_stride, self.smem)


def launch_plan(core: str, dim: int, max_exp: int, num_chains: int,
                x_dtype=torch.float32) -> LaunchPlan:
    """The geometry of a launch of ``core`` ("nuts", "hmc" or "fused_hmc")
    on ``num_chains`` chains of ``dim`` dimensions (``max_exp`` = K for
    NUTS) with X in ``x_dtype`` (float32 or bfloat16).  Raises
    ``ValueError``, naming the limit, for a shape the kernels do not take."""
    if core not in CORES:
        raise ValueError(f"unknown core {core!r}; expected one of "
                         f"{sorted(CORES)}")
    if x_dtype not in X_BYTES:
        raise ValueError(f"X is float32 or bfloat16, got {x_dtype}")
    if dim < 1 or num_chains < 1:
        raise ValueError(f"dim {dim} and num_chains {num_chains} must be >= 1")
    if core == "nuts" and not 1 <= max_exp <= MAX_EXP:
        raise ValueError(f"max_num_expansions {max_exp} is outside "
                         f"[1, {MAX_EXP}]")
    sizes = [(points, smem_bytes(core, dim, points, x_dtype))
             for points in POINTS]
    fits = [(p, s) for p, s in sizes if s <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"{core} at dim {dim} needs {sizes[-1][1]} bytes of shared "
            f"memory a block; the limit is {SMEM_LIMIT}")
    if CORES[core][1]:
        fits = [f for f in fits if two_blocks_fit(f[1])] or fits
    points, smem = fits[0]
    return LaunchPlan(math.ceil(num_chains / CHAINS_PER_BLOCK), points,
                      row_stride(dim, x_dtype), smem)


def data_rows(X, stride: int, x_dtype=torch.float32):
    """X (points, dim) as the kernels read it: contiguous rows of ``stride``
    elements of ``x_dtype``, zero past dim (X itself when it already is).
    A float32 X given for bfloat16 is rounded once, to nearest even."""
    X = X.to(x_dtype)
    if X.shape[1] == stride and X.is_contiguous():
        return X
    out = X.new_zeros((X.shape[0], stride))
    out[:, :X.shape[1]] = X
    return out
