"""The launch plan of the CUDA kernels on the logistic functor, the single
source of their geometry.

A block holds 8 chains, one warp each.  Its shared memory holds the core's
rows of ``dim`` floats per chain (padded to a multiple of 4), then the
functor's scratch (the tile of residuals σ(X q) − y, the potentials and an
mbarrier) and, for the HMC cores, a tile of ``points`` rows of X that one
thread bulk-copies per chunk (``csrc/logistic_pg.cuh``).  The NUTS core has
no room for that tile and reads X through L1 in chunks of 128 points.  X is
read in rows of ``row_stride`` floats, a multiple of 4 (16-byte loads and
copies), zero past ``dim``.  :func:`launch_plan` picks the largest tile that
fits the 227 KB of shared memory a block can use and raises ``ValueError``
before any launch for a shape that does not fit; the wrappers pass its
numbers to the C launchers.
"""

import math
from dataclasses import dataclass

SMEM_LIMIT = 232_448  # bytes of shared memory a block can use (H100)
CHAINS_PER_BLOCK = 8
POINTS = (128, 64, 32, 16, 8)  # points a chunk, the largest that fits first
SCRATCH_FLOATS = 128 * 12 + 8 + 4  # csrc/logistic_pg.cuh:SCRATCH_FLOATS
MAX_EXP = 14                       # the NUTS core's checkpoint slots
# core -> (rows of dim floats per chain besides the functor's, X tile)
CORES = {"nuts": (None, False), "hmc": (8, True), "fused_hmc": (3, True)}


def core_rows(core: str, max_exp: int) -> int:
    """Rows of ``dim`` floats per chain that ``core`` keeps in shared
    memory: NUTS 17 + 2K (edges, proposals, momentum sums, scratch and 2K
    checkpoints), the HMC core 8, the fused leapfrog kernel 3."""
    rows = CORES[core][0]
    return 17 + 2 * max_exp if rows is None else rows


def row_stride(dim: int) -> int:
    """X's row stride in floats: dim rounded up to a multiple of 4."""
    return 4 * math.ceil(dim / 4)


def smem_bytes(core: str, dim: int, max_exp: int, points: int) -> int:
    rows = core_rows(core, max_exp) * CHAINS_PER_BLOCK * row_stride(dim)
    tile = points * row_stride(dim) if CORES[core][1] else 0
    return 4 * (rows + SCRATCH_FLOATS + tile)


@dataclass(frozen=True)
class LaunchPlan:
    blocks: int      # of 8 chains; the last one masks chains past the end
    points: int      # points a chunk of X
    row_stride: int  # floats a row of X as the kernel reads it
    smem: int        # bytes of dynamic shared memory a block

    def args(self):
        """The ints every launcher takes before its stream."""
        return (self.blocks, self.points, self.row_stride, self.smem)


def launch_plan(core: str, dim: int, max_exp: int,
                num_chains: int) -> LaunchPlan:
    """The geometry of a launch of ``core`` ("nuts", "hmc" or "fused_hmc")
    on ``num_chains`` chains of ``dim`` dimensions (``max_exp`` = K for
    NUTS).  Raises ``ValueError``, naming the limit, for a shape the kernels
    do not take."""
    if core not in CORES:
        raise ValueError(f"unknown core {core!r}; expected one of "
                         f"{sorted(CORES)}")
    if dim < 1 or num_chains < 1:
        raise ValueError(f"dim {dim} and num_chains {num_chains} must be >= 1")
    if core == "nuts" and not 1 <= max_exp <= MAX_EXP:
        raise ValueError(f"max_num_expansions {max_exp} is outside "
                         f"[1, {MAX_EXP}]")
    for points in POINTS if CORES[core][1] else POINTS[:1]:
        smem = smem_bytes(core, dim, max_exp, points)
        if smem <= SMEM_LIMIT:
            return LaunchPlan(math.ceil(num_chains / CHAINS_PER_BLOCK),
                              points, row_stride(dim), smem)
    raise ValueError(
        f"{core} at dim {dim}" + (f", K {max_exp}" if core == "nuts" else "")
        + f" needs {smem} bytes of shared memory a block; the limit is "
        f"{SMEM_LIMIT}")


def data_rows(X, stride: int):
    """X (points, dim) as the kernels read it: contiguous rows of ``stride``
    floats, zero past dim (X itself when it already is)."""
    if X.shape[1] == stride and X.is_contiguous():
        return X
    out = X.new_zeros((X.shape[0], stride))
    out[:, :X.shape[1]] = X
    return out
