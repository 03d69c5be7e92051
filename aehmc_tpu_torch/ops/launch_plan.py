"""The launch plan of the CUDA kernels, the single source of their
geometry.

A block is 8 warps and holds ``chains`` chains: 8 (one a warp) or 16 (two
a warp).  Its shared memory holds the core's rows of ``dim`` floats per
chain (padded to a multiple of 4; kernel 8 also one row of M⁻¹ for the
block), then the functor's scratch (the tiles of residuals σ(X q) − y, one
per 8 chains, the potentials, an mbarrier and its counts), with bfloat16
operands the rows of q rounded once per gradient, and a tile of ``points``
rows of X that one thread bulk-copies per chunk, requested as soon as the
tile is free (``csrc/logistic_pg.cuh``).  The NUTS core keeps its 2K U-turn
checkpoint rows per chain in a global buffer of :func:`checkpoint_floats`
floats, so its shared memory does not grow with K.  X is read in rows of
``row_stride`` elements, 16 bytes' worth (4 floats or 8 bfloat16 values),
zero past ``dim``.

The potentials of Neal's funnel and of eight schools are functors with no
data matrix (``csrc/hierarchical_pg.cuh``), taken by the NUTS kernels 1 and
2: their scratch is the block's potentials alone, so their plan has no tile
(``points`` and ``row_stride`` 0) and 8 chains a block
(``launch_plan(..., functor="funnel" | "eight_schools")``).  So is a
functor generated from a potential's traced gradient graph
(``functor="generic"``, ``csrc/generic_pg.cuh``), in kernels 1-7: its
scratch adds a per-chain workspace of ``workspace`` floats, kept in shared
memory when two NUTS blocks still fit an SM with it
(:func:`generic_workspace_shared`), else in a global buffer of
:func:`generic_workspace_floats` floats.  The emitted functor fixes that
choice in its text (``WS_SHARED``) from the NUTS core's 17 rows, so the HMC
core's plan follows it and does not decide again with its own 8 rows: a
workspace two HMC blocks could hold in shared memory stays global when the
functor says so, and the plan's shared memory and the workspace pointer
agree with the functor.

The chains a block (:func:`chains_per_block`) depend on the core, dim and
X's type only, never on the chain count, so a chain's bits do not depend on
how many chains run.  The fused leapfrog kernel ("fused_hmc", kernel 8)
takes 16 wherever two blocks of 16 fit on an SM with a 128-point tile (to
float32 dim 144; 83,232 B a block at dim 100): each tile of X, barrier and
σ pass then serves 16 chains.  The HMC core ("hmc", kernels 5-7) and NUTS
take 8: 16 chains in the HMC core were measured slower at 10,240 chains
(640 blocks leave the grid's last round of 264 blocks 42% full), and NUTS's
17 rows a chain leave no room for 16.  What bounds the kernels then is the
functor's products on the CUDA cores and the shared-memory loads that feed
them (PERF.md §6).

:func:`launch_plan` picks the chains a block, then the largest tile with
which two blocks fit on one SM (NUTS; the other cores take the largest that
fits a block), or, where none does, the largest that fits one block, and
raises ``ValueError`` before any launch for a shape that does not fit.  The
grid is ``ceil(C / chains)`` blocks, the last one masking the chains past
the end; the wrappers pass the plan's numbers to the C launchers, which
launch the kernel built for those chains or fail.
"""

import math
from dataclasses import dataclass

import torch

SMEM_LIMIT = 232_448  # bytes of shared memory a block can use (H100)
SM_SMEM = 233_472     # bytes of shared memory an SM has (H100)
BLOCK_RESERVE = 1_024  # bytes the runtime reserves per resident block
NUTS_CHAINS = 8        # chains a NUTS block
POINTS = (128, 64, 32, 16, 8)  # points a chunk, the largest that fits first
MAX_EXP = 14                   # the NUTS core's checkpoint slots
# core -> (rows of dim floats per chain besides the functor's, rows for the
# whole block, whether the plan prefers two blocks per SM to a larger tile,
# whether the core takes 16 chains a block)
CORES = {"nuts": (17, 0, True, False), "hmc": (8, 0, False, False),
         "fused_hmc": (3, 1, False, True)}
# X's element type -> bytes
X_BYTES = {torch.float32: 4, torch.bfloat16: 2}
# the potential's device functor -> whether it reads a data matrix X through
# a shared tile (logistic_pg.cuh) or keeps only the block's potentials (and
# a generated functor's workspace) in its scratch (hierarchical_pg.cuh,
# generic_pg.cuh)
FUNCTORS = {"logistic": True, "funnel": False, "eight_schools": False,
            "generic": False}
# the cores instantiated on a functor with no X tile
NO_TILE_CORES = {"funnel": ("nuts",), "eight_schools": ("nuts",),
                 "generic": ("nuts", "hmc")}


def scratch_floats(chains: int) -> int:
    """Floats of the functor's scratch at ``chains`` a block
    (csrc/logistic_pg.cuh:scratch_floats): the residual tile, 128 rows of 12
    floats per 8 chains (the second 16 floats past the first's end), then
    the potentials, the mbarrier and its two counts."""
    rt = 128 * 12 if chains == 8 else (128 * 12 + 16) + 128 * 12
    return rt + chains + 4


def state_stride(dim: int) -> int:
    """A row of the chain state in shared memory: dim floats rounded up to a
    multiple of 4."""
    return 4 * math.ceil(dim / 4)


def row_stride(dim: int, x_dtype=torch.float32) -> int:
    """X's row stride in elements: dim rounded up to 16 bytes' worth (a
    multiple of 4 floats or 8 bfloat16 values)."""
    per16 = 16 // X_BYTES[x_dtype]
    return per16 * math.ceil(dim / per16)


def smem_bytes(core: str, dim: int, points: int, x_dtype=torch.float32,
               chains: int = 8, functor: str = "logistic",
               workspace: int = 0) -> int:
    """Bytes of dynamic shared memory a block of ``core`` with ``chains``
    chains takes with a tile of ``points`` rows of X in ``x_dtype``; with a
    functor that reads no X, its rows and the chains' potentials, and for a
    generated one the chains' ``workspace`` floats each when the functor
    keeps them in shared memory (:func:`generic_workspace_shared`, whatever
    the core)."""
    ds = state_stride(dim)
    per_chain, per_block = CORES[core][:2]
    rows = (per_chain * chains + per_block) * ds
    if not FUNCTORS[functor]:
        shared = functor == "generic" and generic_workspace_shared(dim,
                                                                   workspace)
        return 4 * (rows + chains + (chains * workspace if shared else 0))
    qb = chains * ds if x_dtype == torch.bfloat16 else 0
    tile = points * row_stride(dim, x_dtype) * X_BYTES[x_dtype]
    return 4 * (rows + scratch_floats(chains) + qb) + tile


def two_blocks_fit(smem: int) -> bool:
    """Whether two blocks of ``smem`` bytes fit on one SM."""
    return 2 * (smem + BLOCK_RESERVE) <= SM_SMEM


def chains_per_block(core: str, dim: int, x_dtype=torch.float32) -> int:
    """The chains a block of ``core`` holds at ``dim`` with X in
    ``x_dtype``: 16 for a core built for them (the fused leapfrog kernel)
    where two 16-chain blocks fit on an SM with a 128-point tile, else 8."""
    if CORES[core][3] and two_blocks_fit(
            smem_bytes(core, dim, POINTS[0], x_dtype, 16)):
        return 16
    return 8


def generic_workspace_shared(dim: int, workspace: int) -> bool:
    """Whether a generated functor's ``workspace`` floats a chain go to
    shared memory: when two NUTS blocks still fit an SM with them.
    ``workspace`` counts every vector the functor materialises
    (:func:`generic_pg.schedule`): contractions, elementwise values read
    more than once, a triangular solve's solution, a scatter-add's output
    and a cumulative sum.  The emitter bakes this into the functor
    (``WS_SHARED``), and every core's plan reads it from here."""
    rows = CORES["nuts"][0] * NUTS_CHAINS * state_stride(dim)
    smem = 4 * (rows + NUTS_CHAINS + NUTS_CHAINS * workspace)
    return workspace > 0 and two_blocks_fit(smem)


def generic_workspace_floats(dim: int, workspace: int, blocks: int) -> int:
    """Floats of a generated functor's global workspace, (blocks, 8,
    workspace) for the grid of the NUTS or the HMC core (8 chains a block
    in both), or 0 when it is in shared memory."""
    if workspace == 0 or generic_workspace_shared(dim, workspace):
        return 0
    return blocks * NUTS_CHAINS * workspace


def checkpoint_floats(dim: int, max_exp: int, blocks: int) -> int:
    """Floats of the NUTS checkpoint buffer: (blocks, 2, K, 8, ds)."""
    return blocks * 2 * max_exp * NUTS_CHAINS * state_stride(dim)


@dataclass(frozen=True)
class LaunchPlan:
    blocks: int      # ceil(C / chains); the last one masks chains past the end
    points: int      # points a chunk of X (the tile's rows)
    row_stride: int  # elements a row of X as the kernel reads it
    smem: int        # bytes of dynamic shared memory a block
    chains: int      # chains a block: 8 or 16

    def args(self):
        """The ints every launcher takes before its stream."""
        return (self.blocks, self.points, self.row_stride, self.smem,
                self.chains)


def launch_plan(core: str, dim: int, max_exp: int, num_chains: int,
                x_dtype=torch.float32, functor: str = "logistic",
                workspace: int = 0) -> LaunchPlan:
    """The geometry of a launch of ``core`` ("nuts", "hmc" or "fused_hmc")
    on ``num_chains`` chains of ``dim`` dimensions (``max_exp`` = K for
    NUTS) with X in ``x_dtype`` (float32 or bfloat16), for the potential's
    ``functor`` (:data:`FUNCTORS`; one with no X has no tile and ignores
    ``x_dtype``; a generated one has ``workspace`` floats a chain).
    Raises ``ValueError``, naming the limit, for a shape the kernels do not
    take."""
    if core not in CORES:
        raise ValueError(f"unknown core {core!r}; expected one of "
                         f"{sorted(CORES)}")
    if functor not in FUNCTORS:
        raise ValueError(f"unknown functor {functor!r}; expected one of "
                         f"{sorted(FUNCTORS)}")
    if not FUNCTORS[functor] and core not in NO_TILE_CORES[functor]:
        cores = " and ".join(c.upper() for c in NO_TILE_CORES[functor])
        raise ValueError(f"the {functor} functor runs in the {cores} "
                         f"kernels only, not in {core!r}")
    if x_dtype not in X_BYTES:
        raise ValueError(f"X is float32 or bfloat16, got {x_dtype}")
    if dim < 1 or num_chains < 1:
        raise ValueError(f"dim {dim} and num_chains {num_chains} must be >= 1")
    if core == "nuts" and not 1 <= max_exp <= MAX_EXP:
        raise ValueError(f"max_num_expansions {max_exp} is outside "
                         f"[1, {MAX_EXP}]")
    if not FUNCTORS[functor]:
        smem = smem_bytes(core, dim, 0, chains=NUTS_CHAINS, functor=functor,
                          workspace=workspace)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"{core} at dim {dim} needs {smem} bytes of shared memory a "
                f"block; the limit is {SMEM_LIMIT}")
        return LaunchPlan(math.ceil(num_chains / NUTS_CHAINS), 0, 0, smem,
                          NUTS_CHAINS)
    chains = chains_per_block(core, dim, x_dtype)
    sizes = [(points, smem_bytes(core, dim, points, x_dtype, chains))
             for points in POINTS]
    fits = [(p, s) for p, s in sizes if s <= SMEM_LIMIT]
    if not fits:
        raise ValueError(
            f"{core} at dim {dim} needs {sizes[-1][1]} bytes of shared "
            f"memory a block; the limit is {SMEM_LIMIT}")
    if CORES[core][2]:
        fits = [f for f in fits if two_blocks_fit(f[1])] or fits
    points, smem = fits[0]
    return LaunchPlan(math.ceil(num_chains / chains), points,
                      row_stride(dim, x_dtype), smem, chains)


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
