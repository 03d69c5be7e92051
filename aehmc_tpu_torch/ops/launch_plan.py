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
(``functor="generic"``, ``csrc/generic_pg.cuh``), in kernels 1-7, has a
geometry of its own (:func:`generic_geometry`, :class:`GenericGeometry`):
after the block's potentials, its **resident** data operands (copied into
shared memory once, at block entry: the small ones, smallest first, while
two NUTS blocks still fit an SM), then two buffers of a **tile** through
which a top-level matrix product reads a **streamed** operand (one too
large to be resident) in chunks of ``points`` rows (128, 64 or 32, a
multiple of 32, the largest with which two NUTS blocks fit), each row
padded to ``row_stride`` words, an odd number, so that lanes reading
neighbouring rows fall in distinct banks; then the per-chain workspace of
``workspace`` floats, kept in shared memory when two NUTS blocks still fit
an SM with it (:func:`generic_workspace_shared`), else in a global buffer
of :func:`generic_workspace_floats` floats; then, where the workspace is
global and the functor factors or solves a dense matrix (a Cholesky or LU
factor, a triangular solve of several right sides), a **factor** scratch
of ``factor_floats`` a chain in which each such node keeps its working
matrix for its life (the factor, or the solution), wherever the block's 8
copies fit beside the rest (:func:`generic_factor_shared`: where two NUTS
blocks still fit an SM, or, for an LU, one).  The emitted functor fixes
its geometry in its text (``RES_FLOATS``, ``TILE_ROWS``, ``TILE_STRIDE``,
``WS_SHARED``, ``FS_FLOATS``) from the NUTS core's 17 rows, so the HMC
core's plan follows it and does not decide again with its own 8 rows: a
workspace two HMC blocks could hold in shared memory stays global when
the functor says so, and the plan's shared memory, points, row stride
and workspace pointer agree with the functor, which checks the points and
row stride of every launch.

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
               geometry: "GenericGeometry" = None) -> int:
    """Bytes of dynamic shared memory a block of ``core`` with ``chains``
    chains takes with a tile of ``points`` rows of X in ``x_dtype``; with a
    functor that reads no X, its rows and the chains' potentials, and for a
    generated one its ``geometry``'s scratch (resident operands, tile
    buffers, and the workspace when the functor keeps it in shared memory,
    whatever the core)."""
    ds = state_stride(dim)
    per_chain, per_block = CORES[core][:2]
    rows = (per_chain * chains + per_block) * ds
    if not FUNCTORS[functor]:
        if functor == "generic" and geometry is not None:
            return 4 * (rows + geometry.scratch_floats())
        return 4 * (rows + chains)
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


def generic_workspace_shared(dim: int, workspace: int,
                             fixed: int = 0) -> bool:
    """Whether a generated functor's ``workspace`` floats a chain go to
    shared memory: when two NUTS blocks still fit an SM with them beside
    the functor's ``fixed`` floats (its resident operands and tile
    buffers).  ``workspace`` counts every vector the functor materialises
    (:func:`generic_pg.schedule`): contractions, elementwise values read
    more than once, a triangular solve's solution, a scatter-add's output
    and a cumulative sum.  The emitter bakes this into the functor
    (``WS_SHARED``), and every core's plan reads it from the geometry."""
    rows = CORES["nuts"][0] * NUTS_CHAINS * state_stride(dim)
    smem = 4 * (rows + NUTS_CHAINS + fixed + NUTS_CHAINS * workspace)
    return workspace > 0 and two_blocks_fit(smem)


def generic_factor_shared(dim: int, factor: int, fixed: int = 0,
                          lu: bool = False) -> bool:
    """Whether a generated functor's dense nodes keep their working
    matrices (``factor`` floats a chain: the largest a node takes) in
    shared memory beside the functor's ``fixed`` floats: where two NUTS
    blocks still fit an SM with its 8 copies; or, for a functor that
    factors an LU (``lu``), where one block fits.  An LU swaps rows and
    stores the whole trailing matrix at every step, and in the workspace
    those stores leave L2 to serve the next step's loads: S2 at one block
    an SM with the scratch took 7.75 ms a kernel-1 launch against 14.21
    with two blocks' room and the workspace (1,024 chains), 30.9 against
    45.5 at 4,096.  S1's Cholesky factor and solves gained nothing at
    1,024 chains in shared memory and lost 24% at 4,096, where two blocks
    an SM and the L1 the scratch would take serve them better (PERF.md
    §6)."""
    rows = CORES["nuts"][0] * NUTS_CHAINS * state_stride(dim)
    smem = 4 * (rows + NUTS_CHAINS + fixed + NUTS_CHAINS * factor)
    return factor > 0 and (two_blocks_fit(smem) or
                           (lu and smem <= SMEM_LIMIT))


def generic_workspace_floats(geometry: "GenericGeometry",
                             blocks: int) -> int:
    """Floats of a generated functor's global workspace, (blocks, 8,
    workspace) for the grid of the NUTS or the HMC core (8 chains a block
    in both), or 0 when it is in shared memory."""
    if geometry.workspace == 0 or geometry.ws_shared:
        return 0
    return blocks * NUTS_CHAINS * geometry.workspace


TILE_ROWS = (128, 64, 32)  # a streamed operand's rows a chunk, largest first
TILE_STAGES = 2            # tile buffers: one filled while the other is read


def odd_stride(row: int) -> int:
    """A tile's row stride in words: ``row`` rounded up to an odd number,
    so that the 32 lanes of a warp reading one word each of 32 neighbouring
    rows fall in 32 distinct banks."""
    return row | 1


@dataclass(frozen=True)
class GenericGeometry:
    """Where a generated functor keeps its data operands and workspace.

    ``resident``: (operand, offset, floats) of the operands copied into
    shared memory at block entry, at 4-float offsets from the scratch's
    resident area; ``streamed``: (operand, row floats, row stride) of the
    operands a top-level matrix product reads through the tile, ``points``
    rows a chunk; every other operand is read from global memory
    (``__ldg``).  ``tile_floats``: one tile buffer (of ``TILE_STAGES``).
    ``factor_floats``: a chain's factor scratch in shared memory (0: the
    dense nodes work in the workspace).
    """
    dim: int
    workspace: int
    resident: tuple = ()
    streamed: tuple = ()
    points: int = 0
    tile_floats: int = 0
    ws_shared: bool = False
    factor_floats: int = 0

    @property
    def row_stride(self) -> int:
        """The widest streamed row's stride, the launch's ``row_stride``
        (0 without a tile)."""
        return max((rs for _, _, rs in self.streamed), default=0)

    @property
    def resident_floats(self) -> int:
        return sum(4 * math.ceil(n / 4) for _, _, n in self.resident)

    @property
    def fixed_floats(self) -> int:
        """Floats of the resident operands and the tile buffers."""
        return self.resident_floats + TILE_STAGES * self.tile_floats

    def scratch_floats(self) -> int:
        """Floats of the functor's scratch after the core's rows: the
        potentials, resident operands, tile buffers, (shared) the
        workspace, and the factor scratch."""
        return (NUTS_CHAINS + self.fixed_floats
                + (NUTS_CHAINS * self.workspace if self.ws_shared else 0)
                + NUTS_CHAINS * self.factor_floats)

    def kind(self, j: int) -> str:
        """Operand ``j``'s place: "resident", "streamed" or "global"."""
        if any(r[0] == j for r in self.resident):
            return "resident"
        if any(r[0] == j for r in self.streamed):
            return "streamed"
        return "global"


def _tile_floats(points: int, streamed) -> int:
    return 4 * math.ceil(points * max(odd_stride(r) for _, r in streamed) / 4)


def generic_geometry(dim: int, workspace: int, operands=(),
                     streamable=None, factors=(),
                     lu: bool = False) -> GenericGeometry:
    """The geometry of a generated functor at ``dim`` with ``workspace``
    floats a chain and data operands of ``operands`` floats each, of which
    ``streamable`` (operand -> row floats) a top-level matrix product reads
    a whole row of at a time, and whose dense nodes' working matrices take
    ``factors`` floats a chain each (``lu``: one of them an LU).  The
    operands go resident, smallest first, while two NUTS blocks still fit
    an SM beside the smallest tile the other streamable ones need; the
    rest of the streamable ones are streamed through a tile of the most
    rows (of :data:`TILE_ROWS`) with which two NUTS blocks fit (one, where
    two cannot, up to the block's limit); what neither takes is read from
    global memory.  With a global workspace the dense nodes' matrices go
    to a factor scratch in shared memory, the largest of ``factors`` that
    :func:`generic_factor_shared` admits: a node that needs more works in
    the workspace.  Raises
    ``ValueError`` with the bytes a block needs where the NUTS rows and
    potentials alone exceed the limit."""
    streamable = dict(streamable or {})
    rows = CORES["nuts"][0] * NUTS_CHAINS * state_stride(dim)
    base = 4 * (rows + NUTS_CHAINS)
    if base > SMEM_LIMIT:
        raise ValueError(f"a generated functor at dim {dim} needs {base} "
                         f"bytes of shared memory a block; the limit is "
                         f"{SMEM_LIMIT}")
    pair = SM_SMEM // 2 - BLOCK_RESERVE  # a block's bytes with two an SM
    resident, res, taken = [], set(), 0
    for j in sorted(range(len(operands)), key=lambda j: (operands[j], j)):
        rest = [(i, r) for i, r in streamable.items()
                if i != j and i not in res]
        tile = (TILE_STAGES * _tile_floats(TILE_ROWS[-1], rest) if rest
                else 0)
        size = 4 * math.ceil(operands[j] / 4)
        if base + 4 * (taken + size + tile) > pair:
            break
        resident.append((j, taken, operands[j]))
        res.add(j)
        taken += size
    streamed = [(j, r) for j, r in sorted(streamable.items())
                if j not in res]
    points, tile = 0, 0
    for limit in (pair, SMEM_LIMIT):
        if points or not streamed:
            break
        for p in TILE_ROWS:
            t = _tile_floats(p, streamed)
            if base + 4 * (taken + TILE_STAGES * t) <= limit:
                points, tile = p, t
                break
    if not points:
        streamed = []
    fixed = taken + TILE_STAGES * tile
    ws_shared = generic_workspace_shared(dim, workspace, fixed)
    factor = 0 if ws_shared else next(
        (f for f in sorted(set(factors), reverse=True)
         if generic_factor_shared(dim, f, fixed, lu)), 0)
    return GenericGeometry(
        dim=dim, workspace=workspace, resident=tuple(resident),
        streamed=tuple((j, r, odd_stride(r)) for j, r in streamed),
        points=points, tile_floats=tile, ws_shared=ws_shared,
        factor_floats=factor)


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
                geometry: GenericGeometry = None) -> LaunchPlan:
    """The geometry of a launch of ``core`` ("nuts", "hmc" or "fused_hmc")
    on ``num_chains`` chains of ``dim`` dimensions (``max_exp`` = K for
    NUTS) with X in ``x_dtype`` (float32 or bfloat16), for the potential's
    ``functor`` (:data:`FUNCTORS`; one with no X has no X tile and ignores
    ``x_dtype``; a generated one takes the ``geometry`` it was emitted
    with, its tile's points and row stride in the plan's).
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
        if functor == "generic" and geometry is None:
            geometry = GenericGeometry(dim, 0)
        if geometry is not None and geometry.dim != dim:
            raise ValueError(f"the functor was emitted for dim "
                             f"{geometry.dim}, not {dim}")
        smem = smem_bytes(core, dim, 0, chains=NUTS_CHAINS, functor=functor,
                          geometry=geometry)
        if smem > SMEM_LIMIT:
            raise ValueError(
                f"{core} at dim {dim} needs {smem} bytes of shared memory a "
                f"block; the limit is {SMEM_LIMIT}")
        points, stride = ((geometry.points, geometry.row_stride)
                          if geometry is not None else (0, 0))
        return LaunchPlan(math.ceil(num_chains / NUTS_CHAINS), points,
                          stride, smem, NUTS_CHAINS)
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
