"""The potential compiler: any per-chain potential whose ops are in its
table as a device functor of the fused kernels 1-7.

On the TPU the fused kernels run any ``jnp`` potential: Pallas traces it
into the kernel body and differentiates it there with ``jax.vjp``
(``aehmc_tpu/ops/nuts_fused_small.py:_pot_grad_builder_t``,
``aehmc_tpu/ops/nuts_fused.py``).  This module does the same in three
steps with public PyTorch API:

1. :func:`trace_potential` traces the per-chain function and its gradient
   (``make_fx`` over ``torch.func.grad``) on a ``(dim,)`` probe, or the
   caller's ``potential_and_grad_t`` as it stands;
2. the trace becomes a small IR of static-shape nodes with no chain axis
   (:class:`IR`): elementwise ops (the special functions ``lgamma``,
   ``digamma``, ``erf``, ``erfc``, ``log_ndtr``, ``isnan``, ``pow`` of two
   tensors or of a number base among them), sums and maxima along axes,
   the index of a maximum (``max.dim``/``min.dim``'s, a per-chain integer),
   matrix products, triangular solves, general solves (LU with partial
   pivoting), gathers by an index operand and their scatter-adds, writing
   scatters (``put``: by an inverse index map; ``pick``: by a per-chain
   index of one entry), cumulative sums and products, products along
   axes, Cholesky factors, log-determinants (an LU), symmetric
   eigendecompositions (cyclic Jacobi), sorts and top-k (a per-chain
   permutation, the values a ``take`` by it, its backward a scatter by
   it), reducing scatters by an index of data, masks computed from an
   element's index (``eye``, ``tril``, diagonals), per-chain integer
   arithmetic on an index computed on the card, views, constants, the
   position ``q`` and the data operands; and the everyday ops: ``xlogy``,
   ``log_sigmoid``, ``logit``, ``atan2``, ``erfinv``, the modified Bessel
   functions, ``polygamma`` (elementwise), ``logcumsumexp`` and the index
   of a running maximum (``cummax``, ``cummin``; sequential like
   ``cumsum``), scatters, reducing scatters and gathers by a per-chain
   index of several entries, an LU factor with its pivots and the P they
   make, a reduced QR (Householder), a thin SVD (one-sided Jacobi) and the
   matrix exponential (ATen's Taylor polynomials with scaling and
   squaring); closed-over tensors become data operands, as
   ``jax.closure_convert`` makes them.  Data are float32, or integer
   (int32/int64: index vectors, counts), which travel to the card as int32
   rows.  An integer or bool value computed from the data alone (index
   arithmetic such as ``y - 1``, ``torch.arange``, a mask such as
   ``~isnan(t)``, the flat positions that several index tensors, a mask or
   ``torch.gather``/``scatter`` read or write) is evaluated on the host
   into a derived int32 row (:func:`derived_operands`), rebuilt when the
   data change; the kernel's work stays as it is.  A float value of the
   data alone that has no rule (or a dear one: a factorisation, a sort)
   is folded the same way, in float64, into a derived float32 row.
   ``logsumexp``,
   ``log_softmax``, ``softmax``, ``stack``, ``var``, ``cholesky_solve``,
   ``min``, ``amin``, ``mvlgamma``, vector norms, ``linalg.cross``,
   ``cdist`` and its backward, ``inv``, ``lu_solve``, ``lu_unpack``,
   ``det``, ``cholesky_inverse``, ``pinv``, ``lstsq`` and a write under a
   mask that depends on q (a ``where``) are rewritten into the nodes
   above;
3. :func:`emit_cuda` writes ``struct GenericPG`` to the NUTS core's functor
   contract (``csrc/nuts_core.cuh``), which ``csrc/nuts_generic.cu``
   instantiates as kernels 1-4 and ``csrc/hmc_generic.cu`` as kernels 5-7
   (``_build.load_generated`` builds both).

:func:`run_plain` interprets the IR with torch ops over a ``(dim, C)``
batch: the plain version of the generated functor.

The generated functor.  One warp computes one chain (CB = 8 chains a
block).  Every contraction (a sum, a maximum, a matrix product) is
materialised: a reduction to one number ends in ``warp_sum`` (or
``gpg_warp_max``; fixed order) and stays in a register; a longer output
runs one lane an output element, its inner sum sequential, or, where the
lanes would read strided addresses (or fewer than 32 outputs sum long
rows), the warp sums 8 outputs at a time, each in the lane-then-butterfly
order.  A triangular solve substitutes row by row, sequential in the row:
the lanes split each row's inner sum (lane l the columns l, l + 32, ...,
``fmaf`` in turn), ``warp_sum`` ends it, and the lane that owns the row
(its column's lane) stores its solution.  A general solve copies its
matrix into the workspace and factors it there (LAPACK's pivot: the first
largest ``|a|`` below the diagonal; each lane eliminates its rows), then
substitutes one lane a right side.  The index of a maximum scans its axis
one lane an output, sequential.  A scatter-add (the backward of
a gather) starts from its base, and each output's owning lane (output
j: lane j % 32) adds the values that land on it in input order, as
torch's ``index_add``/``index_put(accumulate=True)`` on the CPU does; no
atomics.  By an index the host knows (data, or a row derived from them)
the lane walks only its outputs' values, which the host's preimage row
lists (:func:`_preimage`), and stores each sum once; by an index computed
on the card every lane walks every value.  A cumulative sum (product) runs
one lane a line, sequential.
A Cholesky factor, the LU of a log-determinant and a cyclic Jacobi
eigendecomposition run in the workspace, the warp over one matrix at a
time; a sort ranks by counting up to 32 elements and runs a bitonic
network beyond; a reducing scatter reduces each output's inputs (a row
the host builds) in input order in the output's lane, and so does a
scatter by a per-chain index, each lane walking every input (a write: the
last of a duplicate wins).  An LU factor, a QR and an SVD run a warp a
matrix in the workspace, the SVD's disjoint column pairs on groups of
lanes at once (Brent and Luk's order); matrix exponentials run several
small matrices a warp pass, each with its own degree (``gpg_qr``,
``gpg_svd``, ``gpg_mexp`` in ``csrc/generic_pg.cuh``: templates on their
sizes, inlined).  Gathers
read their index operand at run time (an index is checked on the host
to lie in ``[-n, n)`` and wrapped on the card), so the IR and its cache do
not depend on index values.  Elementwise nodes are inlined into the loops
that read them and share register temporaries there; one is materialised
only when a matrix product reads its elements more than once, when every
lane reads it (a scatter by an index computed on the card, a sort), or
when several loops read it and it costs more than a few operations.  Loops
of one iteration count with no dependence between them fuse into one.
The materialised vectors live in a per-chain workspace of ``W`` floats,
in shared memory when two blocks still fit an SM with it
(:func:`aehmc_tpu_torch.ops.launch_plan.generic_workspace_shared`), else
in a global buffer the wrapper allocates, indexed by block and warp.

Data operands (:func:`geometry_of`, ``launch_plan.generic_geometry``).
The small ones are resident: copied into shared memory at block entry and
read there (``R{j}``) for the whole launch.  One too large for that, read
by a top-level matrix product a whole row at a time (:func:`_row_access`:
a chain of views whose index along one axis walks the operand's rows), is
streamed: the product runs chunk-major (:meth:`_Emitter.chunk_loop`), the
block's threads copying each chunk of rows into one of two tile buffers
(rows padded to an odd stride) while it reads the other, a block barrier a
chunk.  A warp-each product whose outputs are the rows takes the chunk's
outputs; a loop group whose index walks the rows takes the chunk's indices
(each lane the same indices in the same order, a chunk being a multiple of
32 rows); a one-lane-an-output product summing over the rows adds the
chunk's terms to its output's workspace slot; a warp-each product summing
over the rows in its lanes takes a window of up to 32 outputs at a time,
the window's columns copied, each lane's partial sums in registers across
the chunks.  So every sum keeps its order of terms and the tiled functor
computes the untiled one's bits.  Reads of one chunk by several products
of a group share its copy.  A warp-each product ends in the butterflies of
its 8 (a window's up to 32) sums at once (``gpg_warp_sums``: each sum's
pairs those of ``warp_sum``, in a seventh of the shuffles).  A barrier
stands only at the functor's top level: a product inside a sequential node
(a factorisation's, whose loops depend on the chain's values) reads the
operand from global memory (``__ldg``) or from its resident copy.
Arithmetic is IEEE (``expf``, ``logf``, ``log1pf``, ``lgammaf``,
``erfcf``, no fast math, built with ``-fmad=false``); the matrix products
and solves use explicit ``fmaf``.
"""

import contextlib
import hashlib
import math
import operator
import weakref
from dataclasses import dataclass, field
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from aehmc_tpu_torch.ops.launch_plan import generic_geometry, odd_stride

LAYOUTS = ("t", "std")   # the potential's batch: (dim, C) or (C, dim)
MAX_DATA = 32            # data operands a functor takes (csrc/generic_pg.cuh)
SHARE_COST = 8           # ops above which a node read by two loops is stored
WARP_OUTPUTS = 8         # outputs a warp sums at once (measured: PERF.md §6)
# outputs of a warp-each product summing over a streamed operand's rows
# that its lanes carry across the chunks in registers, at most
WARP_OUTPUTS_WINDOW = 32
# a lane's outputs of the one-lane-an-output products summing over a
# streamed operand's rows that it keeps in registers across the chunks
SUM_REGISTERS = 16
# rows a factorisation's trailing update loads before it stores them (half
# as many past 64 columns, whose lanes hold more columns each)
RANK_ROWS = 8
# terms of a substitution's sequential sum whose loads a trip issues first
SUM_UNROLL = 4
# a triangular solve of several right sides: columns a lane solves at once,
# and rows of the solve at once
SOLVE_COLUMNS, SOLVE_ROWS = 2, 2
# a product of two workspace matrices: rows of outputs a lane sums at once
# (each with its columns lane, lane + 32, ...), and terms whose loads it
# issues before their fused multiply-adds
PRODUCT_ROWS, PRODUCT_TERMS = 2, 8
_ROADMAP = "ROADMAP.md item 1.10c (the generic compiler's op table)"
_Q_MASK = ("indexing by a bool mask that depends on q (x[q > 0], x[mask] = v) "
           "gives a shape that depends on the values, which neither package "
           "traces (JAX raises NonConcreteBooleanIndexError); keep the shape "
           "with torch.where(mask, x, 0) instead")

# op kinds of the IR besides the elementwise ones (_formula) and "q",
# "data", "const", "pad_slice", "pad_select", "cat"; "gather" reads its
# source at an index operand's values, "flip" reverses axes
VIEWS = ("reshape", "permute", "expand", "slice", "select", "flip", "gather",
         "take", "diagonal")
CONTRACTIONS = ("sum", "amax", "mm", "prod")
# stored nodes with a loop of their own: a triangular solve, an LU solve, a
# scatter-add, a cumulative sum, the index of a maximum, a Cholesky factor,
# a log-determinant, a symmetric eigendecomposition, a cumulative product,
# a sort's permutation, a scatter by it, a reducing scatter (always in the
# workspace, never a register)
SEQUENTIAL = ("trsolve", "lusolve", "scatter_add", "cumsum", "argmax", "chol",
              "slogdet", "eigh", "cumprod", "sortidx", "scatter_perm",
              "scatter_reduce", "logcumsumexp", "cumarg", "scatter_put",
              "lufactor", "lu_p", "qr", "svd", "mexp",
              "scatter_reduce_chain")
INT_DTYPES = (torch.int32, torch.int64)
COMPARISONS = {"eq": "==", "ne": "!=", "lt": "<", "le": "<=", "gt": ">",
               "ge": ">="}
TRANSCENDENTAL = ("exp", "expm1", "log", "log1p", "sqrt", "rsqrt", "tanh",
                  "sigmoid", "sin", "cos", "pow", "softplus",
                  "softplus_backward", "atan", "lgamma", "digamma", "erf",
                  "erfc", "erfcx", "log_ndtr", "logaddexp", "powt", "rpow",
                  "xlogy", "xlog1py", "log_sigmoid", "log_sigmoid_backward",
                  "logit", "logit_backward", "atan2", "erfinv", "i0e",
                  "i1e", "i0", "i1", "polygamma")


class Node(NamedTuple):
    op: str
    args: tuple    # ids of input nodes
    shape: tuple   # static shape, no chain axis
    dtype: str     # "f" (float32), "b" (bool) or "i" (integer data)
    params: tuple  # op parameters


@dataclass(frozen=True)
class IR:
    """The per-chain potential and gradient: ``nodes`` in topological
    order, the ids of ``u`` (shape ``()``) and ``g`` (``(dim,)``), and the
    shapes and kinds (``"f"`` float32, ``"i"`` integer) of the data
    operands (the caller's data, then the hoisted constants, then the
    derived index rows).  A derived row is an integer value that depends
    on the data alone (index arithmetic, a bool mask's positions, the
    inverse map of a writing scatter): ``host_nodes`` holds the recipes and
    ``derived`` the id of each row's root among them, evaluated on the host
    from the other operands (:func:`derived_operands`)."""

    nodes: tuple
    u: int
    g: int
    dim: int
    layout: str
    data_shapes: tuple
    num_caller_data: int
    data_kinds: tuple
    host_nodes: tuple = ()
    derived: tuple = ()

    @property
    def num_base_data(self) -> int:
        """The operands a caller passes: its data and the constants."""
        return len(self.data_shapes) - len(self.derived)

    def key(self) -> str:
        text = repr((self.nodes, self.u, self.g, self.dim, self.layout,
                     self.data_shapes, self.data_kinds, self.host_nodes,
                     self.derived))
        return hashlib.sha256(text.encode()).hexdigest()[:16]

    def index_bounds(self) -> dict:
        """Integer data operand -> the least axis length it indexes (its
        values must lie in ``[-n, n)``)."""
        bounds = {}
        for n in self.nodes:
            if n.op not in ("gather", "scatter_add"):
                continue
            src = n.args[0]
            length = self.nodes[src].shape[n.params[0]]
            index = self.nodes[_through_views(self, n.args[1])]
            if index.op != "data":  # an index computed on the card
                continue
            j = index.params[0]
            bounds[j] = min(bounds.get(j, length), length)
        return bounds


class Traced(NamedTuple):
    ir: IR
    constants: tuple  # hoisted tensors, the data operands after the caller's
    ops: tuple        # the aten ops of the trace, as traced


# ------------------------------------------------------------- tracing ----

def _per_chain(fn, dim, layout, with_grad):
    """The traced function ``f(q (dim,), *data) -> (u (), g (dim,))``."""
    col = (dim, 1) if layout == "t" else (1, dim)
    if with_grad:
        def one(q, *data):
            return fn(q.reshape(col), *data).reshape(())

        def f(q, *data):
            return one(q, *data), torch.func.grad(one)(q, *data)
    else:
        def f(q, *data):
            u, g = fn(q.reshape(col), *data)
            return u.reshape(()), g.reshape(dim)
    return f


def _check_chains_apart(fn, data, dim, layout, with_grad, device):
    """The batched potential on 3 random columns must equal the per-chain
    one on each: a potential that mixes chains raises ``ValueError``."""
    gen = torch.Generator().manual_seed(20231)
    cols = torch.randn((dim, 3), generator=gen).to(device)
    batch = cols if layout == "t" else cols.T.contiguous()

    def run(q):
        out = fn(q, *data)
        if with_grad:
            return (out.detach().reshape(-1),)
        u, g = out
        g = g if layout == "t" else g.T
        return u.detach().reshape(-1), g.detach().reshape(dim, -1)

    whole = run(batch)
    for c in range(3):
        one = run(batch[:, c:c + 1] if layout == "t" else batch[c:c + 1])
        for a, b in zip(whole, one):
            a = a[..., c:c + 1] if a.ndim == 2 else a[c:c + 1]
            if a.shape != b.shape or not torch.allclose(
                    a, b, rtol=1e-4, atol=1e-4, equal_nan=True):
                raise ValueError(
                    "the potential mixes chains: its value for one chain "
                    "alone differs from that chain's value in a batch; a "
                    "fused potential must compute each chain from its own "
                    "column (row in the standard layout)")


def _require_data(data) -> tuple:
    data = tuple(data)
    for j, d in enumerate(data):
        if not isinstance(d, torch.Tensor) or d.dtype not in (
                torch.float32, *INT_DTYPES):
            raise TypeError(
                "the generated functor takes float32 or integer (int32, "
                f"int64) data; data operand {j} is "
                f"{getattr(d, 'dtype', type(d).__name__)}")
    return data


def _kind(t: torch.Tensor) -> str:
    return "i" if t.dtype in INT_DTYPES else "f"


def check_index(t: torch.Tensor, length: int):
    """Raise ``IndexError`` unless every value of the integer tensor ``t``
    lies in ``[-length, length)``, as torch's indexing does."""
    if t.numel() == 0:
        return
    lo, hi = int(t.min()), int(t.max())
    if lo < -length or hi >= length:
        bad = lo if lo < -length else hi
        raise IndexError(f"index {bad} is out of bounds for an axis of size "
                         f"{length}")


def trace_potential(fn: Callable, data: Sequence[torch.Tensor], dim: int, *,
                    layout: str = "t", with_grad: bool = True,
                    device=None) -> Traced:
    """Trace ``fn`` per chain into the IR.

    ``layout`` "t": ``fn(q_t (dim, C), *data)``; "std": ``fn(q (C, dim),
    *data)``.  With ``with_grad`` ``fn`` is the potential (``(C,)`` or
    ``(1, C)``) and the trace holds ``torch.func.grad`` of it; without, it
    is ``potential_and_grad_t`` returning ``(u, g)``, traced as it stands.
    Closed-over tensors are hoisted into data operands after ``data``.
    Raises ``TypeError`` for data that are neither float32 nor int32/int64,
    ``ValueError`` for a potential that mixes chains and
    ``NotImplementedError`` for an op the compiler has no rule for; an
    index outside its axis raises torch's ``IndexError`` as the potential
    runs (:func:`bind` checks every launch's indices)."""
    from torch.fx.experimental.proxy_tensor import make_fx

    if layout not in LAYOUTS:
        raise ValueError(f"layout is one of {LAYOUTS}, got {layout!r}")
    data = _require_data(data)
    if device is None:
        device = data[0].device if data else torch.device("cpu")
    try:
        _check_chains_apart(fn, data, dim, layout, with_grad, device)
    except RuntimeError as err:  # vmap's refusal of a bool mask
        if "boolean mask" not in str(err):
            raise
        raise NotImplementedError(_Q_MASK) from err
    probe = torch.zeros(dim, dtype=torch.float32, device=device)
    with no_validation():
        gm = make_fx(_per_chain(fn, dim, layout, with_grad))(probe, *data)
    return _Converter(gm, dim, layout, data).run()


@contextlib.contextmanager
def no_validation():
    """``torch.distributions`` with argument validation off, the caller's
    setting restored afterwards: validation checks the values on the host,
    a branch on the data that no trace takes."""
    from torch.distributions import Distribution

    before = Distribution._validate_args
    Distribution.set_default_validate_args(False)
    try:
        yield
    finally:
        Distribution.set_default_validate_args(before)


# ---------------------------------------------------- graph to the IR ----

class _Id(int):
    """The id of an IR node among a traced op's arguments, apart from the
    Python numbers there."""


def _num(x):
    return isinstance(x, (int, float, bool)) and not isinstance(x, _Id)


def _axis(a, ndim):
    return a + ndim if a < 0 else a


class _Converter:
    """aten graph -> IR, with constant folding of fill values, common
    subexpressions merged and dead nodes dropped."""

    def __init__(self, gm, dim, layout, data):
        self.gm, self.dim, self.layout = gm, dim, layout
        self.data = list(data)
        self.data_shapes = [tuple(d.shape) for d in data]
        self.data_kinds = [_kind(d) for d in data]
        self.num_caller_data = len(data)
        self.nodes, self.index = [], {}
        self.constants, self.const_ids = [], {}
        self.ops = set()
        self.qdep = set()       # nodes that depend on q
        self.host_memo = {}     # host node -> its value on the traced data

    # -- node construction
    def make(self, op, args, shape, dtype="f", params=()):
        if op in VIEWS and self.nodes[args[0]].op == "const":
            src = self.nodes[args[0]]
            return self.const(src.params[0], shape, src.dtype)
        if op not in ("host", "derived"):  # the card reads a host value as
            args = [self.derived(a) if self.nodes[a].op == "host" else a
                    for a in args]        # a derived index row
        node = Node(op, tuple(int(a) for a in args),
                    tuple(int(s) for s in shape), dtype, tuple(params))
        if node not in self.index:
            self.index[node] = len(self.nodes)
            self.nodes.append(node)
            if op == "q" or any(a in self.qdep for a in node.args):
                self.qdep.add(self.index[node])
        return _Id(self.index[node])

    def derived(self, nid):
        n = self.nodes[nid]
        return self.make("derived", (nid,), n.shape,
                         "f" if n.dtype == "f" else "i")

    def data_only(self, ids) -> bool:
        return not any(int(i) in self.qdep for i in ids)

    def host(self, params, ids):
        """A node the host evaluates from the data (``params``: an aten op
        or a host function of :data:`_HOST_FNS`, and a template of its
        arguments); its shape and kind are those of its value on the traced
        data.  An op of several outputs gives a node for each tensor among
        them (the output's place the last of ``params``), None for the
        others."""
        if not self.data_only(ids):
            raise NotImplementedError(
                f"{params[1]} on a value that depends on q has no rule in the "
                "generic potential compiler (integer arithmetic, masks and "
                "index maps are evaluated from the data alone); widening its "
                f"op table is {_ROADMAP}")
        operands = (*self.data, *self.constants)
        probe = Node("host", tuple(int(i) for i in ids), (), "i",
                     tuple(params))
        nodes = self.nodes + [probe]
        value = _host_eval(nodes, len(nodes) - 1, operands, self.host_memo)
        self.host_memo.pop(len(nodes) - 1)
        if isinstance(value, (tuple, list)):
            return tuple(
                self.host((*params[:-1], k), ids)
                if isinstance(v, torch.Tensor) else None
                for k, v in enumerate(value))
        dtype = "b" if value.dtype == torch.bool else (
            "f" if value.is_floating_point() else "i")
        nid = self.make("host", ids, tuple(value.shape), dtype, params)
        self.host_memo[int(nid)] = value
        return nid

    def host_op(self, target, args, kwargs):
        """An aten op on values of the data alone, replayed on the host
        (integers and bools as they are, floats in float64)."""
        ids = []
        targs = _template(list(args), ids)
        tkw = tuple(sorted((k, _template(v, ids)) for k, v in kwargs.items()
                           if k not in ("device", "pin_memory", "layout")))
        return self.host(("aten", str(target), targs, tkw, None), ids)

    def const(self, value, shape=(), dtype="f"):
        value = float(value)
        if dtype == "f":  # the float32 value the card holds
            value = float(torch.tensor(value, dtype=torch.float32))
        return self.make("const", (), shape, dtype, (value,))

    def shape(self, nid):
        return self.nodes[nid].shape

    def arg(self, x):
        """An IR id for a graph value: a node's, or a scalar constant's."""
        if _num(x):
            return self.const(x, (), "b" if isinstance(x, bool) else "f")
        return x

    # -- the graph
    def run(self) -> Traced:
        env = {}
        placeholders = 0
        for fx_node in self.gm.graph.nodes:
            if fx_node.op == "placeholder":
                if placeholders == 0:
                    env[fx_node] = self.make("q", (), (self.dim,))
                else:
                    j = placeholders - 1
                    env[fx_node] = self.make("data", (), self.data_shapes[j],
                                             self.data_kinds[j], (j,))
                placeholders += 1
            elif fx_node.op == "get_attr":
                env[fx_node] = self.get_attr(getattr(self.gm, fx_node.target))
            elif fx_node.op == "call_function":
                args = torch.fx.node.map_arg(fx_node.args, lambda n: env[n])
                kwargs = torch.fx.node.map_arg(fx_node.kwargs,
                                               lambda n: env[n])
                if fx_node.target is operator.getitem:  # of an op's tuple
                    env[fx_node] = args[0][args[1]]
                    continue
                val = fx_node.meta.get("val")
                out = self.call(fx_node.target, args, kwargs, val)
                env[fx_node] = out
                name = fx_node.target.overloadpacket.__name__
                if name.endswith("_") and isinstance(fx_node.args[0],
                                                     torch.fx.Node):
                    # an in-place op: later reads of its input see the result
                    self.in_place(env, fx_node.args[0], out)
            elif fx_node.op == "output":
                u, g = fx_node.args[0]
                u = self.reshape(env[u], ())
                g = self.reshape(env[g], (self.dim,))
        return self.finish(u, g)

    def in_place(self, env, target, out):
        """``out`` written into ``target``: and, where ``target`` is a
        diagonal view (``S.diagonal().fill_(1)`` in the SVD's backward),
        into its base, which later reads see."""
        env[target] = out
        aten = torch.ops.aten
        if target.op == "call_function" and \
                target.target == aten.diagonal.default:
            base = target.args[0]
            env[base] = self.call(aten.diagonal_scatter.default,
                                  (env[base], out, *target.args[1:]), {},
                                  base.meta.get("val"))

    def get_attr(self, t):
        if not isinstance(t, torch.Tensor):
            raise NotImplementedError(f"a non-tensor constant {t!r}")
        if t.dtype == torch.bool:
            if t.numel() == 1:
                return self.const(bool(t), tuple(t.shape), "b")
            raise TypeError("the generated functor takes float32 or integer "
                            "constants; a closed-over bool tensor is neither")
        if t.dtype not in (torch.float32, *INT_DTYPES):
            raise TypeError("the generated functor takes float32 or integer "
                            f"constants; a closed-over tensor is {t.dtype}")
        if t.numel() == 1 and t.dtype == torch.float32:
            return self.const(float(t.reshape(())), tuple(t.shape))
        key = id(t)
        if key not in self.const_ids:  # integer constants stay data: their
            j = len(self.data_shapes)  # values are read at every launch
            self.data_shapes.append(tuple(t.shape))
            self.data_kinds.append(_kind(t))
            self.constants.append(t.detach().contiguous())
            self.const_ids[key] = self.make("data", (), tuple(t.shape),
                                            _kind(t), (j,))
        return self.const_ids[key]

    def finish(self, u, g) -> Traced:
        live = _closure(self.nodes, (u, g), ("derived",))
        # each derived row the card reads becomes a data operand after the
        # constants; its recipe goes to the host graph
        derived = sorted(i for i in live if self.nodes[i].op == "derived")
        host_live = sorted(_closure(self.nodes,
                                    [self.nodes[d].args[0] for d in derived]))
        host_remap = {i: k for k, i in enumerate(host_live)}
        host_nodes = tuple(
            self.nodes[i]._replace(args=tuple(host_remap[a]
                                              for a in self.nodes[i].args))
            for i in host_live)
        shapes, kinds = list(self.data_shapes), list(self.data_kinds)
        remap, nodes = {}, []
        for i, n in enumerate(self.nodes):
            if i not in live:
                continue
            if n.op == "derived":
                n = Node("data", (), n.shape, n.dtype, (len(shapes),))
                shapes.append(n.shape)
                kinds.append(n.dtype)
            remap[i] = len(nodes)
            nodes.append(n._replace(args=tuple(remap[a] for a in n.args)))
        ir = IR(tuple(nodes), remap[u], remap[g], self.dim, self.layout,
                tuple(shapes), self.num_caller_data, tuple(kinds), host_nodes,
                tuple(host_remap[self.nodes[d].args[0]] for d in derived))
        return Traced(ir, tuple(self.constants), tuple(sorted(self.ops)))

    # -- views and shapes
    def reshape(self, x, shape):
        shape = tuple(int(s) for s in shape)
        if self.shape(x) == shape:
            return x
        if math.prod(self.shape(x)) != math.prod(shape):
            raise ValueError(f"reshape of {self.shape(x)} to {shape}")
        return self.make("reshape", (x,), shape, self.nodes[x].dtype)

    def expand(self, x, shape):
        shape = tuple(int(s) for s in shape)
        if self.shape(x) == shape:
            return x
        return self.make("expand", (x,), shape, self.nodes[x].dtype)

    def elementwise(self, op, args, val, params=()):
        args = [self.arg(a) for a in args]
        args = [self.make("float", (a,), self.shape(a))
                if self.nodes[a].dtype == "i" else a for a in args]
        shape = tuple(val.shape)
        dtype = "b" if val.dtype == torch.bool else "f"
        consts = [self.nodes[a] for a in args]
        if (op in ("neg", "add", "sub", "mul", "div") and all(
                c.op == "const" and c.dtype == "f" for c in consts)):
            vals = [torch.tensor(c.params[0], dtype=torch.float32)
                    for c in consts]
            out = {"neg": lambda a: -a, "add": lambda a, b: a + b,
                   "sub": lambda a, b: a - b, "mul": lambda a, b: a * b,
                   "div": lambda a, b: a / b}[op](*vals)
            return self.const(float(out), shape)
        return self.make(op, args, shape, dtype, params)

    def call(self, target, args, kwargs, val):
        name = target.overloadpacket.__name__.rstrip("_")
        self.ops.add(str(target))
        ids = []
        _template([list(args), list(kwargs.values())], ids)
        if val is not None and isinstance(val, torch.Tensor):
            if val.dtype not in (torch.float32, torch.bool, *INT_DTYPES):
                raise TypeError(
                    f"the generated functor computes in float32; {target} "
                    f"gives {val.dtype}")
            inputs = {self.nodes[i].dtype for i in ids}
            if val.dtype in INT_DTYPES and not (
                    name in _ARG_RULES or (name in _INT_RULES
                                           and inputs <= {"i", "b"})):
                if not self.data_only(ids):
                    # arithmetic on a per-chain index: computed on the card
                    if name in _CHAIN_INT_RULES:
                        return _CHAIN_INT_RULES[name](self, args, kwargs, val)
                    raise NotImplementedError(
                        f"{target} gives integers from a value that depends "
                        "on q; the generic potential compiler takes integer "
                        "arithmetic on the data (evaluated on the host) and "
                        "add, sub, mul, floor_divide and remainder on a "
                        "per-chain index; widening its op table is "
                        f"{_ROADMAP}")
                # integer arithmetic, on data alone: the host evaluates it
                return self.host_op(target, args, kwargs)
            if val.dtype == torch.bool and name not in _RULES and \
                    self.data_only(ids):
                return self.host_op(target, args, kwargs)
        rule = _RULES.get(name)
        if (rule is None or name in _FOLD) and self.data_only(ids) and \
                _foldable(val) and not name.startswith(_NO_FOLD):
            # a value of the data alone with no rule (or a dear one): folded
            # on the host into a derived row, evaluated in float64
            return self.host_op(target, args, kwargs)
        if rule is None:
            raise NotImplementedError(
                f"the generic potential compiler has no rule for {target}; "
                f"widening its op table is {_ROADMAP}")
        return rule(self, args, kwargs, val)


def _foldable(val) -> bool:
    """Whether the host can fold a value: a float32, integer or bool tensor,
    or a tuple of them (and Nones)."""
    if isinstance(val, (tuple, list)):
        return any(isinstance(v, torch.Tensor) for v in val) and all(
            v is None or _foldable(v) for v in val)
    return isinstance(val, torch.Tensor) and val.dtype in (
        torch.float32, torch.bool, *INT_DTYPES)


def _rule_identity(c, args, kwargs, val):
    x = args[0]
    if isinstance(x, _Id) and c.nodes[x].dtype in ("b", "i") and \
            val.dtype == torch.float32:
        return c.make("float", (x,), c.shape(x))
    if isinstance(x, _Id) and c.nodes[x].dtype != "b" and \
            val.dtype == torch.bool:
        return c.elementwise("ne", (x, 0.0), val)
    if isinstance(x, _Id) and c.nodes[x].dtype != "i" and \
            val.dtype in INT_DTYPES:
        raise NotImplementedError(
            "a conversion to integers has no rule in the generic potential "
            f"compiler; widening its op table is {_ROADMAP}")
    return x


def _rule_reshape(c, args, kwargs, val):
    return c.reshape(args[0], val.shape)


def _rule_permute(c, args, kwargs, val):
    x = args[0]
    ndim = len(c.shape(x))
    if ndim < 2:
        return x
    name_dims = args[1] if len(args) > 1 else kwargs.get("dims")
    perm = tuple(_axis(d, ndim) for d in name_dims)
    if perm == tuple(range(ndim)):
        return x
    return c.make("permute", (x,), val.shape, c.nodes[x].dtype, perm)


def _rule_t(c, args, kwargs, val):
    x = args[0]
    if len(c.shape(x)) < 2:
        return x
    return c.make("permute", (x,), val.shape, c.nodes[x].dtype, (1, 0))


def _rule_transpose(c, args, kwargs, val):
    x = args[0]
    ndim = len(c.shape(x))
    a, b = _axis(args[1], ndim), _axis(args[2], ndim)
    perm = list(range(ndim))
    perm[a], perm[b] = perm[b], perm[a]
    if a == b:
        return x
    return c.make("permute", (x,), val.shape, c.nodes[x].dtype, tuple(perm))


def _rule_expand(c, args, kwargs, val):
    return c.expand(args[0], val.shape)


def _rule_slice(c, args, kwargs, val):
    x = args[0]
    shape = c.shape(x)
    axis = _axis(args[1] if len(args) > 1 else 0, len(shape))
    start = args[2] if len(args) > 2 and args[2] is not None else 0
    step = args[4] if len(args) > 4 else 1
    start = max(0, min(_axis(start, shape[axis]), shape[axis]))
    if tuple(val.shape) == shape:
        return x
    return c.make("slice", (x,), val.shape, c.nodes[x].dtype,
                  (axis, start, step))


def _rule_select(c, args, kwargs, val):
    x = args[0]
    shape = c.shape(x)
    axis = _axis(args[1], len(shape))
    return c.make("select", (x,), val.shape, c.nodes[x].dtype,
                  (axis, _axis(args[2], shape[axis])))


def _rule_fill(value_at):
    def rule(c, args, kwargs, val):
        value = value_at(args, kwargs)
        dtype = "b" if val.dtype == torch.bool else "f"
        return c.const(value, tuple(val.shape), dtype)
    return rule


def _rule_unary(op):
    def rule(c, args, kwargs, val):
        return c.elementwise(op, args[:1], val)
    return rule


def _rule_binary(op):
    def rule(c, args, kwargs, val):
        a, b = args[0], args[1]
        alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
        if alpha != 1:
            b = c.elementwise("mul", (b, alpha), val if _num(b) else
                              _Val(c.shape(b)))
        return c.elementwise(op, (a, b), val)
    return rule


class _Val(NamedTuple):
    """Stands in for a traced value's metadata."""
    shape: tuple
    dtype: torch.dtype = torch.float32


def _rule_rsub(c, args, kwargs, val):
    alpha = kwargs.get("alpha", args[2] if len(args) > 2 else 1)
    a = args[0]
    if alpha != 1:
        a = c.elementwise("mul", (a, alpha), _Val(c.shape(a)))
    return c.elementwise("sub", (args[1], a), val)


def _rule_pow(c, args, kwargs, val):
    """``x ** e`` for a number ``e``; ``b ** x`` for a number ``b``
    (``rpow``); ``x ** y`` of two tensors (``powt``), torch's ``pow`` on
    each element."""
    base, exp = args[0], args[1]
    if _num(base):
        b = float(torch.tensor(float(base), dtype=torch.float32))
        return c.elementwise("rpow", (exp,), val, (b,))
    if not _num(exp):
        return c.elementwise("powt", (base, exp), val)
    if float(exp) == 1.0:
        return base
    return c.elementwise("pow", (base,), val, (float(exp),))


def _rule_compare(op):
    def rule(c, args, kwargs, val):
        return c.elementwise(op, args[:2], val)
    return rule


def _rule_where(c, args, kwargs, val):
    return c.elementwise("where", args[:3], val)


def _rule_masked_fill(c, args, kwargs, val):
    x, mask, value = args[:3]
    return c.elementwise("where", (mask, value, x), val)


def _rule_clamp(c, args, kwargs, val):
    lo = kwargs.get("min", args[1] if len(args) > 1 else None)
    hi = kwargs.get("max", args[2] if len(args) > 2 else None)
    x = args[0]
    for bound, op in ((lo, "clamp_min"), (hi, "clamp_max")):
        if bound is None:
            continue
        if _num(bound):
            x = c.elementwise(op, (x,), val, (float(torch.tensor(
                bound, dtype=torch.float32)),))
        else:
            x = c.elementwise("maximum" if op == "clamp_min" else "minimum",
                              (x, bound), val)
    return x


def _rule_clamp_one(op):
    def rule(c, args, kwargs, val):
        bound = args[1]
        if _num(bound):
            return c.elementwise(op, args[:1], val, (float(torch.tensor(
                bound, dtype=torch.float32)),))
        return c.elementwise("maximum" if op == "clamp_min" else "minimum",
                             args[:2], val)
    return rule


def _rule_softplus(c, args, kwargs, val):
    beta = args[1] if len(args) > 1 else kwargs.get("beta", 1)
    thr = args[2] if len(args) > 2 else kwargs.get("threshold", 20)
    return c.elementwise("softplus", args[:1], val, (float(beta), float(thr)))


def _rule_softplus_backward(c, args, kwargs, val):
    return c.elementwise("softplus_backward", args[:2], val,
                         (float(args[2]), float(args[3])))


def _rule_threshold_backward(c, args, kwargs, val):
    return c.elementwise("threshold_backward", args[:2], val,
                         (float(args[2]),))


def _rule_binary_backward(op):
    def rule(c, args, kwargs, val):
        return c.elementwise(op, args[:2], val)
    return rule


def _axes(dims, ndim):
    if dims is None or (isinstance(dims, (list, tuple)) and not dims):
        return tuple(range(ndim))
    dims = dims if isinstance(dims, (list, tuple)) else (dims,)
    return tuple(sorted({_axis(d, ndim) for d in dims}))


def _reduced(shape, axes, keepdim):
    if keepdim:
        return tuple(1 if a in axes else d for a, d in enumerate(shape))
    return tuple(d for a, d in enumerate(shape) if a not in axes)


def _reduce(c, op, x, axes, keepdim):
    """Contraction ``op`` ("sum" or "amax") of ``x`` over ``axes``."""
    shape = c.shape(x)
    if c.nodes[x].dtype == "i":
        x = c.make("float", (x,), shape)
    if not shape or not axes:
        return x
    return c.make(op, (x,), _reduced(shape, axes, keepdim), "f",
                  (tuple(axes), bool(keepdim)))


def _rule_sum(mean):
    def rule(c, args, kwargs, val):
        x = args[0]
        shape = c.shape(x)
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        axes = _axes(dims, len(shape))
        out = _reduce(c, "sum", x, axes, keepdim)
        if mean and shape:
            n = math.prod(shape[a] for a in axes)
            out = c.elementwise("div", (out, float(n)), _Val(c.shape(out)))
        return out
    return rule


def _rule_amax(c, args, kwargs, val):
    x = args[0]
    dims = args[1] if len(args) > 1 else kwargs.get("dim", ())
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    return _reduce(c, "amax", x, _axes(dims, len(c.shape(x))), keepdim)


def _rule_var(c, args, kwargs, val):
    """``var`` as torch defines it: the mean of the squared deviations from
    the mean, over ``n - correction``."""
    x = args[0]
    shape = c.shape(x)
    dims = args[1] if len(args) > 1 else kwargs.get("dim")
    correction = kwargs.get("correction", 1)
    correction = 1 if correction is None else correction
    keepdim = kwargs.get("keepdim", False)
    axes = _axes(dims, len(shape))
    n = math.prod(shape[a] for a in axes)
    mean = c.elementwise("div", (_reduce(c, "sum", x, axes, True), float(n)),
                         _Val(_reduced(shape, axes, True)))
    dev = c.elementwise("sub", (x, mean), _Val(shape))
    sq = c.elementwise("mul", (dev, dev), _Val(shape))
    ss = _reduce(c, "sum", sq, axes, keepdim)
    return c.elementwise("div", (ss, float(max(n - correction, 0))),
                         _Val(c.shape(ss)))


def _mm(c, a, b):
    (m, k), (k2, n) = c.shape(a), c.shape(b)
    if k != k2:
        raise ValueError(f"mm of {c.shape(a)} and {c.shape(b)}")
    return c.make("mm", (a, b), (m, n))


def _rule_mm(c, args, kwargs, val):
    return _mm(c, args[0], args[1])


def _rule_mv(c, args, kwargs, val):
    a, v = args[0], args[1]
    out = _mm(c, a, c.reshape(v, (c.shape(v)[0], 1)))
    return c.reshape(out, val.shape)


def _rule_dot(c, args, kwargs, val):
    a, b = args[0], args[1]
    k = c.shape(a)[0]
    out = _mm(c, c.reshape(a, (1, k)), c.reshape(b, (k, 1)))
    return c.reshape(out, ())


def _rule_bmm(c, args, kwargs, val):
    """A product a batch: one matrix product each, concatenated."""
    return c.reshape(_bmm(c, args[0], args[1]), val.shape)


def _rule_addmm(c, args, kwargs, val):
    bias, a, b = args[:3]
    beta, alpha = kwargs.get("beta", 1), kwargs.get("alpha", 1)
    prod = _mm(c, a, b)
    if alpha != 1:
        prod = c.elementwise("mul", (prod, alpha), val)
    if beta != 1:
        bias = c.elementwise("mul", (bias, beta), _Val(c.shape(bias)))
    return c.elementwise("add", (bias, prod), val)


def _rule_cat(c, args, kwargs, val):
    pieces = [p for p in args[0] if math.prod(c.shape(p)) > 0]
    axis = _axis(args[1] if len(args) > 1 else kwargs.get("dim", 0),
                 len(val.shape))
    if len(pieces) == 1:
        return pieces[0]
    return c.make("cat", pieces, val.shape, "f", (axis,))


def _rule_slice_backward(c, args, kwargs, val):
    grad, sizes, dim, start, end, step = args[:6]
    axis = _axis(dim, len(sizes))
    start = max(0, min(_axis(start, sizes[axis]), sizes[axis]))
    if tuple(c.shape(grad)) == tuple(sizes):
        return grad
    return c.make("pad_slice", (grad,), sizes, "f", (axis, start, step))


def _rule_select_backward(c, args, kwargs, val):
    grad, sizes, dim, index = args[:4]
    axis = _axis(dim, len(sizes))
    return c.make("pad_select", (grad,), sizes, "f",
                  (axis, _axis(index, sizes[axis])))


def _rule_square(c, args, kwargs, val):
    return c.elementwise("pow", args[:1], val, (2.0,))


# -- gathers and scatters by an integer index operand

def _one_index(c, indices):
    """``(axis, index)`` when ``indices`` (``None`` for the axes taken
    whole) hold one integer index tensor that the card reads as it stands:
    a view of a data operand, or a value computed on the card (max.dim's
    index); else None (the host maps the indices to flat positions)."""
    tensors = [(k, i) for k, i in enumerate(indices) if i is not None]
    if len(tensors) != 1:
        return None
    axis, idx = tensors[0]
    if c.nodes[idx].dtype != "i":
        return None
    if not c.data_only([idx]) or c.nodes[_through_views(c, idx)].op == "data":
        return axis, idx
    return None


def _positions(c, shape, indices):
    """The flat positions in an array of ``shape`` that ``x[indices]``
    reads (several index tensors, bool masks, or integer index arithmetic,
    on data alone), a derived index row: torch's own indexing of an
    ``arange`` on the host, which checks every index against its axis."""
    ids = []
    template = _template(list(indices), ids)
    if _q_mask(c, indices):
        raise NotImplementedError(_Q_MASK)
    if not c.data_only(ids):
        raise NotImplementedError(
            "a writing scatter by several index tensors that depend on q "
            "has no rule in the generic potential compiler; widening its op "
            f"table is {_ROADMAP}")
    return c.host(("fn", "index_positions", tuple(shape), template), ids)


def _q_mask(c, indices) -> bool:
    return any(i is not None and c.nodes[i].dtype == "b"
               and not c.data_only([i]) for i in indices)


def _gather(c, x, axis, idx):
    """``x`` read at ``idx`` along ``axis``: an index of data checked on
    the host and wrapped; a per-chain index (computed on the card) wrapped
    if negative and clamped into the axis, as JAX's gather does."""
    shape = c.shape(x)
    out = shape[:axis] + c.shape(idx) + shape[axis + 1:]
    params = (axis,) if c.data_only([idx]) else (axis, "clamp")
    return c.make("gather", (x, idx), out, c.nodes[x].dtype, params)


def _flat_gather(c, x, pos, shape):
    """``x`` read at the flat positions ``pos``, reshaped to ``shape``."""
    flat = c.reshape(x, (math.prod(c.shape(x)),))
    return c.reshape(_gather(c, flat, 0, pos), shape)


def _scatter_add(c, base, axis, idx, values):
    """``base`` plus ``values`` added at ``idx`` along ``axis`` in input
    order (torch's ``index_add``, ``index_put(accumulate=True)``).  By an
    index the host knows (data, or a row derived from them), the node
    carries a fourth argument, the preimage row of the flat positions the
    values land on (:func:`_preimage`); the index stays its second, which
    the plain version and the bind's check read."""
    shape = c.shape(base)
    expected = shape[:axis] + c.shape(idx) + shape[axis + 1:]
    values = c.expand(values, expected)
    if c.nodes[values].dtype != "f":
        values = c.make("float", (values,), expected)
    args = (base, idx, values)
    if c.data_only([idx]):
        pos = c.host(("fn", "scatter_positions", shape, axis), [idx])
        args += (c.host(("fn", "preimage", math.prod(shape)), [pos]),)
    return c.make("scatter_add", args, shape, "f", (axis,))


def _flat_scatter(c, base, pos, values, accumulate):
    """``base`` with ``values`` added (``accumulate``) or written at the
    flat positions ``pos``.  A writing scatter reads through the inverse
    map of ``pos`` (position -> the value written there, or -1), which the
    host builds and which refuses a duplicate position (torch and JAX leave
    the winner of a duplicate unspecified) unless every value written is
    one constant."""
    shape = c.shape(base)
    flat = c.reshape(base, (math.prod(shape),))
    if accumulate:
        return c.reshape(_scatter_add(c, flat, 0, pos, values), shape)
    uniform = c.nodes[_through_views(c, c.arg(values))].op == "const"
    inv = c.host(("fn", "inverse", math.prod(shape), uniform), [pos])
    values = c.expand(values, c.shape(pos))
    if c.nodes[values].dtype != "f":
        values = c.make("float", (values,), c.shape(pos))
    return c.reshape(c.make("put", (flat, inv, values), c.shape(flat)),
                     shape)


def _rule_index(c, args, kwargs, val):
    x, indices = args[0], list(args[1])
    one = _one_index(c, indices)
    if one is not None:
        return _gather(c, x, *one)
    if _chain_indices(c, indices):
        pos, flat = _chain_positions(c, x, indices)
        return c.reshape(_gather(c, flat, 0, pos), val.shape)
    return _flat_gather(c, x, _positions(c, c.shape(x), indices), val.shape)


def _rule_index_select(c, args, kwargs, val):
    x, dim, idx = args[:3]
    axis = _axis(dim, len(c.shape(x)))
    if not c.shape(idx):
        idx = c.reshape(idx, (1,))
    return _gather(c, x, axis, idx)


def _rule_index_put(c, args, kwargs, val):
    base, indices, values = args[:3]
    accumulate = kwargs.get("accumulate", args[3] if len(args) > 3 else False)
    values = c.arg(values)
    one = _one_index(c, list(indices))
    if accumulate and one is not None:
        return _scatter_add(c, base, *one, values)
    if accumulate and _chain_indices(c, indices):
        # several index tensors, a per-chain one among them (the backward
        # of a gather by them): added at per-chain flat positions
        pos, flat = _chain_positions(c, base, list(indices))
        values = c.expand(values, (*c.shape(pos), *c.shape(flat)[1:]))
        return c.reshape(_scatter_add(c, flat, 0, pos, values),
                         c.shape(base))
    masked = _masked_write(c, base, list(indices), values, accumulate)
    if masked is not None:
        return masked
    pos = _positions(c, c.shape(base), list(indices))
    return _flat_scatter(c, base, pos, values, accumulate)


def _masked_write(c, base, indices, values, accumulate):
    """``x[mask] = v`` with one bool mask over x's leading axes that
    depends on q and a value that broadcasts to an element's trailing
    shape: the shape kept, ``where(mask, v, x)``; None for any other
    write."""
    shape = c.shape(base)
    if accumulate or len(indices) != 1 or indices[0] is None:
        return None
    mask = indices[0]
    if c.nodes[mask].dtype != "b" or c.data_only([mask]):
        return None
    k = len(c.shape(mask))
    rest = shape[k:]
    vshape = c.shape(values)
    if c.shape(mask) != shape[:k] or len(vshape) > len(rest) or any(
            v not in (1, r) for v, r in zip(vshape[::-1], rest[::-1])):
        return None
    mask = c.expand(c.reshape(mask, (*shape[:k], *(1,) * len(rest))), shape)
    return c.elementwise("where", (mask, values, base), _Val(shape))


def _leading(c, x, shape):
    """The leading block of ``x`` of ``shape`` (a number expanded to it)."""
    x = c.arg(x)
    if not c.shape(x):
        return c.expand(x, shape)
    for axis, (have, want) in enumerate(zip(c.shape(x), shape)):
        if have != want:
            out = c.shape(x)[:axis] + (want,) + c.shape(x)[axis + 1:]
            x = c.make("slice", (x,), out, c.nodes[x].dtype, (axis, 0, 1))
    return x


def _rule_gather(c, args, kwargs, val):
    """``torch.gather(x, dim, index)``: by an index of data, at flat
    positions; by a per-chain index, a ``take`` along the axis (the
    backward of a scatter by it)."""
    x, dim, index = args[:3]
    axis = _axis(dim, len(c.shape(x)))
    if not c.data_only([index]):
        return c.make("take", (x, index), c.shape(index), c.nodes[x].dtype,
                      (axis,))
    pos = c.host(("fn", "axis_positions", c.shape(x), axis), [index])
    return _flat_gather(c, x, pos, val.shape)


def _rule_scatter(accumulate):
    """``torch.scatter``/``scatter_add(base, dim, index, src)``: by an
    index of data, through flat positions; by a per-chain index of one
    entry along the axis (max.dim's, in its backward), a ``pick``; by a
    sort's (top-k's) indices, a ``scatter_perm``; by any other per-chain
    index, at per-chain flat positions: a scatter-add in input order
    (cummax's backward), or a write in input order, the last of a
    duplicate winning (``scatter_put``)."""
    def rule(c, args, kwargs, val):
        base, dim, index, src = args[:4]
        shape = c.shape(base)
        axis = _axis(dim, len(shape))
        ishape = c.shape(index)
        src = _leading(c, src, ishape)
        if c.data_only([index]):
            pos = c.host(("fn", "axis_positions", shape, axis), [index])
            return _flat_scatter(c, base, pos, src, accumulate)
        rest = ishape[:axis] + ishape[axis + 1:]
        perm = c.nodes[_through_views(c, index)]
        if not accumulate and perm.op == "sortidx" and \
                perm.params[0] == axis and c.shape(index) == perm.shape and \
                rest == shape[:axis] + shape[axis + 1:]:
            # by a sort's (top-k's) indices: distinct along the axis
            if c.nodes[src].dtype != "f":
                src = c.make("float", (src,), c.shape(src))
            return c.make("scatter_perm", (base, index, src), shape, "f",
                          (axis,))
        if not accumulate and ishape[axis] == 1 and \
                rest == shape[:axis] + shape[axis + 1:]:
            return c.make("pick", (base, index, src), shape, "f", (axis,))
        pos = _chain_flat_positions(c, shape, index, axis)
        numel = math.prod(shape)
        flat = c.reshape(base, (numel,))
        if c.nodes[src].dtype != "f":
            src = c.make("float", (src,), c.shape(src))
        if accumulate:
            out = _scatter_add(c, flat, 0, pos, src)
        else:
            out = c.make("scatter_put", (flat, pos, src), (numel,), "f", (0,))
        return c.reshape(out, shape)
    return rule


def _chain_flat_positions(c, shape, index, axis):
    """The flat positions in an array of ``shape`` that a scatter along
    ``axis`` by the per-chain ``index`` writes: the index (wrapped,
    clamped) times the axis's stride plus the other coordinates' offsets,
    a row of the host's."""
    ishape = c.shape(index)
    k = c.make("iclamp", (index,), ishape, "i", (shape[axis],))
    stride = _strides(shape)[axis]
    if stride != 1:
        k = c.make("mul", (k, c.const(stride, (), "i")), ishape, "i")
    offsets = c.host(("fn", "axis_offsets", shape, ishape, axis), [])
    return c.make("add", (k, offsets), ishape, "i")


def _rule_index_add(c, args, kwargs, val):
    base, dim, idx, source = args[:4]
    alpha = kwargs.get("alpha", args[4] if len(args) > 4 else 1)
    axis = _axis(dim, len(c.shape(base)))
    if not c.shape(idx):
        idx = c.reshape(idx, (1,))
    if alpha != 1:
        source = c.elementwise("mul", (source, alpha), _Val(c.shape(source)))
    return _scatter_add(c, base, axis, idx, source)


def _rule_flip(c, args, kwargs, val):
    x = args[0]
    dims = args[1] if len(args) > 1 else kwargs.get("dims")
    axes = tuple(a for a in _axes(dims, len(c.shape(x)))
                 if c.shape(x)[a] > 1)
    if not axes:
        return x
    return c.make("flip", (x,), c.shape(x), c.nodes[x].dtype, axes)


def _rule_cumsum(c, args, kwargs, val):
    x = args[0]
    axis = _axis(args[1] if len(args) > 1 else kwargs.get("dim"),
                 max(len(c.shape(x)), 1))
    if c.nodes[x].dtype != "f":
        x = c.make("float", (x,), c.shape(x))
    if not c.shape(x):
        return x
    return c.make("cumsum", (x,), c.shape(x), "f", (axis,))


# -- triangular solves

def _swap_last(c, x):
    nd = len(c.shape(x))
    perm = list(range(nd))
    perm[-1], perm[-2] = perm[-2], perm[-1]
    shape = tuple(c.shape(x)[p] for p in perm)
    return c.make("permute", (x,), shape, c.nodes[x].dtype, tuple(perm))


def _solve(c, op, A, B, out_shape, params=()):
    """``X`` of ``A X = B``, ``A`` ``(*, n, n)``, ``B`` ``(*, n, k)``, by a
    triangular (``trsolve``) or LU (``lusolve``) solve: a batch of factors
    of 1 is read for every right side, any other broadcasts against the
    right sides' batch (an expanded view, nothing copied)."""
    sa = c.shape(A)
    n, k = out_shape[-2], out_shape[-1]
    batch = math.prod(out_shape[:-2])
    if len(sa) < 2 or sa[-1] != n or sa[-2] != n:
        raise ValueError(f"a solve of {sa} and {c.shape(B)}")
    if math.prod(sa[:-2]) == 1:
        A3 = c.reshape(A, (1, n, n))
    else:
        A3 = c.reshape(c.expand(A, (*out_shape[:-2], n, n)), (batch, n, n))
    B3 = c.reshape(c.expand(B, out_shape), (batch, n, k))
    if c.nodes[B3].dtype != "f":
        B3 = c.make("float", (B3,), (batch, n, k))
    X = c.make(op, (A3, B3), (batch, n, k), "f", params)
    return c.reshape(X, out_shape)


def _trsolve(c, A, B, upper, unit, out_shape):
    """``X`` of ``A X = B``, ``A`` triangular."""
    return _solve(c, "trsolve", A, B, out_shape, (bool(upper), bool(unit)))


def _rule_solve_triangular(c, args, kwargs, val):
    A, B = args[:2]
    upper = kwargs.get("upper", args[2] if len(args) > 2 else None)
    left = kwargs.get("left", args[3] if len(args) > 3 else True)
    unit = kwargs.get("unitriangular", args[4] if len(args) > 4 else False)
    if left:
        return _trsolve(c, A, B, upper, unit, tuple(val.shape))
    # X A = B is A^T X^T = B^T
    shape = tuple(val.shape)
    t_shape = (*shape[:-2], shape[-1], shape[-2])
    X = _trsolve(c, _swap_last(c, A), _swap_last(c, B), not upper, unit,
                 t_shape)
    return _swap_last(c, X)


def _rule_cholesky_solve(c, args, kwargs, val):
    """``cholesky_solve(B, L)``: ``L L^T X = B`` (``U^T U X = B`` when
    ``upper``) as two triangular solves."""
    B, L = args[:2]
    upper = kwargs.get("upper", args[2] if len(args) > 2 else False)
    shape = tuple(val.shape)
    Lt = _swap_last(c, L)
    first, second = (Lt, L) if upper else (L, Lt)
    Y = _trsolve(c, first, B, False, False, shape)
    return _trsolve(c, second, Y, True, False, shape)


def _rule_linalg_solve(c, args, kwargs, val):
    """``torch.linalg.solve(A, B, left)`` (``_linalg_solve_ex``): an LU
    solve with partial pivoting a chain; ``B`` a batch of vectors when it
    has one axis fewer than ``A``.  Its backward solves with ``A``'s
    transpose, another ``_linalg_solve_ex``.  Gives ``(X, None, None,
    None)``: the factors, pivots and info are not kept."""
    A, B = args[:2]
    left = kwargs.get("left", args[2] if len(args) > 2 else True)
    out = tuple(val[0].shape)
    vector = len(c.shape(B)) == len(c.shape(A)) - 1
    if vector:
        B = c.reshape(B, (*c.shape(B), 1))
        out = (*out, 1)
    if left:
        X = _solve(c, "lusolve", A, B, out)
    else:  # X A = B is A^T X^T = B^T
        t_out = (*out[:-2], out[-1], out[-2])
        X = _swap_last(c, _solve(c, "lusolve", _swap_last(c, A),
                                 _swap_last(c, B), t_out))
    return c.reshape(X, val[0].shape), None, None, None


def _rule_check_errors(c, args, kwargs, val):
    return None


# -- maxima and minima with their indices

def _neg(c, x):
    return c.elementwise("neg", (x,), _Val(c.shape(x)))


def _extreme(c, x, axes, keepdim, sign):
    """The maximum (``sign`` 1) or minimum (-1, ``-amax(-x)``, exact) of
    ``x`` over ``axes``."""
    if sign > 0:
        return _reduce(c, "amax", x, axes, keepdim)
    return _neg(c, _reduce(c, "amax", _neg(c, x), axes, keepdim))


def _argmax(c, x, axis, keepdim, sign):
    """The index of the first maximum (minimum) along ``axis``, a NaN
    counting as the largest, as torch's ``max.dim`` gives it: a per-chain
    integer node computed on the card."""
    if not c.shape(x):  # the one element's index
        return c.const(0, (), "i")
    if c.nodes[x].dtype != "f":
        x = c.make("float", (x,), c.shape(x))
    if sign < 0:
        x = _neg(c, x)
    shape = _reduced(c.shape(x), (axis,), keepdim)
    return c.make("argmax", (x,), shape, "i", (axis, bool(keepdim)))


def _rule_max(sign):
    def rule(c, args, kwargs, val):
        x = args[0]
        other = args[1] if len(args) > 1 else kwargs.get("dim")
        if isinstance(other, _Id):  # max.other: elementwise
            return c.elementwise("maximum" if sign > 0 else "minimum",
                                 (x, other), val)
        if other is None:  # max.default: over every element
            return _extreme(c, x, tuple(range(len(c.shape(x)))), False, sign)
        keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        axis = _axis(other, max(len(c.shape(x)), 1))
        return (_extreme(c, x, (axis,), keepdim, sign),
                _argmax(c, x, axis, keepdim, sign))
    return rule


def _rule_argmax(sign):
    def rule(c, args, kwargs, val):
        x = args[0]
        dim = args[1] if len(args) > 1 else kwargs.get("dim")
        keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        if dim is None:  # over the flattened value
            flat = c.reshape(x, (math.prod(c.shape(x)),))
            return c.reshape(_argmax(c, flat, 0, False, sign), val.shape)
        return _argmax(c, x, _axis(dim, len(c.shape(x))), keepdim, sign)
    return rule


def _rule_amin(c, args, kwargs, val):
    x = args[0]
    dims = args[1] if len(args) > 1 else kwargs.get("dim", ())
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    return _extreme(c, x, _axes(dims, len(c.shape(x))), keepdim, -1)


# -- reductions along an axis, as torch computes them

def _rule_logsumexp(c, args, kwargs, val):
    """``m = amax``, ``m = 0`` where ``|m|`` is infinite, ``log(sum(exp(x
    - m))) + m`` (ATen's ``logsumexp``)."""
    x = args[0]
    shape = c.shape(x)
    dims = args[1] if len(args) > 1 else kwargs.get("dim")
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    axes = _axes(dims, len(shape))
    if not shape:
        return x
    kept = _reduced(shape, axes, True)
    m = _reduce(c, "amax", x, axes, True)
    inf = c.elementwise("eq", (c.elementwise("abs", (m,), _Val(kept)),
                               math.inf), _Val(kept, torch.bool))
    m = c.elementwise("where", (inf, 0.0, m), _Val(kept))
    e = c.elementwise("exp", (c.elementwise("sub", (x, m), _Val(shape)),),
                      _Val(shape))
    s = _reduce(c, "sum", e, axes, keepdim)
    out = tuple(val.shape)
    return c.elementwise("add", (c.elementwise("log", (s,), _Val(out)),
                                 c.reshape(m, out)), _Val(out))


def _shifted(c, x, axis):
    """``x - max`` along ``axis`` and the sum of its exponentials."""
    shape = c.shape(x)
    kept = _reduced(shape, (axis,), True)
    t = c.elementwise("sub", (x, _reduce(c, "amax", x, (axis,), True)),
                      _Val(shape))
    e = c.elementwise("exp", (t,), _Val(shape))
    return t, e, _reduce(c, "sum", e, (axis,), True), kept


def _rule_log_softmax(c, args, kwargs, val):
    x = args[0]
    if not c.shape(x):
        return c.const(0.0, ())
    t, _, s, kept = _shifted(c, x, _axis(args[1], len(c.shape(x))))
    return c.elementwise("sub", (t, c.elementwise("log", (s,), _Val(kept))),
                         val)


def _rule_softmax(c, args, kwargs, val):
    x = args[0]
    if not c.shape(x):
        return c.const(1.0, ())
    _, e, s, _ = _shifted(c, x, _axis(args[1], len(c.shape(x))))
    return c.elementwise("div", (e, s), val)


def _rule_log_softmax_backward(c, args, kwargs, val):
    """``grad - exp(out) * sum(grad)`` along the axis."""
    grad, out, dim = args[:3]
    shape = c.shape(grad)
    if not shape:
        return c.const(0.0, ())
    axis = _axis(dim, len(shape))
    s = _reduce(c, "sum", grad, (axis,), True)
    e = c.elementwise("exp", (out,), _Val(shape))
    return c.elementwise("sub", (grad, c.elementwise("mul", (e, s),
                                                     _Val(shape))), val)


def _rule_softmax_backward(c, args, kwargs, val):
    """``out * (grad - sum(grad * out))`` along the axis."""
    grad, out, dim = args[:3]
    shape = c.shape(grad)
    if not shape:
        return c.const(0.0, ())
    axis = _axis(dim, len(shape))
    s = _reduce(c, "sum", c.elementwise("mul", (grad, out), _Val(shape)),
                (axis,), True)
    return c.elementwise("mul", (out, c.elementwise("sub", (grad, s),
                                                    _Val(shape))), val)


def _rule_stack(c, args, kwargs, val):
    pieces = list(args[0])
    axis = _axis(args[1] if len(args) > 1 else kwargs.get("dim", 0),
                 len(val.shape))
    shape = tuple(val.shape)
    one = shape[:axis] + (1,) + shape[axis + 1:]
    pieces = [c.reshape(p, one) for p in pieces]
    if len(pieces) == 1:
        return pieces[0]
    return c.make("cat", pieces, shape, "f", (axis,))


# -- structural ops: diagonals, triangles, the identity, constant padding

def _band(c, shape, d1, d2, lo, hi, dtype="b"):
    """The mask of ``lo <= i[d2] - i[d1] <= hi`` over ``shape`` (a bound of
    None: none), computed from the element's index."""
    return c.make("band", (), shape, dtype, (d1, d2, lo, hi))


def _rule_eye(c, args, kwargs, val):
    shape = tuple(val.shape)
    return _band(c, shape, 0, 1, 0, 0,
                 "b" if val.dtype == torch.bool else "f")


def _rule_tri(upper):
    def rule(c, args, kwargs, val):
        x = args[0]
        k = args[1] if len(args) > 1 else kwargs.get("diagonal", 0)
        shape = c.shape(x)[-2:]
        mask = _band(c, shape, 0, 1, k if upper else None,
                     None if upper else k)
        return c.elementwise("where", (mask, x, 0.0), val)
    return rule


def _diag_dims(args, kwargs, start, ndim, defaults):
    offset = args[start] if len(args) > start else kwargs.get("offset", 0)
    d1 = args[start + 1] if len(args) > start + 1 else kwargs.get(
        "dim1", defaults[0])
    d2 = args[start + 2] if len(args) > start + 2 else kwargs.get(
        "dim2", defaults[1])
    return int(offset), _axis(d1, ndim), _axis(d2, ndim)


def _rule_diagonal(c, args, kwargs, val):
    """``x.diagonal(offset, dim1, dim2)``: a view, the diagonal last."""
    x = args[0]
    params = _diag_dims(args, kwargs, 1, len(c.shape(x)), (0, 1))
    return c.make("diagonal", (x,), val.shape, c.nodes[x].dtype, params)


def _diag_pad(c, x, shape, params):
    """Zeros of ``shape`` with the diagonal ``params`` (offset, dim1, dim2)
    taken from the last axis of ``x``."""
    if c.nodes[x].dtype != "f":
        x = c.make("float", (x,), c.shape(x))
    return c.make("diag_pad", (x,), shape, "f", params)


def _rule_diag_embed(c, args, kwargs, val):
    x = args[0]
    shape = tuple(val.shape)
    return _diag_pad(c, x, shape, _diag_dims(args, kwargs, 1, len(shape),
                                             (-2, -1)))


def _rule_diagonal_backward(c, args, kwargs, val):
    grad, sizes = args[0], tuple(args[1])
    return _diag_pad(c, grad, sizes, _diag_dims(args, kwargs, 2, len(sizes),
                                                (0, 1)))


def _rule_diagonal_scatter(c, args, kwargs, val):
    """``x`` with its diagonal replaced by ``src``."""
    x, src = args[0], args[1]
    shape = c.shape(x)
    offset, d1, d2 = _diag_dims(args, kwargs, 2, len(shape), (0, 1))
    on = _band(c, shape, d1, d2, offset, offset)
    return c.elementwise("where", (on, _diag_pad(c, src, shape,
                                                 (offset, d1, d2)), x), val)


def _rule_constant_pad_nd(c, args, kwargs, val):
    """``F.pad(x, pad, value=v)``: each axis from the last cropped (a
    negative width, a slice) and padded (a concatenation with constants)."""
    x, pad = args[0], list(args[1])
    value = args[2] if len(args) > 2 else kwargs.get("value", 0.0)
    value = 0.0 if value is None else float(value)
    ndim = len(c.shape(x))
    for p in range(len(pad) // 2):
        axis = ndim - 1 - p
        before, after = int(pad[2 * p]), int(pad[2 * p + 1])
        shape = c.shape(x)
        start, stop = max(-before, 0), shape[axis] - max(-after, 0)
        if (start, stop) != (0, shape[axis]):
            x = c.make("slice", (x,), (*shape[:axis], stop - start,
                                       *shape[axis + 1:]),
                       c.nodes[x].dtype, (axis, start, 1))
        pieces = [x]
        for width, at in ((before, 0), (after, 2)):
            if width > 0:
                pieces.insert(at if at == 0 else len(pieces), c.const(
                    value, (*c.shape(x)[:axis], width,
                            *c.shape(x)[axis + 1:])))
        if len(pieces) > 1:
            out = list(c.shape(x))
            out[axis] = sum(c.shape(q)[axis] for q in pieces)
            x = c.make("cat", pieces, tuple(out), "f", (axis,))
    return x


# -- factorisations: Cholesky, log-determinants, symmetric eigenproblems

def _batched(c, A, n):
    """``A`` ``(*, n, n)`` as ``(batch, n, n)`` and its batch shape."""
    lead = c.shape(A)[:-2]
    return c.reshape(A, (math.prod(lead), n, n)), lead


def _rule_cholesky(c, args, kwargs, val):
    """``linalg_cholesky_ex(A, upper)``: the factor a chain (NaN over the
    whole factor where ``A`` is not positive definite, as JAX's cholesky
    gives it); ``info`` is 0 (``_linalg_check_errors`` ignores it, so the
    kernel never raises, and the binding's NaN where ``info != 0`` is the
    factor itself)."""
    A = args[0]
    upper = kwargs.get("upper", args[1] if len(args) > 1 else False)
    n = c.shape(A)[-1]
    A3, lead = _batched(c, A, n)
    if upper:  # U of A = U^T U is L^T of the lower triangle of A^T
        A3 = _swap_last(c, A3)
    L = c.make("chol", (A3,), c.shape(A3), "f")
    if upper:
        L = _swap_last(c, L)
    return c.reshape(L, (*lead, n, n)), c.const(0, lead, "i")


def _rule_slogdet(c, args, kwargs, val):
    """``_linalg_slogdet(A)``: ``(sign, log|det A|)`` from an LU with
    partial pivoting a chain (lusolve's); the factors and pivots are not
    kept (the traced backward solves with A itself)."""
    A = args[0]
    n = c.shape(A)[-1]
    A3, lead = _batched(c, A, n)
    batch = c.shape(A3)[0]
    S = c.make("slogdet", (A3,), (batch, 2), "f")
    sign, logabs = (c.reshape(c.make("select", (S,), (batch,), "f", (1, k)),
                              lead) for k in (0, 1))
    return sign, logabs, None, None


def _rule_eigh(c, args, kwargs, val):
    """``_linalg_eigh(A, UPLO)``: eigenvalues ascending and unit
    eigenvectors, each with its largest component (the first of equals)
    positive, by cyclic Jacobi a chain."""
    A = args[0]
    uplo = kwargs.get("UPLO", args[1] if len(args) > 1 else "L")
    n = c.shape(A)[-1]
    A3, lead = _batched(c, A, n)
    if uplo == "U":
        A3 = _swap_last(c, A3)
    batch = c.shape(A3)[0]
    E = c.make("eigh", (A3,), (batch, n + 1, n), "f")
    w = c.reshape(c.make("select", (E,), (batch, n), "f", (1, 0)),
                  (*lead, n))
    V = c.reshape(c.make("slice", (E,), (batch, n, n), "f", (1, 1, 1)),
                  (*lead, n, n))
    return w, V


# -- scans and products

def _rule_cumprod(c, args, kwargs, val):
    x = args[0]
    axis = _axis(args[1] if len(args) > 1 else kwargs.get("dim"),
                 max(len(c.shape(x)), 1))
    if c.nodes[x].dtype != "f":
        x = c.make("float", (x,), c.shape(x))
    if not c.shape(x):
        return x
    return c.make("cumprod", (x,), c.shape(x), "f", (axis,))


def _rule_prod(c, args, kwargs, val):
    x = args[0]
    dims = args[1] if len(args) > 1 else kwargs.get("dim")
    keepdim = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
    return _reduce(c, "prod", x, _axes(dims, len(c.shape(x))), keepdim)


# -- sorts: a per-chain permutation and the values it reads

def _sorted(c, x, axis, descending, k):
    """``(values, indices)`` of the first ``k`` of ``x`` along ``axis`` in
    ascending (``descending``) order, ties in index order (torch's stable
    sort), a NaN the largest."""
    if not c.shape(x):
        return x, c.const(0, (), "i")
    if c.nodes[x].dtype != "f":
        x = c.make("float", (x,), c.shape(x))
    out = list(c.shape(x))
    out[axis] = k
    idx = c.make("sortidx", (x,), tuple(out), "i",
                 (axis, bool(descending), int(k)))
    return c.make("take", (x, idx), tuple(out), "f", (axis,)), idx


def _rule_sort(c, args, kwargs, val):
    x = args[0]
    dim = args[1] if len(args) > 1 else kwargs.get("dim", -1)
    desc = args[2] if len(args) > 2 else kwargs.get("descending", False)
    axis = _axis(dim, max(len(c.shape(x)), 1))
    n = c.shape(x)[axis] if c.shape(x) else 1
    return _sorted(c, x, axis, desc, n)


def _rule_topk(c, args, kwargs, val):
    x, k = args[0], int(args[1])
    dim = args[2] if len(args) > 2 else kwargs.get("dim", -1)
    largest = args[3] if len(args) > 3 else kwargs.get("largest", True)
    return _sorted(c, x, _axis(dim, max(len(c.shape(x)), 1)), largest, k)


def _rule_scatter_reduce(c, args, kwargs, val):
    """``scatter_reduce(base, dim, index, src, reduce, include_self)``: by
    an index of data, the host maps each output to the inputs that land on
    it, in input order (the preimage row), and each output's lane reduces
    them in that order; by a per-chain index, at per-chain flat positions
    (``scatter_reduce_chain``)."""
    base, dim, index, src, reduce = args[:5]
    include_self = kwargs.get("include_self",
                              args[5] if len(args) > 5 else True)
    shape = c.shape(base)
    if reduce not in ("sum", "prod", "mean", "amax", "amin"):
        raise NotImplementedError(f"scatter_reduce's reduce={reduce!r}")
    axis = _axis(dim, len(shape))
    src = _leading(c, src, c.shape(index))
    if c.nodes[src].dtype != "f":
        src = c.make("float", (src,), c.shape(src))
    numel = math.prod(shape)
    if not c.data_only([index]):
        # by a per-chain index: each output's lane reduces the values that
        # land on it, walking them in input order
        pos = _chain_flat_positions(c, shape, index, axis)
        out = c.make("scatter_reduce_chain",
                     (c.reshape(base, (numel,)), pos, src), (numel,), "f",
                     (reduce, bool(include_self)))
        return c.reshape(out, shape)
    pos = c.host(("fn", "axis_positions", shape, axis), [index])
    pre = c.host(("fn", "preimage", numel), [pos])
    out = c.make("scatter_reduce",
                 (c.reshape(base, (numel,)), pre,
                  c.reshape(src, (math.prod(c.shape(src)),))),
                 (numel,), "f", (reduce, bool(include_self)))
    return c.reshape(out, shape)


# -- integer arithmetic on a per-chain index (max.dim's, argmax's)

def _chain_int(op):
    def rule(c, args, kwargs, val):
        alpha = kwargs.get("alpha", 1)
        mode = kwargs.get("rounding_mode")
        name = {"floor": "floordiv", "trunc": "truncdiv"}.get(mode, op)
        if op == "div" and mode is None:
            raise NotImplementedError("true division of integers")
        xs = [c.const(a, (), "i") if _num(a) else a for a in args[:2]]
        if op == "rsub":  # other - alpha * self
            xs, name = xs[::-1], "sub"
        if alpha != 1:
            xs[1] = c.make("mul", (xs[1], c.const(alpha, (), "i")),
                           c.shape(xs[1]), "i")
        return c.make(name, xs, tuple(val.shape), "i")
    return rule


_CHAIN_INT_RULES = {"add": _chain_int("add"), "sub": _chain_int("sub"),
                    "rsub": _chain_int("rsub"), "mul": _chain_int("mul"),
                    "floor_divide": _chain_int("floordiv"),
                    "remainder": _chain_int("remainder"),
                    "div": _chain_int("div")}


def _chain_indices(c, indices) -> bool:
    """Whether ``indices`` hold a per-chain index tensor and no mask that
    depends on q."""
    ids = [i for i in indices if i is not None]
    return not c.data_only(ids) and not _q_mask(c, indices)


def _chain_positions(c, x, indices):
    """``(positions, x flat)``: the flat positions, a per-chain integer
    node, of ``x[i, j, ...]`` over the leading axes of ``x``, each index
    wrapped if negative and clamped into its axis (JAX's gather; torch
    raises instead), and ``x`` with those axes flattened into one."""
    shape = c.shape(x)
    tensors = [i for i in indices if i is not None]
    if len(tensors) != len(indices):
        raise NotImplementedError(
            "indexing by several index tensors that depend on q takes them "
            "on the leading axes, with no whole axis among them")
    out = ()
    for t in tensors:
        out = tuple(torch.broadcast_shapes(out, c.shape(t)))
    strides = _strides(shape[:len(tensors)])
    pos = None
    for t, length, st in zip(tensors, shape, strides):
        if c.nodes[t].dtype != "i":
            raise NotImplementedError("a bool mask beside index tensors")
        k = c.make("iclamp", (t,), c.shape(t), "i", (length,))
        if st != 1:
            k = c.make("mul", (k, c.const(st, (), "i")), c.shape(k), "i")
        pos = k if pos is None else c.make("add", (pos, k), tuple(
            torch.broadcast_shapes(c.shape(pos), c.shape(k))), "i")
    n = len(tensors)
    flat = c.reshape(x, (math.prod(shape[:n]), *shape[n:]))
    return c.expand(pos, out), flat


# -- special functions and the everyday families' ops (item 1.10c, reopened)

def _rule_log_sigmoid_forward(c, args, kwargs, val):
    """``(log_sigmoid(x), buffer)``: the buffer (the CPU's exp(-|x|)) is
    read only by the CPU's backward; the functor's backward recomputes it,
    so it is a fill."""
    return (c.elementwise("log_sigmoid", args[:1], val[0]),
            c.const(0.0, tuple(val[1].shape)))


def _rule_log_sigmoid_backward(c, args, kwargs, val):
    return c.elementwise("log_sigmoid_backward", args[:2], val)


def _eps(eps):
    """``logit``'s eps as its (lo, hi) bounds in float32, or () for None."""
    if eps is None:
        return ()
    lo = float(torch.tensor(float(eps), dtype=torch.float32))
    return lo, float(torch.tensor(1.0, dtype=torch.float32) - lo)


def _rule_logit(c, args, kwargs, val):
    eps = args[1] if len(args) > 1 else kwargs.get("eps")
    return c.elementwise("logit", args[:1], val, _eps(eps))


def _rule_logit_backward(c, args, kwargs, val):
    eps = args[2] if len(args) > 2 else kwargs.get("eps")
    return c.elementwise("logit_backward", args[:2], val, _eps(eps))


def _rule_polygamma(c, args, kwargs, val):
    n, x = int(args[0]), args[1]
    if n == 0:
        return c.elementwise("digamma", (x,), val)
    return c.elementwise("polygamma", (x,), val, (n,))


def _rule_mvlgamma(c, args, kwargs, val):
    """``mvlgamma(x, p)``: ``sum_i lgamma(x - i / 2)`` over i = p - 1, ...,
    0 (ATen's order, its arange from -(p - 1) / 2) plus ``p (p - 1) / 4 log
    pi``."""
    x, p = args[0], int(args[1])
    out = None
    for i in range(p - 1, -1, -1):
        t = c.elementwise("lgamma", (c.elementwise(
            "add", (x, -0.5 * i), _Val(c.shape(x))),), _Val(c.shape(x)))
        out = t if out is None else c.elementwise("add", (out, t),
                                                  _Val(c.shape(x)))
    return c.elementwise("add", (out, p * (p - 1) * math.log(math.pi) / 4),
                         val)


def _rule_vector_norm(c, args, kwargs, val):
    """``linalg_vector_norm(x, ord, dim, keepdim)``: ord 2 ``sqrt(sum(x
    x))``, 1 ``sum|x|``, inf ``max|x|``, -inf ``min|x|``, 0 the count of
    non-zeros, any other ``sum(|x|^p)^(1/p)``."""
    x = args[0]
    ord_ = float(args[1] if len(args) > 1 else kwargs.get("ord", 2))
    dims = args[2] if len(args) > 2 else kwargs.get("dim")
    keepdim = args[3] if len(args) > 3 else kwargs.get("keepdim", False)
    shape = c.shape(x)
    axes = _axes(dims, len(shape))
    if not shape:
        axes = ()
    v = _Val(shape)
    if ord_ == 2.0:
        return c.elementwise("sqrt", (_reduce(c, "sum", c.elementwise(
            "mul", (x, x), v), axes, keepdim),), val)
    a = c.elementwise("abs", (x,), v)
    if ord_ == 1.0:
        return _reduce(c, "sum", a, axes, keepdim)
    if math.isinf(ord_):
        return _extreme(c, a, axes, keepdim, 1 if ord_ > 0 else -1)
    if ord_ == 0.0:
        return _reduce(c, "sum", c.make("float", (c.elementwise(
            "ne", (x, 0.0), _Val(shape, torch.bool)),), shape), axes, keepdim)
    s = _reduce(c, "sum", c.elementwise("pow", (a,), v, (ord_,)), axes,
                keepdim)
    return c.elementwise("pow", (s,), val, (1.0 / ord_,))


def _rule_logcumsumexp(c, args, kwargs, val):
    x = args[0]
    axis = _axis(args[1] if len(args) > 1 else kwargs.get("dim"),
                 max(len(c.shape(x)), 1))
    if not c.shape(x):
        return x
    return c.make("logcumsumexp", (x,), c.shape(x), "f", (axis,))


def _rule_cummax(sign):
    """``cummax``/``cummin(x, dim)``: ``(values, indices)``, the index of
    the running maximum (minimum) a per-chain integer, the last of equals
    and a NaN the largest (torch's), the values read at it."""
    def rule(c, args, kwargs, val):
        x = args[0]
        axis = _axis(args[1] if len(args) > 1 else kwargs.get("dim"),
                     max(len(c.shape(x)), 1))
        if not c.shape(x):
            return x, c.const(0, (), "i")
        if c.nodes[x].dtype != "f":
            x = c.make("float", (x,), c.shape(x))
        idx = c.make("cumarg", (x,), c.shape(x), "i", (axis, sign))
        return c.make("take", (x, idx), c.shape(x), "f", (axis,)), idx
    return rule


def _select_keep(c, x, axis, k):
    """Element ``k`` along ``axis`` of ``x``, the axis kept (length 1)."""
    shape = list(c.shape(x))
    shape[axis] = 1
    return c.make("slice", (x,), tuple(shape), c.nodes[x].dtype, (axis, k, 1))


def _rule_cross(c, args, kwargs, val):
    """``linalg_cross(a, b, dim)``: ``c_i = a_{i+1} b_{i+2} - a_{i+2}
    b_{i+1}`` (indices mod 3), as ATen's cross kernel."""
    a, b = args[0], args[1]
    shape = tuple(val.shape)
    dim = _axis(kwargs.get("dim", args[2] if len(args) > 2 else -1),
                len(shape))
    a, b = c.expand(a, shape), c.expand(b, shape)
    one = list(shape)
    one[dim] = 1
    v = _Val(tuple(one))
    pieces = []
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        pieces.append(c.elementwise("sub", (
            c.elementwise("mul", (_select_keep(c, a, dim, j),
                                  _select_keep(c, b, dim, k)), v),
            c.elementwise("mul", (_select_keep(c, a, dim, k),
                                  _select_keep(c, b, dim, j)), v)), v))
    return c.make("cat", pieces, shape, "f", (dim,))


def _cdist_diff(c, x1, x2):
    """``x1 (.., P, M)`` and ``x2 (.., R, M)`` -> their differences ``(..,
    P, R, M)``."""
    s1, s2 = c.shape(x1), c.shape(x2)
    lead = tuple(torch.broadcast_shapes(s1[:-2], s2[:-2]))
    P, R, M = s1[-2], s2[-2], s1[-1]
    out = (*lead, P, R, M)
    a = c.expand(c.reshape(x1, (*s1[:-2], P, 1, M)), out)
    b = c.expand(c.reshape(x2, (*s2[:-2], 1, R, M)), out)
    return c.elementwise("sub", (a, b), _Val(out)), out


def _rule_cdist_forward(c, args, kwargs, val):
    """``_cdist_forward(x1, x2, p)``: the p-norm of each pair's
    difference, computed from the differences (p 2, 1, inf, 0 or any)."""
    x1, x2, p = args[0], args[1], float(args[2])
    d, shape = _cdist_diff(c, x1, x2)
    last = len(shape) - 1
    v = _Val(shape)
    if p == 2.0:
        return c.elementwise("sqrt", (_reduce(c, "sum", c.elementwise(
            "mul", (d, d), v), (last,), False),), val)
    a = c.elementwise("abs", (d,), v)
    if p == 1.0:
        return _reduce(c, "sum", a, (last,), False)
    if math.isinf(p):
        return _reduce(c, "amax", a, (last,), False)
    if p == 0.0:
        return _reduce(c, "sum", c.make("float", (c.elementwise(
            "ne", (d, 0.0), _Val(shape, torch.bool)),), shape), (last,),
            False)
    s = _reduce(c, "sum", c.elementwise("pow", (a,), v, (p,)), (last,),
                False)
    return c.elementwise("pow", (s,), val, (1.0 / p,))


def _rule_cdist_backward(c, args, kwargs, val):
    """``_cdist_backward(grad, x1, x2, p, dist)``: the gradient in ``x1``,
    ATen's per-pair terms summed over x2's rows: p 2 ``g d / dist`` (0
    where dist is 0), 1 ``g sign(d)``, inf ``g sign(d) (|d| == dist)``,
    p < 2 ``g sign(d) |d|^(p-1) / dist^(p-1)`` (0 where dist is 0, or d is
    0 with p < 1), else ``g d |d|^(p-2) / dist^(p-1)`` (0 where dist is
    0)."""
    grad, x1, x2, p, dist = args[:5]
    p = float(p)
    d, shape = _cdist_diff(c, x1, x2)
    v = _Val(shape)
    bv = _Val(shape, torch.bool)
    g = c.expand(c.reshape(grad, (*c.shape(grad), 1)), shape)
    r = c.expand(c.reshape(dist, (*c.shape(dist), 1)), shape)
    sgn = c.elementwise("sign", (d,), v)
    zero = c.elementwise("eq", (r, 0.0), bv)
    if p == 0.0:
        return c.const(0.0, tuple(val.shape))
    if p == 1.0:
        term = c.elementwise("mul", (g, sgn), v)
    elif math.isinf(p):
        a = c.elementwise("abs", (d,), v)
        term = c.elementwise("mul", (c.elementwise("mul", (g, sgn), v),
                                     c.make("float", (c.elementwise(
                                         "eq", (a, r), bv),), shape)), v)
    elif p == 2.0:
        term = c.elementwise("where", (zero, 0.0, c.elementwise(
            "div", (c.elementwise("mul", (g, d), v), r), v)), v)
    else:
        a = c.elementwise("abs", (d,), v)
        if p < 2.0:
            num = c.elementwise("mul", (c.elementwise("mul", (
                sgn, c.elementwise("pow", (a,), v, (p - 1.0,))), v), g), v)
            if p < 1.0:
                zero = c.elementwise("or", (zero, c.elementwise(
                    "eq", (d, 0.0), bv)), bv)
        else:
            num = c.elementwise("mul", (c.elementwise("mul", (
                d, c.elementwise("pow", (a,), v, (p - 2.0,))), v), g), v)
        term = c.elementwise("where", (zero, 0.0, c.elementwise(
            "div", (num, c.elementwise("pow", (r,), v, (p - 1.0,))), v)), v)
    out = _reduce(c, "sum", term, (len(shape) - 2,), False)
    return c.reshape(c.expand(out, tuple(val.shape)), val.shape) \
        if c.shape(out) != tuple(val.shape) else out


# -- linear algebra on the LU, QR, SVD and matrix exponential nodes

def _eye(c, shape):
    return _band(c, tuple(shape), len(shape) - 2, len(shape) - 1, 0, 0, "f")


def _bmm(c, a, b):
    """``a (batch, m, k) @ b (batch or 1, k, n)``: a product a matrix,
    concatenated."""
    (batch, m, _), (bb, _, n) = c.shape(a), c.shape(b)
    outs = []
    for i in range(batch):
        ai = c.make("select", (a,), c.shape(a)[1:], "f", (0, i))
        bi = c.make("select", (b,), c.shape(b)[1:], "f", (0, i if bb > 1
                                                          else 0))
        outs.append(c.reshape(_mm(c, ai, bi), (1, m, n)))
    return outs[0] if batch == 1 else c.make("cat", outs, (batch, m, n), "f",
                                             (0,))


def _rule_inv(c, args, kwargs, val):
    """``linalg_inv_ex(A)``: lusolve against the identity; info 0."""
    A = args[0]
    shape = tuple(val[0].shape)
    return (_solve(c, "lusolve", A, _eye(c, shape), shape),
            c.const(0, tuple(val[1].shape), "i"))


def _lu_nodes(c, A):
    """``(LU (*, n, n), pivots (*, n), A's batch)`` of a ``lufactor``
    node: LAPACK's getrf a matrix (partial pivoting, 1-based pivots)."""
    n = c.shape(A)[-1]
    A3, lead = _batched(c, A, n)
    batch = c.shape(A3)[0]
    F = c.make("lufactor", (A3,), (batch, n + 1, n), "f")
    LU = c.make("slice", (F,), (batch, n, n), "f", (1, 0, 1))
    piv = c.make("select", (F,), (batch, n), "i", (1, n))
    return LU, piv, lead


def _rule_lu_factor(c, args, kwargs, val):
    """``linalg_lu_factor_ex(A)``: ``(LU, pivots, info)``, info 0."""
    A = args[0]
    n = c.shape(A)[-1]
    LU, piv, lead = _lu_nodes(c, A)
    return (c.reshape(LU, (*lead, n, n)), c.reshape(piv, (*lead, n)),
            c.const(0, tuple(val[2].shape), "i"))


def _perm_matrix(c, piv, n):
    """P of A = P L U from getrf's pivots ``(batch, n)`` (an ``lu_p``
    node: the row swaps applied in order, a lane a matrix)."""
    batch = c.shape(piv)[0]
    return c.make("lu_p", (piv,), (batch, n, n), "f")


def _rule_lu_unpack(c, args, kwargs, val):
    """``lu_unpack(LU, pivots)``: ``(P, L, U)``, L unit lower, U upper."""
    LU, piv = args[:2]
    shape = c.shape(LU)
    n = shape[-1]
    if shape[-2] != n:
        raise NotImplementedError(
            "lu_unpack of a non-square factor has no rule in the generic "
            f"potential compiler; widening its op table is {_ROADMAP}")
    lead = shape[:-2]
    batch = math.prod(lead)
    strict = _band(c, shape, len(shape) - 2, len(shape) - 1, None, -1)
    L = c.elementwise("add", (c.elementwise("where", (strict, LU, 0.0),
                                            _Val(shape)), _eye(c, shape)),
                      _Val(shape))
    U = c.elementwise("where", (_band(c, shape, len(shape) - 2,
                                      len(shape) - 1, 0, None), LU, 0.0),
                      _Val(shape))
    P = _perm_matrix(c, c.reshape(piv, (batch, n)), n)
    return c.reshape(P, shape), L, U


def _lu_solve3(c, LU3, piv3, B3, adjoint):
    """``A X = B`` (``A^T X = B`` when ``adjoint``) from A's LU and
    pivots, ``(batch or 1, n, n)`` and ``(batch, n, k)``: P^T, then the
    unit lower and the upper substitution (their transposes, then P)."""
    n = c.shape(LU3)[-1]
    shape = c.shape(B3)
    P = _perm_matrix(c, piv3, n)
    if not adjoint:
        Y = _bmm(c, _swap_last(c, P), B3)
        Y = _trsolve(c, LU3, Y, False, True, shape)
        return _trsolve(c, LU3, Y, True, False, shape)
    Lt = _swap_last(c, LU3)
    Z = _trsolve(c, Lt, B3, False, False, shape)
    Z = _trsolve(c, Lt, Z, True, True, shape)
    return _bmm(c, P, Z)


def _rule_lu_solve(c, args, kwargs, val):
    """``linalg_lu_solve(LU, pivots, B, left, adjoint)``."""
    LU, piv, B = args[:3]
    left = kwargs.get("left", args[3] if len(args) > 3 else True)
    adjoint = kwargs.get("adjoint", args[4] if len(args) > 4 else False)
    n = c.shape(LU)[-1]
    out = tuple(val.shape)
    lu_lead = c.shape(LU)[:-2]
    LU3 = c.reshape(LU, (math.prod(lu_lead), n, n))
    piv3 = c.reshape(piv, (math.prod(lu_lead), n))
    if not left:  # X A = B is A^T X^T = B^T
        B = _swap_last(c, B)
        adjoint = not adjoint
    bshape = c.shape(B)
    batch = math.prod(bshape[:-2])
    B3 = c.reshape(c.expand(B, (*bshape[:-2], *bshape[-2:])),
                   (batch, *bshape[-2:]))
    if c.nodes[B3].dtype != "f":
        B3 = c.make("float", (B3,), c.shape(B3))
    if c.shape(LU3)[0] not in (1, batch):
        raise NotImplementedError("linalg_lu_solve with factors broadcast "
                                  "against a batch of right sides")
    X = c.reshape(_lu_solve3(c, LU3, piv3, B3, adjoint), bshape)
    return _swap_last(c, X) if not left else c.reshape(X, out)


def _rule_det(c, args, kwargs, val):
    """``_linalg_det(A)``: ``(det, LU, pivots)``, det the product of U's
    diagonal, negated for each row swap."""
    A = args[0]
    n = c.shape(A)[-1]
    LU, piv, lead = _lu_nodes(c, A)
    batch = c.shape(LU)[0]
    diag = c.make("diagonal", (LU,), (batch, n), "f", (0, 1, 2))
    rows = c.host(("fn", "arange", n, 1), [])
    swapped = c.elementwise("ne", (piv, rows), _Val((batch, n), torch.bool))
    signs = c.elementwise("where", (swapped, -1.0, 1.0), _Val((batch, n)))
    det = c.elementwise("mul", (_reduce(c, "prod", diag, (1,), False),
                                _reduce(c, "prod", signs, (1,), False)),
                        _Val((batch,)))
    return (c.reshape(det, lead), c.reshape(LU, (*lead, n, n)),
            c.reshape(piv, (*lead, n)))


def _rule_cholesky_inverse(c, args, kwargs, val):
    """``cholesky_inverse(L, upper)``: ``cholesky_solve(I, L)``."""
    L = args[0]
    upper = kwargs.get("upper", args[1] if len(args) > 1 else False)
    shape = tuple(val.shape)
    return _rule_cholesky_solve(c, (_eye(c, shape), L, upper), {}, val)


def _qr_nodes(c, A):
    """``(Q (batch, m, n), R (batch, n, n), lead)`` of the reduced QR of
    ``A (*, m, n)``, m >= n: a ``qr`` node (Householder, LAPACK's geqrf
    and orgqr conventions)."""
    m, n = c.shape(A)[-2:]
    lead = c.shape(A)[:-2]
    if m < n:
        raise NotImplementedError(
            "linalg_qr of a wide matrix (m < n) has no rule in the generic "
            f"potential compiler; widening its op table is {_ROADMAP}")
    batch = math.prod(lead)
    A3 = c.reshape(A, (batch, m, n))
    F = c.make("qr", (A3,), (batch, m + n, n), "f")
    Q = c.make("slice", (F,), (batch, m, n), "f", (1, 0, 1))
    R = c.make("slice", (F,), (batch, n, n), "f", (1, m, 1))
    return Q, R, lead


def _rule_qr(c, args, kwargs, val):
    """``linalg_qr(A, mode)``: "reduced", "r", and "complete" of a square
    matrix (the same factors)."""
    A = args[0]
    mode = kwargs.get("mode", args[1] if len(args) > 1 else "reduced")
    m, n = c.shape(A)[-2:]
    if mode == "complete" and m != n:
        raise NotImplementedError(
            "linalg_qr(mode='complete') of a non-square matrix has no rule "
            f"in the generic potential compiler; widening its op table is "
            f"{_ROADMAP}")
    Q, R, lead = _qr_nodes(c, A)
    R = c.reshape(R, (*lead, n, n))
    if mode == "r":
        return c.const(0.0, tuple(val[0].shape)), R
    return c.reshape(Q, (*lead, m, n)), R


def _svd_nodes(c, A):
    """``(U (batch, m, k), S (batch, k), V (batch, n, k), lead)`` of
    ``A (*, m, n)``, k = min(m, n): an ``svd`` node (one-sided Jacobi,
    singular values descending, each column of U with its largest
    component positive) on A, or on A^T when m < n."""
    m, n = c.shape(A)[-2:]
    lead = c.shape(A)[:-2]
    batch = math.prod(lead)
    A3 = c.reshape(A, (batch, m, n))
    wide = m < n
    if wide:
        A3 = _swap_last(c, A3)
        m, n = n, m
    F = c.make("svd", (A3,), (batch, m + 1 + n, n), "f", (bool(wide),))
    U = c.make("slice", (F,), (batch, m, n), "f", (1, 0, 1))
    S = c.make("select", (F,), (batch, n), "f", (1, m))
    V = c.make("slice", (F,), (batch, n, n), "f", (1, m + 1, 1))
    if wide:
        U, V = V, U
    return U, S, V, lead


def _rule_svd(c, args, kwargs, val):
    """``_linalg_svd(A, full_matrices, compute_uv)``: ``(U, S, Vh)``; U
    and Vh empty without compute_uv."""
    A = args[0]
    full = kwargs.get("full_matrices", args[1] if len(args) > 1 else False)
    compute_uv = kwargs.get("compute_uv", args[2] if len(args) > 2 else True)
    m, n = c.shape(A)[-2:]
    if compute_uv and full and m != n:
        raise NotImplementedError(
            "svd with full_matrices=True of a non-square matrix has no rule "
            "in the generic potential compiler (use full_matrices=False); "
            f"widening its op table is {_ROADMAP}")
    U, S, V, lead = _svd_nodes(c, A)
    k = min(m, n)
    S = c.reshape(S, (*lead, k))
    if not compute_uv:
        return (c.const(0.0, tuple(val[0].shape)), S,
                c.const(0.0, tuple(val[2].shape)))
    return (c.reshape(U, (*lead, m, k)), S,
            c.reshape(_swap_last(c, V), (*lead, k, n)))


def _rule_pinv(c, args, kwargs, val):
    """``linalg_pinv(A, atol, rtol)`` (torch's): from the SVD, 1/s where s
    exceeds max(atol, rtol s_max), else 0; rtol max(m, n) eps by default
    (0 when only atol is given)."""
    A = args[0]
    atol = kwargs.get("atol", args[1] if len(args) > 1 else None)
    rtol = kwargs.get("rtol", args[2] if len(args) > 2 else None)
    if kwargs.get("hermitian", args[3] if len(args) > 3 else False):
        raise NotImplementedError("linalg_pinv(hermitian=True)")
    if isinstance(atol, _Id) or isinstance(rtol, _Id):
        raise NotImplementedError("linalg_pinv with tensor tolerances")
    m, n = c.shape(A)[-2:]
    if rtol is None:
        rtol = 0.0 if atol is not None and atol > 0 else \
            max(m, n) * float(torch.finfo(torch.float32).eps)
    atol = 0.0 if atol is None else float(atol)
    U, S, V, lead = _svd_nodes(c, A)
    batch, k = c.shape(S)
    smax = c.make("slice", (S,), (batch, 1), "f", (1, 0, 1))
    tol = c.elementwise("maximum", (c.elementwise(
        "mul", (smax, float(rtol)), _Val((batch, 1))), atol),
        _Val((batch, 1)))
    keep = c.elementwise("gt", (S, tol), _Val((batch, k), torch.bool))
    inv = c.elementwise("where", (keep, c.elementwise(
        "reciprocal", (S,), _Val((batch, k))), 0.0), _Val((batch, k)))
    Vs = c.elementwise("mul", (V, c.reshape(inv, (batch, 1, k))),
                       _Val((batch, n, k)))
    return c.reshape(_bmm(c, Vs, _swap_last(c, U)), val.shape)


def _rule_lstsq(c, args, kwargs, val):
    """``linalg_lstsq(A, B)`` of a full-rank tall or square A: R^-1 Q^T B
    from its reduced QR; the residuals, rank and singular values empty
    (torch's default gelsy routine returns them so)."""
    A, B = args[:2]
    m, n = c.shape(A)[-2:]
    if m < n:
        raise NotImplementedError(
            "linalg_lstsq of a wide matrix has no rule in the generic "
            f"potential compiler; widening its op table is {_ROADMAP}")
    Q, R, lead = _qr_nodes(c, A)
    batch = c.shape(Q)[0]
    vector = len(c.shape(B)) == len(c.shape(A)) - 1
    if vector:
        B = c.reshape(B, (*c.shape(B), 1))
    k = c.shape(B)[-1]
    B3 = c.reshape(c.expand(B, (*lead, m, k)), (batch, m, k))
    if c.nodes[B3].dtype != "f":
        B3 = c.make("float", (B3,), (batch, m, k))
    X = _trsolve(c, R, _bmm(c, _swap_last(c, Q), B3), True, False,
                 (batch, n, k))
    rest = [c.const(0.0, tuple(v.shape), "i" if v.dtype in INT_DTYPES
                    else "f") for v in val[1:]]
    return (c.reshape(X, val[0].shape), *rest)


def _rule_matrix_exp(c, args, kwargs, val):
    """``linalg_matrix_exp(A)``: ATen's scaling and squaring with Bader,
    Blanes and Casas's Taylor polynomials of degree 1-18, chosen by the
    1-norm against its float32 thresholds (a ``mexp`` node a matrix)."""
    A = args[0]
    n = c.shape(A)[-1]
    if n == 1:
        return c.elementwise("exp", (A,), val)
    A3, lead = _batched(c, A, n)
    return c.reshape(c.make("mexp", (A3,), c.shape(A3), "f"), val.shape)



_RULES = {
    # no computation
    "alias": _rule_identity, "clone": _rule_identity,
    "detach": _rule_identity, "lift_fresh_copy": _rule_identity,
    "contiguous": _rule_identity, "_to_copy": _rule_identity,
    "to": _rule_identity, "_unsafe_view": _rule_reshape,
    "view": _rule_reshape, "reshape": _rule_reshape,
    "squeeze": _rule_reshape, "unsqueeze": _rule_reshape,
    "flatten": _rule_reshape, "permute": _rule_permute, "t": _rule_t,
    "transpose": _rule_transpose, "expand": _rule_expand,
    "slice": _rule_slice, "select": _rule_select,
    # constants
    "ones_like": _rule_fill(lambda a, k: 1.0),
    "zeros_like": _rule_fill(lambda a, k: 0.0),
    "new_ones": _rule_fill(lambda a, k: 1.0),
    "new_zeros": _rule_fill(lambda a, k: 0.0),
    "full_like": _rule_fill(lambda a, k: a[1]),
    "new_full": _rule_fill(lambda a, k: a[2]),
    "full": _rule_fill(lambda a, k: a[1]),
    "zeros": _rule_fill(lambda a, k: 0.0),
    "ones": _rule_fill(lambda a, k: 1.0),
    "scalar_tensor": _rule_fill(lambda a, k: a[0]),
    "fill": _rule_fill(lambda a, k: a[1]),
    # elementwise
    **{n: _rule_unary(n) for n in ("neg", "abs", "exp", "expm1", "log",
                                   "log1p", "sqrt", "rsqrt", "tanh",
                                   "sigmoid", "reciprocal", "relu", "sin",
                                   "cos")},
    "sgn": _rule_unary("sign"), "sign": _rule_unary("sign"),
    "logical_not": _rule_unary("not"),
    "add": _rule_binary("add"), "sub": _rule_binary("sub"),
    "mul": _rule_binary("mul"), "div": _rule_binary("div"),
    "rsub": _rule_rsub, "true_divide": _rule_binary("div"),
    "maximum": _rule_binary("maximum"), "minimum": _rule_binary("minimum"),
    "logical_and": _rule_binary("and"), "logical_or": _rule_binary("or"),
    "bitwise_not": _rule_unary("not"), "bitwise_and": _rule_binary("and"),
    "bitwise_or": _rule_binary("or"), "isnan": _rule_unary("isnan"),
    **{n: _rule_compare(n) for n in COMPARISONS},
    "where": _rule_where, "masked_fill": _rule_masked_fill,
    "clamp": _rule_clamp, "clip": _rule_clamp,
    "clamp_min": _rule_clamp_one("clamp_min"),
    "clamp_max": _rule_clamp_one("clamp_max"),
    "pow": _rule_pow, "square": _rule_square,
    "softplus": _rule_softplus,
    "softplus_backward": _rule_softplus_backward,
    "threshold_backward": _rule_threshold_backward,
    "sigmoid_backward": _rule_binary_backward("sigmoid_backward"),
    "tanh_backward": _rule_binary_backward("tanh_backward"),
    # special functions (B)
    **{n: _rule_unary(n) for n in ("lgamma", "digamma", "erf", "erfc",
                                   "atan")},
    "special_erfcx": _rule_unary("erfcx"),
    "special_log_ndtr": _rule_unary("log_ndtr"),
    "logaddexp": _rule_binary("logaddexp"),
    # contractions
    "sum": _rule_sum(False), "mean": _rule_sum(True), "amax": _rule_amax,
    "amin": _rule_amin, "max": _rule_max(1), "min": _rule_max(-1),
    "argmax": _rule_argmax(1), "argmin": _rule_argmax(-1),
    "var": _rule_var,
    "mm": _rule_mm, "mv": _rule_mv, "dot": _rule_dot, "bmm": _rule_bmm,
    "addmm": _rule_addmm,
    # triangular algebra on a matrix (A)
    "linalg_solve_triangular": _rule_solve_triangular,
    "cholesky_solve": _rule_cholesky_solve,
    # a general solve: LU with partial pivoting a chain
    "_linalg_solve_ex": _rule_linalg_solve,
    "_linalg_check_errors": _rule_check_errors,
    # reductions along an axis (C)
    "logsumexp": _rule_logsumexp, "_log_softmax": _rule_log_softmax,
    "_softmax": _rule_softmax,
    "_log_softmax_backward_data": _rule_log_softmax_backward,
    "_softmax_backward_data": _rule_softmax_backward, "stack": _rule_stack,
    # gathers and their scatter-adds (D), scans
    "index": _rule_index, "index_select": _rule_index_select,
    "index_put": _rule_index_put, "_index_put_impl": _rule_index_put,
    "index_add": _rule_index_add, "flip": _rule_flip, "cumsum": _rule_cumsum,
    "gather": _rule_gather, "scatter": _rule_scatter(False),
    "scatter_add": _rule_scatter(True),
    # scatter into zeros, concatenation
    "cat": _rule_cat, "slice_backward": _rule_slice_backward,
    "select_backward": _rule_select_backward,
    # structural ops (item 1.10c, the last of the table)
    "eye": _rule_eye, "tril": _rule_tri(False), "triu": _rule_tri(True),
    "diagonal": _rule_diagonal, "diag_embed": _rule_diag_embed,
    "diagonal_backward": _rule_diagonal_backward,
    "diagonal_scatter": _rule_diagonal_scatter,
    "constant_pad_nd": _rule_constant_pad_nd,
    # factorisations, scans and products, sorts, reducing scatters
    "linalg_cholesky_ex": _rule_cholesky, "_linalg_slogdet": _rule_slogdet,
    "_linalg_eigh": _rule_eigh,
    "cumprod": _rule_cumprod, "prod": _rule_prod,
    "sort": _rule_sort, "topk": _rule_topk,
    "scatter_reduce": _rule_scatter_reduce,
    # the everyday families' ops and special functions (item 1.10c,
    # reopened): elementwise, reductions and scans
    "xlogy": _rule_binary("xlogy"), "special_xlog1py": _rule_binary("xlog1py"),
    "log_sigmoid_forward": _rule_log_sigmoid_forward,
    "log_sigmoid_backward": _rule_log_sigmoid_backward,
    "empty_like": _rule_fill(lambda a, k: 0.0),
    "empty": _rule_fill(lambda a, k: 0.0),
    "logit": _rule_logit, "logit_backward": _rule_logit_backward,
    "atan2": _rule_binary("atan2"), "erfinv": _rule_unary("erfinv"),
    "special_i0e": _rule_unary("i0e"), "special_i1e": _rule_unary("i1e"),
    "i0": _rule_unary("i0"), "special_i1": _rule_unary("i1"),
    "polygamma": _rule_polygamma, "mvlgamma": _rule_mvlgamma,
    "linalg_vector_norm": _rule_vector_norm,
    "logcumsumexp": _rule_logcumsumexp,
    "cummax": _rule_cummax(1), "cummin": _rule_cummax(-1),
    "linalg_cross": _rule_cross,
    "_cdist_forward": _rule_cdist_forward,
    "_cdist_backward": _rule_cdist_backward,
    # linear algebra: LU, QR, SVD, the matrix exponential
    "linalg_inv_ex": _rule_inv, "linalg_lu_factor_ex": _rule_lu_factor,
    "lu_unpack": _rule_lu_unpack, "linalg_lu_solve": _rule_lu_solve,
    "_linalg_det": _rule_det, "cholesky_inverse": _rule_cholesky_inverse,
    "linalg_qr": _rule_qr, "_linalg_svd": _rule_svd,
    "linalg_pinv": _rule_pinv, "linalg_lstsq": _rule_lstsq,
    "linalg_matrix_exp": _rule_matrix_exp,
}

# ops whose value, where it depends on the data alone, the host folds into
# a derived float row rather than the card computing it at every gradient
_FOLD = {"linalg_cholesky_ex", "_linalg_slogdet", "_linalg_eigh", "sort",
         "topk", "cumprod", "prod", "linalg_inv_ex", "linalg_lu_factor_ex",
         "_linalg_det", "cholesky_inverse", "linalg_qr", "_linalg_svd",
         "linalg_pinv", "linalg_lstsq", "linalg_matrix_exp"}
# ops whose value the host must not fold: uninitialised or random
_NO_FOLD = ("empty", "rand", "normal", "bernoulli", "uniform", "exponential",
            "multinomial", "poisson")

# rules that may give integers (views and copies of integer data; a count)
_INT_RULES = {"alias", "clone", "detach", "lift_fresh_copy", "contiguous",
              "_to_copy", "to", "_unsafe_view", "view", "reshape", "squeeze",
              "unsqueeze", "flatten", "permute", "t", "transpose", "expand",
              "slice", "select", "flip", "sum"}
# rules that give a per-chain index (computed on the card)
_ARG_RULES = {"max", "min", "argmax", "argmin"}


# --------------------------------------------------------- plain back end -

def _plain_op(n: Node, vals, dtype):
    a = vals[0] if vals else None
    op = n.op
    if op == "neg":
        return -a
    if op in ("abs", "exp", "expm1", "log", "log1p", "sqrt", "rsqrt", "tanh",
              "sigmoid", "reciprocal", "relu", "sin", "cos", "atan", "lgamma",
              "digamma", "erf", "erfc", "isnan"):
        return getattr(torch, op)(a)
    if op == "erfcx":
        return torch.special.erfcx(a)
    if op == "log_ndtr":
        return torch.special.log_ndtr(a)
    if op == "sign":
        return torch.sgn(a)
    if op == "not":
        return torch.logical_not(a)
    if op == "float":
        return a.to(dtype)
    binary = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
              "div": torch.div, "maximum": torch.maximum,
              "minimum": torch.minimum, "eq": torch.eq, "ne": torch.ne,
              "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
              "and": torch.logical_and, "or": torch.logical_or,
              "logaddexp": torch.logaddexp}
    if op in binary:
        return binary[op](vals[0], vals[1])
    if op == "where":
        return torch.where(vals[0], vals[1], vals[2])
    if op == "floordiv":
        return torch.div(vals[0], vals[1], rounding_mode="floor")
    if op == "truncdiv":
        return torch.div(vals[0], vals[1], rounding_mode="trunc")
    if op == "remainder":
        return torch.remainder(vals[0], vals[1])
    if op == "iclamp":
        return _clamped(a, n.params[0], flat=False)
    if op == "clamp_min":
        return torch.clamp(a, min=n.params[0])
    if op == "clamp_max":
        return torch.clamp(a, max=n.params[0])
    if op == "pow":
        return torch.pow(a, n.params[0])
    if op == "powt":
        return torch.pow(vals[0], vals[1])
    if op == "rpow":
        return torch.pow(n.params[0], a)
    if op == "softplus":
        return torch.nn.functional.softplus(a, *n.params)
    if op == "softplus_backward":
        return torch.ops.aten.softplus_backward(vals[0], vals[1], *n.params)
    if op == "threshold_backward":
        return torch.ops.aten.threshold_backward(vals[0], vals[1],
                                                 n.params[0])
    if op == "sigmoid_backward":
        return torch.ops.aten.sigmoid_backward(vals[0], vals[1])
    if op == "tanh_backward":
        return torch.ops.aten.tanh_backward(vals[0], vals[1])
    special = {"xlogy": torch.xlogy, "xlog1py": torch.special.xlog1py,
               "atan2": torch.atan2, "erfinv": torch.erfinv,
               "i0e": torch.special.i0e, "i1e": torch.special.i1e,
               "i0": torch.special.i0, "i1": torch.special.i1,
               "log_sigmoid": torch.nn.functional.logsigmoid}
    if op in special:
        return special[op](*vals)
    if op == "log_sigmoid_backward":  # ATen's formula, the buffer recomputed
        g, x = vals
        neg = x < 0
        z = torch.exp(-torch.abs(x))
        return g * (neg.to(x.dtype) - torch.where(neg, 1.0, -1.0).to(
            x.dtype) * (z / (1 + z)))
    if op == "logit":
        return torch.logit(a, n.params[0] if n.params else None)
    if op == "logit_backward":
        return torch.ops.aten.logit_backward(vals[0], vals[1],
                                             n.params[0] if n.params else None)
    if op == "polygamma":
        return torch.polygamma(n.params[0], a)
    raise AssertionError(op)


def _plain_node(n: Node, args, dtype, dev):
    """One IR node (not ``q`` nor ``data``) of the plain back end, on
    values whose last axis is the chain axis (C, or 1); an integer node
    read from a float one (getrf's pivots) as int64."""
    v = _plain_value(n, args, dtype, dev)
    if n.dtype == "i" and v.is_floating_point():
        v = v.round().to(torch.int64)
    return v


def _plain_value(n: Node, args, dtype, dev):
    if n.op == "const":
        return torch.full((*n.shape, 1), n.params[0],
                          dtype={"b": torch.bool, "i": torch.int64}.get(
                              n.dtype, dtype), device=dev)
    if n.op == "band":
        d1, d2, lo, hi = n.params
        diff = (torch.arange(n.shape[d2], device=dev)[None, :]
                - torch.arange(n.shape[d1], device=dev)[:, None])
        mask = torch.ones_like(diff, dtype=torch.bool)
        if lo is not None:
            mask &= diff >= lo
        if hi is not None:
            mask &= diff <= hi
        view = [1] * len(n.shape)
        view[d1], view[d2] = n.shape[d1], n.shape[d2]
        mask = (mask if d1 < d2 else mask.T).reshape(*view, 1)
        return mask.expand(*n.shape, 1).to(
            torch.bool if n.dtype == "b" else dtype)
    if n.op == "diagonal":
        offset, d1, d2 = n.params
        return args[0].diagonal(offset, d1, d2).movedim(-1, -2)
    if n.op == "diag_pad":
        offset, d1, d2 = n.params
        a = args[0]
        v = torch.zeros((*n.shape, a.shape[-1]), dtype=a.dtype, device=dev)
        v.diagonal(offset, d1, d2).copy_(a.movedim(-1, -2))
        return v
    if n.op == "take":  # torch.gather by a per-chain index, clamped
        x, k = args
        axis = n.params[0]
        c = max(x.shape[-1], k.shape[-1])
        k = _clamped(k, x.shape[axis]).expand(*k.shape[:-1], c)
        return torch.gather(x.expand(*x.shape[:-1], c), axis, k)
    if n.op == "reshape":
        return args[0].reshape(*n.shape, args[0].shape[-1])
    if n.op == "permute":
        return args[0].permute(*n.params, len(n.params))
    if n.op == "expand":
        a = args[0]
        lead = len(n.shape) - (a.ndim - 1)
        return a.reshape(*(1,) * lead, *a.shape).expand(*n.shape, a.shape[-1])
    if n.op == "slice":
        axis, start, step = n.params
        index = [slice(None)] * axis + [
            slice(start, start + n.shape[axis] * step, step)]
        return args[0][tuple(index)]
    if n.op == "select":
        return args[0].select(n.params[0], n.params[1])
    if n.op == "flip":
        return args[0].flip(n.params)
    if n.op == "gather":
        x, k = args
        axis = n.params[0]
        if len(n.params) > 1:  # a per-chain index, clamped, a chain each
            c = max(x.shape[-1], k.shape[-1])
            k = _clamped(k, x.shape[axis]).expand(*k.shape[:-1], c)
            x = x.expand(*x.shape[:-1], c).movedim(axis, 0)
            flat = k.reshape(-1, c)
            out = torch.gather(x.reshape(x.shape[0], -1, c), 0, flat[:, None,
                                                                   :].expand(
                flat.shape[0], x[0].numel() // c, c))
            out = out.reshape(*k.shape[:-1], *x.shape[1:-1], c)
            rank = k.ndim - 1
            return out.movedim(tuple(range(rank)),
                               tuple(range(axis, axis + rank)))
        return x.index_select(axis, _wrapped(k, x.shape[axis])).reshape(
            *n.shape, x.shape[-1])
    if n.op == "scatter_add":  # the preimage row, if any, unread
        base, k, src = args[:3]
        axis = n.params[0]
        c = max(base.shape[-1], src.shape[-1], k.shape[-1])
        src = src.expand(*src.shape[:-1], c).reshape(
            *n.shape[:axis], -1, *n.shape[axis + 1:], c)
        if k.shape[-1] == 1:  # an index of data
            return base.expand(*n.shape, c).index_add(
                axis, _wrapped(k, n.shape[axis]), src)
        k = _clamped(k, n.shape[axis]).reshape(
            *(1,) * axis, -1, *(1,) * (len(n.shape) - axis - 1), c)
        return base.expand(*n.shape, c).clone().scatter_add(
            axis, k.expand(src.shape), src)
    if n.op == "put":  # out[o] = values[inv[o]] where inv[o] >= 0
        base, inv, values = args
        c = max(base.shape[-1], values.shape[-1])
        flat = values.expand(*values.shape[:-1], c).reshape(-1, c)
        inv = inv.reshape(-1)
        picked = flat.index_select(0, inv.clamp(min=0)).reshape(*n.shape, c)
        return torch.where((inv >= 0).reshape(*n.shape, 1), picked,
                           base.expand(*n.shape, c))
    if n.op == "pick":  # out[.., j, ..] = src if j == index else base
        base, k, src = args
        axis = n.params[0]
        c = max(a.shape[-1] for a in args)
        return base.expand(*n.shape, c).scatter(
            axis, k.expand(*k.shape[:-1], c),
            src.expand(*src.shape[:-1], c))
    if n.op == "argmax":
        axis, keepdim = n.params
        return args[0].max(dim=axis, keepdim=keepdim).indices
    if n.op == "sortidx":  # stable, a NaN the largest either way
        axis, descending, k = n.params
        return torch.sort(args[0], dim=axis, descending=descending,
                          stable=True).indices.narrow(axis, 0, k)
    if n.op == "scatter_perm":  # out = base; out[.., k[.., r, ..], ..] = src
        base, k, src = args
        axis = n.params[0]
        c = max(a.shape[-1] for a in args)
        return base.expand(*n.shape, c).scatter(
            axis, k.expand(*k.shape[:-1], c), src.expand(*src.shape[:-1], c))
    if n.op == "scatter_reduce":
        base, pre, src = args
        reduce, include_self = n.params
        numel = n.shape[0]
        pre = pre.reshape(-1)
        counts = pre[1:numel + 1] - pre[:numel]
        pos = torch.empty_like(pre[numel + 1:])
        pos[pre[numel + 1:]] = torch.repeat_interleave(
            torch.arange(numel, device=pre.device), counts)
        c = max(base.shape[-1], src.shape[-1])
        return base.expand(numel, c).scatter_reduce(
            0, pos[:, None].expand(-1, c), src.expand(-1, c), reduce,
            include_self=include_self)
    if n.op == "chol":  # NaN over a factor that is not positive definite
        A = args[0].movedim(-1, 0)
        L, info = torch.linalg.cholesky_ex(A)
        L = torch.where((info != 0)[..., None, None], math.nan, L)
        return L.movedim(0, -1)
    if n.op == "slogdet":
        sign, logabs = torch.linalg.slogdet(args[0].movedim(-1, 0))
        return torch.stack([sign, logabs], -1).movedim(0, -1)
    if n.op == "eigh":
        return _plain_eigh(args[0].movedim(-1, 0)).movedim(0, -1)
    if n.op == "cumprod":
        return torch.cumprod(args[0], n.params[0])
    if n.op == "logcumsumexp":
        return torch.logcumsumexp(args[0], n.params[0])
    if n.op in ("lufactor", "lu_p", "qr", "svd", "mexp"):
        return _plain_factor(n, args[0].movedim(-1, 0), dtype).movedim(0, -1)
    if n.op == "cumarg":  # the last index of the running extreme
        axis, sign = n.params
        return (torch.cummax if sign > 0 else torch.cummin)(
            args[0], axis).indices
    if n.op == "scatter_reduce_chain":  # by per-chain flat positions
        base, k, src = args
        reduce, include_self = n.params
        c = max(a.shape[-1] for a in args)
        numel = n.shape[0]
        k = _clamped(k, numel).reshape(-1, k.shape[-1]).expand(-1, c)
        return base.expand(numel, c).scatter_reduce(
            0, k, src.reshape(-1, src.shape[-1]).expand(-1, c), reduce,
            include_self=include_self)
    if n.op == "scatter_put":  # out[k[t]] = src[t], the last t winning
        base, k, src = args
        c = max(a.shape[-1] for a in args)
        numel = n.shape[0]
        k = _clamped(k, numel).reshape(-1, k.shape[-1]).expand(-1, c)
        t = torch.arange(k.shape[0], device=dev)[:, None].expand(-1, c)
        win = torch.full((numel, c), -1, dtype=torch.int64,
                         device=dev).scatter_reduce(0, k, t, "amax")
        src = src.reshape(-1, src.shape[-1]).expand(-1, c)
        picked = torch.gather(src, 0, win.clamp(min=0))
        return torch.where(win >= 0, picked, base.expand(numel, c))
    if n.op == "trsolve":
        upper, unit = n.params
        A, B = (a.movedim(-1, 0) for a in args)  # (C or 1, batch, n, *)
        return torch.linalg.solve_triangular(
            A, B, upper=upper, unitriangular=unit).movedim(0, -1)
    if n.op == "lusolve":  # LAPACK's getrf (partial pivoting) and getrs
        A, B = (a.movedim(-1, 0) for a in args)  # (C or 1, batch, n, *)
        c = max(A.shape[0], B.shape[0])
        LU, pivots = torch.linalg.lu_factor(
            A.expand(c, B.shape[1], *A.shape[2:]))
        return torch.linalg.lu_solve(LU, pivots,
                                     B.expand(c, *B.shape[1:])).movedim(0, -1)
    if n.op == "cumsum":
        return torch.cumsum(args[0], n.params[0])
    if n.op == "pad_slice":
        axis, start, step = n.params
        a = args[0]
        v = torch.zeros((*n.shape, a.shape[-1]), dtype=dtype, device=dev)
        index = [slice(None)] * axis + [
            slice(start, start + a.shape[axis] * step, step)]
        v[tuple(index)] = a
        return v
    if n.op == "pad_select":
        axis, index = n.params
        a = args[0]
        v = torch.zeros((*n.shape, a.shape[-1]), dtype=dtype, device=dev)
        v.select(axis, index).copy_(a)
        return v
    if n.op == "cat":
        c = max(a.shape[-1] for a in args)
        return torch.cat([a.expand(*a.shape[:-1], c) for a in args],
                         dim=n.params[0])
    if n.op == "sum":
        axes, keepdim = n.params
        return args[0].sum(dim=axes, keepdim=keepdim) if axes else args[0]
    if n.op == "amax":
        axes, keepdim = n.params
        return args[0].amax(dim=axes, keepdim=keepdim)
    if n.op == "prod":
        axes, keepdim = n.params
        x = args[0]
        for a in sorted(axes, reverse=True):
            x = x.prod(dim=a, keepdim=keepdim)
        return x
    if n.op == "mm":
        a, b = args
        c = max(a.shape[-1], b.shape[-1])
        return torch.einsum("mkc,knc->mnc", a.expand(*a.shape[:-1], c),
                            b.expand(*b.shape[:-1], c))
    return _plain_op(n, args, dtype)


def run_plain(ir: IR, q_t: torch.Tensor, data: Sequence[torch.Tensor],
              stats: Optional[dict] = None):
    """The plain version of the generated functor: ``(u (1, C), g (dim,
    C))`` of ``q_t (dim, C)`` with the data operands ``data`` (the caller's,
    then the hoisted constants, then, if not given, the derived index rows,
    evaluated here: :func:`derived_operands`), interpreting the IR with
    torch ops in ``q_t``'s dtype on its device.  A value carries the chain
    axis last, of size C, or 1 where it does not depend on the chain.  With
    ``stats`` a dict, ``stats["workspace_floats"]`` receives the floats of
    the workspace the schedule stores a chain (:func:`schedule`)."""
    dtype, dev = q_t.dtype, q_t.device
    dim, num_chains = q_t.shape
    if dim != ir.dim:
        raise ValueError(f"q_t has {dim} rows; the potential was traced at "
                         f"dim {ir.dim}")
    data = all_operands(ir, data)
    vals = []
    for n in ir.nodes:
        args = [vals[a] for a in n.args]
        if n.op == "q":
            v = q_t
        elif n.op == "data":
            v = data[n.params[0]].to(
                device=dev, dtype=torch.int64 if n.dtype == "i" else dtype
            ).reshape(*n.shape, 1)
        else:
            v = _plain_node(n, args, dtype, dev)
        vals.append(v)
    if stats is not None:
        stats["workspace_floats"] = schedule(ir).workspace
    u = vals[ir.u].reshape(1, -1).expand(1, num_chains).contiguous()
    g = vals[ir.g].reshape(dim, -1).expand(dim, num_chains).contiguous()
    return u, g


# -------------------------------------------------- host-evaluated rows --

def _template(x, ids):
    """``x`` with each IR id replaced by ``("__t", k)`` (its place in
    ``ids``, appended) and each list by ``("__l", items)``: hashable."""
    if isinstance(x, _Id):
        ids.append(x)
        return ("__t", len(ids) - 1)
    if isinstance(x, (list, tuple)):
        return ("__l", tuple(_template(e, ids) for e in x))
    return x


def _untemplate(x, vals):
    if isinstance(x, tuple) and len(x) == 2 and x[0] == "__t":
        return vals[x[1]]
    if isinstance(x, tuple) and len(x) == 2 and x[0] == "__l":
        return [_untemplate(e, vals) for e in x[1]]
    return x


def _index_positions(vals, shape, template):
    """The flat positions ``x[indices]`` reads in an array of ``shape``."""
    indices = [slice(None) if i is None else i   # aten's None: a whole axis
               for i in _untemplate(template, vals)]
    return torch.arange(math.prod(shape)).reshape(shape)[tuple(indices)]


def _axis_positions(vals, shape, axis):
    """The flat positions ``torch.gather(x, axis, index)`` reads (and
    ``scatter`` writes) in an array of ``shape``."""
    (index,) = vals
    check_index(index, shape[axis])
    if index.numel() and int(index.min()) < 0:
        raise IndexError(f"index {int(index.min())} is out of bounds for a "
                         "gather or scatter (negative)")
    coords = list(torch.meshgrid(*[torch.arange(s) for s in index.shape],
                                 indexing="ij"))
    coords[axis] = index
    return sum(k * st for k, st in zip(coords, _strides(shape)))


def _scatter_positions(vals, shape, axis):
    """The flat positions in an array of ``shape`` that a scatter-add along
    ``axis`` by ``vals[0]`` (of any shape) adds its values to, in the
    values' order: the index wrapped as ``gpg_wrap`` wraps it on the card,
    through :func:`_axis_positions` on the array seen as (before, axis,
    after)."""
    (index,) = vals
    length = shape[axis]
    check_index(index, length)
    index = torch.where(index < 0, index + length, index).reshape(1, -1, 1)
    outer = (math.prod(shape[:axis]), length, math.prod(shape[axis + 1:]))
    index = index.expand(outer[0], index.shape[1], outer[2])
    return _axis_positions([index], outer, 1).reshape(-1)


def _inverse(vals, numel, uniform=False):
    """Position -> the written value's flat index, or -1, of a writing
    scatter at the flat positions ``vals[0]``; a duplicate position raises
    ``ValueError`` unless every value written is one constant
    (``uniform``)."""
    flat = vals[0].reshape(-1)
    if not uniform and flat.unique().numel() != flat.numel():
        raise ValueError(
            "a writing scatter (index_put without accumulate, x[idx] = v, or "
            "torch.scatter) holds a duplicate index; torch and JAX leave the "
            "winner of a duplicate unspecified, so the generated functor "
            "refuses it (accumulate with index_put(accumulate=True) or "
            "index_add instead)")
    inv = torch.full((numel,), -1, dtype=torch.int64)
    inv[flat] = torch.arange(flat.numel())
    return inv


def _preimage(vals, numel):
    """The inputs that land on each output of a reducing scatter at the
    flat positions ``vals[0]``: ``numel + 1`` offsets, then the inputs'
    indices by output, each output's in input order."""
    flat = vals[0].reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=numel)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         torch.cumsum(counts, 0)])
    return torch.cat([offsets, order])


def _axis_offsets(vals, shape, ishape, axis):
    """The flat offsets in an array of ``shape`` of an index of ``ishape``'s
    coordinates off ``axis`` (a scatter along ``axis`` adds the index's own
    coordinate times its stride)."""
    coords = torch.meshgrid(*[torch.arange(s) for s in ishape], indexing="ij")
    return sum((k * st for a, (k, st) in enumerate(zip(coords,
                                                       _strides(shape)))
                if a != axis), torch.zeros(ishape, dtype=torch.int64))


def _arange(vals, n, start=0):
    return torch.arange(start, start + n)


_HOST_FNS = {"index_positions": _index_positions, "arange": _arange,
             "axis_offsets": _axis_offsets,
             "axis_positions": _axis_positions, "inverse": _inverse,
             "preimage": _preimage, "scatter_positions": _scatter_positions}


def _host_op(n: Node, vals, dtype=torch.float32):
    kind, name, *rest = n.params
    if kind == "fn":
        return _HOST_FNS[name](vals, *rest)
    ns, packet, overload = name.split(".")
    op = getattr(getattr(getattr(torch.ops, ns), packet), overload)
    targs, tkw, item = rest
    kw = {k: _untemplate(v, vals) for k, v in tkw}
    if kw.get("dtype") == torch.float32:  # the evaluation's float type
        kw["dtype"] = dtype
    out = op(*_untemplate(targs, vals), **kw)
    return out if item is None else out[item]


def _host_eval(nodes, nid, operands, memo, dtype=torch.float32):
    """The value, on the CPU and without a chain axis, of node ``nid`` of
    ``nodes`` that depends on the data alone, its floats in ``dtype``."""
    if nid in memo:
        return memo[nid]
    n = nodes[nid]
    args = [_host_eval(nodes, a, operands, memo, dtype) for a in n.args]
    if n.op == "data":
        v = operands[n.params[0]].detach().cpu().reshape(n.shape)
        v = v.to(torch.int64) if v.dtype in INT_DTYPES else v.to(dtype)
    elif n.op == "derived":
        v = args[0]
    elif n.op == "host":
        v = _host_op(n, args, dtype)
    else:
        v = _plain_node(n, [a.unsqueeze(-1) for a in args], dtype,
                        torch.device("cpu"))[..., 0]
    memo[nid] = v
    return v


def _closure(nodes, roots, stop=()):
    """The ids reached from ``roots`` through their arguments, not going
    past nodes whose op is in ``stop``."""
    seen, stack = set(), list(roots)
    while stack:
        i = stack.pop()
        if i not in seen:
            seen.add(i)
            if nodes[i].op not in stop:
                stack.extend(nodes[i].args)
    return seen


def derived_operands(ir: IR, operands) -> tuple:
    """The derived rows of ``ir`` (on the CPU) from the base operands (the
    caller's data, then the constants), evaluated on the host: index rows
    as int64; float rows (folded values of the data) in float64, to be
    rounded to float32 once.  ``IndexError`` for an index outside its axis,
    ``ValueError`` for a duplicate in a writing scatter or a row whose
    shape differs from the traced one (a bool mask that now selects
    another count)."""
    memo, memo64, out = {}, {}, []
    base = ir.num_base_data
    for root, shape, kind in zip(ir.derived, ir.data_shapes[base:],
                                 ir.data_kinds[base:]):
        if kind == "f":
            v = _host_eval(ir.host_nodes, root, operands, memo64,
                           torch.float64).to(torch.float64)
        else:
            v = _host_eval(ir.host_nodes, root, operands, memo)
        if tuple(v.shape) != shape:
            raise ValueError(
                f"an index row computed from the data (a bool mask's "
                f"positions, or index arithmetic) now has shape "
                f"{tuple(v.shape)}; the potential was traced with {shape}: "
                "a mask that selects another count needs a new trace")
        out.append(v if kind == "f" else v.to(torch.int64))
    return tuple(out)


def all_operands(ir: IR, operands) -> tuple:
    """``operands`` with the derived index rows after them, unless given."""
    operands = tuple(operands)
    if len(operands) == len(ir.data_shapes):
        return operands
    if len(operands) != ir.num_base_data:
        raise ValueError(f"{len(operands)} data operands for "
                         f"{ir.num_base_data}")
    return operands + derived_operands(ir, operands)


def _clamped(k: torch.Tensor, length: int, flat=False) -> torch.Tensor:
    """A per-chain index, wrapped if negative and clamped into ``[0,
    length)`` (JAX's gather; torch would raise)."""
    k = torch.where(k < 0, k + length, k).clamp(0, length - 1)
    return k.reshape(-1) if flat else k


def _plain_eigh(A):
    """Eigenvalues (ascending) and eigenvectors of the symmetric ``A (*, n,
    n)`` (its lower triangle), each eigenvector's largest component (the
    first of equals) made positive, as ``(*, n + 1, n)``: the eigenvalues,
    then the eigenvectors as columns; NaN for a matrix with a non-finite
    element."""
    finite = torch.isfinite(A).all(-1).all(-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    w, V = torch.linalg.eigh(torch.where(finite[..., None, None], A, eye))
    at = V.abs().argmax(dim=-2, keepdim=True)
    V = V * torch.where(torch.gather(V, -2, at) < 0, -1.0, 1.0).to(V.dtype)
    out = torch.cat([w.unsqueeze(-2), V], -2)
    return torch.where(finite[..., None, None], out, math.nan)


def _plain_factor(n: Node, A, dtype):
    """The factorisation nodes' plain versions, chain axis first: getrf's
    LU with its 1-based pivots as a last row, P from the pivots, the
    reduced QR (Q over R), the SVD (U, the singular values, V; U's columns
    (V's, for A^T) each with its largest component, the first of equals,
    positive, the other factor flipped with it) and the matrix
    exponential."""
    if n.op == "lufactor":
        LU, piv = torch.linalg.lu_factor(A)
        return torch.cat([LU, piv.to(A.dtype).unsqueeze(-2)], -2)
    if n.op == "lu_p":
        piv = A.round().to(torch.int32)
        size = piv.shape[-1]
        return torch.lu_unpack(torch.zeros(*piv.shape, size, dtype=dtype,
                                           device=A.device), piv,
                               unpack_data=False)[0]
    if n.op == "qr":
        return torch.cat(torch.linalg.qr(A, mode="reduced"), -2)
    if n.op == "svd":
        U, S, Vh = torch.linalg.svd(A, full_matrices=False)
        V = Vh.mT
        fixed = V if n.params[0] else U
        at = fixed.abs().argmax(dim=-2, keepdim=True)
        flip = torch.where(torch.gather(fixed, -2, at) < 0, -1.0, 1.0).to(
            A.dtype)
        return torch.cat([U * flip, S.unsqueeze(-2), V * flip], -2)
    return torch.linalg.matrix_exp(A.contiguous())


def _wrapped(k: torch.Tensor, length: int) -> torch.Tensor:
    """An index operand's values, flat, checked and wrapped into ``[0,
    length)``."""
    k = k.reshape(-1)
    check_index(k, length)
    return torch.where(k < 0, k + length, k)


# ------------------------------------------------------------- schedule --

class Schedule(NamedTuple):
    """Where each materialised node lives (``slots``: node -> workspace
    offset; ``registers``: nodes held in a register) and the workspace
    floats a chain."""
    slots: dict
    registers: frozenset
    workspace: int


def _numel(shape):
    return math.prod(shape)


def _is_compute(n: Node) -> bool:
    return n.op not in VIEWS and n.op not in ("q", "data", "const")


def _reduction_length(ir, n: Node) -> int:
    if n.op == "mm":
        return ir.nodes[n.args[0]].shape[1]
    axes = n.params[0]
    shape = ir.nodes[n.args[0]].shape
    return _numel(tuple(shape[a] for a in axes))


def _through_views(ir, nid):
    while ir.nodes[nid].op in VIEWS:
        nid = ir.nodes[nid].args[0]
    return nid


def _cost(ir, nid, stored, memo):
    """Ops of a node's virtual subtree."""
    if nid in memo:
        return memo[nid]
    n = ir.nodes[nid]
    if nid in stored or n.op in ("q", "data", "const"):
        c = 0
    else:
        c = (1 if _is_compute(n) else 0) + (
            4 if n.op in TRANSCENDENTAL else 0) + sum(
                _cost(ir, a, stored, memo) for a in n.args)
    memo[nid] = c
    return c


def _virtual_deps(ir, args, stored):
    """Stored nodes reached from ``args`` through virtual nodes, and the
    virtual compute nodes on the way."""
    seen, deps, virt = set(), set(), set()
    stack = list(args)
    while stack:
        a = stack.pop()
        if a in seen:
            continue
        seen.add(a)
        if a in stored:
            deps.add(a)
            continue
        n = ir.nodes[a]
        if _is_compute(n):
            virt.add(a)
        stack.extend(n.args)
    return deps, virt


def _every_lane_reads(n: Node) -> bool:
    """Whether every lane of the warp reads each of node ``n``'s values: a
    scatter by an index computed on the card walks them all in each lane
    (one through the host's preimage row reads each once, in its output's
    lane), and a sort ranks each against all."""
    return n.op in ("scatter_put", "scatter_reduce_chain", "sortidx") or (
        n.op == "scatter_add" and len(n.args) == 3)


def _stored_nodes(ir) -> set:
    """The nodes the functor materialises (registers or workspace)."""
    stored = set()
    for i, n in enumerate(ir.nodes):
        if n.op in CONTRACTIONS or n.op in SEQUENTIAL or (
                _is_compute(n) and _numel(n.shape) == 1):
            stored.add(i)
    for i, n in enumerate(ir.nodes):
        if _every_lane_reads(n):
            base = _through_views(ir, n.args[0 if n.op == "sortidx"
                                           else 2])
            if _is_compute(ir.nodes[base]):
                stored.add(base)
        if n.op != "mm":
            continue
        (m, _), (_, ncols) = ir.nodes[n.args[0]].shape, ir.nodes[n.args[1]].shape
        for operand, reread in zip(n.args, (ncols > 1, m > 1)):
            base = _through_views(ir, operand)
            if reread and _is_compute(ir.nodes[base]):
                stored.add(base)
    while True:  # nodes shared by several loops, when dear to recompute
        roots = sorted(stored) + [ir.g]
        readers = {}
        for r in roots:
            _, virt = _virtual_deps(ir, ir.nodes[r].args, stored)
            for v in virt:
                readers.setdefault(v, set()).add(r)
        memo = {}
        shared = {v for v, rs in readers.items()
                  if len(rs) > 1 and _cost(ir, v, stored, memo) > SHARE_COST}
        if not shared:
            return stored
        stored |= {min(shared)}


def _sort_width(length: int) -> int:
    """The bitonic network's width over an axis of ``length``, or 0 where
    the warp ranks the axis by counting (at most 32 elements)."""
    return 0 if length <= 32 else 1 << (length - 1).bit_length()


def _mexp_group(size: int, batch: int) -> int:
    """Matrix exponentials of ``size`` x ``size`` a warp pass: as many as
    the 32 lanes hold an element each of (two 4 x 4 matrices, three 3 x 3),
    at most the batch; one from 6 x 6."""
    return max(1, min(batch, 32 // (size * size)))


def _scratch(ir, n: Node) -> int:
    """Workspace floats a sequential node keeps after its output: an LU's
    factors and pivots, a Jacobi's matrix and eigenvectors, a bitonic
    sort's keys and indices."""
    if n.op in ("lusolve", "slogdet"):  # the LU and its pivots
        size = ir.nodes[n.args[0]].shape[-1]
        return size * size + size
    if n.op == "eigh":
        return 2 * n.shape[-1] ** 2
    if n.op == "sortidx":
        return 2 * _sort_width(ir.nodes[n.args[0]].shape[n.params[0]])
    if n.op in ("qr", "svd"):  # the working copy; tau, or V and the norms
        _, m, k = ir.nodes[n.args[0]].shape
        return m * k + (k if n.op == "qr" else k * k + k)
    if n.op == "mexp":  # a pass's A, A^2, A^3, A^6, five combinations, a
        size = n.shape[-1]  # product
        return _mexp_group(size, n.shape[0]) * 10 * size * size
    if n.op == "scatter_reduce_chain":  # each output's count
        return n.shape[0]
    return 0


def schedule(ir: IR) -> Schedule:
    stored = _stored_nodes(ir)
    slots, offset, registers = {}, 0, set()
    for i in sorted(stored):
        size = _numel(ir.nodes[i].shape) + _scratch(ir, ir.nodes[i])
        if size == 1 and ir.nodes[i].op not in SEQUENTIAL:
            registers.add(i)
        else:
            slots[i] = offset
            offset += size
    return Schedule(slots, frozenset(registers), offset)


# --------------------------------------------------------- CUDA back end --

class Ix(NamedTuple):
    """An int index expression of C and the exclusive bound of its value."""
    expr: str
    bound: int

    @property
    def const(self):
        return self.expr.isdigit()


def _ic(v: int) -> Ix:
    return Ix(str(v), v + 1)


def _iadd(a: Ix, b: Ix) -> Ix:
    if a.const and b.const:
        return _ic(int(a.expr) + int(b.expr))
    if a.expr == "0":
        return b
    if b.expr == "0":
        return a
    return Ix(f"({a.expr} + {b.expr})", a.bound + b.bound - 1)


def _imul(a: Ix, k: int) -> Ix:
    if k == 0 or a.expr == "0":
        return _ic(0)
    if k == 1:
        return a
    if a.const:
        return _ic(int(a.expr) * k)
    return Ix(f"({a.expr} * {k})", (a.bound - 1) * k + 1)


def _idiv(a: Ix, k: int) -> Ix:
    if k == 1:
        return a
    if a.bound <= k:
        return _ic(0)
    if a.const:
        return _ic(int(a.expr) // k)
    return Ix(f"({a.expr} / {k})", (a.bound - 1) // k + 1)


def _imod(a: Ix, k: int) -> Ix:
    if k == 1:
        return _ic(0)
    if a.bound <= k:
        return a
    if a.const:
        return _ic(int(a.expr) % k)
    return Ix(f"({a.expr} % {k})", k)


def _strides(shape):
    out, s = [], 1
    for d in reversed(shape):
        out.append(s)
        s *= d
    return tuple(reversed(out))


def _unflatten(flat: Ix, shape) -> tuple:
    return tuple(_imod(_idiv(flat, st), d)
                 for st, d in zip(_strides(shape), shape))


def _flatten(idx, shape) -> Ix:
    out = _ic(0)
    for i, st in zip(idx, _strides(shape)):
        out = _iadd(out, _imul(i, st))
    return out


def _literal(x: float) -> str:
    if math.isnan(x):
        return "__int_as_float(0x7fc00000)"
    if math.isinf(x):
        return "__int_as_float(0x7f800000)" if x > 0 else \
            "__int_as_float(0xff800000)"
    if x == int(x) and abs(x) < 2 ** 24:
        return f"{int(x)}.f"
    return f"{float(x).hex()}f"


def _pow_formula(a, e):
    special = {2.0: f"({a} * {a})", 3.0: f"(({a} * {a}) * {a})",
               0.5: f"sqrtf({a})", -0.5: f"(1.f / sqrtf({a}))",
               -1.0: f"(1.f / {a})", -2.0: f"(1.f / ({a} * {a}))",
               0.0: "1.f"}
    return special.get(e, f"powf({a}, {_literal(e)})")


def _formula(n: Node, a) -> str:
    op = n.op
    unary = {"neg": "(-{0})", "abs": "fabsf({0})", "exp": "expf({0})",
             "expm1": "expm1f({0})", "log": "logf({0})",
             "log1p": "log1pf({0})", "sqrt": "sqrtf({0})",
             "rsqrt": "(1.f / sqrtf({0}))", "tanh": "tanhf({0})",
             "sigmoid": "(1.f / (1.f + expf(-{0})))",
             "sign": "gpg_sign({0})", "reciprocal": "(1.f / {0})",
             "relu": "gpg_relu({0})", "sin": "sinf({0})", "cos": "cosf({0})",
             "not": "(({0}) == 0.f ? 1.f : 0.f)", "float": "(float)({0})",
             "atan": "atanf({0})", "lgamma": "lgammaf({0})",
             "digamma": "gpg_digamma({0})", "erf": "erff({0})",
             "erfc": "erfcf({0})", "erfcx": "erfcxf({0})",
             "log_ndtr": "gpg_log_ndtr({0})",
             "isnan": "({0} != {0} ? 1.f : 0.f)",
             "log_sigmoid": "gpg_log_sigmoid({0})",
             "erfinv": "erfinvf({0})", "i0e": "gpg_i0e({0})",
             "i1e": "gpg_i1e({0})", "i0": "gpg_i0({0})", "i1": "gpg_i1({0})"}
    if op in unary:
        return unary[op].format(*a)
    simple = {"add": "({0} + {1})", "sub": "({0} - {1})", "mul": "({0} * {1})",
              "div": "({0} / {1})", "maximum": "gpg_max({0}, {1})",
              "minimum": "gpg_min({0}, {1})",
              "and": "(({0}) != 0.f && ({1}) != 0.f ? 1.f : 0.f)",
              "or": "(({0}) != 0.f || ({1}) != 0.f ? 1.f : 0.f)",
              "where": "(({0}) != 0.f ? {1} : {2})",
              "logaddexp": "gpg_logaddexp({0}, {1})",
              "powt": "powf({0}, {1})",
              "xlogy": "gpg_xlogy({0}, {1})",
              "xlog1py": "gpg_xlog1py({0}, {1})",
              "atan2": "atan2f({0}, {1})",
              "log_sigmoid_backward": "gpg_log_sigmoid_backward({0}, {1})",
              "sigmoid_backward": "(({0} * (1.f - {1})) * {1})",
              "tanh_backward": "({0} * (1.f - {1} * {1}))"}
    if op in simple:
        return simple[op].format(*a)
    if op in COMPARISONS:
        return f"({a[0]} {COMPARISONS[op]} {a[1]} ? 1.f : 0.f)"
    if op == "floordiv":
        return f"floorf({a[0]} / {a[1]})"
    if op == "truncdiv":
        return f"truncf({a[0]} / {a[1]})"
    if op == "remainder":
        return f"gpg_remainder({a[0]}, {a[1]})"
    if op == "iclamp":
        return f"(float)gpg_index({a[0]}, {n.params[0]})"
    if op == "clamp_min":
        return f"gpg_clamp_min({a[0]}, {_literal(n.params[0])})"
    if op == "clamp_max":
        return f"gpg_clamp_max({a[0]}, {_literal(n.params[0])})"
    if op == "pow":
        return _pow_formula(a[0], n.params[0])
    if op == "rpow":
        return f"powf({_literal(n.params[0])}, {a[0]})"
    if op == "softplus":
        return (f"gpg_softplus({a[0]}, {_literal(n.params[0])}, "
                f"{_literal(n.params[1])})")
    if op == "softplus_backward":
        return (f"gpg_softplus_backward({a[0]}, {a[1]}, "
                f"{_literal(n.params[0])}, {_literal(n.params[1])})")
    if op == "threshold_backward":
        return f"({a[1]} <= {_literal(n.params[0])} ? 0.f : {a[0]})"
    if op in ("logit", "logit_backward"):
        lo, hi = n.params if n.params else (-1.0, 2.0)  # none: no clamp
        bounds = f"{_literal(lo)}, {_literal(hi)}, {_cbool(bool(n.params))}"
        if op == "logit":
            return f"gpg_logit({a[0]}, {bounds})"
        return f"gpg_logit_backward({a[0]}, {a[1]}, {bounds})"
    if op == "polygamma":
        k = n.params[0]
        return (f"gpg_trigamma({a[0]})" if k == 1
                else f"gpg_polygamma({a[0]}, {k})")
    raise AssertionError(op)


def _cbool(b: bool) -> str:
    return "true" if b else "false"


def _affine(ir, nid):
    """``(operand, offset, strides)`` of a node that is a chain of views
    (reshape, permute, expand, slice, select) of a float data operand: the
    flat element of the operand that index ``idx`` of the node reads is
    ``offset + Σ strides[a] idx[a]``; None for any other node."""
    n = ir.nodes[nid]
    if n.op == "data":
        j = n.params[0]
        return (j, 0, _strides(n.shape)) if ir.data_kinds[j] == "f" else None
    if n.op not in ("reshape", "permute", "expand", "slice", "select"):
        return None
    inner = _affine(ir, n.args[0])
    if inner is None:
        return None
    j, off, st = inner
    src = ir.nodes[n.args[0]].shape
    if n.op == "permute":
        return j, off, tuple(st[a] for a in n.params)
    if n.op == "expand":
        lead = len(n.shape) - len(src)
        return j, off, (0,) * lead + tuple(
            0 if s == 1 else st[k] for k, s in enumerate(src))
    if n.op == "slice":
        axis, start, step = n.params
        st = list(st)
        off += start * st[axis]
        st[axis] *= step
        return j, off, tuple(st)
    if n.op == "select":
        axis, index = n.params
        return j, off + index * st[axis], st[:axis] + st[axis + 1:]
    out_axes = [k for k, d in enumerate(n.shape) if d != 1]
    in_axes = [k for k, d in enumerate(src) if d != 1]
    if [n.shape[k] for k in out_axes] == [src[k] for k in in_axes]:
        out = [0] * len(n.shape)
        for ko, ki in zip(out_axes, in_axes):
            out[ko] = st[ki]
        return j, off, tuple(out)
    dense = _strides(src)
    if all(st[k] == dense[k] for k in in_axes):  # row-major: re-split
        return j, off, _strides(n.shape)
    return None


def _pow2(n: int) -> int:
    """The least power of 2 at least ``n``."""
    return 1 << (n - 1).bit_length()


def _accumulators(count, init, array):
    """Lines declaring ``count`` accumulators and the name of the u-th:
    one array ``acc`` (whose butterflies run at once) or ``acc0``, ..."""
    if array:
        vals = ", ".join([init] * count)
        return [f"float acc[{count}] = {{{vals}}};"], (lambda u: f"acc[{u}]")
    return ([f"float acc{u} = {init};" for u in range(count)],
            lambda u: f"acc{u}")


def _rows_scaled(unit):
    """The chunk's rows [c0, c1) in elements of ``unit`` a row."""
    if unit == 1:
        return "c0", "c1"
    return f"c0 * {unit}", f"c1 * {unit}"


class RowAccess(NamedTuple):
    """How a matrix product's 2-D operand reads a streamed operand: row
    ``index[axis]`` of the operand (``row`` floats a row, all ``rows`` of
    them along ``axis``), column ``col0 + col_step * index[1 - axis]``."""
    operand: int
    axis: int
    row: int
    rows: int
    col0: int
    col_step: int


def _row_access(ir, nid, axis) -> Optional[RowAccess]:
    """The :class:`RowAccess` of 2-D node ``nid`` along ``axis`` when its
    index along ``axis`` walks every row of a float data operand in order
    and its other index stays inside the row; else None."""
    aff = _affine(ir, nid)
    shape = ir.nodes[nid].shape
    if aff is None or len(shape) != 2:
        return None
    j, off, st = aff
    length = _numel(ir.data_shapes[j])
    row, other = st[axis], 1 - axis
    if row <= 0 or length % row or length // row != shape[axis]:
        return None
    if off < 0 or st[other] < 0 or off + st[other] * (shape[other] - 1) \
            >= row:
        return None
    return RowAccess(j, axis, row, shape[axis], off, st[other])


def _stream_reads(ir, nid, along):
    """{argument position: RowAccess} of matrix product ``nid`` whose rows
    walk a data operand's rows ``along`` its output ("out": A's rows, each
    a run of the output's columns; B's columns when A is one row) or its
    sum ("sum": A's columns, B's rows)."""
    n = ir.nodes[nid]
    if n.op != "mm":
        return {}
    a, b = n.args
    m = ir.nodes[a].shape[0]
    if along == "out":
        cands = [(0, a, 0)] + ([(1, b, 1)] if m == 1 else [])
    else:
        cands = [(0, a, 1), (1, b, 0)]
    out = {}
    for pos, arg, axis in cands:
        acc = _row_access(ir, arg, axis)
        if acc is not None:
            out[pos] = acc
    return out


class _Scope:
    def __init__(self, emitter, memo=None):
        self.emitter = emitter
        self.lines = []
        self.memo = dict(memo or {})

    def temp(self, expr: str, ctype: str = "float") -> str:
        name = self.emitter.fresh("t")
        self.lines.append(f"const {ctype} {name} = {expr};")
        return name


class _Emitter:
    def __init__(self, ir: IR, sched: Schedule, geometry=None):
        self.ir, self.sched = ir, sched
        self.counter = 0
        self.stored = set(sched.slots) | set(sched.registers)
        self.geometry = geometry
        self.resident = {j for j, *_ in geometry.resident} if geometry \
            else set()
        # the streamed operands: operand -> (row floats, row stride)
        self.streamed = ({j: (r, rs) for j, r, rs in geometry.streamed}
                         if geometry else {})
        self.reads = {}  # in a chunk's body: (product, arg) -> RowAccess
        self.window = 0  # in a window pass: the tile's row stride
        # floats a chain of factor scratch (0: none), the LU users
        self.fs = geometry.factor_floats if geometry else 0
        self.lu_users = _lu_owners(ir)
        self.lu_owners = set(self.lu_users.values())

    def fresh(self, prefix):
        self.counter += 1
        return f"{prefix}{self.counter}"

    def uses_factor(self, nid) -> bool:
        """Whether node ``nid`` works in the factor scratch."""
        return 0 < _factor_need(self.ir, nid) <= self.fs

    # -- values
    def load(self, nid, idx):
        n = self.ir.nodes[nid]
        if nid in self.sched.registers:
            return f"r{nid}"
        off = _flatten(idx, n.shape)
        if n.op == "q":
            return f"qc[{off.expr}]"
        if n.op == "data":
            j = n.params[0]
            if j in self.resident:
                return f"R{j}[{off.expr}]"
            return f"__ldg(D{j} + {off.expr})"
        return f"ws[{self.sched.slots[nid]} + {off.expr}]"

    def slot(self, nid, flat: Ix) -> str:
        """The workspace element ``flat`` of stored node ``nid``."""
        return f"ws[{self.sched.slots[nid]} + {flat.expr}]"

    def value(self, nid, idx, scope: _Scope) -> str:
        key = (nid, tuple(i.expr for i in idx))
        if key in scope.memo:
            return scope.memo[key]
        n = self.ir.nodes[nid]
        if nid in self.stored or n.op in ("q", "data"):
            e = self.load(nid, idx)
            if not e.startswith("r"):
                e = scope.temp(e, "int" if n.dtype == "i" else "float")
        else:
            e = self.compute(nid, idx, scope)
        scope.memo[key] = e
        return e

    def compute(self, nid, idx, scope) -> str:
        n = self.ir.nodes[nid]
        nodes = self.ir.nodes
        if n.op == "const":
            return _literal(n.params[0])
        if n.op == "reshape":
            src = nodes[n.args[0]].shape
            return self.value(n.args[0], _reshape_index(idx, n.shape, src),
                              scope)
        if n.op == "permute":
            inner = [None] * len(idx)
            for out_axis, in_axis in enumerate(n.params):
                inner[in_axis] = idx[out_axis]
            return self.value(n.args[0], tuple(inner), scope)
        if n.op == "expand":
            src = nodes[n.args[0]].shape
            lead = len(n.shape) - len(src)
            inner = tuple(_ic(0) if s == 1 else idx[lead + k]
                          for k, s in enumerate(src))
            return self.value(n.args[0], inner, scope)
        if n.op == "slice":
            axis, start, step = n.params
            inner = list(idx)
            inner[axis] = _iadd(_imul(idx[axis], step), _ic(start))
            return self.value(n.args[0], tuple(inner), scope)
        if n.op == "select":
            axis, index = n.params
            inner = list(idx[:axis]) + [_ic(index)] + list(idx[axis:])
            return self.value(n.args[0], tuple(inner), scope)
        if n.op == "flip":
            inner = list(idx)
            for a in n.params:
                size = n.shape[a]
                inner[a] = (_ic(size - 1 - int(idx[a].expr)) if idx[a].const
                            else Ix(f"({size - 1} - {idx[a].expr})", size))
            return self.value(n.args[0], tuple(inner), scope)
        if n.op == "gather":
            axis = n.params[0]
            x, index = n.args
            length = nodes[x].shape[axis]
            rank = len(nodes[index].shape)
            k = self.value(index, idx[axis:axis + rank], scope)
            fn = "gpg_index" if len(n.params) > 1 else "gpg_wrap"
            inner = (*idx[:axis], Ix(f"{fn}({k}, {length})", length),
                     *idx[axis + rank:])
            return self.value(x, inner, scope)
        if n.op == "take":
            axis = n.params[0]
            x, index = n.args
            length = nodes[x].shape[axis]
            k = self.value(index, idx, scope)
            inner = list(idx)
            inner[axis] = Ix(f"gpg_index({k}, {length})", length)
            return self.value(x, tuple(inner), scope)
        if n.op == "diagonal":
            offset, d1, d2 = n.params
            k = idx[-1]
            src = nodes[n.args[0]].shape
            rest = iter(idx[:-1])
            inner = []
            for a in range(len(src)):
                if a in (d1, d2):
                    shift = max(-offset, 0) if a == d1 else max(offset, 0)
                    inner.append(_iadd(k, _ic(shift)))
                else:
                    inner.append(next(rest))
            return self.value(n.args[0], tuple(inner), scope)
        if n.op == "band":
            d1, d2, lo, hi = n.params
            diff = f"({idx[d2].expr} - {idx[d1].expr})"
            conds = [f"{diff} >= {lo}"] if lo is not None else []
            conds += [f"{diff} <= {hi}"] if hi is not None else []
            return scope.temp(f"({' && '.join(conds) or 'true'}) ? 1.f : 0.f")
        if n.op == "diag_pad":
            offset, d1, d2 = n.params
            length = nodes[n.args[0]].shape[-1]
            i, j = idx[d1], idx[d2]
            k = i if offset >= 0 else Ix(f"({i.expr} + {offset})", i.bound)
            k = Ix(f"gpg_imin(gpg_imax({k.expr}, 0), {length - 1})", length)
            rest = [idx[a] for a in range(len(n.shape)) if a not in (d1, d2)]
            v = self.value(n.args[0], (*rest, k), scope)
            return scope.temp(f"({j.expr} - {i.expr} == {offset}) ? {v} : 0.f")
        if n.op == "pad_slice":
            axis, start, step = n.params
            length = nodes[n.args[0]].shape[axis]
            j = idx[axis]
            rel = j if start == 0 else Ix(f"gpg_imax({j.expr} - {start}, 0)",
                                          max(j.bound - start, 1))
            inner_j = _idiv(rel, step)
            if inner_j.bound > length:
                inner_j = Ix(f"gpg_imin({inner_j.expr}, {length - 1})", length)
            conds = []
            if start > 0:
                conds.append(f"{j.expr} >= {start}")
            if j.bound > start + (length - 1) * step + 1:
                conds.append(f"{j.expr} <= {start + (length - 1) * step}")
            if step > 1:
                conds.append(f"({j.expr} - {start}) % {step} == 0")
            inner = list(idx)
            inner[axis] = inner_j
            v = self.value(n.args[0], tuple(inner), scope)
            if not conds:
                return v
            return scope.temp(f"({' && '.join(conds)}) ? {v} : 0.f")
        if n.op == "pad_select":
            axis, index = n.params
            inner = idx[:axis] + idx[axis + 1:]
            v = self.value(n.args[0], inner, scope)
            return scope.temp(f"({idx[axis].expr} == {index}) ? {v} : 0.f")
        if n.op == "cat":
            axis = n.params[0]
            j = idx[axis]
            offset, pieces = 0, []
            for a in n.args:
                length = nodes[a].shape[axis]
                rel = j if offset == 0 else Ix(
                    f"gpg_imax({j.expr} - {offset}, 0)", max(j.bound - offset, 1))
                if rel.bound > length:
                    rel = Ix(f"gpg_imin({rel.expr}, {length - 1})", length)
                inner = list(idx)
                inner[axis] = rel
                pieces.append((offset + length,
                               self.value(a, tuple(inner), scope)))
                offset += length
            expr = pieces[-1][1]
            for end, v in reversed(pieces[:-1]):
                expr = f"({j.expr} < {end} ? {v} : {expr})"
            return scope.temp(expr)
        if n.op == "put":  # the value written at this position, or base
            base, inv, values = n.args
            k = self.value(inv, idx, scope)
            vshape = nodes[values].shape
            src = _unflatten(Ix(f"gpg_imax({k}, 0)", _numel(vshape)), vshape)
            v = self.value(values, src, scope)
            b = self.value(base, idx, scope)
            return scope.temp(f"({k} >= 0 ? {v} : {b})")
        if n.op == "pick":  # src where the index names this position
            base, index, src = n.args
            axis = n.params[0]
            inner = (*idx[:axis], _ic(0), *idx[axis + 1:])
            k = self.value(index, inner, scope)
            v = self.value(src, inner, scope)
            b = self.value(base, idx, scope)
            return scope.temp(f"((int)({k}) == {idx[axis].expr} ? {v} : {b})")
        if n.op in CONTRACTIONS or n.op in SEQUENTIAL:
            raise AssertionError("contractions are always stored")
        args = []
        for a in n.args:
            src = nodes[a].shape
            lead = len(n.shape) - len(src)
            inner = tuple(_ic(0) if s == 1 else idx[lead + k]
                          for k, s in enumerate(src))
            args.append(self.value(a, inner, scope))
        return scope.temp(_formula(n, args))

    # -- roots
    def signature(self, nid):
        """``("loop", n)``, ``("scalar",)`` or ``("warp_each", nid)``."""
        if nid == "g":
            return ("loop", self.ir.dim)
        n = self.ir.nodes[nid]
        if n.op in SEQUENTIAL:
            return (n.op, nid)
        if n.op in CONTRACTIONS:
            out = _numel(n.shape)
            red = _reduction_length(self.ir, n)
            if out == 1:
                return ("loop", red)
            if red <= 32 or (out >= 32 and self.coalesced(n)):
                return ("loop", out)
            return ("warp_each", nid)
        if _numel(n.shape) == 1:
            return ("scalar",)
        return ("loop", _numel(n.shape))

    def coalesced(self, n: Node) -> bool:
        """Whether one lane an output element reads a matrix product's
        operands at neighbouring addresses across the warp's lanes (else
        the warp takes each output in turn, its lanes along the sum)."""
        if n.op != "mm":
            return True
        a, b = n.args
        if self.ir.nodes[b].shape[1] > 1:
            step = _lane_stride(self.ir, b, 1, self.stored)
        else:
            step = _lane_stride(self.ir, a, 0, self.stored)
        return step is not None and step <= 1

    def emit_root(self, nid, flat: Ix, scope, after):
        """Statements of root ``nid`` at loop index ``flat`` into
        ``scope``; statements to run after the loop into ``after``."""
        ir = self.ir
        if nid == "g":
            v = self.value(ir.g, _unflatten(flat, (ir.dim,)), scope)
            scope.lines.append(f"gc[{flat.expr}] = {v};")
            return
        n = ir.nodes[nid]
        if n.op not in CONTRACTIONS:
            v = self.compute(nid, _unflatten(flat, n.shape), scope)
            if nid in self.sched.registers:
                scope.lines.append(f"const float r{nid} = {v};")
            else:
                scope.lines.append(f"ws[{self.sched.slots[nid]} + "
                                   f"{flat.expr}] = {v};")
            return
        out, red = _numel(n.shape), _reduction_length(ir, n)
        init, reduce = _ACCUMULATE[n.op]
        if out == 1:  # the warp reduces the whole contraction
            acc = f"a{nid}"
            scope.lines.append(self.term(nid, _ic(0), flat, scope, acc))
            after.append(("decl", f"float {acc} = {init};"))
            after.append(("post", f"const float r{nid} = {reduce}({acc});"))
            return
        acc = self.fresh("acc")
        scope.lines.append(f"float {acc} = {init};")
        scope.lines.append(f"for (int k = 0; k < {red}; ++k) {{")
        inner = _Scope(self, scope.memo)
        inner.lines.append(self.term(nid, flat, Ix("k", red), inner, acc))
        scope.lines.extend("  " + line for line in inner.lines)
        scope.lines.append("}")
        scope.lines.append(f"ws[{self.sched.slots[nid]} + {flat.expr}] = "
                           f"{acc};")

    def term(self, nid, out_flat: Ix, k: Ix, scope, acc) -> str:
        """``acc`` updated by term ``k`` of output element ``out_flat`` of
        contraction ``nid``, the operands' statements into ``scope``; in a
        chunk's body, a streamed operand read from the tile."""
        ir = self.ir
        n = ir.nodes[nid]
        if n.op == "mm":
            (m, kk), (_, ncols) = (ir.nodes[n.args[0]].shape,
                                   ir.nodes[n.args[1]].shape)
            i, j = _unflatten(out_flat, (m, ncols))
            a, b = ((self.tile_read(self.reads[(nid, pos)], idx, scope)
                     if (nid, pos) in self.reads else
                     self.value(n.args[pos], idx, scope))
                    for pos, idx in ((0, (i, k)), (1, (k, j))))
            return f"{acc} = fmaf({a}, {b}, {acc});"
        axes, keepdim = n.params
        src = ir.nodes[n.args[0]].shape
        kept = [d for a, d in enumerate(src) if a not in axes]
        out_idx = _unflatten(out_flat, tuple(kept))
        red_idx = _unflatten(k, tuple(src[a] for a in axes))
        idx, ko, kr = [], 0, 0
        for a in range(len(src)):
            if a in axes:
                idx.append(red_idx[kr])
                kr += 1
            else:
                idx.append(out_idx[ko])
                ko += 1
        v = self.value(n.args[0], tuple(idx), scope)
        if n.op == "amax":
            return f"{acc} = gpg_max({acc}, {v});"
        if n.op == "prod":
            return f"{acc} = {acc} * {v};"
        return f"{acc} = {acc} + {v};"

    def warp_each(self, nid, lines, unit=0):
        """The warp over the sum of each output of contraction ``nid``,
        WARP_OUTPUTS outputs at a time: their independent sums and
        ``warp_sum``s overlap (each output's order is that of one at a
        time); with ``unit`` outputs a row, the outputs of the chunk's rows
        [c0, c1) only."""
        n = self.ir.nodes[nid]
        out, red = _numel(n.shape), _reduction_length(self.ir, n)
        init, reduce = _ACCUMULATE[n.op]
        unroll = min(WARP_OUTPUTS, out)
        ragged = out % unroll != 0
        lo, hi = (_rows_scaled(unit) if unit else ("0", str(out)))
        together = reduce == "warp_sum"  # the sums' butterflies at once
        accs = _accumulators(unroll if not together else _pow2(unroll),
                             init, together)
        lines.append(f"for (int o0 = {lo}; o0 < {hi}; o0 += {unroll}) {{")
        lines.extend("  " + line for line in accs[0])
        lines.append(f"  for (int k = lane; k < {red}; k += 32) {{")
        scope = _Scope(self)
        for u in range(unroll):  # a ragged tail recomputes the last output
            o = (Ix(f"gpg_imin(o0 + {u}, {out - 1})", out) if ragged
                 else Ix(f"(o0 + {u})", out))
            scope.lines.append(self.term(nid, o, Ix("k", red), scope,
                                         accs[1](u)))
        lines.extend("    " + line for line in scope.lines)
        lines.append("  }")
        if together:
            lines.extend("  " + line for line in self.sums_store(
                nid, unroll, "o0", out if ragged else None))
        else:
            for u in range(unroll):
                guard = f" && o0 + {u} < {out}" if ragged else ""
                lines.append(f"  acc{u} = {reduce}(acc{u});")
                lines.append(f"  if (lane == 0{guard}) ws["
                             f"{self.sched.slots[nid]} + o0 + {u}] = acc{u};")
        lines.append("}")
        lines.append("__syncwarp();")

    def sums_store(self, nid, count, base, bound=None):
        """The butterflies of the ``count`` sums in ``acc`` at once
        (``gpg_warp_sums``: each sum's order of terms ``warp_sum``'s), and
        the stores of sum u at ``base + u`` (below ``bound``) by the first
        lane holding it."""
        width = _pow2(count)
        per = 32 // width
        u = "lane" if per == 1 else f"(lane / {per})"
        guards = ([] if per == 1 else [f"lane % {per} == 0"]) + (
            [f"{u} < {count}"] if count < width else []) + (
            [f"{base} + {u} < {bound}"] if bound is not None else [])
        cond = " && ".join(guards) or "true"
        return [f"const float sum = gpg_warp_sums<{width}>(acc, lane);",
                f"if ({cond}) ws[{self.sched.slots[nid]} + {base} + {u}] = "
                "sum;"]

    def groups(self):
        """Roots in groups: each loop group one lane-strided loop."""
        ir = self.ir
        roots = sorted(self.stored) + ["g"]
        group_of, groups = {}, []
        for r in roots:
            args = ir.nodes[r].args if r != "g" else (ir.g,)
            deps, _ = _virtual_deps(ir, args, self.stored)
            if r == "g" and ir.g in self.stored:
                deps = {ir.g}
            after = max((group_of[d] for d in deps), default=-1)
            sig = self.signature(r)
            placed = None
            if sig[0] in ("loop", "scalar"):
                for gi in range(after + 1, len(groups)):
                    if groups[gi][0] == sig:
                        placed = gi
                        break
            if placed is None:
                groups.append((sig, []))
                placed = len(groups) - 1
            groups[placed][1].append(r)
            group_of[r] = placed
        return groups

    # -- the tile: passes of top-level products over a streamed operand
    def passes(self, sig, roots, streamed):
        """The passes through the tile of a top-level group, each
        ``(kind, operand, roots, reads, unit)``, ``reads`` {(product,
        argument position): RowAccess}: kind "out" where the outputs walk
        the operand's rows, ``unit`` outputs a row (a warp-each product, or
        a loop group chunked along its index); "sum" where the group's
        one-lane-an-output products sum over them (chunk-major, each
        output's sum carried in its workspace slot); "lanes" where a
        warp-each product sums over them in its lanes (chunk-major over a
        window of ``unit`` outputs at a time, each lane's partial sums in
        registers across the chunks, the butterfly after the last).
        ``streamed``: operand -> row floats.  Only a warp-each or a loop
        group runs a pass: their trip counts are fixed, so their block
        barriers stand at the functor's top level (:meth:`chunk_loop`
        checks)."""
        ir = self.ir

        def take(nid, along):
            return {pos: a for pos, a in _stream_reads(ir, nid, along).items()
                    if streamed.get(a.operand) == a.row}

        def unit(nid, pos):  # output elements a row of the operand
            return ir.nodes[ir.nodes[nid].args[1]].shape[1] if pos == 0 \
                else 1

        if sig[0] == "warp_each":
            nid = roots[0]
            reads = take(nid, "out")
            if reads:
                pos = min(reads)
                return [("out", reads[pos].operand, roots,
                         {(nid, pos): reads[pos]}, unit(nid, pos))]
            node = ir.nodes[nid]
            if node.op != "mm":
                return []
            (m, _), (_, ncols) = (ir.nodes[node.args[0]].shape,
                                  ir.nodes[node.args[1]].shape)
            one = {0: ncols == 1, 1: m == 1}  # the output is A's or B's index
            reads = {pos: a for pos, a in take(nid, "sum").items()
                     if one[pos] and a.col_step == 1}
            if not reads:
                return []
            pos = min(reads)
            out = _numel(node.shape)
            width = -(-out // -(-out // WARP_OUTPUTS_WINDOW))
            return [("lanes", reads[pos].operand, roots,
                     {(nid, pos): reads[pos]}, width)]
        if sig[0] != "loop":
            return []
        products = [r for r in roots if r != "g" and ir.nodes[r].op == "mm"
                    and _numel(ir.nodes[r].shape) > 1]
        for r in products:  # the loop's index walks the rows
            if _numel(ir.nodes[r].shape) != sig[1]:
                continue
            for pos, acc in sorted(take(r, "out").items()):
                u = unit(r, pos)
                reads = {(r2, p2): a2 for r2 in products
                         if _numel(ir.nodes[r2].shape) == sig[1]
                         for p2, a2 in take(r2, "out").items()
                         if a2.operand == acc.operand and unit(r2, p2) == u}
                return [("out", acc.operand, roots, reads, u)]
        by = {}
        for r in products:  # one-lane-an-output sums over the rows
            reads = take(r, "sum")
            if reads:
                pos = min(reads)
                rs, rd = by.setdefault(reads[pos].operand, ([], {}))
                rs.append(r)
                rd[(r, pos)] = reads[pos]
        return [("sum", j, rs, rd, 1) for j, (rs, rd) in sorted(by.items())]

    def streamable(self) -> dict:
        """operand -> row floats of the data operands some top-level
        product could stream (the geometry picks which it does)."""
        rows = {}
        for sig, roots in self.groups():
            for kind in ("out", "sum"):
                ids = roots if sig[0] != "warp_each" else roots[:1]
                for r in ids:
                    if r == "g" or sig[0] not in ("loop", "warp_each"):
                        continue
                    for acc in _stream_reads(self.ir, r, kind).values():
                        rows.setdefault(acc.operand, acc.row)
        return rows

    def fill_call(self, pas, rel, dest):
        """The request of the pass's fill ``rel`` (a C expression, or an
        int) into buffer ``dest``: its chunk's rows and, for a window pass,
        its columns."""
        j, row, stride, width, chunks = (pas[k] for k in (
            "operand", "row", "stride", "width", "chunks"))
        points, total = self.geometry.points, pas["rows"]
        if isinstance(rel, int):
            ch, gi = rel % chunks, rel // chunks
            r0, count = ch * points, min(points, total - ch * points)
            col = pas["col0"] + gi * width
            ncols = min(width, pas["outputs"] - gi * width)
        else:
            ch = rel if pas["groups"] == 1 else f"({rel}) % {chunks}"
            gi = f"({rel}) / {chunks}"
            r0 = f"({ch}) * {points}"
            count = f"gpg_imin({points}, {total} - {r0})"
            col = f"{pas['col0']} + {gi} * {width}"
            ncols = f"gpg_imin({width}, {pas['outputs']} - {gi} * {width})"
        args = f"S.tile + {dest} * TILE_FLOATS, D{j}, {r0}, {count}"
        if pas["kind"] != "lanes":
            return f"fill<{row}, {stride}>({args});"
        return f"fill<{row}, {stride}, {width}>({args}, {col}, {ncols});"

    def chunk_loop(self, sig, pas, lines, body, rel="ch"):
        """A pass's chunks: wait for the chunk and the block barrier,
        request the next fill into the other buffer (the pass's next, or
        after its last the next pass's first), then ``body`` (its lines,
        read from the tile ``T`` for rows [c0, c1)).  ``rel``: the pass's
        fill of this chunk (``ch``, or ``gi * chunks + ch`` in a window
        pass).  Raises where the group is not one whose barriers stand at
        the functor's top level."""
        if sig[0] not in ("loop", "warp_each"):
            raise ValueError(
                f"a block barrier inside {sig[0]!r}, whose loops' trip "
                "counts depend on a chain's values: its products read their "
                "operands from global memory")
        first, points, chunks = pas["first"], self.geometry.points, \
            pas["chunks"]
        count = chunks * pas["groups"]
        lines.append(f"for (int ch = 0; ch < {chunks}; ++ch) {{")
        lines.append("  chunk_ready();")
        if count > 1:
            lines.append(f"  if ({rel} + 1 < {count})")
            lines.append("    " + self.fill_call(
                pas, f"{rel} + 1", f"(({first + 1} + {rel}) & 1)"))
        nxt = self.pass_of.get(first + count)
        if nxt is not None:
            lines.append(f"  if ({rel} + 1 == {count})" if count > 1
                         else "  if (true)")
            lines.append("    " + self.fill_call(nxt, 0,
                                                 (first + count) & 1))
        lines.append(f"  const float* __restrict__ T = S.tile + "
                     f"(({first} + {rel}) & 1) * TILE_FLOATS;")
        lines.append(f"  const int c0 = ch * {points}, "
                     f"c1 = gpg_imin(c0 + {points}, {pas['rows']});")
        lines.extend("  " + line for line in body)
        lines.append("}")

    def loop_group(self, n, roots, lines, unit=0):
        """One lane-strided loop over ``n`` computing ``roots``; with
        ``unit`` indices a row, the indices of the chunk's rows [c0, c1)
        only (c0 a multiple of 32: each lane takes the indices it takes
        unchunked, in order).
        Returns its statements to run before and after (declarations,
        warp reductions)."""
        if not unit and len(roots) == 1 and self.ws_product(roots[0]):
            self.product_tiles(roots[0], lines)
            return [], []
        scope, after = _Scope(self), []
        for r in roots:
            self.emit_root(r, Ix("i", n), scope, after)
        start, stop = ((_rows_scaled(unit)[0] + " + lane",
                        _rows_scaled(unit)[1]) if unit else ("lane", str(n)))
        lines.append(f"for (int i = {start}; i < {stop}; i += 32) {{")
        lines.extend("  " + line for line in scope.lines)
        lines.append("}")
        return ([s for kind, s in after if kind == "decl"],
                [s for kind, s in after if kind == "post"])

    def ws_product(self, nid) -> bool:
        """Whether ``nid`` is a matrix product of two workspace matrices
        (stored nodes of two axes longer than one, seen through views) whose
        outputs tile by PRODUCT_ROWS rows and 32 columns."""
        if nid == "g" or self.ir.nodes[nid].op != "mm":
            return False
        n = self.ir.nodes[nid]
        m, ncols = n.shape
        if m % PRODUCT_ROWS or ncols % 32:
            return False
        for a in n.args:
            base = _through_views(self.ir, a)
            if base not in self.sched.slots or len(
                    [d for d in self.ir.nodes[base].shape if d > 1]) < 2:
                return False
        return True

    def product_tiles(self, nid, lines):
        """A product of two workspace matrices, a lane the outputs of
        PRODUCT_ROWS rows in its columns (lane, lane + 32, ...): each term
        k's elements of A's rows and B's columns loaded once for all of
        them, PRODUCT_TERMS terms' loads before their ``fmaf``s; each
        output's sum over k in order, as one output at a time takes it."""
        n = self.ir.nodes[nid]
        A, B = n.args
        m, ncols = n.shape
        red = _reduction_length(self.ir, n)
        nc = ncols // 32
        accs = [(u, v) for u in range(PRODUCT_ROWS) for v in range(nc)]
        lines.append(f"for (int r0 = 0; r0 < {m}; r0 += {PRODUCT_ROWS}) {{")
        lines += [f"  float p{u}_{v} = 0.f;" for u, v in accs]

        def trip(k0, terms):
            scope, fmas = _Scope(self), []
            for t in range(terms):
                k = Ix(f"({k0} + {t})" if t else k0, red)
                a = [self.value(A, (Ix(f"(r0 + {u})" if u else "r0", m), k),
                                scope) for u in range(PRODUCT_ROWS)]
                b = [self.value(B, (k, Ix(f"(lane + {32 * v})" if v else
                                          "lane", ncols)), scope)
                     for v in range(nc)]
                fmas += [f"p{u}_{v} = fmaf({a[u]}, {b[v]}, p{u}_{v});"
                         for u, v in accs]
            return ["    " + line for line in scope.lines + fmas]
        full = red - red % PRODUCT_TERMS
        if full:
            lines.append(f"  for (int k0 = 0; k0 < {full}; k0 += "
                         f"{PRODUCT_TERMS}) {{")
            lines += trip("k0", PRODUCT_TERMS) + ["  }"]
        if full < red:
            lines.append(f"  for (int k0 = {full}; k0 < {red}; ++k0) {{")
            lines += trip("k0", 1) + ["  }"]
        for u, v in accs:
            out = Ix(f"((r0 + {u}) * {ncols} + lane + {32 * v})", m * ncols)
            lines.append(f"  {self.slot(nid, out)} = p{u}_{v};")
        lines.append("}")

    def sum_pass(self, roots, lines):
        """The chunk's terms of one-lane-an-output products ``roots``: each
        output's sum carried across chunks in its workspace slot (its first
        value the sum's start), terms c0 .. c1 - 1 in order."""
        ir = self.ir
        n = _numel(ir.nodes[roots[0]].shape)
        scope = _Scope(self)
        for r in roots:
            node = ir.nodes[r]
            init, _ = _ACCUMULATE[node.op]
            acc = self.fresh("acc")
            slot = self.slot(r, Ix("i", n))
            scope.lines.append(f"float {acc} = ch == 0 ? {init} : {slot};")
            scope.lines.append("for (int k = c0; k < c1; ++k) {")
            inner = _Scope(self, scope.memo)
            inner.lines.append(self.term(r, Ix("i", n),
                                         Ix("k", _reduction_length(ir, node)),
                                         inner, acc))
            scope.lines.extend("  " + line for line in inner.lines)
            scope.lines.append("}")
            scope.lines.append(f"{slot} = {acc};")
        lines.append(f"for (int i = lane; i < {n}; i += 32) {{")
        lines.extend("  " + line for line in scope.lines)
        lines.append("}")

    def sum_pass_registers(self, roots):
        """The register form of :meth:`sum_pass`, where a lane's outputs
        (``ceil(n / 32)`` a product, SUM_REGISTERS at most in all) fit in
        registers: each output's sum starts at its start value before the
        first chunk and is stored after the last, and each term ``k``
        reads the operands the lane's outputs share (the other factor's
        element k) once.  The terms of an output are those of
        :meth:`sum_pass`, in order.  Returns (declarations, the chunk's
        body, stores), or None where they do not fit."""
        ir = self.ir
        n = _numel(ir.nodes[roots[0]].shape)
        per = -(-n // 32)
        if per * len(roots) > SUM_REGISTERS:
            return None
        decl, store, terms = [], [], _Scope(self)
        for r in roots:
            node = ir.nodes[r]
            init, _ = _ACCUMULATE[node.op]
            red = _reduction_length(ir, node)
            for it in range(per):
                acc = self.fresh("acc")
                i = f"lane + {32 * it}" if it else "lane"
                ragged = 32 * (it + 1) > n
                idx = (Ix(f"gpg_imin({i}, {n - 1})", n) if ragged
                       else Ix(f"({i})", n))
                decl.append(f"float {acc} = {init};")
                terms.lines.append(self.term(r, idx, Ix("k", red), terms,
                                             acc))
                guard = f"if ({i} < {n}) " if ragged else ""
                store.append(f"{guard}{self.slot(r, Ix(f'({i})', n))} = "
                             f"{acc};")
        body = ["for (int k = c0; k < c1; ++k) {"]
        body += ["  " + line for line in terms.lines] + ["}"]
        return decl, body, store

    def lanes_pass(self, sig, pas, lines):
        """A warp-each product summing over the streamed rows, a window of
        ``width`` outputs at a time: each lane's partial sums of the
        window's outputs in registers across the chunks (its terms the rows
        k ≡ lane mod 32 in order, as the warp-each loop takes them), then
        each output's butterfly, so each output's order of terms is the
        warp-each one's."""
        nid = pas["roots"][0]
        n = self.ir.nodes[nid]
        out, red = _numel(n.shape), _reduction_length(self.ir, n)
        init, _ = _ACCUMULATE[n.op]
        width, groups = pas["width"], pas["groups"]
        accs = _accumulators(_pow2(width), init, True)
        lines.append(f"for (int gi = 0; gi < {groups}; ++gi) {{")
        lines.append(f"  const int g0 = gi * {width};")
        lines.extend("  " + line for line in accs[0])
        scope = _Scope(self)
        ragged = out % width != 0
        for u in range(width):  # a ragged window recomputes its last output
            o = (Ix(f"gpg_imin(g0 + {u}, {out - 1})", out) if ragged
                 else Ix(f"(g0 + {u})", out))
            scope.lines.append(self.term(nid, o, Ix("k", red), scope,
                                         accs[1](u)))
        body = ["for (int k = c0 + lane; k < c1; k += 32) {"]
        body += ["  " + line for line in scope.lines] + ["}"]
        sub = []
        self.chunk_loop(sig, pas, sub, body, rel=f"gi * {pas['chunks']} + ch")
        lines.extend("  " + line for line in sub)
        lines.extend("  " + line for line in self.sums_store(
            nid, width, "g0", out if ragged else None))
        lines.append("}")
        lines.append("__syncwarp();")

    def plan(self):
        """Each group with its passes, and the call's sequence of fills:
        each pass's ``chunks`` chunks of rows, for each of its ``groups``
        windows of columns (one: whole rows) in order."""
        groups = self.groups()
        rows = {j: r for j, (r, _) in self.streamed.items()}
        planned = []
        self.pass_of, count = {}, 0
        for sig, roots in groups:
            passes = []
            for kind, j, rs, reads, unit in self.passes(sig, roots, rows):
                row, stride = self.streamed[j]
                total = _numel(self.ir.data_shapes[j]) // row
                pas = dict(kind=kind, operand=j, roots=rs, reads=reads,
                           unit=unit, row=row, stride=stride, width=row,
                           rows=total, col0=0, outputs=row, groups=1,
                           chunks=-(-total // self.geometry.points),
                           first=count)
                if kind == "lanes":
                    acc = next(iter(reads.values()))
                    out = _numel(self.ir.nodes[rs[0]].shape)
                    pas.update(width=unit, stride=odd_stride(unit),
                               col0=acc.col0, outputs=out,
                               groups=-(-out // unit))
                self.pass_of[count] = pas
                count += pas["chunks"] * pas["groups"]
                passes.append(pas)
            planned.append((sig, roots, passes))
        self.fills = count
        return planned

    def body(self) -> list:
        lines = []
        planned = self.plan()
        if self.fills:  # the call's first chunk, while the body starts
            lines.append(self.fill_call(self.pass_of[0], 0, 0))
        for sig, roots, passes in planned:
            if sig[0] == "scalar":
                scope = _Scope(self)
                for r in roots:
                    self.emit_root(r, _ic(0), scope, [])
                lines.extend(scope.lines)
                continue
            if sig[0] == "warp_each":
                if passes and passes[0]["kind"] == "lanes":
                    self.reads = passes[0]["reads"]
                    self.window = passes[0]["stride"]
                    self.lanes_pass(sig, passes[0], lines)
                    self.reads, self.window = {}, 0
                elif passes:
                    self.reads = passes[0]["reads"]
                    sub = []
                    self.warp_each(roots[0], sub, passes[0]["unit"])
                    self.reads = {}
                    self.chunk_loop(sig, passes[0], lines, sub[:-1])
                    lines.append("__syncwarp();")
                else:
                    self.warp_each(roots[0], lines)
                continue
            if sig[0] in SEQUENTIAL:
                getattr(self, sig[0])(roots[0], lines)
                continue
            n = sig[1]
            if passes and passes[0]["kind"] == "out":
                pas, = passes
                self.reads = pas["reads"]
                sub = []
                decl, post = self.loop_group(n, roots, sub, pas["unit"])
                self.reads = {}
                lines.extend(decl)
                self.chunk_loop(sig, pas, lines, sub)
                lines.extend(post)
                lines.append("__syncwarp();")
                continue
            summed = {r for pas in passes for r in pas["roots"]}
            others = [r for r in roots if r not in summed]
            post = []
            if others:
                decl, post = self.loop_group(n, others, sub := [])
                lines.extend(decl)
                lines.extend(sub)
            for pas in passes:
                self.reads = pas["reads"]
                held = self.sum_pass_registers(pas["roots"])
                if held is None:
                    sub = []
                    self.sum_pass(pas["roots"], sub)
                    self.chunk_loop(sig, pas, lines, sub)
                else:
                    decl, body, store = held
                    lines.extend(decl)
                    self.chunk_loop(sig, pas, lines, body)
                    lines.extend(store)
                self.reads = {}
            lines.extend(post)
            lines.append("__syncwarp();")
        scope = _Scope(self)
        u = self.value(self.ir.u, (), scope)
        lines.extend(scope.lines)
        lines.append(f"if (lane == 0) S.nu[c] = {u};")
        lines.append("__syncwarp();")
        return lines

    def tile_read(self, acc: RowAccess, idx, scope) -> str:
        """A streamed operand's element at a product operand's index
        ``idx``, from the tile ``T`` of rows [c0, c1) (in a window pass,
        its columns from g0)."""
        row, other = idx[acc.axis], idx[1 - acc.axis]
        if self.window:
            return scope.temp(f"T[({row.expr} - c0) * {self.window} + "
                              f"({other.expr} - g0)]")
        col = _iadd(_imul(other, acc.col_step), _ic(acc.col0))
        stride = self.streamed[acc.operand][1]
        return scope.temp(f"T[({row.expr} - c0) * {stride} + {col.expr}]")


    def trsolve(self, nid, lines):
        """A triangular solve: several right sides a lane a column
        (:meth:`_trsolve_columns`); one right side row by row with the
        lanes along the row (:meth:`_trsolve_rows`), or, where the matrix
        is stored transposed (read through a permute), a column at a time
        with the lanes down the column (:meth:`_trsolve_down`), so that the
        lanes of a load read neighbouring addresses either way."""
        n = self.ir.nodes[nid]
        if n.shape[-1] > 1:
            self._trsolve_columns(nid, lines)
        elif (_lane_stride(self.ir, n.args[0], 2, self.stored) != 1 and
              _lane_stride(self.ir, n.args[0], 1, self.stored) == 1):
            self._trsolve_down(nid, lines)
        else:
            self._trsolve_rows(nid, lines)

    def _trsolve_rows(self, nid, lines):
        """One right side, row by row (forward when lower, backward when
        upper): row i's inner sum split over the lanes (lane l the columns
        j = l, l + 32, ... counted from the diagonal's far end, each
        ``fmaf`` in turn), ended by ``warp_sum``; the lane of column i
        stores x_i, so each lane reads back only the solutions it stored
        and the rows need no barrier."""
        n = self.ir.nodes[nid]
        A, B = n.args
        upper, unit = n.params
        batch, size, _ = n.shape
        ba = self.ir.nodes[A].shape[0]
        b = Ix("b", batch) if batch > 1 else _ic(0)
        col = _ic(0)
        i, j = Ix("i", size), Ix("j", size)
        if upper:  # rows n-1 .. 0, lane l owns the columns n-1-l, n-1-l-32, ...
            head = [f"for (int s = 0; s < {size}; ++s) {{",
                    f"  const int i = {size - 1} - s;",
                    "  float acc = 0.f;",
                    f"  for (int j = {size - 1} - lane; j > i; j -= 32) {{"]
            owner = f"({size - 1} - i) % 32"
        else:
            head = [f"for (int i = 0; i < {size}; ++i) {{",
                    "  float acc = 0.f;",
                    "  for (int j = lane; j < i; j += 32) {"]
            owner = "i % 32"
        bA = b if ba > 1 else _ic(0)
        inner = _Scope(self)
        a_ij = self.value(A, (bA, i, j), inner)
        x_j = self.slot(nid, _flatten((b, j, col), n.shape))
        inner.lines.append(f"acc = fmaf({a_ij}, {x_j}, acc);")
        row = _Scope(self)
        b_i = self.value(B, (b, i, col), row)
        x_i = f"({b_i} - acc)"
        if not unit:
            x_i = f"{x_i} / {self.value(A, (bA, i, i), row)}"
        body = head + ["    " + line for line in inner.lines]
        body += ["  }", "  acc = warp_sum(acc);"]
        body += ["  " + line for line in row.lines]
        body += [f"  if (lane == {owner}) "
                 f"{self.slot(nid, _flatten((b, i, col), n.shape))} = {x_i};",
                 "}"]
        if batch > 1:
            body = ([f"for (int b = 0; b < {batch}; ++b) {{"]
                    + ["  " + line for line in body] + ["}"])
        lines.extend(body)
        lines.append("__syncwarp();")

    def _trsolve_columns(self, nid, lines):
        """Several right sides, a lane a column: SOLVE_COLUMNS columns a
        lane at once (lane, lane + 32, ... of a group) and SOLVE_ROWS rows
        of the solve at once, so each element of the matrix and of the
        solved rows is loaded once for all of them.  Each solution x_ic =
        (b_ic - sum_j a_ij x_jc) / a_ii takes its sum over the solved rows
        j in the solve's order (ascending when lower, from the last row
        down when upper) in one lane, ``fmaf`` by ``fmaf``, the rows solved
        beside it last: no butterfly, and a lane reads back only the
        solutions it wrote.  With a factor scratch the matrix is first
        copied into it (its lanes along the stored rows) and the lane's
        columns of solutions kept beside it, so the sums' loads wait on
        shared memory; the solutions go to the node's slot as they come."""
        n = self.ir.nodes[nid]
        A, B = n.args
        upper, unit = n.params
        batch, size, cols = n.shape
        ba = self.ir.nodes[A].shape[0]
        b = Ix("b", batch) if batch > 1 else _ic(0)
        bA = b if ba > 1 else _ic(0)
        nc = min(SOLVE_COLUMNS, -(-cols // 32))
        width = 32 * nc
        ragged = cols % width != 0
        cols_at = ["(c0 + lane)"] + [f"(c0 + lane + {32 * c})"
                                    for c in range(1, nc)]
        col_ix = [Ix(f"gpg_imin({e}, {cols - 1})" if ragged else e, cols)
                  for e in cols_at]
        shared = self.uses_factor(nid)
        body = []
        if shared:
            st, xo = _factor_stride(size), _factor_stride(size) * size

            def a_of(r, c, scope):
                return scope.temp(f"fs[({r.expr}) * {st} + {c.expr}]")

            def x_of(r, c):
                return f"fs[{xo} + ({r}) * {width} + lane + {32 * c}]"
            body += self._copy(A, bA, size,
                               lambda r, c: f"fs[({r}) * {st} + {c}]")
            body.append("__syncwarp();")
        else:
            def a_of(r, c, scope):
                return self.value(A, (bA, r, c), scope)

            def x_of(r, c):
                x = self.slot(nid, _flatten((b, Ix(r, size), col_ix[c]),
                                            n.shape))
                return f"({cols_at[c]} < {cols} ? {x} : 0.f)" if ragged \
                    else x

        def block(rows_at):
            """Rows ``rows_at`` (C expressions, in the solve's order)."""
            nr = len(rows_at)
            out = [f"const int i{q} = {e};" for q, e in enumerate(rows_at)]
            ri = [Ix(f"i{q}", size) for q in range(nr)]
            pre = _Scope(self)  # read before the sum, which hides their wait
            bv = [[self.value(B, (b, ri[q], col_ix[c]), pre)
                   for c in range(nc)] for q in range(nr)]
            diag = [None if unit else a_of(ri[q], ri[q], pre)
                    for q in range(nr)]
            cross = {(q, p): a_of(ri[q], ri[p], pre)
                     for q in range(nr) for p in range(q)}
            out += pre.lines
            out += [f"float acc{q}_{c} = 0.f;" for q in range(nr)
                    for c in range(nc)]

            def term(v, u):
                scope = _Scope(self)
                a = [a_of(ri[q], Ix(v, size), scope) for q in range(nr)]
                x = [scope.temp(x_of(v, c)) for c in range(nc)]
                return scope.lines, [
                    f"acc{q}_{c} = fmaf({a[q]}, {x[c]}, acc{q}_{c});"
                    for q in range(nr) for c in range(nc)]
            out += (_sum_loop("j", str(size - 1), ">", "i0", -1, term)
                    if upper else _sum_loop("j", "0", "<", "i0", 1, term))
            for q in range(nr):
                for c in range(nc):
                    acc = f"acc{q}_{c}"
                    out += [f"{acc} = fmaf({cross[q, p]}, x{p}_{c}, {acc});"
                            for p in range(q)]
                    x = f"({bv[q][c]} - {acc})"
                    out.append(f"const float x{q}_{c} = {x}"
                               + ("" if unit else f" / {diag[q]}") + ";")
                    if shared:
                        out.append(f"{x_of(f'i{q}', c)} = x{q}_{c};")
                    store = self.slot(nid, _flatten(
                        (b, ri[q], Ix(cols_at[c], cols)), n.shape))
                    guard = f"if ({cols_at[c]} < {cols}) " if ragged else ""
                    out.append(f"{guard}{store} = x{q}_{c};")
            return ["  " + line for line in out]

        def row_at(k):
            return f"{size - 1} - ({k})" if upper else f"({k})"
        full = size - size % SOLVE_ROWS
        solve = [f"for (int it = 0; it < {full}; it += {SOLVE_ROWS}) {{"]
        solve += block([row_at(f"it + {q}" if q else "it")
                        for q in range(SOLVE_ROWS)])
        solve.append("}")
        for k in range(full, size):
            solve += ["{"] + block([row_at(str(k))]) + ["}"]
        body.append(f"for (int c0 = 0; c0 < {cols}; c0 += {width}) {{")
        body += ["  " + line for line in solve]
        body += ["}", "__syncwarp();"]
        if batch > 1:
            body = ([f"for (int b = 0; b < {batch}; ++b) {{"]
                    + ["  " + line for line in body] + ["}"])
        lines.extend(body)

    def _trsolve_down(self, nid, lines):
        """One right side of a matrix stored transposed: a column at a
        time in the order of the solve, the lanes down the column (row i in
        lane i % 32, its residual r_i = b_i - sum_j a_ij x_j in a register,
        ``fmaf`` by ``fmaf`` in the solve's order): x_j = r_j / a_jj, which
        every lane takes from the owner's register by a shuffle, then each
        lane's rows still to solve take their term of column j, read along
        the stored rows."""
        n = self.ir.nodes[nid]
        A, B = n.args
        upper, unit = n.params
        batch, size, _ = n.shape
        ba = self.ir.nodes[A].shape[0]
        b = Ix("b", batch) if batch > 1 else _ic(0)
        bA = b if ba > 1 else _ic(0)
        ns = -(-size // 32)
        body = []
        for s in range(ns):
            i = Ix(f"(lane + {32 * s})", size)
            scope = _Scope(self)
            ragged = 32 * (s + 1) > size
            iv = Ix(f"gpg_imin(lane + {32 * s}, {size - 1})", size) \
                if ragged else i
            v = self.value(B, (b, iv, _ic(0)), scope)
            body += scope.lines
            body.append(f"float x{s} = {v};")
        order = range(ns - 1, -1, -1) if upper else range(ns)
        for S in order:
            last = min(31, size - 1 - 32 * S)
            head = (f"for (int t = {last}; t >= 0; --t) {{" if upper else
                    f"for (int t = 0; t <= {last}; ++t) {{")
            step = [f"const int j = {32 * S} + t;"]
            scope = _Scope(self)
            xj = f"__shfl_sync(FULL, x{S}, t)"
            if not unit:
                d = self.value(A, (bA, Ix("j", size), Ix("j", size)), scope)
                xj = f"{xj} / {d}"
            step += scope.lines
            step += [f"const float xj = {xj};",
                     f"if (lane == t) x{S} = xj;"]
            for s in range(ns):
                if (s > S) if upper else (s < S):
                    continue  # every row of the slot solved before column j
                i = Ix(f"(lane + {32 * s})", size)
                after = f"lane + {32 * s} < j" if upper else \
                    f"lane + {32 * s} > j && lane + {32 * s} < {size}"
                scope = _Scope(self)
                a = self.value(A, (bA, i, Ix("j", size)), scope)
                step.append(f"if ({after}) {{")
                step += ["  " + line for line in scope.lines]
                step += [f"  x{s} = fmaf(-{a}, xj, x{s});", "}"]
            body += [head] + ["  " + line for line in step] + ["}"]
        for s in range(ns):
            i = Ix(f"(lane + {32 * s})", size)
            guard = f"if (lane + {32 * s} < {size}) " \
                if 32 * (s + 1) > size else ""
            out = self.slot(nid, _flatten((b, i, _ic(0)), n.shape))
            body.append(f"{guard}{out} = x{s};")
        head = f"for (int b = 0; b < {batch}; ++b) {{" if batch > 1 else "{"
        lines.extend([head] + ["  " + line for line in body] + ["}"])
        lines.append("__syncwarp();")

    def scatter_add(self, nid, lines, update="+="):
        """Each output sums its base and the values that land on it in
        input order, in its own lane (output o in lane o % 32), with no
        atomics.  By an index the host knows, through its preimage row
        (offsets, then the values by output, each output's in input
        order): the lane starts from the base, adds its output's values
        and stores once, reading no value another lane adds.  By an index
        computed on the card, the base, lane-strided; then every lane walks
        the values in input order and the lane that owns each one's output
        adds it (``update``), with no barrier between the two loops."""
        n = self.ir.nodes[nid]
        if len(n.args) == 4:
            base, _, values, pre = n.args
            self._preimage_loop(nid, lines, base, pre, values, "acc + v")
            return
        base, index, values = n.args
        axis = n.params[0]
        out = _numel(n.shape)
        vshape = self.ir.nodes[values].shape
        rank = len(self.ir.nodes[index].shape)
        init = _Scope(self)
        v = self.value(base, _unflatten(Ix("o", out), n.shape), init)
        lines.append(f"for (int o = lane; o < {out}; o += 32) {{")
        lines.extend("  " + line for line in init.lines)
        lines.append(f"  {self.slot(nid, Ix('o', out))} = {v};")
        lines.append("}")
        scan = _Scope(self)
        t = _unflatten(Ix("t", _numel(vshape)), vshape)
        k = self.value(index, t[axis:axis + rank], scan)
        length = n.shape[axis]
        o = _flatten((*t[:axis], Ix(f"gpg_wrap({k}, {length})", length),
                      *t[axis + rank:]), n.shape)
        scan.lines.append(f"const int o = {o.expr};")
        val = self.value(values, t, scan)
        scan.lines.append(f"if (o % 32 == lane) {self.slot(nid, Ix('o', out))}"
                          f" {update} {val};")
        lines.append(f"for (int t = 0; t < {_numel(vshape)}; ++t) {{")
        lines.extend("  " + line for line in scan.lines)
        lines.append("}")
        lines.append("__syncwarp();")

    def argmax(self, nid, lines):
        """One lane an output, its scan along the axis sequential: the
        first index of the maximum, a NaN the largest (torch's max.dim);
        stored as a float."""
        n = self.ir.nodes[nid]
        x = n.args[0]
        axis = n.params[0]
        src = self.ir.nodes[x].shape
        length = src[axis]
        rest = src[:axis] + src[axis + 1:]
        m = _unflatten(Ix("m", _numel(rest)), rest)
        scope = _Scope(self)
        v = self.value(x, (*m[:axis], Ix("l", length), *m[axis:]), scope)
        lines.append(f"for (int m = lane; m < {_numel(rest)}; m += 32) {{")
        lines.append("  float best = 0.f;")
        lines.append("  int at = 0;")
        lines.append(f"  for (int l = 0; l < {length}; ++l) {{")
        lines.extend("    " + line for line in scope.lines)
        lines.append(f"    if (l == 0 || (best == best && ({v} > best || "
                     f"{v} != {v}))) {{")
        lines.append(f"      best = {v};")
        lines.append("      at = l;")
        lines.append("    }")
        lines.append("  }")
        lines.append(f"  {self.slot(nid, Ix('m', _numel(rest)))} = (float)at;")
        lines.append("}")
        lines.append("__syncwarp();")

    def _lu_of(self, nid, shared):
        """Accessors ``(LU(i, j), PIV(k), to_global)`` of the LU that node
        ``nid`` factors or reads: in the factor scratch (``shared``), else
        in the workspace after its owner's output (its own, or the node that
        factors the same matrix first: :func:`_lu_owners`); the pivots, row
        indices as floats, after the factors.  ``to_global``: lines copying
        the scratch's LU and pivots to the owner's workspace, where a later
        node reads them."""
        n = self.ir.nodes[nid]
        size = self.ir.nodes[n.args[0]].shape[-1]
        owner = self.lu_users.get(nid, nid)
        g0 = self.sched.slots[owner] + _numel(self.ir.nodes[owner].shape)

        def glu(i, j):
            return f"ws[{g0} + ({i}) * {size} + {j}]"

        def gpiv(k):
            return f"ws[{g0 + size * size} + {k}]"
        if not shared:
            return glu, gpiv, []
        st = _factor_stride(size)

        def lu(i, j):
            return f"fs[({i}) * {st} + {j}]"

        def piv(k):
            return f"fs[{size * st} + {k}]"
        out = [f"for (int e = lane; e < {size * size}; e += 32) {{",
               f"  {glu(f'e / {size}', f'e % {size}')} = "
               f"{lu(f'e / {size}', f'e % {size}')};", "}",
               f"for (int k = lane; k < {size}; k += 32) {{",
               f"  {gpiv('k')} = {piv('k')};", "}"]
        return lu, piv, out

    def _lu_here(self, nid, LU, PIV, to_global, bA):
        """Lines that give node ``nid`` its LU: its matrix factored in place
        (:func:`_lu_factor`, lane 0 recording each pivot), copied to the
        workspace where a later node reads it; or, for a node whose owner
        factored the same matrix, the owner's LU copied into the factor
        scratch (nothing where both are the workspace's)."""
        n = self.ir.nodes[nid]
        A = n.args[0]
        size = self.ir.nodes[A].shape[-1]
        if nid in self.lu_users:
            if not to_global:
                return []
            glu, gpiv, _ = self._lu_of(nid, False)
            return [f"for (int e = lane; e < {size * size}; e += 32) {{",
                    f"  {LU(f'e / {size}', f'e % {size}')} = "
                    f"{glu(f'e / {size}', f'e % {size}')};", "}",
                    f"for (int k = lane; k < {size}; k += 32) {{",
                    f"  {PIV('k')} = {gpiv('k')};", "}", "__syncwarp();"]
        body = self._copy(A, bA, size, LU)
        body += ["__syncwarp();"]
        body += _lu_factor(LU, size, [f"if (lane == 0) {PIV('k')} = "
                                      "(float)p;"])
        if nid in self.lu_owners:
            body += to_global + ["__syncwarp();"]
        return body

    def lusolve(self, nid, lines):
        """``A X = B`` by LU with partial pivoting (:meth:`_lu_here`: the
        matrix factored once for every right-side batch when it has no
        batch of its own, and once for every node that solves or takes the
        log-determinant of the same matrix), then a lane a right-side
        column: its column of B, the pivots' row swaps in order, then
        forward (unit lower) and backward (upper) substitution, its sums
        sequential; with a factor scratch the column lives beside the
        factors in shared memory and goes to the node's slot at the end."""
        n = self.ir.nodes[nid]
        A, B = n.args
        batch, size, cols = n.shape
        ba = self.ir.nodes[A].shape[0]
        base = self.sched.slots[nid]
        shared = self.uses_factor(nid)
        LU, PIV, to_global = self._lu_of(nid, shared)
        if shared:
            xo = _factor_stride(size) * size + size

            def X(i):
                return f"fs[{xo} + ({i}) * 32 + lane]"
        else:
            def X(i):
                return (f"ws[{base} + b * {size * cols} + ({i}) * {cols} + "
                        "col]")
        scope = _Scope(self)
        vb = self.value(B, (Ix("b", batch), Ix("i", size), Ix("col", cols)),
                        scope)

        def term(v, u):
            return ([f"const float la{u} = {LU('i', v)};",
                     f"const float lx{u} = {X(v)};"],
                    [f"acc = fmaf(-la{u}, lx{u}, acc);"])
        solve = [f"for (int col = lane; col < {cols}; col += 32) {{",
                 f"  for (int i = 0; i < {size}; ++i) {{",
                 *("    " + line for line in scope.lines),
                 f"    {X('i')} = {vb};",
                 "  }",
                 f"  for (int k = 0; k < {size}; ++k) {{",
                 f"    const int p = (int){PIV('k')};",
                 "    if (p != k) {",
                 f"      const float t = {X('k')};",
                 f"      {X('k')} = {X('p')};",
                 f"      {X('p')} = t;",
                 "    }",
                 "  }",
                 f"  for (int i = 1; i < {size}; ++i) {{",
                 f"    float acc = {X('i')};",
                 *("    " + line for line in _sum_loop("t", "0", "<", "i", 1,
                                                      term)),
                 f"    {X('i')} = acc;",
                 "  }",
                 f"  for (int i = {size - 1}; i >= 0; --i) {{",
                 f"    float acc = {X('i')};",
                 *("    " + line for line in _sum_loop(
                     "t", "i + 1", "<", str(size), 1, term)),
                 f"    {X('i')} = acc / {LU('i', 'i')};",
                 "  }"]
        if shared:
            solve += [f"  for (int i = 0; i < {size}; ++i)",
                      f"    ws[{base} + b * {size * cols} + i * {cols} + col]"
                      f" = {X('i')};"]
        solve += ["}", "__syncwarp();"]
        once = ba == 1
        bA = _ic(0) if once else Ix("b", batch)
        here = self._lu_here(nid, LU, PIV, to_global, bA)
        if once:
            lines.extend(here)
            here = []
        lines.append(f"for (int b = 0; b < {batch}; ++b) {{")
        lines.extend("  " + line for line in here + solve)
        lines.append("}")

    def cumsum(self, nid, lines, init="0.f", step="acc + {v}"):
        """One lane a line along the axis, its sum sequential."""
        n = self.ir.nodes[nid]
        axis = n.params[0]
        length = n.shape[axis]
        rest = n.shape[:axis] + n.shape[axis + 1:]
        m = _unflatten(Ix("m", _numel(rest)), rest)
        idx = (*m[:axis], Ix("l", length), *m[axis:])
        scope = _Scope(self)
        v = self.value(n.args[0], idx, scope)
        lines.append(f"for (int m = lane; m < {_numel(rest)}; m += 32) {{")
        lines.append(f"  float acc = {init};")
        lines.append(f"  for (int l = 0; l < {length}; ++l) {{")
        lines.extend("    " + line for line in scope.lines)
        lines.append(f"    acc = {step.format(v=v)};")
        lines.append(f"    {self.slot(nid, _flatten(idx, n.shape))} = acc;")
        lines.append("  }")
        lines.append("}")
        lines.append("__syncwarp();")

    def cumprod(self, nid, lines):
        """One lane a line along the axis, its product sequential."""
        self.cumsum(nid, lines, "1.f", "acc * {v}")

    def logcumsumexp(self, nid, lines):
        """One lane a line along the axis, a running ``logaddexp``
        (ATen's ``_log_add_exp_helper``) from -inf."""
        self.cumsum(nid, lines, "__int_as_float(0xff800000)",
                    "gpg_log_add_exp({v}, acc)")

    def cumarg(self, nid, lines):
        """One lane a line along the axis: the index of the running maximum
        (minimum), updated where the element is NaN or, the running value
        not NaN, at least (at most) it (torch's cummax/cummin); stored as a
        float."""
        n = self.ir.nodes[nid]
        axis, sign = n.params
        length = n.shape[axis]
        rest = n.shape[:axis] + n.shape[axis + 1:]
        m = _unflatten(Ix("m", _numel(rest)), rest)
        idx = (*m[:axis], Ix("l", length), *m[axis:])
        scope = _Scope(self)
        v = self.value(n.args[0], idx, scope)
        cmp = ">=" if sign > 0 else "<="
        lines.append(f"for (int m = lane; m < {_numel(rest)}; m += 32) {{")
        lines.append("  float best = 0.f;")
        lines.append("  int at = 0;")
        lines.append(f"  for (int l = 0; l < {length}; ++l) {{")
        lines.extend("    " + line for line in scope.lines)
        lines.append(f"    if (l == 0 || {v} != {v} || (best == best && "
                     f"{v} {cmp} best)) {{")
        lines.append(f"      best = {v};")
        lines.append("      at = l;")
        lines.append("    }")
        lines.append(f"    {self.slot(nid, _flatten(idx, n.shape))} = "
                     "(float)at;")
        lines.append("  }")
        lines.append("}")
        lines.append("__syncwarp();")

    def _batch_loop(self, nid, lines, body):
        n = self.ir.nodes[nid]
        lines.append(f"for (int b = 0; b < {n.shape[0]}; ++b) {{")
        lines.extend("  " + line for line in body)
        lines.append("}")

    def _arg_batch(self, nid):
        """The batch index expression of a factorisation's argument (a
        batch of one read for every output)."""
        n = self.ir.nodes[nid]
        return Ix("b", n.shape[0]) if \
            self.ir.nodes[n.args[0]].shape[0] > 1 else _ic(0)

    def lufactor(self, nid, lines):
        """getrf a matrix: its copy factored in place (``_lu_factor``; in
        the factor scratch where there is one, then copied to the output's
        slot), lane 0 writing each 1-based pivot in the row after the
        factors."""
        n = self.ir.nodes[nid]
        (A,) = n.args
        size = n.shape[-1]
        base = self.sched.slots[nid]
        block = f"b * {(size + 1) * size}"

        def out(i, j):
            return f"ws[{base} + {block} + ({i}) * {size} + {j}]"

        if self.uses_factor(nid):
            st = _factor_stride(size)

            def LU(i, j):
                return f"fs[({i}) * {st} + {j}]"
        else:
            LU = out
        body = self._copy(A, self._arg_batch(nid), size, LU)
        body += ["__syncwarp();"]
        body += _lu_factor(LU, size, [
            f"if (lane == 0) {out(size, 'k')} = (float)(p + 1);"])
        if LU is not out:
            body += [f"for (int e = lane; e < {size * size}; e += 32)",
                     f"  {out(f'e / {size}', f'e % {size}')} = "
                     f"{LU(f'e / {size}', f'e % {size}')};",
                     "__syncwarp();"]
        self._batch_loop(nid, lines, body)

    def lu_p(self, nid, lines):
        """P of A = P L U from getrf's pivots: every lane applies the row
        swaps to the identity permutation in order, then writes its
        elements of P (P[perm[j], j] = 1)."""
        n = self.ir.nodes[nid]
        (piv,) = n.args
        batch, size, _ = n.shape
        scope = _Scope(self)
        v = self.value(piv, (Ix("b", batch) if self.ir.nodes[piv].shape[0] > 1
                             else _ic(0), Ix("i", size)), scope)
        p_at = self.slot(nid, Ix(f"b * {size * size} + e",
                                 batch * size * size))
        body = [f"int perm[{size}];",
                f"for (int i = 0; i < {size}; ++i) perm[i] = i;",
                f"for (int i = 0; i < {size}; ++i) {{",
                *("  " + line for line in scope.lines),
                f"  const int p = (int)({v}) - 1;",
                "  const int t = perm[i];",
                "  perm[i] = perm[p];",
                "  perm[p] = t;",
                "}",
                f"for (int e = lane; e < {size * size}; e += 32)",
                f"  {p_at} = perm[e % {size}] == e / {size} ? 1.f : 0.f;",
                "__syncwarp();"]
        self._batch_loop(nid, lines, body)

    def _dense(self, nid, lines, call, rows, cols):
        """A factorisation of ``gpg_*`` (``call(out, scratch)``): the
        argument's matrix copied into the scratch after the output (its
        working copy), then the helper, a matrix at a time."""
        n = self.ir.nodes[nid]
        (A,) = n.args
        base = self.sched.slots[nid]
        out_size = _numel(n.shape[1:])
        w0 = base + _numel(n.shape)
        scope = _Scope(self)
        i, j = _unflatten(Ix("e", rows * cols), (rows, cols))
        v = self.value(A, (self._arg_batch(nid), i, j), scope)
        body = [f"for (int e = lane; e < {rows * cols}; e += 32) {{",
                *("  " + line for line in scope.lines),
                f"  ws[{w0} + e] = {v};", "}", "__syncwarp();",
                call(f"ws + {base} + b * {out_size}", f"ws + {w0}")]
        self._batch_loop(nid, lines, body)

    def qr(self, nid, lines):
        """The reduced QR a matrix (``gpg_qr``): Q over R."""
        _, m, k = self.ir.nodes[self.ir.nodes[nid].args[0]].shape
        self._dense(nid, lines, lambda out, w: (
            f"gpg_qr<{m}, {k}>({out}, {w}, {w} + {m * k}, lane);"), m, k)

    def svd(self, nid, lines):
        """The thin SVD a matrix (``gpg_svd``): U, the singular values,
        V."""
        n = self.ir.nodes[nid]
        _, m, k = self.ir.nodes[n.args[0]].shape
        fix_v = _cbool(n.params[0])
        self._dense(nid, lines, lambda out, w: (
            f"gpg_svd<{m}, {k}, {fix_v}>({out}, {w}, {w} + {m * k}, "
            f"{w} + {m * k + k * k}, lane);"), m, k)

    def mexp(self, nid, lines):
        """Matrix exponentials, ``_mexp_group`` matrices a warp pass
        (``gpg_mexp``): the pass's arguments copied into their scratch
        matrices, then the body."""
        n = self.ir.nodes[nid]
        batch, size = n.shape[0], n.shape[-1]
        nn = size * size
        group = _mexp_group(size, batch)
        base = self.sched.slots[nid]
        w0 = base + _numel(n.shape)
        ragged = batch % group != 0
        scope = _Scope(self)
        if self.ir.nodes[n.args[0]].shape[0] == 1:
            bb = _ic(0)
        else:
            bb = Ix("bb", batch) if group > 1 else Ix("b", batch)
        e = Ix(f"(e % {nn})", nn) if group > 1 else Ix("e", nn)
        i, j = _unflatten(e, (size, size))
        v = self.value(n.args[0], (bb, i, j), scope)
        body = [f"for (int e = lane; e < {group * nn}; e += 32) {{"]
        if group > 1:
            body.append(f"  const int bb = b + e / {nn};")
            if ragged:
                body.append(f"  if (bb >= {batch}) continue;")
            dst = f"ws[{w0} + (e / {nn}) * {10 * nn} + e % {nn}]"
        else:
            dst = f"ws[{w0} + e]"
        body += [*("  " + line for line in scope.lines), f"  {dst} = {v};",
                 "}", "__syncwarp();"]
        count = f"gpg_imin({group}, {batch} - b)" if ragged else str(group)
        body.append(f"gpg_mexp<{size}, {group}>(ws + {base} + b * {nn}, "
                    f"ws + {w0}, {count}, lane);")
        lines.append(f"for (int b = 0; b < {batch}; b += {group}) {{")
        lines.extend("  " + line for line in body)
        lines.append("}")

    def scatter_reduce_chain(self, nid, lines):
        """scatter_add's loops, reducing: each output's lane starts from
        its base (without it, from its first value), reduces the values
        that land on it in input order by sum, product, maximum or minimum
        (NaN wins), counting them, and averages over the count for a
        mean."""
        n = self.ir.nodes[nid]
        base, pos, src = n.args
        reduce, include_self = n.params
        out = n.shape[0]
        cnt = self.sched.slots[nid] + out
        init = _Scope(self)
        v = self.value(base, (Ix("o", out),), init)
        lines.append(f"for (int o = lane; o < {out}; o += 32) {{")
        lines.extend("  " + line for line in init.lines)
        lines.append(f"  {self.slot(nid, Ix('o', out))} = {v};")
        lines.append(f"  ws[{cnt} + o] = 0.f;")
        lines.append("}")
        scan = _Scope(self)
        sshape = self.ir.nodes[src].shape
        t = _unflatten(Ix("t", _numel(sshape)), sshape)
        k = self.value(pos, t, scan)
        scan.lines.append(f"const int o = (int)({k});")
        val = self.value(src, t, scan)
        step = {"sum": "acc + v", "mean": "acc + v", "prod": "acc * v",
                "amax": "gpg_max(acc, v)", "amin": "gpg_min(acc, v)"}[reduce]
        first = "" if include_self else f"ws[{cnt} + o] == 0.f ? v : "
        acc = self.slot(nid, Ix("o", out))
        scan.lines += ["if (o % 32 == lane) {",
                       f"  const float v = {val};",
                       f"  const float acc = {acc};",
                       f"  {acc} = {first}{step};",
                       f"  ws[{cnt} + o] += 1.f;",
                       "}"]
        lines.append(f"for (int t = 0; t < {_numel(sshape)}; ++t) {{")
        lines.extend("  " + line for line in scan.lines)
        lines.append("}")
        if reduce == "mean":
            count = f"(ws[{cnt} + o] + 1.f)" if include_self else \
                f"ws[{cnt} + o]"
            lines += [f"for (int o = lane; o < {out}; o += 32)",
                      f"  if (ws[{cnt} + o] > 0.f) {acc} = {acc} / {count};"]
        lines.append("__syncwarp();")

    def scatter_put(self, nid, lines):
        """scatter_add's loops with a write for the sum: each output's lane
        writes the values that land on it in input order, so the last of a
        duplicate wins."""
        self.scatter_add(nid, lines, "=")

    def _copy(self, src, batch_ix, size, dest, lower=False):
        """Lines copying matrix ``src[b]`` (``(size, size)``) into
        ``dest(i, j)``, lane-strided, the lanes along the stored rows (down
        the columns of a matrix stored transposed); ``lower``: its lower
        triangle, mirrored (symmetric) or zeros above (``"zero"``)."""
        scope = _Scope(self)
        down = (not lower and
                _lane_stride(self.ir, src, 2, self.stored) != 1 and
                _lane_stride(self.ir, src, 1, self.stored) == 1)
        i, j = _unflatten(Ix("e", size * size), (size, size))
        if down:
            i, j = j, i
        if lower:
            ii = Ix(f"gpg_imax({i.expr}, {j.expr})", size)
            jj = Ix(f"gpg_imin({i.expr}, {j.expr})", size)
        else:
            ii, jj = i, j
        v = self.value(src, (batch_ix, ii, jj), scope)
        if lower == "zero":
            v = f"({j.expr} <= {i.expr} ? {v} : 0.f)"
        return [f"for (int e = lane; e < {size * size}; e += 32) {{",
                *("  " + line for line in scope.lines),
                f"  {dest(i.expr, j.expr)} = {v};", "}"]

    def chol(self, nid, lines):
        """The lower Cholesky factor in place, right-looking, column by
        column: every lane reads the pivot (NaN or not positive: the whole
        factor is made NaN at the end, as JAX's cholesky gives it), the
        lane that owns it stores its square root, the lanes split the rows
        below (row r in lane r % 32) to divide the column, then the
        trailing update (:func:`_rank_one`: the lanes along each row, its
        columns' multipliers in registers; each element's terms in the
        order of k, so the bits of a row a lane).  In the factor scratch
        where there is one (an odd row stride: a column's read by the lanes
        hits distinct banks), then copied to the slot; else in the slot."""
        n = self.ir.nodes[nid]
        (A,) = n.args
        batch, size, _ = n.shape
        ba = self.ir.nodes[A].shape[0]
        base = self.sched.slots[nid]

        def out(i, j):
            return f"ws[{base} + b * {size * size} + ({i}) * {size} + {j}]"

        if self.uses_factor(nid):
            st = _factor_stride(size)

            def L(i, j):
                return f"fs[({i}) * {st} + {j}]"
        else:
            L = out
        body = self._copy(A, Ix("b", batch) if ba > 1 else _ic(0), size, L,
                          "zero")
        body += ["__syncwarp();",
                 "bool bad = false;",
                 f"for (int k = 0; k < {size}; ++k) {{",
                 f"  const float d = {L('k', 'k')};",
                 "  bad = bad || !(d > 0.f);",
                 "  const float piv = sqrtf(d);",
                 "  __syncwarp();  // every lane has read the pivot",
                 f"  if (lane == k % 32) {L('k', 'k')} = piv;",
                 f"  for (int r = k + 1 + lane; r < {size}; r += 32)",
                 f"    {L('r', 'k')} = {L('r', 'k')} / piv;",
                 "  __syncwarp();",
                 *("  " + line for line in _rank_one(
                     L, size, lambda j: L(j, "k"), lower=True)),
                 "  __syncwarp();",
                 "}"]
        nan = "__int_as_float(0x7fc00000)"
        if L is out:
            body += ["if (bad) {",
                     f"  for (int e = lane; e < {size * size}; e += 32)",
                     f"    ws[{base} + b * {size * size} + e] = {nan};",
                     "}"]
        else:
            body += [f"for (int e = lane; e < {size * size}; e += 32)",
                     f"  ws[{base} + b * {size * size} + e] = bad ? {nan} : "
                     f"{L(f'e / {size}', f'e % {size}')};"]
        body += ["__syncwarp();"]
        lines.append(f"for (int b = 0; b < {batch}; ++b) {{")
        lines.extend("  " + line for line in body)
        lines.append("}")

    def slogdet(self, nid, lines):
        """``(sign, log|det|)`` a matrix: lusolve's LU with partial
        pivoting (:meth:`_lu_here`: one for every node on the same
        matrix), then every lane flips the sign at each row swap and sums
        ``log|u_ii|`` in row order, multiplying the signs; lane 0 stores
        both."""
        n = self.ir.nodes[nid]
        (A,) = n.args
        batch = n.shape[0]
        size = self.ir.nodes[A].shape[-1]
        ba = self.ir.nodes[A].shape[0]
        base = self.sched.slots[nid]
        shared = self.uses_factor(nid) and nid not in self.lu_users
        LU, PIV, to_global = self._lu_of(nid, shared)
        body = self._lu_here(nid, LU, PIV, to_global,
                             Ix("b", batch) if ba > 1 else _ic(0))
        body += ["float sign = 1.f;",
                 f"for (int k = 0; k < {size}; ++k)",
                 f"  if ((int){PIV('k')} != k) sign = -sign;",
                 "float logabs = 0.f;",
                 f"for (int i = 0; i < {size}; ++i) {{",
                 f"  const float u = {LU('i', 'i')};",
                 "  logabs = logabs + logf(fabsf(u));",
                 "  sign = sign * gpg_sign(u);",
                 "}",
                 "if (lane == 0) {",
                 f"  ws[{base} + b * 2] = sign;",
                 f"  ws[{base} + b * 2 + 1] = logabs;",
                 "}",
                 "__syncwarp();"]
        lines.append(f"for (int b = 0; b < {batch}; ++b) {{")
        lines.extend("  " + line for line in body)
        lines.append("}")

    def eigh(self, nid, lines):
        """Cyclic Jacobi a matrix: its lower triangle, mirrored, into the
        workspace, V = I beside it; sweeps over the pairs p < q in row
        order until the off-diagonal Frobenius norm is at most 1e-7 of the
        matrix's (or 16 sweeps): each rotation (Numerical Recipes' t, c,
        s, computed alike by every lane) updates columns p and q of A and
        V, the lanes over the rows, then rows p and q, then lane 0 sets the
        2x2 block; then each lane ranks its eigenvalues (ascending, ties by
        index), fixes each eigenvector's sign (its largest component, the
        first of equals, positive) and writes its column."""
        n = self.ir.nodes[nid]
        (A,) = n.args
        batch, _, size = n.shape
        ba = self.ir.nodes[A].shape[0]
        base = self.sched.slots[nid]
        a0 = base + _numel(n.shape)
        v0 = a0 + size * size

        def M(i, j):
            return f"ws[{a0} + ({i}) * {size} + {j}]"

        def V(i, j):
            return f"ws[{v0} + ({i}) * {size} + {j}]"

        def E(i, j):
            return f"ws[{base} + b * {(size + 1) * size} + ({i}) * {size} + {j}]"

        body = self._copy(A, Ix("b", batch) if ba > 1 else _ic(0), size, M,
                          True)
        body += [f"for (int e = lane; e < {size * size}; e += 32)",
                 f"  ws[{v0} + e] = e / {size} == e % {size} ? 1.f : 0.f;",
                 "__syncwarp();",
                 "float norm = 0.f;",
                 f"for (int e = lane; e < {size * size}; e += 32)",
                 f"  norm = fmaf(ws[{a0} + e], ws[{a0} + e], norm);",
                 "norm = warp_sum(norm);",
                 "for (int sweep = 0; sweep < 16; ++sweep) {",
                 "  float off = 0.f;",
                 f"  for (int e = lane; e < {size * size}; e += 32)",
                 f"    if (e / {size} != e % {size})",
                 f"      off = fmaf(ws[{a0} + e], ws[{a0} + e], off);",
                 "  off = warp_sum(off);",
                 "  if (!(off > 1e-14f * norm)) break;",
                 f"  for (int p = 0; p < {size - 1}; ++p) {{",
                 f"    for (int q = p + 1; q < {size}; ++q) {{",
                 f"      const float apq = {M('p', 'q')};",
                 "      if (apq == 0.f) continue;",
                 f"      const float app = {M('p', 'p')}, aqq = {M('q', 'q')};",
                 "      const float theta = (aqq - app) / (2.f * apq);",
                 "      float t = fabsf(theta) > 1e18f ? 0.5f / fabsf(theta)",
                 "                : 1.f / (fabsf(theta) + "
                 "sqrtf(fmaf(theta, theta, 1.f)));",
                 "      if (theta < 0.f) t = -t;",
                 "      const float cs = 1.f / sqrtf(fmaf(t, t, 1.f));",
                 "      const float sn = t * cs;",
                 "      __syncwarp();  // every lane has read the pair",
                 f"      for (int r = lane; r < {size}; r += 32) {{",
                 f"        const float arp = {M('r', 'p')}, arq = {M('r', 'q')};",
                 f"        {M('r', 'p')} = fmaf(cs, arp, -(sn * arq));",
                 f"        {M('r', 'q')} = fmaf(sn, arp, cs * arq);",
                 f"        const float vrp = {V('r', 'p')}, vrq = {V('r', 'q')};",
                 f"        {V('r', 'p')} = fmaf(cs, vrp, -(sn * vrq));",
                 f"        {V('r', 'q')} = fmaf(sn, vrp, cs * vrq);",
                 "      }",
                 "      __syncwarp();",
                 f"      for (int r = lane; r < {size}; r += 32) {{",
                 f"        const float apr = {M('p', 'r')}, aqr = {M('q', 'r')};",
                 f"        {M('p', 'r')} = fmaf(cs, apr, -(sn * aqr));",
                 f"        {M('q', 'r')} = fmaf(sn, apr, cs * aqr);",
                 "      }",
                 "      __syncwarp();",
                 "      if (lane == 0) {",
                 f"        {M('p', 'q')} = 0.f;",
                 f"        {M('q', 'p')} = 0.f;",
                 f"        {M('p', 'p')} = fmaf(-t, apq, app);",
                 f"        {M('q', 'q')} = fmaf(t, apq, aqq);",
                 "      }",
                 "      __syncwarp();",
                 "    }",
                 "  }",
                 "}",
                 f"for (int i = lane; i < {size}; i += 32) {{",
                 f"  const float wi = {M('i', 'i')};",
                 "  int rank = 0;",
                 f"  for (int j = 0; j < {size}; ++j)",
                 f"    rank += gpg_sort_before({M('j', 'j')}, j, wi, i, false, "
                 f"{size}) ? 1 : 0;",
                 "  float big = -1.f, sg = 1.f;",
                 f"  for (int r = 0; r < {size}; ++r) {{",
                 f"    const float v = {V('r', 'i')};",
                 "    if (fabsf(v) > big) {",
                 "      big = fabsf(v);",
                 "      sg = v < 0.f ? -1.f : 1.f;",
                 "    }",
                 "  }",
                 f"  {E('0', 'rank')} = wi;",
                 f"  for (int r = 0; r < {size}; ++r)",
                 f"    {E('1 + r', 'rank')} = sg * {V('r', 'i')};",
                 "}",
                 "__syncwarp();"]
        lines.append(f"for (int b = 0; b < {batch}; ++b) {{")
        lines.extend("  " + line for line in body)
        lines.append("}")

    def sortidx(self, nid, lines):
        """A sort's (top-k's) indices, a line of the axis at a time: up to
        32 elements each lane ranks its element by counting those before
        it (ascending or descending, a NaN the largest, ties by index:
        torch's stable order) and writes its index at its rank if that is
        among the first k; longer axes run a bitonic network over (value,
        index) pairs in the workspace, padded to a power of two, and write
        the first k indices."""
        n = self.ir.nodes[nid]
        (x,) = n.args
        axis, desc, k = n.params
        src = self.ir.nodes[x].shape
        length = src[axis]
        rest = src[:axis] + src[axis + 1:]
        nrest = _numel(rest)
        m = _unflatten(Ix("m", nrest), rest)
        base = self.sched.slots[nid]
        d = "true" if desc else "false"

        def out(r):
            return self.slot(nid, _flatten((*m[:axis], Ix(r, k), *m[axis:]),
                                           n.shape))

        def elem(var, scope):
            return self.value(x, (*m[:axis], Ix(var, length), *m[axis:]),
                              scope)

        body = []
        width = _sort_width(length)
        if width == 0:
            own, other = _Scope(self), _Scope(self)
            vi, vj = elem("i", own), elem("j", other)
            body += [f"for (int i = lane; i < {length}; i += 32) {{",
                     *("  " + line for line in own.lines),
                     "  int rank = 0;",
                     f"  for (int j = 0; j < {length}; ++j) {{",
                     *("    " + line for line in other.lines),
                     f"    rank += gpg_sort_before({vj}, j, {vi}, i, {d}, "
                     f"{length}) ? 1 : 0;",
                     "  }",
                     f"  if (rank < {k}) {out('rank')} = (float)i;",
                     "}",
                     "__syncwarp();"]
        else:
            k0 = base + _numel(n.shape)
            i0 = k0 + width
            load = _Scope(self)
            v = elem("e", load)
            body += [f"for (int e = lane; e < {width}; e += 32) {{",
                     f"  if (e < {length}) {{",
                     *("    " + line for line in load.lines),
                     f"    ws[{k0} + e] = {v};",
                     "  } else {",
                     f"    ws[{k0} + e] = 0.f;",
                     "  }",
                     f"  ws[{i0} + e] = (float)e;",
                     "}",
                     "__syncwarp();",
                     f"for (int size = 2; size <= {width}; size <<= 1) {{",
                     "  for (int stride = size >> 1; stride > 0; "
                     "stride >>= 1) {",
                     f"    for (int t = lane; t < {width // 2}; t += 32) {{",
                     "      const int i = 2 * stride * (t / stride) + "
                     "t % stride, j = i + stride;",
                     f"      const float ki = ws[{k0} + i], kj = ws[{k0} + j];",
                     f"      const int ii = (int)ws[{i0} + i], "
                     f"ij = (int)ws[{i0} + j];",
                     f"      const bool swap = (i & size) == 0 ? "
                     f"gpg_sort_before(kj, ij, ki, ii, {d}, {length}) : "
                     f"gpg_sort_before(ki, ii, kj, ij, {d}, {length});",
                     "      if (swap) {",
                     f"        ws[{k0} + i] = kj;",
                     f"        ws[{k0} + j] = ki;",
                     f"        ws[{i0} + i] = (float)ij;",
                     f"        ws[{i0} + j] = (float)ii;",
                     "      }",
                     "    }",
                     "    __syncwarp();",
                     "  }",
                     "}",
                     f"for (int r = lane; r < {k}; r += 32) "
                     f"{out('r')} = ws[{i0} + r];",
                     "__syncwarp();"]
        lines.append(f"for (int m = 0; m < {nrest}; ++m) {{")
        lines.extend("  " + line for line in body)
        lines.append("}")

    def scatter_perm(self, nid, lines):
        """The base, lane-strided; then each lane writes its values at the
        positions the permutation names (distinct: no two lanes write one
        element)."""
        n = self.ir.nodes[nid]
        base, index, src = n.args
        axis = n.params[0]
        out = _numel(n.shape)
        ishape = self.ir.nodes[index].shape
        init = _Scope(self)
        v = self.value(base, _unflatten(Ix("o", out), n.shape), init)
        lines.append(f"for (int o = lane; o < {out}; o += 32) {{")
        lines.extend("  " + line for line in init.lines)
        lines.append(f"  {self.slot(nid, Ix('o', out))} = {v};")
        lines.append("}")
        lines.append("__syncwarp();")
        scan = _Scope(self)
        t = _unflatten(Ix("t", _numel(ishape)), ishape)
        k = self.value(index, t, scan)
        length = n.shape[axis]
        o = list(t)
        o[axis] = Ix(f"gpg_index({k}, {length})", length)
        val = self.value(src, t, scan)
        lines.append(f"for (int t = lane; t < {_numel(ishape)}; t += 32) {{")
        lines.extend("  " + line for line in scan.lines)
        lines.append(f"  {self.slot(nid, _flatten(o, n.shape))} = {val};")
        lines.append("}")
        lines.append("__syncwarp();")

    def scatter_reduce(self, nid, lines):
        """One lane an output (o in lane o % 32): its base (or, without
        it, its first value), then the values that land on it in input
        order (the host's preimage row: offsets, then the inputs by
        output), reduced by sum, product, maximum or minimum (NaN wins) or
        averaged over their count; an output no value lands on keeps its
        base."""
        base, pre, src = self.ir.nodes[nid].args
        reduce, include_self = self.ir.nodes[nid].params
        step = {"sum": "acc + v", "mean": "acc + v", "prod": "acc * v",
                "amax": "gpg_max(acc, v)", "amin": "gpg_min(acc, v)"}[reduce]
        mean = None
        if reduce == "mean":
            mean = "(hi - lo + 1)" if include_self else "(hi - lo)"
        self._preimage_loop(nid, lines, base, pre, src, step,
                            "" if include_self else "e == lo ? v : ", mean)

    def _preimage_loop(self, nid, lines, base, pre, src, step, first="",
                       mean=None):
        """In output o's lane (o in lane o % 32): ``acc`` = its base, then
        ``acc = step(acc, v)`` over the values ``src[pre[out + 1 + e]]``
        for e in ``[pre[o], pre[o + 1])``, in that (input) order (``first``:
        a prefix giving the first value itself), divided by the count
        ``mean`` where given, stored once."""
        n = self.ir.nodes[nid]
        out = _numel(n.shape)
        sshape = self.ir.nodes[src].shape
        nsrc = _numel(sshape)
        scope = _Scope(self)
        b = self.value(base, _unflatten(Ix("o", out), n.shape), scope)
        lo = self.load(pre, (Ix("o", out + 1),))
        hi = self.load(pre, (Ix("(o + 1)", out + 2),))
        inner = _Scope(self)
        t = self.load(pre, (Ix(f"({out + 1} + e)", out + 1 + nsrc),))
        v = self.value(src, _unflatten(Ix("t", nsrc), sshape), inner)
        lines += [f"for (int o = lane; o < {out}; o += 32) {{",
                  *("  " + line for line in scope.lines),
                  f"  const int lo = {lo}, hi = {hi};",
                  f"  float acc = {b};",
                  f"  for (int e = lo; e < hi; ++e) {{",
                  f"    const int t = {t};",
                  *("    " + line for line in inner.lines),
                  f"    const float v = {v};",
                  f"    acc = {first}{step};",
                  "  }"]
        if mean is not None:
            lines.append(f"  if (hi > lo) acc = acc / (float){mean};")
        lines += [f"  {self.slot(nid, Ix('o', out))} = acc;", "}",
                  "__syncwarp();"]


def _lu_factor(LU, size, on_pivot):
    """Lines of an LU with partial pivoting in place, column by column:
    every lane scans the column below the diagonal for the first largest
    ``|a|`` (LAPACK ``i?amax``'s pivot; after the search every lane runs
    ``on_pivot``: the pivot's record); the lanes swap the pivot row; the
    lanes split the rows below (row r in lane r % 32)
    to divide the column by the pivot, then the trailing update
    (:func:`_rank_one`: the lanes along each row, the pivot row's elements
    in registers), each element's terms in the order of k."""
    return [f"for (int k = 0; k < {size}; ++k) {{",
            "  int p = k;",
            f"  float top = fabsf({LU('k', 'k')});",
            f"  for (int r = k + 1; r < {size}; ++r) {{",
            f"    const float a = fabsf({LU('r', 'k')});",
            "    if (a > top) {",
            "      top = a;",
            "      p = r;",
            "    }",
            "  }",
            *("  " + line for line in on_pivot),
            "  __syncwarp();  // every lane has read the column",
            "  if (p != k) {",
            f"    for (int j = lane; j < {size}; j += 32) {{",
            f"      const float t = {LU('k', 'j')};",
            f"      {LU('k', 'j')} = {LU('p', 'j')};",
            f"      {LU('p', 'j')} = t;",
            "    }",
            "  }",
            "  __syncwarp();",
            f"  for (int r = k + 1 + lane; r < {size}; r += 32)",
            f"    {LU('r', 'k')} = {LU('r', 'k')} / {LU('k', 'k')};",
            "  __syncwarp();",
            *("  " + line for line in _rank_one(LU, size,
                                                 lambda j: LU("k", j))),
            "  __syncwarp();",
            "}"]


def _rank_one(M, size, mult, lower=False):
    """Lines of step k's trailing update of a factorisation, M[r][j] =
    fmaf(-M[r][k], mult(j), M[r][j]) for the rows r > k and the columns
    k < j (j <= r when ``lower``): the lanes along each row (columns lane,
    lane + 32, ...), each column's multiplier read once into a register,
    the rows RANK_ROWS at a time with every load before the first store
    (the rows of a batch are distinct elements, which the compiler cannot
    prove of indices it does not know)."""
    ns = -(-size // 32)
    rb = RANK_ROWS if ns <= 2 else RANK_ROWS // 2
    js = ["lane"] + [f"lane + {32 * s}" for s in range(1, ns)]
    lines = [f"const float m{s} = {j} > k && {j} < {size} ? {mult(j)} : 0.f;"
             for s, j in enumerate(js)]
    lines.append(f"for (int rb = k + 1; rb < {size}; rb += {rb}) {{")
    for u in range(rb):
        r = f"ro{u}"
        lines.append(f"  const int {r} = rb + {u};")
        lines.append(f"  const float l{u} = {r} < {size} ? {M(r, 'k')} : "
                     "0.f;")
        for s, j in enumerate(js):
            bound = f"{j} <= {r}" if lower else f"{j} < {size}"
            lines.append(f"  const bool w{u}_{s} = {r} < {size} && {j} > k "
                         f"&& {bound};")
            lines.append(f"  const float v{u}_{s} = w{u}_{s} ? {M(r, j)} : "
                         "0.f;")
    for u in range(rb):
        for s, j in enumerate(js):
            lines.append(f"  if (w{u}_{s}) {M(f'ro{u}', j)} = "
                         f"fmaf(-l{u}, m{s}, v{u}_{s});")
    lines.append("}")
    return lines


def _sum_loop(var, start, op, bound, sign, term):
    """Lines of a sequential sum's loop over ``var`` from ``start`` while
    ``var op bound``, stepping by ``sign``: SUM_UNROLL terms a trip, each
    term's loads (``term(v, u)`` -> (loads, updates) at index expression v,
    the u-th of the trip) before the trip's updates, which keep the order of
    terms; then the remaining terms one at a time.  A loop whose body only
    loads lets the loads of a trip wait together."""
    d = "+" if sign > 0 else "-"
    lines = [f"int {var} = {start};",
             f"for (; {var} {d} {SUM_UNROLL - 1} {op} {bound}; "
             f"{var} {d}= {SUM_UNROLL}) {{"]
    loads, updates = [], []
    for u in range(SUM_UNROLL):
        ld, up = term(var if u == 0 else f"({var} {d} {u})", u)
        loads += ld
        updates += up
    lines += ["  " + line for line in loads + updates] + ["}"]
    ld, up = term(var, 0)
    lines.append(f"for (; {var} {op} {bound}; {d}{d}{var}) {{")
    lines += ["  " + line for line in ld + up] + ["}"]
    return lines


def _factor_stride(size: int) -> int:
    """A matrix's row stride in the factor scratch: odd, so that the lanes
    reading down a column hit distinct banks."""
    return size | 1


def _factor_need(ir, nid) -> int:
    """Floats a chain of factor scratch node ``nid`` works in (0: none): a
    Cholesky or LU factor at its odd stride, an LU's pivots, a warp's
    columns of solutions (32 a row), or a triangular solve's matrix and its
    solutions."""
    n = ir.nodes[nid]
    if n.op in ("chol", "lufactor"):
        size = n.shape[-1]
        return size * _factor_stride(size)
    if n.op in ("lusolve", "slogdet"):
        size = ir.nodes[n.args[0]].shape[-1]
        return size * _factor_stride(size) + size + (
            32 * size if n.op == "lusolve" else 0)
    if n.op == "trsolve" and n.shape[-1] > 1:
        size, cols = n.shape[-2:]
        return size * _factor_stride(size) + 32 * min(
            SOLVE_COLUMNS, -(-cols // 32)) * size
    return 0


def _lu_owners(ir):
    """``{node: owner}`` of the LU solves and log-determinants of a matrix
    that an earlier node (its owner) factors: the same IR node, a batch of
    one.  The owner keeps its LU and pivots in the workspace after its
    output; the same values give the same factor and pivots, so sharing
    changes no result."""
    first, users = {}, {}
    for i, n in enumerate(ir.nodes):
        if n.op not in ("lusolve", "slogdet"):
            continue
        A = n.args[0]
        if ir.nodes[A].shape[0] != 1:
            continue
        if A in first:
            users[i] = first[A]
        else:
            first[A] = i
    return users


# contraction -> (the accumulator's first value, the warp's reduction)
_ACCUMULATE = {"sum": ("0.f", "warp_sum"), "mm": ("0.f", "warp_sum"),
               "amax": ("__int_as_float(0xff800000)", "gpg_warp_max"),
               "prod": ("1.f", "gpg_warp_prod")}


def _lane_stride(ir, nid, axis, stored):
    """Elements between the loads of neighbouring indices along ``axis`` of
    node ``nid`` (0: one element for all), or None where unknown."""
    n = ir.nodes[nid]
    if n.shape[axis] == 1 or n.op == "const":
        return 0
    if nid in stored or n.op in ("q", "data"):
        return _strides(n.shape)[axis]
    src = ir.nodes[n.args[0]].shape if n.args else ()
    if n.op == "permute":
        return _lane_stride(ir, n.args[0], n.params[axis], stored)
    if n.op == "reshape":
        out_axes = [k for k, d in enumerate(n.shape) if d != 1]
        in_axes = [k for k, d in enumerate(src) if d != 1]
        if [n.shape[k] for k in out_axes] != [src[k] for k in in_axes]:
            return None
        return _lane_stride(ir, n.args[0], in_axes[out_axes.index(axis)],
                            stored)
    if n.op == "slice":
        inner = _lane_stride(ir, n.args[0], axis, stored)
        step = n.params[2] if axis == n.params[0] else 1
        return None if inner is None else inner * step
    if n.op == "select":
        return _lane_stride(ir, n.args[0],
                            axis if axis < n.params[0] else axis + 1, stored)
    if n.op == "flip":
        return _lane_stride(ir, n.args[0], axis, stored)
    if n.op in ("put", "take", "diag_pad"):  # positions known at run time
        return None
    if n.op == "diagonal":
        offset, d1, d2 = n.params
        if axis == len(n.shape) - 1:
            a, b = (_lane_stride(ir, n.args[0], d, stored) for d in (d1, d2))
            return None if a is None or b is None else a + b
        rest = [d for d in range(len(src)) if d not in (d1, d2)]
        return _lane_stride(ir, n.args[0], rest[axis], stored)
    if n.op == "gather":
        first, rank = n.params[0], len(ir.nodes[n.args[1]].shape)
        if first <= axis < first + rank:
            return None
        return _lane_stride(ir, n.args[0],
                            axis if axis < first else axis - rank + 1, stored)
    # expand, elementwise, pad, cat: the widest of the arguments' loads
    steps = []
    for a in n.args:
        a_shape = ir.nodes[a].shape
        k = axis - (len(n.shape) - len(a_shape))
        if k >= 0 and (n.op != "cat" or k != n.params[0]):
            steps.append(_lane_stride(ir, a, k, stored))
    if any(st is None for st in steps):
        return None
    return max(steps, default=0)


def _reshape_index(idx, out_shape, in_shape) -> tuple:
    """The index into ``in_shape`` of element ``idx`` of its reshape to
    ``out_shape`` (row-major order kept)."""
    out_axes = [k for k, s in enumerate(out_shape) if s != 1]
    in_axes = [k for k, s in enumerate(in_shape) if s != 1]
    if [out_shape[k] for k in out_axes] == [in_shape[k] for k in in_axes]:
        inner = [_ic(0)] * len(in_shape)
        for ko, ki in zip(out_axes, in_axes):
            inner[ki] = idx[ko]
        return tuple(inner)
    return _unflatten(_flatten(idx, out_shape), in_shape)


def geometry_of(ir: IR):
    """The functor's geometry (:func:`launch_plan.generic_geometry`): its
    resident and streamed data operands, tile and workspace placement."""
    sched = schedule(ir)
    return generic_geometry(ir.dim, sched.workspace,
                            tuple(_numel(s) for s in ir.data_shapes),
                            _Emitter(ir, sched).streamable(),
                            tuple(_factor_need(ir, i)
                                  for i in range(len(ir.nodes))),
                            any(n.op in ("lusolve", "slogdet", "lufactor")
                                for n in ir.nodes))


def emit_cuda(ir: IR) -> str:
    """The C++ text of ``struct GenericPG``, the device functor of ``ir`` to
    the NUTS core's contract (``csrc/nuts_core.cuh``, helpers in
    ``csrc/generic_pg.cuh``), with its geometry (:func:`geometry_of`) in
    its text.  Deterministic: the same IR gives the same text."""
    sched = schedule(ir)
    geo = geometry_of(ir)
    em = _Emitter(ir, sched, geo)
    body = em.body()
    lengths = ", ".join(str(_numel(s)) for s in ir.data_shapes) or "0"
    data_ptrs = []
    for j in range(len(ir.data_shapes)):
        ctype = "float" if ir.data_kinds[j] == "f" else "int"
        if j in em.resident:
            off = next(o for i, o, _ in geo.resident if i == j)
            data_ptrs.append(
                f"    const {ctype}* __restrict__ R{j} = "
                + (f"S.res + {off};" if ctype == "float" else
                   f"reinterpret_cast<const int*>(S.res + {off});"))
        elif ctype == "float":
            data_ptrs.append(f"    const float* __restrict__ D{j} = "
                             f"data.ptr[{j}];")
        else:
            data_ptrs.append(f"    const int* __restrict__ D{j} = "
                             f"int_row({j});")
    request = [f"    make_resident(S, {j}, {off}, {n});"
               for j, off, n in geo.resident]
    places = ", ".join(f"{j} {geo.kind(j)}"
                       for j in range(len(ir.data_shapes))) or "none"
    ops = sorted({n.op for n in ir.nodes})
    head = [
        "// Generated by aehmc_tpu_torch/ops/generic_pg.py:emit_cuda from the",
        f"// traced potential {ir.key()}: dim {ir.dim}, layout {ir.layout},",
        f"// {len(ir.nodes)} IR nodes ({', '.join(ops)}),",
        f"// {len(ir.data_shapes)} data operands of "
        f"{', '.join(str(s) for s in ir.data_shapes) or 'none'}",
        f"// ({places}; {em.fills} tile fills a call).",
        "struct GenericPG : aehmc::generic::Base {",
        f"  static constexpr int DIM = {ir.dim};",
        f"  static constexpr int W = {sched.workspace};",
        f"  static constexpr bool WS_SHARED = "
        f"{'true' if geo.ws_shared else 'false'};",
        f"  static constexpr int NDATA = {len(ir.data_shapes)};",
        f"  static constexpr int RES_FLOATS = {geo.resident_floats};",
        f"  static constexpr int TILE_ROWS = {geo.points};",
        f"  static constexpr int TILE_STRIDE = {geo.row_stride};",
        f"  static constexpr int TILE_FLOATS = {geo.tile_floats};",
        f"  static constexpr int FS_FLOATS = {geo.factor_floats};",
        "",
        "  bool fits(int dim, const aehmc::Geometry& G) const {",
        f"    static const long long lengths[] = {{{lengths}}};",
        "    return dim == DIM && tile_is(G, TILE_ROWS, TILE_STRIDE) &&",
        "           lengths_are(lengths, NDATA) &&",
        "           (W == 0 || WS_SHARED || ws_global);",
        "  }",
        "",
        "  static __device__ Scratch carve_scratch(float* base, int) {",
        "    return carve<WS_SHARED, RES_FLOATS, TILE_FLOATS, W, FS_FLOATS>("
        "base);",
        "  }",
        "",
        "  __device__ void request(const Scratch& S) const {",
        *request,
        "    (void)S;",
        "  }",
        "",
        "  __device__ void operator()(const Scratch& S, int, int ds,",
        "                             const float* q, float* grad,",
        "                             bool = false) const {",
        "    const int c = threadIdx.x / 32, lane = threadIdx.x % 32;",
        "    const float* __restrict__ qc = q + c * ds;",
        "    float* __restrict__ gc = grad + c * ds;",
        "    float* __restrict__ ws = chain_workspace<WS_SHARED, W>(S, c);",
        "    (void)qc;",
        "    (void)ws;",
        *data_ptrs,
        *(["    float* __restrict__ fs = chain_factor<FS_FLOATS>(S, c);"]
          if geo.factor_floats else []),
    ]
    tail = ["  }", "};", ""]
    return "\n".join(head + ["    " + line for line in body] + tail)


# ------------------------------------------------------------ binding ----

@dataclass
class Bound:
    """A potential bound for the card: its IR, the hoisted constants (data
    operands after the caller's), the functor's text, workspace floats a
    chain and geometry (:func:`geometry_of`), which every launch plan on
    it takes."""

    ir: IR
    constants: tuple
    source: str
    workspace: int
    ops: tuple
    geometry: object = None
    # (integer operand, device) -> (a weak reference to its tensor, its
    # _version, the int32 row on that device); device -> (weak references
    # to the base operands, their _versions, the derived rows there)
    _rows: dict = field(default_factory=dict, repr=False)
    _derived: dict = field(default_factory=dict, repr=False)

    def __post_init__(self):
        self.index_bounds = self.ir.index_bounds()

    def library(self):
        """The kernels 1-4 built on this functor (built once per text)."""
        from aehmc_tpu_torch.ops._build import load_generated

        return load_generated(self.source)

    def operands(self, data, device) -> tuple:
        """The data operands of a launch: the caller's data, then the
        hoisted constants, contiguous on ``device``: float32, and int32
        rows of the integer operands (an index checked to lie in its
        axis: ``IndexError`` if not)."""
        device = torch.device(device)
        ops = []
        operands = (*data, *self.constants)
        if len(operands) != self.ir.num_base_data:
            raise ValueError(f"{len(operands)} data operands; the potential "
                             f"was traced with {self.ir.num_base_data}")
        for j, d in enumerate(operands):
            kind = self.ir.data_kinds[j]
            dtypes = INT_DTYPES if kind == "i" else (torch.float32,)
            if not isinstance(d, torch.Tensor) or d.dtype not in dtypes:
                raise TypeError(
                    f"data operand {j} must be a "
                    f"{'int32 or int64' if kind == 'i' else 'float32'} "
                    f"tensor, got {getattr(d, 'dtype', type(d).__name__)}")
            if kind == "i":
                ops.append(self._int_row(j, d, device))
                continue
            if d.device != device or not d.is_contiguous():
                d = self._float_row(j, d, device)
            ops.append(d)
        ops.extend(self._derived_rows(operands, device))
        shapes = tuple(tuple(d.shape) for d in ops)
        if shapes != self.ir.data_shapes:
            raise ValueError(f"data operands of shapes {shapes}; the potential "
                             f"was traced with {self.ir.data_shapes}")
        return tuple(ops)

    def _derived_rows(self, operands, device):
        """The derived index rows as int32 on ``device``, evaluated again
        whenever a base operand or its values (its ``_version``) change."""
        if not self.ir.derived:
            return ()
        hit = self._derived.get(device)
        versions = tuple(d._version for d in operands)
        if hit is not None and versions == hit[1] and all(
                r() is d for r, d in zip(hit[0], operands)):
            return hit[2]
        rows = []
        for d in derived_operands(self.ir, operands):
            if d.is_floating_point():  # a folded value, rounded once
                rows.append(d.to(device=device,
                                 dtype=torch.float32).contiguous())
                continue
            if d.numel() and (int(d.min()) < -2**31 or int(d.max()) >= 2**31):
                raise ValueError("a derived index row does not fit int32")
            rows.append(d.to(device=device, dtype=torch.int32).contiguous())
        rows = tuple(rows)
        self._derived[device] = (tuple(weakref.ref(d) for d in operands),
                                 versions, rows)
        return rows

    def _float_row(self, j, d, device):
        """Float32 operand ``j`` contiguous on ``device`` (a constant that a
        ``torch.distributions`` object made on the CPU, say), copied again
        only when the tensor or its values change, so a launch copies
        nothing (and a CUDA graph may capture it)."""
        hit = self._rows.get((j, device))
        if hit is not None and hit[0]() is d and hit[1] == d._version:
            return hit[2]
        row = d.to(device).contiguous()
        self._rows[(j, device)] = (weakref.ref(d), d._version, row)
        return row

    def _int_row(self, j, d, device):
        """Operand ``j`` as int32 on ``device``, checked and converted again
        whenever the tensor or its values (its ``_version``) change.  Each
        device keeps its own row, so the shards of a mesh each hit."""
        hit = self._rows.get((j, device))
        if hit is not None and hit[0]() is d and hit[1] == d._version:
            return hit[2]
        length = self.index_bounds.get(j)
        if length is not None:
            check_index(d, length)
        if d.dtype == torch.int64 and d.numel() and (
                int(d.min()) < -2**31 or int(d.max()) >= 2**31):
            raise ValueError(f"integer data operand {j} does not fit int32")
        row = d.to(device=device, dtype=torch.int32).contiguous()
        self._rows[(j, device)] = (weakref.ref(d), d._version, row)
        return row


# potential function -> {(layout, dim, with_grad, data signature): Bound}
_BOUND = weakref.WeakKeyDictionary()


def bind(fn: Callable, data: Sequence[torch.Tensor], dim: int, *,
         layout: str = "t", with_grad: bool = True, device=None) -> Bound:
    """Trace, compile (to text) and cache the functor of ``fn``: one trace
    per function, layout, dim and data signature, so a warmup's launches
    trace once; the library is built once per text
    (:meth:`Bound.library`)."""
    data = _require_data(data)
    device = torch.device(device) if device is not None else (
        data[0].device if data else torch.device("cpu"))
    key = (layout, dim, with_grad, str(device),
           tuple((tuple(d.shape), str(d.dtype), str(d.device)) for d in data))
    try:
        cache = _BOUND.setdefault(fn, {})
    except TypeError:  # not weakly referenceable: no cache
        cache = {}
    if key not in cache:
        traced = trace_potential(fn, data, dim, layout=layout,
                                 with_grad=with_grad, device=device)
        cache[key] = Bound(traced.ir, traced.constants,
                           emit_cuda(traced.ir),
                           schedule(traced.ir).workspace, traced.ops,
                           geometry_of(traced.ir))
    bound = cache[key]
    for j in bound.index_bounds:  # the caller's indices, as they are now
        if j < len(data):
            bound._int_row(j, data[j], device)
    if bound.ir.derived:  # the rows computed from them, checked
        bound._derived_rows((*data, *bound.constants), device)
    return bound


def launch_operands(bound: Bound, data, device, blocks: int):
    """ctypes arguments naming the potential in a generic launcher: the
    table of data pointers and lengths (float32 data, and the int32 rows
    of integer operands, each checked against its axis when its tensor or
    values change: :meth:`Bound.operands`), its size, and the global
    workspace (allocated here when the plan keeps it out of shared memory),
    plus the tensors to keep alive until the launch is queued."""
    import ctypes

    from aehmc_tpu_torch.ops.launch_plan import generic_workspace_floats

    ops = bound.operands(data, device)
    if len(ops) > MAX_DATA:
        raise ValueError(f"{len(ops)} data operands; the functor takes at "
                         f"most {MAX_DATA}")
    ptrs = (ctypes.c_void_p * MAX_DATA)(*[d.data_ptr() for d in ops])
    lens = (ctypes.c_longlong * MAX_DATA)(*[d.numel() for d in ops])
    floats = generic_workspace_floats(bound.geometry, blocks)
    ws = (torch.empty(floats, dtype=torch.float32, device=device)
          if floats else None)
    return (ptrs, lens, len(ops), None if ws is None else ws.data_ptr()), \
        (ops, ws)
