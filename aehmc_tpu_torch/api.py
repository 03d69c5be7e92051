"""The front door: ``sample(...)`` (port of :mod:`aehmc_tpu.api`).

Three paths, picked as the JAX package picks them (``path="auto"``):

- **xla**: the XLA-path kernels for any ``logprob_fn``
  (:mod:`aehmc_tpu_torch.nuts`, ``hmc``, ``mala``, ``ghmc``): a 1-D (or
  scalar) position runs one chain through
  :func:`aehmc_tpu_torch.sampling.sample`, a ``(chains, dim)`` position one
  independent chain per row (:func:`~aehmc_tpu_torch.sampling.sample_chains`);
  ChEES and MEADS, chain-ensemble methods, take the pooled driver;
- **pooled** (the default for a 2-D position): pooled cross-chain warmup
  and sampling of the batch,
  :func:`aehmc_tpu_torch.parallel.sample_sharded`;
- **fused** (the default for a 2-D position with a transposed potential
  given): the CUDA kernels' drivers; NUTS runs Stan warmup through the
  per-transition NUTS kernel and the whole sampling phase in one launch,
  MALA and GHMC through the GHMC transition and segment kernels, ChEES the
  pooled ChEES driver over the ChEES transition kernel, MEADS the pooled
  MEADS driver over the GHMC segment kernel (one launch a
  ``meads_recompute_every``-draw segment) or, with ``checkpoint_every``,
  the GHMC transition kernel (one launch a draw).

A bare ``logprob_fn`` on the fused path takes the generic fused binding
(:func:`_generic_fused_binding`, as the JAX package's): a transposed
potential and its data rows, which the plain versions run on CPU tensors
and every fused kernel (NUTS 1-4, GHMC and MALA 5-6, ChEES 7, MEADS 5-6)
runs on the card through a functor generated from the potential's traced
gradient graph (:mod:`aehmc_tpu_torch.ops.generic_pg`).  ``mesh=``
(:func:`aehmc_tpu_torch.parallel.make_mesh`) shards the chains of the
pooled route and of the fused NUTS, ChEES and MEADS routes over its
devices; the fused routes' runs equal the unsharded ones bit for bit on
the card. The fused MALA and GHMC routes take none (``ValueError``), as
in the JAX package.
"""

import math
import operator
from typing import Callable, Optional, Sequence

import torch

from aehmc_tpu_torch.ops.chees_fused import make_fused_chees_kernel
from aehmc_tpu_torch.ops.ghmc_fused import (
    make_fused_meads_segment,
    make_fused_meads_transition,
)
from aehmc_tpu_torch.ops.fused_driver import (
    sample_fused_adaptive,
    sample_fused_ghmc,
)
from aehmc_tpu_torch import sampling
from aehmc_tpu_torch.parallel.pooled import sample_sharded
from aehmc_tpu_torch.sampling import SampleResult
from aehmc_tpu_torch.types import Diagnostics

ALGORITHMS = ("nuts", "hmc", "chees", "meads", "ghmc", "mala")
PATHS = ("auto", "xla", "pooled", "fused")
# the JAX package's fused algorithms, which path="auto" sends to "fused"
_FUSED_ALGORITHMS = ("nuts", "chees", "meads", "mala", "ghmc")
# keyword arguments of the ChEES route that build its kernel
_CHEES_KERNEL_KWARGS = ("block_chains", "use_internal_prng", "step_size_factors")
# ... and of the MEADS route
_MEADS_KERNEL_KWARGS = ("block_chains", "use_internal_prng")


def _resolve_path(path, initial_position, potential_fn_t,
                  potential_and_grad_t, algorithm):
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if path != "auto":
        return path
    if initial_position.ndim <= 1:
        return "xla"
    if ((potential_fn_t is not None or potential_and_grad_t is not None)
            and algorithm in _FUSED_ALGORITHMS):
        return "fused"
    return "pooled"


def _generic_fused_binding(logprob_fn: Callable, dim: int, device=None):
    """Transposed-batch potential and data rows from a per-chain logprob
    (port of the JAX package's ``_generic_fused_binding``).

    ``q_t`` is ``(dim, C)``; vmapping the logprob over axis 1 gives the
    ``(C,)`` potential row the transposed kernels take.  Tensors the
    logprob closes over become data operands, as ``jax.closure_convert``
    makes them: the logprob is traced once (``make_fx`` on a float32
    ``(dim,)`` probe), each closed-over tensor becomes an input of the
    traced graph and travels as a flat ``(1, n)`` data row in its own
    dtype, reshaped back inside the potential: an integer tensor (an index
    vector, counts) stays an integer row, which the generated functor
    reads as int32 (a view of the tensor, so changed values are read
    anew).  The trace is functionalized, so a logprob may assign into a
    tensor it makes (``ll = torch.zeros(n); ll[mask] = ...``), and runs
    with ``torch.distributions``' argument validation off (a host check
    on the values), the caller's setting restored after.  Returns
    ``(potential_t, data)``."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from aehmc_tpu_torch.ops.generic_pg import no_validation

    # functionalized: an indexed assignment into a tensor the logprob
    # makes (``ll[obs] = ...``) becomes an index_put the vmap below takes;
    # torch.distributions traced with argument validation off
    with no_validation():
        gm = make_fx(torch.func.functionalize(logprob_fn))(
            torch.zeros(dim, dtype=torch.float32, device=device))
    graph = gm.graph
    last = next(n for n in graph.nodes if n.op == "placeholder")
    inputs, consts = {}, []
    for node in list(graph.nodes):
        if node.op != "get_attr":
            continue
        if node.target not in inputs:
            with graph.inserting_after(last):
                last = graph.placeholder(f"closed_{len(consts)}")
            inputs[node.target] = last
            consts.append(getattr(gm, node.target))
        node.replace_all_uses_with(inputs[node.target])
        graph.erase_node(node)
    _nan_for_failed_factors(graph)
    _vmap_safe(graph)
    if device is not None:
        _on_device(graph, torch.device(device))
    graph.lint()
    closed = torch.fx.GraphModule(gm, graph)
    specs = [(tuple(c.shape), c.dtype) for c in consts]
    # on the probe's device: a constant made on the CPU inside the logprob
    # (a torch.distributions parameter given as a number) goes along
    data = [c.reshape(1, -1) if device is None else
            c.reshape(1, -1).to(device) for c in consts]

    def potential_t(q_t, *rows):
        if len(rows) != len(specs):
            raise ValueError(
                f"the generic fused potential takes {len(specs)} data rows, "
                f"got {len(rows)}; pass an explicit potential_fn_t/data "
                "binding instead")
        args = [r.reshape(shape).to(dtype)
                for r, (shape, dtype) in zip(rows, specs)]
        return -torch.func.vmap(lambda q: closed(q, *args), in_dims=1)(q_t)

    return potential_t, data


def _nan_for_failed_factors(graph):
    """The fused kernels' rule on a failed factorisation, on the graph the
    binding runs on CPU tensors too: a Cholesky factor is NaN where its
    matrix is not positive definite (JAX's cholesky), and no
    ``_linalg_check_errors`` raises (a singular solve gives what its LU
    gives), so such a position is a divergent leaf, never an exception."""
    aten = torch.ops.aten
    for node in list(graph.nodes):
        if node.op != "call_function":
            continue
        if node.target == aten._linalg_check_errors.default:
            graph.erase_node(node)
        elif node.target == aten.linalg_cholesky_ex.default:
            factor = next((u for u in node.users if u.args[1] == 0), None)
            if factor is None:
                continue
            last = [factor]

            def after(target, args):
                with graph.inserting_after(last[0]):
                    last[0] = graph.call_function(target, args)
                return last[0]

            info = after(operator.getitem, (node, 1))
            bad = after(aten.ne.Scalar, (info, 0))
            bad = after(aten.unsqueeze.default, (bad, -1))
            bad = after(aten.unsqueeze.default, (bad, -1))
            nan = after(aten.where.ScalarSelf, (bad, math.nan, factor))
            factor.replace_all_uses_with(nan)
            nan.update_arg(2, factor)


def _vmap_safe(graph):
    """Rewrites of a functionalized graph that vmap and autograd take,
    each computing what it replaces: a strided write through a flat view
    (``K.view(-1, m * m)[:, ::m + 1] += 1`` in
    ``torch.distributions.LowRankMultivariateNormal``) functionalizes to
    slices and a ``slice_scatter`` whose end is the largest int64, which
    vmap's batching rule rejects (``invalid size, possible overflow?``) once
    the step exceeds 1: the end is clamped to its axis; the functional
    ``copy(dst, src)`` it leaves, which has no derivative, becomes ``src``
    expanded to ``dst``'s shape (and converted to its dtype); and a write
    under a bool mask that depends on q (``_masked_write_as_where``)
    becomes a ``where``."""
    aten = torch.ops.aten
    ends = {aten.slice.Tensor: (1, 3), aten.slice_scatter.default: (2, 4)}
    on_q = set()  # the nodes that depend on the position
    for node in list(graph.nodes):
        if node.op == "placeholder" and not on_q:
            on_q.add(node)
        if node.op != "call_function":
            continue
        if any(a in on_q for a in node.all_input_nodes):
            on_q.add(node)
        if node.target == aten.index_put.default:
            _masked_write_as_where(graph, node, on_q)
        elif node.target in ends:
            dim_at, end_at = ends[node.target]
            val = node.args[0].meta.get("val")
            args = list(node.args)
            if val is None or len(args) <= end_at or \
                    not isinstance(args[end_at], int):
                continue
            dim = args[dim_at] if len(args) > dim_at else 0
            args[end_at] = min(args[end_at], val.shape[dim])
            node.args = tuple(args)
        elif node.target == aten.copy.default:
            dst, src = node.args[:2]
            with graph.inserting_before(node):
                out = graph.call_function(
                    aten.expand.default,
                    (src, list(dst.meta["val"].shape)))
                out = graph.call_function(aten.clone.default, (out,))
                dtype = dst.meta["val"].dtype
                if src.meta["val"].dtype != dtype:
                    out = graph.call_function(aten._to_copy.default, (out,),
                                              {"dtype": dtype})
            node.replace_all_uses_with(out)
            graph.erase_node(node)


def _on_device(graph, device):
    """Every tensor the graph makes, made on the probe's device: a factory
    traced with another device (a CPU default inside a library's code)
    would meet the device's values when the binding re-runs the graph."""
    for node in graph.nodes:
        if node.op != "call_function" or "device" not in node.kwargs:
            continue
        at = node.kwargs["device"]
        if isinstance(at, torch.device) and at != device:
            node.kwargs = {**node.kwargs, "device": device}


def _masked_write_as_where(graph, node, on_q):
    """``x[mask] = v`` (``index_put`` without accumulate) with one bool
    mask over x's leading axes that depends on q and a value that
    broadcasts to an element's trailing shape, as
    ``torch.distributions.Geometric`` and ``Multinomial`` write it: the
    shape is kept, so it is ``where(mask, v, x)``, which vmap batches (a
    bool index under vmap is refused)."""
    aten = torch.ops.aten
    x, indices, v = node.args[:3]
    accumulate = node.args[3] if len(node.args) > 3 else node.kwargs.get(
        "accumulate", False)
    if accumulate or len(indices) != 1 or indices[0] not in on_q:
        return
    mask = indices[0]
    xv, mv = x.meta.get("val"), mask.meta.get("val")
    vv = v.meta.get("val") if isinstance(v, torch.fx.Node) else None
    if xv is None or mv is None or vv is None or mv.dtype != torch.bool:
        return
    k = mv.ndim
    rest = tuple(xv.shape[k:])
    if tuple(mv.shape) != tuple(xv.shape[:k]) or vv.ndim > len(rest) or any(
            a not in (1, b) for a, b in zip(tuple(vv.shape)[::-1],
                                            rest[::-1])):
        return
    with graph.inserting_before(node):
        m = graph.call_function(aten.view.default,
                                (mask, [*mv.shape, *(1,) * len(rest)]))
        if vv.dtype != xv.dtype:
            v = graph.call_function(aten._to_copy.default, (v,),
                                    {"dtype": xv.dtype})
        out = graph.call_function(aten.where.self, (m, v, x))
    node.replace_all_uses_with(out)
    graph.erase_node(node)


def _fused_nuts_result(out) -> SampleResult:
    """The fused driver's return as a ``SampleResult``: stats columns
    ``[energy, accept, doublings, leaves, diverging, turning]`` are the
    fields of ``Diagnostics`` (GHMC's are ``[energy, accept, 0, steps,
    diverging, 0]``: no doublings, never turning)."""
    final_positions, positions, stats, eps, imm = out
    diag = Diagnostics(
        acceptance_probability=stats[..., 1],
        num_doublings=stats[..., 2].to(torch.int32),
        is_turning=stats[..., 5] > 0.5,
        is_diverging=stats[..., 4] > 0.5,
        energy=stats[..., 0],
        num_integration_steps=stats[..., 3].to(torch.int32),
    )
    return SampleResult(
        final_state=final_positions,
        positions=positions,
        diagnostics=diag,
        step_size=eps,
        inverse_mass_matrix=imm,
    )


def sample(
    generator,
    logprob_fn: Optional[Callable],
    initial_position: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    *,
    algorithm: str = "nuts",
    path: str = "auto",
    mesh=None,
    data: Sequence[torch.Tensor] = (),
    potential_fn_t: Optional[Callable] = None,
    potential_and_grad_t: Optional[Callable] = None,
    **kwargs,
) -> SampleResult:
    """Warmup + sampling in one call.

    ``generator`` (a ``torch.Generator``, or a key of
    :mod:`aehmc_tpu_torch.keys`) is the only source of randomness: the same
    generator state reproduces the run bit for bit.  ``logprob_fn`` maps
    one position to its log-density (a scalar); it may be None only on the
    fused NUTS, MALA and GHMC routes with a transposed potential.  The
    chains run on the device of ``initial_position``: ``(dim,)`` (or a
    scalar) runs one chain on the XLA path, ``(chains, dim)`` a chain batch
    (pooled by default).  Positions are ``(draws, dim)`` for one chain,
    ``(chains, draws, dim)`` for independent XLA chains and ``(draws,
    chains, dim)`` on the pooled and fused paths.

    The XLA and pooled routes take ``kwargs`` of
    :func:`aehmc_tpu_torch.sampling.sample` and
    :func:`aehmc_tpu_torch.parallel.sample_sharded` (``max_num_expansions``
    10, ``num_integration_steps`` 32, ``initial_step_size`` 1.0,
    ``search_initial_step_size`` True, ``per_chain_step_size`` on the
    pooled path, ``chees_kernel_fn`` for ChEES, e.g. the XLA ChEES kernel
    on kernel 8: ``chees.new_kernel(logprob_fn,
    integrate_fn=ops.logistic_integrate_fn(X, y))``,
    ``meads_recompute_every`` for MEADS, and on every pooled branch
    ``checkpoint_every``/``checkpoint_path``/``resume`` and
    ``progress_every``).

    The fused routes take the transposed ``potential_fn_t(q_t, *data)``
    and/or ``potential_and_grad_t(q_t, *data) -> (u, g)``.  On a CUDA device
    every fused route (NUTS, MALA, GHMC, ChEES, MEADS) runs
    ``models.logistic_pg_t`` (``models.logistic_regression_pg_t``) in a
    hand-written device functor, picked by the identity of
    ``potential_and_grad_t``, and so does the NUTS route
    ``models.funnel_pg_t`` (``models.neals_funnel_pg_t``) and
    ``models.schools_pg_t`` (``models.eight_schools_pg_t``).  Any other
    float32 potential (or a bare ``logprob_fn``, through
    :func:`_generic_fused_binding`), and the funnel and eight schools on the
    MALA, GHMC, ChEES and MEADS routes, run in a functor generated from the
    potential's traced gradient graph; a potential no functor takes (an op
    outside the compiler's table, ROADMAP.md item 1.10c) raises before any
    launch.  ``kwargs`` go to
    :func:`aehmc_tpu_torch.ops.fused_driver.sample_fused_adaptive` for NUTS
    (``max_num_expansions`` defaults to 6; ``loop_in_kernel`` to True
    unless ``checkpoint_every`` or ``sort_by_depth`` is given, whose draws
    need one launch each; the draws are the same bits either way) and to
    :func:`aehmc_tpu_torch.ops.fused_driver.sample_fused_ghmc` for MALA and
    GHMC (``ghmc_alpha``, the GHMC momentum persistence, defaults to 0.9).
    Both take the JAX drivers' ``per_chain_step_size``,
    ``per_chain_quantiles``, ``per_chain_quantile_stat`` and
    ``search_initial_step_size``; NUTS also ``sort_by_depth`` and
    ``step_size_factors``.
    ``mesh`` (:mod:`aehmc_tpu_torch.parallel.mesh`, one process driving
    its devices) shards the chain axis on the pooled route and the fused
    NUTS, ChEES and MEADS routes (MEADS then on the per-draw transition
    kernel: the segment kernel has no shard adapter); fused MALA and GHMC
    raise ``ValueError``.  With ``mesh=None`` every route runs on the
    positions' device, however many cards there are (the JAX package
    shards the pooled route over all of them; a torch ``logprob_fn``'s
    closed-over tensors stay on their own card, so the port shards only
    over a mesh the caller passes).
    Fused ChEES needs ``logprob_fn`` to start its chain states;
    ``block_chains``, ``use_internal_prng``, ``step_size_factors`` and
    ``divergence_threshold`` build its kernel
    (:func:`aehmc_tpu_torch.ops.chees_fused.make_fused_chees_kernel`), the
    others go to :func:`aehmc_tpu_torch.parallel.sample_sharded`; its
    ``generator`` may be a key source ``(phase, index) -> key`` that
    replays given randomness.  Fused MEADS needs ``logprob_fn`` too;
    ``block_chains``, ``use_internal_prng`` and ``divergence_threshold``
    build its kernel adapter, ``meads_recompute_every`` defaults to 8, and
    the others go to :func:`~aehmc_tpu_torch.parallel.sample_sharded`.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
    route = _resolve_path(path, initial_position, potential_fn_t,
                          potential_and_grad_t, algorithm)
    if logprob_fn is None and not (
        route == "fused" and algorithm in ("nuts", "mala", "ghmc")
        and (potential_fn_t is not None or potential_and_grad_t is not None)
    ):
        raise ValueError(
            "logprob_fn may be None only on the fused NUTS/MALA/GHMC routes "
            "with an explicit potential_fn_t/potential_and_grad_t binding"
        )
    if route == "xla":
        if initial_position.ndim <= 1:
            if algorithm in ("chees", "meads"):
                raise ValueError(
                    f"{algorithm!r} is a chain-ensemble method (cross-chain "
                    "adaptation); pass a (chains, dim) initial_position"
                )
            return sampling.sample(generator, logprob_fn, initial_position,
                                   num_samples, num_warmup,
                                   algorithm=algorithm, **kwargs)
        if algorithm in ("chees", "meads"):
            # an ensemble method has no independent-chain mode: its XLA
            # route is the pooled driver
            route = "pooled"
        else:
            return sampling.sample_chains(generator, logprob_fn,
                                          initial_position, num_samples,
                                          num_warmup, algorithm=algorithm,
                                          **kwargs)
    if initial_position.ndim != 2:
        raise ValueError(
            f"path={route!r} needs a (chains, dim) initial_position, got "
            f"shape {tuple(initial_position.shape)}"
        )
    if route == "pooled":
        return sample_sharded(generator, logprob_fn, initial_position,
                              num_samples, num_warmup, algorithm=algorithm,
                              mesh=mesh, **kwargs)

    # route == "fused"
    if algorithm == "hmc":
        raise ValueError(
            "no fused megakernel for algorithm='hmc' (fused paths: "
            "nuts, mala, ghmc, chees); use path='pooled': plain HMC runs the "
            "XLA kernels (its fused analog with adaptive trajectory lengths "
            "is algorithm='chees')"
        )
    if potential_fn_t is None and potential_and_grad_t is None:
        potential_fn_t, data = _generic_fused_binding(
            logprob_fn, initial_position.shape[1], initial_position.device)
    if algorithm == "chees":
        kernel_kwargs = {k: kwargs.pop(k) for k in _CHEES_KERNEL_KWARGS
                         if k in kwargs}
        if "divergence_threshold" in kwargs:
            # the threshold parameterizes both the kernel and the driver
            kernel_kwargs["divergence_threshold"] = kwargs[
                "divergence_threshold"]
        kernel_fn = make_fused_chees_kernel(
            potential_fn_t, tuple(data),
            potential_and_grad_t=potential_and_grad_t, mesh=mesh,
            num_chains=initial_position.shape[0], **kernel_kwargs,
        )
        return sample_sharded(
            generator, logprob_fn, initial_position.to(torch.float32),
            num_samples, num_warmup, algorithm="chees", mesh=mesh,
            chees_kernel_fn=kernel_fn, **kwargs,
        )
    if algorithm == "meads":
        return _fused_meads(generator, logprob_fn, initial_position,
                            num_samples, num_warmup, data, potential_fn_t,
                            potential_and_grad_t, mesh, kwargs)
    if algorithm in ("mala", "ghmc"):
        if mesh is not None:
            raise ValueError(
                f"the fused {algorithm.upper()} route is single-host for "
                "now — pass path='pooled' with mesh= for the sharded XLA "
                "kernels")
        if "alpha" in kwargs:
            raise TypeError(
                f"alpha= with algorithm={algorithm!r}: the fused route sets "
                "the momentum persistence itself (MALA is alpha=0); pass "
                "ghmc_alpha= with algorithm='ghmc'")
        if algorithm == "mala":
            if "ghmc_alpha" in kwargs:
                raise TypeError(
                    "ghmc_alpha= with algorithm='mala' (MALA IS alpha=0); "
                    "use algorithm='ghmc' for persistent momentum"
                )
            alpha = 0.0
        else:
            alpha = kwargs.pop("ghmc_alpha", 0.9)
        out = sample_fused_ghmc(
            generator,
            potential_fn_t,
            tuple(data),
            initial_position.to(torch.float32),
            num_samples,
            num_warmup,
            alpha=alpha,
            potential_and_grad_t=potential_and_grad_t,
            **kwargs,
        )
        return _fused_nuts_result(out)
    kwargs.setdefault("max_num_expansions", 6)
    # the whole-run kernel unless the sampling phase runs in checkpointed
    # segments or depth-sorted draws, which need one launch a draw (the JAX
    # driver's default is the per-draw loop, bit for bit the same draws)
    kwargs.setdefault("loop_in_kernel", not (kwargs.get("checkpoint_every")
                                             or kwargs.get("sort_by_depth")))
    out = sample_fused_adaptive(
        generator,
        logprob_fn,
        tuple(data),
        initial_position.to(torch.float32),
        num_samples,
        num_warmup,
        potential_fn_t=potential_fn_t,
        potential_and_grad_t=potential_and_grad_t,
        mesh=mesh,
        **kwargs,
    )
    if out is None:  # a checkpointed run killed by its test hook
        return None
    return _fused_nuts_result(out)


def _fused_meads(generator, logprob_fn, initial_position, num_samples,
                 num_warmup, data, potential_fn_t, potential_and_grad_t,
                 mesh, kwargs) -> SampleResult:
    """The fused MEADS route: the pooled MEADS driver over kernel 6 (one
    launch a ``meads_recompute_every``-draw segment), or over kernel 5 (one
    launch a draw) when the run is checkpointed, whose segments need the
    per-draw kernel, or sharded over a mesh (kernel 5 per shard: the
    segment kernel has no shard adapter)."""
    kernel_kwargs = {k: kwargs.pop(k) for k in _MEADS_KERNEL_KWARGS
                     if k in kwargs}
    if "divergence_threshold" in kwargs:
        kernel_kwargs["divergence_threshold"] = kwargs["divergence_threshold"]
    kwargs.setdefault("meads_recompute_every", 8)
    common = dict(potential_and_grad_t=potential_and_grad_t, **kernel_kwargs)
    if mesh is not None or kwargs.get("checkpoint_every"):
        kwargs["meads_transition_fn"] = make_fused_meads_transition(
            potential_fn_t, tuple(data), mesh=mesh,
            num_chains=initial_position.shape[0], **common)
    else:
        kwargs["meads_segment_fn"] = make_fused_meads_segment(
            potential_fn_t, tuple(data), **common)
    return sample_sharded(generator, logprob_fn,
                          initial_position.to(torch.float32), num_samples,
                          num_warmup, algorithm="meads", mesh=mesh, **kwargs)
