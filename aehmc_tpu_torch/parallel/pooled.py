"""Pooled warmup and sampling of a chain batch (port of
:mod:`aehmc_tpu.parallel.pooled`), on one device or sharded over a mesh.

All chains share one step size (or one per chain, ``per_chain_step_size``)
and one inverse mass matrix, adapted from pooled statistics: the mean
acceptance across chains drives dual averaging (the fixed-tree
:func:`~aehmc_tpu_torch.algorithms.pairwise_mean`), and every chain's
position folds into one Welford estimate (the Chan batched merge).  The
kernels take the whole chain batch in one call.

Every branch of :func:`sample_sharded` (NUTS/HMC/MALA/GHMC, ChEES, MEADS)
runs through :func:`_checkpointed_run`, which can snapshot warmup and
sampling to an ``.npz`` file and resume them bit for bit.  With a mesh
(:mod:`aehmc_tpu_torch.parallel.mesh`) the kernels run per shard
(:func:`shard_kernel`, :func:`shard_fold_transition`) and the pooled
statistics reduce over the chains joined in chain order, so a sharded run
equals the unsharded one bit for bit wherever a chain's arithmetic does
not depend on the batch width: the fused kernels', not always the XLA
path's (``torch.func`` gradients through a cuBLAS product, which may
split the sum over data points differently for a shard's rows).
"""

import os
from typing import Callable, Optional, Tuple

import torch
from aehmc_tpu_torch import _batch, chees, hmc, keys, meads
from aehmc_tpu_torch import checkpoint as ckpt
from aehmc_tpu_torch.algorithms import pairwise_mean, welford_update_batch
from aehmc_tpu_torch.observability import progress_callback, progress_draws
from aehmc_tpu_torch.ops.nuts_fused import _is_key_source
from aehmc_tpu_torch.parallel.mesh import (
    SHARDED,
    SHARED,
    VECTOR,
    chain_shards,
    map_shards,
)
from aehmc_tpu_torch.sampling import (
    SampleResult,
    default_inverse_mass_matrix,
    make_kernel,
    new_sampler_state,
)
from aehmc_tpu_torch.step_size import find_reasonable_step_size
from aehmc_tpu_torch.types import ChainState, Diagnostics
from aehmc_tpu_torch.window_adaptation import window_adaptation


def _shard_key(key, shard):
    """A shard's key: the key's Philox seed at the shard's first global
    chain, or its chains of an external ``(z, u)`` pair."""
    if isinstance(key, tuple) and not isinstance(key, keys.Key):
        return shard.take(key)
    return keys.Key(key.seed, key.chain_offset + shard.start)


def _global_key(key):
    return (key if isinstance(key, tuple) and not isinstance(key, keys.Key)
            else keys.as_key(key))


def shard_kernel(kernel: Callable, mesh, num_chains: int) -> Callable:
    """An XLA-path kernel ``kernel(key, states, step_size, *shared) ->
    (states, info)`` (:func:`aehmc_tpu_torch.sampling.make_kernel`, the
    ChEES ``kernel_fn``) run per shard of the chain axis over ``mesh``:
    shard ``i`` takes its chains of the states and of a per-chain
    ``(chains,)`` step size, the other arguments replicated, and the key
    ``Key(seed, chain_offset + start)`` (a ``torch.Generator`` key draws
    its seed once), the Philox streams its chains draw in the whole batch.
    The outputs join in chain order on the states' device."""
    shards = chain_shards(mesh, num_chains)

    def sharded(key, states, step_size, *shared):
        key = _global_key(key)
        spec = (SHARDED, VECTOR) + (SHARED,) * len(shared)
        return map_shards(
            lambda s: kernel(_shard_key(key, s),
                             *s.args(spec, (states, step_size, *shared))),
            shards, states.position.device)

    sharded.mesh = mesh
    return sharded


def shard_fold_transition(transition: Callable, mesh,
                          num_chains: int) -> Callable:
    """A MEADS fold transition ``transition(key, fold_states, hyper)``
    (:func:`aehmc_tpu_torch.meads.new_kernel`'s, or
    :func:`aehmc_tpu_torch.ops.ghmc_fused.make_fused_meads_transition`) run
    per shard of the flattened chain axis over ``mesh``: a shard's chains
    go in as folds of one chain each, with their folds' hyperparameters,
    and the key of :func:`shard_kernel`; the outputs are joined and
    refolded."""
    shards = chain_shards(mesh, num_chains)

    def sharded(key, fold_states, hyper):
        num_folds, per_fold = fold_states.position.shape[:2]
        key = _global_key(key)
        states = meads._map(meads._unfold, fold_states)
        per_chain = type(hyper)(*(meads._tile(h, per_fold) for h in hyper))

        def local(s):
            new, infos = transition(
                _shard_key(key, s),
                meads._map(lambda a: a.unsqueeze(1), s.take(states)),
                s.take(per_chain))
            return (meads._map(meads._unfold, new),
                    meads._map(meads._unfold, infos))

        new, infos = map_shards(local, shards, fold_states.position.device)
        return (meads._map(lambda a: meads._fold(a, num_folds), new),
                meads._map(lambda a: meads._fold(a, num_folds), infos))

    sharded.mesh = mesh
    return sharded


def _on_mesh(fn: Callable, shard: Callable, mesh, num_chains: int):
    """``fn`` sharded by ``shard`` over ``mesh``, unless it is None or
    already runs on a mesh (a ``mesh`` attribute: the fused kernels built
    with ``mesh=``)."""
    if mesh is None or fn is None or getattr(fn, "mesh", None) is not None:
        return fn
    return shard(fn, mesh, num_chains)


def pooled_window_adaptation(
    num_steps: int,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    *,
    per_chain_step_size: bool = False,
    num_chains: int = None,
) -> Tuple[Callable, Callable]:
    """``(init, update)`` of the Stan window state machine driven by pooled
    statistics: the fixed-tree mean acceptance drives dual averaging, and
    each step folds the chain batch into the Welford state.

    ``per_chain_step_size`` keeps one dual-averaging state per chain, each
    fed its own chain's acceptance (the single-chain adaptation,
    elementwise over ``(chains,)``); the mass matrix stays pooled.  It
    needs ``num_chains``.
    """
    if per_chain_step_size:
        if num_chains is None:
            raise ValueError("per_chain_step_size requires num_chains")
        initial_step_size = torch.full((num_chains,), initial_step_size,
                                       dtype=torch.float64)

        def acceptance_statistic(info):
            return info.acceptance_probability
    else:
        def acceptance_statistic(info):
            return pairwise_mean(info.acceptance_probability)
    return window_adaptation(
        num_steps, is_mass_matrix_full, initial_step_size,
        target_acceptance_rate,
        welford_update_fn=welford_update_batch(is_mass_matrix_full),
        acceptance_statistic=acceptance_statistic,
        num_dims_fn=lambda positions: (0 if positions.ndim == 1
                                       else positions.shape[1]),
    )


def pooled_warmup_hooks(
    kernel: Callable,
    num_chains: int,
    num_steps: int = 400,
    *,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    progress_every: int = 0,
    search_initial_step_size: bool = True,
    per_chain_step_size: bool = False,
) -> Tuple[Callable, Callable, Callable]:
    """Segmentable pooled warmup: ``(init, segment, finish)``.

    ``init(key, states) -> wcarry`` builds the adaptation state (after the
    initial step-size search on the pooled acceptance, when asked);
    ``segment(wcarry, steps) -> (wcarry, infos)`` runs the absolute steps
    ``steps`` in order; ``finish(wcarry) -> (states, (step_size,
    inverse_mass_matrix))``.  The carry ``(key, states, adaptation_state)``
    holds the key that step ``t`` takes the ``t``-th split of, so running
    ``[0, N)`` in slices draws what one run draws; it is a tree of tensors
    and ints that :mod:`aehmc_tpu_torch.checkpoint` saves.
    ``kernel(key, states, step_size, inverse_mass_matrix)`` takes the chain
    batch.  ``progress_every=N`` prints a progress line every N steps
    (:func:`aehmc_tpu_torch.observability.progress_callback`).
    """
    init_adapt, update_adapt = pooled_window_adaptation(
        num_steps, is_mass_matrix_full, initial_step_size,
        target_acceptance_rate, per_chain_step_size=per_chain_step_size,
        num_chains=num_chains,
    )

    def init(rng, initial_states):
        key = keys.as_key(rng)
        adaptation_state = init_adapt(initial_states)
        if search_initial_step_size:
            key, search_key = keys.split(key)
            search_keys = keys.split(search_key, 32)
            search_eps = adaptation_state.step_size
            if per_chain_step_size:
                # the search probes one pooled value; every chain's dual
                # averaging then starts at the found one
                search_eps = search_eps[0]
            found = find_reasonable_step_size(
                lambda probe, s, eps, imm: kernel(search_keys[probe], s, eps,
                                                  imm),
                initial_states, adaptation_state.inverse_mass_matrix,
                initial_step_size=search_eps, reduce_fn=pairwise_mean,
            )
            if per_chain_step_size:
                found = torch.full((num_chains,), float(found),
                                   dtype=found.dtype, device=found.device)
            adaptation_state = init_adapt(initial_states, found)
        return (key, initial_states, adaptation_state)

    def segment(wcarry, steps):
        key, states, adaptation_state = wcarry
        step_keys = keys.split(key, num_steps)
        infos = []
        for step in steps:
            step = int(step)
            states, info = kernel(step_keys[step], states,
                                  adaptation_state.step_size,
                                  adaptation_state.inverse_mass_matrix)
            adaptation_state = update_adapt(step, adaptation_state,
                                            states.position, info)
            if progress_every:
                progress_callback(step, info, every=progress_every)
            infos.append(info)
        return ((key, states, adaptation_state),
                _batch.stack(infos) if infos else None)

    def finish(wcarry):
        _, states, adaptation_state = wcarry
        return states, (adaptation_state.step_size,
                        adaptation_state.inverse_mass_matrix)

    return init, segment, finish


def pooled_warmup(
    rng,
    kernel: Callable,
    initial_states: ChainState,
    num_steps: int = 400,
    *,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    progress_every: int = 0,
    search_initial_step_size: bool = True,
    per_chain_step_size: bool = False,
) -> Tuple[ChainState, Tuple[torch.Tensor, torch.Tensor], Diagnostics]:
    """Warm up a chain batch with shared, pooled-adapted parameters.
    ``kernel(key, states, step_size, inverse_mass_matrix)`` takes the batch
    (``initial_states`` with a leading chain axis).  ``progress_every=N``
    prints the step, the pooled acceptance and the divergent chains every N
    steps.  Returns ``(states, (step_size, inverse_mass_matrix),
    info_history)``."""
    init, segment, finish = pooled_warmup_hooks(
        kernel, initial_states.position.shape[0], num_steps,
        is_mass_matrix_full=is_mass_matrix_full,
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
        progress_every=progress_every,
        search_initial_step_size=search_initial_step_size,
        per_chain_step_size=per_chain_step_size,
    )
    wcarry, info_history = segment(init(rng, initial_states),
                                   range(num_steps))
    states, (eps, imm) = finish(wcarry)
    return states, (eps, imm), info_history


def _chees_diagnostics(info: chees.CheesSampleInfo) -> Diagnostics:
    """``CheesSampleInfo`` as ``Diagnostics``, every field (draws, chains):
    ChEES has no tree, so doublings are 0 and no chain is turning; the
    shared trip count is broadcast over the chains."""
    accept = info.acceptance_probability
    return Diagnostics(
        acceptance_probability=accept,
        num_doublings=torch.zeros(accept.shape, dtype=torch.int32,
                                  device=accept.device),
        is_turning=torch.zeros(accept.shape, dtype=torch.bool,
                               device=accept.device),
        is_diverging=info.is_diverging,
        energy=info.energy,
        num_integration_steps=info.num_integration_steps.to(torch.int32)[
            :, None].expand(accept.shape),
    )


def sample_sharded(
    generator,
    logprob_fn: Callable,
    initial_positions: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 400,
    *,
    algorithm: str = "nuts",
    num_integration_steps: int = 32,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    search_initial_step_size: bool = True,
    per_chain_step_size: bool = False,
    mesh=None,
    collect_positions: bool = True,
    meads_recompute_every: int = 1,
    meads_transition_fn: Callable = None,
    meads_segment_fn: Callable = None,
    chees_kernel_fn: Callable = None,
    progress_every: int = 0,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    _crash_after_segments: Optional[int] = None,
    _crash_after_warmup_segments: Optional[int] = None,
) -> SampleResult:
    """Pooled warmup and sampling of ``initial_positions (chains, dim)``.

    ``algorithm`` "nuts", "hmc", "mala" or "ghmc": the XLA kernel of
    :func:`aehmc_tpu_torch.sampling.make_kernel` over the whole batch,
    :func:`pooled_warmup` (``num_warmup`` steps; none leaves the initial
    step size and the identity), then ``num_samples`` draws; ``generator``
    is a key, a ``torch.Generator`` or an int seed
    (:mod:`aehmc_tpu_torch.keys`).  ``per_chain_step_size`` adapts one step
    size per chain (returned ``(chains,)``), the mass matrix pooled.

    ``algorithm="chees"``: the chain states come from ``logprob_fn`` by
    :func:`aehmc_tpu_torch.hmc.new_state`, then the ChEES warmup
    (``max(num_warmup, 1)`` steps, target acceptance 0.651) and
    :func:`aehmc_tpu_torch.chees.sample` run ``chees_kernel_fn`` (e.g.
    :func:`aehmc_tpu_torch.ops.chees_fused.make_fused_chees_kernel`), by
    default the XLA kernel :func:`aehmc_tpu_torch.chees.new_kernel`;
    ``generator`` is a ``torch.Generator`` or a key source ``(phase,
    index) -> key`` (:mod:`aehmc_tpu_torch.chees`).

    ``algorithm="meads"``: :mod:`aehmc_tpu_torch.meads` (``num_warmup`` is
    burn-in; adaptation goes on while sampling), re-estimating every
    ``meads_recompute_every`` draws.  ``meads_transition_fn`` replaces the
    fold transition (kernel 5:
    :func:`aehmc_tpu_torch.ops.ghmc_fused.make_fused_meads_transition`),
    ``meads_segment_fn`` a whole segment (kernel 6:
    ``make_fused_meads_segment``; not with checkpoints).  The result's
    ``step_size`` and ``inverse_mass_matrix`` are the means of the last
    per-fold values.

    **Checkpoint / resume**: ``checkpoint_every=N, checkpoint_path=
    "run.npz"`` runs warmup and sampling in N-step segments and saves the
    whole state after each (warmup to ``<path minus .npz>_warmup.npz``:
    chain states, adaptation state, keys, a ``torch.Generator``'s state, the
    draws so far).  ``resume=True`` with the same arguments continues from
    the last snapshot and returns what the uninterrupted run returns, bit
    for bit.  ``_crash_after_segments`` / ``_crash_after_warmup_segments``
    stop after N segments of a phase and return None (test hooks).
    ``progress_every=N`` prints a progress line every N draws (and every N
    pooled warmup steps).

    **Mesh**: ``mesh`` (:func:`aehmc_tpu_torch.parallel.make_mesh`) runs the
    XLA kernels (the ChEES kernel and the MEADS fold transition too) per
    shard of the chains (:func:`shard_kernel`, :func:`shard_fold_transition`)
    at the shards' global chain offsets, on the devices the mesh names; the
    chain states come back joined in chain order, so dual averaging, the
    Welford folds, the ChEES criterion and MEADS's estimates reduce over
    the chains in global order and the run equals the unsharded one bit for
    bit wherever a chain's arithmetic does not depend on the batch width
    (the fused kernels; on the card a cuBLAS product in ``logprob_fn``'s
    gradient may sum differently for a shard's rows, chip_smoke phase 46).
    A ``chees_kernel_fn`` or ``meads_transition_fn`` built with ``mesh=`` runs
    as it is; there is no sharded ``meads_segment_fn`` (``ValueError``).
    The checkpoints hold the joined state.  Unlike the JAX package, which
    shards over every device when ``mesh=None`` and more than one is
    attached, the chains shard only over a ``mesh`` the caller passes: JAX
    replicates the constants a ``logprob_fn`` closes over for the sharded
    computation, while a torch closure keeps its tensors on their own card,
    so ``logprob_fn`` must be one that evaluates positions on every mesh
    device.

    Returns a ``SampleResult`` whose ``final_state`` is the chain state,
    ``positions`` ``(draws, chains, dim)`` and ``diagnostics`` every field
    ``(draws, chains)``.
    """
    if checkpoint_every and checkpoint_path is None:
        raise ValueError("checkpoint_every requires checkpoint_path")
    if per_chain_step_size and algorithm in ("meads", "chees"):
        raise ValueError(
            f"per_chain_step_size is not supported with algorithm="
            f"{algorithm!r} (MEADS/ChEES manage their own step-size "
            "adaptation)"
        )
    num_chains = initial_positions.shape[0]
    if mesh is not None and meads_segment_fn is not None:
        raise ValueError(
            "meads_segment_fn has no shard adapter: with a mesh, pass a "
            "meads_transition_fn (make_fused_meads_transition(mesh=..., "
            "num_chains=...)) or none")
    meads_transition_fn = _on_mesh(meads_transition_fn, shard_fold_transition,
                                   mesh, num_chains)
    chees_kernel_fn = _on_mesh(chees_kernel_fn, shard_kernel, mesh,
                               num_chains)
    run = dict(checkpoint_every=checkpoint_every,
               checkpoint_path=checkpoint_path, resume=resume,
               _crash_after_segments=_crash_after_segments,
               _crash_after_warmup_segments=_crash_after_warmup_segments)
    if algorithm == "meads":
        if mesh is not None and meads_transition_fn is None:
            meads_transition_fn = shard_fold_transition(
                meads._make_fold_transition(logprob_fn, divergence_threshold),
                mesh, num_chains)
        return _sample_meads(
            generator, logprob_fn, initial_positions, num_samples, num_warmup,
            divergence_threshold=divergence_threshold,
            collect_positions=collect_positions,
            recompute_every=meads_recompute_every,
            transition_fn=meads_transition_fn, segment_fn=meads_segment_fn,
            progress_every=progress_every, run=run)
    if algorithm == "chees":
        if mesh is not None and chees_kernel_fn is None:
            chees_kernel_fn = shard_kernel(
                chees.new_kernel(logprob_fn, divergence_threshold), mesh,
                num_chains)
        return _sample_chees(
            generator, logprob_fn, initial_positions, num_samples, num_warmup,
            divergence_threshold=divergence_threshold,
            initial_step_size=initial_step_size,
            search_initial_step_size=search_initial_step_size,
            collect_positions=collect_positions,
            chees_kernel_fn=chees_kernel_fn, progress_every=progress_every,
            run=run)
    if algorithm == "mala" and is_mass_matrix_full:
        raise ValueError(
            "MALA supports scalar/diagonal preconditioners only; "
            "is_mass_matrix_full=True is not compatible with algorithm='mala'"
        )
    kernel = _on_mesh(make_kernel(
        logprob_fn, algorithm, num_integration_steps=num_integration_steps,
        max_num_expansions=max_num_expansions,
        divergence_threshold=divergence_threshold,
    ), shard_kernel, mesh, num_chains)
    w_init, w_segment, w_finish = pooled_warmup_hooks(
        kernel, num_chains, num_warmup,
        is_mass_matrix_full=is_mass_matrix_full,
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
        progress_every=progress_every,
        search_initial_step_size=search_initial_step_size,
        per_chain_step_size=per_chain_step_size,
    )

    def wh_init(rng, positions):
        init_key, warmup_key, sample_key = keys.split(rng, 3)
        states = new_sampler_state(algorithm, init_key, positions, logprob_fn)
        if num_warmup > 0:
            return w_init(warmup_key, states), sample_key
        return (states,), sample_key

    def wh_segment(wcarry, steps):
        return w_segment(wcarry, steps)[0] if num_warmup > 0 else wcarry

    def wh_finish(wcarry):
        if num_warmup > 0:
            return w_finish(wcarry)
        eps = _batch.like(initial_step_size, initial_positions)
        if per_chain_step_size:
            eps = eps.expand(num_chains).clone()
        return wcarry[0], (eps, default_inverse_mass_matrix(
            initial_positions[0], is_mass_matrix_full))

    def sample_segment(states, draws, extras, draw_keys):
        eps, imm = extras
        positions, infos = [], []
        for key in draw_keys:
            states, info = kernel(key, states, eps, imm)
            if collect_positions:
                positions.append(states.position)
            infos.append(info)
        infos = _batch.stack(infos)
        progress_draws(progress_every, draws, infos)
        return states, (torch.stack(positions) if collect_positions else None,
                        infos)

    def build_result(states, extras, outs):
        eps, imm = extras
        positions, infos = outs
        return SampleResult(final_state=states, positions=positions,
                            diagnostics=infos, step_size=eps,
                            inverse_mass_matrix=imm)

    return _checkpointed_run(
        generator, initial_positions, (wh_init, wh_segment, wh_finish),
        sample_segment, build_result, num_samples, num_warmup, **run)


def _sample_chees(generator, logprob_fn, initial_positions, num_samples,
                  num_warmup, *, divergence_threshold, initial_step_size,
                  search_initial_step_size, collect_positions,
                  chees_kernel_fn, progress_every, run) -> SampleResult:
    """The ChEES branch of :func:`sample_sharded`.  The warmup carry leaves
    out its key source, which is rebuilt from ``generator``."""
    num_chains, dim = initial_positions.shape
    num_steps = max(num_warmup, 1)
    ch_init, ch_segment, ch_finish = chees.warmup_hooks(
        logprob_fn, num_chains, dim, num_steps,
        initial_step_size=initial_step_size,
        divergence_threshold=divergence_threshold,
        search_initial_step_size=search_initial_step_size,
        dtype=initial_positions.dtype, kernel_fn=chees_kernel_fn,
    )
    key_source = chees._key_source(generator)

    def wh_init(rng, positions):
        states = hmc.new_state(positions, logprob_fn)
        return ch_init(rng, states)[1:], None

    def wh_segment(wcarry, steps):
        return ch_segment((key_source,) + wcarry, steps)[0][1:]

    def wh_finish(wcarry):
        result = ch_finish((key_source,) + wcarry)
        return result.states, (result.step_size, result.trajectory_length,
                               result.inverse_mass_matrix)

    def sample_segment(states, draws, extras, _):
        eps, h, imm = extras
        states, positions, info = chees.sample(
            generator, logprob_fn, states, len(draws), eps, h, imm,
            divergence_threshold=divergence_threshold,
            collect_positions=collect_positions, kernel_fn=chees_kernel_fn,
            _step_offset=draws.start,
        )
        progress_draws(progress_every, draws, info)
        return states, (positions, info)

    def build_result(states, extras, outs):
        eps, _, imm = extras
        positions, info = outs
        return SampleResult(final_state=states, positions=positions,
                            diagnostics=_chees_diagnostics(info),
                            step_size=eps, inverse_mass_matrix=imm)

    return _checkpointed_run(
        generator, initial_positions, (wh_init, wh_segment, wh_finish),
        sample_segment, build_result, num_samples, num_steps, **run)


def _meads_result(states, positions, infos, hyper) -> SampleResult:
    return SampleResult(
        final_state=states, positions=positions, diagnostics=infos,
        step_size=torch.mean(hyper.step_size),
        inverse_mass_matrix=torch.mean(hyper.inverse_mass_matrix, dim=0),
    )


def _sample_meads(generator, logprob_fn, initial_positions, num_samples,
                  num_warmup, *, divergence_threshold, collect_positions,
                  recompute_every, transition_fn, segment_fn,
                  progress_every, run) -> SampleResult:
    """The MEADS branch of :func:`sample_sharded`: :func:`meads.sample`,
    or, with checkpoints, the per-draw kernel :func:`meads.new_kernel`
    whose carry is a :class:`meads.MeadsCarry`."""
    if segment_fn is not None and run["checkpoint_every"]:
        raise ValueError(
            "meads_segment_fn does not compose with checkpointing yet — the "
            "checkpointed MEADS carrier steps the per-draw kernel"
        )
    if not run["checkpoint_every"]:
        states, positions, infos, hyper = meads.sample(
            generator, logprob_fn, initial_positions, num_samples, num_warmup,
            divergence_threshold=divergence_threshold,
            collect_positions=collect_positions,
            recompute_every=recompute_every, transition_fn=transition_fn,
            segment_transition_fn=segment_fn,
        )
        progress_draws(progress_every, range(num_samples), infos)
        return _meads_result(states, positions, infos, hyper)
    meads._check_folds(initial_positions.shape[0], 4)
    kernel = meads.new_kernel(logprob_fn,
                              divergence_threshold=divergence_threshold,
                              recompute_every=recompute_every,
                              transition_fn=transition_fn)
    # a key source is stateless: the carry holds its phase keys as None
    source = generator if _is_key_source(generator) else None

    def wh_init(rng, positions):
        if source is not None:
            carry = meads.init_carry(source("init", 0), positions, logprob_fn)
            return (carry, None), None
        init_key, warm_key, sample_key = keys.split(rng, 3)
        return ((meads.init_carry(init_key, positions, logprob_fn), warm_key),
                sample_key)

    def wh_segment(wcarry, steps):
        carry, warm_key = wcarry
        if source is None:
            warm_keys = keys.split(warm_key, max(num_warmup, 1))
        for t in steps:
            key = (source("warmup", t) if source is not None
                   else warm_keys[t])
            carry, _ = kernel(key, carry)
        return carry, warm_key

    def wh_finish(wcarry):
        return wcarry[0], ()

    def sample_segment(carry, draws, extras, draw_keys):
        if draw_keys is None:
            draw_keys = [source("sample", t) for t in draws]
        positions, infos = [], []
        for key in draw_keys:
            carry, info = kernel(key, carry)
            if collect_positions:
                positions.append(carry.states.position)
            infos.append(info)
        infos = _batch.stack(infos)
        progress_draws(progress_every, draws, infos)
        return carry, (torch.stack(positions) if collect_positions else None,
                       infos)

    def build_result(carry, extras, outs):
        positions, infos = outs
        return _meads_result(carry.states, positions, infos, carry.hyper)

    return _checkpointed_run(
        generator, initial_positions, (wh_init, wh_segment, wh_finish),
        sample_segment, build_result, num_samples, num_warmup, **run)


def _concat(chunks):
    """Segments' outputs (trees of per-draw stacked tensors) joined along
    the draw axis."""
    first = chunks[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        values = [_concat([c[i] for c in chunks]) for i in range(len(first))]
        return (type(first)(*values) if hasattr(first, "_fields")
                else tuple(values))
    return torch.cat(chunks)


def _checkpointed_run(
    generator,
    initial_positions: torch.Tensor,
    warmup_hooks,
    sample_segment: Callable,
    build_result: Callable,
    num_samples: int,
    num_warmup: int,
    *,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
    _crash_after_segments: Optional[int] = None,
    _crash_after_warmup_segments: Optional[int] = None,
):
    """Warmup, then sampling in segments, with snapshots (port of the JAX
    ``_checkpointed_run``).

    ``warmup_hooks = (init, segment, finish)``: ``init(generator,
    positions) -> (wcarry, sample_key)``, ``segment(wcarry, steps) ->
    wcarry`` over absolute step indices, ``finish(wcarry) -> (carry,
    extras)``.  ``sample_segment(carry, draws, extras, draw_keys) -> (carry,
    outs)`` runs the absolute draws ``draws`` (a range); ``draw_keys`` are
    their keys, the splits of a ``Key`` ``sample_key`` over the whole run
    (None when ``sample_key`` is None: the branch keys its draws itself).
    ``outs`` is a tree of per-draw stacked tensors; ``build_result(carry,
    extras, outs)`` makes the result.

    Without ``checkpoint_every`` the run is one warmup and one segment.
    With it, warmup runs in ``checkpoint_every``-step segments saved to
    ``<checkpoint_path minus .npz>_warmup.npz`` and sampling in
    ``ceil(num_samples / checkpoint_every)`` segments saved to
    ``checkpoint_path``; every snapshot holds a ``torch.Generator``
    ``generator``'s state, which a resumed run sets back.  The carries are
    trees of tensors, ints, keys and generators (no callables).
    """
    init, wsegment, finish = warmup_hooks

    def draw_keys(sample_key, draws):
        if sample_key is None:
            return None
        return keys.split(sample_key, num_samples)[draws.start:draws.stop]

    if not checkpoint_every:
        wcarry, sample_key = init(generator, initial_positions)
        carry, extras = finish(wsegment(wcarry, range(num_warmup)))
        draws = range(num_samples)
        carry, outs = sample_segment(carry, draws, extras,
                                     draw_keys(sample_key, draws))
        return build_result(carry, extras, outs)

    if not checkpoint_path.endswith(".npz"):
        raise ValueError(
            "driver-level checkpointing requires an .npz checkpoint_path "
            f"(got {checkpoint_path!r})"
        )
    gen = generator if isinstance(generator, torch.Generator) else None
    warmup_path = checkpoint_path[: -len(".npz")] + "_warmup.npz"
    n_segments = -(-num_samples // checkpoint_every)

    def restore(path):
        loaded = ckpt.restore(path)
        if gen is not None:
            gen.set_state(loaded["generator"].get_state())
        return loaded

    done_segments, outs = 0, None
    if resume and os.path.exists(checkpoint_path):
        loaded = restore(checkpoint_path)
        carry, extras = loaded["carry"], loaded["extras"]
        sample_key = loaded["sample_key"]
        done_segments, outs = loaded["done_segments"], loaded["outs"]
    else:
        done_steps = 0
        if resume and os.path.exists(warmup_path):
            loaded = restore(warmup_path)
            wcarry, sample_key = loaded["wcarry"], loaded["sample_key"]
            done_steps = loaded["done_steps"]
        else:
            wcarry, sample_key = init(generator, initial_positions)
        for wseg, lo in enumerate(range(done_steps, num_warmup,
                                        checkpoint_every)):
            hi = min(lo + checkpoint_every, num_warmup)
            wcarry = wsegment(wcarry, range(lo, hi))
            ckpt.save(warmup_path, {"wcarry": wcarry,
                                    "sample_key": sample_key,
                                    "done_steps": hi, "generator": gen})
            if (_crash_after_warmup_segments is not None
                    and wseg + 1 >= _crash_after_warmup_segments
                    and hi < num_warmup):
                return None  # a simulated kill mid-warmup (test hook)
        carry, extras = finish(wcarry)

    for seg in range(done_segments, n_segments):
        draws = range(seg * checkpoint_every,
                      min((seg + 1) * checkpoint_every, num_samples))
        carry, seg_outs = sample_segment(carry, draws, extras,
                                         draw_keys(sample_key, draws))
        outs = seg_outs if outs is None else _concat([outs, seg_outs])
        ckpt.save(checkpoint_path, {
            "carry": carry, "extras": extras, "sample_key": sample_key,
            "done_segments": seg + 1, "outs": outs, "generator": gen})
        if (_crash_after_segments is not None
                and seg + 1 - done_segments >= _crash_after_segments
                and seg + 1 < n_segments):
            return None  # a simulated kill (test hook)
    return build_result(carry, extras, outs)
