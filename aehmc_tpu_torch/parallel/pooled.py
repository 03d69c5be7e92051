"""Pooled warmup and sampling of a chain batch (port of
:mod:`aehmc_tpu.parallel.pooled`, without checkpoints and on one device).

All chains share one step size (or one per chain, ``per_chain_step_size``)
and one inverse mass matrix, adapted from pooled statistics: the mean
acceptance across chains drives dual averaging (the fixed-tree
:func:`~aehmc_tpu_torch.algorithms.pairwise_mean`), and every chain's
position folds into one Welford estimate (the Chan batched merge).  The
kernels take the whole chain batch in one call.

Checkpoint/resume (``checkpoint_every``) is ROADMAP.md item 1.10, MEADS
item 1.11, a mesh item 1.12; each raises ``NotImplementedError``.
"""

from typing import Callable, Optional, Tuple

import torch
from aehmc_tpu_torch import _batch, chees, hmc, keys
from aehmc_tpu_torch.algorithms import pairwise_mean, welford_update_batch
from aehmc_tpu_torch.sampling import (
    SampleResult,
    default_inverse_mass_matrix,
    make_kernel,
    new_sampler_state,
)
from aehmc_tpu_torch.step_size import find_reasonable_step_size
from aehmc_tpu_torch.types import ChainState, Diagnostics
from aehmc_tpu_torch.window_adaptation import window_adaptation


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
    search_initial_step_size: bool = True,
    per_chain_step_size: bool = False,
) -> Tuple[Callable, Callable, Callable]:
    """Segmentable pooled warmup: ``(init, segment, finish)``.

    ``init(key, states) -> wcarry`` builds the adaptation state (after the
    initial step-size search on the pooled acceptance, when asked);
    ``segment(wcarry, steps) -> (wcarry, infos)`` runs the absolute steps
    ``steps`` in order; ``finish(wcarry) -> (states, (step_size,
    inverse_mass_matrix))``.  The carry holds the split key of every step,
    so running ``[0, N)`` in slices draws what one run draws.
    ``kernel(key, states, step_size, inverse_mass_matrix)`` takes the chain
    batch.
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
        return (keys.split(key, num_steps), initial_states, adaptation_state)

    def segment(wcarry, steps):
        step_keys, states, adaptation_state = wcarry
        infos = []
        for step in steps:
            step = int(step)
            states, info = kernel(step_keys[step], states,
                                  adaptation_state.step_size,
                                  adaptation_state.inverse_mass_matrix)
            adaptation_state = update_adapt(step, adaptation_state,
                                            states.position, info)
            infos.append(info)
        return ((step_keys, states, adaptation_state),
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
    search_initial_step_size: bool = True,
    per_chain_step_size: bool = False,
) -> Tuple[ChainState, Tuple[torch.Tensor, torch.Tensor], Diagnostics]:
    """Warm up a chain batch with shared, pooled-adapted parameters.
    ``kernel(key, states, step_size, inverse_mass_matrix)`` takes the batch
    (``initial_states`` with a leading chain axis).  Returns ``(states,
    (step_size, inverse_mass_matrix), info_history)``."""
    init, segment, finish = pooled_warmup_hooks(
        kernel, initial_states.position.shape[0], num_steps,
        is_mass_matrix_full=is_mass_matrix_full,
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
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
    chees_kernel_fn: Callable = None,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
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
    :func:`aehmc_tpu_torch.hmc.new_state`, then
    :func:`aehmc_tpu_torch.chees.warmup` (``max(num_warmup, 1)`` steps,
    target acceptance 0.651) and :func:`aehmc_tpu_torch.chees.sample` run
    ``chees_kernel_fn`` (e.g.
    :func:`aehmc_tpu_torch.ops.chees_fused.make_fused_chees_kernel`), by
    default the XLA kernel :func:`aehmc_tpu_torch.chees.new_kernel`;
    ``generator`` is a ``torch.Generator`` or a key source ``(phase,
    index) -> key`` (:mod:`aehmc_tpu_torch.chees`).

    Returns a ``SampleResult`` whose ``final_state`` is the chain state,
    ``positions`` ``(draws, chains, dim)`` and ``diagnostics`` every field
    ``(draws, chains)``.
    """
    if per_chain_step_size and algorithm in ("meads", "chees"):
        raise ValueError(
            f"per_chain_step_size is not supported with algorithm="
            f"{algorithm!r} (MEADS/ChEES manage their own step-size "
            "adaptation)"
        )
    if checkpoint_every or resume:
        raise NotImplementedError(
            "checkpoint_every / resume are not ported yet (ROADMAP.md item "
            "1.10)")
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported yet (ROADMAP.md item "
                                  "1.12)")
    if algorithm == "meads":
        raise NotImplementedError(
            "sample_sharded(algorithm='meads') is not ported yet (ROADMAP.md "
            "item 1.11)")
    if algorithm == "chees":
        return _sample_chees(
            generator, logprob_fn, initial_positions, num_samples, num_warmup,
            divergence_threshold=divergence_threshold,
            initial_step_size=initial_step_size,
            search_initial_step_size=search_initial_step_size,
            collect_positions=collect_positions,
            chees_kernel_fn=chees_kernel_fn)
    if algorithm == "mala" and is_mass_matrix_full:
        raise ValueError(
            "MALA supports scalar/diagonal preconditioners only; "
            "is_mass_matrix_full=True is not compatible with algorithm='mala'"
        )
    kernel = make_kernel(
        logprob_fn, algorithm, num_integration_steps=num_integration_steps,
        max_num_expansions=max_num_expansions,
        divergence_threshold=divergence_threshold,
    )
    num_chains = initial_positions.shape[0]
    init_key, warmup_key, sample_key = keys.split(generator, 3)
    states = new_sampler_state(algorithm, init_key, initial_positions,
                               logprob_fn)
    if num_warmup > 0:
        states, (eps, imm), _ = pooled_warmup(
            warmup_key, kernel, states, num_warmup,
            is_mass_matrix_full=is_mass_matrix_full,
            initial_step_size=initial_step_size,
            target_acceptance_rate=target_acceptance_rate,
            search_initial_step_size=search_initial_step_size,
            per_chain_step_size=per_chain_step_size,
        )
    else:
        eps = _batch.like(initial_step_size, initial_positions)
        if per_chain_step_size:
            eps = eps.expand(num_chains).clone()
        imm = default_inverse_mass_matrix(initial_positions[0],
                                          is_mass_matrix_full)
    positions, infos = [], []
    for key in keys.split(sample_key, num_samples):
        states, info = kernel(key, states, eps, imm)
        if collect_positions:
            positions.append(states.position)
        infos.append(info)
    return SampleResult(
        final_state=states,
        positions=torch.stack(positions) if collect_positions else None,
        diagnostics=_batch.stack(infos),
        step_size=eps,
        inverse_mass_matrix=imm,
    )


def _sample_chees(generator, logprob_fn, initial_positions, num_samples,
                  num_warmup, *, divergence_threshold, initial_step_size,
                  search_initial_step_size, collect_positions,
                  chees_kernel_fn) -> SampleResult:
    """The ChEES branch of :func:`sample_sharded`."""
    states = hmc.new_state(initial_positions, logprob_fn)
    result = chees.warmup(
        generator, logprob_fn, states, num_steps=max(num_warmup, 1),
        initial_step_size=initial_step_size,
        divergence_threshold=divergence_threshold,
        search_initial_step_size=search_initial_step_size,
        kernel_fn=chees_kernel_fn,
    )
    final_states, positions, info = chees.sample(
        generator, logprob_fn, result.states, num_samples, result.step_size,
        result.trajectory_length, result.inverse_mass_matrix,
        divergence_threshold=divergence_threshold,
        collect_positions=collect_positions, kernel_fn=chees_kernel_fn,
    )
    return SampleResult(
        final_state=final_states,
        positions=positions,
        diagnostics=_chees_diagnostics(info),
        step_size=result.step_size,
        inverse_mass_matrix=result.inverse_mass_matrix,
    )
