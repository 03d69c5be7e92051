"""Stan-style window adaptation (port of :mod:`aehmc_tpu.window_adaptation`).

The schedule is a Python list, and ``update`` takes the step as a Python
int, so the fast/slow branches are plain ``if``s where the JAX package
computes both and selects (the values are the same).  :func:`run` is the
whole warmup of one chain as a host loop over the kernel; given a
``(chains, dim)`` batch it warms up every row independently in one loop
(one step size, one Welford state and one inverse mass matrix a chain:
the JAX package's ``vmap`` of the single-chain warmup).  As in the JAX
package, the dual-averaging shrinkage point is ``log(10 * step_size)`` and
the log-step-size iterate starts at ``log(step_size)`` (Stan's scheme).
"""

import math
from typing import Callable, List, NamedTuple, Tuple

import torch

from aehmc_tpu_torch import _batch, keys
from aehmc_tpu_torch.config import WindowSchedule
from aehmc_tpu_torch.mass_matrix import covariance_adaptation
from aehmc_tpu_torch.metrics import PerChain
from aehmc_tpu_torch.step_size import (
    dual_averaging_adaptation,
    find_reasonable_step_size,
)
from aehmc_tpu_torch.types import (
    ChainState,
    Diagnostics,
    DualAveragingState,
    WelfordState,
)

_SCHEDULE = WindowSchedule()


class WindowAdaptationState(NamedTuple):
    da_state: DualAveragingState
    wc_state: WelfordState
    step_size: torch.Tensor
    inverse_mass_matrix: torch.Tensor


def build_schedule(
    num_steps: int,
    initial_buffer_size: int = _SCHEDULE.initial_buffer,
    final_buffer_size: int = _SCHEDULE.final_buffer,
    first_window_size: int = _SCHEDULE.first_window,
) -> List[Tuple[int, bool]]:
    """Stan's warmup schedule as ``(stage, is_middle_window_end)`` pairs:
    stage 0 = fast (step size only), 1 = slow (step size + covariance)."""
    schedule = []
    if num_steps < 20:
        schedule += [(0, False)] * num_steps
        return schedule

    if initial_buffer_size + first_window_size + final_buffer_size > num_steps:
        initial_buffer_size = int(0.15 * num_steps)
        final_buffer_size = int(0.1 * num_steps)
        first_window_size = num_steps - initial_buffer_size - final_buffer_size

    schedule += [(0, False)] * initial_buffer_size

    final_buffer_start = num_steps - final_buffer_size
    next_window_size = first_window_size
    next_window_start = initial_buffer_size
    while next_window_start < final_buffer_start:
        current_start, current_size = next_window_start, next_window_size
        if 3 * current_size <= final_buffer_start - current_start:
            next_window_size = 2 * current_size
        else:
            current_size = final_buffer_start - current_start
        next_window_start = current_start + current_size
        schedule += [(1, False)] * (next_window_start - 1 - current_start)
        schedule.append((1, True))

    schedule += [(0, False)] * (num_steps - final_buffer_start)
    return schedule


def window_adaptation(
    num_steps: int,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    *,
    welford_update_fn: Callable = None,
    acceptance_statistic: Callable = None,
    num_dims_fn: Callable = None,
    chain_batch: bool = False,
) -> Tuple[Callable, Callable]:
    """Build ``(init, update)`` for the window-adaptation state machine.

    The keyword hooks are the JAX package's: ``welford_update_fn(position,
    wc_state)`` replaces the single-sample Welford update (pooled adaptation
    passes the batched fold), ``acceptance_statistic(info)`` reduces the
    acceptance probabilities, ``num_dims_fn(position)`` reads the model
    dimension from a possibly chain-batched position.  ``chain_batch``
    adapts each row of a ``(chains, dim)`` position alone: the state's step
    size is ``(chains,)``, its inverse mass matrix ``(chains, dim)`` or
    ``(chains, dim, dim)``, every update elementwise over the chains.
    """
    mm_init, mm_update, mm_final = covariance_adaptation(is_mass_matrix_full)
    da_init, da_update = dual_averaging_adaptation(target_acceptance_rate)
    if welford_update_fn is None:
        welford_update_fn = mm_update
    if acceptance_statistic is None:
        acceptance_statistic = lambda info: info.acceptance_probability  # noqa: E731
    if num_dims_fn is None:
        num_dims_fn = lambda position: (  # noqa: E731
            0 if position.ndim == 0 else position.shape[-1]
        )
    schedule = build_schedule(num_steps)

    def _new_da_state(step_size: torch.Tensor) -> DualAveragingState:
        log_step_size = torch.log(step_size)
        state = da_init(math.log(10.0) + log_step_size)
        return state._replace(
            iterates=log_step_size,
            iterates_avg=log_step_size,
            gradient_avg=torch.zeros_like(log_step_size),
        )

    def init(initial_chain_state: ChainState,
             step_size=None) -> WindowAdaptationState:
        position = initial_chain_state.position
        batch_shape = position.shape[:1] if chain_batch else ()
        inverse_mass_matrix, wc_state = mm_init(
            num_dims_fn(position), dtype=position.dtype,
            device=position.device, batch_shape=batch_shape,
        )
        step_size = torch.as_tensor(
            initial_step_size if step_size is None else step_size,
            dtype=position.dtype, device=position.device,
        )
        if chain_batch:
            step_size = step_size.expand(batch_shape).clone()
        return WindowAdaptationState(
            da_state=_new_da_state(step_size),
            wc_state=wc_state,
            step_size=step_size,
            inverse_mass_matrix=inverse_mass_matrix,
        )

    def _slow_final(da_state, wc_state) -> WindowAdaptationState:
        """End of a middle window: recompute M^{-1}, reset Welford, re-init
        dual averaging at the current step size."""
        inverse_mass_matrix = mm_final(wc_state)
        new_wc_state = WelfordState(*map(torch.zeros_like, wc_state))
        step_size = torch.exp(da_state.iterates)
        return WindowAdaptationState(
            da_state=_new_da_state(step_size),
            wc_state=new_wc_state,
            step_size=step_size,
            inverse_mass_matrix=inverse_mass_matrix,
        )

    def update(step: int, state: WindowAdaptationState, position, info):
        """One adaptation step; ``step`` is the Python index into the
        schedule."""
        stage, is_middle_window_end = schedule[step]
        new_da_state = da_update(acceptance_statistic(info), state.da_state)
        wc_state = state.wc_state
        if stage == 1:
            wc_state = welford_update_fn(position, wc_state)
        updated = WindowAdaptationState(
            da_state=new_da_state,
            wc_state=wc_state,
            step_size=torch.exp(new_da_state.iterates),
            inverse_mass_matrix=state.inverse_mass_matrix,
        )
        if is_middle_window_end:
            updated = _slow_final(updated.da_state, updated.wc_state)
        if step == num_steps - 1:
            # the last step switches to the averaged iterate
            updated = updated._replace(
                step_size=torch.exp(updated.da_state.iterates_avg)
            )
        return updated

    return init, update


def run(
    rng,
    kernel: Callable,
    initial_state: ChainState,
    num_steps: int = 1000,
    *,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    search_initial_step_size: bool = True,
) -> Tuple[ChainState, Tuple[torch.Tensor, torch.Tensor], Diagnostics]:
    """Run the whole warmup: ``num_steps`` transitions of
    ``kernel(key, state, step_size, inverse_mass_matrix)`` (for HMC close
    over the number of integration steps), each followed by one adaptation
    step.  ``rng`` is a key, a ``torch.Generator`` or an int seed
    (:mod:`aehmc_tpu_torch.keys`); step ``t`` takes the ``t``-th of its
    split keys.

    With ``search_initial_step_size`` dual averaging starts from the
    doubling/halving search (:func:`find_reasonable_step_size`, one host
    read a probe) seeded at ``initial_step_size``.

    A ``(chains, dim)`` state is that many chains, each warmed up alone in
    one loop (``window_adaptation``'s ``chain_batch``): chain ``c`` gets
    what the single-chain warmup of row ``c`` with the key ``Key(seed,
    chain_offset + c)`` gets (its own search, dual averaging and Welford
    estimate), and the kernel its inverse mass matrix as a
    :class:`~aehmc_tpu_torch.metrics.PerChain`.

    Returns ``(last_state, (step_size, inverse_mass_matrix),
    info_history)``, the history's fields stacked over the steps.
    """
    chain_batch = initial_state.position.ndim == 2
    init_adapt, update_adapt = window_adaptation(
        num_steps, is_mass_matrix_full, initial_step_size,
        target_acceptance_rate, chain_batch=chain_batch)
    wrap = PerChain if chain_batch else (lambda imm: imm)
    key = keys.as_key(rng)
    adaptation_state = init_adapt(initial_state)
    if search_initial_step_size:
        key, search_key = keys.split(key)
        search_keys = keys.split(search_key, 32)
        found = find_reasonable_step_size(
            lambda probe, s, eps, imm: kernel(search_keys[probe], s, eps, imm),
            initial_state, wrap(adaptation_state.inverse_mass_matrix),
            initial_step_size=adaptation_state.step_size,
        )
        adaptation_state = init_adapt(initial_state, found)
    state, infos = initial_state, []
    for step, step_key in enumerate(keys.split(key, num_steps)):
        state, info = kernel(step_key, state, adaptation_state.step_size,
                             wrap(adaptation_state.inverse_mass_matrix))
        adaptation_state = update_adapt(step, adaptation_state,
                                        state.position, info)
        infos.append(info)
    return (state, (adaptation_state.step_size,
                    adaptation_state.inverse_mass_matrix),
            _batch.stack(infos) if infos else None)
