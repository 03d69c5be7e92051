"""State tuples threaded through the port's samplers.

Counterparts of :mod:`aehmc_tpu.types` (``IntegratorState``, ``ChainState``,
``ProposalState``, ``TerminationState``, ``DualAveragingState``,
``WelfordState``, ``Diagnostics``) with ``torch.Tensor`` leaves.  The field
names and their order are the JAX package's, so :mod:`aehmc_tpu_torch.convert`
can carry a state across field by field.
"""

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class IntegratorState(NamedTuple):
    """Full phase-space state used inside a transition."""

    position: Tensor
    momentum: Tensor
    potential_energy: Tensor
    potential_energy_grad: Tensor


class ChainState(NamedTuple):
    """State carried between transitions (momentum is refreshed each step)."""

    position: Tensor
    potential_energy: Tensor
    potential_energy_grad: Tensor


class ProposalState(NamedTuple):
    """A proposal and its progressive-sampling bookkeeping; ``state`` is a
    :class:`ChainState` (the total energy is kept, the momentum is not)."""

    state: ChainState
    energy: Tensor
    weight: Tensor
    sum_log_p_accept: Tensor


class TerminationState(NamedTuple):
    """Checkpoint buffers of the iterative U-turn criterion, each ``batch +
    (max_num_doublings,) + event`` (``(K, dim)`` for one chain, ``(chains,
    K, dim)`` for a batch); the index range of the last step, Python ints."""

    momentum_checkpoints: Tensor
    momentum_sum_checkpoints: Tensor
    min_index: int
    max_index: int


class DualAveragingState(NamedTuple):
    step: Tensor
    iterates: Tensor
    iterates_avg: Tensor
    gradient_avg: Tensor
    shrinkage_pts: Tensor


class WelfordState(NamedTuple):
    mean: Tensor
    m2: Tensor
    sample_size: Tensor


class Diagnostics(NamedTuple):
    """Per-transition observability (fields of ``aehmc_tpu.types.Diagnostics``)."""

    acceptance_probability: Tensor
    num_doublings: Tensor
    is_turning: Tensor
    is_diverging: Tensor
    energy: Tensor
    num_integration_steps: Tensor


def integrator_to_chain_state(state: IntegratorState) -> ChainState:
    return ChainState(
        position=state.position,
        potential_energy=state.potential_energy,
        potential_energy_grad=state.potential_energy_grad,
    )
