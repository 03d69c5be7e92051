"""Proposal bookkeeping and progressive sampling for NUTS (port of
:mod:`aehmc_tpu.proposals`).

A proposal's weight is ``H0 - H1`` with NaN taken to ``-inf``; a transition
is divergent iff ``|ΔE|`` exceeds the threshold.  Uniform progressive
sampling (inside a subtree) accepts with ``sigmoid(w_new - w_old)``, biased
sampling (across doublings) with ``min(1, exp(w_new - w_old))``: the
reference's sigmoid form, not the fused kernels' logit comparison.  The
uniforms are inputs (the ``_from_u`` functions); the kernels draw them from
their Philox streams.  Every function takes one chain or a batch.
"""

from typing import Callable, Tuple

import torch

from aehmc_tpu_torch import _batch
from aehmc_tpu_torch.types import ChainState, IntegratorState, ProposalState


def proposal_generator(kinetic_energy: Callable,
                       divergence_threshold: float) -> Callable:
    """``update(initial_energy, state) -> (proposal, is_divergent)``."""

    def update(initial_energy, state: IntegratorState
               ) -> Tuple[ProposalState, torch.Tensor]:
        new_energy = state.potential_energy + kinetic_energy(state.momentum)
        delta_energy = initial_energy - new_energy
        delta_energy = torch.where(torch.isnan(delta_energy), -torch.inf,
                                   delta_energy)
        is_transition_divergent = torch.abs(delta_energy) > divergence_threshold
        return (
            ProposalState(
                state=ChainState(state.position, state.potential_energy,
                                 state.potential_energy_grad),
                energy=new_energy,
                weight=delta_energy,
                sum_log_p_accept=torch.clamp(delta_energy, max=0.0),
            ),
            is_transition_divergent,
        )

    return update


def progressive_uniform_sampling_from_u(u, proposal: ProposalState,
                                        new_proposal: ProposalState
                                        ) -> ProposalState:
    """Accept the new proposal iff ``u < sigmoid(w_new - w_old)`` (NaN ->
    0)."""
    p_accept = torch.sigmoid(new_proposal.weight - proposal.weight)
    p_accept = torch.where(torch.isnan(p_accept), 0.0, p_accept)
    return maybe_update_proposal(u < p_accept, proposal, new_proposal)


def progressive_biased_sampling_from_u(u, proposal: ProposalState,
                                       new_proposal: ProposalState
                                       ) -> ProposalState:
    """Accept the new proposal iff ``u < min(1, exp(w_new - w_old))``."""
    p_accept = torch.clamp(torch.exp(new_proposal.weight - proposal.weight),
                           0.0, 1.0)
    return maybe_update_proposal(u < p_accept, proposal, new_proposal)


def _uniform(generator: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(like.shape, generator=generator, dtype=like.dtype,
                      device=generator.device).to(like.device)


def progressive_uniform_sampling(generator: torch.Generator,
                                 proposal: ProposalState,
                                 new_proposal: ProposalState) -> ProposalState:
    """:func:`progressive_uniform_sampling_from_u` with a uniform from
    ``generator``."""
    u = _uniform(generator, proposal.weight)
    return progressive_uniform_sampling_from_u(u, proposal, new_proposal)


def progressive_biased_sampling(generator: torch.Generator,
                                proposal: ProposalState,
                                new_proposal: ProposalState) -> ProposalState:
    """:func:`progressive_biased_sampling_from_u` with a uniform from
    ``generator``."""
    u = _uniform(generator, proposal.weight)
    return progressive_biased_sampling_from_u(u, proposal, new_proposal)


def maybe_update_proposal(do_accept, proposal: ProposalState,
                          new_proposal: ProposalState) -> ProposalState:
    """Select between proposals on ``do_accept``, merging the weights."""
    return ProposalState(
        state=_batch.where(do_accept, new_proposal.state, proposal.state),
        energy=torch.where(do_accept, new_proposal.energy, proposal.energy),
        weight=torch.logaddexp(proposal.weight, new_proposal.weight),
        sum_log_p_accept=torch.logaddexp(proposal.sum_log_p_accept,
                                         new_proposal.sum_log_p_accept),
    )
