"""Trajectory construction: static integration, NUTS subtree integration and
multiplicative (doubling) expansion (port of :mod:`aehmc_tpu.trajectory`).

The JAX loops are ``lax.while_loop``s over one chain, batched by ``vmap``,
whose batching rule runs the body while any lane is active and freezes the
carry of every finished lane.  Here the loops run on the host over a chain
batch (or one chain) for as long as any chain is active, and every carry
field of a finished chain is frozen with ``torch.where`` (:func:`_batch.where`),
so each chain computes what the JAX per-chain kernel computes.  The leaf
step of a subtree and the doubling are Python ints: every chain still
running has the same one.  Each loop iteration reads one flag on the host
(one synchronisation): the subtree loop once a leaf (once a pair of leaves
in the paired loop, plus one before the epilogue leaf), the doubling loop
once a doubling.

As in the JAX package, a subtree of doubling ``d`` integrates exactly
``2**d`` leaves (PARITY.md deviation 1; the reference's until-scan takes up
to ``2**d + 1``).  Randomness is external: ``leaf_uniform_fn(leaf_index)``
gives the uniforms of leaf ``i`` of doubling ``d`` at the global index
``2**d - 1 + i``, ``direction_fn(d)`` the go-right flags and
``bias_uniform_fn(d)`` the uniforms of the biased merge, each of the batch
shape.
"""

from typing import Callable, NamedTuple

import torch

from aehmc_tpu_torch import _batch
from aehmc_tpu_torch.proposals import (
    progressive_biased_sampling_from_u,
    progressive_uniform_sampling_from_u,
    proposal_generator,
)
from aehmc_tpu_torch.types import IntegratorState, ProposalState

__all__ = [
    "static_integration",
    "dynamic_integration",
    "dynamic_integration_paired",
    "multiplicative_expansion",
    "where_proposal",
]


def static_integration(integrator: Callable, num_integration_steps) -> Callable:
    """A fixed-length trajectory: ``integrate(init_state, step_size)`` takes
    ``num_integration_steps`` integrator steps (a tensor is read once)."""

    def integrate(init_state: IntegratorState, step_size) -> IntegratorState:
        state = init_state
        for _ in range(int(num_integration_steps)):
            state = integrator(state, step_size)
        return state

    return integrate


def _signed_step(direction, step_size, position: torch.Tensor) -> torch.Tensor:
    """``direction * step_size``, each of the batch shape, shaped to
    broadcast against ``position``."""
    eps = _batch.like(step_size, position)
    direction = _batch.like(direction, position)
    return _batch.expand(direction, position) * _batch.expand(eps, position)


def _all_true(like: torch.Tensor) -> torch.Tensor:
    return torch.ones(like.shape, dtype=torch.bool, device=like.device)


def _subtree_start(integrator, generate_proposal, new_termination_state,
                   update_termination_state, max_num_doublings,
                   previous_last_state, d_eps, initial_energy):
    """Leaf 0 of a subtree: it seeds the subtree's proposal, writes
    checkpoint slot 0 and is never checked for a U-turn."""
    termination_state = new_termination_state(previous_last_state.position,
                                              max_num_doublings)
    state = integrator(previous_last_state, d_eps)
    proposal, is_diverging = generate_proposal(initial_energy, state)
    momentum_sum = state.momentum
    termination_state = update_termination_state(
        termination_state, momentum_sum, state.momentum, 0, parity=0)
    return proposal, state, momentum_sum, termination_state, is_diverging


def dynamic_integration(
    integrator: Callable,
    kinetic_energy: Callable,
    new_termination_state: Callable,
    update_termination_state: Callable,
    is_criterion_met: Callable,
    max_num_doublings: int,
    divergence_threshold: float,
    leaf_uniform_fn: Callable,
) -> Callable:
    """Integrate one NUTS subtree in one direction until it is complete,
    diverges or makes a U-turn, one leaf a loop iteration.

    Returns ``integrate(previous_last_state, direction, max_num_steps,
    step_size, initial_energy, active=None)`` returning ``(proposal,
    last_state, momentum_sum, trajectory_length, is_diverging,
    has_terminated)``; only the chains set in ``active`` (all by default)
    run, the others' outputs are to be discarded.  ``max_num_steps`` is a
    Python int.
    """
    generate_proposal = proposal_generator(kinetic_energy, divergence_threshold)

    def integrate(previous_last_state: IntegratorState, direction,
                  max_num_steps: int, step_size, initial_energy, active=None):
        d_eps = _signed_step(direction, step_size,
                             previous_last_state.position)
        proposal, state, momentum_sum, term_state, is_diverging = (
            _subtree_start(integrator, generate_proposal,
                           new_termination_state, update_termination_state,
                           max_num_doublings, previous_last_state, d_eps,
                           initial_energy))
        has_terminated = torch.zeros_like(is_diverging)
        length = torch.ones(is_diverging.shape, dtype=torch.int32,
                            device=is_diverging.device)
        running = (_all_true(is_diverging) if active is None else active)
        running = running & ~is_diverging
        step = 1
        while step < max_num_steps and bool(running.any()):
            new_state = integrator(state, d_eps)
            new_proposal, new_diverging = generate_proposal(initial_energy,
                                                            new_state)
            u = leaf_uniform_fn((max_num_steps - 1) + step)
            sampled = progressive_uniform_sampling_from_u(u, proposal,
                                                          new_proposal)
            new_momentum_sum = momentum_sum + new_state.momentum
            # checked against the buffers before this step's write
            terminated = is_criterion_met(term_state, new_momentum_sum,
                                          new_state.momentum, step)
            term_state = update_termination_state(
                term_state, new_momentum_sum, new_state.momentum, step)
            proposal, state, momentum_sum, is_diverging, has_terminated = (
                _batch.where(running, (sampled, new_state, new_momentum_sum,
                                       new_diverging, terminated),
                             (proposal, state, momentum_sum, is_diverging,
                              has_terminated)))
            length = torch.where(running, step + 1, length)
            running = running & ~new_diverging & ~terminated
            step += 1
        return (proposal, state, momentum_sum, length, is_diverging,
                has_terminated)

    return integrate


def dynamic_integration_paired(
    integrator: Callable,
    kinetic_energy: Callable,
    new_termination_state: Callable,
    update_termination_state: Callable,
    is_criterion_met: Callable,
    max_num_doublings: int,
    divergence_threshold: float,
    leaf_uniform_fn: Callable,
) -> Callable:
    """:func:`dynamic_integration` advancing two leaves (odd, even) a loop
    iteration, with the final odd leaf as an epilogue; the same leaves,
    uniforms and stopping rule, half the loop iterations.  A chain that
    stops at the pair's first leaf keeps that leaf's values."""
    generate_proposal = proposal_generator(kinetic_energy, divergence_threshold)

    def integrate(previous_last_state: IntegratorState, direction,
                  max_num_steps: int, step_size, initial_energy, active=None):
        d_eps = _signed_step(direction, step_size,
                             previous_last_state.position)

        def one_leaf(proposal, last_state, momentum_sum, step, term_state):
            new_state = integrator(last_state, d_eps)
            new_proposal, is_diverging = generate_proposal(initial_energy,
                                                           new_state)
            u = leaf_uniform_fn((max_num_steps - 1) + step)
            sampled = progressive_uniform_sampling_from_u(u, proposal,
                                                          new_proposal)
            new_momentum_sum = momentum_sum + new_state.momentum
            if term_state is None:
                has_terminated = torch.zeros_like(is_diverging)
            else:
                has_terminated = is_criterion_met(
                    term_state, new_momentum_sum, new_state.momentum, step)
            return (sampled, new_state, new_momentum_sum, is_diverging,
                    has_terminated)

        proposal, state, momentum_sum, term_state, is_diverging = (
            _subtree_start(integrator, generate_proposal,
                           new_termination_state, update_termination_state,
                           max_num_doublings, previous_last_state, d_eps,
                           initial_energy))
        has_terminated = torch.zeros_like(is_diverging)
        length = torch.ones(is_diverging.shape, dtype=torch.int32,
                            device=is_diverging.device)
        active = _all_true(is_diverging) if active is None else active
        running = active & ~is_diverging
        step = 1  # the pair's odd leaf; every running chain has length == step
        while step + 1 < max_num_steps and bool(running.any()):
            prop_a, state_a, psum_a, div_a, term_a = one_leaf(
                proposal, state, momentum_sum, step, term_state)
            ts_a = update_termination_state(term_state, psum_a,
                                            state_a.momentum, step, parity=1)
            stop_a = div_a | term_a
            prop_b, state_b, psum_b, div_b, _ = one_leaf(
                prop_a, state_a, psum_a, step + 1, None)
            # a chain that stops at leaf a never reads its buffers again
            term_state = update_termination_state(
                ts_a, psum_b, state_b.momentum, step + 1, parity=0)
            new = _batch.where(stop_a, (prop_a, state_a, psum_a, div_a),
                               (prop_b, state_b, psum_b, div_b))
            proposal, state, momentum_sum, is_diverging, has_terminated = (
                _batch.where(running, new + (term_a,),
                             (proposal, state, momentum_sum, is_diverging,
                              has_terminated)))
            length = torch.where(running,
                                 torch.where(stop_a, step + 1, step + 2),
                                 length)
            running = running & ~stop_a & ~div_b
            step += 2

        # epilogue: the final odd leaf max_num_steps - 1, whose check decides
        # whether the completed subtree U-turned
        do_epilogue = active & ~is_diverging & ~has_terminated
        if max_num_steps >= 2 and bool(do_epilogue.any()):
            epilogue = one_leaf(proposal, state, momentum_sum,
                                max_num_steps - 1, term_state)
            proposal, state, momentum_sum, is_diverging, has_terminated = (
                _batch.where(do_epilogue, epilogue,
                             (proposal, state, momentum_sum, is_diverging,
                              has_terminated)))
            length = torch.where(do_epilogue, length + 1, length)
        return (proposal, state, momentum_sum, length, is_diverging,
                has_terminated)

    return integrate


class ExpansionState(NamedTuple):
    """Carry of the doubling loop (the JAX carry without its PRNG key: the
    randomness comes from the kernel's streams)."""

    step: torch.Tensor
    proposal: ProposalState
    left_state: IntegratorState
    right_state: IntegratorState
    momentum_sum: torch.Tensor
    acceptance_probability: torch.Tensor
    num_integration_steps: torch.Tensor
    is_diverging: torch.Tensor
    is_turning: torch.Tensor
    has_subtree_terminated: torch.Tensor


def multiplicative_expansion(
    trajectory_integrator: Callable,
    uturn_check_fn: Callable,
    max_num_expansions: int,
    direction_fn: Callable,
    bias_uniform_fn: Callable,
) -> Callable:
    """The NUTS doubling loop: at doubling ``d`` go right where
    ``direction_fn(d)``, integrate a subtree of ``2**d`` leaves from that
    edge, merge it (biased, only for a cleanly completed subtree; the
    acceptance statistic always), and stop on divergence, U-turn or a
    subtree's own termination.

    Returns ``expand(proposal, left_state, right_state, momentum_sum,
    initial_energy, step_size) -> ExpansionState``.
    """

    def expand(proposal: ProposalState, left_state: IntegratorState,
               right_state: IntegratorState, momentum_sum, initial_energy,
               step_size) -> ExpansionState:
        energy = proposal.energy
        false = torch.zeros(energy.shape, dtype=torch.bool,
                            device=energy.device)
        zero = torch.zeros(energy.shape, dtype=torch.int32,
                           device=energy.device)
        s = ExpansionState(
            step=zero, proposal=proposal, left_state=left_state,
            right_state=right_state, momentum_sum=momentum_sum,
            acceptance_probability=torch.zeros_like(energy),
            num_integration_steps=zero, is_diverging=false, is_turning=false,
            has_subtree_terminated=false,
        )
        active = ~false
        for d in range(max_num_expansions):
            if not bool(active.any()):
                break
            go_right = direction_fn(d)
            direction = torch.where(go_right, 1.0, -1.0).to(energy.dtype)
            start_state = _batch.where(go_right, s.right_state, s.left_state)
            (new_proposal, new_state, subtree_momentum_sum,
             subtrajectory_length, is_diverging,
             has_subtree_terminated) = trajectory_integrator(
                start_state, direction, 1 << d, step_size, initial_energy,
                active=active)
            # the subtree integrates forward in its own time: swap the edges
            new_left = _batch.where(go_right, s.left_state, new_state)
            new_right = _batch.where(go_right, new_state, s.right_state)
            new_momentum_sum = s.momentum_sum + subtree_momentum_sum
            acceptance_probability = (torch.exp(new_proposal.sum_log_p_accept)
                                      / subtrajectory_length.to(energy.dtype))
            # rejected subtrees still count in the acceptance statistic
            updated_proposal = s.proposal._replace(
                sum_log_p_accept=torch.logaddexp(
                    new_proposal.sum_log_p_accept,
                    s.proposal.sum_log_p_accept))
            sampled = where_proposal(
                is_diverging | has_subtree_terminated, updated_proposal,
                progressive_biased_sampling_from_u(
                    bias_uniform_fn(d), s.proposal, new_proposal))
            is_turning = uturn_check_fn(new_left.momentum, new_right.momentum,
                                        new_momentum_sum)
            new = ExpansionState(
                step=s.step + 1, proposal=sampled, left_state=new_left,
                right_state=new_right, momentum_sum=new_momentum_sum,
                acceptance_probability=acceptance_probability,
                num_integration_steps=(s.num_integration_steps
                                       + subtrajectory_length),
                is_diverging=is_diverging, is_turning=is_turning,
                has_subtree_terminated=has_subtree_terminated,
            )
            s = _batch.where(active, new, s)
            active = (active & ~is_diverging & ~is_turning
                      & ~has_subtree_terminated)
        return s

    return expand


def where_proposal(do_pick_left, left_proposal: ProposalState,
                   right_proposal: ProposalState) -> ProposalState:
    """Switch between two proposals on a condition."""
    return _batch.where(do_pick_left, left_proposal, right_proposal)
