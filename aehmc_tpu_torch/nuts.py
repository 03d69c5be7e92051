"""No-U-Turn Sampler, the iterative NUTS kernel (port of :mod:`aehmc_tpu.nuts`).

Metric, integrator, iterative U-turn criterion, subtree integration and
doubling loop assembled into one transition over one chain or a ``(chains,
dim)`` batch (:mod:`aehmc_tpu_torch.trajectory`).

``new_kernel``'s step draws its randomness from the key's Philox streams,
the layout of the fused NUTS kernels
(:func:`aehmc_tpu_torch.ops.philox.nuts_streams`): momentum normals,
directions, the biased-merge uniforms, and the leaf uniforms at the index
``2**d - 1 + i``, the latter drawn one doubling at a time, when a chain
first reaches it.  So a seeded step is the externalized step fed those
streams of the same key, bit for bit.
"""

from typing import Callable, Tuple

import torch

from aehmc_tpu_torch import _batch, keys, metrics
from aehmc_tpu_torch.hmc import new_state  # noqa: F401
from aehmc_tpu_torch.integrators import velocity_verlet
from aehmc_tpu_torch.ops.philox import leaf_uniforms, nuts_streams
from aehmc_tpu_torch.termination import iterative_uturn
from aehmc_tpu_torch.trajectory import (
    dynamic_integration,
    dynamic_integration_paired,
    multiplicative_expansion,
)
from aehmc_tpu_torch.types import (
    ChainState,
    Diagnostics,
    IntegratorState,
    ProposalState,
)


# the doublings whose leaf uniforms a seeded step draws up front
EAGER_DOUBLINGS = 4


def _rows(x_t: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
    """A ``(rows, C)`` stream as ``batch + (rows,)``."""
    x = x_t.to(position.dtype)
    return x.T.contiguous() if position.ndim == 2 else x[:, 0]


def _transition(potential_fn, integrator, max_num_expansions,
                divergence_threshold, paired_leaves, state: ChainState,
                momentum, direction_fn, bias_uniform_fn, leaf_uniform_fn,
                step_size, inverse_mass_matrix
                ) -> Tuple[ChainState, Diagnostics]:
    _, kinetic_energy_fn, uturn_check_fn = metrics.gaussian_metric(
        _batch.like(inverse_mass_matrix, state.position))
    new_termination_state, update_termination_state, is_criterion_met = (
        iterative_uturn(uturn_check_fn))
    integration = (dynamic_integration_paired if paired_leaves
                   else dynamic_integration)
    trajectory_integrator = integration(
        integrator(potential_fn, kinetic_energy_fn), kinetic_energy_fn,
        new_termination_state, update_termination_state, is_criterion_met,
        max_num_expansions, divergence_threshold, leaf_uniform_fn)
    expand = multiplicative_expansion(trajectory_integrator, uturn_check_fn,
                                      max_num_expansions, direction_fn,
                                      bias_uniform_fn)
    initial_state = IntegratorState(state.position, momentum,
                                    state.potential_energy,
                                    state.potential_energy_grad)
    initial_energy = initial_state.potential_energy + kinetic_energy_fn(
        momentum)
    # weight 0, sum_log_p_accept -inf
    initial_proposal = ProposalState(
        state=ChainState(state.position, state.potential_energy,
                         state.potential_energy_grad),
        energy=initial_energy,
        weight=torch.zeros_like(initial_energy),
        sum_log_p_accept=torch.full_like(initial_energy, -torch.inf),
    )
    result = expand(initial_proposal, initial_state, initial_state, momentum,
                    initial_energy, step_size)
    info = Diagnostics(
        acceptance_probability=result.acceptance_probability,
        num_doublings=result.step,
        is_turning=result.is_turning,
        is_diverging=result.is_diverging,
        energy=result.proposal.energy,
        num_integration_steps=result.num_integration_steps,
    )
    return result.proposal.state, info


def new_kernel(
    logprob_fn: Callable,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    integrator: Callable = velocity_verlet,
    paired_leaves: bool = True,
) -> Callable:
    """Build an iterative NUTS transition kernel.

    ``paired_leaves`` takes the two-leaves-a-loop-iteration subtree loop
    (the default, as in the JAX package); False the single-leaf loop.

    Returns ``step(key, state, step_size, inverse_mass_matrix) ->
    (ChainState, Diagnostics)``; ``key`` is a
    :class:`aehmc_tpu_torch.keys.Key`, a ``torch.Generator`` or an int
    seed.
    """

    def potential_fn(x):
        return -logprob_fn(x)

    def step(key, state: ChainState, step_size, inverse_mass_matrix):
        key = keys.as_key(key)
        position = state.position
        chains = keys.num_chains(position)
        # doublings 0-3 come with the other streams in one Philox call,
        # a later doubling's leaves when a chain first reaches it
        first_rows = 1 << min(max_num_expansions, EAGER_DOUBLINGS)
        z, directions, u_bias, u_leaf = nuts_streams(
            key.seed, chains, keys.event_size(position), max_num_expansions,
            device=position.device, chain_offset=key.chain_offset,
            leaf_rows=first_rows)
        momentum_generator = metrics.gaussian_metric(
            _batch.like(inverse_mass_matrix, position))[0]
        momentum = momentum_generator(keys.to_batch(z, position))
        directions = _rows(directions, position)
        u_bias = _rows(u_bias, position)
        eager, drawn = _rows(u_leaf, position), {}

        def leaf_uniform_fn(index):
            if index < first_rows:
                return eager[..., index]
            doubling = (index + 1).bit_length() - 1
            first = (1 << doubling) - 1
            if doubling not in drawn:
                drawn[doubling] = _rows(leaf_uniforms(
                    key.seed, chains, first, 1 << doubling,
                    device=position.device, chain_offset=key.chain_offset),
                    position)
            return drawn[doubling][..., index - first]

        return _transition(
            potential_fn, integrator, max_num_expansions,
            divergence_threshold, paired_leaves, state, momentum,
            lambda d: directions[..., d] > 0, lambda d: u_bias[..., d],
            leaf_uniform_fn, step_size, inverse_mass_matrix)

    return step


def new_externalized_kernel(
    logprob_fn: Callable,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    integrator: Callable = velocity_verlet,
    paired_leaves: bool = True,
) -> Callable:
    """The NUTS transition with all its randomness passed in.

    Returns ``step(state, momentum, directions, u_bias, u_leaf, step_size,
    inverse_mass_matrix) -> (ChainState, Diagnostics)``: ``momentum`` the
    initial momentum, ``directions`` ``batch + (K,)`` of ±1, ``u_bias``
    ``batch + (K,)`` uniforms of the biased merge, ``u_leaf`` ``batch +
    (2**K,)`` where leaf ``i`` of doubling ``d`` reads index ``2**d - 1 +
    i`` (the NumPy oracle's convention).
    """

    def potential_fn(x):
        return -logprob_fn(x)

    def step(state: ChainState, momentum, directions, u_bias, u_leaf,
             step_size, inverse_mass_matrix):
        return _transition(
            potential_fn, integrator, max_num_expansions,
            divergence_threshold, paired_leaves, state, momentum,
            lambda d: directions[..., d] > 0, lambda d: u_bias[..., d],
            lambda i: u_leaf[..., i], step_size, inverse_mass_matrix)

    return step
