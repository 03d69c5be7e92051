"""Hamiltonian Monte Carlo (port of :mod:`aehmc_tpu.hmc`).

``new_kernel`` builds ``step(key, state, step_size, inverse_mass_matrix,
num_integration_steps) -> (ChainState, Diagnostics)`` over one chain or a
``(chains, dim)`` batch.  The key's Philox streams
(:func:`aehmc_tpu_torch.keys.normals_and_uniform`) give the momentum's
standard normals and the Metropolis uniform; a ``(z, u)`` pair passes them
in.
"""

from typing import Callable, Tuple

import torch

from aehmc_tpu_torch import _batch, keys, metrics
from aehmc_tpu_torch.integrators import velocity_verlet
from aehmc_tpu_torch.trajectory import static_integration
from aehmc_tpu_torch.types import ChainState, Diagnostics, IntegratorState


def new_state(position: torch.Tensor, logprob_fn: Callable) -> ChainState:
    """The chain state ``(q, U, ∇U)`` of a position or of each row of a
    ``(chains, dim)`` batch, ``U = -logprob_fn(q)``."""
    potential, grad = _batch.value_and_grad(lambda q: -logprob_fn(q))(position)
    return ChainState(position=position, potential_energy=potential,
                      potential_energy_grad=grad)


def metropolis(initial_state: IntegratorState, final_state: IntegratorState,
               kinetic_energy_fn: Callable, divergence_threshold: float, u):
    """The Metropolis test of ``final_state`` (its momentum already
    flipped): accept iff ``u < min(1, exp(ΔE))``, NaN ΔE taken to
    ``-inf``.  Returns ``(p_accept, do_accept, is_divergent, energy,
    new_energy)``."""
    energy = initial_state.potential_energy + kinetic_energy_fn(
        initial_state.momentum)
    new_energy = final_state.potential_energy + kinetic_energy_fn(
        final_state.momentum)
    delta_energy = energy - new_energy
    delta_energy = torch.where(torch.isnan(delta_energy), -torch.inf,
                               delta_energy)
    is_divergent = torch.abs(delta_energy) > divergence_threshold
    p_accept = torch.clamp(torch.exp(delta_energy), 0.0, 1.0)
    return p_accept, u < p_accept, is_divergent, energy, new_energy


def info_of(p_accept, is_divergent, energy, num_integration_steps
            ) -> Diagnostics:
    """Diagnostics of a kernel without a tree: no doublings, not turning."""
    shape, device = p_accept.shape, p_accept.device
    return Diagnostics(
        acceptance_probability=p_accept,
        num_doublings=torch.zeros(shape, dtype=torch.int32, device=device),
        is_turning=torch.zeros(shape, dtype=torch.bool, device=device),
        is_diverging=is_divergent,
        energy=energy,
        num_integration_steps=torch.full(shape, int(num_integration_steps),
                                         dtype=torch.int32, device=device),
    )


def new_kernel(logprob_fn: Callable, divergence_threshold: float = 1000.0,
               integrator: Callable = velocity_verlet) -> Callable:
    """Build an HMC transition kernel; ``integrator`` is a symplectic scheme
    factory ``(potential_fn, kinetic_energy_fn) -> one_step``.

    Returns ``step(key, state, step_size, inverse_mass_matrix,
    num_integration_steps) -> (ChainState, Diagnostics)``.
    """

    def potential_fn(x):
        return -logprob_fn(x)

    def step(key, state: ChainState, step_size, inverse_mass_matrix,
             num_integration_steps) -> Tuple[ChainState, Diagnostics]:
        num_integration_steps = int(num_integration_steps)
        z, u = keys.normals_and_uniform(key, state.position)
        momentum_generator, kinetic_energy_fn, _ = metrics.gaussian_metric(
            _batch.like(inverse_mass_matrix, state.position))
        integrate = static_integration(
            integrator(potential_fn, kinetic_energy_fn), num_integration_steps)
        initial_state = IntegratorState(
            state.position, momentum_generator(z), state.potential_energy,
            state.potential_energy_grad)
        final_state = integrate(initial_state, step_size)
        final_state = final_state._replace(momentum=-final_state.momentum)
        p_accept, do_accept, is_divergent, energy, new_energy = metropolis(
            initial_state, final_state, kinetic_energy_fn,
            divergence_threshold, u)
        accepted = _batch.where(do_accept, final_state, initial_state)
        new_chain_state = ChainState(accepted.position,
                                     accepted.potential_energy,
                                     accepted.potential_energy_grad)
        return new_chain_state, info_of(
            p_accept, is_divergent, torch.where(do_accept, new_energy, energy),
            num_integration_steps)

    return step
