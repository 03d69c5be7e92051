"""Generalized HMC (Horowitz): persistent momentum with partial refresh
(port of :mod:`aehmc_tpu.ghmc`).

``p <- α p + √(1 - α²) ξ`` with ``ξ ~ N(0, M)``, leapfrog steps, a
Metropolis-Hastings accept on the energy difference and the momentum
flipped on rejection, over one chain or a ``(chains, dim)`` batch.  The
key's Philox streams (:func:`aehmc_tpu_torch.keys.normals_and_uniform`)
give ξ's standard normals and the accept uniform; a ``(z, u)`` pair passes
them in.  :func:`new_noise_kernel` takes ξ and the uniform as inputs: the
MEADS fold transition (:mod:`aehmc_tpu_torch.meads`) draws them for the
whole fleet at once.
"""

from typing import Callable, Tuple

import torch

from aehmc_tpu_torch import _batch, keys, metrics
from aehmc_tpu_torch.hmc import info_of, metropolis
from aehmc_tpu_torch.integrators import velocity_verlet
from aehmc_tpu_torch.trajectory import static_integration
from aehmc_tpu_torch.types import Diagnostics, IntegratorState


def new_state(key, position: torch.Tensor, logprob_fn: Callable,
              inverse_mass_matrix=None) -> IntegratorState:
    """A GHMC state: the position, a momentum drawn from ``N(0, M)`` (the
    key's normals), U and ∇U."""
    if inverse_mass_matrix is None:
        inverse_mass_matrix = torch.ones(position.shape[-1:],
                                         dtype=position.dtype,
                                         device=position.device)
    momentum_generator, _, _ = metrics.gaussian_metric(
        _batch.like(inverse_mass_matrix, position))
    z, _ = keys.normals_and_uniform(key, position)
    potential, grad = _batch.value_and_grad(lambda q: -logprob_fn(q))(position)
    return IntegratorState(position=position,
                           momentum=momentum_generator(z),
                           potential_energy=potential,
                           potential_energy_grad=grad)


def new_kernel(logprob_fn: Callable, divergence_threshold: float = 1000.0,
               integrator: Callable = velocity_verlet,
               num_integration_steps: int = 1) -> Callable:
    """Build a GHMC transition kernel.

    Returns ``step(key, state, step_size, alpha, inverse_mass_matrix) ->
    (IntegratorState, Diagnostics)``; ``alpha`` in [0, 1) is the momentum
    persistence (0 refreshes fully: one-step HMC).
    """
    noise_step = new_noise_kernel(logprob_fn, divergence_threshold,
                                  integrator, num_integration_steps)

    def step(key, state: IntegratorState, step_size, alpha,
             inverse_mass_matrix) -> Tuple[IntegratorState, Diagnostics]:
        momentum_generator, _, _ = metrics.gaussian_metric(
            _batch.like(inverse_mass_matrix, state.position))
        z, uniform = keys.normals_and_uniform(key, state.position)
        return noise_step(momentum_generator(z), uniform, state, step_size,
                          alpha, inverse_mass_matrix)

    return step


def new_noise_kernel(logprob_fn: Callable, divergence_threshold: float = 1000.0,
                     integrator: Callable = velocity_verlet,
                     num_integration_steps: int = 1) -> Callable:
    """GHMC with its randomness as inputs.

    Returns ``step(noise, uniform, state, step_size, alpha,
    inverse_mass_matrix) -> (IntegratorState, Diagnostics)`` with ``noise ~
    N(0, M)`` the refresh innovation (the state's shape) and ``uniform`` the
    Metropolis-Hastings coin (the batch shape).  A NaN energy difference
    counts as ``-inf`` (rejected); ``is_diverging`` is ``|ΔE| >
    divergence_threshold``; the negated accepted momentum is stored.
    """

    def potential_fn(x):
        return -logprob_fn(x)

    def step(noise, uniform, state: IntegratorState, step_size, alpha,
             inverse_mass_matrix) -> Tuple[IntegratorState, Diagnostics]:
        position = state.position
        _, kinetic_energy_fn, _ = metrics.gaussian_metric(
            _batch.like(inverse_mass_matrix, position))
        alpha = _batch.expand(_batch.like(alpha, position), position)
        # partial refresh: p ~ N(alpha p, (1 - alpha^2) M)
        momentum = alpha * state.momentum + torch.sqrt(1.0 - alpha**2) * noise
        init = state._replace(momentum=momentum)
        integrate = static_integration(
            integrator(potential_fn, kinetic_energy_fn), num_integration_steps)
        final = integrate(init, step_size)
        final = final._replace(momentum=-final.momentum)
        p_accept, do_accept, is_diverging, energy, new_energy = metropolis(
            init, final, kinetic_energy_fn, divergence_threshold, uniform)
        # keep the negated accepted momentum (the flip-flip composition):
        # accepted moves continue forward, rejections reverse
        accepted = _batch.where(
            do_accept, final._replace(momentum=-final.momentum),
            init._replace(momentum=-init.momentum))
        return accepted, info_of(
            p_accept, is_diverging, torch.where(do_accept, new_energy, energy),
            num_integration_steps)

    return step
