"""Symplectic integrators for Hamiltonian dynamics (port of
:mod:`aehmc_tpu.integrators`).

Each ``one_step(state, step_size)`` takes one chain or a ``(chains, dim)``
batch (the step size ``()`` or ``(chains,)``) and costs the JAX version's
number of fresh potential gradients, by :func:`torch.func.grad_and_value`
(mapped over the chains by ``torch.func.vmap``).  The drift is the gradient
of the kinetic energy: the metric's ``velocity`` ``M⁻¹ p`` when the kinetic
energy carries one (:func:`aehmc_tpu_torch.metrics.gaussian_metric`), else
autograd of it.
"""

from typing import Callable

import torch
from torch.func import grad

from aehmc_tpu_torch._batch import expand, like, value_and_grad
from aehmc_tpu_torch.types import IntegratorState


def new_integrator_state(potential_fn: Callable, position: torch.Tensor,
                         momentum: torch.Tensor) -> IntegratorState:
    """The integrator state of ``position``, computing U and ∇U once."""
    potential_energy, potential_energy_grad = value_and_grad(potential_fn)(
        position)
    return IntegratorState(position=position, momentum=momentum,
                           potential_energy=potential_energy,
                           potential_energy_grad=potential_energy_grad)


def _kinetic_grad(kinetic_energy_fn: Callable) -> Callable:
    velocity = getattr(kinetic_energy_fn, "velocity", None)
    if velocity is not None:
        return velocity
    return grad(lambda p: torch.sum(kinetic_energy_fn(p)))


def _step_size(step_size, position: torch.Tensor) -> torch.Tensor:
    return expand(like(step_size, position), position)


def _palindromic(b, a, potential_fn: Callable,
                 kinetic_energy_fn: Callable) -> Callable:
    """``B(b[0]) A(a[0]) B(b[1]) ... A(a[-1]) B(b[0])``: kicks ``b`` and
    drifts ``a`` of a palindromic scheme, each kick but the last one taking
    a fresh gradient."""
    potential_vag = value_and_grad(potential_fn)
    kinetic_grad = _kinetic_grad(kinetic_energy_fn)

    def one_step(state: IntegratorState, step_size) -> IntegratorState:
        q, p, u, g = state
        eps = _step_size(step_size, q)
        for i, a_i in enumerate(a):
            p = p - b[i] * eps * g
            q = q + a_i * eps * kinetic_grad(p)
            u, g = potential_vag(q)
        p = p - b[-1] * eps * g
        return IntegratorState(q, p, u, g)

    return one_step


def velocity_verlet(potential_fn: Callable,
                    kinetic_energy_fn: Callable) -> Callable:
    """Velocity Verlet: half kick, drift, half kick; one gradient a step."""
    return _palindromic((0.5, 0.5), (1.0,), potential_fn, kinetic_energy_fn)


def mclachlan(potential_fn: Callable, kinetic_energy_fn: Callable) -> Callable:
    """McLachlan's minimum-norm two-stage scheme
    ``B(b1) A(1/2) B(1-2b1) A(1/2) B(b1)``; two gradients a step."""
    b1 = 0.1931833275037836
    return _palindromic((b1, 1.0 - 2.0 * b1, b1), (0.5, 0.5), potential_fn,
                        kinetic_energy_fn)


def yoshida(potential_fn: Callable, kinetic_energy_fn: Callable) -> Callable:
    """Three-stage ``B(b1) A(a1) B(b2) A(1-2a1) B(b2) A(a1) B(b1)`` with the
    Blanes-Casas-Sanz-Serna coefficients; three gradients a step."""
    b1 = 0.11888010966548
    a1 = 0.29619504261126
    b2 = 0.5 - b1
    return _palindromic((b1, b2, b2, b1), (a1, 1.0 - 2.0 * a1, a1),
                        potential_fn, kinetic_energy_fn)
