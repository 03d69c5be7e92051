"""Step-size adaptation by dual averaging, and the initial step-size search
(port of :mod:`aehmc_tpu.step_size`)."""

from typing import Callable, Tuple

import torch

from aehmc_tpu_torch import algorithms
from aehmc_tpu_torch.config import DualAveragingConfig
from aehmc_tpu_torch.types import DualAveragingState

_DA = DualAveragingConfig()


def dual_averaging_adaptation(
    target_acceptance_rate: float = _DA.target_acceptance_rate,
    gamma: float = _DA.gamma,
    t0: int = _DA.t0,
    kappa: float = _DA.kappa,
) -> Tuple[Callable, Callable]:
    """Tune the LOG step size towards ``target_acceptance_rate``: ``update``
    feeds ``target - acceptance_probability`` to dual averaging."""
    da_init, da_update = algorithms.dual_averaging(gamma, t0, kappa)

    def update(acceptance_probability, state: DualAveragingState):
        return da_update(target_acceptance_rate - acceptance_probability, state)

    return da_init, update


def find_reasonable_step_size(
    kernel_step: Callable,
    state,
    inverse_mass_matrix,
    initial_step_size=1.0,
    target_accept: float = 0.65,
    max_iters: int = 32,
    reduce_fn: Callable = None,
):
    """Double or halve the step size until the acceptance probability crosses
    ``target_accept`` (Stan's initial heuristic; port of
    :func:`aehmc_tpu.step_size.find_reasonable_step_size`).

    ``kernel_step(probe, state, step_size, inverse_mass_matrix)`` returns
    ``(state, info)`` with ``info.acceptance_probability``; ``probe`` is the
    probe's index (0, 1, ...), which the caller maps to its randomness as the
    JAX version splits a key.  ``reduce_fn`` pools a chain batch's
    acceptance into one scalar.  Each probe reads on the host whether any
    search is still running: at most ``max_iters`` synchronisations.

    The search has crossed only when two successive nonzero directions
    disagree; it returns the step size *at* the crossing (the first probed
    value whose acceptance landed on the other side of the target), and the
    user's value when the result is not finite or not positive.

    A ``(chains,)`` initial step size without ``reduce_fn`` runs one search
    a chain, elementwise: a chain's probes stop where its search alone
    would, and its lane then holds the user's value (the kernel's results
    there are not read).
    """
    if reduce_fn is None:
        reduce_fn = lambda a: a  # noqa: E731
    initial = torch.as_tensor(initial_step_size)
    last = probed = initial
    zero = torch.zeros(initial.shape, dtype=torch.int8, device=initial.device)
    direction = previous = zero

    def running():
        crossed = (previous != 0) & (direction != previous)
        return ~crossed & torch.isfinite(last) & (last > 0)

    i, active = 0, running()
    while i < max_iters and bool(active.any()):
        _, info = kernel_step(i, state, torch.where(active, last, initial),
                              inverse_mass_matrix)
        accept = reduce_fn(info.acceptance_probability)
        up = accept > target_accept
        new_direction = torch.where(up, 1, -1).to(torch.int8)
        factor = torch.where(up, 2.0, 0.5).to(last.dtype)
        last, probed = (torch.where(active, last * factor, last),
                        torch.where(active, last, probed))
        direction, previous = (torch.where(active, new_direction, direction),
                               torch.where(active, direction, previous))
        i, active = i + 1, running()
    crossed = (previous != 0) & (direction != previous)
    result = torch.where(crossed, probed, last)
    return torch.where(torch.isfinite(result) & (result > 0), result, initial)
