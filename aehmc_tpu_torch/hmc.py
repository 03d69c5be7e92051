"""Hamiltonian Monte Carlo chain states (port of :func:`aehmc_tpu.hmc.new_state`;
the XLA HMC kernel of that module is ROADMAP.md item 1.9)."""

from typing import Callable

import torch
from torch.func import grad_and_value

from aehmc_tpu_torch.types import ChainState


def new_state(position: torch.Tensor, logprob_fn: Callable) -> ChainState:
    """The chain state ``(q, U, ∇U)`` of one position, ``U =
    -logprob_fn(q)``.  Map it over a chain batch with ``torch.func.vmap``,
    as :func:`aehmc_tpu_torch.parallel.sample_sharded` does."""
    grad, potential = grad_and_value(lambda q: -logprob_fn(q))(position)
    return ChainState(position=position, potential_energy=potential,
                      potential_energy_grad=grad)
