"""Metropolis-adjusted Langevin algorithm (port of :mod:`aehmc_tpu.mala`).

Proposal ``q' = q + ε²/2 · M⁻¹ ∇log p(q) + ε √M⁻¹ z`` with the exact
asymmetric Metropolis-Hastings correction, over one chain or a ``(chains,
dim)`` batch.  The key's Philox streams
(:func:`aehmc_tpu_torch.keys.normals_and_uniform`) give ``z`` and the
accept uniform; a ``(z, u)`` pair passes them in.
"""

from typing import Callable, Tuple

import torch

from aehmc_tpu_torch import _batch, keys
from aehmc_tpu_torch.hmc import info_of
from aehmc_tpu_torch.metrics import PerChain
from aehmc_tpu_torch.types import ChainState, Diagnostics


def new_state(position: torch.Tensor, logprob_fn: Callable) -> ChainState:
    potential, grad = _batch.value_and_grad(lambda q: -logprob_fn(q))(position)
    return ChainState(position, potential, grad)


def new_kernel(logprob_fn: Callable,
               divergence_threshold: float = 1000.0) -> Callable:
    """Build a MALA transition kernel.

    Returns ``step(key, state, step_size, inverse_mass_matrix) ->
    (ChainState, Diagnostics)``; the inverse mass matrix is a scalar or
    diagonal preconditioner (shared, or one a chain in
    :class:`~aehmc_tpu_torch.metrics.PerChain`), a dense one raises
    ``ValueError``.
    """
    potential_vag = _batch.value_and_grad(lambda q: -logprob_fn(q))

    def step(key, state: ChainState, step_size, inverse_mass_matrix
             ) -> Tuple[ChainState, Diagnostics]:
        position = state.position
        precond = _batch.like(inverse_mass_matrix, position)
        per_chain = isinstance(precond, PerChain)
        if per_chain:
            precond = precond.inverse_mass_matrix
        if precond.ndim - per_chain > 1:
            raise ValueError(
                "MALA supports scalar or diagonal preconditioners only; got "
                f"a {precond.ndim - per_chain}-d inverse mass matrix"
            )
        if per_chain:
            precond = _batch.expand(precond, position)
        noise, u = keys.normals_and_uniform(key, position)
        eps = _batch.expand(_batch.like(step_size, position), position)
        eps2 = torch.square(eps)
        scale = eps * torch.sqrt(precond)

        # the drift uses grad(log p) = -grad(U)
        mean_fwd = position - 0.5 * eps2 * precond * state.potential_energy_grad
        proposal = mean_fwd + scale * noise
        new_potential, new_grad = potential_vag(proposal)
        # the reverse move's density: q given q'
        mean_bwd = proposal - 0.5 * eps2 * precond * new_grad

        def log_q(x, mean):
            terms = torch.square(x - mean) / (eps2 * precond)
            return -0.5 * (torch.sum(terms, dim=-1) if position.ndim
                           else terms)

        log_ratio = ((state.potential_energy - new_potential)
                     + log_q(position, mean_bwd) - log_q(proposal, mean_fwd))
        log_ratio = torch.where(torch.isnan(log_ratio), -torch.inf, log_ratio)
        is_diverging = torch.abs(log_ratio) > divergence_threshold
        p_accept = torch.clamp(torch.exp(log_ratio), 0.0, 1.0)
        do_accept = u < p_accept
        new_state_ = _batch.where(
            do_accept, ChainState(proposal, new_potential, new_grad), state)
        return new_state_, info_of(p_accept, is_diverging,
                                   new_state_.potential_energy, 1)

    return step
