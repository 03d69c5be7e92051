"""Sampling drivers (port of :mod:`aehmc_tpu.sampling`).

- :func:`sample_loop`: ``num_samples`` transitions of any kernel, one chain
  or a chain batch.
- :func:`sample`: window adaptation and sampling of one chain in one call;
  :func:`sample_chains`: one independent warmup and run per chain, all
  chains in one batched loop.

The port's kernels take a ``(chains, dim)`` batch as they are, so
:func:`multi_chain` (the JAX package's ``vmap`` of a kernel) is the kernel
itself.  Keys are :mod:`aehmc_tpu_torch.keys` keys (a ``torch.Generator``
or an int seed gives one); draw ``t`` takes the ``t``-th split key.  The
loops run on the host, each transition on the position's device.
"""

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from aehmc_tpu_torch import _batch, ghmc, hmc, keys, mala, nuts
from aehmc_tpu_torch import window_adaptation
from aehmc_tpu_torch.metrics import PerChain
from aehmc_tpu_torch.types import ChainState, Diagnostics


class SampleResult(NamedTuple):
    final_state: torch.Tensor
    positions: Optional[torch.Tensor]
    diagnostics: Diagnostics
    step_size: torch.Tensor
    inverse_mass_matrix: torch.Tensor


def sample_loop(rng, kernel: Callable, initial_state, num_samples: int
                ) -> Tuple[ChainState, torch.Tensor, Diagnostics]:
    """``num_samples`` transitions of ``kernel(key, state) -> (state,
    info)`` (close over the step size and mass matrix with
    ``functools.partial``).  Returns ``(final_state, positions, infos)``,
    stacked over the draws."""
    state, positions, infos = initial_state, [], []
    for key in keys.split(rng, num_samples):
        state, info = kernel(key, state)
        positions.append(state.position)
        infos.append(info)
    return state, torch.stack(positions), _batch.stack(infos)


def multi_chain(kernel: Callable) -> Callable:
    return kernel


def make_kernel(
    logprob_fn: Callable,
    algorithm: str = "nuts",
    *,
    num_integration_steps: int = 32,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    ghmc_alpha: float = 0.9,
) -> Callable:
    """``kernel(key, state, step_size, inverse_mass_matrix)`` of the named
    algorithm ("nuts", "hmc", "mala" or "ghmc"; GHMC with the fixed
    persistence ``ghmc_alpha``, its state carrying a momentum: build it with
    :func:`new_sampler_state`)."""
    if algorithm == "nuts":
        return nuts.new_kernel(logprob_fn,
                               max_num_expansions=max_num_expansions,
                               divergence_threshold=divergence_threshold)
    if algorithm == "hmc":
        base = hmc.new_kernel(logprob_fn, divergence_threshold)
        return lambda key, state, eps, imm: base(key, state, eps, imm,
                                                 num_integration_steps)
    if algorithm == "mala":
        return mala.new_kernel(logprob_fn, divergence_threshold)
    if algorithm == "ghmc":
        base = ghmc.new_kernel(logprob_fn, divergence_threshold)
        return lambda key, state, eps, imm: base(key, state, eps, ghmc_alpha,
                                                 imm)
    raise ValueError(f"Unknown algorithm: {algorithm!r}")


def new_sampler_state(algorithm: str, rng, initial_position: torch.Tensor,
                      logprob_fn: Callable):
    """The initial state of the named algorithm: GHMC carries a momentum
    (drawn from the key), the others a plain ``ChainState``."""
    if algorithm == "ghmc":
        return ghmc.new_state(rng, initial_position, logprob_fn)
    return hmc.new_state(initial_position, logprob_fn)


def default_inverse_mass_matrix(position: torch.Tensor,
                                is_mass_matrix_full: bool) -> torch.Tensor:
    """The identity of a position's event: ``(dim, dim)`` when dense,
    ``(dim,)``, or ``()`` for a scalar position."""
    kw = dict(dtype=position.dtype, device=position.device)
    dim = position.shape[-1] if position.ndim else 0
    if is_mass_matrix_full and dim:
        return torch.eye(dim, **kw)
    return torch.ones((dim,) if dim else (), **kw)


def sample(
    rng,
    logprob_fn: Callable,
    initial_position: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    *,
    algorithm: str = "nuts",
    num_integration_steps: int = 32,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 1.0,
    target_acceptance_rate: float = 0.8,
    search_initial_step_size: bool = True,
    ghmc_alpha: float = 0.9,
    step_size=None,
    inverse_mass_matrix=None,
) -> SampleResult:
    """Window adaptation and sampling of one chain (a position of at most
    one dimension).  Passing ``step_size`` and/or ``inverse_mass_matrix``
    skips warmup; a missing one takes its default (``initial_step_size`` /
    the identity).  ``positions`` is ``(num_samples,) + position.shape``.

    A ``(chains, dim)`` position is that many independent chains in one
    batched loop: each row warms up alone (``window_adaptation.run`` of
    the batch), chain ``c`` drawing what a single-chain run with the
    key ``Key(seed, chain_offset + c)`` draws; ``step_size`` is then
    ``(chains,)`` and ``inverse_mass_matrix`` ``(chains, dim)`` or
    ``(chains, dim, dim)`` after warmup (:func:`sample_chains` gives the
    JAX layout)."""
    if algorithm == "mala" and is_mass_matrix_full:
        raise ValueError(
            "MALA supports scalar/diagonal preconditioners only; "
            "is_mass_matrix_full=True is not compatible with algorithm='mala'"
        )
    kernel = make_kernel(
        logprob_fn, algorithm, num_integration_steps=num_integration_steps,
        max_num_expansions=max_num_expansions,
        divergence_threshold=divergence_threshold, ghmc_alpha=ghmc_alpha,
    )
    init_key, warmup_key, sample_key = keys.split(rng, 3)
    state = new_sampler_state(algorithm, init_key, initial_position,
                              logprob_fn)
    chain_batch = initial_position.ndim == 2
    if step_size is None and inverse_mass_matrix is None and num_warmup > 0:
        state, (eps, imm), _ = window_adaptation.run(
            warmup_key, kernel, state, num_warmup,
            is_mass_matrix_full=is_mass_matrix_full,
            initial_step_size=initial_step_size,
            target_acceptance_rate=target_acceptance_rate,
            search_initial_step_size=search_initial_step_size,
        )
        kernel_imm = PerChain(imm) if chain_batch else imm
    else:
        eps = _batch.like(initial_step_size if step_size is None
                          else step_size, initial_position)
        imm = (default_inverse_mass_matrix(initial_position,
                                           is_mass_matrix_full)
               if inverse_mass_matrix is None
               else _batch.like(inverse_mass_matrix, initial_position))
        kernel_imm = imm
    final_state, positions, infos = sample_loop(
        sample_key, lambda key, s: kernel(key, s, eps, kernel_imm), state,
        num_samples)
    return SampleResult(final_state=final_state, positions=positions,
                        diagnostics=infos, step_size=eps,
                        inverse_mass_matrix=imm)


def sample_chains(
    rng,
    logprob_fn: Callable,
    initial_positions: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    **kwargs,
) -> SampleResult:
    """One independent chain per row of ``initial_positions (chains,
    dim)``, all in one batched :func:`sample`: chain ``c`` warms up and
    samples alone, drawing what :func:`sample` of its row alone with the key
    ``Key(seed, chain_offset + c)`` draws.  The results have a leading chain
    axis, as the JAX package's ``vmap`` of :func:`sample` gives them:
    ``positions`` ``(chains, draws, dim)``, every diagnostic ``(chains,
    draws)``, ``step_size`` ``(chains,)``, ``inverse_mass_matrix``
    ``(chains, dim)`` or ``(chains, dim, dim)``.  For pooled cross-chain
    adaptation use :mod:`aehmc_tpu_torch.parallel`."""
    if initial_positions.ndim != 2:
        raise ValueError(
            "sample_chains needs (chains, dim) initial positions, got shape "
            f"{tuple(initial_positions.shape)}"
        )
    res = sample(rng, logprob_fn, initial_positions, num_samples, num_warmup,
                 **kwargs)
    eps, imm = res.step_size, res.inverse_mass_matrix
    if not (kwargs.get("step_size") is None
            and kwargs.get("inverse_mass_matrix") is None and num_warmup > 0):
        # warmup skipped: the chains share the parameters; one copy a chain
        chains = initial_positions.shape[:1]
        eps, imm = (x.expand(chains + x.shape).clone() for x in (eps, imm))
    return SampleResult(
        final_state=res.final_state,
        positions=res.positions.transpose(0, 1),
        diagnostics=type(res.diagnostics)(
            *(d.transpose(0, 1) for d in res.diagnostics)),
        step_size=eps,
        inverse_mass_matrix=imm,
    )
