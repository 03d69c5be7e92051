"""Pooled warmup and sampling of a chain batch (port of the
``algorithm="chees"`` branch of :func:`aehmc_tpu.parallel.pooled.sample_sharded`,
without checkpoints).

The other algorithms of the JAX driver (NUTS, HMC, MALA, GHMC and MEADS on
the XLA kernels) and checkpoint/resume are ROADMAP.md item 1.10; a mesh is
item 1.12.
"""

from typing import Callable, Optional

import torch
from torch.func import vmap

from aehmc_tpu_torch import chees, hmc
from aehmc_tpu_torch.sampling import SampleResult
from aehmc_tpu_torch.types import Diagnostics


def _chees_diagnostics(info: chees.CheesSampleInfo) -> Diagnostics:
    """``CheesSampleInfo`` as ``Diagnostics``, every field (draws, chains):
    ChEES has no tree, so doublings are 0 and no chain is turning; the
    shared trip count is broadcast over the chains."""
    accept = info.acceptance_probability
    return Diagnostics(
        acceptance_probability=accept,
        num_doublings=torch.zeros(accept.shape, dtype=torch.int32,
                                  device=accept.device),
        is_turning=torch.zeros(accept.shape, dtype=torch.bool,
                               device=accept.device),
        is_diverging=info.is_diverging,
        energy=info.energy,
        num_integration_steps=info.num_integration_steps.to(torch.int32)[
            :, None].expand(accept.shape),
    )


def sample_sharded(
    generator,
    logprob_fn: Callable,
    initial_positions: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 400,
    *,
    algorithm: str = "nuts",
    divergence_threshold: float = 1000.0,
    initial_step_size: float = 1.0,
    search_initial_step_size: bool = True,
    per_chain_step_size: bool = False,
    mesh=None,
    collect_positions: bool = True,
    chees_kernel_fn: Callable = None,
    checkpoint_every: int = 0,
    checkpoint_path: Optional[str] = None,
    resume: bool = False,
) -> SampleResult:
    """Pooled warmup and sampling of ``initial_positions (chains, dim)``.

    ``algorithm="chees"``: the chain states come from ``logprob_fn`` (one
    position ``(dim,)`` -> log-density) by :func:`aehmc_tpu_torch.hmc.new_state`
    mapped over the chains, then :func:`aehmc_tpu_torch.chees.warmup`
    (``max(num_warmup, 1)`` steps, target acceptance 0.651) and
    :func:`aehmc_tpu_torch.chees.sample` run ``chees_kernel_fn`` (e.g.
    :func:`aehmc_tpu_torch.ops.chees_fused.make_fused_chees_kernel`).  The
    options of the JAX driver's other algorithms are not taken.
    ``generator`` is a ``torch.Generator`` or a key source ``(phase, index)
    -> key`` (:mod:`aehmc_tpu_torch.chees`).

    Returns a ``SampleResult`` whose ``final_state`` is the ``ChainState``,
    ``positions`` ``(draws, chains, dim)`` and ``diagnostics`` every field
    ``(draws, chains)``.
    """
    if per_chain_step_size and algorithm in ("meads", "chees"):
        raise ValueError(
            f"per_chain_step_size is not supported with algorithm="
            f"{algorithm!r} (MEADS/ChEES manage their own step-size "
            "adaptation)"
        )
    if algorithm != "chees":
        raise NotImplementedError(
            f"sample_sharded(algorithm={algorithm!r}) is not ported yet "
            "(ROADMAP.md item 1.10); the port's pooled driver runs ChEES"
        )
    if checkpoint_every or resume:
        raise NotImplementedError(
            "checkpoint_every / resume are not ported yet (ROADMAP.md item "
            "1.10)")
    if mesh is not None:
        raise NotImplementedError("mesh= is not ported yet (ROADMAP.md item "
                                  "1.12)")
    states = vmap(lambda q: hmc.new_state(q, logprob_fn))(initial_positions)
    result = chees.warmup(
        generator, logprob_fn, states, num_steps=max(num_warmup, 1),
        initial_step_size=initial_step_size,
        divergence_threshold=divergence_threshold,
        search_initial_step_size=search_initial_step_size,
        kernel_fn=chees_kernel_fn,
    )
    final_states, positions, info = chees.sample(
        generator, logprob_fn, result.states, num_samples, result.step_size,
        result.trajectory_length, result.inverse_mass_matrix,
        divergence_threshold=divergence_threshold,
        collect_positions=collect_positions, kernel_fn=chees_kernel_fn,
    )
    return SampleResult(
        final_state=final_states,
        positions=positions,
        diagnostics=_chees_diagnostics(info),
        step_size=result.step_size,
        inverse_mass_matrix=result.inverse_mass_matrix,
    )
