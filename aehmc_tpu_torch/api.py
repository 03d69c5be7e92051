"""The front door: ``sample(...)`` (port of :mod:`aehmc_tpu.api`, the fused
routes of ``algorithm="nuts"``, ``"mala"``, ``"ghmc"`` and ``"chees"``).

The fused NUTS route runs Stan warmup through the per-transition NUTS kernel
and then the whole sampling phase through the whole-run kernel (one launch),
as the JAX package's benchmark does; the two sampling paths are bitwise equal
by construction.  The fused MALA and GHMC routes run warmup through the GHMC
transition kernel and sampling through the GHMC segment kernel, one launch
per ``segment_draws`` draws.  The fused ChEES route runs the pooled ChEES
driver (:func:`aehmc_tpu_torch.parallel.sample_sharded`) over the ChEES
transition kernel, warmup and sampling one launch per step.  Every other
algorithm and path raises ``NotImplementedError`` naming its ROADMAP.md
item.
"""

from typing import Callable, Optional, Sequence

import torch

from aehmc_tpu_torch.ops.chees_fused import make_fused_chees_kernel
from aehmc_tpu_torch.ops.fused_driver import (
    sample_fused_adaptive,
    sample_fused_ghmc,
)
from aehmc_tpu_torch.parallel.pooled import sample_sharded
from aehmc_tpu_torch.sampling import SampleResult
from aehmc_tpu_torch.types import Diagnostics

ALGORITHMS = ("nuts", "hmc", "chees", "meads", "ghmc", "mala")
PATHS = ("auto", "xla", "pooled", "fused")
_FUSED_ALGORITHMS = ("nuts", "mala", "ghmc", "chees")
# keyword arguments of the ChEES route that build its kernel
_CHEES_KERNEL_KWARGS = ("block_chains", "use_internal_prng", "step_size_factors")


def _fused_nuts_result(out) -> SampleResult:
    """The fused driver's return as a ``SampleResult``: stats columns
    ``[energy, accept, doublings, leaves, diverging, turning]`` are the
    fields of ``Diagnostics`` (GHMC's are ``[energy, accept, 0, steps,
    diverging, 0]``: no doublings, never turning)."""
    final_positions, positions, stats, eps, imm = out
    diag = Diagnostics(
        acceptance_probability=stats[..., 1],
        num_doublings=stats[..., 2].to(torch.int32),
        is_turning=stats[..., 5] > 0.5,
        is_diverging=stats[..., 4] > 0.5,
        energy=stats[..., 0],
        num_integration_steps=stats[..., 3].to(torch.int32),
    )
    return SampleResult(
        final_state=final_positions,
        positions=positions,
        diagnostics=diag,
        step_size=eps,
        inverse_mass_matrix=imm,
    )


def sample(
    generator: torch.Generator,
    logprob_fn: Optional[Callable],
    initial_position: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 1000,
    *,
    algorithm: str = "nuts",
    path: str = "auto",
    data: Sequence[torch.Tensor] = (),
    potential_fn_t: Optional[Callable] = None,
    potential_and_grad_t: Optional[Callable] = None,
    **kwargs,
) -> SampleResult:
    """Warmup + sampling in one call.

    ``generator`` (a ``torch.Generator``) is the only source of randomness:
    the same generator state reproduces the run bit for bit.
    ``initial_position`` is ``(chains, dim)``; the chains run on its device
    (the data tensors must be on the same device).  The model is the
    transposed ``potential_fn_t(q_t, *data)`` and/or
    ``potential_and_grad_t(q_t, *data) -> (u, g)``.  On a CUDA device the
    fused NUTS route runs three models, each a device functor in kernels 1
    and 2, picked by the identity of ``potential_and_grad_t``:
    ``models.logistic_pg_t`` (``models.logistic_regression_pg_t``),
    ``models.funnel_pg_t`` (``models.neals_funnel_pg_t``) and
    ``models.schools_pg_t`` (``models.eight_schools_pg_t``); the MALA, GHMC
    and ChEES routes take the logistic one.  Any other potential on the card
    raises ``NotImplementedError`` (the generic path is ROADMAP.md item
    1.10).  ``kwargs`` go to
    :func:`aehmc_tpu_torch.ops.fused_driver.sample_fused_adaptive` for NUTS
    (``max_num_expansions`` defaults to 6, ``loop_in_kernel`` to True) and to
    :func:`aehmc_tpu_torch.ops.fused_driver.sample_fused_ghmc` for MALA and
    GHMC (``ghmc_alpha``, the GHMC momentum persistence, defaults to 0.9).
    ChEES needs ``logprob_fn`` (one position ``(dim,)`` -> log-density) to
    start its chain states; ``block_chains``, ``use_internal_prng``,
    ``step_size_factors`` and ``divergence_threshold`` build its kernel
    (:func:`aehmc_tpu_torch.ops.chees_fused.make_fused_chees_kernel`), the
    others go to :func:`aehmc_tpu_torch.parallel.sample_sharded`
    (``initial_step_size`` 1.0 and ``search_initial_step_size`` True by
    default); its ``generator`` may be a key source ``(phase, index) ->
    key`` that replays given randomness.

    Returns a ``SampleResult`` with ``positions`` ``(draws, chains, dim)``.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if algorithm not in _FUSED_ALGORITHMS:
        raise NotImplementedError(
            f"algorithm={algorithm!r} is not ported yet (ROADMAP.md items "
            "1.9-1.11)"
        )
    if algorithm == "chees" and logprob_fn is None:
        raise ValueError(
            "logprob_fn may be None only on the fused NUTS/MALA/GHMC routes "
            "with an explicit potential_fn_t/potential_and_grad_t binding: "
            "ChEES starts its chain states from logprob_fn"
        )
    if path in ("xla", "pooled"):
        raise NotImplementedError(
            f"path={path!r} is not ported yet (ROADMAP.md items 1.9-1.10)"
        )
    if potential_fn_t is None and potential_and_grad_t is None:
        raise NotImplementedError(
            "a bare logprob_fn (no potential_fn_t / potential_and_grad_t) "
            "needs the XLA or pooled path, not ported yet (ROADMAP.md items "
            "1.9-1.10)"
        )
    if initial_position.ndim != 2:
        raise ValueError(
            "the fused path needs a (chains, dim) initial_position, got shape "
            f"{tuple(initial_position.shape)}"
        )
    if algorithm == "chees":
        kernel_kwargs = {k: kwargs.pop(k) for k in _CHEES_KERNEL_KWARGS
                         if k in kwargs}
        if "divergence_threshold" in kwargs:
            # the threshold parameterizes both the kernel and the driver
            kernel_kwargs["divergence_threshold"] = kwargs[
                "divergence_threshold"]
        kernel_fn = make_fused_chees_kernel(
            potential_fn_t, tuple(data),
            potential_and_grad_t=potential_and_grad_t, **kernel_kwargs,
        )
        return sample_sharded(
            generator, logprob_fn, initial_position.to(torch.float32),
            num_samples, num_warmup, algorithm="chees",
            chees_kernel_fn=kernel_fn, **kwargs,
        )
    if algorithm in ("mala", "ghmc"):
        if algorithm == "mala":
            if "ghmc_alpha" in kwargs:
                raise TypeError(
                    "ghmc_alpha= with algorithm='mala' (MALA IS alpha=0); "
                    "use algorithm='ghmc' for persistent momentum"
                )
            alpha = 0.0
        else:
            alpha = kwargs.pop("ghmc_alpha", 0.9)
        out = sample_fused_ghmc(
            generator,
            potential_fn_t,
            tuple(data),
            initial_position.to(torch.float32),
            num_samples,
            num_warmup,
            alpha=alpha,
            potential_and_grad_t=potential_and_grad_t,
            **kwargs,
        )
        return _fused_nuts_result(out)
    kwargs.setdefault("max_num_expansions", 6)
    kwargs.setdefault("loop_in_kernel", True)
    out = sample_fused_adaptive(
        generator,
        logprob_fn,
        tuple(data),
        initial_position.to(torch.float32),
        num_samples,
        num_warmup,
        potential_fn_t=potential_fn_t,
        potential_and_grad_t=potential_and_grad_t,
        **kwargs,
    )
    return _fused_nuts_result(out)
