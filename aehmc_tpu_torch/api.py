"""The front door: ``sample(...)`` (port of :mod:`aehmc_tpu.api`, the route
``algorithm="nuts", path="fused"``).

The fused route runs Stan warmup through the per-transition NUTS kernel and
then the whole sampling phase through the whole-run kernel (one launch), as
the JAX package's benchmark does; the two sampling paths are bitwise equal by
construction.  Every other algorithm and path raises ``NotImplementedError``
naming its ROADMAP.md item.
"""

from typing import Callable, Optional, Sequence

import torch

from aehmc_tpu_torch.ops.fused_driver import sample_fused_adaptive
from aehmc_tpu_torch.sampling import SampleResult
from aehmc_tpu_torch.types import Diagnostics

ALGORITHMS = ("nuts", "hmc", "chees", "meads", "ghmc", "mala")
PATHS = ("auto", "xla", "pooled", "fused")


def _fused_nuts_result(out) -> SampleResult:
    """The fused driver's return as a ``SampleResult``: stats columns
    ``[energy, accept, doublings, leaves, diverging, turning]`` are the
    fields of ``Diagnostics``."""
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
    ``potential_and_grad_t(q_t, *data) -> (u, g)``; on a CUDA device the
    kernels take ``models.logistic_pg_t``.  ``kwargs`` go to
    :func:`aehmc_tpu_torch.ops.fused_driver.sample_fused_adaptive`
    (``max_num_expansions`` defaults to 6, ``loop_in_kernel`` to True).

    Returns a ``SampleResult`` with ``positions`` ``(draws, chains, dim)``.
    """
    if algorithm not in ALGORITHMS:
        raise ValueError(f"algorithm must be one of {ALGORITHMS}, got {algorithm!r}")
    if path not in PATHS:
        raise ValueError(f"path must be one of {PATHS}, got {path!r}")
    if algorithm != "nuts":
        raise NotImplementedError(
            f"algorithm={algorithm!r} is not ported yet (ROADMAP.md items "
            "1.9-1.11)"
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
