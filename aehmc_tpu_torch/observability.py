"""Progress logging, profiler spans, finite guards and the throughput counter
(port of :mod:`aehmc_tpu.observability`).

- :func:`progress_callback` prints the step, the mean acceptance and the
  count of divergent chains every ``every`` steps; it is called from the
  host loops of the drivers, and reads the device only on the steps it
  prints (``progress_every`` of
  :func:`aehmc_tpu_torch.parallel.sample_sharded`,
  :func:`~aehmc_tpu_torch.parallel.pooled_warmup` and
  :func:`aehmc_tpu_torch.ops.sample_fused_adaptive`);
- :func:`annotate` names a phase with ``torch.profiler.record_function``,
  which shows in a profiler trace and as an NVTX range on the card;
- :func:`guard_finite` checks that chain positions are finite (one read of
  the device) and warns when they are not;
- :func:`grad_evals_per_sec` turns the per-transition leapfrog counters
  into gradient evaluations a second.
"""

import sys
import types
from contextlib import contextmanager
from typing import Callable

import torch


def _default_printer(step, acceptance, divergences):
    print(
        f"[aehmc_tpu_torch] step {int(step):>7d}  "
        f"mean acceptance {float(acceptance):.3f}  "
        f"divergent chains {int(divergences)}",
        file=sys.stderr,
        flush=True,
    )


def progress_callback(step: int, info, every: int = 100,
                      printer: Callable = _default_printer) -> None:
    """Print a progress line when ``step % every == 0``.  ``info`` has
    ``acceptance_probability`` and ``is_diverging`` (one chain's
    :class:`~aehmc_tpu_torch.types.Diagnostics` or a batch's, reduced
    here)."""
    if int(step) % every:
        return
    acceptance = torch.mean(torch.as_tensor(info.acceptance_probability,
                                            dtype=torch.float64))
    divergences = torch.sum(torch.as_tensor(info.is_diverging).to(torch.int64))
    printer(step, acceptance, divergences)


def progress_draws(every: int, draws: range, infos) -> None:
    """:func:`progress_callback` for each draw of ``draws`` whose stacked
    ``infos`` (``(draws, chains)`` fields) a loop has already made; the
    device is read only for the printed draws."""
    if not every:
        return
    for i, t in enumerate(draws):
        if t % every == 0:
            progress_callback(t, types.SimpleNamespace(
                acceptance_probability=infos.acceptance_probability[i],
                is_diverging=infos.is_diverging[i]), every=every)


def stats_info(stats: torch.Tensor):
    """The acceptance and divergence of the fused kernels' stats (columns
    ``[energy, accept, ., ., diverging, ...]`` on the last axis), for
    :func:`progress_callback`."""
    return types.SimpleNamespace(acceptance_probability=stats[..., 1],
                                 is_diverging=stats[..., 4] > 0.5)


@contextmanager
def annotate(name: str):
    """A named profiler span (``torch.profiler.record_function``)."""
    with torch.profiler.record_function(name):
        yield


def guard_finite(state_position: torch.Tensor,
                 where: str = "chain state") -> torch.Tensor:
    """Whether every value of ``state_position`` is finite (a bool tensor);
    warns on stderr when one is not.  A divergent proposal is rejected, so
    a non-finite accepted position is a fault."""
    ok = torch.all(torch.isfinite(state_position))
    if not bool(ok):
        _warn_nonfinite(where)
    return ok


def _warn_nonfinite(where: str = "chain state"):
    print(
        f"[aehmc_tpu_torch] WARNING: non-finite values detected in {where}",
        file=sys.stderr,
        flush=True,
    )


def grad_evals_per_sec(infos, elapsed_seconds: float) -> float:
    """The summed leapfrog counters of ``infos`` over ``elapsed_seconds``."""
    total = torch.sum(torch.as_tensor(infos.num_integration_steps,
                                      dtype=torch.float64))
    return float(total) / elapsed_seconds
