"""aehmc_tpu_torch: the PyTorch / CUDA port of :mod:`aehmc_tpu`.

What is ported: the XLA path for any ``logprob_fn`` (the NUTS, HMC, MALA,
GHMC and ChEES kernels of :mod:`nuts`, :mod:`hmc`, :mod:`mala`,
:mod:`ghmc` and :mod:`chees`, MEADS (:mod:`meads`), window adaptation, the
sampling drivers and pooled warmup, through ``sample(..., path="xla" |
"pooled")``), checkpoint/resume of every sampling driver
(:mod:`checkpoint`), progress lines and profiler spans
(:mod:`observability`), the fused
NUTS route (Stan warmup driving a per-transition NUTS kernel, then the
whole sampling run in one kernel launch) on the logistic regression,
Neal's funnel and eight schools, the fused MALA and GHMC routes (warmup
through the GHMC transition kernel, sampling in segments of the GHMC
segment kernel), the fused ChEES route (the ChEES adaptation over the
ChEES transition kernel), the fused MEADS route (the GHMC segment kernel a
re-estimation segment, or the transition kernel a draw when checkpointed),
the standard-layout NUTS entry points of
:mod:`aehmc_tpu_torch.ops.nuts_fused`, the two leapfrog entry points of
:mod:`aehmc_tpu_torch.ops` (``fused_logistic_hmc``, also the XLA ChEES
kernel's trajectory, and ``batched_leapfrog``), and the JAX package's
model builders and diagnostics.  Every kernel is hand-written CUDA for the
H100 (``csrc/``) with a plain PyTorch version beside it.  This package
imports no JAX.
"""

from aehmc_tpu_torch import (
    checkpoint,
    chees,
    diagnostics,
    ghmc,
    hmc,
    keys,
    mala,
    meads,
    metrics,
    nuts,
    observability,
    ops,
    sampling,
    window_adaptation,
)
from aehmc_tpu_torch.api import sample
from aehmc_tpu_torch.ops import (
    batched_leapfrog,
    fused_logistic_hmc,
    sample_fused_ghmc,
    sample_fused_mala,
)
from aehmc_tpu_torch.sampling import SampleResult
from aehmc_tpu_torch.types import (
    ChainState,
    Diagnostics,
    DualAveragingState,
    IntegratorState,
    ProposalState,
    TerminationState,
    WelfordState,
)
from aehmc_tpu_torch.utils import RaveledParamsMap

__all__ = [
    "ChainState",
    "Diagnostics",
    "DualAveragingState",
    "IntegratorState",
    "ProposalState",
    "RaveledParamsMap",
    "SampleResult",
    "TerminationState",
    "WelfordState",
    "batched_leapfrog",
    "checkpoint",
    "chees",
    "diagnostics",
    "fused_logistic_hmc",
    "ghmc",
    "hmc",
    "keys",
    "mala",
    "meads",
    "metrics",
    "nuts",
    "observability",
    "ops",
    "sample",
    "sampling",
    "sample_fused_ghmc",
    "sample_fused_mala",
    "window_adaptation",
]
