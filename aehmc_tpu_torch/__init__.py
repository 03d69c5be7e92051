"""aehmc_tpu_torch: the PyTorch / CUDA port of :mod:`aehmc_tpu`.

What is ported: the fused NUTS route (Stan window adaptation driving a
per-transition NUTS kernel, then the whole sampling run in one kernel
launch) on the logistic regression, Neal's funnel and eight schools, the
JAX package's model builders and diagnostics, the fused MALA and GHMC routes (warmup through the GHMC transition
kernel, sampling in segments of the GHMC segment kernel), the fused ChEES
route (the ChEES adaptation over the ChEES transition kernel), the
standard-layout NUTS entry points of :mod:`aehmc_tpu_torch.ops.nuts_fused`,
and the two leapfrog entry points of :mod:`aehmc_tpu_torch.ops`
(``fused_logistic_hmc``, ``batched_leapfrog``).  Every kernel is
hand-written CUDA for the H100 (``csrc/``) with a plain PyTorch version
beside it.  This package imports no JAX.
"""

from aehmc_tpu_torch import diagnostics, ops
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
    WelfordState,
)

__all__ = [
    "ChainState",
    "Diagnostics",
    "DualAveragingState",
    "SampleResult",
    "WelfordState",
    "batched_leapfrog",
    "diagnostics",
    "fused_logistic_hmc",
    "ops",
    "sample",
    "sample_fused_ghmc",
    "sample_fused_mala",
]
