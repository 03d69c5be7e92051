"""aehmc_tpu_torch: the PyTorch / CUDA port of :mod:`aehmc_tpu`.

The first slice of the port: the flagship fused-NUTS path (Stan window
adaptation driving a per-transition NUTS kernel, then the whole sampling run
in one kernel launch) on the logistic-regression posterior, with both NUTS
kernels hand-written in CUDA for the H100 (``csrc/``) and a plain PyTorch
version of each beside it.  This package imports no JAX.
"""

from aehmc_tpu_torch import diagnostics
from aehmc_tpu_torch.api import sample
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
    "diagnostics",
    "sample",
]
