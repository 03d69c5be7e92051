"""Fused kernels of the port: plain PyTorch versions beside the CUDA kernels
(``aehmc_tpu_torch/csrc``) that replace the TPU's Pallas kernels."""

from aehmc_tpu_torch.ops.chees_fused import (
    make_fused_chees_kernel,
    make_fused_chees_transition,
    sample_fused_chees_adaptive,
)
from aehmc_tpu_torch.ops.fused_driver import (
    sample_fused_adaptive,
    sample_fused_ghmc,
    sample_fused_mala,
)
from aehmc_tpu_torch.ops.fused_hmc import (
    fused_logistic_hmc,
    fused_logistic_hmc_reference,
    logistic_integrate_fn,
)
from aehmc_tpu_torch.ops.ghmc_fused import (
    fused_ghmc_segment,
    make_fused_ghmc_transition,
    make_fused_meads_segment,
    make_fused_meads_transition,
)
from aehmc_tpu_torch.ops.launches import LAUNCHES, reset_launch_counts
from aehmc_tpu_torch.ops.leapfrog import (
    batched_leapfrog,
    batched_leapfrog_reference,
)
from aehmc_tpu_torch.ops.nuts_fused import (
    fused_nuts_transition,
    logistic_potential,
    make_fused_nuts_transition,
    sample_fused,
    sample_fused_logistic,
)
from aehmc_tpu_torch.ops.nuts_fused_small import (
    make_fused_nuts_transition_small,
    sample_fused_small,
)

__all__ = [
    "LAUNCHES",
    "batched_leapfrog",
    "batched_leapfrog_reference",
    "fused_ghmc_segment",
    "fused_logistic_hmc",
    "fused_logistic_hmc_reference",
    "fused_nuts_transition",
    "logistic_integrate_fn",
    "logistic_potential",
    "make_fused_chees_kernel",
    "make_fused_chees_transition",
    "make_fused_ghmc_transition",
    "make_fused_meads_segment",
    "make_fused_meads_transition",
    "make_fused_nuts_transition",
    "make_fused_nuts_transition_small",
    "reset_launch_counts",
    "sample_fused",
    "sample_fused_adaptive",
    "sample_fused_chees_adaptive",
    "sample_fused_ghmc",
    "sample_fused_logistic",
    "sample_fused_mala",
    "sample_fused_small",
]
