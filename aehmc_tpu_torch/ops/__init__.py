"""Fused NUTS kernels of the port: plain PyTorch versions beside the CUDA
kernels (``aehmc_tpu_torch/csrc``) that replace the TPU's Pallas kernels."""

from aehmc_tpu_torch.ops.nuts_fused_small import (
    LAUNCHES,
    make_fused_nuts_transition_small,
    reset_launch_counts,
    sample_fused_small,
)

__all__ = [
    "LAUNCHES",
    "make_fused_nuts_transition_small",
    "reset_launch_counts",
    "sample_fused_small",
]
