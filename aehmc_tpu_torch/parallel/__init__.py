"""Pooled multi-chain drivers of the port (:mod:`aehmc_tpu.parallel` on one
device)."""

from aehmc_tpu_torch.parallel.pooled import (
    pooled_warmup,
    pooled_warmup_hooks,
    pooled_window_adaptation,
    sample_sharded,
)

__all__ = [
    "pooled_warmup",
    "pooled_warmup_hooks",
    "pooled_window_adaptation",
    "sample_sharded",
]
