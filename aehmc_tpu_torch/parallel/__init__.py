"""Pooled multi-chain drivers of the port (the ChEES branch of
:func:`aehmc_tpu.parallel.sample_sharded`)."""

from aehmc_tpu_torch.parallel.pooled import sample_sharded

__all__ = ["sample_sharded"]
