"""Pooled multi-chain drivers and device meshes of the port
(:mod:`aehmc_tpu.parallel`): chains shard over a :class:`Mesh` of devices
driven by one process."""

from aehmc_tpu_torch.parallel.mesh import (
    Mesh,
    chain_sharding,
    make_mesh,
    make_multislice_mesh,
    replicated,
)
from aehmc_tpu_torch.parallel.pooled import (
    pooled_warmup,
    pooled_warmup_hooks,
    pooled_window_adaptation,
    sample_sharded,
)

__all__ = [
    "Mesh",
    "chain_sharding",
    "make_mesh",
    "make_multislice_mesh",
    "pooled_warmup",
    "pooled_warmup_hooks",
    "pooled_window_adaptation",
    "replicated",
    "sample_sharded",
]
