"""Helpers of the fused NUTS kernels shared by both layouts (port of the
helper part of :mod:`aehmc_tpu.ops.nuts_fused`).

The standard-layout kernels of that module (kernels 3 and 4 of the port's
table) are not ported yet: ROADMAP.md, section 2.
"""

import torch

from aehmc_tpu_torch.ops.philox import MASK32, uniform_from_bits

NEG_INF = -1e30  # finite stand-in for -inf in log-weights

# Stream of draw t = base + t * DRAW_SEED_STRIDE (mod 2^32).  The JAX
# package also offsets each chain block by BLOCK_SEED_STRIDE; the port's
# Philox counter carries the global chain index instead, so per-chain
# results do not depend on the block size.
DRAW_SEED_STRIDE = 104729


def derive_draw_seeds(generator: torch.Generator, num_draws: int) -> list:
    """Per-draw Philox keys: one random base from ``generator`` plus the
    fixed per-draw stride, as Python ints in [0, 2^32)."""
    base = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                             device=generator.device))
    return [(base + t * DRAW_SEED_STRIDE) & MASK32 for t in range(num_draws)]


def _popcount_scalar(x: int) -> int:
    return bin(int(x)).count("1")


def _trailing_ones_scalar(x: int) -> int:
    # popcount(x ^ (x+1)) - 1
    return _popcount_scalar(x ^ (x + 1)) - 1


# u32 words (int64 tensor) -> float32 uniforms in (0, 1]
_uniform_from_bits = uniform_from_bits
