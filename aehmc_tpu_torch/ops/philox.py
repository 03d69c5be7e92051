"""Philox4x32-10 on int64 tensors that hold unsigned 32-bit values.

The port's counter-based generator: it takes the place of the TPU's
``pltpu.prng_random_bits`` inside the NUTS kernels.  This plain PyTorch
version and the CUDA kernels (``csrc/nuts_fused_small.cu``) compute the same
bits, so the generator's randomness is an ordinary tensor that the plain
transition can be fed.  Known-answer values are Random123's.

Stream layout of one NUTS transition (key = the per-draw seed): chain ``c``
uses counter ``(c, index, stream, 0)``, where ``stream`` is
:data:`MOMENTUM` (index = group of four normals), :data:`DIRECTION`
(index = doubling), :data:`BIAS` (index = doubling) or :data:`LEAF`
(index = ``2**d - 1 + i``, the row of the external ``u_leaf`` stream).
"""

import math

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

MOMENTUM, DIRECTION, BIAS, LEAF = 0, 1, 2, 3


def _mulhilo(m: int, b: torch.Tensor):
    """``(hi, lo)`` 32-bit halves of ``m * b`` without int64 overflow."""
    t1 = m * (b & 0xFFFF)
    t2 = m * (b >> 16)
    s = t1 + ((t2 & 0xFFFF) << 16)
    return (t2 >> 16) + (s >> 32), s & MASK32


def philox4x32(counter, key):
    """Philox4x32-10.  ``counter`` is four int64 tensors (broadcastable) and
    ``key`` two ints or tensors, all holding u32 values; returns four int64
    tensors of u32 output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for r in range(10):
        if r:
            k0 = (k0 + _W0) & MASK32
            k1 = (k1 + _W1) & MASK32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """u32 words -> float32 uniforms in (0, 1]: the top 24 bits plus one,
    times 2^-24 (the JAX package's ``_uniform_from_bits``)."""
    return ((bits >> 8) + 1).to(torch.float32) * (1.0 / 16777216.0)


def nuts_streams(seed: int, num_chains: int, dim: int, max_exp: int,
                 device=None, chain_offset: int = 0):
    """The Philox-filled randomness of one NUTS transition, transposed:
    ``z (dim, C)`` standard normals, ``dirs (K, C)`` of ±1, ``u_bias (K, C)``
    and ``u_leaf (2**K, C)`` uniforms in (0, 1].  ``seed`` is the u32 key."""
    chains = torch.arange(chain_offset, chain_offset + num_chains,
                          dtype=torch.int64, device=device)
    key = (int(seed) & MASK32, 0)

    def words(stream, rows):
        idx = torch.arange(rows, dtype=torch.int64, device=device)[:, None]
        zero = torch.zeros((), dtype=torch.int64, device=device)
        return philox4x32((chains[None, :], idx, zero + stream, zero), key)

    groups = -(-dim // 4)
    w0, w1, w2, w3 = (uniform_from_bits(w) for w in words(MOMENTUM, groups))
    two_pi = 2.0 * math.pi
    r0, a0 = torch.sqrt(-2.0 * torch.log(w0)), two_pi * w1
    r1, a1 = torch.sqrt(-2.0 * torch.log(w2)), two_pi * w3
    z = torch.stack(
        [r0 * torch.cos(a0), r0 * torch.sin(a0),
         r1 * torch.cos(a1), r1 * torch.sin(a1)], dim=1,
    ).reshape(4 * groups, num_chains)[:dim]
    u_dir = uniform_from_bits(words(DIRECTION, max_exp)[0])
    dirs = torch.where(u_dir < 0.5, -1.0, 1.0).to(torch.float32)
    u_bias = uniform_from_bits(words(BIAS, max_exp)[0])
    u_leaf = uniform_from_bits(words(LEAF, 2**max_exp)[0])
    return z, dirs, u_bias, u_leaf
