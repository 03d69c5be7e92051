"""Philox4x32-10 on int64 tensors that hold unsigned 32-bit values.

The port's counter-based generator: it takes the place of the TPU's
``pltpu.prng_random_bits`` inside the NUTS and GHMC kernels.  This plain
PyTorch version and the CUDA kernels (``csrc/common.cuh``) compute the same
bits, so the generator's randomness is an ordinary tensor that the plain
transition can be fed.  Known-answer values are Random123's.

Stream layout of one transition (key = the per-draw seed): chain ``c``
uses counter ``(c, index, stream, 0)``, where ``stream`` is
:data:`MOMENTUM` (index = group of four Box-Muller normals),
:data:`DIRECTION` (index = doubling), :data:`BIAS` (index = doubling),
:data:`LEAF` (index = ``2**d - 1 + i``, the row of the external ``u_leaf``
stream) or :data:`ACCEPT` (index 0, GHMC's Metropolis-Hastings uniform).
"""

import math

import torch

MASK32 = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85

MOMENTUM, DIRECTION, BIAS, LEAF, ACCEPT = 0, 1, 2, 3, 4


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


def _stream_words(seed, num_chains, device, chain_offset, parts):
    """The four output words of counters ``(chain, start..start+rows-1,
    stream, 0)`` for each part ``(stream, start, rows)``, each word ``(rows,
    C)``, from one Philox call over the parts' rows."""
    chains = torch.arange(chain_offset, chain_offset + num_chains,
                          dtype=torch.int64, device=device)
    # built on the device: a copy from the host would wait for the stream
    idx = torch.cat([torch.arange(start, start + rows, dtype=torch.int64,
                                  device=device)
                     for _, start, rows in parts])
    stream = torch.cat([torch.full((rows,), stream, dtype=torch.int64,
                                   device=device)
                        for stream, _, rows in parts])
    zero = torch.zeros((), dtype=torch.int64, device=device)
    words = philox4x32((chains[None, :], idx[:, None], stream[:, None], zero),
                       (int(seed) & MASK32, 0))
    sizes = [rows for _, _, rows in parts]
    return list(zip(*(torch.split(w, sizes) for w in words)))


def _normals(momentum_words, dim, num_chains):
    """``(dim, C)`` standard normals from the words of the :data:`MOMENTUM`
    stream's ``ceil(dim / 4)`` rows: group ``j`` of four is two Box-Muller
    pairs from one counter."""
    groups = -(-dim // 4)
    w0, w1, w2, w3 = (uniform_from_bits(w) for w in momentum_words)
    two_pi = 2.0 * math.pi
    r0, a0 = torch.sqrt(-2.0 * torch.log(w0)), two_pi * w1
    r1, a1 = torch.sqrt(-2.0 * torch.log(w2)), two_pi * w3
    return torch.stack(
        [r0 * torch.cos(a0), r0 * torch.sin(a0),
         r1 * torch.cos(a1), r1 * torch.sin(a1)], dim=1,
    ).reshape(4 * groups, num_chains)[:dim]


def nuts_streams(seed: int, num_chains: int, dim: int, max_exp: int,
                 device=None, chain_offset: int = 0, leaf_rows: int = None):
    """The Philox-filled randomness of one NUTS transition, transposed:
    ``z (dim, C)`` standard normals, ``dirs (K, C)`` of ±1, ``u_bias (K, C)``
    and ``u_leaf (2**K, C)`` uniforms in (0, 1], from one Philox call.
    ``leaf_rows`` draws only the first rows of ``u_leaf`` (the others come
    from :func:`leaf_uniforms`).  ``seed`` is the u32 key."""
    leaf_rows = 2**max_exp if leaf_rows is None else leaf_rows
    momentum, direction, bias, leaf = _stream_words(
        seed, num_chains, device, chain_offset,
        [(MOMENTUM, 0, -(-dim // 4)), (DIRECTION, 0, max_exp),
         (BIAS, 0, max_exp), (LEAF, 0, leaf_rows)])
    z = _normals(momentum, dim, num_chains)
    u_dir = uniform_from_bits(direction[0])
    dirs = torch.where(u_dir < 0.5, -1.0, 1.0).to(torch.float32)
    return z, dirs, uniform_from_bits(bias[0]), uniform_from_bits(leaf[0])


def leaf_uniforms(seed: int, num_chains: int, start: int, rows: int,
                  device=None, chain_offset: int = 0) -> torch.Tensor:
    """Rows ``start .. start + rows - 1`` of the :data:`LEAF` stream, ``(rows,
    C)``: the same uniforms as those rows of :func:`nuts_streams`'s
    ``u_leaf``."""
    (leaf,) = _stream_words(seed, num_chains, device, chain_offset,
                            [(LEAF, start, rows)])
    return uniform_from_bits(leaf[0])


def ghmc_streams(seed: int, num_chains: int, dim: int, device=None,
                 chain_offset: int = 0):
    """The Philox-filled randomness of one GHMC transition, transposed:
    ``z (dim, C)`` standard normals (the refresh noise is ``√(1/M⁻¹)·z``)
    and ``u_accept (1, C)``, the Metropolis-Hastings uniform in (0, 1],
    from one Philox call.  ``seed`` is the u32 key."""
    momentum, accept = _stream_words(
        seed, num_chains, device, chain_offset,
        [(MOMENTUM, 0, -(-dim // 4)), (ACCEPT, 0, 1)])
    return _normals(momentum, dim, num_chains), uniform_from_bits(accept[0])
