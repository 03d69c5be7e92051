"""Keys of the XLA-path kernels: a Philox seed and the chain index it starts at.

The JAX package threads ``jax.random`` keys and splits them; the port's
XLA-path kernels draw their randomness from the Philox streams of
:mod:`aehmc_tpu_torch.ops.philox` instead, so a key is a u32 Philox seed
plus the global index of the first chain it draws for.  The counter carries
the chain index, so a chain's draws do not depend on how many chains run
beside it: chain ``c`` run alone with ``Key(seed, c)`` draws what row ``c``
of a batch drawn with ``Key(seed, 0)`` draws.

A ``torch.Generator`` becomes a key through
:func:`aehmc_tpu_torch.ops.nuts_fused_small.derive_draw_seeds` (one draw of
the generator), an ``int`` is a seed.  :func:`split` derives independent
children by Philox, as ``jax.random.split`` does by threefry.
"""

from typing import List, NamedTuple

import torch

from aehmc_tpu_torch.ops.nuts_fused_small import derive_draw_seeds
from aehmc_tpu_torch.ops.philox import MASK32, ghmc_streams, philox4x32

# the Philox stream of key splits (the transitions use streams 0-4 under the
# key (seed, 0); splits use the key (seed, 1), so the two never share bits)
SPLIT = 5


class Key(NamedTuple):
    seed: int
    chain_offset: int = 0


def as_key(key) -> Key:
    """A :class:`Key` from a key, a ``torch.Generator`` or an ``int``
    seed."""
    if isinstance(key, Key):
        return key
    if isinstance(key, torch.Generator):
        return Key(derive_draw_seeds(key, 1)[0])
    if isinstance(key, int):
        return Key(key & MASK32)
    raise TypeError(
        "a key is an aehmc_tpu_torch.keys.Key, a torch.Generator or an int "
        f"seed, got {type(key).__name__}"
    )


def split(key, num: int = 2) -> List[Key]:
    """``num`` independent child keys of ``key`` (same chain offset)."""
    key = as_key(key)
    idx = torch.arange(num, dtype=torch.int64)
    zero = torch.zeros((), dtype=torch.int64)
    words = philox4x32((idx, zero, zero + SPLIT, zero), (key.seed, 1))[0]
    return [Key(int(w), key.chain_offset) for w in words.tolist()]


def num_chains(position: torch.Tensor) -> int:
    """The chains of a position: a ``(chains, dim)`` batch, else one."""
    return position.shape[0] if position.ndim == 2 else 1


def event_size(position: torch.Tensor) -> int:
    return position.shape[-1] if position.ndim >= 1 else 1


def to_batch(rows: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
    """A transposed stream ``(rows, C)`` in the position's layout: ``(C,
    rows)`` for a batch, ``(rows,)`` for one chain of a vector, ``()`` for
    one scalar chain; in the position's dtype."""
    rows = rows.to(position.dtype)
    if position.ndim == 2:
        return rows.T.contiguous()
    if position.ndim == 1:
        return rows[:, 0]
    return rows[0, 0]


def to_chains(row: torch.Tensor, position: torch.Tensor) -> torch.Tensor:
    """One stream row ``(C,)`` of per-chain values, of the batch shape."""
    row = row.to(position.dtype)
    return row if position.ndim == 2 else row[0]


def normals_and_uniform(key, position: torch.Tensor):
    """``(z, u)``: standard normals of the position's shape and a uniform
    per chain.  ``key`` is an external ``(z, u)`` pair (used as it is), or a
    key whose Philox seed gives :func:`ghmc_streams` (chain ``c`` at counter
    ``chain_offset + c``)."""
    if isinstance(key, tuple) and not isinstance(key, Key):
        z, u = key
        return (torch.as_tensor(z, dtype=position.dtype,
                                device=position.device),
                torch.as_tensor(u, dtype=position.dtype,
                                device=position.device))
    key = as_key(key)
    z, u = ghmc_streams(key.seed, num_chains(position), event_size(position),
                        device=position.device, chain_offset=key.chain_offset)
    return to_batch(z, position), to_chains(u[0], position)
