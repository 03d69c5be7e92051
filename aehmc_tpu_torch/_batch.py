"""Chain batches of the XLA-path kernels.

The JAX kernels are per-chain functions that ``vmap`` batches; the port's
take states with an optional leading chain axis instead.  A position of at
most one dimension is one chain, a ``(chains, dim)`` position a batch.
Per-chain scalars (energies, step sizes, masks) have the batch shape,
``()`` or ``(chains,)``.
"""

from typing import Callable

import torch
from torch.func import functionalize, grad_and_value, vmap

from aehmc_tpu_torch.metrics import PerChain


def expand(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` of the batch shape, with trailing unit axes to broadcast
    against ``like``."""
    x = torch.as_tensor(x)
    return x.reshape(x.shape + (1,) * (like.ndim - x.ndim))


def like(x, position: torch.Tensor) -> torch.Tensor:
    """``x`` as a tensor of the position's dtype and device; a Python
    number is filled on the device (a copy from the host would wait for the
    stream).  A :class:`~aehmc_tpu_torch.metrics.PerChain` stays one."""
    if isinstance(x, PerChain):
        return PerChain(like(x.inverse_mass_matrix, position))
    kw = dict(dtype=position.dtype, device=position.device)
    if isinstance(x, (int, float)):
        return torch.full((), x, **kw)
    return torch.as_tensor(x, **kw)


def where(mask: torch.Tensor, new, old):
    """Select ``new`` where ``mask`` (batch shape) is set, else ``old``, in
    every tensor of two tuples of one structure: the lane freeze of JAX's
    batched while loop."""
    if isinstance(new, tuple):
        values = [where(mask, n, o) for n, o in zip(new, old)]
        return type(new)(*values) if hasattr(new, "_fields") else tuple(values)
    return torch.where(expand(mask, new), new, old)


def value_and_grad(potential_fn: Callable) -> Callable:
    """``q -> (U(q), ∇U(q))`` of one position, or of each row of a ``(chains,
    dim)`` batch by ``torch.func.vmap`` of the functionalized potential, so
    that a potential may write in place into a tensor it makes (``ll =
    torch.zeros(n); ll[mask] = ...``), which vmap alone refuses."""
    one = grad_and_value(potential_fn)
    batched = vmap(grad_and_value(functionalize(potential_fn)))

    def vag(q):
        g, u = (batched if q.ndim == 2 else one)(q)
        return u, g

    return vag


def stack(items):
    """Stack a list of tuples of one structure field by field along a new
    leading axis (the stacked outputs of ``lax.scan``)."""
    first = items[0]
    if isinstance(first, tuple):
        values = [stack([item[i] for item in items])
                  for i in range(len(first))]
        return (type(first)(*values) if hasattr(first, "_fields")
                else tuple(values))
    return torch.stack([torch.as_tensor(x) for x in items])
