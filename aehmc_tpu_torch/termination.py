"""Iterative U-turn termination criterion (port of :mod:`aehmc_tpu.termination`).

The checkpoint indices are closed-form bit operations on the leaf step:
``idx_max = popcount(step >> 1)``, ``num_subtrees = popcount(step ^ (step +
1)) - 1`` (the trailing ones), ``idx_min = idx_max - num_subtrees + 1``.
Checkpoints are written at even steps only; a check at an odd step tests
every subtree that ends there, slots ``idx_min .. idx_max``.

The trajectory loops pass the step as a Python int, the same for every
chain still running, so the write is one slot and the check reads only the
slots in range; a tensor step is read once.  The index range is kept as
Python ints.  The buffers are ``batch +
(K,) + event``: ``(K, dim)`` for one chain, ``(chains, K, dim)`` for a
batch.
"""

from typing import Callable, Tuple

import torch

from aehmc_tpu_torch.types import TerminationState


def _popcount(x):
    """Set bits of a non-negative int or integer tensor."""
    if isinstance(x, int):
        return bin(x).count("1")
    x = x.to(torch.int64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _find_storage_indices(step) -> Tuple:
    """``(idx_min, idx_max)`` of the subtrees that end at leaf ``step``."""
    if not isinstance(step, int):
        step = torch.as_tensor(step, dtype=torch.int32)
    idx_max = _popcount(step >> 1)
    num_subtrees = _popcount(step ^ (step + 1)) - 1
    idx_min = idx_max - num_subtrees + 1
    return idx_min, idx_max


def _slot_axis(buffer: torch.Tensor) -> int:
    """The K axis: 1 in a ``(chains, K, dim)`` batch, else 0."""
    return 1 if buffer.ndim == 3 else 0


def iterative_uturn(is_turning_fn: Callable) -> Tuple[Callable, Callable,
                                                      Callable]:
    """``(new_state, update, is_iterative_turning)``; ``is_turning_fn(p_left,
    p_right, momentum_sum)`` comes from the metric."""

    def new_state(position: torch.Tensor,
                  max_num_doublings: int) -> TerminationState:
        """Zeroed checkpoint buffers."""
        position = torch.as_tensor(position)
        shape = position.shape[:-1] + (max_num_doublings,) + position.shape[-1:]
        return TerminationState(
            momentum_checkpoints=torch.zeros(shape, dtype=position.dtype,
                                             device=position.device),
            momentum_sum_checkpoints=torch.zeros(shape, dtype=position.dtype,
                                                 device=position.device),
            min_index=0,
            max_index=0,
        )

    def update(state: TerminationState, momentum_sum, momentum, step,
               parity: int = None) -> TerminationState:
        """Write the checkpoints at an even step; refresh the index range.
        ``parity`` is the step's parity when the caller knows it (0 or 1),
        as in the JAX package; the write depends on the step alone."""
        step = int(step)
        idx_min, idx_max = _find_storage_indices(step)
        indices = dict(min_index=idx_min, max_index=idx_max)
        if step % 2:
            return state._replace(**indices)
        axis = _slot_axis(state.momentum_checkpoints)
        p_ckpts = state.momentum_checkpoints.clone()
        s_ckpts = state.momentum_sum_checkpoints.clone()
        p_ckpts.select(axis, idx_max).copy_(momentum)
        s_ckpts.select(axis, idx_max).copy_(momentum_sum)
        return TerminationState(p_ckpts, s_ckpts, **indices)

    def is_iterative_turning(state: TerminationState, momentum_sum, momentum,
                             step=None) -> torch.Tensor:
        """Whether any subtree that ends at the current (odd) leaf makes a
        U-turn: slot ``i`` in ``[idx_min, idx_max]`` reconstructs its
        subtree's momentum sum as ``momentum_sum - sum_ckpt[i] + p_ckpt[i]``.
        With ``step`` the range comes from the step, so the check may run on
        the buffers before this step's write (writes happen at even steps,
        checks at odd ones)."""
        if step is None:
            idx_min, idx_max = int(state.min_index), int(state.max_index)
        else:
            idx_min, idx_max = _find_storage_indices(int(step))
        axis = _slot_axis(state.momentum_checkpoints)
        lo, n = max(idx_min, 0), idx_max + 1 - max(idx_min, 0)
        p_ckpts = state.momentum_checkpoints.narrow(axis, lo, max(n, 0))
        s_ckpts = state.momentum_sum_checkpoints.narrow(axis, lo, max(n, 0))
        subtree_sums = momentum_sum.unsqueeze(axis) - s_ckpts + p_ckpts
        turning = is_turning_fn(p_ckpts, momentum.unsqueeze(axis),
                                subtree_sums)
        return torch.any(turning, dim=-1)

    return new_state, update, is_iterative_turning
