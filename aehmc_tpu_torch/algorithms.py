"""Dual averaging, Welford (co)variance and the fixed-tree pooled sums.

Port of :mod:`aehmc_tpu.algorithms`.  The pooled reductions keep the JAX
package's fixed binary-tree order (:func:`pairwise_sum`): the summation order
depends on the logical length only, which is what pooling across several
cards will rely on.
"""

import math
from typing import Callable, Tuple

import torch

from aehmc_tpu_torch.config import DualAveragingConfig
from aehmc_tpu_torch.types import DualAveragingState, WelfordState

_DA = DualAveragingConfig()


def dual_averaging(
    gamma: float = _DA.gamma, t0: int = _DA.t0, kappa: float = _DA.kappa
) -> Tuple[Callable, Callable]:
    """Nesterov's dual averaging with Hoffman-Gelman stabilisation.

    ``init(mu)`` starts the iterates at 0 with shrinkage point ``mu``;
    ``update(gradient, state)`` is one step of
    ``g_avg <- (1-eta) g_avg + eta g``, ``x <- mu - sqrt(step)/gamma g_avg``,
    ``x_avg <- step^-kappa x + (1 - step^-kappa) x_avg``.
    """

    def init(mu: torch.Tensor) -> DualAveragingState:
        mu = torch.as_tensor(mu)
        zero = torch.zeros((), dtype=mu.dtype, device=mu.device)
        return DualAveragingState(
            step=torch.ones((), dtype=torch.int32, device=mu.device),
            iterates=zero,
            iterates_avg=zero,
            gradient_avg=zero,
            shrinkage_pts=mu,
        )

    def update(gradient, state: DualAveragingState) -> DualAveragingState:
        dtype = state.iterates.dtype
        step = state.step.to(dtype)
        eta = 1.0 / (step + t0)
        new_gradient_avg = (1.0 - eta) * state.gradient_avg + eta * gradient
        new_x = state.shrinkage_pts - (torch.sqrt(step) / gamma) * new_gradient_avg
        x_eta = step ** (-kappa)
        new_x_avg = x_eta * state.iterates + (1.0 - x_eta) * state.iterates_avg
        return state._replace(
            step=state.step + 1,
            iterates=new_x.to(dtype),
            iterates_avg=new_x_avg.to(dtype),
            gradient_avg=new_gradient_avg.to(dtype),
        )

    return init, update


def welford_covariance(
    compute_covariance: bool,
) -> Tuple[Callable, Callable, Callable]:
    """Welford's online variance (``(d,)``) or covariance (``(d, d)``);
    with ``batch_shape`` one estimate per chain, ``batch_shape + (d,)`` or
    ``batch_shape + (d, d)``, updated by a ``batch_shape + (d,)`` value."""

    def init(n_dims: int, dtype=torch.float32, device=None,
             batch_shape=()) -> WelfordState:
        sample_size = torch.zeros((), dtype=torch.int32, device=device)
        batch_shape = tuple(batch_shape)
        if n_dims == 0:
            zero = torch.zeros(batch_shape, dtype=dtype, device=device)
            return WelfordState(mean=zero, m2=zero, sample_size=sample_size)
        mean = torch.zeros(batch_shape + (n_dims,), dtype=dtype, device=device)
        shape = (n_dims, n_dims) if compute_covariance else (n_dims,)
        m2 = torch.zeros(batch_shape + shape, dtype=dtype, device=device)
        return WelfordState(mean=mean, m2=m2, sample_size=sample_size)

    def update(value: torch.Tensor, state: WelfordState) -> WelfordState:
        sample_size = state.sample_size + 1
        delta = value - state.mean
        mean = state.mean + delta / sample_size.to(delta.dtype)
        updated_delta = value - mean
        if compute_covariance and mean.ndim > 0:
            # the outer product of each chain's pair
            m2 = state.m2 + updated_delta[..., :, None] * delta[..., None, :]
        else:
            m2 = state.m2 + updated_delta * delta
        return WelfordState(mean=mean, m2=m2, sample_size=sample_size)

    def final(state: WelfordState) -> torch.Tensor:
        denominator = torch.clamp(state.sample_size - 1, min=1)
        return state.m2 / denominator.to(state.m2.dtype)

    return init, update, final


def welford_merge(
    compute_covariance: bool,
) -> Callable[[WelfordState, WelfordState], WelfordState]:
    """Chan-et-al. parallel merge of two Welford states."""

    def merge(a: WelfordState, b: WelfordState) -> WelfordState:
        dtype = a.mean.dtype
        n = a.sample_size + b.sample_size
        n_f = torch.clamp(n, min=1).to(dtype)
        delta = b.mean - a.mean
        w_b = b.sample_size.to(dtype) / n_f
        mean = a.mean + delta * w_b
        cross = a.sample_size.to(dtype) * w_b
        if compute_covariance and a.mean.ndim > 0:
            m2 = a.m2 + b.m2 + cross * torch.outer(delta, delta)
        else:
            m2 = a.m2 + b.m2 + cross * delta * delta
        return WelfordState(mean=mean, m2=m2, sample_size=n)

    return merge


def pairwise_sum(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Sum along ``axis`` in a FIXED binary-tree order.

    Each level adds the even and odd halves of the (zero-padded to a power
    of two) axis, so the rounding is a function of the logical length only.
    """
    x = torch.movedim(x, axis, 0)
    n = x.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    if size != n:
        pad = torch.zeros((size - n,) + x.shape[1:], dtype=x.dtype,
                          device=x.device)
        x = torch.cat([x, pad], dim=0)
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def pairwise_mean(x: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Mean along ``axis`` via :func:`pairwise_sum`."""
    # a Python divisor: a tensor from the host would wait for the stream
    return pairwise_sum(x, axis) / x.shape[axis]


def _pairwise_outer_sum(centered: torch.Tensor,
                        max_chunks: int = 128) -> torch.Tensor:
    """``centered.T @ centered``: fixed-size chunk Gram matrices combined in
    the fixed pairwise tree.  ``centered`` is ``(n, dim)``, or ``(..., n,
    dim)`` with leading batch axes (one Gram matrix each)."""
    *batch, n, dim = centered.shape
    num_chunks = math.gcd(n, max_chunks)
    blocks = centered.reshape(*batch, num_chunks, n // num_chunks, dim)
    partial = torch.einsum("...bci,...bcj->...bij", blocks, blocks)
    return pairwise_sum(partial, axis=-3)


def welford_update_batch(
    compute_covariance: bool,
) -> Callable[[torch.Tensor, WelfordState], WelfordState]:
    """Fold a batch of values (one position per chain, ``(chains, dim)``)
    into a Welford state: the batch's own moments, then
    :func:`welford_merge`."""
    merge = welford_merge(compute_covariance)

    def update_batch(values: torch.Tensor, state: WelfordState) -> WelfordState:
        values = torch.atleast_1d(values)
        batch_mean = pairwise_mean(values, axis=0)
        centered = values - batch_mean
        if compute_covariance and state.mean.ndim > 0:
            batch_m2 = _pairwise_outer_sum(centered)
        else:
            batch_m2 = pairwise_sum(centered * centered, axis=0)
        batch_state = WelfordState(
            mean=batch_mean.to(state.mean.dtype),
            m2=batch_m2.to(state.m2.dtype),
            sample_size=torch.full((), values.shape[0],
                                   dtype=state.sample_size.dtype,
                                   device=values.device),
        )
        return merge(state, batch_state)

    return update_batch
