"""Convergence diagnostics: split-R-hat, bulk and tail effective sample size.

Port of :mod:`aehmc_tpu.diagnostics` (Vehtari et al. 2021): rank-normalised
split chains, FFT autocovariance (``torch.fft``) and Geyer's initial
monotone sequence.  Inputs are ``(chains, draws)`` or ``(chains, draws,
dim)`` tensors on any device.
"""

import math

import torch


def _validate(samples) -> torch.Tensor:
    samples = torch.as_tensor(samples)
    return samples[None, :] if samples.ndim == 1 else samples


def _split_chains(samples: torch.Tensor) -> torch.Tensor:
    """(C, N, ...) -> (2C, N//2, ...)."""
    half = samples.shape[1] // 2
    return torch.cat([samples[:, :half], samples[:, half:2 * half]], dim=0)


def _rank_normalize(samples: torch.Tensor) -> torch.Tensor:
    """Blom normal scores of the pooled ranks, evaluated on the mirrored rank
    for the upper half (keeps the upper tail off 1.0 in float32)."""
    c, n = samples.shape[:2]
    total = c * n
    flat = samples.reshape((total,) + samples.shape[2:])
    ranks = torch.argsort(torch.argsort(flat, dim=0, stable=True), dim=0,
                          stable=True)
    upper = ranks >= (total + 1) // 2
    mirrored = torch.where(upper, total - 1 - ranks, ranks).to(samples.dtype)
    z = torch.special.ndtri((mirrored + 1.0 - 0.375) / (total + 0.25))
    return torch.where(upper, -z, z).reshape(samples.shape)


def potential_scale_reduction(samples, rank_normalized: bool = False):
    """Split-R-hat per dimension (a scalar for ``(chains, draws)``)."""
    samples = _split_chains(_validate(samples))
    if rank_normalized:
        samples = _rank_normalize(samples)
    num_draws = samples.shape[1]
    chain_means = torch.mean(samples, dim=1)
    chain_vars = torch.var(samples, dim=1, correction=1)
    between = num_draws * torch.var(chain_means, dim=0, correction=1)
    within = torch.mean(chain_vars, dim=0)
    var_plus = ((num_draws - 1) * within + between) / num_draws
    return torch.sqrt(var_plus / within)


def _autocovariance_fft(x: torch.Tensor) -> torch.Tensor:
    """Autocovariance of each chain of ``x (C, N, ...)`` via a zero-padded FFT."""
    n = x.shape[1]
    x = x - torch.mean(x, dim=1, keepdim=True)
    fft = torch.fft.rfft(x, n=2 * n, dim=1)
    acov = torch.fft.irfft(fft * torch.conj(fft), n=2 * n, dim=1)[:, :n]
    return acov / n


def effective_sample_size(samples, rank_normalized: bool = True):
    """Bulk ESS (rank-normalised by default) with Geyer's initial monotone
    sequence."""
    samples = _split_chains(_validate(samples))
    if rank_normalized:
        samples = _rank_normalize(samples)
    num_chains, num_draws = samples.shape[:2]

    acov = _autocovariance_fft(samples)
    chain_var = acov[:, 0] * num_draws / (num_draws - 1.0)
    mean_var = torch.mean(chain_var, dim=0)
    var_plus = mean_var * (num_draws - 1.0) / num_draws
    if num_chains > 1:
        var_plus = var_plus + torch.var(torch.mean(samples, dim=1), dim=0,
                                        correction=1)

    rho = 1.0 - (mean_var - torch.mean(acov, dim=0)) / var_plus
    rho = torch.cat([torch.ones_like(rho[:1]), rho[1:]], dim=0)
    max_pairs = num_draws // 2
    paired = rho[0:2 * max_pairs:2] + rho[1:2 * max_pairs:2]
    keep_positive = torch.cumprod((paired > 0).to(torch.int64), dim=0).bool()
    monotone = torch.cummin(paired, dim=0).values
    contributions = torch.where(keep_positive, monotone, 0.0)
    tau = -1.0 + 2.0 * torch.sum(contributions, dim=0)
    tau = torch.clamp(tau, min=1.0 / math.log10(num_chains * num_draws + 10.0))
    ess = num_chains * num_draws / tau
    # degenerate chains (zero pooled variance) carry no information
    return torch.where(var_plus > 0.0, ess, 0.0)


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile along dim 0 (``jnp.quantile``'s), by
    sorting: no size limit."""
    n = x.shape[0]
    pos = q * (n - 1)
    lo, hi = int(pos // 1), min(int(-(-pos // 1)), n - 1)
    high_weight = pos - lo
    srt = torch.sort(x, dim=0).values
    return srt[lo] * (1.0 - high_weight) + srt[hi] * high_weight


def tail_effective_sample_size(samples):
    """Tail ESS: the smaller ESS of the 5% and 95% quantile indicators."""
    samples = _validate(samples)
    pooled = samples.reshape((-1,) + samples.shape[2:])
    ind05 = (samples <= _quantile(pooled, 0.05)).to(samples.dtype)
    ind95 = (samples <= _quantile(pooled, 0.95)).to(samples.dtype)
    return torch.minimum(
        effective_sample_size(ind05, rank_normalized=False),
        effective_sample_size(ind95, rank_normalized=False),
    )
