"""Convergence diagnostics: split-R-hat, bulk and tail effective sample
size, the Monte Carlo standard error, a posterior summary and the bridge to
arviz.

Port of :mod:`aehmc_tpu.diagnostics` (Vehtari et al. 2021): rank-normalised
split chains, FFT autocovariance (``torch.fft``) and Geyer's initial
monotone sequence.  Inputs are ``(chains, draws)`` or ``(chains, draws,
dim)`` tensors on any device.
"""

import math

import numpy as np
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


def mcse(samples):
    """Monte Carlo standard error of the mean, via ESS: ``(mcse_mean,
    ess)``, the pooled sd (ddof 1) over √(bulk ESS), per dimension."""
    samples = _validate(samples)
    ess = effective_sample_size(samples)
    pooled = samples.reshape((-1,) + samples.shape[2:])
    sd = torch.std(pooled, dim=0, correction=1)
    return sd / torch.sqrt(ess), ess


def summary(samples) -> dict:
    """Per-dimension posterior summary, the columns of arviz's
    ``az.summary``: ``mean, sd, median, q05, q95, ess_bulk, ess_tail,
    r_hat, mcse_mean`` of ``samples (chains, draws[, dim])``.  Both ESS
    columns are capped at chains × draws (antithetic NUTS chains can push
    the raw estimate past it); the raw estimators stay uncapped."""
    samples = _validate(samples)
    pooled = samples.reshape((-1,) + samples.shape[2:])
    mcse_mean, _ = mcse(samples)
    n_total = samples.shape[0] * samples.shape[1]
    return {
        "mean": torch.mean(pooled, dim=0),
        "sd": torch.std(pooled, dim=0, correction=1),
        "median": _quantile(pooled, 0.5),
        "q05": _quantile(pooled, 0.05),
        "q95": _quantile(pooled, 0.95),
        "ess_bulk": torch.clamp(effective_sample_size(samples), max=n_total),
        "ess_tail": torch.clamp(tail_effective_sample_size(samples),
                                max=n_total),
        "r_hat": potential_scale_reduction(samples, rank_normalized=True),
        "mcse_mean": mcse_mean,
    }


def _numpy(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def to_inference_data_dict(positions, diagnostics=None, *, draw_axis: int = 0,
                           param_names=None) -> dict:
    """A sampling result in the ``arviz.from_dict`` layout: numpy arrays in
    arviz's (chain, draw, ...) convention, without depending on arviz::

        idata = az.from_dict(**to_inference_data_dict(res.positions,
                                                      res.diagnostics))

    ``positions`` is (draws, dim), (draws, chains, dim) (``draw_axis=0``,
    the front door's layout) or (chains, draws, dim) (``draw_axis=1``).
    Returns ``{"posterior": {name: (chains, draws)}}`` with names
    ``theta_i`` (``theta`` at dim 1) unless ``param_names`` are given, and
    with ``diagnostics`` (a ``Diagnostics`` stacked over the same axes)
    also ``"sample_stats"``: ``acceptance_rate, diverging, energy,
    tree_depth, n_steps``."""
    pos = _numpy(positions)
    if pos.ndim == 2:  # (draws, dim): one chain
        pos = pos[:, None, :]
        draw_axis = 0
    if draw_axis == 0:
        pos = np.moveaxis(pos, 0, 1)  # -> (chains, draws, dim)
    dim = pos.shape[2]
    if param_names is None:
        param_names = ["theta"] if dim == 1 else [f"theta_{i}"
                                                  for i in range(dim)]
    if len(param_names) == 1 and dim == 1:
        posterior = {param_names[0]: pos[:, :, 0]}
    else:
        posterior = {name: pos[:, :, i] for i, name in enumerate(param_names)}

    out = {"posterior": posterior}
    if diagnostics is not None:
        def chain_draw(x):
            x = _numpy(x)
            if x.ndim == 1:  # (draws,): one chain, or shared per draw
                x = x[:, None]
            return np.moveaxis(x, 0, 1) if draw_axis == 0 else x

        out["sample_stats"] = {
            "acceptance_rate": chain_draw(diagnostics.acceptance_probability),
            "diverging": chain_draw(diagnostics.is_diverging),
            "energy": chain_draw(diagnostics.energy),
            "tree_depth": chain_draw(diagnostics.num_doublings),
            "n_steps": chain_draw(diagnostics.num_integration_steps),
        }
    return out
