"""MEADS: Maximum-Eigenvalue Adaptation of Damping and Step size (port of
:mod:`aehmc_tpu.meads`, Hoffman & Sountsov 2022).

Tuning-free generalized HMC over a chain fleet split into ``num_folds``
folds.  Fold ``k``'s hyperparameters come from the current states of fold
``k-1``:

- the diagonal preconditioner ``σ_d``, the cross-chain standard deviation
  of position component ``d`` (the GHMC inverse mass matrix is ``σ²``);
- the step size ``ε = 0.5 / √λmax(E[(σ∇U)(σ∇U)ᵀ])``;
- the damping ``γ = ε / √max(λmax(cov(q / σ)), 1)`` and the momentum
  retention ``α = exp(-2γ)``.

A fold's parameters never depend on its own state, so every transition is
a valid Markov kernel and adaptation runs through burn-in and sampling
alike.  Largest eigenvalues come from 16 power iterations from the all-ones
start; every reduction over chains is the fixed-tree
:func:`~aehmc_tpu_torch.algorithms.pairwise_sum`.

Chain states are batched ``(chains, dim)``; the estimation is batched over
the fold axis.  Randomness: ``rng`` is a key of :mod:`aehmc_tpu_torch.keys`
(a ``Key``, a ``torch.Generator`` or an int seed), split as the JAX package
splits its key into the init, burn-in and sampling keys, or a key source
``rng(phase, index) -> key`` with ``phase`` ``"init"`` (index 0),
``"warmup"`` or ``"sample"`` (index = draw), whose keys may be ``(z, u)``
pairs: that is how the tests replay the JAX run's streams.  A fold
transition under ``Key(s)`` draws what kernel 5 draws in-kernel for seed
``s`` (:func:`aehmc_tpu_torch.ops.philox.ghmc_streams`).
"""

from typing import Callable, NamedTuple, Tuple

import torch

from aehmc_tpu_torch import _batch, ghmc, keys
from aehmc_tpu_torch.algorithms import (
    _pairwise_outer_sum,
    pairwise_mean,
    pairwise_sum,
)
from aehmc_tpu_torch.metrics import PerChain
from aehmc_tpu_torch.ops.nuts_fused import _is_key_source
from aehmc_tpu_torch.types import Diagnostics, IntegratorState

# Up to this dimension the (dim, dim) covariance is formed once and the
# power iteration runs on it; above it the iteration is matrix-free.
_EXPLICIT_COV_MAX_DIM = 512


class MeadsHyperparams(NamedTuple):
    """Per-fold hyperparameters."""

    step_size: torch.Tensor  # (num_folds,)
    alpha: torch.Tensor  # (num_folds,) momentum retention
    inverse_mass_matrix: torch.Tensor  # (num_folds, dim) = sigma^2


class MeadsCarry(NamedTuple):
    """The MEADS kernel's carry: chain states, the hyperparameters in force
    and the iteration counter (a host int) that schedules re-estimation."""

    states: IntegratorState  # batched over the chain axis
    hyper: MeadsHyperparams
    step: int


def _lmax_cov(x: torch.Tensor, num_iters: int = 16,
              center: bool = True) -> torch.Tensor:
    """Largest eigenvalue of the covariance (or, ``center=False``, of the
    uncentered second moment) of the rows of ``x (..., n, dim)``; leading
    axes are a batch (the folds).

    Up to ``_EXPLICIT_COV_MAX_DIM`` the second-moment matrix is formed with
    :func:`~aehmc_tpu_torch.algorithms._pairwise_outer_sum`; above it each
    matvec contracts the chain axis with :func:`pairwise_sum`.
    """
    if center:
        x = x - pairwise_mean(x, axis=-2).unsqueeze(-2)
    n, dim = x.shape[-2:]
    kw = dict(dtype=x.dtype, device=x.device)
    v = (torch.ones(x.shape[:-2] + (dim,), **kw)
         / torch.sqrt(torch.full((), float(dim), **kw)))

    if dim <= _EXPLICIT_COV_MAX_DIM:
        cov = _pairwise_outer_sum(x) / n

        def matvec(v):
            return (cov @ v.unsqueeze(-1)).squeeze(-1)
    else:
        def matvec(v):
            w = x @ v.unsqueeze(-1)  # (..., n, 1): reduces over dim
            return pairwise_sum(w * x, axis=-2) / n

    for _ in range(num_iters):
        w = matvec(v)
        v = w / torch.clamp(torch.linalg.vector_norm(w, dim=-1, keepdim=True),
                            min=1e-20)
    w = matvec(v)
    return torch.clamp(torch.sum(v * w, dim=-1), min=1e-20)


def estimate_hyperparams(states: IntegratorState, num_folds: int = 4,
                         step_size_multiplier: float = 0.5
                         ) -> MeadsHyperparams:
    """Cross-fold estimation: fold ``k``'s hyperparameters from fold
    ``k-1``'s states, every fold at once."""
    num_chains, dim = states.position.shape
    per_fold = num_chains // num_folds

    def fold(a):
        return a.reshape((num_folds, per_fold) + a.shape[1:])

    pos = torch.roll(fold(states.position), 1, dims=0)
    grad = torch.roll(fold(states.potential_energy_grad), 1, dims=0)
    pos_mean = pairwise_mean(pos, axis=1)
    std = torch.sqrt(pairwise_mean((pos - pos_mean[:, None]) ** 2, axis=1))
    # coincident chains have no cross-chain spread: take the identity
    # preconditioner there, not ~0 (which would send eps to infinity)
    degenerate = std <= 1e-10 * (1.0 + torch.abs(pos_mean))
    sigma = torch.where(degenerate, 1.0, std)
    # the uncentered second moment of the preconditioned gradients: the
    # covariance at stationarity, and still a curvature when chains coincide
    eps = step_size_multiplier / torch.sqrt(
        _lmax_cov(grad * sigma[:, None], center=False))
    length = torch.sqrt(torch.clamp(_lmax_cov(pos / sigma[:, None]), min=1.0))
    alpha = torch.exp(-2.0 * (eps / length))
    return MeadsHyperparams(step_size=eps, alpha=alpha,
                            inverse_mass_matrix=sigma**2)


def init_states(key, initial_positions: torch.Tensor,
                logprob_fn: Callable) -> IntegratorState:
    """Batched GHMC states with unit-metric momenta (MEADS
    re-preconditions every step)."""
    return ghmc.new_state(key, initial_positions, logprob_fn)


def init_carry(key, initial_positions: torch.Tensor, logprob_fn: Callable,
               num_folds: int = 4, step_size_multiplier: float = 0.5
               ) -> MeadsCarry:
    """The initial :class:`MeadsCarry`: batched states and a first
    estimate."""
    states = init_states(key, initial_positions, logprob_fn)
    hyper = estimate_hyperparams(states, num_folds, step_size_multiplier)
    return MeadsCarry(states=states, hyper=hyper, step=0)


def _fold(a: torch.Tensor, num_folds: int) -> torch.Tensor:
    return a.reshape((num_folds, a.shape[0] // num_folds) + a.shape[1:])


def _unfold(a: torch.Tensor) -> torch.Tensor:
    return a.reshape((a.shape[0] * a.shape[1],) + a.shape[2:])


def _map(fn, states):
    return type(states)(*(fn(a) for a in states))


def new_kernel(logprob_fn: Callable, num_folds: int = 4,
               divergence_threshold: float = 1000.0,
               step_size_multiplier: float = 0.5, recompute_every: int = 1,
               transition_fn: Callable = None) -> Callable:
    """The MEADS transition over a chain batch.

    Returns ``step(key, carry) -> (carry, infos)`` with ``carry`` a
    :class:`MeadsCarry` (build it with :func:`init_carry`) whose chains
    divide into ``num_folds`` folds of at least 2.  ``recompute_every=k``
    re-estimates the hyperparameters on every k-th step (the host counter
    ``carry.step``) and keeps them in between.  ``transition_fn(key,
    fold_states, hyper)`` replaces the fold transition, e.g.
    :func:`aehmc_tpu_torch.ops.ghmc_fused.make_fused_meads_transition`.
    """
    transition = transition_fn or _make_fold_transition(
        logprob_fn, divergence_threshold)

    def step(key, carry: MeadsCarry) -> Tuple[MeadsCarry, Diagnostics]:
        if carry.step % recompute_every == 0:
            hyper = estimate_hyperparams(carry.states, num_folds,
                                         step_size_multiplier)
        else:
            hyper = carry.hyper
        fold_states = _map(lambda a: _fold(a, num_folds), carry.states)
        new_fold_states, infos = transition(key, fold_states, hyper)
        return (MeadsCarry(states=_map(_unfold, new_fold_states), hyper=hyper,
                           step=carry.step + 1),
                _map(_unfold, infos))

    return step


def _tile(a: torch.Tensor, per_fold: int) -> torch.Tensor:
    """A per-fold ``(folds, ...)`` tensor repeated for each of a fold's
    chains: ``(chains, ...)``."""
    return torch.repeat_interleave(a, per_fold, dim=0)


def _make_fold_transition(logprob_fn: Callable,
                          divergence_threshold: float = 1000.0) -> Callable:
    """One GHMC sweep over folded states ``(num_folds, per_fold, ...)`` with
    fixed per-fold hyperparameters: ``transition(key, fold_states, hyper)``.

    One normal draw for the whole fleet and one uniform a chain (the key's
    :func:`~aehmc_tpu_torch.keys.normals_and_uniform`, or a ``(z, u)`` pair
    of shapes ``(chains, dim)`` and ``(chains,)``); fold ``k``'s noise is
    ``√(1/M⁻¹_k)·z``.
    """
    ghmc_step = ghmc.new_noise_kernel(logprob_fn, divergence_threshold)

    def transition(key, fold_states: IntegratorState,
                   hyper: MeadsHyperparams):
        num_folds, per_fold = fold_states.position.shape[:2]
        states = _map(_unfold, fold_states)
        z, u = keys.normals_and_uniform(key, states.position)
        imm = _tile(hyper.inverse_mass_matrix, per_fold)
        noise = torch.sqrt(1.0 / imm) * z
        new_states, infos = ghmc_step(
            noise, u, states, _tile(hyper.step_size, per_fold),
            _tile(hyper.alpha, per_fold), PerChain(imm))
        return (_map(lambda a: _fold(a, num_folds), new_states),
                _map(lambda a: _fold(a, num_folds), infos))

    return transition


def _key_source(rng, num_warmup_keys: int, num_sample_keys: int) -> Callable:
    """``(phase, index) -> key``: a key source as it is; else the JAX
    package's split of one key into the init, burn-in and sampling keys,
    each of the last two split once more into per-draw keys."""
    if _is_key_source(rng):
        return rng
    init_key, warm_key, sample_key = keys.split(rng, 3)
    per_phase = {
        "init": [init_key],
        "warmup": keys.split(warm_key, max(num_warmup_keys, 1)),
        "sample": keys.split(sample_key, max(num_sample_keys, 1)),
    }
    return lambda phase, index: per_phase[phase][index]


def _check_folds(num_chains: int, num_folds: int) -> None:
    if num_chains % num_folds or num_chains // num_folds < 2:
        raise ValueError(
            f"MEADS needs chains divisible by num_folds={num_folds} with "
            f">= 2 chains per fold, got {num_chains}"
        )


def sample(
    rng,
    logprob_fn: Callable,
    initial_positions: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 500,
    *,
    num_folds: int = 4,
    divergence_threshold: float = 1000.0,
    step_size_multiplier: float = 0.5,
    collect_positions: bool = True,
    recompute_every: int = 1,
    transition_fn: Callable = None,
    segment_transition_fn: Callable = None,
):
    """Burn-in, then sampling, of ``initial_positions (chains, dim)``.

    Adaptation is part of the kernel, so ``num_warmup`` draws are simply
    discarded.  ``recompute_every > 1`` or a ``segment_transition_fn``
    takes the segmented driver: one estimation a ``recompute_every``-draw
    segment, the segment's draws under fixed hyperparameters, segment counts
    rounded up and the output trimmed to ``num_samples``.
    ``segment_transition_fn(key, fold_states, hyper, num_draws, collect) ->
    (fold_states, (positions, infos))`` runs a whole segment in one call
    (:func:`aehmc_tpu_torch.ops.ghmc_fused.make_fused_meads_segment`, one
    launch of kernel 6), with the segment's first draw key.

    Returns ``(final_states, positions (draws, chains, dim) or None, infos
    (draws, chains) each, hyper)`` with ``hyper`` the last per-fold
    :class:`MeadsHyperparams`.
    """
    _check_folds(initial_positions.shape[0], num_folds)
    segmented = recompute_every > 1 or segment_transition_fn is not None
    if segmented:
        k = recompute_every
        key_source = _key_source(rng, -(-num_warmup // k) * k,
                                 -(-num_samples // k) * k)
        return _sample_segmented(
            key_source, logprob_fn, initial_positions, num_samples,
            num_warmup, num_folds=num_folds,
            divergence_threshold=divergence_threshold,
            step_size_multiplier=step_size_multiplier,
            collect_positions=collect_positions,
            recompute_every=recompute_every, transition_fn=transition_fn,
            segment_transition_fn=segment_transition_fn,
        )
    key_source = _key_source(rng, num_warmup, num_samples)
    carry = init_carry(key_source("init", 0), initial_positions, logprob_fn,
                       num_folds, step_size_multiplier)
    kernel = new_kernel(logprob_fn, num_folds, divergence_threshold,
                        step_size_multiplier, transition_fn=transition_fn)
    for t in range(num_warmup):
        carry, _ = kernel(key_source("warmup", t), carry)
    positions, infos = [], []
    for t in range(num_samples):
        carry, info = kernel(key_source("sample", t), carry)
        if collect_positions:
            positions.append(carry.states.position)
        infos.append(info)
    return (carry.states,
            torch.stack(positions) if collect_positions else None,
            _batch.stack(infos), carry.hyper)


def _sample_segmented(key_source, logprob_fn, initial_positions, num_samples,
                      num_warmup, *, num_folds, divergence_threshold,
                      step_size_multiplier, collect_positions,
                      recompute_every, transition_fn=None,
                      segment_transition_fn=None):
    """MEADS in segments: one estimation, then ``recompute_every`` draws with
    the hyperparameters fixed (the JAX package's nested scans)."""
    k = recompute_every
    transition = transition_fn or _make_fold_transition(
        logprob_fn, divergence_threshold)
    states = init_states(key_source("init", 0), initial_positions,
                         logprob_fn)
    fold_states = _map(lambda a: _fold(a, num_folds), states)

    def segment(fold_states, phase, first, collect):
        hyper = estimate_hyperparams(_map(_unfold, fold_states), num_folds,
                                     step_size_multiplier)
        if segment_transition_fn is not None:
            fold_states, (pos, infos) = segment_transition_fn(
                key_source(phase, first), fold_states, hyper, k, collect)
            return fold_states, pos, infos, hyper
        positions, infos = [], []
        for t in range(first, first + k):
            fold_states, info = transition(key_source(phase, t), fold_states,
                                           hyper)
            if collect:
                positions.append(fold_states.position)
            infos.append(info)
        pos = torch.stack(positions) if collect else None
        return fold_states, pos, _batch.stack(infos), hyper

    for s in range(-(-num_warmup // k)):
        fold_states, _, _, _ = segment(fold_states, "warmup", s * k, False)
    positions, infos = [], []
    hyper = None
    for s in range(-(-num_samples // k)):
        fold_states, pos, info, hyper = segment(fold_states, "sample", s * k,
                                                collect_positions)
        positions.append(pos)
        infos.append(info)

    def flatten(chunks):
        # (segments · k, folds, per_fold, ...) -> (draws, chains, ...)
        a = torch.cat(chunks)
        return a.reshape((a.shape[0], -1) + a.shape[3:])[:num_samples]

    return (_map(_unfold, fold_states),
            flatten(positions) if collect_positions else None,
            type(infos[0])(*(flatten(list(f)) for f in zip(*infos))),
            hyper)
