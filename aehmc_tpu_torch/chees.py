"""ChEES-HMC: adaptive trajectory lengths for many parallel chains (port of
:mod:`aehmc_tpu.chees`, Hoffman, Radul & Sountsov 2021).

Every chain takes the same Halton-jittered number of leapfrog steps per
draw.  Warmup tunes the step size by dual averaging on the pooled
acceptance (target 0.651), the trajectory length ``h`` by Adam ascent on
``log h`` with the cross-chain ChEES gradient, and a diagonal ``M⁻¹`` by
pooled Welford windows on Stan's schedule.  The cross-chain reductions are
the fixed-tree :func:`~aehmc_tpu_torch.algorithms.pairwise_sum`.

The transition is a ``kernel_fn(key, states, step_size,
num_integration_steps, inverse_mass_matrix) -> (ChainState, CheesInfo)``:
by default the XLA kernel :func:`new_kernel` (the autograd leapfrog, or a
fused ``integrate_fn`` such as
:func:`aehmc_tpu_torch.ops.fused_hmc.logistic_integrate_fn`, kernel 8), or
e.g. :func:`aehmc_tpu_torch.ops.chees_fused.make_fused_chees_kernel`.  The
trip count is computed on the chains' device, ``clip(ceil(jitter·h/ε), 1,
max)`` in float32 in that order, and reaches the kernel as a device int32;
the XLA kernel reads it on the host once a step.

Randomness: ``rng`` is a ``torch.Generator``, handed to ``kernel_fn`` as
every call's key (the fused kernel draws its Philox seed or its streams from
it), or a callable ``rng(phase, index) -> key`` with ``phase`` one of
``"search"``, ``"warmup"`` and ``"sample"``: the port's counterpart of the
JAX package's split keys, through which the tests replay the JAX run's
streams.
"""

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from aehmc_tpu_torch import _batch, hmc, keys, metrics
from aehmc_tpu_torch.algorithms import (
    pairwise_mean,
    pairwise_sum,
    welford_update_batch,
)
from aehmc_tpu_torch.integrators import velocity_verlet
from aehmc_tpu_torch.mass_matrix import covariance_adaptation
from aehmc_tpu_torch.step_size import (
    dual_averaging_adaptation,
    find_reasonable_step_size,
)
from aehmc_tpu_torch.trajectory import static_integration
from aehmc_tpu_torch.types import ChainState, IntegratorState
from aehmc_tpu_torch.window_adaptation import build_schedule

OPTIMAL_TARGET_ACCEPTANCE = 0.651


class CheesInfo(NamedTuple):
    acceptance_probability: torch.Tensor  # per chain
    is_diverging: torch.Tensor  # per chain
    proposed_position: torch.Tensor  # (chains, dim), endpoint even if rejected
    proposed_velocity: torch.Tensor  # (chains, dim)
    num_integration_steps: torch.Tensor  # int32 scalar shared by the chains
    energy: torch.Tensor


class CheesSampleInfo(NamedTuple):
    """Per-draw diagnostics stacked by :func:`sample`: (draws, chains), and
    ``num_integration_steps`` (draws,)."""

    acceptance_probability: torch.Tensor
    num_integration_steps: torch.Tensor
    is_diverging: torch.Tensor
    energy: torch.Tensor


class AdamState(NamedTuple):
    m: torch.Tensor
    v: torch.Tensor
    step: torch.Tensor


class CheesWarmupResult(NamedTuple):
    states: ChainState
    step_size: torch.Tensor
    trajectory_length: torch.Tensor
    inverse_mass_matrix: torch.Tensor


def halton(index, bits: int = 24) -> torch.Tensor:
    """Base-2 radical inverse (van der Corput) of ``index + 1`` in (0, 1),
    float32: the 24-bit reversal of the index plus one, over 2^24.  An
    ``int`` index is reversed on the host."""
    if isinstance(index, int):
        bits_str = format((index + 1) & ((1 << bits) - 1), f"0{bits}b")
        return torch.tensor(int(bits_str[::-1], 2) / float(1 << bits),
                            dtype=torch.float32)
    index = (torch.as_tensor(index, dtype=torch.int64) + 1) & ((1 << bits) - 1)
    rev = torch.zeros_like(index)
    for _ in range(bits):
        rev = (rev << 1) | (index & 1)
        index = index >> 1
    return rev.to(torch.float32) / float(1 << bits)


def new_kernel(
    logprob_fn: Callable,
    divergence_threshold: float = 1000.0,
    integrator: Callable = velocity_verlet,
    integrate_fn: Callable = None,
) -> Callable:
    """The batched XLA ChEES-HMC transition.

    Returns ``step(key, states, step_size, num_integration_steps,
    inverse_mass_matrix) -> (ChainState, CheesInfo)``: ``states`` has a
    leading chain axis, ``num_integration_steps`` is shared by the chains
    (an int, or an int32 tensor read once on the host).  The key's Philox
    streams give the momentum normals and the accept uniforms
    (:func:`aehmc_tpu_torch.keys.normals_and_uniform`: the streams of the
    fused ChEES kernel at the same seed); a ``(z, u)`` pair passes them in.

    ``integrate_fn(q, p, step_size, num_steps, inverse_mass_matrix) ->
    (q', p')`` replaces the autograd leapfrog loop with a fused trajectory
    over the batch (kernel 8 through
    :func:`aehmc_tpu_torch.ops.fused_hmc.logistic_integrate_fn`); it gets the
    current inverse mass matrix, and the final energies and gradients are
    recomputed with one batched ``logprob_fn`` evaluation.
    """

    def potential_fn(x):
        return -logprob_fn(x)

    potential_vag = _batch.value_and_grad(potential_fn)

    def step(key, states: ChainState, step_size, num_integration_steps,
             inverse_mass_matrix) -> Tuple[ChainState, CheesInfo]:
        position = states.position
        imm = _batch.like(inverse_mass_matrix, position)
        momentum_generator, kinetic_energy_fn, _ = metrics.gaussian_metric(imm)
        z, u = keys.normals_and_uniform(key, position)
        init = IntegratorState(position, momentum_generator(z),
                               states.potential_energy,
                               states.potential_energy_grad)
        if integrate_fn is None:
            final = static_integration(
                integrator(potential_fn, kinetic_energy_fn),
                num_integration_steps)(init, step_size)
            final = final._replace(momentum=-final.momentum)
        else:
            q_final, p_final = integrate_fn(position, init.momentum, step_size,
                                            num_integration_steps, imm)
            final_u, final_grad = potential_vag(q_final)
            final = IntegratorState(q_final, -p_final, final_u, final_grad)
        p_accept, do_accept, diverging, energy, new_energy = hmc.metropolis(
            init, final, kinetic_energy_fn, divergence_threshold, u)
        accepted = _batch.where(do_accept, final, init)
        new_states = ChainState(accepted.position, accepted.potential_energy,
                                accepted.potential_energy_grad)
        info = CheesInfo(
            acceptance_probability=p_accept,
            is_diverging=diverging,
            proposed_position=final.position,
            # the endpoint velocity M⁻¹ p, before the flip
            proposed_velocity=kinetic_energy_fn.velocity(-final.momentum),
            num_integration_steps=torch.as_tensor(
                num_integration_steps, dtype=torch.int32,
                device=position.device),
            energy=torch.where(do_accept, new_energy, energy),
        )
        return new_states, info

    return step


def _chees_gradient(positions: torch.Tensor, info: CheesInfo,
                    jitter) -> torch.Tensor:
    """Cross-chain estimate of d(ChEES)/d(trajectory length): per chain
    ``(‖q′−q̄′‖² − ‖q−q̄‖²) · (q′−q̄′)·v′``, weighted by the acceptance
    probability (non-finite terms get weight 0), times the jitter."""
    alpha = info.acceptance_probability
    q = positions
    q_prop = info.proposed_position
    q_mean = pairwise_mean(q, axis=0)
    q_prop_mean = pairwise_mean(q_prop, axis=0)
    delta_prop = q_prop - q_prop_mean
    delta = q - q_mean
    change_sq = (torch.sum(delta_prop**2, dim=-1)
                 - torch.sum(delta**2, dim=-1))
    dchees_dt = change_sq * torch.sum(delta_prop * info.proposed_velocity,
                                      dim=-1)
    finite = torch.isfinite(dchees_dt)
    weights = torch.where(finite, alpha, 0.0)
    dchees_dt = torch.where(finite, dchees_dt, 0.0)
    grad = pairwise_sum(weights * dchees_dt) / torch.clamp(
        pairwise_sum(weights), min=1e-10
    )
    return grad * jitter


def _adam_update(grad, value, state: AdamState, learning_rate: float = 0.025,
                 beta1: float = 0.9, beta2: float = 0.999,
                 eps: float = 1e-8) -> Tuple[torch.Tensor, AdamState]:
    """One Adam *ascent* step on ``value``."""
    step = state.step + 1
    m = beta1 * state.m + (1.0 - beta1) * grad
    v = beta2 * state.v + (1.0 - beta2) * grad**2
    t = step.to(value.dtype)
    m_hat = m / (1.0 - beta1**t)
    v_hat = v / (1.0 - beta2**t)
    new_value = value + learning_rate * m_hat / (torch.sqrt(v_hat) + eps)
    return new_value, AdamState(m=m, v=v, step=step)


def _key_source(rng) -> Callable:
    """``(phase, index) -> key``: a callable as it is, a generator for every
    call."""
    if callable(rng) and not isinstance(rng, torch.Generator):
        return rng
    return lambda phase, index: rng


def _scalar(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` as a 0-d tensor of ``like``'s dtype and device, filled on the
    device when it comes from the host (a copy would synchronise)."""
    if isinstance(x, torch.Tensor) and x.device == like.device:
        return x.to(like.dtype)
    return torch.full((), float(x), dtype=like.dtype, device=like.device)


def _num_leapfrog(step: int, trajectory_length, step_size,
                  max_num_integration_steps: int):
    """The shared trip count of draw ``step`` and its jitter, on the device:
    ``clip(ceil(jitter·h/ε), 1, max)``."""
    jitter = float(halton(step))
    steps = torch.ceil(jitter * trajectory_length / step_size).to(torch.int32)
    return torch.clamp(steps, 1, max_num_integration_steps), jitter


def warmup_hooks(
    logprob_fn: Callable,
    num_chains: int,
    dim: int,
    num_steps: int = 400,
    *,
    initial_step_size: float = 0.1,
    initial_trajectory_length: Optional[float] = None,
    target_acceptance_rate: float = OPTIMAL_TARGET_ACCEPTANCE,
    max_num_integration_steps: int = 1024,
    learning_rate: float = 0.025,
    integrator: Callable = velocity_verlet,
    integrate_fn: Callable = None,
    divergence_threshold: float = 1000.0,
    search_initial_step_size: bool = True,
    dtype=None,
    kernel_fn: Callable = None,
):
    """Segmentable ChEES warmup: ``(init, segment, finish)``.

    ``init(rng, initial_states) -> wcarry`` (with the initial step-size
    search when asked), ``segment(wcarry, steps) -> (wcarry,
    accept_history)`` runs the steps in order, ``finish(wcarry) ->``
    :class:`CheesWarmupResult`.  ``kernel_fn`` is the whole transition, by
    default :func:`new_kernel` of ``logprob_fn``, ``divergence_threshold``,
    ``integrator`` and ``integrate_fn``.
    """
    kernel = kernel_fn or new_kernel(logprob_fn, divergence_threshold,
                                     integrator, integrate_fn)
    da_init, da_update = dual_averaging_adaptation(target_acceptance_rate)
    mm_init, _, mm_final = covariance_adaptation(False)
    wc_update_batch = welford_update_batch(False)
    schedule = build_schedule(num_steps)
    dtype = torch.float32 if dtype is None else dtype

    def _new_da_state(step_size):
        log_eps = torch.log(step_size)
        return da_init(math.log(10.0) + log_eps)._replace(
            iterates=log_eps, iterates_avg=log_eps
        )

    def init(rng, initial_states: ChainState):
        key_source = _key_source(rng)
        device = initial_states.position.device
        init_eps = torch.full((), initial_step_size, dtype=dtype, device=device)
        imm0, wc0 = mm_init(dim, dtype=dtype, device=device)
        if search_initial_step_size:
            one = torch.ones((), dtype=torch.int32, device=device)
            init_eps = find_reasonable_step_size(
                lambda probe, s, eps, imm: kernel(key_source("search", probe), s,
                                                  eps, one, imm),
                initial_states, imm0, initial_step_size=init_eps,
                target_accept=target_acceptance_rate, reduce_fn=pairwise_mean,
            )
        h0 = (10.0 * init_eps if initial_trajectory_length is None
              else torch.full((), initial_trajectory_length, dtype=dtype,
                              device=device))
        zero = torch.zeros((), dtype=dtype, device=device)
        adam = AdamState(m=zero, v=zero,
                         step=torch.zeros((), dtype=torch.int32, device=device))
        return (key_source, initial_states, _new_da_state(init_eps), adam,
                torch.log(h0), wc0, imm0)

    def one_step(carry, step: int):
        key_source, states, da_state, adam_state, log_h, wc_state, imm = carry
        eps = torch.exp(da_state.iterates)
        num_leapfrog, jitter = _num_leapfrog(step, torch.exp(log_h), eps,
                                             max_num_integration_steps)
        new_states, info = kernel(key_source("warmup", step), states, eps,
                                  num_leapfrog, imm)

        # step size: dual averaging on the pooled acceptance
        new_da_state = da_update(pairwise_mean(info.acceptance_probability),
                                 da_state)
        # trajectory length: Adam ascent on log h, the gradient scaled by h
        grad = _chees_gradient(states.position, info, jitter)
        grad = grad * torch.exp(log_h)
        new_log_h, new_adam_state = _adam_update(grad, log_h, adam_state,
                                                 learning_rate)
        new_log_h = torch.clamp(new_log_h, min=torch.log(eps),
                                max=torch.log(eps * max_num_integration_steps))
        # mass matrix: pooled Welford in the slow windows; at a window end
        # swap it in, restart Welford and dual averaging
        stage, is_window_end = schedule[step]
        if stage == 1:
            wc_state = wc_update_batch(new_states.position, wc_state)
        if is_window_end:
            imm = mm_final(wc_state)
            _, wc_state = mm_init(dim, dtype=dtype, device=imm.device)
            new_da_state = _new_da_state(torch.exp(new_da_state.iterates))
        return (key_source, new_states, new_da_state, new_adam_state, new_log_h,
                wc_state, imm), info.acceptance_probability

    def segment(wcarry, steps):
        accepts = []
        for step in steps:
            wcarry, accept = one_step(wcarry, int(step))
            accepts.append(accept)
        return wcarry, torch.stack(accepts)

    def finish(wcarry) -> CheesWarmupResult:
        _, states, da_state, _, log_h, _, imm = wcarry
        return CheesWarmupResult(
            states=states,
            step_size=torch.exp(da_state.iterates_avg),
            trajectory_length=torch.exp(log_h),
            inverse_mass_matrix=imm,
        )

    return init, segment, finish


def warmup(
    rng,
    logprob_fn: Callable,
    initial_states: ChainState,
    num_steps: int = 400,
    *,
    initial_step_size: float = 0.1,
    initial_trajectory_length: Optional[float] = None,
    target_acceptance_rate: float = OPTIMAL_TARGET_ACCEPTANCE,
    max_num_integration_steps: int = 1024,
    learning_rate: float = 0.025,
    integrator: Callable = velocity_verlet,
    integrate_fn: Callable = None,
    divergence_threshold: float = 1000.0,
    search_initial_step_size: bool = True,
    kernel_fn: Callable = None,
) -> CheesWarmupResult:
    """Jointly adapt the step size, the trajectory length and a diagonal
    ``M⁻¹`` over ``num_steps`` transitions of ``kernel_fn``.  With
    ``search_initial_step_size`` both ε and the initial ``h = 10·ε`` start
    from the doubling/halving search on the pooled one-leapfrog acceptance.
    """
    num_chains, dim = initial_states.position.shape
    init, segment, finish = warmup_hooks(
        logprob_fn, num_chains, dim, num_steps,
        initial_step_size=initial_step_size,
        initial_trajectory_length=initial_trajectory_length,
        target_acceptance_rate=target_acceptance_rate,
        max_num_integration_steps=max_num_integration_steps,
        learning_rate=learning_rate,
        integrator=integrator,
        integrate_fn=integrate_fn,
        divergence_threshold=divergence_threshold,
        search_initial_step_size=search_initial_step_size,
        dtype=initial_states.position.dtype,
        kernel_fn=kernel_fn,
    )
    wcarry, _ = segment(init(rng, initial_states), range(num_steps))
    return finish(wcarry)


def sample(
    rng,
    logprob_fn: Callable,
    states: ChainState,
    num_samples: int,
    step_size,
    trajectory_length,
    inverse_mass_matrix,
    *,
    max_num_integration_steps: int = 1024,
    integrator: Callable = velocity_verlet,
    integrate_fn: Callable = None,
    divergence_threshold: float = 1000.0,
    collect_positions: bool = True,
    collect_dtype=None,
    kernel_fn: Callable = None,
    _step_offset: int = 0,
):
    """Sample with the tuned parameters, the trajectory length still
    Halton-jittered (draw ``t`` takes jitter ``halton(_step_offset + t)``
    and the key ``rng("sample", _step_offset + t)``, so a run cut into
    segments draws what the whole run draws).

    Returns ``(final_states, positions (draws, chains, dim) or None,
    CheesSampleInfo)``; ``collect_dtype`` narrows the stored draws.
    """
    kernel = kernel_fn or new_kernel(logprob_fn, divergence_threshold,
                                     integrator, integrate_fn)
    key_source = _key_source(rng)
    like = states.position
    step_size = _scalar(step_size, like)
    trajectory_length = _scalar(trajectory_length, like)
    positions, infos = [], []
    for t in range(_step_offset, _step_offset + num_samples):
        num_leapfrog, _ = _num_leapfrog(t, trajectory_length, step_size,
                                        max_num_integration_steps)
        states, info = kernel(key_source("sample", t), states, step_size,
                              num_leapfrog, inverse_mass_matrix)
        if collect_positions:
            positions.append(states.position if collect_dtype is None
                             else states.position.to(collect_dtype))
        infos.append(info)
    stacked = CheesSampleInfo(
        acceptance_probability=torch.stack(
            [i.acceptance_probability for i in infos]),
        num_integration_steps=torch.stack(
            [i.num_integration_steps.reshape(()) for i in infos]),
        is_diverging=torch.stack([i.is_diverging for i in infos]),
        energy=torch.stack([i.energy for i in infos]),
    )
    pos = torch.stack(positions) if collect_positions else None
    return states, pos, stacked
