"""End-to-end driver of the fused NUTS kernels: Stan window adaptation driving
the per-transition kernel, then sampling (port of the main-path subset of
:mod:`aehmc_tpu.ops.fused_driver`).

Step size and inverse mass matrix are runtime inputs of the kernels, so
adaptation changes them every step.  The pooled statistics are the JAX
package's: the fixed-tree pairwise mean of the per-chain acceptance, and the
batched Welford fold of the positions.  Supported: diagonal or dense M⁻¹,
scalar ε, Philox (``use_internal_prng``) or external randomness, the
whole-run kernel (``loop_in_kernel``), ``collect_dtype`` float32 or
bfloat16.  The other options of the JAX driver raise ``NotImplementedError``
naming their ROADMAP.md item.
"""

from typing import Callable, Sequence

import torch

from aehmc_tpu_torch.algorithms import pairwise_mean, welford_update_batch
from aehmc_tpu_torch.ops.nuts_fused import derive_draw_seeds
from aehmc_tpu_torch.ops.nuts_fused_small import (
    _draw_loop,
    _external_randomness,
    _fused_sampling_call_t,
    _generator_streams,
    _mass_sqrt,
    _pot_grad_builder_t,
    make_fused_nuts_transition_small,
)
from aehmc_tpu_torch.types import ChainState
from aehmc_tpu_torch.window_adaptation import window_adaptation

# options of the JAX driver that the port does not have yet -> ROADMAP item
_NOT_PORTED = {
    "sort_by_depth": "1.5",
    "step_size_factors": "1.5",
    "per_chain_step_size": "1.5",
    "per_chain_quantiles": "1.5",
    "search_initial_step_size": "1.5",
    "mesh": "1.12",
    "checkpoint_every": "1.10",
    "checkpoint_path": "1.10",
    "resume": "1.10",
}


def _reject_unported(options: dict) -> None:
    for name, value in options.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"unexpected keyword argument {name!r}")
        if value:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP.md item {_NOT_PORTED[name]})"
            )


def warmup_fused_hooks(
    transition: Callable,
    num_chains: int,
    dim: int,
    num_steps: int = 400,
    *,
    max_num_expansions: int,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 0.1,
    target_acceptance_rate: float = 0.8,
    use_internal_prng: bool = True,
    streams: Callable = None,
    **options,
):
    """Segmentable fused warmup: ``(init, segment, finish)``.

    ``transition`` is a transposed-layout transition
    (``make_fused_nuts_transition_small(..., transposed_io=True)``).
    ``init(generator, (q_t, u_row, g_t)) -> wcarry`` takes the chain state as
    ``(dim, C)``, ``(1, C)``, ``(dim, C)``; ``segment(wcarry, steps) ->
    (wcarry, accept_history)`` runs the steps in order; ``finish(wcarry) ->
    ((q_t, u, g_t), (step_size, inverse_mass_matrix))``.  With
    ``use_internal_prng`` step ``t`` uses the Philox key ``base +
    t*DRAW_SEED_STRIDE``; otherwise ``streams(t) -> (z, dirs, u_bias,
    u_leaf)`` (standard layout), drawn from the generator when not given.
    """
    _reject_unported(options)
    init_adapt, update_adapt = window_adaptation(
        num_steps,
        is_mass_matrix_full,
        initial_step_size,
        target_acceptance_rate,
        welford_update_fn=welford_update_batch(is_mass_matrix_full),
        acceptance_statistic=lambda stats_t: pairwise_mean(stats_t[1]),
        num_dims_fn=lambda positions: positions.shape[1],
    )

    def init(generator, qug):
        q_t, u, g_t = qug
        ast = init_adapt(ChainState(q_t.T, u.reshape(-1), g_t.T))
        if use_internal_prng:
            randomness = derive_draw_seeds(generator, num_steps)
        else:
            randomness = streams or _generator_streams(
                generator, num_chains, dim, max_num_expansions, q_t.device
            )
        return qug, ast, randomness

    def one_step(qug, ast, step, randomness):
        q_t, u, g_t = qug
        imm, eps = ast.inverse_mass_matrix, ast.step_size
        if use_internal_prng:
            out = transition(q_t, u, g_t, None, None, None, None, imm, eps,
                             seed=randomness[step])
        else:
            p, dirs, ub, ul = _external_randomness(randomness(step), imm,
                                                   q_t.device)
            out = transition(q_t, u, g_t, p, dirs, ub, ul, imm, eps)
        q_t, u, g_t, stats_t = out
        return (q_t, u, g_t), update_adapt(step, ast, q_t.T, stats_t), stats_t[1]

    def segment(wcarry, steps):
        qug, ast, randomness = wcarry
        accepts = []
        for step in steps:
            qug, ast, accept = one_step(qug, ast, int(step), randomness)
            accepts.append(accept)
        return (qug, ast, randomness), torch.stack(accepts)

    def finish(wcarry):
        qug, ast, _ = wcarry
        return qug, (ast.step_size, ast.inverse_mass_matrix)

    return init, segment, finish


def warmup_fused(
    generator: torch.Generator,
    transition: Callable,
    initial_positions: torch.Tensor,
    u0: torch.Tensor,
    g0: torch.Tensor,
    num_steps: int = 400,
    *,
    max_num_expansions: int,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 0.1,
    target_acceptance_rate: float = 0.8,
    use_internal_prng: bool = True,
    streams: Callable = None,
    **options,
):
    """Stan window adaptation over a fused NUTS transition.

    ``initial_positions``/``g0`` are ``(chains, dim)``, ``u0`` is
    ``(chains, 1)``; ``transition`` is transposed-layout (see
    :func:`warmup_fused_hooks`).  Returns ``((q, u, g), step_size,
    inverse_mass_matrix)`` in the same layout.
    """
    num_chains, dim = initial_positions.shape
    init, segment, finish = warmup_fused_hooks(
        transition, num_chains, dim, num_steps,
        max_num_expansions=max_num_expansions,
        is_mass_matrix_full=is_mass_matrix_full,
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
        use_internal_prng=use_internal_prng,
        streams=streams,
        **options,
    )
    wcarry = init(generator, (initial_positions.T.contiguous(),
                              u0.reshape(1, num_chains),
                              g0.T.contiguous()))
    wcarry, _ = segment(wcarry, range(num_steps))
    (q_t, u, g_t), (eps, imm) = finish(wcarry)
    return (q_t.T, u.reshape(num_chains, 1), g_t.T), eps, imm


def sample_fused_adaptive(
    generator: torch.Generator,
    potential_fn: Callable,
    data: Sequence[torch.Tensor],
    initial_positions: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 400,
    *,
    potential_fn_t: Callable = None,
    potential_and_grad_t: Callable = None,
    max_num_expansions: int = 6,
    divergence_threshold: float = 1000.0,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 0.1,
    target_acceptance_rate: float = 0.8,
    collect_positions: bool = True,
    collect_dtype=None,
    use_internal_prng: bool = True,
    loop_in_kernel: bool = False,
    **options,
):
    """One-call driver: fused warmup, then fused sampling.

    The model is the transposed ``potential_fn_t(q_t, *data)`` and/or the
    pre-differentiated ``potential_and_grad_t(q_t, *data) -> (u, g)``;
    ``potential_fn`` (the standard-layout kernel's contract) is not ported.
    ``loop_in_kernel`` runs the whole sampling phase as one call of the
    whole-run kernel, bitwise equal to one transition per draw.  With
    ``use_internal_prng=False`` the external streams are drawn from
    ``generator``.

    Returns ``(final_positions, positions (draws, chains, dim),
    stats (draws, chains, 8), step_size, inverse_mass_matrix)``.
    """
    _reject_unported(options)
    if potential_fn_t is None and potential_and_grad_t is None:
        raise NotImplementedError(
            "the standard-layout fused kernel (potential_fn) is not ported "
            "yet (ROADMAP.md, kernels 3-4); pass potential_fn_t or "
            "potential_and_grad_t"
        )
    if loop_in_kernel and not use_internal_prng:
        raise ValueError(
            "loop_in_kernel draws all randomness in the kernel — it requires "
            "use_internal_prng=True"
        )
    num_chains, dim = initial_positions.shape
    data = tuple(data)
    transition = make_fused_nuts_transition_small(
        potential_fn_t, data,
        max_num_expansions=max_num_expansions,
        divergence_threshold=divergence_threshold,
        potential_and_grad_t=potential_and_grad_t,
        transposed_io=True,
    )
    q0_t = initial_positions.T.to(torch.float32).contiguous()
    u0, g0_t = _pot_grad_builder_t(potential_fn_t, potential_and_grad_t,
                                   data)(q0_t)
    init, segment, finish = warmup_fused_hooks(
        transition, num_chains, dim, num_warmup,
        max_num_expansions=max_num_expansions,
        is_mass_matrix_full=is_mass_matrix_full,
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
        use_internal_prng=use_internal_prng,
    )
    wcarry = init(generator, (q0_t, u0.reshape(1, num_chains), g0_t))
    wcarry, _ = segment(wcarry, range(num_warmup))
    (q_t, u, g_t), (eps, imm) = finish(wcarry)

    cdt = torch.float32 if collect_dtype is None else collect_dtype
    if loop_in_kernel:
        seed = derive_draw_seeds(generator, 1)[0]
        pos_t, stats_t, qf_t, _, _ = _fused_sampling_call_t(
            potential_fn_t, potential_and_grad_t, data, q_t, u, g_t, imm,
            eps, seed, num_samples,
            max_num_expansions=max_num_expansions,
            divergence_threshold=divergence_threshold,
            collect_positions=collect_positions, collect_dtype=cdt,
        )
        positions = None if pos_t is None else pos_t.transpose(1, 2)
        return qf_t.T, positions, stats_t.transpose(1, 2), eps, imm

    if use_internal_prng:
        randomness = derive_draw_seeds(generator, num_samples)
    else:
        randomness = _generator_streams(generator, num_chains, dim,
                                        max_num_expansions, q_t.device)
    qf, positions, stats = _draw_loop(
        transition, q_t, u, g_t, imm, eps, num_samples, randomness,
        collect_positions, cdt,
    )
    return qf, positions, stats, eps, imm
