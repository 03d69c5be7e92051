"""End-to-end drivers of the fused kernels: Stan window adaptation driving
the per-transition kernel, then sampling (port of the NUTS and GHMC/MALA
drivers of :mod:`aehmc_tpu.ops.fused_driver`).

Step size and inverse mass matrix are runtime inputs of the kernels, so
adaptation changes them every step.  The pooled statistics are the JAX
package's: the fixed-tree pairwise mean of the per-chain acceptance, and the
batched Welford fold of the positions.  Supported: diagonal or dense M⁻¹
(NUTS; GHMC and MALA take a diagonal), a scalar or per-chain ε (per-chain
dual averaging, its quantile snap, the riffle of ``step_size_factors``),
the initial-ε search, depth-sorted block scheduling (``sort_by_depth``),
Philox (``use_internal_prng``) or external randomness, the whole-run NUTS
kernel (``loop_in_kernel``), the standard-layout NUTS kernel
(``potential_fn`` alone), GHMC segments of ``segment_draws`` draws,
``collect_dtype`` float32 or bfloat16, checkpoint/resume of the NUTS
driver (``checkpoint_every``: per-draw launches in saved segments), and a
device mesh (``mesh=``, :func:`shard_fused_transition`: the kernels run
per shard at the shard's global chain offset, bitwise equal to the
unsharded run).
"""

from typing import Callable, NamedTuple, Sequence

import torch

from aehmc_tpu_torch.algorithms import pairwise_mean, welford_update_batch
from aehmc_tpu_torch.observability import (
    progress_callback,
    progress_draws,
    stats_info,
)
from aehmc_tpu_torch.ops.ghmc_fused import (
    fused_ghmc_segment,
    make_fused_ghmc_transition,
)
from aehmc_tpu_torch.ops.nuts_fused import (
    DRAW_SEED_STRIDE,
    _generic_model,
    _is_key_source,
    _sample_phase,
    derive_draw_seeds,
    make_fused_nuts_transition,
)
from aehmc_tpu_torch.ops.nuts_fused_small import (
    _depth_sorted,
    _draw_loop,
    _external_randomness,
    _fused_sampling_call_t,
    _generator_streams,
    _mass_sqrt,
    _pot_grad_builder_t,
    make_fused_nuts_transition_small,
)
from aehmc_tpu_torch.ops.philox import MASK32
from aehmc_tpu_torch.step_size import find_reasonable_step_size
from aehmc_tpu_torch.types import ChainState
from aehmc_tpu_torch.window_adaptation import window_adaptation

def shard_fused_transition(
    transition: Callable,
    mesh,
    num_chains: int,
    block_chains: int = None,
    *,
    transposed_io: bool = False,
) -> Callable:
    """A fused NUTS transition run per shard of the chain axis over
    ``mesh`` (:mod:`aehmc_tpu_torch.parallel.mesh`; port of the JAX
    ``shard_fused_transition``), with the same signature.

    ``transition`` comes from :func:`make_fused_nuts_transition_small` or
    :func:`~aehmc_tpu_torch.ops.nuts_fused.make_fused_nuts_transition`;
    ``transposed_io`` says it takes the ``(dim, chains)`` layout (the chain
    axis last) rather than ``(chains, dim)``.  Each shard runs on its
    device with its chains of the state and of external randomness, a
    per-chain ε vector sharded with the chains and a scalar ε and M⁻¹
    replicated; under a Philox ``seed`` the shard's chains draw their
    global chain index's streams (``chain_offset``), so the outputs, joined
    in chain order on the state's device, equal the unsharded
    transition's bit for bit on the card.  Raises ``ValueError`` when the
    chains do not split over the devices or a given ``block_chains`` does
    not tile a shard, as the JAX adapter does.
    """
    from aehmc_tpu_torch.parallel.mesh import (
        SHARDED,
        SHARED,
        VECTOR,
        chain_shards,
        map_shards,
    )

    shards = chain_shards(mesh, num_chains, block_chains)
    axis = -1 if transposed_io else 0
    spec = (SHARDED,) * 7 + (SHARED, VECTOR)

    def sharded(q, u, g, p, dirs, ub, ul, imm, eps, seed=None,
                chain_offset=0):
        return map_shards(
            lambda s: transition(
                *s.args(spec, (q, u, g, p, dirs, ub, ul, imm, eps), axis),
                seed=seed, chain_offset=chain_offset + s.start),
            shards, q.device, axis)

    return sharded


def quantile_snap(values: torch.Tensor, num_buckets: int,
                  stat: str = "min") -> torch.Tensor:
    """Snap a positive per-chain vector to ``num_buckets`` rank-quantile
    bucket representatives (port of the JAX ``quantile_snap``).

    The chains are ranked and split into ``num_buckets`` buckets of equal
    count (sorted place ``i`` is in bucket ``(i·K)//n``); every chain of a
    bucket gets the bucket's representative: its minimum (``"min"``: no
    chain runs above its own tuned ε) or its geometric mean
    (``"geomean"``).  Order statistics only, and the sums run in a fixed
    order, so the snap is deterministic on every device.
    """
    n = values.shape[0]
    order = torch.argsort(values, stable=True)
    ranks = torch.argsort(order)
    sorted_vals = values[order]
    if stat not in ("min", "geomean"):
        raise ValueError(f"unknown quantile_snap stat {stat!r}")
    # bucket b holds the sorted places [ceil(b·n/K), ceil((b+1)·n/K))
    edges = [-(-b * n // num_buckets) for b in range(num_buckets + 1)]
    spans = [(lo, hi) for lo, hi in zip(edges, edges[1:]) if hi > lo]
    if stat == "min":  # ascending: a bucket's minimum is its first value
        reps = torch.stack([sorted_vals[lo] for lo, _ in spans])
    else:
        logs = torch.log(sorted_vals)
        reps = torch.exp(torch.stack([logs[lo:hi].sum() / (hi - lo)
                                      for lo, hi in spans]))
    counts = torch.tensor([hi - lo for lo, hi in spans], device=values.device)
    snapped = torch.repeat_interleave(reps, counts, output_size=n)
    return snapped[ranks].to(values.dtype)


def _probe_value_and_grad(data: Sequence[torch.Tensor],
                          potential_and_grad_t: Callable = None,
                          potential_fn_t: Callable = None,
                          potential_fn: Callable = None) -> Callable:
    """``vg(q) -> (u (C,), g (C, dim))`` in the standard batched layout from
    whichever potential the caller has: the pre-differentiated transposed
    one, the transposed one (autograd) or the standard one (autograd)."""
    data = tuple(data)
    if potential_and_grad_t is not None or potential_fn_t is not None:
        pot_grad_t = _pot_grad_builder_t(potential_fn_t, potential_and_grad_t,
                                         data)

        def vg(q):
            u, g_t = pot_grad_t(q.T.to(torch.float32).contiguous())
            return u.reshape(-1), g_t.T

    elif potential_fn is not None:
        pot_grad = _generic_model(potential_fn, data).pot_grad

        def vg(q):
            u, g = pot_grad(q.to(torch.float32))
            return u.reshape(-1), g

    else:
        raise ValueError("no potential available for the step-size probe")
    return vg


def _ke_batch(p: torch.Tensor, inverse_mass: torch.Tensor) -> torch.Tensor:
    """``0.5 pᵀM⁻¹p`` per chain, ``(C, dim)`` layout, scalar, diagonal or
    dense M⁻¹."""
    if inverse_mass.ndim == 2:
        return 0.5 * torch.sum(p * (p @ inverse_mass), dim=-1)
    return 0.5 * torch.sum(inverse_mass * p * p, dim=-1)


class _ProbeInfo(NamedTuple):
    acceptance_probability: torch.Tensor


def find_reasonable_step_size_fused(
    noise: Callable,
    value_and_grad: Callable,
    positions: torch.Tensor,
    inverse_mass_matrix: torch.Tensor,
    initial_step_size: float = 1.0,
    target_accept: float = 0.8,
    max_iters: int = 16,
) -> torch.Tensor:
    """Stan's initial-ε heuristic for the fused warmup: each probe is one
    chain-batched velocity-Verlet step (one gradient), the chains'
    acceptance pooled by the fixed-tree pairwise mean, ε doubled or halved
    until it crosses ``target_accept`` (port of the JAX
    ``find_reasonable_step_size_fused``, on
    :func:`aehmc_tpu_torch.step_size.find_reasonable_step_size`).

    ``noise(probe) -> z (C, dim)`` gives the probe's standard normals (the
    momentum is ``z`` under ``sqrt(M)``); ``value_and_grad(q) -> (u, g)``
    is in the standard layout (:func:`_probe_value_and_grad`).  Returns a
    0-d ε.
    """
    q = positions.to(torch.float32)
    u0, g0 = value_and_grad(q)
    imm = torch.as_tensor(inverse_mass_matrix, dtype=torch.float32,
                          device=q.device)
    mass_sqrt = _mass_sqrt(imm)

    def kernel_step(probe, state, eps, imm):
        z = torch.as_tensor(noise(probe), dtype=torch.float32, device=q.device)
        p = z @ mass_sqrt.T if mass_sqrt.ndim == 2 else mass_sqrt * z
        h0 = u0 + _ke_batch(p, imm)
        p_half = p - 0.5 * eps * g0
        drift = p_half @ imm.T if imm.ndim == 2 else imm * p_half
        u1, g1 = value_and_grad(q + eps * drift)
        p1 = p_half - 0.5 * eps * g1
        delta = h0 - (u1 + _ke_batch(p1, imm))
        delta = torch.where(torch.isnan(delta), -torch.inf, delta)
        return state, _ProbeInfo(torch.exp(torch.clamp(delta, max=0.0)))

    return find_reasonable_step_size(
        kernel_step, None, imm,
        initial_step_size=torch.tensor(initial_step_size, dtype=torch.float32,
                                       device=q.device),
        target_accept=target_accept, max_iters=max_iters,
        reduce_fn=pairwise_mean,
    )


def _generator_normals(generator, shape, device) -> Callable:
    """``noise(i) -> z``: standard normals of ``shape`` from a
    ``torch.Generator``."""
    def noise(_):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(device)

    return noise


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
    sort_by_depth: bool = False,
    step_size_factors=None,
    per_chain_step_size: bool = False,
    per_chain_quantiles: int = 0,
    per_chain_quantile_stat: str = "min",
    search_initial_step_size: bool = False,
    probe_value_and_grad: Callable = None,
    streams: Callable = None,
    search_streams: Callable = None,
    progress_every: int = 0,
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
    ``progress_every=N`` prints a progress line every N steps.

    The options are the JAX hooks':

    - ``per_chain_step_size``: one dual-averaging state a chain, seeded with
      a ``(C,)`` ε and fed the chain's own acceptance (stats row 1, no
      pooling); M⁻¹ stays pooled.
    - ``per_chain_quantiles=K``: at ``finish`` the tuned ``(C,)`` ε is
      snapped to K rank-quantile representatives (:func:`quantile_snap`,
      ``per_chain_quantile_stat``); warmup itself is unchanged.
    - ``step_size_factors`` ``(C,)``: chain ``c`` runs every step at ε ·
      ``factors[c]`` while dual averaging tunes the base ε (the riffle).
    - ``sort_by_depth``: each step runs under depth-sorted block scheduling
      (:func:`~aehmc_tpu_torch.ops.nuts_fused_small._depth_sorted`) by the
      previous step's doublings; the adaptation sees the outputs in chain
      order, and the depth is in the carry, so segments (checkpoints)
      replay the unsegmented run bit for bit.
    - ``search_initial_step_size``: ``init`` seats dual averaging at
      :func:`find_reasonable_step_size_fused` from ``initial_step_size``,
      probing with ``probe_value_and_grad`` and the normals
      ``search_streams(probe) -> z (C, dim)``, drawn from the generator
      before the warmup keys when not given.
    """
    if search_initial_step_size and probe_value_and_grad is None:
        raise ValueError(
            "search_initial_step_size probes with single leapfrog steps "
            "— pass probe_value_and_grad (see _probe_value_and_grad)"
        )
    scalar_initial_step_size = initial_step_size
    if per_chain_step_size:
        # one DA state a chain: a (C,) step size and each chain's own
        # acceptance; every DA operation is elementwise
        initial_step_size = torch.full((num_chains,), initial_step_size,
                                       dtype=torch.float32)
        acceptance_statistic = lambda stats_t: stats_t[1]  # noqa: E731
    else:
        acceptance_statistic = lambda stats_t: pairwise_mean(  # noqa: E731
            stats_t[1])
    init_adapt, update_adapt = window_adaptation(
        num_steps,
        is_mass_matrix_full,
        initial_step_size,
        target_acceptance_rate,
        welford_update_fn=welford_update_batch(is_mass_matrix_full),
        acceptance_statistic=acceptance_statistic,
        num_dims_fn=lambda positions: positions.shape[1],
    )

    def init(generator, qug):
        q_t, u, g_t = qug
        chain_state = ChainState(q_t.T, u.reshape(-1), g_t.T)
        ast = init_adapt(chain_state)
        if search_initial_step_size:
            # the search's draws come first, as JAX splits its key first
            noise = search_streams or _generator_normals(
                generator, (num_chains, dim), q_t.device)
            found = find_reasonable_step_size_fused(
                noise, probe_value_and_grad, q_t.T, ast.inverse_mass_matrix,
                initial_step_size=scalar_initial_step_size,
                target_accept=target_acceptance_rate,
            )
            if per_chain_step_size:
                found = found.reshape(1).repeat(num_chains)
            ast = init_adapt(chain_state, found)
        if use_internal_prng:
            randomness = derive_draw_seeds(generator, num_steps)
        else:
            randomness = streams or _generator_streams(
                generator, num_chains, dim, max_num_expansions, q_t.device
            )
        depth = (torch.zeros(num_chains, dtype=torch.float32,
                             device=q_t.device) if sort_by_depth else None)
        return qug, ast, depth, randomness

    def one_step(qug, ast, depth, step, randomness):
        imm, eps = ast.inverse_mass_matrix, ast.step_size
        if step_size_factors is not None:
            eps = eps * step_size_factors
        if use_internal_prng:
            def run(q_t, u, g_t, eps):
                return transition(q_t, u, g_t, None, None, None, None, imm,
                                  eps, seed=randomness[step])
        else:
            rand = _external_randomness(randomness(step), imm, qug[0].device)

            def run(q_t, u, g_t, eps):
                return transition(q_t, u, g_t, *rand, imm, eps)
        q_t, u, g_t, stats_t = _depth_sorted(run, *qug, eps, depth)
        if progress_every:
            progress_callback(step, stats_info(stats_t.T), progress_every)
        return ((q_t, u, g_t), update_adapt(step, ast, q_t.T, stats_t),
                None if depth is None else stats_t[2], stats_t[1])

    def segment(wcarry, steps):
        qug, ast, depth, randomness = wcarry
        accepts = []
        for step in steps:
            qug, ast, depth, accept = one_step(qug, ast, depth, int(step),
                                               randomness)
            accepts.append(accept)
        return (qug, ast, depth, randomness), torch.stack(accepts)

    def finish(wcarry):
        qug, ast, _, _ = wcarry
        eps = ast.step_size
        if per_chain_quantiles and eps.ndim > 0:
            eps = quantile_snap(eps, per_chain_quantiles,
                                per_chain_quantile_stat)
        return qug, (eps, ast.inverse_mass_matrix)

    return init, segment, finish


def warmup_fused(
    generator: torch.Generator,
    transition: Callable,
    initial_positions: torch.Tensor,
    u0: torch.Tensor,
    g0: torch.Tensor,
    num_steps: int = 400,
    **options,
):
    """Stan window adaptation over a fused NUTS transition.

    ``initial_positions``/``g0`` are ``(chains, dim)``, ``u0`` is
    ``(chains, 1)``; ``transition`` is transposed-layout, and ``options``
    are the keywords of :func:`warmup_fused_hooks` (``max_num_expansions``
    is required).  Returns ``((q, u, g), step_size, inverse_mass_matrix)``
    in the same layout.
    """
    num_chains, dim = initial_positions.shape
    init, segment, finish = warmup_fused_hooks(
        transition, num_chains, dim, num_steps, **options)
    wcarry = init(generator, (initial_positions.T.contiguous(),
                              u0.reshape(1, num_chains),
                              g0.T.contiguous()))
    wcarry, _ = segment(wcarry, range(num_steps))
    (q_t, u, g_t), (eps, imm) = finish(wcarry)
    return (q_t.T, u.reshape(num_chains, 1), g_t.T), eps, imm


def _standard_as_transposed(transition: Callable) -> Callable:
    """A standard-layout transition (:mod:`aehmc_tpu_torch.ops.nuts_fused`)
    under the transposed contract of :func:`warmup_fused_hooks` and
    ``_draw_loop``: the state crosses as transposed views, so a ``(dim, C)``
    view of a contiguous ``(C, dim)`` state costs no copy."""
    def t(x):
        return None if x is None else x.T

    def transposed(q_t, u, g_t, p, dirs, ub, ul, imm, eps, seed=None,
                   chain_offset=0):
        q, un, g, stats = transition(q_t.T, u.reshape(-1, 1), g_t.T, t(p),
                                     t(dirs), t(ub), t(ul), imm, eps,
                                     seed=seed, chain_offset=chain_offset)
        return q.T, un.reshape(1, -1), g.T, stats.T

    return transposed


def _standard_branch_errors(is_mass_matrix_full, loop_in_kernel,
                            step_size_factors, per_chain_step_size):
    """The JAX driver's rules for the standard-layout kernel."""
    rules = (
        (is_mass_matrix_full, "dense-metric self-tuning requires the "
         "transposed kernel — pass potential_fn_t (the standard-layout "
         "megakernel has no dense metric path)"),
        (step_size_factors is not None, "step_size_factors "
         "requires the transposed kernel — pass potential_fn_t"),
        (per_chain_step_size, "per_chain_step_size requires "
         "the transposed kernel — pass potential_fn_t"),
        (loop_in_kernel, "loop_in_kernel requires the transposed kernel — "
         "pass potential_fn_t (the standard-layout megakernel has its own "
         "loop via ops.nuts_fused.sample_fused)"),
    )
    for broken, message in rules:
        if broken:
            raise ValueError(message)


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
    block_chains: int = None,
    is_mass_matrix_full: bool = False,
    initial_step_size: float = 0.1,
    target_acceptance_rate: float = 0.8,
    collect_positions: bool = True,
    collect_dtype=None,
    use_internal_prng: bool = True,
    sort_by_depth: bool = False,
    step_size_factors=None,
    per_chain_step_size: bool = False,
    per_chain_quantiles: int = 0,
    per_chain_quantile_stat: str = "min",
    search_initial_step_size: bool = False,
    loop_in_kernel: bool = False,
    progress_every: int = 0,
    checkpoint_every: int = 0,
    checkpoint_path: str = None,
    resume: bool = False,
    mesh=None,
    _crash_after_segments: int = None,
    _crash_after_warmup_segments: int = None,
):
    """One-call driver: fused warmup, then fused sampling.

    The model is the transposed ``potential_fn_t(q_t, *data)`` and/or the
    pre-differentiated ``potential_and_grad_t(q_t, *data) -> (u, g)``
    (kernels 1 and 2 on the card); without either, the standard-layout
    ``potential_fn(q, *data) -> (chains,)`` (kernel 3 on the card, one
    launch per warmup step and per draw, when it is
    :func:`aehmc_tpu_torch.ops.nuts_fused.logistic_potential`), which takes
    a diagonal metric, a scalar ε and no ``loop_in_kernel``, as in the JAX
    driver.  ``loop_in_kernel`` runs the transposed sampling phase as one
    call of the whole-run kernel, bitwise equal to one transition per draw.
    With ``use_internal_prng=False`` the external streams are drawn from
    ``generator``, or ``generator`` is a key source ``(phase, index) ->
    (z, dirs, u_bias, u_leaf)`` (standard layout, ``phase`` ``"warmup"`` or
    ``"sample"``; ``"search"`` gives the initial-ε probes' normals ``z``),
    as :mod:`aehmc_tpu_torch.chees` takes one.
    ``block_chains`` has no effect (a CUDA block holds 8 chains).
    ``progress_every=N`` prints a progress line every N warmup steps and
    draws.

    The JAX driver's step-size options (:func:`warmup_fused_hooks`):
    ``per_chain_step_size`` (one dual-averaging state a chain; the tuned ε
    is ``(chains,)``), ``per_chain_quantiles``/``per_chain_quantile_stat``
    (the tuned vector snapped to K values, :func:`quantile_snap`),
    ``step_size_factors`` (a ``(chains,)`` riffle of the tuned base ε, in
    warmup and every draw) and ``search_initial_step_size`` (dual averaging
    seated at :func:`find_reasonable_step_size_fused`).
    ``sort_by_depth`` runs every warmup step and draw under depth-sorted
    block scheduling (the chains in the stable order of their last
    doublings, a per-chain ε along); it runs one transition a draw
    (kernel 1 on the card), so not with ``loop_in_kernel``.

    **Checkpoint / resume** as in
    :func:`aehmc_tpu_torch.parallel.sample_sharded`: ``checkpoint_every=N,
    checkpoint_path="run.npz"`` runs warmup and sampling in saved N-step
    segments of one launch a step; draw ``t`` takes the Philox key ``base +
    t·DRAW_SEED_STRIDE`` with ``t`` the absolute draw index, the base drawn
    where the unsegmented run draws it, so the checkpointed run draws what
    the unsegmented one draws and a resumed run (``resume=True``) what the
    uninterrupted one does, bit for bit.  The last depth is in the
    snapshots.  Not with ``loop_in_kernel``.

    **Mesh**: ``mesh`` (:func:`aehmc_tpu_torch.parallel.make_mesh`) runs
    every warmup step and draw through :func:`shard_fused_transition`, one
    launch a shard, and ``loop_in_kernel`` as one whole-run launch a shard
    at its chain offset; the adaptation reduces over the chains gathered
    in chain order, the depth sort is one global stable argsort, and the
    checkpoints hold the gathered state, so the run equals the unsharded
    one bit for bit on the card (and on the CPU wherever the potential's
    arithmetic for a chain does not depend on the batch width).
    A ``block_chains`` given must tile a shard, as in the JAX driver (the
    CUDA kernels need no tiling: a ragged block is masked, and the streams
    follow the global chain index).

    Returns ``(final_positions, positions (draws, chains, dim),
    stats (draws, chains, 8), step_size, inverse_mass_matrix)``.
    """
    standard = potential_fn_t is None and potential_and_grad_t is None
    if standard:
        _standard_branch_errors(is_mass_matrix_full, loop_in_kernel,
                                step_size_factors, per_chain_step_size)
    if per_chain_quantiles and not per_chain_step_size:
        raise ValueError(
            "per_chain_quantiles snaps the PER-CHAIN tuned step sizes — "
            "set per_chain_step_size=True as well"
        )
    if loop_in_kernel and not use_internal_prng:
        raise ValueError(
            "loop_in_kernel draws all randomness in the kernel — it requires "
            "use_internal_prng=True"
        )
    if loop_in_kernel and sort_by_depth:
        raise ValueError(
            "loop_in_kernel keeps each block's chains resident in "
            "VMEM across draws; sort_by_depth is a global cross-"
            "block permutation between draws — use the scan path"
        )
    if loop_in_kernel and checkpoint_every:
        raise ValueError(
            "loop_in_kernel runs the whole sampling phase in one kernel — "
            "checkpoint segmentation needs the scan path"
        )
    if checkpoint_every and checkpoint_path is None:
        raise ValueError("checkpoint_every requires checkpoint_path")
    warmup_streams = sample_streams = search_streams = None
    if _is_key_source(generator):
        if use_internal_prng:
            raise TypeError("a key source replays external streams — it "
                            "requires use_internal_prng=False")
        key_source = generator

        def warmup_streams(step):
            return key_source("warmup", step)

        def search_streams(probe):
            return key_source("search", probe)

        sample_streams = _sample_phase(key_source)
    num_chains, dim = initial_positions.shape
    device = initial_positions.device
    data = tuple(data)
    if step_size_factors is not None:
        step_size_factors = torch.as_tensor(
            step_size_factors, dtype=torch.float32,
            device=device).reshape(num_chains)
    if standard:
        transition = _standard_as_transposed(make_fused_nuts_transition(
            potential_fn, data, max_num_expansions=max_num_expansions,
            divergence_threshold=divergence_threshold,
        ))
        q0 = initial_positions.to(torch.float32).contiguous()
        u0, g0 = _generic_model(potential_fn, data).pot_grad(q0)
        q0_t, g0_t = q0.T, g0.T
    else:
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
    # imported here: parallel.pooled imports this package
    from aehmc_tpu_torch.parallel.mesh import (
        SHARDED,
        SHARED,
        VECTOR,
        Shard,
        chain_shards,
        device_replicas,
        map_shards,
    )
    from aehmc_tpu_torch.parallel.pooled import _checkpointed_run

    if mesh is None:
        shards = [Shard(device, 0, num_chains)]
    else:
        shards = chain_shards(mesh, num_chains, block_chains)
        transition = shard_fused_transition(transition, mesh, num_chains,
                                            block_chains, transposed_io=True)
    data_on = device_replicas(data)
    # kernel 2's operands: the state (dim, chains), M⁻¹, ε
    whole_run_spec = (SHARDED,) * 3 + (SHARED, VECTOR)
    probe_vg = None
    if search_initial_step_size:
        probe_vg = _probe_value_and_grad(
            data, potential_and_grad_t=potential_and_grad_t,
            potential_fn_t=potential_fn_t,
            potential_fn=potential_fn if standard else None)
    init, segment, finish = warmup_fused_hooks(
        transition, num_chains, dim, num_warmup,
        max_num_expansions=max_num_expansions,
        is_mass_matrix_full=is_mass_matrix_full,
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
        use_internal_prng=use_internal_prng,
        sort_by_depth=sort_by_depth,
        step_size_factors=step_size_factors,
        per_chain_step_size=per_chain_step_size,
        per_chain_quantiles=per_chain_quantiles,
        per_chain_quantile_stat=per_chain_quantile_stat,
        search_initial_step_size=search_initial_step_size,
        probe_value_and_grad=probe_vg,
        streams=warmup_streams,
        search_streams=search_streams,
        progress_every=progress_every,
    )
    cdt = torch.float32 if collect_dtype is None else collect_dtype
    qug0 = (q0_t, u0.reshape(1, num_chains), g0_t)

    def sample_randomness(draws, base):
        """The draws' Philox keys, or their streams by index in ``draws``."""
        if use_internal_prng:
            return [(base + t * DRAW_SEED_STRIDE) & MASK32 for t in draws]
        streams = sample_streams or _generator_streams(
            generator, num_chains, dim, max_num_expansions, q0_t.device)
        return lambda i: streams(draws.start + i)

    def warmup_randomness(seeds):
        if use_internal_prng:
            return seeds
        return warmup_streams or _generator_streams(
            generator, num_chains, dim, max_num_expansions, q0_t.device)

    def wh_init(gen, _):
        qug, ast, depth, randomness = init(gen, qug0)
        if not use_internal_prng:
            return (qug, ast, depth, None, None), None
        # the sampling base is the generator's next draw after the warmup
        # keys; warmup draws nothing more from it
        return (qug, ast, depth, randomness, derive_draw_seeds(gen, 1)[0]), None

    def wh_segment(wc, steps):
        qug, ast, depth, seeds, base = wc
        (qug, ast, depth, _), _ = segment(
            (qug, ast, depth, warmup_randomness(seeds)), steps)
        return qug, ast, depth, seeds, base

    def wh_finish(wc):
        qug, ast, _, _, base = wc
        _, (eps, imm) = finish((qug, ast, None, None))
        # sampling starts from depth 0 (the stable sort keeps chain order)
        depth0 = (torch.zeros(num_chains, dtype=torch.float32, device=device)
                  if sort_by_depth else None)
        return (*qug, depth0), (eps, imm, base)

    def run_eps(eps):
        return eps if step_size_factors is None else eps * step_size_factors

    def sample_segment(carry, draws, extras, _):
        eps, imm, base = extras
        *qug, depth = carry
        if loop_in_kernel:  # one whole-run launch (kernel 2) a shard
            operands = (*qug, imm, run_eps(eps))

            def whole_run(s):
                pos_t, stats_t, *state = _fused_sampling_call_t(
                    potential_fn_t, potential_and_grad_t, data_on(s.device),
                    *s.args(whole_run_spec, operands, -1), base,
                    len(draws), max_num_expansions=max_num_expansions,
                    divergence_threshold=divergence_threshold,
                    collect_positions=collect_positions, collect_dtype=cdt,
                    chain_offset=s.start,
                )
                return (None if pos_t is None else pos_t.transpose(1, 2),
                        stats_t.transpose(1, 2), *state)

            positions, stats, *qug = map_shards(whole_run, shards, device,
                                                (1, 1, -1, -1, -1))
        else:
            (*qug, depth), positions, stats = _draw_loop(
                transition, *qug, imm, run_eps(eps), len(draws),
                sample_randomness(draws, base), collect_positions, cdt,
                final_state=True, depth=depth)
        progress_draws(progress_every, draws, stats_info(stats))
        return (*qug, depth), (positions, stats)

    def build_result(carry, extras, outs):
        eps, imm, _ = extras
        positions, stats = outs
        return carry[0].T, positions, stats, eps, imm

    return _checkpointed_run(
        generator, initial_positions, (wh_init, wh_segment, wh_finish),
        sample_segment, build_result, num_samples, num_warmup,
        checkpoint_every=checkpoint_every,
        checkpoint_path=checkpoint_path, resume=resume,
        _crash_after_segments=_crash_after_segments,
        _crash_after_warmup_segments=_crash_after_warmup_segments)


def _generator_ghmc_streams(generator, shape, device):
    """``streams(i) -> (z, u)``: raw standard normals of ``shape`` (the last
    axis is dim) and uniforms of ``shape[:-1]``, drawn from a
    ``torch.Generator``."""
    def streams(_):
        kw = dict(generator=generator, device=generator.device)
        z = torch.randn(shape, **kw)
        return z.to(device), torch.rand(shape[:-1], **kw).to(device)

    return streams


def _diag_im(imm, dim, device, sampler) -> torch.Tensor:
    """``imm`` as a ``(dim,)`` diagonal; ``sampler`` names the route in the
    error a dense metric raises."""
    imm = torch.as_tensor(imm, dtype=torch.float32, device=device)
    if imm.ndim == 2:
        raise ValueError(
            f"{sampler} supports scalar or diagonal preconditioners only "
            "(aehmc_tpu/mala.py contract)"
        )
    return imm.reshape(-1).expand(dim)


def ghmc_warmup(
    generator: torch.Generator,
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor],
    initial_positions: torch.Tensor,
    num_warmup: int,
    *,
    potential_and_grad_t: Callable = None,
    divergence_threshold: float = 1000.0,
    initial_step_size: float = 0.1,
    target_acceptance_rate: float = 0.8,
    per_chain_step_size: bool = False,
    per_chain_quantiles: int = 0,
    per_chain_quantile_stat: str = "min",
    search_initial_step_size: bool = False,
    use_internal_prng: bool = True,
    warmup_streams: Callable = None,
    search_streams: Callable = None,
):
    """The warmup of :func:`sample_fused_ghmc`: Stan window adaptation of ε
    and the diagonal M⁻¹ over the α = 0 GHMC transition (kernel 5 on the
    card), with the step-size options of :func:`warmup_fused_hooks`
    (``search_streams(probe) -> z (chains, dim)`` the search's normals).
    Returns ``((q_t, u, g_t), (step_size, inverse_mass_matrix))`` with the
    chain state in the kernels' ``(dim, chains)`` layout; a per-chain ε is
    ``(chains,)``."""
    num_chains, dim = initial_positions.shape
    device = initial_positions.device
    data = tuple(data)
    ghmc_tr = make_fused_ghmc_transition(
        potential_fn_t, data, divergence_threshold=divergence_threshold,
        potential_and_grad_t=potential_and_grad_t, transposed_io=True,
    )
    zero_p = torch.zeros((dim, num_chains), dtype=torch.float32, device=device)

    def transition(q_t, u, g_t, p, dirs, ub, ul, imm, eps, seed=None):
        # the α = 0 GHMC transition under the NUTS warmup's contract: the
        # momentum is refreshed in full every step, so a zero placeholder
        # carries no state; with external randomness p ~ N(0, M) is the
        # refresh noise and the first uniform row the MH draw
        rand = (dict(seed=seed) if seed is not None
                else dict(noise=p, u_accept=ub[:1]))
        im = _diag_im(imm, dim, device, "the fused MALA/GHMC warmup")
        qn, un, gn, _, stats = ghmc_tr(q_t, u, g_t, zero_p, eps, 0.0, im,
                                       **rand)
        return qn, un, gn, stats

    if use_internal_prng:
        warmup_raw = None
    else:
        per_step = warmup_streams or _generator_ghmc_streams(
            generator, (num_chains, dim), device)

        def warmup_raw(step):
            z, u = per_step(step)
            return z, None, torch.as_tensor(u).reshape(num_chains, 1), None

    q0_t = initial_positions.T.to(torch.float32).contiguous()
    u0, g0_t = _pot_grad_builder_t(potential_fn_t, potential_and_grad_t,
                                   data)(q0_t)
    probe_vg = None
    if search_initial_step_size:
        probe_vg = _probe_value_and_grad(
            data, potential_and_grad_t=potential_and_grad_t,
            potential_fn_t=potential_fn_t)
    init, segment, finish = warmup_fused_hooks(
        transition, num_chains, dim, num_warmup,
        max_num_expansions=1,
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
        use_internal_prng=use_internal_prng,
        per_chain_step_size=per_chain_step_size,
        per_chain_quantiles=per_chain_quantiles,
        per_chain_quantile_stat=per_chain_quantile_stat,
        search_initial_step_size=search_initial_step_size,
        probe_value_and_grad=probe_vg,
        streams=warmup_raw,
        search_streams=search_streams,
    )
    wcarry = init(generator, (q0_t, u0.reshape(1, num_chains), g0_t))
    wcarry, _ = segment(wcarry, range(num_warmup))
    return finish(wcarry)


def ghmc_sampling(
    generator: torch.Generator,
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor],
    state_t,
    step_size,
    inverse_mass_matrix,
    num_samples: int,
    *,
    alpha: float = 0.9,
    potential_and_grad_t: Callable = None,
    divergence_threshold: float = 1000.0,
    collect_positions: bool = True,
    collect_dtype=None,
    use_internal_prng: bool = True,
    segment_draws: int = 32,
    segment_streams: Callable = None,
    momentum_z: torch.Tensor = None,
):
    """The sampling of :func:`sample_fused_ghmc` from a tuned state
    ``state_t = (q_t, u, g_t)`` (the layout :func:`ghmc_warmup` returns):
    ``⌈num_samples / segment_draws⌉`` segments, one launch of kernel 6 each
    on the card, trimmed to ``num_samples``.  Returns ``(final_positions,
    positions, stats)`` in the ``(chains, ...)`` layout."""
    q_t, u, g_t = state_t
    dim, num_chains = q_t.shape
    device = q_t.device
    im = _diag_im(inverse_mass_matrix, dim, device,
                  "MALA" if alpha == 0.0 else "GHMC")
    noise_scale = torch.sqrt(1.0 / im).reshape(dim, 1)
    segment = fused_ghmc_segment(
        potential_fn_t, tuple(data), divergence_threshold=divergence_threshold,
        potential_and_grad_t=potential_and_grad_t, transposed_io=True,
    )
    num_segments = -(-num_samples // segment_draws)
    total = num_segments * segment_draws
    seeds = (derive_draw_seeds(generator, total)[::segment_draws]
             if use_internal_prng else None)
    if alpha:
        # persistent momentum: seed it from N(0, M) under the tuned metric
        if momentum_z is None:
            momentum_z = torch.randn((num_chains, dim), generator=generator,
                                     device=generator.device)
        z = torch.as_tensor(momentum_z, dtype=torch.float32, device=device)
        p_t = (noise_scale * z.T).contiguous()
    else:  # full refresh every draw: the initial momentum is not read
        p_t = torch.zeros_like(q_t)
    if not use_internal_prng:
        per_segment = segment_streams or _generator_ghmc_streams(
            generator, (segment_draws, num_chains, dim), device)

    positions, stats = [], []
    for s in range(num_segments):
        if use_internal_prng:
            rand = dict(seed=seeds[s])
        else:
            z, u_acc = per_segment(s)
            z = torch.as_tensor(z, dtype=torch.float32, device=device)
            rand = dict(noise=(noise_scale * z.transpose(1, 2)).contiguous(),
                        u_accept=torch.as_tensor(u_acc, dtype=torch.float32,
                                                 device=device))
        pos_t, st, q_t, u, g_t, p_t = segment(
            q_t, u, g_t, p_t, step_size, alpha, im, segment_draws,
            collect_positions=collect_positions, **rand,
        )
        if collect_positions:
            pos = pos_t.transpose(1, 2)
            positions.append(pos if collect_dtype is None
                             else pos.to(collect_dtype))
        stats.append(st.transpose(1, 2))
    positions = (torch.cat(positions)[:num_samples] if collect_positions
                 else None)
    return q_t.T, positions, torch.cat(stats)[:num_samples]


def sample_fused_ghmc(
    generator: torch.Generator,
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor],
    initial_positions: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 400,
    *,
    alpha: float = 0.9,
    potential_and_grad_t: Callable = None,
    divergence_threshold: float = 1000.0,
    block_chains: int = None,
    initial_step_size: float = 0.1,
    target_acceptance_rate: float = 0.8,
    search_initial_step_size: bool = False,
    per_chain_step_size: bool = False,
    per_chain_quantiles: int = 0,
    per_chain_quantile_stat: str = "min",
    collect_positions: bool = True,
    collect_dtype=None,
    use_internal_prng: bool = True,
    segment_draws: int = 32,
    warmup_streams: Callable = None,
    segment_streams: Callable = None,
    momentum_z: torch.Tensor = None,
    search_streams: Callable = None,
):
    """Fused GHMC: Stan warmup through the GHMC transition kernel, then
    sampling in segments of ``segment_draws`` draws, one launch of the
    segment kernel each (port of the JAX ``sample_fused_ghmc``; the two
    phases are :func:`ghmc_warmup` and :func:`ghmc_sampling`).

    ``alpha`` is the momentum persistence, in [0, 1); ``alpha = 0`` is MALA
    (:func:`sample_fused_mala`).  Warmup tunes ε and the diagonal M⁻¹ under
    the full-refresh (α = 0) transition; sampling then seeds the momentum
    from ``N(0, M)`` under the tuned metric (α > 0) and carries it across
    draws and segments.  The draw ``t`` of sampling takes the Philox key
    ``base + t·DRAW_SEED_STRIDE`` with ``t`` the absolute draw index, so the
    segmentation does not change a chain's bits.

    With ``use_internal_prng=False`` the randomness is external: raw
    standard normals ``z`` (the refresh noise is ``√(1/M⁻¹)·z`` under the
    current metric) and uniforms, from ``warmup_streams(step) -> (z (chains,
    dim), u (chains,))``, ``segment_streams(segment) -> (z (draws, chains,
    dim), u (draws, chains))`` and ``momentum_z (chains, dim)`` for the
    α > 0 initial momentum, each drawn from ``generator`` when not given.

    ``per_chain_step_size``, ``per_chain_quantiles``,
    ``per_chain_quantile_stat`` and ``search_initial_step_size`` are the
    NUTS driver's (:func:`warmup_fused_hooks`; ``search_streams(probe) ->
    z (chains, dim)`` gives the search's normals, drawn from ``generator``
    first when not given); kernels 5 and 6 take the ``(chains,)`` ε.
    ``block_chains`` has no effect (a CUDA block holds 8 chains).

    Returns ``(final_positions, positions (draws, chains, dim), stats
    (draws, chains, 8), step_size, inverse_mass_matrix)``; stats columns are
    ``[energy, accept, 0, 1, diverging, 0, 0, 0]``.
    """
    alpha_f = float(alpha)
    if not 0.0 <= alpha_f < 1.0:
        raise ValueError(
            f"alpha must be in [0, 1) (momentum persistence), got {alpha}"
        )
    if per_chain_quantiles and not per_chain_step_size:
        raise ValueError(
            "per_chain_quantiles snaps the PER-CHAIN tuned step sizes — "
            "set per_chain_step_size=True as well"
        )
    common = dict(potential_and_grad_t=potential_and_grad_t,
                  divergence_threshold=divergence_threshold,
                  use_internal_prng=use_internal_prng)
    state_t, (eps, imm) = ghmc_warmup(
        generator, potential_fn_t, data, initial_positions, num_warmup,
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
        per_chain_step_size=per_chain_step_size,
        per_chain_quantiles=per_chain_quantiles,
        per_chain_quantile_stat=per_chain_quantile_stat,
        search_initial_step_size=search_initial_step_size,
        warmup_streams=warmup_streams, search_streams=search_streams,
        **common,
    )
    final, positions, stats = ghmc_sampling(
        generator, potential_fn_t, data, state_t, eps, imm, num_samples,
        alpha=alpha_f, collect_positions=collect_positions,
        collect_dtype=collect_dtype, segment_draws=segment_draws,
        segment_streams=segment_streams, momentum_z=momentum_z, **common,
    )
    return final, positions, stats, eps, imm


def sample_fused_mala(
    generator: torch.Generator,
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor],
    initial_positions: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 400,
    **kwargs,
):
    """Fused MALA: :func:`sample_fused_ghmc` at ``alpha = 0``.

    One leapfrog step from a fully refreshed momentum is the MALA proposal
    with preconditioner M⁻¹, and the one-step energy ratio equals MALA's
    Metropolis-Hastings ratio.  Takes every keyword of
    :func:`sample_fused_ghmc` except ``alpha``.
    """
    if "alpha" in kwargs:
        raise TypeError(
            "sample_fused_mala IS alpha=0 — call sample_fused_ghmc for "
            "persistent momentum"
        )
    return sample_fused_ghmc(
        generator, potential_fn_t, data, initial_positions,
        num_samples, num_warmup, alpha=0.0, **kwargs,
    )
