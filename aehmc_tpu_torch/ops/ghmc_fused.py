"""Fused GHMC in the chains-in-lanes layout: plain PyTorch versions and the
wrappers of the two CUDA kernels (``csrc/ghmc_fused.cu``,
``csrc/hmc_generic.cu``).

Port of :mod:`aehmc_tpu.ops.ghmc_fused` (kernels 5 and 6 of the port's
table).  One transition is a partial momentum refresh ``p0 = α p +
√(1−α²) ξ`` with ``ξ ~ N(0, M)``, ``num_steps`` leapfrog steps and
Metropolis-Hastings with the momentum flipped on rejection
(:func:`aehmc_tpu.ghmc.new_noise_kernel`).  At ``α = 0`` and one step it is
MALA.  Chain state is ``(dim, chains)`` inside, ``(chains, dim)`` at the
builders' boundary; stats rows are ``[energy, accept_prob, 0, num_steps,
is_diverging, 0, 0, 0]``.

``step_size`` and ``alpha`` are scalars or per-chain ``(chains,)``;
``inverse_mass`` is a diagonal, ``(dim,)`` shared or ``(chains, dim)`` per
chain.  Randomness is external (``noise`` and ``u_accept``) or a Philox key
(``seed``): the kernels and the plain versions draw the same streams
(:func:`aehmc_tpu_torch.ops.philox.ghmc_streams`), the segment's draw ``t``
taking the key ``seed + t·DRAW_SEED_STRIDE``.

Dispatch is by the device of the chain state: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises.  The kernels compute
the potential in a device functor, as the NUTS kernels do
(:func:`aehmc_tpu_torch.ops.functors.card_functor`): the hand-written one
of the logistic regression (:func:`models.logistic_pg_t`, float32 or
bfloat16 X), and for any other float32 potential, given as
``potential_and_grad_t`` or ``potential_fn_t``, one generated from its
traced gradient graph (:mod:`aehmc_tpu_torch.ops.generic_pg`), the funnel
and eight schools included.  Launches count per functor:
``ghmc_transition`` and ``ghmc_transition_generic``, ``ghmc_segment`` and
``ghmc_segment_generic``.

:func:`make_fused_meads_transition` and :func:`make_fused_meads_segment`
adapt the two kernels to the MEADS fold contract
(:mod:`aehmc_tpu_torch.meads`): the per-fold ε, α and diagonal M⁻¹ are
repeated for each chain of a fold, the outputs refolded.
:func:`shard_fused_ghmc_transition` runs kernel 5 per shard of a device
mesh (the MEADS transition's ``mesh=``); the segment kernel has no shard
adapter, as in the JAX package.
"""

from typing import Callable, Sequence

import torch

from aehmc_tpu_torch import keys
from aehmc_tpu_torch.models.regression import logistic_pg_t
from aehmc_tpu_torch.ops.functors import HMC_CORE, card_functor
from aehmc_tpu_torch.ops.launch_plan import data_rows, launch_plan
from aehmc_tpu_torch.ops.launches import LAUNCHES
from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE, NEG_INF
from aehmc_tpu_torch.ops.nuts_fused_small import (
    _clamped,
    _pot_grad_builder_t,
)
from aehmc_tpu_torch.ops.philox import MASK32, ghmc_streams
from aehmc_tpu_torch.types import Diagnostics


def _ghmc_core_t(q0, u0, g0, p_prev, noise, u_acc, eps, alpha, im, pot_grad,
                 *, num_steps: int, divergence_threshold: float):
    """One GHMC transition of a batch of chains (plain PyTorch).

    ``q0, g0, p_prev, noise`` are ``(dim, C)``; ``u0, u_acc, eps, alpha``
    ``(1, C)``; ``im`` the diagonal ``M⁻¹`` as ``(dim, C)`` or ``(dim, 1)``;
    ``pot_grad(q) -> (u (1, C), g (dim, C))`` already clamped.  Returns
    ``(q, u, g, p, stats (8, C))``.  The operations are those of the JAX
    package's ``_ghmc_core_t`` in the same order.
    """
    def ke(p):
        return 0.5 * torch.sum(p * (im * p), dim=0, keepdim=True)

    p0 = alpha * p_prev + torch.sqrt(1.0 - alpha * alpha) * noise
    e0 = u0 + ke(p0)
    q, p, u, g = q0, p0, u0, g0
    for _ in range(num_steps):
        p = p - 0.5 * eps * g
        q = q + eps * (im * p)
        u, g = pot_grad(q)
        p = p - 0.5 * eps * g
    # the kinetic energy is even in p: the flipped proposal has e1 too
    e1 = torch.clamp(u + ke(p), NEG_INF, -NEG_INF)
    delta = e0 - e1
    delta = torch.clamp(torch.where(torch.isnan(delta), NEG_INF, delta),
                        NEG_INF, -NEG_INF)
    div = (torch.abs(delta) > divergence_threshold).to(q0.dtype)
    p_acc = torch.clamp(torch.exp(delta), max=1.0)
    acc = u_acc < p_acc
    zero = torch.zeros_like(u0)
    stats = torch.cat([torch.where(acc, e1, e0), p_acc, zero,
                       zero + float(num_steps), div, zero, zero, zero], dim=0)
    # true selects: a rejected proposal may carry inf positions
    return (torch.where(acc, q, q0), torch.where(acc, u, u0),
            torch.where(acc, g, g0), torch.where(acc, p, -p0), stats)


def _row(x, num_chains, device) -> torch.Tensor:
    """A scalar or per-chain ``(chains,)`` parameter as a ``(1, C)`` row.
    A scalar from the host is filled on the device: copying it there would
    synchronize the stream on every launch."""
    on_device = isinstance(x, torch.Tensor) and x.device == device
    if not on_device and torch.as_tensor(x).numel() == 1:
        return torch.full((1, num_chains), float(x), dtype=torch.float32,
                          device=device)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if x.numel() == 1:
        return x.reshape(1, 1).expand(1, num_chains)
    return x.reshape(1, num_chains)


def _im_t(inverse_mass, dim, num_chains, device) -> torch.Tensor:
    """The diagonal ``M⁻¹`` as a ``(dim, 1)`` column (shared) or
    ``(dim, C)`` (per chain, given as ``(chains, dim)``)."""
    im = torch.as_tensor(inverse_mass, dtype=torch.float32, device=device)
    if im.ndim == 2:
        if tuple(im.shape) != (num_chains, dim):
            raise ValueError(
                f"a 2-d inverse_mass is a per-chain diagonal (chains, dim) = "
                f"{(num_chains, dim)}, got {tuple(im.shape)}; the GHMC kernels "
                "take no dense metric"
            )
        return im.T
    return im.reshape(dim, 1)


def ghmc_transition_plain(q_t, u, g_t, p_t, step_size, alpha, inverse_mass,
                          pot_grad, *, num_steps: int = 1,
                          divergence_threshold: float = 1000.0, noise=None,
                          u_accept=None, seed=None, chain_offset: int = 0):
    """Plain version of kernel 5, transposed layout on any device.

    Either ``noise (dim, C) ~ N(0, M)`` and ``u_accept (1, C)``, or a Philox
    ``seed`` (u32), whose streams are :func:`ghmc_streams` of the global
    chains ``chain_offset ..``.  Returns ``(q_t,
    u (1, C), g_t, p_t, stats (8, C))``.
    """
    dim, num_chains = q_t.shape
    device = q_t.device
    im = _im_t(inverse_mass, dim, num_chains, device)
    if seed is not None:
        z, u_accept = ghmc_streams(seed, num_chains, dim, device=device,
                                   chain_offset=chain_offset)
        noise = torch.sqrt(1.0 / im) * z
    return _ghmc_core_t(
        q_t, u.reshape(1, num_chains), g_t, p_t, noise,
        u_accept.reshape(1, num_chains), _row(step_size, num_chains, device),
        _row(alpha, num_chains, device), im,
        _clamped(pot_grad, num_chains), num_steps=num_steps,
        divergence_threshold=divergence_threshold,
    )


def ghmc_segment_plain(q_t, u, g_t, p_t, step_size, alpha, inverse_mass,
                       pot_grad, num_draws: int, *, num_steps: int = 1,
                       divergence_threshold: float = 1000.0, noise=None,
                       u_accept=None, seed=None, collect_positions=True):
    """Plain version of kernel 6: ``num_draws`` plain transitions, draw ``t``
    taking ``noise[t] (dim, C)`` and ``u_accept[t] (C,)`` or the key ``seed
    + t·DRAW_SEED_STRIDE``.  Returns ``(positions_t (draws, dim, C) or None,
    stats (draws, 8, C), q_t, u, g_t, p_t)``."""
    positions, stats = [], []
    for t in range(num_draws):
        rand = (dict(seed=(seed + t * DRAW_SEED_STRIDE) & MASK32)
                if seed is not None
                else dict(noise=noise[t], u_accept=u_accept[t]))
        q_t, u, g_t, p_t, st = ghmc_transition_plain(
            q_t, u, g_t, p_t, step_size, alpha, inverse_mass, pot_grad,
            num_steps=num_steps, divergence_threshold=divergence_threshold,
            **rand,
        )
        if collect_positions:
            positions.append(q_t)
        stats.append(st)
    pos = torch.stack(positions) if collect_positions else None
    return pos, torch.stack(stats), q_t, u, g_t, p_t


def _to_kernel_layout(transposed_io: bool) -> Callable:
    """A ``(chains, dim)`` tensor (or None) to the kernels' ``(dim,
    chains)``; the identity with ``transposed_io``."""
    if transposed_io:
        return lambda x: x
    return lambda x: None if x is None else x.T.contiguous()


def make_fused_ghmc_transition(
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor] = (),
    *,
    divergence_threshold: float = 1000.0,
    num_integration_steps: int = 1,
    potential_and_grad_t: Callable = None,
    transposed_io: bool = False,
    block_chains: int = None,
) -> Callable:
    """Fused whole-transition GHMC (kernel 5 on the card).

    Returns ``transition(q, potential, grad, momentum, step_size, alpha,
    inverse_mass, noise=None, u_accept=None, seed=None, chain_offset=0) ->
    (q', potential', grad', momentum', stats)`` like the JAX builder:
    ``(chains, dim)`` state, ``potential (chains, 1)`` out, ``noise ~ N(0,
    M)`` ``(chains, dim)``, ``u_accept (chains,)``, stats ``(chains, 8)``.
    ``seed`` (a u32 int) selects Philox randomness, chain c drawing global
    chain ``chain_offset + c``'s streams (a shard's offset).
    ``transposed_io=True`` keeps the kernel's own layout throughout
    (``(dim, chains)`` state and noise, ``(1, chains)`` potential and
    ``u_accept``, stats ``(8, chains)``).
    ``block_chains`` has no effect (a CUDA block holds 8 chains).
    """
    from aehmc_tpu_torch.parallel.mesh import device_replicas

    data = tuple(data)
    pot_grad = _pot_grad_builder_t(potential_fn_t, potential_and_grad_t, data)
    to_t = _to_kernel_layout(transposed_io)
    data_on = device_replicas(data)

    def transition(q, potential, grad, momentum, step_size, alpha,
                   inverse_mass, noise=None, u_accept=None, seed=None,
                   chain_offset=0):
        q_t, g_t, p_t, noise_t = (to_t(x) for x in (q, grad, momentum, noise))
        num_chains = q_t.shape[1]
        rand = dict(noise=noise_t, u_accept=u_accept, seed=seed,
                    chain_offset=chain_offset)
        if q_t.is_cuda:
            out = ghmc_transition_cuda(
                q_t, potential, g_t, p_t, step_size, alpha, inverse_mass,
                data_on(q_t.device), num_steps=num_integration_steps,
                divergence_threshold=divergence_threshold,
                potential_and_grad_t=potential_and_grad_t,
                potential_fn_t=potential_fn_t, **rand,
            )
        else:
            out = ghmc_transition_plain(
                q_t, potential, g_t, p_t, step_size, alpha, inverse_mass,
                pot_grad, num_steps=num_integration_steps,
                divergence_threshold=divergence_threshold, **rand,
            )
        qn, un, gn, pn, stats = out
        if transposed_io:
            return out
        return qn.T, un.reshape(num_chains, 1), gn.T, pn.T, stats.T

    return transition


def fused_ghmc_segment(
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor] = (),
    *,
    divergence_threshold: float = 1000.0,
    num_integration_steps: int = 1,
    potential_and_grad_t: Callable = None,
    transposed_io: bool = False,
    block_chains: int = None,
) -> Callable:
    """The multi-draw fused GHMC sampler (kernel 6 on the card).

    Returns ``segment(q, potential, grad, momentum, step_size, alpha,
    inverse_mass, num_draws, noise=None, u_accept=None, seed=None,
    collect_positions=True) -> (positions, stats, q', potential', grad',
    momentum')`` like the JAX builder: ``positions (draws, chains, dim)``,
    ``stats (draws, chains, 8)``, ``noise (draws, chains, dim)``,
    ``u_accept (draws, chains)``.  The final state equals ``num_draws``
    transitions of :func:`make_fused_ghmc_transition`.  ``transposed_io``
    keeps the kernel's layout: ``noise (draws, dim, chains)``, positions
    ``(draws, dim, chains)``, stats ``(draws, 8, chains)``.
    ``block_chains`` has no effect (a CUDA block holds 8 chains).
    """
    data = tuple(data)
    pot_grad = _pot_grad_builder_t(potential_fn_t, potential_and_grad_t, data)
    to_t = _to_kernel_layout(transposed_io)

    def segment(q, potential, grad, momentum, step_size, alpha, inverse_mass,
                num_draws, noise=None, u_accept=None, seed=None,
                collect_positions=True):
        q_t, g_t, p_t = (to_t(x) for x in (q, grad, momentum))
        if noise is not None and not transposed_io:
            noise = noise.transpose(1, 2).contiguous()
        num_chains = q_t.shape[1]
        kw = dict(num_steps=num_integration_steps,
                  divergence_threshold=divergence_threshold, noise=noise,
                  u_accept=u_accept, seed=seed,
                  collect_positions=collect_positions)
        if q_t.is_cuda:
            out = ghmc_segment_cuda(q_t, potential, g_t, p_t, step_size,
                                    alpha, inverse_mass, data, num_draws,
                                    potential_and_grad_t=potential_and_grad_t,
                                    potential_fn_t=potential_fn_t, **kw)
        else:
            out = ghmc_segment_plain(q_t, potential, g_t, p_t, step_size,
                                     alpha, inverse_mass, pot_grad, num_draws,
                                     **kw)
        if transposed_io:
            return out
        pos_t, stats, qn, un, gn, pn = out
        pos = None if pos_t is None else pos_t.transpose(1, 2)
        return (pos, stats.transpose(1, 2), qn.T, un.reshape(num_chains, 1),
                gn.T, pn.T)

    return segment


def _meads_operands(fold_states, hyper):
    """The flat ``(chains, ...)`` state of MEADS's folded states and its
    per-chain ε, α and ``(chains, dim)`` M⁻¹ (each fold's repeated for its
    chains)."""
    num_folds, per_fold = fold_states.position.shape[:2]
    num_chains = num_folds * per_fold

    def flat(a):
        return a.reshape((num_chains,) + a.shape[2:])

    def tile(a):
        return torch.repeat_interleave(a.to(torch.float32), per_fold, dim=0)

    state = tuple(flat(a).to(torch.float32) for a in (
        fold_states.position, fold_states.potential_energy,
        fold_states.potential_energy_grad, fold_states.momentum))
    return state, (tile(hyper.step_size), tile(hyper.alpha),
                   tile(hyper.inverse_mass_matrix))


def _meads_infos(stats: torch.Tensor, refold: Callable) -> Diagnostics:
    """MEADS's ``Diagnostics`` from the kernels' stats columns ``[energy,
    accept, 0, steps, diverging, ...]`` (last axis), refolded."""
    accept = stats[..., 1]
    return Diagnostics(
        acceptance_probability=refold(accept),
        num_doublings=refold(torch.zeros(accept.shape, dtype=torch.int32,
                                         device=accept.device)),
        is_turning=refold(torch.zeros(accept.shape, dtype=torch.bool,
                                      device=accept.device)),
        is_diverging=refold(stats[..., 4] > 0.5),
        energy=refold(stats[..., 0]),
        num_integration_steps=refold(stats[..., 3].to(torch.int32)),
    )


def shard_fused_ghmc_transition(
    transition: Callable,
    mesh,
    num_chains: int,
    block_chains: int = None,
    *,
    transposed_io: bool = False,
) -> Callable:
    """A fused GHMC transition (:func:`make_fused_ghmc_transition`) run
    per shard of the chain axis over ``mesh``, with the same signature
    (port of the JAX ``shard_fused_ghmc_transition``): the state, external
    randomness and every per-chain ε, α and ``(chains, dim)`` M⁻¹ are
    sharded with the chains, a scalar or shared value replicated, and
    under a Philox ``seed`` each shard draws its global chains' streams, so
    the joined outputs equal the unsharded transition's bit for bit on the
    card.  ``transposed_io`` as the builder's.  Raises ``ValueError`` as
    :func:`aehmc_tpu_torch.parallel.mesh.chain_shards` does.
    """
    from aehmc_tpu_torch.parallel.mesh import (
        ROWS,
        SHARDED,
        VECTOR,
        chain_shards,
        map_shards,
    )

    shards = chain_shards(mesh, num_chains, block_chains)
    axis = -1 if transposed_io else 0
    spec = (SHARDED,) * 4 + (VECTOR, VECTOR, ROWS, SHARDED, SHARDED)

    def sharded(q, potential, grad, momentum, step_size, alpha,
                inverse_mass, noise=None, u_accept=None, seed=None,
                chain_offset=0):
        values = (q, potential, grad, momentum, step_size, alpha,
                  inverse_mass, noise, u_accept)
        return map_shards(
            lambda s: transition(*s.args(spec, values, axis), seed=seed,
                                 chain_offset=chain_offset + s.start),
            shards, q.device, axis)

    return sharded


def make_fused_meads_transition(
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor] = (),
    *,
    divergence_threshold: float = 1000.0,
    block_chains: int = None,
    potential_and_grad_t: Callable = None,
    use_internal_prng: bool = True,
    mesh=None,
    num_chains: int = None,
) -> Callable:
    """Kernel 5 under the MEADS fold-transition contract:
    ``transition(key, fold_states, hyper) -> (fold_states', infos)`` with
    ``fold_states`` an :class:`~aehmc_tpu_torch.types.IntegratorState`
    batched ``(num_folds, per_fold, ...)`` and ``hyper`` the per-fold
    :class:`aehmc_tpu_torch.meads.MeadsHyperparams`.  Plug it into
    ``meads.sample(transition_fn=...)`` or ``sample_sharded(algorithm=
    "meads", meads_transition_fn=...)``.

    With ``use_internal_prng`` the kernel draws its streams from the key's
    Philox seed (a ``Key``, an int or a ``torch.Generator``, one draw of
    it): the streams the XLA fold transition draws under the same
    ``Key``.  Otherwise the raw normals ``z (chains, dim)`` and uniforms
    ``(chains,)`` are passed in: the key's Philox streams drawn outside the
    kernel, or a ``(z, u)`` pair as it is; the noise is ``√(1/M⁻¹)·z``.
    ``mesh`` (with ``num_chains``, the total chain count) runs the kernel
    per shard (:func:`shard_fused_ghmc_transition`); ``block_chains``
    otherwise has no effect (a CUDA block holds 8 chains).
    """
    base = make_fused_ghmc_transition(
        potential_fn_t, data, divergence_threshold=divergence_threshold,
        num_integration_steps=1, potential_and_grad_t=potential_and_grad_t,
    )
    if mesh is not None:
        if num_chains is None:
            raise ValueError(
                "mesh sharding needs num_chains (the TOTAL chain count) "
                "to fix the shards' chain offsets"
            )
        base = shard_fused_ghmc_transition(base, mesh, num_chains,
                                           block_chains)

    def transition(key, fold_states, hyper):
        num_folds, per_fold = fold_states.position.shape[:2]
        (q, u, g, p), (eps_c, alpha_c, imm_c) = _meads_operands(fold_states,
                                                                hyper)
        if use_internal_prng:
            seed, chain_offset = keys.as_key(key)
            rand = dict(seed=seed, chain_offset=chain_offset)
        else:
            z, u_acc = keys.normals_and_uniform(key, q)
            rand = dict(noise=torch.sqrt(1.0 / imm_c) * z, u_accept=u_acc)
        qn, un, gn, pn, stats = base(q, u, g, p, eps_c, alpha_c, imm_c,
                                     **rand)

        def refold(a):
            return a.reshape((num_folds, per_fold) + a.shape[1:])

        new_states = type(fold_states)(
            position=refold(qn), momentum=refold(pn),
            potential_energy=refold(un[:, 0]),
            potential_energy_grad=refold(gn))
        return new_states, _meads_infos(stats, refold)

    transition.mesh = mesh
    return transition


def make_fused_meads_segment(
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor] = (),
    *,
    divergence_threshold: float = 1000.0,
    block_chains: int = None,
    potential_and_grad_t: Callable = None,
    use_internal_prng: bool = True,
    mesh=None,
) -> Callable:
    """Kernel 6 under the MEADS segment contract: ``segment(key,
    fold_states, hyper, num_draws, collect=True) -> (fold_states',
    (positions, infos))``, a whole fixed-hyperparameter segment of
    :func:`aehmc_tpu_torch.meads._sample_segmented` in one launch.
    ``positions`` is ``(num_draws, folds, per_fold, dim)`` (None unless
    ``collect``) and ``infos`` the per-draw ``Diagnostics``.

    Draw ``t`` of the segment takes the Philox key ``seed +
    t·DRAW_SEED_STRIDE`` of the key's seed, in the kernel
    (``use_internal_prng``) or drawn outside it; a ``(z, u)`` pair gives
    the raw normals ``(draws, chains, dim)`` and uniforms ``(draws,
    chains)`` as they are.  There is no sharded segment (nor in the JAX
    package): a ``mesh`` raises ``ValueError``; the MEADS transition
    (:func:`make_fused_meads_transition`) takes one.
    """
    if mesh is not None:
        raise ValueError(
            "the fused MEADS segment kernel has no shard adapter (nor has "
            "the JAX package's): with a mesh, use "
            "make_fused_meads_transition(mesh=..., num_chains=...)")
    seg = fused_ghmc_segment(
        potential_fn_t, data, divergence_threshold=divergence_threshold,
        num_integration_steps=1, potential_and_grad_t=potential_and_grad_t,
    )

    def segment(key, fold_states, hyper, num_draws, collect=True):
        num_folds, per_fold, dim = fold_states.position.shape
        num_chains = num_folds * per_fold
        (q, u, g, p), (eps_c, alpha_c, imm_c) = _meads_operands(fold_states,
                                                                hyper)
        if isinstance(key, tuple) and not isinstance(key, keys.Key):
            z, u_acc = (torch.as_tensor(x, dtype=torch.float32,
                                        device=q.device) for x in key)
            rand = dict(noise=torch.sqrt(1.0 / imm_c)[None] * z,
                        u_accept=u_acc)
        elif use_internal_prng:
            rand = dict(seed=keys.as_key(key).seed)
        else:
            seed = keys.as_key(key).seed
            draws = [ghmc_streams((seed + t * DRAW_SEED_STRIDE) & MASK32,
                                  num_chains, dim, device=q.device)
                     for t in range(num_draws)]
            z = torch.stack([zt.T for zt, _ in draws])
            rand = dict(noise=torch.sqrt(1.0 / imm_c)[None] * z,
                        u_accept=torch.stack([ua[0] for _, ua in draws]))
        pos, stats, qn, un, gn, pn = seg(
            q, u, g, p, eps_c, alpha_c, imm_c, num_draws,
            collect_positions=collect, **rand)

        def refold(a):  # (chains, ...) -> (folds, per_fold, ...)
            return a.reshape((num_folds, per_fold) + a.shape[1:])

        def refold_d(a):  # (draws, chains, ...) -> (draws, folds, pf, ...)
            return a.reshape((a.shape[0], num_folds, per_fold) + a.shape[2:])

        new_states = type(fold_states)(
            position=refold(qn), momentum=refold(pn),
            potential_energy=refold(un[:, 0]),
            potential_energy_grad=refold(gn))
        positions = refold_d(pos) if collect else None
        return new_states, (positions, _meads_infos(stats, refold_d))

    return segment


# ---------------------------------------------------------------- CUDA ----

def _ptr(t):
    return None if t is None else t.data_ptr()


def _row_or_scalar(x, num_chains, device):
    """A per-chain parameter for the kernels: ``(None, value)`` for a host
    scalar, which the kernel takes as a launch argument (no fill on the
    card), else ``((C,) row, 0.0)``."""
    on_device = isinstance(x, torch.Tensor) and x.device == device
    if not on_device and torch.as_tensor(x).numel() == 1:
        return None, float(x)
    return _row(x, num_chains, device).reshape(num_chains).contiguous(), 0.0


def _potential_operands(functor, data, dim, device):
    """The potential's operands of an HMC-core launch (kernels 5-7) and X's
    type: the logistic functor's y as a float32 ``(N,)`` row (X checked:
    float32 or bfloat16, ``(N, dim)``); none for a generated functor (its
    data table is built at the launch, :func:`generic_pg.launch_operands`)."""
    from aehmc_tpu_torch.ops._build import require_f32_cuda, require_x_cuda

    ops, x_dtype = {}, torch.float32
    if functor == "logistic":
        X, _, y = data
        num_points = X.shape[0]
        require_x_cuda(X, num_points, dim, device)
        ops["y"] = y.reshape(num_points)
        require_f32_cuda("y", ops["y"], (num_points,), device)
        x_dtype = X.dtype
    return ops, x_dtype


def _hmc_launcher(kernel, functor, bound, data, ops, plan, dim, num_chains,
                 device):
    """``(library, launcher, potential arguments, sizes, tensors to keep
    alive)`` of ``kernel`` ("ghmc_transition", "ghmc_segment" or
    "chees_transition") on ``functor``: the logistic entry point (X, its
    type, y; sizes dim, N, C), or the generated functor's in its own
    library (``*_generic_*``: the data table and workspace; dim, C)."""
    from aehmc_tpu_torch.ops._build import load_kernels

    if functor == "generic":
        from aehmc_tpu_torch.ops.generic_pg import launch_operands

        lib = bound.library()
        table, keep = launch_operands(bound, data, device, plan.blocks)
        return (lib, getattr(lib, f"{kernel}_generic_launch"), table,
                (dim, num_chains), keep)
    lib = load_kernels("chees_fused.cu" if kernel.startswith("chees")
                       else "ghmc_fused.cu")
    X = ops["X"]
    return (lib, getattr(lib, f"{kernel}_launch"),
            (_ptr(X), int(X.dtype == torch.bfloat16), _ptr(ops["y"])),
            (dim, X.shape[0], num_chains), None)


def _cuda_operands(q_t, u, g_t, p_t, step_size, alpha, inverse_mass, data,
                   functor="logistic", bound=None):
    """Validate and normalise the operands shared by both kernels, and plan
    the launch for ``functor`` (for the logistic one X's dtype, float32 or
    bfloat16, picks its operands; a generated one, ``bound``, brings its
    workspace); returns ``(operands, (eps0, alpha0), im_per_chain, plan,
    (dim, C))``: ``operands["eps"]`` and ``["alpha"]`` are None for host
    scalars, whose values are ``eps0`` and ``alpha0``."""
    from aehmc_tpu_torch.ops._build import require_f32_cuda

    dim, num_chains = q_t.shape
    device = q_t.device
    im = _im_t(inverse_mass, dim, num_chains, device)
    per_chain = im.shape[1] > 1
    eps, eps0 = _row_or_scalar(step_size, num_chains, device)
    alpha, alpha0 = _row_or_scalar(alpha, num_chains, device)
    ops = dict(
        q=q_t, u=u.reshape(1, num_chains), g=g_t, p=p_t, eps=eps,
        alpha=alpha,
        im=im.contiguous() if per_chain else im.reshape(dim).contiguous(),
    )
    shapes = dict(q=(dim, num_chains), u=(1, num_chains), g=(dim, num_chains),
                  p=(dim, num_chains), eps=(num_chains,),
                  alpha=(num_chains,),
                  im=(dim, num_chains) if per_chain else (dim,))
    for name, t in ops.items():
        if t is not None:
            require_f32_cuda(name, t, shapes[name], device)
    pot_ops, x_dtype = _potential_operands(functor, data, dim, device)
    ops.update(pot_ops)
    plan = launch_plan("hmc", dim, 0, num_chains, x_dtype, functor,
                       geometry=None if bound is None else bound.geometry)
    if functor == "logistic":
        ops["X"] = data_rows(data[0], plan.row_stride, x_dtype)
    return ops, (eps0, alpha0), per_chain, plan, (dim, num_chains)


def _external(noise, u_accept, shape, seed, device):
    """Pointers of the external streams (null under a Philox seed)."""
    from aehmc_tpu_torch.ops._build import require_f32_cuda

    if seed is not None:
        return None, None
    require_f32_cuda("noise", noise, shape, device)
    u_accept = u_accept.reshape(*shape[:-2], shape[-1])
    require_f32_cuda("u_accept", u_accept, u_accept.shape, device)
    return noise.data_ptr(), u_accept.data_ptr()


def ghmc_transition_cuda(q_t, u, g_t, p_t, step_size, alpha, inverse_mass,
                         data, *, num_steps: int = 1,
                         divergence_threshold: float = 1000.0, noise=None,
                         u_accept=None, seed=None, chain_offset: int = 0,
                         potential_and_grad_t=logistic_pg_t,
                         potential_fn_t=None):
    """Launch kernel 5 (``ghmc_transition``) on CUDA tensors with the
    functor of the potential (:func:`functors.card_functor` on
    :data:`functors.HMC_CORE`: the logistic one by default); returns
    ``(q_t, u (1, C), g_t, p_t, stats (8, C))``.  With a ``seed``, chain c
    draws global chain ``chain_offset + c``'s streams."""
    from aehmc_tpu_torch.ops._build import check_launch

    functor, bound, suffix = card_functor(
        potential_fn_t, potential_and_grad_t, data, q_t, HMC_CORE)
    ops, scalars, per_chain, plan, (dim, num_chains) = _cuda_operands(
        q_t, u, g_t, p_t, step_size, alpha, inverse_mass, data, functor,
        bound)
    device = q_t.device
    noise_p, ua_p = _external(noise, u_accept, (dim, num_chains), seed, device)
    q_out, g_out, p_out = (torch.empty_like(q_t) for _ in range(3))
    u_out = torch.empty((1, num_chains), dtype=torch.float32, device=device)
    stats = torch.empty((8, num_chains), dtype=torch.float32, device=device)
    lib, launcher, pot, sizes, keep = _hmc_launcher(
        "ghmc_transition", functor, bound, data, ops, plan, dim, num_chains,
        device)
    with torch.cuda.device(device):
        err = launcher(
            _ptr(ops["q"]), _ptr(ops["u"]), _ptr(ops["g"]), _ptr(ops["p"]),
            noise_p, ua_p, int(seed is not None),
            0 if seed is None else int(seed) & MASK32, int(chain_offset),
            *pot, _ptr(ops["eps"]), _ptr(ops["alpha"]), *scalars,
            _ptr(ops["im"]), int(per_chain), float(divergence_threshold),
            *sizes, int(num_steps), _ptr(q_out), _ptr(u_out), _ptr(g_out),
            _ptr(p_out), _ptr(stats), *plan.args(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(lib, err, "ghmc_transition")
    del keep
    LAUNCHES["ghmc_transition" + suffix] += 1
    return q_out, u_out, g_out, p_out, stats


def ghmc_segment_cuda(q_t, u, g_t, p_t, step_size, alpha, inverse_mass, data,
                      num_draws: int, *, num_steps: int = 1,
                      divergence_threshold: float = 1000.0, noise=None,
                      u_accept=None, seed=None, collect_positions=True,
                      potential_and_grad_t=logistic_pg_t,
                      potential_fn_t=None):
    """Launch kernel 6 (``ghmc_segment``): ``num_draws`` transitions in one
    launch, with the functor of the potential as kernel 5.  Positions are
    written as ``(draws, C, dim)`` (a chain's row contiguous) and returned
    as the ``(draws, dim, C)`` view of the transposed contract; stats are
    ``(draws, 8, C)``."""
    from aehmc_tpu_torch.ops._build import check_launch

    functor, bound, suffix = card_functor(
        potential_fn_t, potential_and_grad_t, data, q_t, HMC_CORE)
    ops, scalars, per_chain, plan, (dim, num_chains) = _cuda_operands(
        q_t, u, g_t, p_t, step_size, alpha, inverse_mass, data, functor,
        bound)
    device = q_t.device
    noise_p, ua_p = _external(noise, u_accept, (num_draws, dim, num_chains),
                              seed, device)
    pos = (torch.empty((num_draws, num_chains, dim), dtype=torch.float32,
                       device=device) if collect_positions else None)
    stats = torch.empty((num_draws, 8, num_chains), dtype=torch.float32,
                        device=device)
    q_out, g_out, p_out = (torch.empty_like(q_t) for _ in range(3))
    u_out = torch.empty((1, num_chains), dtype=torch.float32, device=device)
    lib, launcher, pot, sizes, keep = _hmc_launcher(
        "ghmc_segment", functor, bound, data, ops, plan, dim, num_chains,
        device)
    with torch.cuda.device(device):
        err = launcher(
            _ptr(ops["q"]), _ptr(ops["u"]), _ptr(ops["g"]), _ptr(ops["p"]),
            noise_p, ua_p, int(seed is not None),
            0 if seed is None else int(seed) & MASK32, int(num_draws), *pot,
            _ptr(ops["eps"]), _ptr(ops["alpha"]), *scalars, _ptr(ops["im"]),
            int(per_chain), float(divergence_threshold), *sizes,
            int(num_steps), _ptr(pos), _ptr(stats), _ptr(q_out), _ptr(u_out),
            _ptr(g_out), _ptr(p_out), *plan.args(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(lib, err, "ghmc_segment")
    del keep
    LAUNCHES["ghmc_segment" + suffix] += 1
    pos_t = None if pos is None else pos.permute(0, 2, 1)
    return pos_t, stats, q_out, u_out, g_out, p_out
