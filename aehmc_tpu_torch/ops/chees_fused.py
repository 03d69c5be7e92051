"""Fused ChEES-HMC transition: the plain PyTorch version and the wrapper of
kernel 7 (``csrc/chees_fused.cu``, ``csrc/hmc_generic.cu``), the
``kernel_fn`` adapter of :mod:`aehmc_tpu_torch.chees`, and the one-call
driver (port of :mod:`aehmc_tpu.ops.chees_fused`).

A transition draws a momentum ``p ~ N(0, M)``, takes ``num_steps``
velocity-Verlet steps, all chains the same number, and accepts by
Metropolis-Hastings (a divergence, ``|ΔE| > threshold``, does not veto the
accept draw).  Besides the kept state and the stats ``[energy, accept_prob,
0, num_steps, is_diverging, 0, 0, 0]`` it returns the proposed endpoint
position and velocity ``M⁻¹ p_L`` of every chain, accepted or not: the
ChEES gradient reads them.  ``step_size`` is a scalar or per chain,
``inverse_mass`` a diagonal ``(dim,)`` or dense ``(dim, dim)``.  Randomness
is external (``momentum`` and ``u_accept``) or a Philox ``seed`` with the
GHMC streams (:func:`aehmc_tpu_torch.ops.philox.ghmc_streams`).

Dispatch is by the device of the chain state: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises.  The kernel computes
the potential in the device functor the GHMC kernels take
(:func:`aehmc_tpu_torch.ops.functors.card_functor`): the logistic
regression's, or one generated from any other float32 potential's traced
gradient graph; launches count as ``chees_transition`` and
``chees_transition_generic``.  On the card
``num_steps`` may be a device int32, read by the kernel, so the driver's
trip count never synchronises the stream.  :func:`shard_fused_chees_transition`
runs the transition per shard of a device mesh (``mesh=`` of the kernel
adapter and the driver).
"""

from typing import Callable, Sequence

import torch

from aehmc_tpu_torch import chees, keys
from aehmc_tpu_torch.models.regression import logistic_pg_t
from aehmc_tpu_torch.ops.functors import HMC_CORE, card_functor
from aehmc_tpu_torch.ops.ghmc_fused import (
    _row,
    _hmc_launcher,
    _potential_operands,
)
from aehmc_tpu_torch.ops.launch_plan import data_rows, launch_plan
from aehmc_tpu_torch.ops.launches import LAUNCHES
from aehmc_tpu_torch.ops.nuts_fused_small import (
    NEG_INF,
    _clamped,
    _mass_sqrt,
    _pot_grad_builder_t,
    derive_draw_seeds,
)
from aehmc_tpu_torch.ops.philox import MASK32, ghmc_streams
from aehmc_tpu_torch.types import ChainState


def _chees_core_t(q0, u0, g0, p0, u_acc, eps, num_steps: int, apply_im,
                  pot_grad, *, divergence_threshold: float):
    """One ChEES transition of a batch of chains (plain PyTorch), in the
    operations and order of the JAX kernel body.

    ``q0, g0, p0`` are ``(dim, C)``; ``u0, u_acc`` ``(1, C)``; ``eps`` a
    ``(1, C)`` row; ``apply_im(p)`` is ``M⁻¹ p``; ``pot_grad(q) -> (u (1, C),
    g (dim, C))`` already clamped.  Returns ``(q, u, g, stats (8, C), q_L,
    v_L)``.
    """
    def ke(p):
        return 0.5 * torch.sum(p * apply_im(p), dim=0, keepdim=True)

    e0 = u0 + ke(p0)
    q, p, u, g = q0, p0, u0, g0
    for _ in range(num_steps):
        p = p - 0.5 * eps * g
        q = q + eps * apply_im(p)
        u, g = pot_grad(q)
        p = p - 0.5 * eps * g
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
            torch.where(acc, g, g0), stats, q, apply_im(p))


def chees_transition_plain(q, u, g, inverse_mass, step_size, num_steps,
                           pot_grad_t, *, divergence_threshold: float = 1000.0,
                           momentum=None, u_accept=None, seed=None,
                           chain_offset: int = 0):
    """Plain version of kernel 7 on any device, in the builder's layout:
    ``q, g, momentum (C, dim)``, ``u`` and ``u_accept (C,)`` (or ``(C,
    1)``), ``pot_grad_t(q_t) -> (u, g_t)`` transposed.  ``seed`` (u32)
    replaces ``momentum`` and ``u_accept`` by the Philox streams of the
    global chains ``chain_offset ..``.  Returns
    ``(q, u (C, 1), g, stats (C, 8), q_proposed, v_proposed)``."""
    num_chains, dim = q.shape
    device = q.device
    im = torch.as_tensor(inverse_mass, dtype=torch.float32, device=device)
    if im.ndim == 2:
        def apply_im(p):
            return im @ p
    else:
        im_col = im.reshape(-1, 1).expand(dim, 1)

        def apply_im(p):
            return im_col * p
    if seed is not None:
        z, u_acc = ghmc_streams(seed, num_chains, dim, device=device,
                                chain_offset=chain_offset)
        p0 = _mass_sqrt(im) @ z if im.ndim == 2 else torch.sqrt(1.0 / im_col) * z
    else:
        p0 = momentum.T
        u_acc = u_accept.reshape(1, num_chains)
    out = _chees_core_t(
        q.T, u.reshape(1, num_chains), g.T, p0, u_acc,
        _row(step_size, num_chains, device), int(num_steps), apply_im,
        _clamped(pot_grad_t, num_chains),
        divergence_threshold=divergence_threshold,
    )
    qn, un, gn, stats, qp, vp = out
    return qn.T, un.reshape(num_chains, 1), gn.T, stats.T, qp.T, vp.T


def make_fused_chees_transition(
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor] = (),
    *,
    divergence_threshold: float = 1000.0,
    block_chains: int = 1024,
    potential_and_grad_t: Callable = None,
) -> Callable:
    """Fused whole-transition ChEES (kernel 7 on the card).

    Returns ``transition(q, potential, grad, momentum, u_accept,
    inverse_mass, step_size, num_steps, seed=None) -> (q', potential' (C,
    1), grad', stats (C, 8), q_proposed, v_proposed)`` in the ``(chains,
    dim)`` layout, as the JAX builder.  ``num_steps`` is the trip count
    shared by all chains (an int or an int32 tensor); ``seed`` (a u32 int)
    selects Philox randomness, chain c drawing global chain ``chain_offset
    + c``'s streams (``transition(..., seed=s, chain_offset=o)``, a
    shard's offset), else ``momentum (C, dim)`` and ``u_accept (C,)`` are
    used.  ``block_chains`` has no effect: a CUDA block holds 8
    chains, and the Philox streams follow the global chain index.
    """
    from aehmc_tpu_torch.parallel.mesh import device_replicas

    data = tuple(data)
    pot_grad_t = _pot_grad_builder_t(potential_fn_t, potential_and_grad_t, data)
    data_on = device_replicas(data)

    def transition(q, potential, grad, momentum, u_accept, inverse_mass,
                   step_size, num_steps, seed=None, chain_offset=0):
        if q.is_cuda:
            return chees_transition_cuda(
                q.contiguous(), potential, grad.contiguous(), inverse_mass,
                step_size, num_steps, data_on(q.device),
                divergence_threshold=divergence_threshold, seed=seed,
                chain_offset=chain_offset,
                momentum=None if momentum is None else momentum.contiguous(),
                u_accept=u_accept, potential_and_grad_t=potential_and_grad_t,
                potential_fn_t=potential_fn_t,
            )
        rand = dict(momentum=momentum, u_accept=u_accept, seed=seed,
                    chain_offset=chain_offset)
        return chees_transition_plain(
            q, potential, grad, inverse_mass, step_size, num_steps,
            pot_grad_t, divergence_threshold=divergence_threshold, **rand,
        )

    return transition


def _randomness(key, use_internal_prng: bool, num_chains: int, dim: int,
                device):
    """One call's randomness from ``key``: a ``torch.Generator`` gives a
    Philox seed (``use_internal_prng``) or the standard normals ``z (C,
    dim)`` and uniforms ``u (C,)``; a key given as an int seed or a ``(z,
    u)`` pair is used as it is; a :class:`~aehmc_tpu_torch.keys.Key` (a
    shard's, :func:`aehmc_tpu_torch.parallel.pooled.shard_kernel`) gives
    ``(seed, chain_offset)``."""
    if isinstance(key, keys.Key):
        if not use_internal_prng:
            raise TypeError("a Key is a Philox seed: it needs "
                            "use_internal_prng=True")
        return key
    if isinstance(key, torch.Generator):
        if use_internal_prng:
            return derive_draw_seeds(key, 1)[0]
        kw = dict(generator=key, device=key.device)
        return (torch.randn((num_chains, dim), **kw).to(device),
                torch.rand((num_chains,), **kw).to(device))
    if use_internal_prng != isinstance(key, int):
        raise TypeError(
            "a key is a torch.Generator, an int Philox seed "
            "(use_internal_prng=True) or a (z, u_accept) pair "
            f"(use_internal_prng=False), got {type(key).__name__}"
        )
    return key


def shard_fused_chees_transition(
    transition: Callable,
    mesh,
    num_chains: int,
    block_chains: int = None,
) -> Callable:
    """A fused ChEES transition (:func:`make_fused_chees_transition`) run
    per shard of the chain axis over ``mesh``, with the same signature
    (port of the JAX ``shard_fused_chees_transition``): the state, external
    randomness and a per-chain ε are sharded, M⁻¹ and the trip count
    replicated, and under a Philox ``seed`` each shard draws its global
    chains' streams, so the joined outputs (the proposals too) equal the
    unsharded transition's bit for bit on the card.  The ChEES criterion's
    cross-chain means stay outside, over the joined chains.  Raises
    ``ValueError`` as :func:`aehmc_tpu_torch.parallel.mesh.chain_shards`
    does.
    """
    from aehmc_tpu_torch.parallel.mesh import (
        SHARDED,
        SHARED,
        VECTOR,
        chain_shards,
        map_shards,
    )

    shards = chain_shards(mesh, num_chains, block_chains)
    spec = (SHARDED,) * 5 + (SHARED, VECTOR, SHARED)

    def sharded(q, u, g, p, uacc, imm, eps, num_steps, seed=None,
                chain_offset=0):
        return map_shards(
            lambda s: transition(
                *s.args(spec, (q, u, g, p, uacc, imm, eps, num_steps)),
                seed=seed, chain_offset=chain_offset + s.start),
            shards, q.device)

    return sharded


def make_fused_chees_kernel(
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor] = (),
    *,
    divergence_threshold: float = 1000.0,
    block_chains: int = None,
    potential_and_grad_t: Callable = None,
    use_internal_prng: bool = True,
    step_size_factors=None,
    mesh=None,
    num_chains: int = None,
) -> Callable:
    """The fused transition as the ``kernel_fn(key, states, step_size,
    num_integration_steps, inverse_mass_matrix) -> (ChainState, CheesInfo)``
    of :func:`aehmc_tpu_torch.chees.warmup` and
    :func:`aehmc_tpu_torch.chees.sample`.

    ``use_internal_prng`` draws a Philox seed per call; otherwise the call
    draws standard normals ``z`` and uniforms, and the momentum is ``L⁻ᵀ z``
    (dense ``M⁻¹``) or ``√(1/M⁻¹)·z``, as the JAX adapter does.
    ``step_size_factors`` (chains,) multiplies every step size the
    adaptation proposes.  ``mesh`` (with ``num_chains``) runs the
    transition per shard (:func:`shard_fused_chees_transition`).
    """
    transition = make_fused_chees_transition(
        potential_fn_t, data, divergence_threshold=divergence_threshold,
        block_chains=block_chains, potential_and_grad_t=potential_and_grad_t,
    )
    if mesh is not None:
        if num_chains is None:
            raise ValueError("mesh= requires num_chains=")
        transition = shard_fused_chees_transition(transition, mesh,
                                                  num_chains, block_chains)

    def kernel_fn(key, states, step_size, num_integration_steps,
                  inverse_mass_matrix):
        num_chains, dim = states.position.shape
        device = states.position.device
        eps = step_size
        if step_size_factors is not None:
            eps = eps * torch.as_tensor(step_size_factors, dtype=torch.float32,
                                        device=device).reshape(num_chains)
        rand = _randomness(key, use_internal_prng, num_chains, dim, device)
        chain_offset = 0
        if use_internal_prng:
            momentum = u_acc = None
            seed, chain_offset = keys.as_key(rand)
        else:
            imm = torch.as_tensor(inverse_mass_matrix, dtype=torch.float32,
                                  device=device)
            z, u_acc = (torch.as_tensor(r, dtype=torch.float32, device=device)
                        for r in rand)
            momentum = (z @ _mass_sqrt(imm).T if imm.ndim == 2
                        else torch.sqrt(1.0 / imm) * z)
            seed = None
        qn, un, gn, stats, qp, vp = transition(
            states.position, states.potential_energy,
            states.potential_energy_grad, momentum, u_acc,
            inverse_mass_matrix, eps, num_integration_steps, seed=seed,
            chain_offset=chain_offset,
        )
        new_states = ChainState(position=qn, potential_energy=un[:, 0],
                                potential_energy_grad=gn)
        info = chees.CheesInfo(
            acceptance_probability=stats[:, 1],
            is_diverging=stats[:, 4] > 0.5,
            proposed_position=qp,
            proposed_velocity=vp,
            num_integration_steps=torch.as_tensor(num_integration_steps,
                                                  dtype=torch.int32),
            energy=stats[:, 0],
        )
        return new_states, info

    kernel_fn.mesh = mesh
    return kernel_fn


def initial_states(potential_fn_t, potential_and_grad_t, data,
                   positions) -> ChainState:
    """Chain states of ``positions (C, dim)`` from the transposed potential:
    the caller's ``potential_and_grad_t``, or autograd of
    ``potential_fn_t``."""
    pot_grad = _pot_grad_builder_t(potential_fn_t, potential_and_grad_t,
                                   tuple(data))
    q = positions.to(torch.float32)
    u, g_t = pot_grad(q.T)
    return ChainState(position=q, potential_energy=u.reshape(-1),
                      potential_energy_grad=g_t.T.contiguous())


def sample_fused_chees_adaptive(
    generator,
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor],
    initial_positions: torch.Tensor,
    num_samples: int = 1000,
    num_warmup: int = 400,
    *,
    potential_and_grad_t: Callable = None,
    divergence_threshold: float = 1000.0,
    block_chains: int = None,
    initial_step_size: float = 0.1,
    target_acceptance_rate: float = None,
    max_num_integration_steps: int = 1024,
    learning_rate: float = 0.025,
    search_initial_step_size: bool = True,
    collect_positions: bool = True,
    use_internal_prng: bool = True,
    step_size_factors=None,
    mesh=None,
):
    """One-call fused ChEES: warmup (step size, trajectory length, diagonal
    ``M⁻¹``) and sampling, both through the fused transition.

    ``generator`` is a ``torch.Generator`` or a key source ``(phase, index)
    -> key`` (:mod:`aehmc_tpu_torch.chees`).  ``mesh`` shards the chains
    over its devices (:func:`shard_fused_chees_transition`); the ChEES
    gradient's and the pooled reductions run over the joined chains, so
    the run equals the unsharded one bit for bit on the card.  Returns
    ``(final_positions, positions (draws, C, dim), CheesSampleInfo,
    CheesWarmupResult)``.
    """
    if target_acceptance_rate is None:
        target_acceptance_rate = chees.OPTIMAL_TARGET_ACCEPTANCE
    kernel_fn = make_fused_chees_kernel(
        potential_fn_t, data, divergence_threshold=divergence_threshold,
        block_chains=block_chains,
        potential_and_grad_t=potential_and_grad_t,
        use_internal_prng=use_internal_prng,
        step_size_factors=step_size_factors,
        mesh=mesh, num_chains=initial_positions.shape[0],
    )
    states = initial_states(potential_fn_t, potential_and_grad_t, data,
                            initial_positions)
    wres = chees.warmup(
        generator, None, states, num_warmup,
        initial_step_size=initial_step_size,
        target_acceptance_rate=target_acceptance_rate,
        max_num_integration_steps=max_num_integration_steps,
        learning_rate=learning_rate,
        divergence_threshold=divergence_threshold,
        search_initial_step_size=search_initial_step_size,
        kernel_fn=kernel_fn,
    )
    final_states, positions, infos = chees.sample(
        generator, None, wres.states, num_samples, wres.step_size,
        wres.trajectory_length, wres.inverse_mass_matrix,
        max_num_integration_steps=max_num_integration_steps,
        divergence_threshold=divergence_threshold,
        collect_positions=collect_positions, kernel_fn=kernel_fn,
    )
    return final_states.position, positions, infos, wres


# ---------------------------------------------------------------- CUDA ----

def _ptr(t):
    return None if t is None else t.data_ptr()


def _device_steps(num_steps, device) -> torch.Tensor:
    """The trip count as a device int32; one from the host is filled on the
    device (a copy would synchronise)."""
    if isinstance(num_steps, torch.Tensor) and num_steps.device == device:
        steps = num_steps.to(torch.int32).reshape(-1)
    else:
        steps = torch.full((1,), int(num_steps), dtype=torch.int32,
                           device=device)
    if steps.numel() != 1:
        raise ValueError("num_steps is one trip count shared by the chains")
    return steps


def chees_transition_cuda(q, u, g, inverse_mass, step_size, num_steps, data,
                          *, divergence_threshold: float = 1000.0,
                          momentum=None, u_accept=None, seed=None,
                          chain_offset: int = 0,
                          potential_and_grad_t=logistic_pg_t,
                          potential_fn_t=None):
    """Launch kernel 7 (``chees_transition``) on CUDA tensors in the
    ``(chains, dim)`` layout, with the functor of the potential
    (:func:`functors.card_functor` on :data:`functors.HMC_CORE`: the
    logistic one by default).
    ``step_size`` is one value or ``(C,)``, and reaches the kernel as
    ``(C,)``; ``num_steps`` an int or an int32 (device) scalar.  With a
    ``seed``, chain c draws global chain ``chain_offset + c``'s streams.
    Returns
    ``(q, u (C, 1), g, stats (C, 8), q_proposed, v_proposed)``."""
    from aehmc_tpu_torch.ops._build import check_launch, require_f32_cuda

    functor, bound, suffix = card_functor(
        potential_fn_t, potential_and_grad_t, data, q.T, HMC_CORE)
    num_chains, dim = q.shape
    device = q.device
    im = torch.as_tensor(inverse_mass, dtype=torch.float32, device=device)
    dense = im.ndim == 2
    im = im.contiguous() if dense else im.reshape(-1).expand(dim).contiguous()
    eps = _row(step_size, num_chains, device).reshape(num_chains).contiguous()
    steps = _device_steps(num_steps, device)
    ops = dict(q=q, u=u.reshape(num_chains), g=g, im=im, eps=eps)
    shapes = dict(q=(num_chains, dim), u=(num_chains,), g=(num_chains, dim),
                  im=(dim, dim) if dense else (dim,), eps=(num_chains,))
    if seed is None:
        ops.update(p=momentum, ua=u_accept.reshape(num_chains))
        shapes.update(p=(num_chains, dim), ua=(num_chains,))
    for name, t in ops.items():
        require_f32_cuda(name, t, shapes[name], device)
    pot_ops, x_dtype = _potential_operands(functor, data, dim, device)
    ops.update(pot_ops)
    plan = launch_plan("hmc", dim, 0, num_chains, x_dtype, functor,
                       geometry=None if bound is None else bound.geometry)
    if functor == "logistic":
        ops["X"] = data_rows(data[0], plan.row_stride, x_dtype)
    ms = _mass_sqrt(im).contiguous() if dense and seed is not None else None
    q_out, g_out, qp, vp = (torch.empty_like(q) for _ in range(4))
    u_out = torch.empty((num_chains, 1), dtype=torch.float32, device=device)
    stats = torch.empty((num_chains, 8), dtype=torch.float32, device=device)
    lib, launcher, pot, sizes, keep = _hmc_launcher(
        "chees_transition", functor, bound, data, ops, plan, dim, num_chains,
        device)
    with torch.cuda.device(device):
        err = launcher(
            _ptr(ops["q"]), _ptr(ops["u"]), _ptr(ops["g"]),
            _ptr(ops.get("p")), _ptr(ops.get("ua")), int(seed is not None),
            0 if seed is None else int(seed) & MASK32, int(chain_offset),
            *pot, _ptr(eps), _ptr(im), _ptr(ms), int(dense), _ptr(steps),
            float(divergence_threshold), *sizes, _ptr(q_out), _ptr(u_out),
            _ptr(g_out), _ptr(stats), _ptr(qp), _ptr(vp), *plan.args(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(lib, err, "chees_transition")
    del keep
    LAUNCHES["chees_transition" + suffix] += 1
    return q_out, u_out, g_out, stats, qp, vp
