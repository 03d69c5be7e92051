"""Fused whole-transition NUTS in the chains-in-lanes layout: plain PyTorch
versions and the wrappers of the two CUDA kernels
(``csrc/nuts_fused_small.cu``).

Port of :mod:`aehmc_tpu.ops.nuts_fused_small`.  Chain state is ``(dim,
chains)``, per-chain scalars ``(1, chains)``, stats ``(8, chains)`` with rows
``[energy, accept, doublings, leaves, div, turn, 0, 0]``.  The plain core
:func:`_transition_core_t` also serves the standard-layout module
(:mod:`aehmc_tpu_torch.ops.nuts_fused`), which re-exports the helpers below
under the JAX module's names.

Dispatch is by the device of the chain state and nothing else: a CPU tensor
runs the plain version, a CUDA tensor launches the kernel or raises.  The
kernels compute the potential and gradient in their own body, a device
functor (:mod:`aehmc_tpu_torch.ops.functors`).  Three are hand-written,
picked by the identity of ``potential_and_grad_t``: the logistic regression's
(:func:`aehmc_tpu_torch.models.logistic_pg_t`, with float32 or bfloat16
operands as X's dtype says; the model builder's default is bfloat16, as in
the JAX package), Neal's funnel's (:func:`aehmc_tpu_torch.models.funnel_pg_t`)
and eight schools' (:func:`aehmc_tpu_torch.models.schools_pg_t`).  Any other
float32 potential, given as ``potential_and_grad_t`` or as ``potential_fn_t``
(differentiated in the trace), gets a functor generated from its traced
gradient graph (:mod:`aehmc_tpu_torch.ops.generic_pg`, kernels
``nuts_transition_generic`` and ``nuts_sampling_generic``); one the
compiler cannot take raises.

Randomness is either external (``p, dirs, u_bias, u_leaf`` tensors, the
oracle-parity mode) or a Philox key per draw.  The generator fills exactly
the external streams (:func:`aehmc_tpu_torch.ops.philox.nuts_streams`), so a
plain transition fed those streams computes what the kernel computes, and the
whole-run kernel equals one launch per draw bit for bit.
"""

import functools
from typing import Callable, Sequence

import torch

from aehmc_tpu_torch.models.regression import logistic_pg_t
from aehmc_tpu_torch.ops.functors import (
    MODEL_NUMBERS,
    card_functor,
    generic_bound,
    hand_written,
)
from aehmc_tpu_torch.ops.launch_plan import (
    checkpoint_floats,
    data_rows,
    launch_plan,
)
from aehmc_tpu_torch.ops.launches import LAUNCHES
from aehmc_tpu_torch.ops.philox import MASK32, nuts_streams

NEG_INF = -1e30  # finite stand-in for -inf in log-weights

# Stream of draw t = base + t * DRAW_SEED_STRIDE (mod 2^32).  The JAX
# package also offsets each chain block by BLOCK_SEED_STRIDE; the port's
# Philox counter carries the global chain index instead, so per-chain
# results do not depend on the block size.
DRAW_SEED_STRIDE = 104729


def derive_draw_seeds(generator: torch.Generator, num_draws: int) -> list:
    """Per-draw Philox keys: one random base from ``generator`` plus the
    fixed per-draw stride, as Python ints in [0, 2^32)."""
    base = int(torch.randint(0, 2**31 - 1, (), generator=generator,
                             device=generator.device))
    return [(base + t * DRAW_SEED_STRIDE) & MASK32 for t in range(num_draws)]


def _popcount_scalar(x: int) -> int:
    return bin(int(x)).count("1")


def _trailing_ones_scalar(x: int) -> int:
    # popcount(x ^ (x+1)) - 1
    return _popcount_scalar(x ^ (x + 1)) - 1


def _logaddexp(a, b):
    # the finite-input formula of jnp.logaddexp (log-weights are clamped to
    # +-1e30, never inf); the CUDA kernels use the same expression
    return torch.maximum(a, b) + torch.log1p(torch.exp(-torch.abs(a - b)))


def _clamped(pot_grad: Callable, num_chains: int) -> Callable:
    """The kernels' guard on the potential: a NaN potential becomes +1e30, a
    NaN gradient 0, both clipped to ±1e30; ``u`` comes back ``(1, C)``."""
    def pg(q):
        u, g = pot_grad(q)
        u = u.reshape(1, num_chains)
        u = torch.clamp(torch.where(torch.isnan(u), -NEG_INF, u),
                        NEG_INF, -NEG_INF)
        g = torch.clamp(torch.where(torch.isnan(g), 0.0, g), NEG_INF, -NEG_INF)
        return u, g

    return pg


def _transition_core_t(q0, u0, g0, p0, dirs, u_bias, u_leaf, apply_im, eps,
                       pot_grad, *, max_exp: int, divergence_threshold: float):
    """One NUTS transition of a batch of chains (plain PyTorch).

    ``q0, g0, p0`` are ``(dim, C)``, ``u0`` is ``(1, C)``; ``dirs`` and
    ``u_bias`` are ``(K, C)``, ``u_leaf`` ``(2**K, C)``; ``apply_im(p)`` is
    ``M^{-1} p``; ``pot_grad(q) -> (u (1, C), g (dim, C))``.  Returns
    ``(q, u, g, stats (8, C))``.

    The semantics are ``_transition_core_t`` of the JAX package (itself the
    NumPy oracle's): up to K doublings of ``2**d``-leaf subtrees,
    progressive-uniform sampling inside a subtree and biased sampling across
    doublings, both in logit space, checkpoint writes at even leaves and
    U-turn checks at odd leaves, ``|ΔE| > threshold`` divergence.  Masks are
    true selects.  The JAX kernel walks leaves in pairs; this walks them one
    by one, which changes nothing per chain.
    """
    dtype, device = q0.dtype, q0.device
    dim, num_chains = q0.shape
    where = torch.where
    pg = _clamped(pot_grad, num_chains)

    def ke(p):
        return 0.5 * torch.sum(p * apply_im(p), dim=0, keepdim=True)

    def turning(p_l, p_r, rho_sum):
        rho = rho_sum - (p_r + p_l) * 0.5
        v = apply_im(rho)
        t_l = torch.sum(p_l * v, dim=0, keepdim=True) <= 0
        t_r = torch.sum(p_r * v, dim=0, keepdim=True) <= 0
        return (t_l | t_r).to(dtype)

    def on(mask):
        return mask > 0.5

    e0 = u0 + ke(p0)
    zero = torch.zeros_like(u0)
    one = zero + 1.0
    # proposal (q, u, g, energy, log-weight, sum log p_accept)
    prop = (q0, u0, g0, e0, zero, zero + NEG_INF)
    left = right = (q0, p0, u0, g0)
    psum = p0
    active = one
    div = turn = accept = leaves = doublings = zero
    ck_p = torch.zeros((max_exp, dim, num_chains), dtype=dtype, device=device)
    ck_s = torch.zeros_like(ck_p)

    for d in range(max_exp):
        if not bool(on(active).any()):
            break
        direction = dirs[d:d + 1]
        go_right = on((direction + 1.0) * 0.5)
        last = tuple(where(go_right, r, l) for l, r in zip(left, right))
        d_eps = direction * eps
        nleaf = 1 << d
        sprop = (last[0], last[2], last[3], e0, zero, zero + NEG_INF)
        s_psum = torch.zeros_like(psum)
        s_active = active
        s_div = s_term = s_len = zero
        for i in range(nleaf):
            if not bool(on(s_active).any()):
                break
            keep = on(s_active)
            lq, lp, lu, lg = last
            p1 = lp - 0.5 * d_eps * lg
            nq = lq + d_eps * apply_im(p1)
            nu, ng = pg(nq)
            np_ = p1 - 0.5 * d_eps * ng
            energy = torch.clamp(nu + ke(np_), NEG_INF, -NEG_INF)
            delta = e0 - energy
            delta = torch.clamp(where(torch.isnan(delta), NEG_INF, delta),
                                NEG_INF, -NEG_INF)
            leaf_div = (torch.abs(delta) > divergence_threshold).to(dtype)
            slpa_leaf = torch.clamp(delta, max=0.0)
            if i == 0:
                take, m_w, m_slpa = keep, delta, slpa_leaf
            else:
                u_row = u_leaf[nleaf - 1 + i:nleaf + i]
                u_logit = torch.log(u_row) - torch.log1p(-u_row)
                take = keep & (u_logit < delta - sprop[4])
                m_w = _logaddexp(sprop[4], delta)
                m_slpa = _logaddexp(sprop[5], slpa_leaf)
            sprop = (
                where(take, nq, sprop[0]), where(take, nu, sprop[1]),
                where(take, ng, sprop[2]), where(take, energy, sprop[3]),
                where(keep, m_w, sprop[4]), where(keep, m_slpa, sprop[5]),
            )
            last = tuple(where(keep, n, o)
                         for n, o in zip((nq, np_, nu, ng), last))
            psum_raw = s_psum + np_
            s_psum = where(keep, psum_raw, s_psum)
            s_len = s_len + keep.to(dtype)
            s_div = s_div + keep.to(dtype) * leaf_div
            m_idx = _popcount_scalar(i >> 1)
            if i % 2 == 0:
                ck_p[m_idx] = np_
                ck_s[m_idx] = psum_raw
                stop = leaf_div
            else:
                term = zero
                for j in range(m_idx - _trailing_ones_scalar(i) + 1, m_idx + 1):
                    rho_sum = psum_raw - ck_s[j] + ck_p[j]
                    term = torch.maximum(term, turning(ck_p[j], np_, rho_sum))
                s_term = s_term + keep.to(dtype) * term
                stop = torch.clamp(leaf_div + term, max=1.0)
            s_active = s_active * (1.0 - stop)

        # doubling epilogue: move the edge, merge the subtree (biased)
        keep = on(active)
        lq, lp, lu, lg = last
        left = tuple(where(keep & ~go_right, n, o)
                     for n, o in zip((lq, lp, lu, lg), left))
        right = tuple(where(keep & go_right, n, o)
                      for n, o in zip((lq, lp, lu, lg), right))
        psum = where(keep, psum + s_psum, psum)
        new_accept = torch.exp(sprop[5]) / torch.clamp(s_len, min=1.0)
        merged_slpa = _logaddexp(sprop[5], prop[5])
        clean = keep & on((1.0 - s_div) * (1.0 - s_term))
        p_acc = torch.clamp(torch.exp(sprop[4] - prop[4]), max=1.0)
        take = clean & (u_bias[d:d + 1] < p_acc)
        prop = (
            where(take, sprop[0], prop[0]), where(take, sprop[1], prop[1]),
            where(take, sprop[2], prop[2]), where(take, sprop[3], prop[3]),
            where(clean, _logaddexp(prop[4], sprop[4]), prop[4]),
            where(keep, merged_slpa, prop[5]),
        )
        turn_f = turning(left[1], right[1], psum)
        stop_now = torch.clamp(s_div + turn_f + s_term, max=1.0)
        active = active * (1.0 - stop_now)
        div = where(keep, s_div, div)
        turn = where(keep, turn_f, turn)
        accept = where(keep, new_accept, accept)
        leaves = leaves + keep.to(dtype) * s_len
        doublings = doublings + keep.to(dtype)

    stats = torch.cat([prop[3], accept, doublings, leaves, div, turn,
                       zero, zero], dim=0)
    return prop[0], prop[1], prop[2], stats


def _apply_im_fn(inverse_mass: torch.Tensor, dim: int) -> Callable:
    if inverse_mass.ndim == 2:
        return lambda p: inverse_mass @ p
    im_col = inverse_mass.reshape(-1, 1).expand(dim, 1)
    return lambda p: im_col * p


def _mass_sqrt(inverse_mass: torch.Tensor) -> torch.Tensor:
    """``sqrt(M)`` such that ``p = z·sqrt(M)ᵀ ~ N(0, M)`` for standard-normal
    ``z``: ``L^{-T}`` with ``L = chol(M^{-1})`` when dense, else
    ``sqrt(1/M^{-1})``.  The unchecked factorisation does not synchronise
    the stream."""
    if inverse_mass.ndim == 2:
        chol = torch.linalg.cholesky_ex(inverse_mass).L
        eye = torch.eye(inverse_mass.shape[0], dtype=inverse_mass.dtype,
                        device=inverse_mass.device)
        return torch.linalg.solve_triangular(chol.mT, eye, upper=True)
    return torch.sqrt(1.0 / inverse_mass)


def _mass_sqrt_t(inverse_mass: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`_mass_sqrt` for the transposed layout: ``(dim, dim)``, or a
    ``(dim, 1)`` column."""
    if inverse_mass.ndim == 2:
        return _mass_sqrt(inverse_mass)
    return _mass_sqrt(inverse_mass).reshape(-1, 1).expand(dim, 1)


def _momentum_t(z_t: torch.Tensor, mass_sqrt: torch.Tensor) -> torch.Tensor:
    """``p_t`` from standard normals ``z_t (dim, C)``: a matrix product with
    a dense square root, elementwise with the ``(dim, 1)`` column."""
    if mass_sqrt.shape[1] > 1:
        return mass_sqrt @ z_t
    return mass_sqrt * z_t


def _pot_grad_builder_t(potential_fn_t: Callable, potential_and_grad_t: Callable,
                        data: Sequence[torch.Tensor]) -> Callable:
    """``q_t -> (u, g)``: the caller's potential+gradient when given, else
    autograd of ``potential_fn_t`` (plain versions only; contiguous, as the
    kernels take them: a gradient through a transposed view, a triangular
    solve's say, comes out of autograd strided)."""
    if potential_and_grad_t is not None:
        return lambda q_t: potential_and_grad_t(q_t, *data)

    def pot_grad(q_t):
        with torch.enable_grad():
            q = q_t.detach().requires_grad_(True)
            u = potential_fn_t(q, *data)
            (g,) = torch.autograd.grad(u.sum(), q)
        return u.detach().contiguous(), g.contiguous()

    return pot_grad


def nuts_transition_plain(q_t, u, g_t, inverse_mass, step_size, pot_grad, *,
                          max_exp: int, divergence_threshold: float = 1000.0,
                          momentum=None, directions=None, u_bias=None,
                          u_leaf=None, seed=None, chain_offset: int = 0):
    """Plain version of kernel 1, transposed layout on any device.

    Either the external streams (``momentum (dim, C)``, ``directions`` and
    ``u_bias (K, C)``, ``u_leaf (2**K, C)``) or a Philox ``seed`` (u32) is
    given; with a seed the streams are :func:`nuts_streams` of the global
    chains ``chain_offset ..`` (a shard's offset).  ``step_size``
    is a scalar or a per-chain ``(C,)`` vector (:func:`_step_size_row`).
    """
    dim, num_chains = q_t.shape
    inverse_mass = torch.as_tensor(inverse_mass, dtype=q_t.dtype,
                                   device=q_t.device)
    if seed is not None:
        z, directions, u_bias, u_leaf = nuts_streams(
            seed, num_chains, dim, max_exp, device=q_t.device,
            chain_offset=chain_offset,
        )
        momentum = _momentum_t(z.to(q_t.dtype),
                               _mass_sqrt_t(inverse_mass, dim))
    return _transition_core_t(
        q_t, u.reshape(1, num_chains), g_t, momentum, directions, u_bias,
        u_leaf, _apply_im_fn(inverse_mass, dim),
        _step_size_row(step_size, num_chains, q_t.dtype, q_t.device),
        pot_grad, max_exp=max_exp, divergence_threshold=divergence_threshold,
    )


def _step_size_row(step_size, num_chains, dtype, device) -> torch.Tensor:
    """ε as the plain core takes it: a 0-d scalar, or a per-chain vector of
    ``num_chains`` entries as a ``(1, C)`` row, each chain integrating at
    its own ε (the JAX kernels' ``per_chain_eps``)."""
    eps = torch.as_tensor(step_size, dtype=dtype, device=device)
    if eps.numel() == 1:
        return eps.reshape(())
    if eps.numel() != num_chains:
        raise ValueError(f"per-chain step_size has {eps.numel()} entries for "
                         f"{num_chains} chains")
    return eps.reshape(1, num_chains)


def _check_cuda_args(potential_and_grad_t, data, q_t, step_size,
                     potential_fn_t=None) -> str:
    """Raise for what kernels 1 and 2 do not take
    (:func:`functors.card_functor`, and a per-chain ε of the wrong shape,
    type or device); return the functor: a hand-written one's name, or
    "generic" for a potential bound to a generated functor."""
    name = card_functor(potential_fn_t, potential_and_grad_t, data, q_t)[0]
    _eps_row(step_size, q_t)
    return name


def _eps_row(step_size, q_t):
    """The per-chain ε row the kernels read, or None for a scalar ε; a
    per-chain ε must be a float32 ``(C,)`` tensor on the chains' device
    (``ValueError`` otherwise)."""
    step_size = torch.as_tensor(step_size)
    if step_size.numel() == 1:
        return None
    num_chains = q_t.shape[1]
    if (step_size.shape != (num_chains,) or step_size.dtype != torch.float32
            or step_size.device != q_t.device):
        raise ValueError(
            "a per-chain step_size is a float32 (chains,) tensor on the "
            f"chains' device: got {tuple(step_size.shape)} {step_size.dtype} "
            f"on {step_size.device} for {num_chains} chains on {q_t.device}"
        )
    return step_size.contiguous()


def make_fused_nuts_transition_small(
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor] = (),
    *,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    potential_and_grad_t: Callable = None,
    transposed_io: bool = False,
    block_chains: int = None,
) -> Callable:
    """Transposed-layout fused NUTS transition.

    Returns ``transition(q, potential, grad, momentum, directions, u_bias,
    u_leaf, inverse_mass, step_size, seed=None, chain_offset=0)`` like the
    JAX builder.  The public contract is ``(chains, dim)`` (``potential
    (chains, 1)``, stats ``(chains, 8)``); ``transposed_io=True`` keeps the
    kernel's own layout throughout.  ``seed`` (a u32 int) selects Philox
    randomness, chain c drawing global chain ``chain_offset + c``'s streams
    (a shard's offset, :func:`~aehmc_tpu_torch.ops.fused_driver.
    shard_fused_transition`); otherwise the four external streams are
    used.  ``step_size`` is a scalar or a
    per-chain ``(chains,)`` vector (float32 on the chains' device for the
    kernel), each chain integrating at its own ε.  ``block_chains`` has no
    effect (a CUDA block holds 8 chains).
    """
    from aehmc_tpu_torch.parallel.mesh import device_replicas

    data = tuple(data)
    pot_grad = _pot_grad_builder_t(potential_fn_t, potential_and_grad_t, data)
    data_on = device_replicas(data)

    def transition(q, potential, grad, momentum, directions, u_bias, u_leaf,
                   inverse_mass, step_size, seed=None, chain_offset=0):
        if not transposed_io:
            q, grad = q.T.contiguous(), grad.T.contiguous()
            if seed is None:
                momentum, directions, u_bias, u_leaf = (
                    s.T.contiguous()
                    for s in (momentum, directions, u_bias, u_leaf)
                )
        num_chains = q.shape[1]
        streams = dict(momentum=momentum, directions=directions,
                       u_bias=u_bias, u_leaf=u_leaf, seed=seed,
                       chain_offset=chain_offset)
        if q.is_cuda:
            out = nuts_transition_cuda(
                q, potential, grad, inverse_mass, step_size,
                data_on(q.device), max_exp=max_num_expansions,
                divergence_threshold=divergence_threshold,
                potential_and_grad_t=potential_and_grad_t,
                potential_fn_t=potential_fn_t, **streams,
            )
        else:
            out = nuts_transition_plain(
                q, potential, grad, inverse_mass, step_size, pot_grad,
                max_exp=max_num_expansions,
                divergence_threshold=divergence_threshold, **streams,
            )
        qt, ut, gt, stats = out
        if transposed_io:
            return qt, ut, gt, stats
        return qt.T, ut.reshape(num_chains, 1), gt.T, stats.T

    return transition


def _sampling_plain(pot_grad, q_t, u0, g0_t, inverse_mass, step_size, seed,
                    num_draws, *, max_exp, divergence_threshold,
                    collect_positions, collect_dtype, chain_offset=0):
    """Plain version of kernel 2: ``num_draws`` plain transitions with the
    per-draw keys ``seed + t * DRAW_SEED_STRIDE``."""
    positions, stats = [], []
    q, u, g = q_t, u0, g0_t
    for t in range(num_draws):
        q, u, g, st = nuts_transition_plain(
            q, u, g, inverse_mass, step_size, pot_grad, max_exp=max_exp,
            divergence_threshold=divergence_threshold,
            seed=(seed + t * DRAW_SEED_STRIDE) & MASK32,
            chain_offset=chain_offset,
        )
        if collect_positions:
            positions.append(q.to(collect_dtype))
        stats.append(st)
    pos = torch.stack(positions) if collect_positions else None
    return pos, torch.stack(stats), q, u, g


def _fused_sampling_call_t(potential_fn_t, potential_and_grad_t, data, q_t, u0,
                           g0_t, inverse_mass, step_size, seed, num_draws, *,
                           max_num_expansions: int,
                           divergence_threshold: float = 1000.0,
                           collect_positions: bool = True,
                           collect_dtype=None, chain_offset: int = 0):
    """The whole sampling phase in one call (kernel 2 on the card).

    Transposed contract: ``q_t, g0_t (dim, C)``, ``u0 (1, C)``; returns
    ``(positions_t (draws, dim, C) in collect_dtype, stats_t (draws, 8, C),
    q_t, u, g_t)``.  Draw ``t`` uses the Philox key ``seed +
    t*DRAW_SEED_STRIDE``, the layout of :func:`derive_draw_seeds`, so this
    equals the per-draw path bit for bit.  ``step_size`` is a scalar or a
    per-chain ``(C,)`` vector, each chain's ε fixed across the draws.
    Chain c draws global chain ``chain_offset + c``'s streams.
    """
    cdt = torch.float32 if collect_dtype is None else collect_dtype
    if cdt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"collect_dtype must be float32 or bfloat16, got {cdt}")
    data = tuple(data)
    if q_t.is_cuda:
        return nuts_sampling_cuda(
            q_t, u0, g0_t, inverse_mass, step_size, data, seed, num_draws,
            max_exp=max_num_expansions,
            divergence_threshold=divergence_threshold,
            collect_positions=collect_positions, collect_dtype=cdt,
            potential_and_grad_t=potential_and_grad_t,
            potential_fn_t=potential_fn_t, chain_offset=chain_offset,
        )
    pot_grad = _pot_grad_builder_t(potential_fn_t, potential_and_grad_t, data)
    return _sampling_plain(
        pot_grad, q_t, u0, g0_t, torch.as_tensor(inverse_mass, dtype=q_t.dtype),
        step_size, seed, num_draws, max_exp=max_num_expansions,
        divergence_threshold=divergence_threshold,
        collect_positions=collect_positions, collect_dtype=cdt,
        chain_offset=chain_offset,
    )


def sample_fused_small(
    generator: torch.Generator,
    potential_fn_t: Callable,
    data: Sequence[torch.Tensor],
    initial_positions: torch.Tensor,
    num_samples: int,
    step_size,
    inverse_mass,
    max_num_expansions: int = 10,
    divergence_threshold: float = 1000.0,
    block_chains: int = None,
    collect_positions: bool = True,
    collect_dtype=None,
    internal_prng: bool = True,
    sort_by_depth: bool = False,
    potential_and_grad_t: Callable = None,
    loop_in_kernel: bool = False,
    streams: Callable = None,
):
    """Sampling loop over the transposed transition.

    Returns ``(final_positions (C, dim), positions (draws, C, dim),
    stats (draws, C, 8))``.  ``internal_prng`` uses Philox keys from
    :func:`derive_draw_seeds`; ``loop_in_kernel`` runs all draws in one call
    of :func:`_fused_sampling_call_t` (kernel 2 on the card), bitwise equal to
    the per-draw path.  With ``internal_prng=False`` each draw takes
    ``streams(t) -> (z, dirs, u_bias, u_leaf)`` in the standard layout
    (``(C, dim)``, ``(C, K)``, ``(C, K)``, ``(C, 2**K)``), or draws them from
    ``generator`` when ``streams`` is None.  ``step_size`` is a scalar or a
    per-chain ``(C,)`` vector.

    ``sort_by_depth`` schedules the blocks by depth: before each draw the
    chains are put in the stable order of the previous draw's doublings
    (:func:`_depth_sorted`; a per-chain ε rides the permutation), so a
    block's chains walk trees of like depth, and the outputs come back in
    chain order.  It runs one transition a draw (kernel 1 on the card), so
    not with ``loop_in_kernel``.  ``block_chains`` has no effect (a CUDA
    block holds 8 chains).
    """
    num_chains, dim = initial_positions.shape
    device = initial_positions.device
    inverse_mass = torch.as_tensor(inverse_mass, dtype=torch.float32,
                                   device=device)
    if torch.as_tensor(step_size).numel() > 1:  # a scalar stays as given
        step_size = torch.as_tensor(step_size, dtype=torch.float32,
                                    device=device).reshape(num_chains)
    data = tuple(data)
    q0_t = initial_positions.T.to(torch.float32).contiguous()
    pot_grad = _pot_grad_builder_t(potential_fn_t, potential_and_grad_t, data)
    u0, g0_t = pot_grad(q0_t)
    u0 = u0.reshape(1, num_chains)
    cdt = torch.float32 if collect_dtype is None else collect_dtype

    if loop_in_kernel:
        if not internal_prng:
            raise ValueError(
                "loop_in_kernel draws all randomness in the kernel — it "
                "requires internal_prng=True"
            )
        if sort_by_depth:
            raise ValueError(
                "loop_in_kernel keeps each block's chains resident in "
                "VMEM across draws; sort_by_depth is a global cross-"
                "block permutation between draws — use the scan path"
            )
        seed = derive_draw_seeds(generator, 1)[0]
        pos_t, stats_t, qf_t, _, _ = _fused_sampling_call_t(
            potential_fn_t, potential_and_grad_t, data, q0_t, u0, g0_t,
            inverse_mass, step_size, seed, num_samples,
            max_num_expansions=max_num_expansions,
            divergence_threshold=divergence_threshold,
            collect_positions=collect_positions, collect_dtype=collect_dtype,
        )
        pos = None if pos_t is None else pos_t.transpose(1, 2)
        return qf_t.T, pos, stats_t.transpose(1, 2)

    transition = make_fused_nuts_transition_small(
        potential_fn_t, data, max_num_expansions=max_num_expansions,
        divergence_threshold=divergence_threshold,
        potential_and_grad_t=potential_and_grad_t, transposed_io=True,
    )
    if internal_prng:
        randomness = derive_draw_seeds(generator, num_samples)
    else:
        randomness = streams or _generator_streams(
            generator, num_chains, dim, max_num_expansions, device
        )
    depth0 = (torch.zeros(num_chains, dtype=torch.float32, device=device)
              if sort_by_depth else None)
    return _draw_loop(transition, q0_t, u0, g0_t, inverse_mass, step_size,
                      num_samples, randomness, collect_positions, cdt,
                      depth=depth0)


def _external_randomness(raw, inverse_mass, device):
    """Transposed ``(p, dirs, u_bias, u_leaf)`` from one draw of raw streams
    ``(z, dirs, u_bias, u_leaf)`` in the standard layout: the momentum is
    ``N(0, M)`` for the current metric (``fused_driver._external_randomness``
    of the JAX package, with the draws given).  A stream given as None stays
    None."""
    z, dirs, ub, ul = (None if s is None else
                       torch.as_tensor(s, dtype=torch.float32,
                                       device=device).T.contiguous()
                       for s in raw)
    dim = z.shape[0]
    p = _momentum_t(z, _mass_sqrt_t(inverse_mass.to(torch.float32), dim))
    return p.contiguous(), dirs, ub, ul


def _depth_sorted(step: Callable, q_t, u, g_t, step_size, depth):
    """``step(q_t, u, g_t, eps) -> (q_t, u, g_t, stats_t)`` under
    depth-sorted block scheduling: the chains enter in the stable order of
    ``depth`` (the previous transition's doublings, ``(C,)``; stable as
    ``jnp.argsort``, so ties keep chain order), a per-chain ε rides the
    permutation, and every output returns to chain order.  Only the state
    moves: row i of the randomness (a Philox stream on the array index, or
    an external stream's row) serves whichever chain sits in place i, as in
    the JAX drivers.  ``depth`` None runs ``step`` unsorted."""
    if depth is None:
        return step(q_t, u, g_t, step_size)
    order = torch.argsort(depth, stable=True)
    inv = torch.argsort(order)
    eps = step_size
    if isinstance(eps, torch.Tensor) and eps.ndim > 0:
        eps = eps[order]
    out = step(q_t[:, order], u[:, order], g_t[:, order], eps)
    return tuple(x[:, inv] for x in out)


def _draw_loop(transition, q_t, u, g_t, inverse_mass, step_size, num_draws,
               randomness, collect_positions, collect_dtype,
               final_state=False, depth=None):
    """One transition per draw.  ``randomness`` is a list of Philox keys, or
    ``streams(t)`` giving each draw's raw external streams.  A ``depth``
    ``(C,)`` sorts the chains by it before the first draw and by each
    draw's doublings after (:func:`_depth_sorted`).  Returns ``(final (C,
    dim), positions (draws, C, dim), stats (draws, C, 8))``; with
    ``final_state`` the first item is the transposed state and the last
    depth ``(q_t, u, g_t, depth)``."""
    positions, stats = [], []
    for t in range(num_draws):
        if isinstance(randomness, list):
            def step(q_t, u, g_t, eps, seed=randomness[t]):
                return transition(q_t, u, g_t, None, None, None, None,
                                  inverse_mass, eps, seed=seed)
        else:
            rand = _external_randomness(randomness(t), inverse_mass,
                                        q_t.device)

            def step(q_t, u, g_t, eps, rand=rand):
                return transition(q_t, u, g_t, *rand, inverse_mass, eps)
        q_t, u, g_t, st = _depth_sorted(step, q_t, u, g_t, step_size, depth)
        if depth is not None:
            depth = st[2]
        if collect_positions:
            positions.append(q_t.T.to(collect_dtype))
        stats.append(st.T)
    pos = torch.stack(positions) if collect_positions else None
    final = (q_t, u, g_t, depth) if final_state else q_t.T
    return final, pos, torch.stack(stats)


def _generator_streams(generator, num_chains, dim, max_exp, device):
    """``streams(t)`` drawing ``(z, dirs, u_bias, u_leaf)`` from a
    ``torch.Generator`` (the external-randomness mode's default)."""
    def streams(t):
        kw = dict(generator=generator, device=generator.device)
        z = torch.randn((num_chains, dim), **kw)
        dirs = torch.where(torch.rand((num_chains, max_exp), **kw) < 0.5,
                           -1.0, 1.0)
        ub = torch.rand((num_chains, max_exp), **kw)
        ul = torch.rand((num_chains, 2**max_exp), **kw)
        return tuple(s.to(device) for s in (z, dirs, ub, ul))

    return streams


# ---------------------------------------------------------------- CUDA ----

def _ptr(t):
    return None if t is None else t.data_ptr()


def _cuda_operands(q_t, u, g_t, inverse_mass, data, max_exp, functor,
                   bound=None):
    """Validate and normalise the operands shared by both kernels, and plan
    the launch.  For the logistic functor X's dtype picks the operands:
    float32, or bfloat16 (the model builder's default), as the plain
    version computes with those data; the funnel takes no data (its dummy
    row is not read), eight schools its (y, σ²) columns as float32 (J,)
    rows, J = dim − 2; a generated functor (``bound``) its data operands
    and a workspace.  Also allocates the U-turn checkpoint buffer."""
    from aehmc_tpu_torch.ops._build import require_f32_cuda, require_x_cuda

    dim, num_chains = q_t.shape
    device = q_t.device
    inverse_mass = torch.as_tensor(inverse_mass, dtype=torch.float32,
                                   device=device)
    dense = inverse_mass.ndim == 2
    im = inverse_mass if dense else inverse_mass.reshape(-1).expand(dim)
    ops = dict(q=q_t, u=u.reshape(1, num_chains), g=g_t, im=im.contiguous())
    shapes = dict(q=(dim, num_chains), u=(1, num_chains), g=(dim, num_chains),
                  im=(dim, dim) if dense else (dim,))
    x_dtype = torch.float32
    if functor == "logistic":
        X, _, y = data
        num_points = X.shape[0]
        ops["y"], shapes["y"] = y.reshape(num_points), (num_points,)
        require_x_cuda(X, num_points, dim, device)
        x_dtype = X.dtype
    elif functor == "eight_schools":
        ops["y"], ops["s2"] = (d.reshape(-1) for d in data)
        shapes["y"] = shapes["s2"] = (dim - 2,)
    for name, t in ops.items():
        require_f32_cuda(name, t, shapes[name], device)
    mass_sqrt = (_mass_sqrt_t(ops["im"], dim).contiguous() if dense
                 else None)
    plan = launch_plan("nuts", dim, max_exp, num_chains, x_dtype, functor,
                       geometry=None if bound is None else bound.geometry)
    if functor == "logistic":
        ops["X"] = data_rows(X, plan.row_stride, X.dtype)
    ops["ck"] = torch.empty(checkpoint_floats(dim, max_exp, plan.blocks),
                            dtype=torch.float32, device=device)
    return ops, dense, mass_sqrt, plan


def _potential_args(ops, functor, dim, num_chains, max_exp, generic=None):
    """The arguments of ``functor``'s launcher that name its potential and
    sizes: X, its type, y, then (dim, N, C, K) for the logistic launchers;
    the model number, y, σ² and J, then (dim, C, K) for the *_pot_*
    launchers; the data table and workspace (``generic``,
    :func:`generic_pg.launch_operands`), then (dim, C, K) for the generated
    functor's."""
    if functor == "generic":
        return generic, (dim, num_chains, max_exp)
    if functor == "logistic":
        X = ops["X"]
        return ((_ptr(X), int(X.dtype == torch.bfloat16), _ptr(ops["y"])),
                (dim, X.shape[0], num_chains, max_exp))
    y, s2 = ops.get("y"), ops.get("s2")
    return ((MODEL_NUMBERS[functor], _ptr(y), _ptr(s2),
             0 if y is None else y.numel()), (dim, num_chains, max_exp))


def _launcher(functor, bound, data, q_t, plan, kernel):
    """``(library, launcher, generic arguments, tensors to keep alive)`` of
    kernel 1 or 2 (``kernel`` "transition" or "sampling") for ``functor``:
    a hand-written functor's entry point in ``nuts_fused_small.cu``, or the
    generated functor's in its own library, called with the transposed
    layout."""
    from aehmc_tpu_torch.ops._build import load_kernels

    if functor != "generic":
        lib = load_kernels("nuts_fused_small.cu")
        kind = "" if functor == "logistic" else "_pot"
        return lib, getattr(lib, f"nuts_{kernel}{kind}_launch"), None, None
    from aehmc_tpu_torch.ops.generic_pg import launch_operands

    lib = bound.library()
    generic, keep = launch_operands(bound, data, q_t.device, plan.blocks)
    launch = getattr(lib, f"generic_{kernel}_launch")
    return lib, functools.partial(launch, 0), generic, keep


def nuts_transition_cuda(q_t, u, g_t, inverse_mass, step_size, data, *,
                         max_exp: int, divergence_threshold: float = 1000.0,
                         momentum=None, directions=None, u_bias=None,
                         u_leaf=None, seed=None, chain_offset: int = 0,
                         potential_and_grad_t=logistic_pg_t,
                         potential_fn_t=None):
    """Launch kernel 1 (``nuts_transition``) on CUDA tensors with the
    functor of ``potential_and_grad_t`` (:func:`_check_cuda_args`), or the
    generated functor of the potential (``nuts_transition_generic``);
    returns ``(q_t, u (1, C), g_t, stats (8, C))``.  With a ``seed``,
    chain c draws the Philox streams of global chain ``chain_offset + c``
    (a shard's offset)."""
    from aehmc_tpu_torch.ops._build import check_launch, require_f32_cuda

    functor = _check_cuda_args(potential_and_grad_t, data, q_t, step_size,
                               potential_fn_t)
    eps_row = _eps_row(step_size, q_t)
    eps = 0.0 if eps_row is not None else float(step_size)
    bound = (generic_bound(potential_fn_t, potential_and_grad_t, data, q_t)
             if functor == "generic" else None)
    ops, dense, mass_sqrt, plan = _cuda_operands(
        q_t, u, g_t, inverse_mass, data, max_exp, functor, bound)
    dim, num_chains = q_t.shape
    if seed is None:
        ext = dict(p=(momentum, (dim, num_chains)),
                   dirs=(directions, (max_exp, num_chains)),
                   ub=(u_bias, (max_exp, num_chains)),
                   ul=(u_leaf, (2**max_exp, num_chains)))
        for name, (t, shape) in ext.items():
            require_f32_cuda(name, t, shape, q_t.device)
        ext_ptrs = [_ptr(t) for t, _ in ext.values()]
    else:
        ext_ptrs = [None] * 4
    q_out = torch.empty_like(q_t)
    u_out = torch.empty((1, num_chains), dtype=torch.float32, device=q_t.device)
    g_out = torch.empty_like(q_t)
    stats = torch.empty((8, num_chains), dtype=torch.float32, device=q_t.device)
    lib, launcher, generic, keep = _launcher(functor, bound, data, q_t, plan,
                                             "transition")
    pot, sizes = _potential_args(ops, functor, dim, num_chains, max_exp,
                                 generic)
    with torch.cuda.device(q_t.device):
        err = launcher(
            _ptr(ops["q"]), _ptr(ops["u"]), _ptr(ops["g"]), *ext_ptrs,
            int(seed is not None), 0 if seed is None else int(seed) & MASK32,
            int(chain_offset), *pot, _ptr(ops["im"]), _ptr(mass_sqrt),
            int(dense), eps, _ptr(eps_row), float(divergence_threshold),
            *sizes, _ptr(q_out), _ptr(u_out), _ptr(g_out), _ptr(stats),
            _ptr(ops["ck"]), *plan.args(),
            torch.cuda.current_stream(q_t.device).cuda_stream,
        )
    check_launch(lib, err, "nuts_transition")
    del keep
    LAUNCHES["nuts_transition" + hand_written(potential_and_grad_t)[2]] += 1
    return q_out, u_out, g_out, stats


def nuts_sampling_cuda(q_t, u0, g0_t, inverse_mass, step_size, data, seed,
                       num_draws, *, max_exp: int,
                       divergence_threshold: float = 1000.0,
                       collect_positions: bool = True,
                       collect_dtype=torch.float32,
                       potential_and_grad_t=logistic_pg_t,
                       potential_fn_t=None, chain_offset: int = 0):
    """Launch kernel 2 (``nuts_sampling``): all draws in one launch, with
    the functor of ``potential_and_grad_t`` or the potential's generated
    one (``nuts_sampling_generic``); chain c draws the Philox streams of
    global chain ``chain_offset + c``.

    Positions are written as ``(draws, C, dim)`` (each chain's row is
    contiguous) and returned as the ``(draws, dim, C)`` view of the JAX
    contract; stats are ``(draws, 8, C)``.
    """
    from aehmc_tpu_torch.ops._build import check_launch

    functor = _check_cuda_args(potential_and_grad_t, data, q_t, step_size,
                               potential_fn_t)
    eps_row = _eps_row(step_size, q_t)
    eps = 0.0 if eps_row is not None else float(step_size)
    bound = (generic_bound(potential_fn_t, potential_and_grad_t, data, q_t)
             if functor == "generic" else None)
    ops, dense, mass_sqrt, plan = _cuda_operands(
        q_t, u0, g0_t, inverse_mass, data, max_exp, functor, bound)
    dim, num_chains = q_t.shape
    device = q_t.device
    pos = (torch.empty((num_draws, num_chains, dim), dtype=collect_dtype,
                       device=device) if collect_positions else None)
    stats = torch.empty((num_draws, 8, num_chains), dtype=torch.float32,
                        device=device)
    q_out = torch.empty_like(q_t)
    u_out = torch.empty((1, num_chains), dtype=torch.float32, device=device)
    g_out = torch.empty_like(q_t)
    lib, launcher, generic, keep = _launcher(functor, bound, data, q_t, plan,
                                             "sampling")
    pot, sizes = _potential_args(ops, functor, dim, num_chains, max_exp,
                                 generic)
    with torch.cuda.device(device):
        err = launcher(
            _ptr(ops["q"]), _ptr(ops["u"]), _ptr(ops["g"]),
            int(seed) & MASK32, int(chain_offset), num_draws, *pot,
            _ptr(ops["im"]), _ptr(mass_sqrt), int(dense), eps, _ptr(eps_row),
            float(divergence_threshold), *sizes, _ptr(pos),
            int(collect_dtype == torch.bfloat16), _ptr(stats), _ptr(q_out),
            _ptr(u_out), _ptr(g_out), _ptr(ops["ck"]), *plan.args(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(lib, err, "nuts_sampling")
    del keep
    LAUNCHES["nuts_sampling" + hand_written(potential_and_grad_t)[2]] += 1
    pos_t = None if pos is None else pos.permute(0, 2, 1)
    return pos_t, stats, q_out, u_out, g_out
