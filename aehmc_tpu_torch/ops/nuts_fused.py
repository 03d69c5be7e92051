"""Fused whole-transition NUTS in the standard ``(chains, dim)`` layout: the
plain PyTorch versions and the wrappers of kernels 3 and 4
(``csrc/nuts_fused.cu``), and the entry points of
:mod:`aehmc_tpu.ops.nuts_fused`.

- :func:`make_fused_nuts_transition`: any batched standard-layout potential
  ``potential_fn(q, *data) -> (chains,)``, differentiated by autograd in the
  plain version;
- :func:`fused_nuts_transition`: the logistic-regression transition, with
  ``matmul_dtype`` float32 or bfloat16 operands of the two data products;
- :func:`sample_fused` and :func:`sample_fused_logistic`: their sampling
  loops, one transition per draw, or every draw in one call
  (``loop_in_kernel``, kernel 4 on the card), bitwise equal to the per-draw
  path.

Dispatch is by the device of the chain state: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises.  On the card the
kernels compute the potential in their own body: the hand-written logistic
functor for the logistic entry points, and for the generic ones when
``potential_fn`` is :func:`logistic_potential` with ``data = (X, Xᵀ,
y_row)``; any other float32 ``potential_fn`` a functor generated from its
traced gradient graph (:mod:`aehmc_tpu_torch.ops.generic_pg`, kernels
``nuts_transition_std_generic`` and ``nuts_sampling_std_generic``), or it
raises.  The metric is a diagonal ``M⁻¹``, as in the JAX kernels.
``block_chains`` is accepted and has no effect: a CUDA block holds 8
chains.

The plain transition is the transposed core
(:func:`aehmc_tpu_torch.ops.nuts_fused_small._transition_core_t`) on the
transposed views of the state, and with a Philox seed the kernels draw the
streams of :func:`aehmc_tpu_torch.ops.philox.nuts_streams` on the global
chain index, so kernel 3 on ``q`` equals kernel 1 on ``qᵀ`` bit for bit.
The external streams are ``momentum (C, dim)``, ``directions`` and
``u_bias (C, K)``, ``u_leaf (C, 2**K)``; stats are ``(C, 8)`` with columns
``[energy, accept, doublings, leaves, div, turn, 0, 0]``.

The NUTS helpers shared by both layouts live in
:mod:`aehmc_tpu_torch.ops.nuts_fused_small` and are re-exported here under
the JAX module's names.
"""

from typing import Callable, NamedTuple, Optional, Sequence

import torch

from aehmc_tpu_torch.models.regression import _softplus
from aehmc_tpu_torch.ops.launch_plan import (
    checkpoint_floats,
    data_rows,
    launch_plan,
)
from aehmc_tpu_torch.ops.launches import LAUNCHES
from aehmc_tpu_torch.ops.nuts_fused_small import (
    DRAW_SEED_STRIDE,
    NEG_INF,
    _generator_streams,
    _popcount_scalar,
    _trailing_ones_scalar,
    derive_draw_seeds,
    _pot_grad_builder_t,
    nuts_transition_plain,
)
from aehmc_tpu_torch.ops.philox import MASK32, uniform_from_bits

# u32 words (int64 tensor) -> float32 uniforms in (0, 1]
_uniform_from_bits = uniform_from_bits


def logistic_potential(q, X, XT, y_row):
    """The logistic-regression potential ``(chains,)`` of ``q (chains,
    dim)``, prior precision 1, with ``data = (X (N, dim), Xᵀ (dim, N), y_row
    (1, N))``.  The generic builders' kernels recognise it by identity.
    Bfloat16 data are widened to q's dtype, as JAX promotes them."""
    logits = q @ XT.to(q.dtype)
    return -torch.sum(y_row * logits - _softplus(logits), dim=-1) + 0.5 * torch.sum(
        q * q, dim=-1
    )


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _logistic_pot_grad(prior_precision: float, matmul_dtype) -> Callable:
    """``pot_grad(q, X, Xᵀ, y_row) -> (u (C, 1), g (C, dim))``, the plain
    version of the kernels' functor: with ``matmul_dtype=bfloat16`` the
    products' operands are rounded to bfloat16 and multiplied in float32
    (exact products, float32 sums), the prior terms stay float32; with
    float32 bfloat16 data are widened, as JAX promotes them."""
    if matmul_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"matmul_dtype is float32 or bfloat16, got {matmul_dtype}")
    rnd = (_bf16 if matmul_dtype == torch.bfloat16 else
           (lambda x: x.to(torch.float32)))

    def pot_grad(q, X, XT, y_row):
        logits = rnd(q) @ rnd(XT)
        loglik = torch.sum(y_row * logits - _softplus(logits), dim=-1,
                           keepdim=True)
        resid = torch.sigmoid(logits) - y_row
        g = rnd(resid) @ rnd(X) + prior_precision * q
        u = -loglik + 0.5 * prior_precision * torch.sum(q * q, dim=-1,
                                                        keepdim=True)
        return u, g

    return pot_grad


class _Model(NamedTuple):
    """A standard-layout potential: ``pot_grad(q) -> (u (C, 1), g (C,
    dim))`` on its data for the plain version, the data, and ``(prior
    precision, bf16)`` of the kernels' logistic functor when it computes
    the potential (None otherwise: the potential ``fn`` then gets a
    generated functor on the card)."""

    pot_grad: Callable
    data: tuple
    card: Optional[tuple]
    fn: Optional[Callable] = None


def _generic_model(potential_fn, data) -> _Model:
    """``potential_fn(q, *data) -> (C,)``, differentiated by autograd."""
    data = tuple(data)
    pot_grad = _pot_grad_builder_t(potential_fn, None, data)

    def pot_grad_col(q):
        u, g = pot_grad(q)
        return u.reshape(-1, 1), g

    card = (1.0, False) if potential_fn is logistic_potential else None
    return _Model(pot_grad_col, data, card, potential_fn)


def _logistic_model(X, y, prior_precision, matmul_dtype) -> _Model:
    """With bfloat16 operands X is stored rounded (once, to nearest even; a
    bfloat16 X passes through), as the kernel reads it."""
    num_points = X.shape[0]
    X = X.to(torch.float32 if matmul_dtype == torch.float32 else
             torch.bfloat16)
    data = (X, X.T.contiguous(), y.reshape(1, num_points).to(torch.float32))
    pot_grad = _logistic_pot_grad(prior_precision, matmul_dtype)
    return _Model(lambda q: pot_grad(q, *data), data,
                  (float(prior_precision), matmul_dtype == torch.bfloat16))


def _check_card(model: _Model, q):
    """Raise for what kernels 3 and 4 do not take; return the generated
    functor of a potential with no hand-written one
    (:func:`generic_pg.bind`, cached), else None."""
    if q.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32, got {q.dtype}")
    if model.card is None:
        from aehmc_tpu_torch.ops.generic_pg import bind

        return bind(model.fn, model.data, q.shape[1], layout="std",
                    device=q.device)
    if len(model.data) != 3:
        raise ValueError("logistic data is (X, Xᵀ, y_row)")
    return None


def nuts_transition_std_plain(q, u, g, inverse_mass, step_size, pot_grad, *,
                              max_exp: int, divergence_threshold: float = 1000.0,
                              momentum=None, directions=None, u_bias=None,
                              u_leaf=None, seed=None, chain_offset: int = 0):
    """Plain version of kernel 3 on any device: ``q, g (C, dim)``, ``u (C,)``
    or ``(C, 1)``, ``pot_grad(q) -> (u (C, 1), g (C, dim))``.  It runs the
    transposed plain core on transposed copies, so with a Philox seed it
    computes what the transposed plain version computes on ``qᵀ``; returns
    ``(q, u (C, 1), g, stats (C, 8))``."""
    num_chains = q.shape[0]

    def pot_grad_t(q_t):
        uu, gg = pot_grad(q_t.T)
        return uu.reshape(1, num_chains), gg.T.contiguous()

    def t(x):  # contiguous, so the reductions run in the transposed order
        return None if x is None else x.T.contiguous()

    q_t, u_t, g_t, stats = nuts_transition_plain(
        t(q), u.reshape(1, num_chains), t(g), inverse_mass, step_size,
        pot_grad_t, max_exp=max_exp, divergence_threshold=divergence_threshold,
        momentum=t(momentum), directions=t(directions), u_bias=t(u_bias),
        u_leaf=t(u_leaf), seed=seed, chain_offset=chain_offset,
    )
    return q_t.T, u_t.reshape(num_chains, 1), g_t.T, stats.T


def _transition(model: _Model, q, u, g, momentum, directions, u_bias, u_leaf,
                inverse_mass, step_size, *, max_exp, divergence_threshold,
                seed=None, chain_offset=0):
    """One transition of ``model``: kernel 3 on a CUDA tensor, the plain
    version on a CPU one."""
    streams = dict(momentum=momentum, directions=directions, u_bias=u_bias,
                   u_leaf=u_leaf, seed=seed, chain_offset=chain_offset)
    if q.is_cuda:
        bound = _check_card(model, q)
        streams = {k: v if not isinstance(v, torch.Tensor) else v.contiguous()
                   for k, v in streams.items()}
        return nuts_transition_std_cuda(
            q.contiguous(), u, g.contiguous(), inverse_mass, step_size,
            model.data, max_exp=max_exp,
            divergence_threshold=divergence_threshold, card=model.card,
            bound=bound, **streams,
        )
    return nuts_transition_std_plain(
        q, u, g, inverse_mass, step_size, model.pot_grad, max_exp=max_exp,
        divergence_threshold=divergence_threshold, **streams,
    )


def make_fused_nuts_transition(
    potential_fn: Callable,
    data: Sequence[torch.Tensor] = (),
    *,
    max_num_expansions: int = 6,
    divergence_threshold: float = 1000.0,
    block_chains: int = 128,
) -> Callable:
    """Generic fused NUTS transition for a batched standard-layout
    ``potential_fn(q, *data) -> (chains,)`` (kernel 3 on the card when it is
    :func:`logistic_potential`).

    Returns ``transition(q, potential, grad, momentum, directions, u_bias,
    u_leaf, inverse_mass, step_size, seed=None, chain_offset=0) -> (q', U'
    (C, 1), grad', stats (C, 8))``.  ``seed`` (a u32 int) selects Philox
    randomness, chain c drawing global chain ``chain_offset + c``'s
    streams.
    """
    from aehmc_tpu_torch.parallel.mesh import device_replicas

    model = _generic_model(potential_fn, data)
    data_on = device_replicas(model.data)

    def transition(q, potential, grad, momentum, directions, u_bias, u_leaf,
                   inverse_mass, step_size, seed=None, chain_offset=0):
        return _transition(model._replace(data=data_on(q.device)), q,
                           potential, grad, momentum, directions,
                           u_bias, u_leaf, inverse_mass, step_size,
                           max_exp=max_num_expansions,
                           divergence_threshold=divergence_threshold,
                           seed=seed, chain_offset=chain_offset)

    return transition


def fused_nuts_transition(
    q: torch.Tensor,
    potential: torch.Tensor,
    grad: torch.Tensor,
    momentum: torch.Tensor,
    directions: torch.Tensor,
    u_bias: torch.Tensor,
    u_leaf: torch.Tensor,
    X: torch.Tensor,
    y: torch.Tensor,
    inverse_mass: torch.Tensor,
    step_size,
    max_num_expansions: int,
    divergence_threshold: float = 1000.0,
    prior_precision: float = 1.0,
    block_chains: int = 128,
    matmul_dtype=torch.float32,
    seed=None,
):
    """One fused NUTS transition per chain of the logistic-regression family
    (kernel 3 on the card).  ``q, grad, momentum (C, dim)``, ``potential (C,
    1)``, ``directions, u_bias (C, K)`` with directions ±1, ``u_leaf (C,
    2**K)``; ``seed`` selects Philox randomness instead.
    ``matmul_dtype=torch.bfloat16`` rounds the data products' operands to
    bfloat16.  Returns ``(q', U', grad', stats)``."""
    model = _logistic_model(X, y, prior_precision, matmul_dtype)
    return _transition(model, q, potential, grad, momentum, directions,
                       u_bias, u_leaf, inverse_mass, step_size,
                       max_exp=max_num_expansions,
                       divergence_threshold=divergence_threshold, seed=seed)


def _sampling_plain(model: _Model, q, u, g, inverse_mass, step_size, seed,
                    num_draws, *, max_exp, divergence_threshold,
                    collect_positions, chain_offset=0):
    """Plain version of kernel 4 on any device: ``num_draws`` plain
    transitions keyed by ``seed + t·DRAW_SEED_STRIDE``, chain c drawing
    global chain ``chain_offset + c``'s streams."""
    positions, stats = [], []
    for t in range(num_draws):
        q, u, g, st = nuts_transition_std_plain(
            q, u, g, inverse_mass, step_size, model.pot_grad,
            max_exp=max_exp, divergence_threshold=divergence_threshold,
            seed=(seed + t * DRAW_SEED_STRIDE) & MASK32,
            chain_offset=chain_offset,
        )
        if collect_positions:
            positions.append(q)
        stats.append(st)
    pos = torch.stack(positions) if collect_positions else None
    return pos, torch.stack(stats), q, u, g


def _fused_sampling_call(model: _Model, q, potential, grad, inverse_mass,
                         step_size, seed, num_draws, *,
                         max_num_expansions: int,
                         divergence_threshold: float = 1000.0,
                         collect_positions: bool = True,
                         chain_offset: int = 0):
    """The whole sampling phase in one call (kernel 4 on the card): draw
    ``t`` takes the Philox key ``seed + t·DRAW_SEED_STRIDE`` (chain c the
    streams of global chain ``chain_offset + c``), so this equals one
    transition per draw bit for bit.  Returns ``(positions (draws, C,
    dim) float32 or None, stats (draws, C, 8), q, U (C, 1), grad)``."""
    if q.is_cuda:
        bound = _check_card(model, q)
        return nuts_sampling_std_cuda(
            q.contiguous(), potential, grad.contiguous(), inverse_mass,
            step_size, model.data, seed,
            num_draws, max_exp=max_num_expansions,
            divergence_threshold=divergence_threshold, card=model.card,
            collect_positions=collect_positions, bound=bound,
            chain_offset=chain_offset,
        )
    return _sampling_plain(
        model, q, potential, grad, inverse_mass, step_size, seed, num_draws,
        max_exp=max_num_expansions, divergence_threshold=divergence_threshold,
        collect_positions=collect_positions, chain_offset=chain_offset,
    )


def _is_key_source(generator) -> bool:
    """Whether ``generator`` is a key source ``(phase, index) -> key``
    rather than a ``torch.Generator``."""
    return callable(generator) and not isinstance(generator, torch.Generator)


def _sample_phase(key_source) -> Callable:
    """``streams(t)`` of the ``"sample"`` phase of a key source."""
    return lambda t: key_source("sample", t)


def _sampling_loop(model: _Model, generator, initial_positions, u0, g0,
                   num_samples, step_size, inverse_mass, *, max_exp,
                   divergence_threshold, collect_positions, internal_prng,
                   loop_in_kernel):
    """The three randomness modes of the JAX sampling loops: one call of
    kernel 4 (``loop_in_kernel``), per-draw Philox keys
    (``internal_prng``), or per-draw external streams in the standard
    layout, drawn from a ``torch.Generator`` or given by a key source
    ``generator("sample", t) -> (z, dirs, u_bias, u_leaf)``.  Returns
    ``(final_positions, positions, stats)``."""
    num_chains, dim = initial_positions.shape
    device = initial_positions.device
    imm = torch.as_tensor(inverse_mass, dtype=torch.float32, device=device)
    q = initial_positions.to(torch.float32).contiguous()
    kw = dict(max_exp=max_exp, divergence_threshold=divergence_threshold)
    if _is_key_source(generator) and (internal_prng or loop_in_kernel):
        raise TypeError("a key source replays external streams — it requires "
                        "internal_prng=False and loop_in_kernel=False")
    if loop_in_kernel:
        seed = derive_draw_seeds(generator, 1)[0]
        pos, stats, qf, _, _ = _fused_sampling_call(
            model, q, u0, g0, imm, step_size, seed, num_samples,
            max_num_expansions=max_exp,
            divergence_threshold=divergence_threshold,
            collect_positions=collect_positions,
        )
        return qf, pos, stats
    if internal_prng:
        seeds = derive_draw_seeds(generator, num_samples)
    else:
        streams = (_sample_phase(generator) if _is_key_source(generator) else
                   _generator_streams(generator, num_chains, dim, max_exp,
                                      device))
        mass_sqrt = torch.sqrt(1.0 / imm).reshape(-1).expand(dim)
    positions, stats = [], []
    u, g = u0, g0
    for t in range(num_samples):
        if internal_prng:
            rand, seed = (None,) * 4, seeds[t]
        else:
            z, dirs, ub, ul = (torch.as_tensor(s, dtype=torch.float32,
                                               device=device).contiguous()
                               for s in streams(t))
            rand, seed = ((mass_sqrt * z).contiguous(), dirs, ub, ul), None
        q, u, g, st = _transition(model, q, u, g, *rand, imm, step_size,
                                  seed=seed, **kw)
        if collect_positions:
            positions.append(q)
        stats.append(st)
    pos = torch.stack(positions) if collect_positions else None
    return q, pos, torch.stack(stats)


def sample_fused(
    generator: torch.Generator,
    potential_fn: Callable,
    data: Sequence[torch.Tensor],
    initial_positions: torch.Tensor,
    num_samples: int,
    step_size,
    inverse_mass,
    max_num_expansions: int = 6,
    divergence_threshold: float = 1000.0,
    block_chains: int = 128,
    collect_positions: bool = True,
    internal_prng: bool = False,
    loop_in_kernel: bool = False,
):
    """Sampling loop over the generic transition
    (:func:`make_fused_nuts_transition`).  Randomness: per-draw Philox keys
    from ``generator`` (``internal_prng``), one call of the whole-run kernel
    (``loop_in_kernel``), or external streams drawn from ``generator``, or
    given by a key source ``generator("sample", t) -> (z, dirs, u_bias,
    u_leaf)`` as :mod:`aehmc_tpu_torch.chees` takes one.  Returns
    ``(final_positions, positions (draws, C, dim), stats (draws, C, 8))``.
    """
    model = _generic_model(potential_fn, data)
    u0, g0 = model.pot_grad(initial_positions.to(torch.float32))
    return _sampling_loop(
        model, generator, initial_positions, u0, g0, num_samples, step_size,
        inverse_mass, max_exp=max_num_expansions,
        divergence_threshold=divergence_threshold,
        collect_positions=collect_positions, internal_prng=internal_prng,
        loop_in_kernel=loop_in_kernel,
    )


def sample_fused_logistic(
    generator: torch.Generator,
    X: torch.Tensor,
    y: torch.Tensor,
    initial_positions: torch.Tensor,
    num_samples: int,
    step_size,
    inverse_mass,
    max_num_expansions: int = 6,
    divergence_threshold: float = 1000.0,
    prior_precision: float = 1.0,
    block_chains: int = 128,
    collect_positions: bool = True,
    matmul_dtype=torch.bfloat16,
    internal_prng: bool = False,
    loop_in_kernel: bool = False,
):
    """Sampling loop over :func:`fused_nuts_transition` (kernels 3 and 4 on
    the card), the data products' operands in ``matmul_dtype`` (bfloat16 by
    default, as in the JAX package).  The initial potential and gradient are
    float32.  Randomness as :func:`sample_fused`.  Returns
    ``(final_positions, positions, stats)``."""
    model = _logistic_model(X, y, prior_precision, matmul_dtype)
    u0, g0 = _logistic_model(X, y, prior_precision, torch.float32).pot_grad(
        initial_positions.to(torch.float32))
    return _sampling_loop(
        model, generator, initial_positions, u0, g0, num_samples, step_size,
        inverse_mass, max_exp=max_num_expansions,
        divergence_threshold=divergence_threshold,
        collect_positions=collect_positions, internal_prng=internal_prng,
        loop_in_kernel=loop_in_kernel,
    )


# ---------------------------------------------------------------- CUDA ----

def _ptr(t):
    return None if t is None else t.data_ptr()


def _cuda_operands(q, u, g, inverse_mass, data, max_exp, bf16, bound=None):
    """Validate and normalise the operands shared by kernels 3 and 4, and
    plan the launch: X in the functor's operand type (a float32 X of a
    bfloat16 call rounded once, a bfloat16 X of a float32 call widened),
    or a generated functor's (``bound``) plan with its workspace; and the
    U-turn checkpoint buffer."""
    from aehmc_tpu_torch.ops._build import require_f32_cuda, require_x_cuda

    num_chains, dim = q.shape
    device = q.device
    im = torch.as_tensor(inverse_mass, dtype=torch.float32, device=device)
    if im.ndim == 2:
        raise ValueError("the standard-layout NUTS kernels take a diagonal "
                         "inverse mass (the JAX kernels' contract)")
    ops = dict(q=q, u=u.reshape(num_chains, 1), g=g,
               im=im.reshape(-1).expand(dim).contiguous())
    shapes = dict(q=(num_chains, dim), u=(num_chains, 1), g=(num_chains, dim),
                  im=(dim,))
    num_points = 0
    if bound is None:
        X, _, y = data
        num_points = X.shape[0]
        ops["y"], shapes["y"] = y.reshape(num_points), (num_points,)
        require_x_cuda(X, num_points, dim, device)
    for name, t in ops.items():
        require_f32_cuda(name, t, shapes[name], device)
    if bound is None:
        x_dtype = torch.bfloat16 if bf16 else torch.float32
        plan = launch_plan("nuts", dim, max_exp, num_chains, x_dtype)
        ops["X"] = data_rows(X, plan.row_stride, x_dtype)
    else:
        plan = launch_plan("nuts", dim, max_exp, num_chains,
                           functor="generic", geometry=bound.geometry)
    ops["ck"] = torch.empty(checkpoint_floats(dim, max_exp, plan.blocks),
                            dtype=torch.float32, device=device)
    return ops, plan, (dim, num_points, num_chains)


def _generic_launcher(bound, data, q, plan, kernel):
    """The generated functor's launcher of kernel 3 or 4 (``kernel``
    "transition" or "sampling", the standard layout), its library, the
    arguments that name the potential, and the tensors to keep alive."""
    from aehmc_tpu_torch.ops.generic_pg import launch_operands

    lib = bound.library()
    generic, keep = launch_operands(bound, data, q.device, plan.blocks)
    return lib, getattr(lib, f"generic_{kernel}_launch"), generic, keep


def nuts_transition_std_cuda(q, u, g, inverse_mass, step_size, data, *,
                             max_exp: int, divergence_threshold: float = 1000.0,
                             card=(1.0, False), momentum=None, directions=None,
                             u_bias=None, u_leaf=None, seed=None, bound=None,
                             chain_offset: int = 0):
    """Launch kernel 3 (``nuts_transition_std``) on CUDA tensors; ``card``
    is ``(prior_precision, bf16)`` of the logistic functor, or ``bound`` a
    generated functor (``nuts_transition_std_generic``).  With a ``seed``,
    chain c draws the Philox streams of global chain ``chain_offset + c``.
    Returns ``(q, u (C, 1), g, stats (C, 8))``."""
    from aehmc_tpu_torch.ops._build import (
        check_launch,
        load_kernels,
        require_f32_cuda,
    )

    prior_precision, bf16 = card or (1.0, False)
    ops, plan, (dim, num_points, num_chains) = _cuda_operands(
        q, u, g, inverse_mass, data, max_exp, bf16, bound)
    if seed is None:
        ext = dict(p=(momentum, (num_chains, dim)),
                   dirs=(directions, (num_chains, max_exp)),
                   ub=(u_bias, (num_chains, max_exp)),
                   ul=(u_leaf, (num_chains, 2**max_exp)))
        for name, (t, shape) in ext.items():
            require_f32_cuda(name, t, shape, q.device)
        ext_ptrs = [_ptr(t) for t, _ in ext.values()]
    else:
        ext_ptrs = [None] * 4
    q_out, g_out = torch.empty_like(q), torch.empty_like(q)
    u_out = torch.empty((num_chains, 1), dtype=torch.float32, device=q.device)
    stats = torch.empty((num_chains, 8), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    seeded = (int(seed is not None),
              0 if seed is None else int(seed) & MASK32, int(chain_offset))
    if bound is not None:
        lib, launch, generic, keep = _generic_launcher(bound, data, q, plan,
                                                       "transition")
        with torch.cuda.device(q.device):
            err = launch(
                1, _ptr(ops["q"]), _ptr(ops["u"]), _ptr(ops["g"]),
                *ext_ptrs, *seeded, *generic, _ptr(ops["im"]), None, 0,
                float(step_size), None, float(divergence_threshold), dim,
                num_chains, max_exp, _ptr(q_out), _ptr(u_out), _ptr(g_out),
                _ptr(stats), _ptr(ops["ck"]), *plan.args(), stream,
            )
        check_launch(lib, err, "nuts_transition_std")
        del keep
        LAUNCHES["nuts_transition_std_generic"] += 1
        return q_out, u_out, g_out, stats
    lib = load_kernels("nuts_fused.cu")
    with torch.cuda.device(q.device):
        err = lib.nuts_transition_std_launch(
            _ptr(ops["q"]), _ptr(ops["u"]), _ptr(ops["g"]), *ext_ptrs,
            *seeded, _ptr(ops["X"]), _ptr(ops["y"]), _ptr(ops["im"]),
            float(step_size), float(divergence_threshold),
            float(prior_precision), int(bf16), dim, num_points, num_chains,
            max_exp, _ptr(q_out), _ptr(u_out), _ptr(g_out), _ptr(stats),
            _ptr(ops["ck"]), *plan.args(), stream,
        )
    check_launch(lib, err, "nuts_transition_std")
    LAUNCHES["nuts_transition_std"] += 1
    return q_out, u_out, g_out, stats


def nuts_sampling_std_cuda(q, u0, g0, inverse_mass, step_size, data, seed,
                           num_draws, *, max_exp: int,
                           divergence_threshold: float = 1000.0,
                           card=(1.0, False), collect_positions: bool = True,
                           bound=None, chain_offset: int = 0):
    """Launch kernel 4 (``nuts_sampling_std``): all draws in one launch,
    with the logistic functor of ``card`` or the generated functor
    ``bound`` (``nuts_sampling_std_generic``); chain c draws the Philox
    streams of global chain ``chain_offset + c``.  Returns ``(positions
    (draws, C, dim) float32 or None, stats (draws, C, 8), q, u (C, 1),
    g)``."""
    from aehmc_tpu_torch.ops._build import check_launch, load_kernels

    prior_precision, bf16 = card or (1.0, False)
    ops, plan, (dim, num_points, num_chains) = _cuda_operands(
        q, u0, g0, inverse_mass, data, max_exp, bf16, bound)
    device = q.device
    pos = (torch.empty((num_draws, num_chains, dim), dtype=torch.float32,
                       device=device) if collect_positions else None)
    stats = torch.empty((num_draws, num_chains, 8), dtype=torch.float32,
                        device=device)
    q_out, g_out = torch.empty_like(q), torch.empty_like(q)
    u_out = torch.empty((num_chains, 1), dtype=torch.float32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    if bound is not None:
        lib, launch, generic, keep = _generic_launcher(bound, data, q, plan,
                                                       "sampling")
        with torch.cuda.device(device):
            err = launch(
                1, _ptr(ops["q"]), _ptr(ops["u"]), _ptr(ops["g"]),
                int(seed) & MASK32, int(chain_offset), int(num_draws),
                *generic, _ptr(ops["im"]), None, 0, float(step_size), None,
                float(divergence_threshold), dim, num_chains, max_exp,
                _ptr(pos), 0, _ptr(stats), _ptr(q_out), _ptr(u_out),
                _ptr(g_out), _ptr(ops["ck"]), *plan.args(), stream,
            )
        check_launch(lib, err, "nuts_sampling_std")
        del keep
        LAUNCHES["nuts_sampling_std_generic"] += 1
        return pos, stats, q_out, u_out, g_out
    lib = load_kernels("nuts_fused.cu")
    with torch.cuda.device(device):
        err = lib.nuts_sampling_std_launch(
            _ptr(ops["q"]), _ptr(ops["u"]), _ptr(ops["g"]),
            int(seed) & MASK32, int(chain_offset), int(num_draws),
            _ptr(ops["X"]), _ptr(ops["y"]), _ptr(ops["im"]),
            float(step_size), float(divergence_threshold),
            float(prior_precision), int(bf16), dim, num_points, num_chains,
            max_exp, _ptr(pos), _ptr(stats), _ptr(q_out), _ptr(u_out),
            _ptr(g_out), _ptr(ops["ck"]), *plan.args(), stream,
        )
    check_launch(lib, err, "nuts_sampling_std")
    LAUNCHES["nuts_sampling_std"] += 1
    return pos, stats, q_out, u_out, g_out


__all__ = [
    "DRAW_SEED_STRIDE",
    "NEG_INF",
    "_popcount_scalar",
    "_trailing_ones_scalar",
    "_uniform_from_bits",
    "derive_draw_seeds",
    "fused_nuts_transition",
    "logistic_potential",
    "make_fused_nuts_transition",
    "sample_fused",
    "sample_fused_logistic",
]
