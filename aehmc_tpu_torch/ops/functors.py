"""Which device functor runs a potential on the card.

The fused kernels compute the potential and its gradient in a device
functor, the template parameter of their core.  Hand-written functors are
found by the identity of ``potential_and_grad_t``: the logistic
regression's (:func:`models.logistic_pg_t`, ``LogisticPGT`` in
``csrc/logistic_pg.cuh``) in the NUTS kernels 1 and 2 and the HMC kernels
5-7, and Neal's funnel's and eight schools' (:func:`models.funnel_pg_t`,
:func:`models.schools_pg_t`; ``FunnelPG``, ``EightSchoolsPG`` in
``csrc/hierarchical_pg.cuh``) in kernels 1 and 2 only.  Any other float32
potential (its data float32, or integer index and count data), and the
hierarchical ones in kernels 5-7, run on a functor generated from the
potential's traced gradient graph (:mod:`aehmc_tpu_torch.ops.generic_pg`).
"""

import torch

from aehmc_tpu_torch.models.hierarchical import funnel_pg_t, schools_pg_t
from aehmc_tpu_torch.models.regression import logistic_pg_t

# the potential+gradient functions with a hand-written device functor ->
# (the functor in the launch plan, its data tensors, the suffix of its
# launch counts)
HAND_WRITTEN = (
    (logistic_pg_t, "logistic", ("X", "Xᵀ", "y_col"), ""),
    (funnel_pg_t, "funnel", ("a (1, 1) dummy row",), "_funnel"),
    (schools_pg_t, "eight_schools", ("y_col", "sig2_col"), "_eight_schools"),
)
# the hand-written functors each core is instantiated on
NUTS_CORE = ("logistic", "funnel", "eight_schools")
HMC_CORE = ("logistic",)
# the number of a functor with no X in the *_pot_* launchers of kernels 1
# and 2 (csrc/nuts_fused_small.cu: with_model)
MODEL_NUMBERS = {"funnel": 1, "eight_schools": 2}
# the generated functor's entry in HAND_WRITTEN's form
GENERIC = ("generic", (), "_generic")


def hand_written(potential_and_grad_t, core=NUTS_CORE):
    """``(functor, data, count suffix)`` of a potential whose hand-written
    functor ``core`` holds; the generated functor's for any other."""
    for fn, *functor in HAND_WRITTEN:
        if fn is potential_and_grad_t and functor[0] in core:
            return functor
    return GENERIC


def generic_bound(potential_fn_t, potential_and_grad_t, data, q_t):
    """The generated functor of the potential (:func:`generic_pg.bind`,
    cached): ``potential_and_grad_t`` traced as it stands, else
    ``potential_fn_t`` with its gradient."""
    from aehmc_tpu_torch.ops.generic_pg import bind

    fn = potential_and_grad_t or potential_fn_t
    if fn is None:
        raise ValueError("no potential: pass potential_fn_t or "
                         "potential_and_grad_t")
    return bind(fn, data, q_t.shape[0], layout="t",
                with_grad=potential_and_grad_t is None, device=q_t.device)


def card_functor(potential_fn_t, potential_and_grad_t, data, q_t,
                 core=NUTS_CORE):
    """The device functor that runs a potential in ``core``'s kernels
    (:data:`NUTS_CORE` or :data:`HMC_CORE`), chains ``q_t (dim, C)``:
    ``(name, bound, count suffix)``, ``name`` a hand-written functor's or
    "generic", ``bound`` the generated functor (:func:`generic_bound`) or
    None.  Raises only for what no functor takes: ``TypeError`` for chains
    that are not float32 or data that are neither float32 nor int32/int64,
    ``ValueError`` for a hand-written functor's data of another count or a
    potential that mixes chains, ``IndexError`` for an index operand with
    a value outside its axis, and ``NotImplementedError`` naming an op
    outside the compiler's table (ROADMAP.md item 1.10c)."""
    name, layout, suffix = hand_written(potential_and_grad_t, core)
    if q_t.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32, got {q_t.dtype}")
    if name == "generic":
        return name, generic_bound(potential_fn_t, potential_and_grad_t,
                                   data, q_t), suffix
    if len(data) != len(layout):
        raise ValueError(f"{name} data is ({', '.join(layout)})")
    return name, None, suffix
