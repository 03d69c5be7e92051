"""Carry state across from the JAX package.

The JAX package's arrays, given as numpy arrays (or anything ``np.asarray``
reads), become the port's tensors on a given device (the card unless the
caller passes ``device="cpu"``), dtypes kept.  The tests use this to start
both packages from the same state; the port imports no JAX for it.
"""

import numpy as np
import torch

from aehmc_tpu_torch.chees import CheesWarmupResult
from aehmc_tpu_torch.types import ChainState, DualAveragingState, WelfordState
from aehmc_tpu_torch.window_adaptation import WindowAdaptationState


def to_tensor(x, device="cuda") -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def model_data(X, XT, y_col, device="cuda"):
    """``(X, Xᵀ, y_col)`` of ``logistic_regression_pg_t``: X and Xᵀ keep the
    builder's bfloat16 (its default) or become float32; y_col is float32."""
    def mat(a):
        t = to_tensor(np.asarray(a, np.float32), device)
        bf16 = str(getattr(a, "dtype", "")) == "bfloat16"
        return (t.to(torch.bfloat16) if bf16 else t).contiguous()

    return mat(X), mat(XT), to_tensor(np.asarray(y_col, np.float32),
                                      device).contiguous()


def eight_schools_data(y_col, sig2_col, device="cuda"):
    """``(y_col, sig2_col)`` of the JAX ``eight_schools_pg_t`` /
    ``eight_schools_t`` (the schools' effects and variances, (8, 1) each)
    as the port's float32 columns, the dtype the CUDA kernels take; the
    values are small integers, exact in float32."""
    return tuple(to_tensor(np.asarray(a, np.float32), device).contiguous()
                 for a in (y_col, sig2_col))


def generic_data(arrays, device="cuda") -> tuple:
    """The data operands of a generated functor from the JAX model's
    constants (a Cholesky factor, an index vector, counts): integer arrays
    stay integers (int64; the launch sends int32 rows), every other array
    becomes float32, contiguous on ``device``."""
    out = []
    for a in arrays:
        a = np.asarray(a)
        dtype = np.int64 if np.issubdtype(a.dtype, np.integer) else np.float32
        out.append(to_tensor(np.asarray(a, dtype), device).contiguous())
    return tuple(out)


def chain_state(q, u, g, device="cuda"):
    """``(q (chains, dim), u (chains, 1), g (chains, dim))``."""
    return tuple(to_tensor(a, device) for a in (q, u, g))


def ghmc_state(q, u, g, p, device="cuda"):
    """A JAX GHMC carry with its persistent momentum: ``(q (chains, dim),
    u (chains, 1), g (chains, dim), p (chains, dim))``."""
    return tuple(to_tensor(a, device) for a in (q, u, g, p))


def window_adaptation_state(state, device="cuda") -> WindowAdaptationState:
    """A JAX ``WindowAdaptationState`` (any object with its fields) as the
    port's, field by field."""
    return WindowAdaptationState(
        da_state=DualAveragingState(
            *(to_tensor(getattr(state.da_state, f), device)
              for f in DualAveragingState._fields)
        ),
        wc_state=WelfordState(
            *(to_tensor(getattr(state.wc_state, f), device)
              for f in WelfordState._fields)
        ),
        step_size=to_tensor(state.step_size, device),
        inverse_mass_matrix=to_tensor(state.inverse_mass_matrix, device),
    )


def tuned_parameters(step_size, inverse_mass_matrix, device="cuda"):
    """``(step_size, inverse_mass_matrix)`` as returned by the JAX drivers."""
    return to_tensor(step_size, device), to_tensor(inverse_mass_matrix, device)


def chees_warmup_result(result, device="cuda") -> CheesWarmupResult:
    """A JAX ``CheesWarmupResult`` (any object with its fields, its states a
    ``ChainState``) as the port's, field by field."""
    return CheesWarmupResult(
        states=ChainState(*(to_tensor(getattr(result.states, f), device)
                            for f in ChainState._fields)),
        step_size=to_tensor(result.step_size, device),
        trajectory_length=to_tensor(result.trajectory_length, device),
        inverse_mass_matrix=to_tensor(result.inverse_mass_matrix, device),
    )
