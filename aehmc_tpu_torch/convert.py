"""Carry state across from the JAX package.

The JAX package's arrays, given as numpy arrays (or anything ``np.asarray``
reads), become the port's tensors on a given device, dtypes kept.  The tests
use this to start both packages from the same state; the port imports no
JAX for it.
"""

import numpy as np
import torch

from aehmc_tpu_torch.types import DualAveragingState, WelfordState
from aehmc_tpu_torch.window_adaptation import WindowAdaptationState


def to_tensor(x, device=None) -> torch.Tensor:
    return torch.as_tensor(np.array(x), device=device)


def model_data(X, XT, y_col, device=None):
    """``(X, Xᵀ, y_col)`` of ``logistic_regression_pg_t``, float32."""
    return tuple(to_tensor(a, device).to(torch.float32).contiguous()
                 for a in (X, XT, y_col))


def chain_state(q, u, g, device=None):
    """``(q (chains, dim), u (chains, 1), g (chains, dim))``."""
    return tuple(to_tensor(a, device) for a in (q, u, g))


def window_adaptation_state(state, device=None) -> WindowAdaptationState:
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


def tuned_parameters(step_size, inverse_mass_matrix, device=None):
    """``(step_size, inverse_mass_matrix)`` as returned by the JAX drivers."""
    return to_tensor(step_size, device), to_tensor(inverse_mass_matrix, device)
