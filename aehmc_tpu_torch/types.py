"""State tuples threaded through the port's samplers.

Counterparts of :mod:`aehmc_tpu.types` (``ChainState``, ``DualAveragingState``,
``WelfordState``, ``Diagnostics``) with ``torch.Tensor`` leaves.  The field
names and their order are the JAX package's, so :mod:`aehmc_tpu_torch.convert`
can carry a state across field by field.
"""

from typing import NamedTuple

import torch

Tensor = torch.Tensor


class ChainState(NamedTuple):
    """State carried between transitions (momentum is refreshed each step)."""

    position: Tensor
    potential_energy: Tensor
    potential_energy_grad: Tensor


class DualAveragingState(NamedTuple):
    step: Tensor
    iterates: Tensor
    iterates_avg: Tensor
    gradient_avg: Tensor
    shrinkage_pts: Tensor


class WelfordState(NamedTuple):
    mean: Tensor
    m2: Tensor
    sample_size: Tensor


class Diagnostics(NamedTuple):
    """Per-transition observability (fields of ``aehmc_tpu.types.Diagnostics``)."""

    acceptance_probability: Tensor
    num_doublings: Tensor
    is_turning: Tensor
    is_diverging: Tensor
    energy: Tensor
    num_integration_steps: Tensor
