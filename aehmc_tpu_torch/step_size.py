"""Step-size adaptation by dual averaging (port of :mod:`aehmc_tpu.step_size`)."""

from typing import Callable, Tuple

from aehmc_tpu_torch import algorithms
from aehmc_tpu_torch.config import DualAveragingConfig
from aehmc_tpu_torch.types import DualAveragingState

_DA = DualAveragingConfig()


def dual_averaging_adaptation(
    target_acceptance_rate: float = _DA.target_acceptance_rate,
    gamma: float = _DA.gamma,
    t0: int = _DA.t0,
    kappa: float = _DA.kappa,
) -> Tuple[Callable, Callable]:
    """Tune the LOG step size towards ``target_acceptance_rate``: ``update``
    feeds ``target - acceptance_probability`` to dual averaging."""
    da_init, da_update = algorithms.dual_averaging(gamma, t0, kappa)

    def update(acceptance_probability, state: DualAveragingState):
        return da_update(target_acceptance_rate - acceptance_probability, state)

    return da_init, update
