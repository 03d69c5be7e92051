"""Mass-matrix adaptation from the sample covariance, with Stan shrinkage
(port of :mod:`aehmc_tpu.mass_matrix`)."""

from typing import Callable, Tuple

import torch

from aehmc_tpu_torch import algorithms
from aehmc_tpu_torch.config import MassMatrixConfig
from aehmc_tpu_torch.types import WelfordState

_MM = MassMatrixConfig()


def covariance_adaptation(
    is_mass_matrix_full: bool = False,
) -> Tuple[Callable, Callable, Callable]:
    """``(init, update, final)``; ``final`` applies
    ``(n/(n+5))·cov + 1e-3·(5/(n+5))`` (times the identity when dense)."""
    wc_init, wc_update, wc_final = algorithms.welford_covariance(
        is_mass_matrix_full
    )

    def init(n_dims: int, dtype=torch.float32, device=None):
        if n_dims == 0:
            inverse_mass_matrix = torch.ones((), dtype=dtype, device=device)
        elif is_mass_matrix_full:
            inverse_mass_matrix = torch.eye(n_dims, dtype=dtype, device=device)
        else:
            inverse_mass_matrix = torch.ones((n_dims,), dtype=dtype,
                                             device=device)
        return inverse_mass_matrix, wc_init(n_dims, dtype=dtype, device=device)

    def update(position: torch.Tensor, wc_state: WelfordState) -> WelfordState:
        return wc_update(position, wc_state)

    def final(wc_state: WelfordState) -> torch.Tensor:
        covariance = wc_final(wc_state)
        n = wc_state.sample_size.to(covariance.dtype)
        w = _MM.shrinkage_weight
        scaled_covariance = (n / (n + w)) * covariance
        shrinkage = _MM.shrinkage_scale * (w / (n + w))
        if covariance.ndim == 2 and is_mass_matrix_full:
            eye = torch.eye(covariance.shape[0], dtype=covariance.dtype,
                            device=covariance.device)
            return scaled_covariance + shrinkage * eye
        return scaled_covariance + shrinkage

    return init, update, final
