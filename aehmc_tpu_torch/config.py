"""Frozen Stan defaults, the same values as :mod:`aehmc_tpu.config`.

Dtype policy: every function computes at the dtype of the tensors it is
given (float32 on the card; the CPU tests also run float64).  Matrix
products in the plain PyTorch versions run in full float32: TF32 stays off.
"""

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DualAveragingConfig:
    """Nesterov dual averaging (Hoffman-Gelman stabilisation, Stan defaults)."""

    target_acceptance_rate: float = 0.8
    gamma: float = 0.05
    t0: int = 10
    kappa: float = 0.75


@dataclass(frozen=True)
class MassMatrixConfig:
    """Welford covariance adaptation with Stan shrinkage:
    ``(n/(n+5))·cov + 1e-3·(5/(n+5))·I``."""

    is_full: bool = False
    shrinkage_weight: float = 5.0
    shrinkage_scale: float = 1e-3


@dataclass(frozen=True)
class WindowSchedule:
    """Stan's three-phase warmup schedule."""

    initial_buffer: int = 75
    first_window: int = 25
    final_buffer: int = 50


@dataclass(frozen=True)
class NutsConfig:
    """NUTS transition parameters."""

    max_num_expansions: int = 10
    divergence_threshold: float = 1000.0
    paired_leaves: bool = True


@dataclass(frozen=True)
class HmcConfig:
    """Static-trajectory HMC parameters."""

    num_integration_steps: int = 32
    divergence_threshold: float = 1000.0


@dataclass(frozen=True)
class WarmupConfig:
    """Window-adaptation driver defaults."""

    num_steps: int = 1000
    initial_step_size: float = 1.0
    search_initial_step_size: bool = True
    dual_averaging: DualAveragingConfig = field(
        default_factory=DualAveragingConfig
    )
    mass_matrix: MassMatrixConfig = field(default_factory=MassMatrixConfig)
    schedule: WindowSchedule = field(default_factory=WindowSchedule)


DEFAULTS = WarmupConfig()
