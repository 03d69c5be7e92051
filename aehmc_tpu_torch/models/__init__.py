"""Posteriors of the port: the regressions (logistic, the flagship, and
linear), the Gaussian test targets, and the hierarchical funnel and eight
schools.  The CUDA NUTS kernels take the potential+gradient functions
``logistic_pg_t``, ``funnel_pg_t`` and ``schools_pg_t``."""

from aehmc_tpu_torch.models.gaussian import (
    correlated_mvn,
    mvn,
    normal,
    std_normal,
)
from aehmc_tpu_torch.models.hierarchical import (
    eight_schools,
    eight_schools_pg_t,
    eight_schools_t,
    funnel_pg_t,
    funnel_potential_t,
    neals_funnel,
    neals_funnel_pg_t,
    neals_funnel_t,
    schools_pg_t,
    schools_potential_t,
)
from aehmc_tpu_torch.models.regression import (
    linear_regression,
    logistic_pg_t,
    logistic_regression,
    logistic_regression_data,
    logistic_regression_pg_t,
    logistic_regression_t,
)

__all__ = [
    "correlated_mvn",
    "eight_schools",
    "eight_schools_pg_t",
    "eight_schools_t",
    "funnel_pg_t",
    "funnel_potential_t",
    "linear_regression",
    "logistic_pg_t",
    "logistic_regression",
    "logistic_regression_data",
    "logistic_regression_pg_t",
    "logistic_regression_t",
    "mvn",
    "neals_funnel",
    "neals_funnel_pg_t",
    "neals_funnel_t",
    "normal",
    "schools_pg_t",
    "schools_potential_t",
    "std_normal",
]
