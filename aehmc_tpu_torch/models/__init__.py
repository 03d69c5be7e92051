"""Posteriors of the port: the flagship logistic regression."""

from aehmc_tpu_torch.models.regression import (
    logistic_pg_t,
    logistic_regression,
    logistic_regression_data,
    logistic_regression_pg_t,
)

__all__ = [
    "logistic_pg_t",
    "logistic_regression",
    "logistic_regression_data",
    "logistic_regression_pg_t",
]
