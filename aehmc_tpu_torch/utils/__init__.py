"""Utilities of the port: :class:`RaveledParamsMap`."""

from aehmc_tpu_torch.utils.ravel import RaveledParamsMap

__all__ = ["RaveledParamsMap"]
