"""The result of a sampling run (the ``SampleResult`` of
:mod:`aehmc_tpu.sampling`)."""

from typing import NamedTuple, Optional

import torch

from aehmc_tpu_torch.types import Diagnostics


class SampleResult(NamedTuple):
    final_state: torch.Tensor
    positions: Optional[torch.Tensor]
    diagnostics: Diagnostics
    step_size: torch.Tensor
    inverse_mass_matrix: torch.Tensor
