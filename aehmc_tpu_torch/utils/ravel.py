"""Map structured model parameters to one flat sampling vector and back (port
of :mod:`aehmc_tpu.utils.ravel`).

Parameters are example tensors (or anything ``torch.as_tensor`` takes),
named by a dict or by position; ``unravel_params`` restores both shapes and
dtypes.  The flat vector is floating point, so HMC treats the whole model as
one Euclidean position.
"""

import math
from typing import Any, Dict, Iterable, List, Tuple, Union

import torch


class RaveledParamsMap:
    """Maps named parameters (any shapes and dtypes) to one flat vector.

    ``ref_params`` is a dict ``name -> example`` or an iterable of examples
    (then keyed by index); ``dtype`` is the flat vector's dtype (by default
    the promoted dtype of the parameters, float32 when that is not
    floating point).
    """

    def __init__(self, ref_params: Union[Dict[str, Any], Iterable[Any]],
                 dtype=None):
        if isinstance(ref_params, dict):
            self.names: Tuple[Any, ...] = tuple(ref_params.keys())
            examples = tuple(ref_params.values())
        else:
            examples = tuple(ref_params)
            self.names = tuple(range(len(examples)))
        examples = tuple(torch.as_tensor(p) for p in examples)
        self.ref_shapes = [tuple(p.shape) for p in examples]
        self.ref_dtypes = [p.dtype for p in examples]
        sizes = [math.prod(s) if s else 1 for s in self.ref_shapes]
        ends = [sum(sizes[:i + 1]) for i in range(len(sizes))]
        self.slice_indices = list(zip([0] + ends[:-1], ends))
        self.vec_slices = [slice(*idx) for idx in self.slice_indices]
        self.size = ends[-1] if sizes else 0
        if dtype is None:
            dtype = torch.float32
            if examples:
                promoted = examples[0].dtype
                for p in examples[1:]:
                    promoted = torch.promote_types(promoted, p.dtype)
                if promoted.is_floating_point:
                    dtype = promoted
        self.dtype = dtype

    def ravel_params(self, params: Union[Dict[str, Any], List[Any]]
                     ) -> torch.Tensor:
        """Concatenate the raveled values of each parameter."""
        values = ([params[k] for k in self.names] if isinstance(params, dict)
                  else list(params))
        return torch.cat([
            torch.atleast_1d(torch.as_tensor(v)).reshape(-1).to(self.dtype)
            for v in values
        ])

    def unravel_params(self, raveled_params: torch.Tensor
                       ) -> Dict[Any, torch.Tensor]:
        """Reshape and re-cast slices of the flat vector back to
        parameters."""
        return {
            k: raveled_params[slc].reshape(shape).to(dt)
            for k, slc, shape, dt in zip(self.names, self.vec_slices,
                                         self.ref_shapes, self.ref_dtypes)
        }

    def __repr__(self):
        return f"{type(self).__name__}({list(self.names)})"
