"""L leapfrog steps on the Bayesian logistic regression potential for a batch
of chains (port of :mod:`aehmc_tpu.ops.fused_hmc`, kernel 8 of the port's
table): the plain PyTorch version and the wrapper of the CUDA kernel
(``csrc/fused_hmc.cu``).

:func:`fused_logistic_hmc` launches the kernel on a CUDA tensor and runs
:func:`fused_logistic_hmc_reference` on a CPU tensor.  The kernel masks the
ragged last block itself, so every chain count runs on the card.
:func:`logistic_integrate_fn` binds it to its data as the ``integrate_fn``
of the XLA ChEES kernel (:func:`aehmc_tpu_torch.chees.new_kernel`), the
kernel's caller on the sampling path, as in the JAX package.
"""

from typing import Tuple

import torch

from aehmc_tpu_torch.ops.launch_plan import data_rows, launch_plan
from aehmc_tpu_torch.ops.launches import LAUNCHES


def _logistic_grad(q, X, XT, y_row, prior_precision):
    """∇U(q) for U = −log-likelihood − log-prior; q: (chains, dim)."""
    resid = torch.sigmoid(q @ XT) - y_row
    return resid @ X + prior_precision * q


def fused_logistic_hmc_reference(
    q: torch.Tensor,
    p: torch.Tensor,
    X: torch.Tensor,
    y: torch.Tensor,
    inverse_mass: torch.Tensor,
    step_size,
    num_steps: int,
    prior_precision: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``num_steps`` velocity-Verlet steps on the logistic
    regression potential.  ``q, p``: (chains, dim); ``X``: (points, dim);
    ``y``: (points,); ``inverse_mass``: (dim,).  Returns ``(q, p)``."""
    eps = torch.as_tensor(step_size, dtype=q.dtype, device=q.device)
    half = 0.5 * eps
    X = X.to(q.dtype)  # bfloat16 data widened, as the JAX kernel's products
    XT, y_row = X.T, y.reshape(1, -1)
    g = _logistic_grad(q, X, XT, y_row, prior_precision)
    for _ in range(int(num_steps)):
        p_half = p - half * g
        q = q + eps * (inverse_mass * p_half)
        g = _logistic_grad(q, X, XT, y_row, prior_precision)
        p = p_half - half * g
    return q, p


def fused_logistic_hmc(
    q: torch.Tensor,
    p: torch.Tensor,
    X: torch.Tensor,
    y: torch.Tensor,
    inverse_mass: torch.Tensor,
    step_size,
    num_steps: int,
    prior_precision: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused trajectory: kernel 8 on a CUDA tensor, the plain version on
    the CPU.  Arguments as :func:`fused_logistic_hmc_reference`."""
    if q.is_cuda:
        return fused_logistic_hmc_cuda(q, p, X, y, inverse_mass, step_size,
                                       num_steps, prior_precision)
    return fused_logistic_hmc_reference(q, p, X, y, inverse_mass, step_size,
                                        num_steps, prior_precision)


def fused_logistic_hmc_cuda(q, p, X, y, inverse_mass, step_size, num_steps,
                            prior_precision=1.0):
    """Launch kernel 8 (``fused_logistic_hmc``) on CUDA tensors; a bfloat16
    X is widened to float32 (the kernel's products are float32, as the JAX
    kernel's on q's dtype)."""
    from aehmc_tpu_torch.ops._build import (
        check_launch,
        load_kernels,
        require_f32_cuda,
        require_x_cuda,
    )

    num_chains, dim = q.shape
    num_points = X.shape[0]
    device = q.device
    operands = dict(q=(q, (num_chains, dim)), p=(p, (num_chains, dim)),
                    y=(y, (num_points,)), inverse_mass=(inverse_mass, (dim,)))
    for name, (t, shape) in operands.items():
        require_f32_cuda(name, t, shape, device)
    require_x_cuda(X, num_points, dim, device)
    plan = launch_plan("fused_hmc", dim, 0, num_chains)
    Xk = data_rows(X, plan.row_stride)
    q_out, p_out = torch.empty_like(q), torch.empty_like(p)
    lib = load_kernels("fused_hmc.cu")
    with torch.cuda.device(device):
        err = lib.fused_hmc_launch(
            q.data_ptr(), p.data_ptr(), Xk.data_ptr(), y.data_ptr(),
            inverse_mass.data_ptr(), float(step_size), int(num_steps),
            float(prior_precision), dim, num_points, num_chains,
            q_out.data_ptr(), p_out.data_ptr(), *plan.args(),
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(lib, err, "fused_logistic_hmc")
    LAUNCHES["fused_logistic_hmc"] += 1
    return q_out, p_out


def logistic_integrate_fn(X: torch.Tensor, y: torch.Tensor,
                          prior_precision: float = 1.0):
    """``integrate_fn(q, p, step_size, num_steps, inverse_mass_matrix) ->
    (q', p')`` of :func:`aehmc_tpu_torch.chees.new_kernel`: the trajectory
    through :func:`fused_logistic_hmc` on ``X (points, dim)``, ``y
    (points,)``.  The kernel takes the step size and the trip count as host
    numbers, so the binding reads both on the host once a call (two
    synchronisations when they live on the device); ``inverse_mass_matrix``
    is diagonal, ``(dim,)``.  ``X`` and ``y`` follow the chains to their
    device (a shard's, copied once)."""
    from aehmc_tpu_torch.parallel.mesh import device_replicas

    data_on = device_replicas((X, y))

    def integrate_fn(q, p, step_size, num_steps, inverse_mass_matrix):
        Xd, yd = data_on(q.device)
        return fused_logistic_hmc(q, p, Xd, yd, inverse_mass_matrix,
                                  float(step_size), int(num_steps),
                                  prior_precision)

    return integrate_fn
