"""L velocity-Verlet steps on the diagonal-quadratic potential
``U(q) = ½ Σ λ q²`` with a diagonal metric, batched over chains (port of
:mod:`aehmc_tpu.ops.leapfrog`, kernel 9 of the port's table): the plain
PyTorch version and the wrapper of the CUDA kernel (``csrc/leapfrog.cu``).

:func:`batched_leapfrog` launches the kernel on a CUDA tensor and runs
:func:`batched_leapfrog_reference` on a CPU tensor.  The kernel equals the
plain version bit for bit, and takes any chain count.
"""

from typing import Tuple

import torch

from aehmc_tpu_torch.ops.launches import LAUNCHES


def batched_leapfrog_reference(
    q: torch.Tensor,
    p: torch.Tensor,
    lam: torch.Tensor,
    inverse_mass: torch.Tensor,
    step_size,
    num_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: ``num_steps`` velocity-Verlet steps.  ``q, p``:
    (chains, dim); ``lam``, ``inverse_mass``: (dim,).  Returns ``(q, p)``."""
    eps = torch.as_tensor(step_size, dtype=q.dtype, device=q.device)
    half = 0.5 * eps
    for _ in range(int(num_steps)):
        p_half = p - half * (lam * q)
        q = q + eps * (inverse_mass * p_half)
        p = p_half - half * (lam * q)
    return q, p


def batched_leapfrog(
    q: torch.Tensor,
    p: torch.Tensor,
    lam: torch.Tensor,
    inverse_mass: torch.Tensor,
    step_size,
    num_steps: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fused multi-step leapfrog: kernel 9 on a CUDA tensor, the plain
    version on the CPU.  Arguments as :func:`batched_leapfrog_reference`."""
    if q.is_cuda:
        return batched_leapfrog_cuda(q, p, lam, inverse_mass, step_size,
                                     num_steps)
    return batched_leapfrog_reference(q, p, lam, inverse_mass, step_size,
                                      num_steps)


def batched_leapfrog_cuda(q, p, lam, inverse_mass, step_size, num_steps):
    """Launch kernel 9 (``batched_leapfrog``) on CUDA tensors."""
    from aehmc_tpu_torch.ops._build import (
        check_launch,
        load_kernels,
        require_f32_cuda,
    )

    num_chains, dim = q.shape
    device = q.device
    operands = dict(q=(q, (num_chains, dim)), p=(p, (num_chains, dim)),
                    lam=(lam, (dim,)), inverse_mass=(inverse_mass, (dim,)))
    for name, (t, shape) in operands.items():
        require_f32_cuda(name, t, shape, device)
    q_out, p_out = torch.empty_like(q), torch.empty_like(p)
    lib = load_kernels("leapfrog.cu")
    err = lib.batched_leapfrog_launch(
        q.data_ptr(), p.data_ptr(), lam.data_ptr(), inverse_mass.data_ptr(),
        float(step_size), int(num_steps), dim, num_chains,
        q_out.data_ptr(), p_out.data_ptr(),
        torch.cuda.current_stream(device).cuda_stream,
    )
    check_launch(lib, err, "batched_leapfrog")
    LAUNCHES["batched_leapfrog"] += 1
    return q_out, p_out
