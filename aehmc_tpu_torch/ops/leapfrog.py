"""L velocity-Verlet steps on the diagonal-quadratic potential
``U(q) = ½ Σ λ q²`` with a diagonal metric, batched over chains (port of
:mod:`aehmc_tpu.ops.leapfrog`, kernel 9 of the port's table): the plain
PyTorch version and the wrapper of the CUDA kernel (``csrc/leapfrog.cu``).

:func:`batched_leapfrog` launches the kernel on a CUDA tensor and runs
:func:`batched_leapfrog_reference` on a CPU tensor.  The kernel equals the
plain version bit for bit, and takes any chain count.  Its wrapper sets the
pace of back-to-back calls (its host time a call is several times the
kernel's, PERF.md §6), so it resolves the C launcher once, allocates both
outputs at once (two views of one buffer) and reads the current stream's
handle directly.
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


def _launcher():
    """Kernel 9's C launcher and its library, built and resolved at the first
    call and kept: a call then pays no lookup."""
    global _LAUNCH
    if _LAUNCH is None:
        from aehmc_tpu_torch.ops._build import load_kernels

        lib = load_kernels("leapfrog.cu")
        _LAUNCH = (lib, lib.batched_leapfrog_launch)
    return _LAUNCH


_LAUNCH = None


def batched_leapfrog_cuda(q, p, lam, inverse_mass, step_size, num_steps):
    """Launch kernel 9 (``batched_leapfrog``) on CUDA tensors."""
    from aehmc_tpu_torch.ops._build import check_launch, require_f32_cuda

    num_chains, dim = q.shape
    device = q.device
    require_f32_cuda("q", q, (num_chains, dim), device)
    require_f32_cuda("p", p, (num_chains, dim), device)
    require_f32_cuda("lam", lam, (dim,), device)
    require_f32_cuda("inverse_mass", inverse_mass, (dim,), device)
    out = torch.empty((2, num_chains, dim), dtype=torch.float32,
                      device=device)
    lib, launch = _launcher()
    err = launch(
        q.data_ptr(), p.data_ptr(), lam.data_ptr(), inverse_mass.data_ptr(),
        float(step_size), int(num_steps), dim, num_chains,
        out.data_ptr(), out.data_ptr() + 4 * num_chains * dim,
        torch._C._cuda_getCurrentRawStream(device.index),
    )
    if err:
        check_launch(lib, err, "batched_leapfrog")
    LAUNCHES["batched_leapfrog"] += 1
    return out.unbind(0)
