"""Euclidean (Gaussian) metric for Hamiltonian dynamics (port of
:mod:`aehmc_tpu.metrics`).

The inverse mass matrix is a scalar, a diagonal ``(dim,)`` or a dense
``(dim, dim)``, shared by every chain, or one of each chain wrapped in
:class:`PerChain`; the dense square root of ``M`` is ``L⁻ᵀ`` with ``M⁻¹ =
L Lᵀ``.  Every function works on the last axis, so it takes one chain or a
batch.
The momentum generator maps standard normals ``z`` (drawn by the caller
from its Philox streams) to ``N(0, M)``, where the JAX generator draws them
from a key.  The kinetic energy carries its gradient ``M⁻¹ p`` as the
attribute ``velocity``, which the integrators use for the drift.
"""

from typing import Callable, NamedTuple, Tuple

import torch


class PerChain(NamedTuple):
    """An inverse mass matrix of each row of a ``(chains, dim)`` batch:
    ``(chains,)``, ``(chains, dim)`` or ``(chains, dim, dim)`` (the
    independent warmups of :func:`aehmc_tpu_torch.sampling.sample_chains`).
    A plain tensor is shared by every chain, which tells a ``(dim, dim)``
    dense matrix from ``dim`` chains' diagonals."""
    inverse_mass_matrix: torch.Tensor


def gaussian_metric(
    inverse_mass_matrix,
) -> Tuple[Callable, Callable, Callable]:
    r"""Hamiltonian dynamics on a Euclidean manifold with Gaussian momentum.

    Returns ``(momentum_generator(z), kinetic_energy(p), is_turning(p_left,
    p_right, momentum_sum))``: :math:`p = \sqrt{M} z`,
    :math:`\tfrac12 p^T M^{-1} p`, and the generalized U-turn criterion
    (with :math:`\rho = \sum p - (p_L + p_R)/2`, turning iff
    :math:`\langle v_L, \rho\rangle \le 0` or
    :math:`\langle v_R, \rho\rangle \le 0`).
    """
    per_chain = isinstance(inverse_mass_matrix, PerChain)
    if per_chain:
        inverse_mass_matrix = inverse_mass_matrix.inverse_mass_matrix
    inverse_mass_matrix = torch.as_tensor(inverse_mass_matrix)
    if per_chain and inverse_mass_matrix.ndim == 1:
        # a scalar a chain scales that chain's row
        inverse_mass_matrix = inverse_mass_matrix[:, None]
    ndim = inverse_mass_matrix.ndim - per_chain

    def align(m, x):
        """A chain's matrix against its rows of ``x (chains, ..., dim)``."""
        if not per_chain:
            return m
        return m.reshape(m.shape[:1] + (1,) * (x.ndim - 2) + m.shape[1:])

    if ndim == 0:
        mass_matrix_sqrt = torch.sqrt(torch.reciprocal(inverse_mass_matrix))

        def dot(x, y):
            return x * y

        def matmul(m, x):
            return m * x
    elif ndim == 1:
        mass_matrix_sqrt = torch.sqrt(torch.reciprocal(inverse_mass_matrix))

        def dot(x, y):
            return torch.sum(x * y, dim=-1)

        def matmul(m, x):
            return align(m, x) * x
    elif ndim == 2:
        chol = torch.linalg.cholesky_ex(inverse_mass_matrix).L
        identity = torch.eye(inverse_mass_matrix.shape[-1],
                             dtype=inverse_mass_matrix.dtype,
                             device=inverse_mass_matrix.device)
        mass_matrix_sqrt = torch.linalg.solve_triangular(chol.mT, identity,
                                                         upper=True)

        def dot(x, y):
            return torch.sum(x * y, dim=-1)

        def matmul(m, x):
            if per_chain:
                return torch.einsum("...ij,...j->...i", align(m, x), x)
            return torch.einsum("ij,...j->...i", m, x)
    else:
        raise ValueError(
            "Expected a mass matrix of dimension 0 (scalar), 1 (diagonal) or "
            f"2 (dense), got {ndim}"
        )

    def momentum_generator(z: torch.Tensor) -> torch.Tensor:
        return matmul(mass_matrix_sqrt, z.to(inverse_mass_matrix.dtype))

    def velocity(momentum: torch.Tensor) -> torch.Tensor:
        return matmul(inverse_mass_matrix, momentum)

    def kinetic_energy(momentum: torch.Tensor) -> torch.Tensor:
        return 0.5 * dot(velocity(momentum), momentum)

    kinetic_energy.velocity = velocity

    def is_turning(momentum_left, momentum_right, momentum_sum):
        velocity_left = velocity(momentum_left)
        velocity_right = velocity(momentum_right)
        rho = momentum_sum - (momentum_right + momentum_left) / 2
        turning_at_left = dot(velocity_left, rho) <= 0
        turning_at_right = dot(velocity_right, rho) <= 0
        return turning_at_left | turning_at_right

    return momentum_generator, kinetic_energy, is_turning
