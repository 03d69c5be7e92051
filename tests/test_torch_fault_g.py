"""Fault G's kept witness (ROADMAP §3): P2 ``hier_negbin`` (919
observations in 85 counties, dim 89) under the N(0, 4) prior on log φ,
from 0.1·N(0, 1) made with numpy, through the port's pooled XLA NUTS route
(``aehmc_tpu_torch.parallel.pooled.sample_sharded``: ``pooled_warmup``,
then the draws) in float64 and in float32, and through the reference's
(``aehmc_tpu.parallel.pooled.sample_sharded``) in float64 on the CPU.

Each run records how many chains end warmup with log φ > 10 and its tuned
M⁻¹ entry for log φ.  A float32 run on the card once held 17 of 512
chains at log φ 14-16, where float32 ``lgamma(y + φ) - lgamma(φ)`` is
rounding noise (ROADMAP.md §3, fault G); ``chip_smoke.py`` phase 53 runs
that setting in float32 and float64.  Here, at 32 chains and 50 warmup
steps, the float64 runs of the port and of the reference strand no chain
and tune log φ's M⁻¹ alike.
"""

import numpy as np
import torch

import jax
import jax.numpy as jnp

import aehmc_tpu.parallel.pooled as jax_pooled
from aehmc_tpu_torch.parallel.pooled import sample_sharded
from tests.test_torch_generic_ops import (
    hier_negbin,
    jax_hier_negbin,
    negbin_data,
)

CHAINS, WARMUP, K = 32, 50, 4
PRIOR = (0.0, 2.0)   # log φ ~ N(0, 4)
EPS0 = 0.05          # phase 50's initial step size
FAR = 10.0           # log φ of a stranded chain


def _start():
    return 0.1 * np.random.default_rng(11).standard_normal((CHAINS, 89))


def _record(first_draw_log_phi, imm_log_phi):
    return dict(stranded=int((np.asarray(first_draw_log_phi) > FAR).sum()),
                imm=float(imm_log_phi),
                max_log_phi=float(np.max(first_draw_log_phi)))


def _port(dtype):
    group, x, y = negbin_data()
    x = x.astype(np.float64) if dtype == torch.float64 else x
    res = sample_sharded(torch.Generator().manual_seed(5),
                         hier_negbin(group, x, y, 85, log_phi_prior=PRIOR),
                         torch.tensor(_start(), dtype=dtype), num_samples=1,
                         num_warmup=WARMUP, max_num_expansions=K,
                         initial_step_size=EPS0)
    assert res.positions.dtype == dtype
    assert bool(torch.isfinite(res.positions).all())
    return _record(res.positions.reshape(CHAINS, 89)[:, -1].numpy(),
                   res.inverse_mass_matrix[-1])


def _reference():
    group, x, y = negbin_data()
    res = jax_pooled.sample_sharded(
        jax.random.PRNGKey(5),
        jax_hier_negbin(group, x, y, 85, jnp.float64, log_phi_prior=PRIOR),
        jnp.asarray(_start()), num_samples=1, num_warmup=WARMUP,
        max_num_expansions=K, initial_step_size=EPS0)
    pos = np.asarray(res.positions).reshape(CHAINS, 89)
    assert pos.dtype == np.float64 and np.isfinite(pos).all()
    return _record(pos[:, -1], np.asarray(res.inverse_mass_matrix)[-1])


def test_fault_g_witness_float64_float32_and_the_reference():
    runs = {"port float64": _port(torch.float64),
            "port float32": _port(torch.float32),
            "reference float64": _reference()}
    print(runs)
    assert runs["port float64"]["stranded"] == 0
    assert runs["reference float64"]["stranded"] == 0
    ratio = runs["port float64"]["imm"] / runs["reference float64"]["imm"]
    assert 0.5 < ratio < 2.0, runs
