#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Builds every CUDA kernel from ``aehmc_tpu_torch/csrc`` (one nvcc per source,
all started together) and holds each against its plain PyTorch version at
the shapes of the main paths: 10,240 chains of the 100-d, 1,000-point
logistic regression.  Then it drives the port's front door
(``aehmc_tpu_torch.sample``) on that posterior:

- phases 2-7, fused NUTS: 150 Stan warmup steps and 200 draws with
  max_num_expansions=6 and bf16 draw storage (kernels ``nuts_transition``
  and ``nuts_sampling``);
- phases 8-10: the GHMC kernels (``ghmc_transition``, ``ghmc_segment``) and
  the two leapfrog kernels (``fused_logistic_hmc``, ``batched_leapfrog``;
  kernel 9's device time alone with L2 cold and warm, and its wrapper's
  host time a call, beside the back-to-back reading);
- phase 11, fused MALA: 150 warmup steps from ε 0.1 and 600 float32 draws
  in segments of 32 (the JAX benchmark's ``mala_10k_fused`` cell);
- phase 12, fused GHMC at α 0.9: 150 warmup steps and 200 draws;
- phase 13: the ChEES kernel (``chees_transition``) against its plain
  version and against the GHMC kernel at α 0;
- phase 14, the fused ChEES front door: 150 warmup steps from ε 0.05 and
  200 draws, one launch per step (the JAX benchmark's ``chees_fused`` leg);
- phases 15-16: the standard-layout NUTS kernels (``nuts_transition_std``,
  ``nuts_sampling_std``) against their plain versions and kernel 1, then the
  standard branch of the adaptive driver (150 + 200 launches of kernel 3)
  and ``sample_fused_logistic`` with bfloat16 operands (one launch of
  kernel 4);
- phase 17: the model builder's default data, bfloat16: kernels 1, 2, 5, 6
  and 7 against their plain bfloat16 versions, the fused NUTS front door on
  those data (150 + 200, phase 5's limits, means within 0.02 posterior sd
  of phase 5's) and short MALA, GHMC and ChEES front doors on them;
- phase 18, Neal's funnel (dim 10) and phase 19, eight schools: kernels 1
  and 2 with the ``FunnelPG`` and ``EightSchoolsPG`` functors against their
  plain versions (single transitions at ε 0.2, K 4; the whole-run kernel
  equal to per-draw launches bit for bit), then the fused NUTS front door
  at the JAX benchmark's cells (``funnel_fused_adaptive``: 8,192 chains,
  300 + 200; ``eight_schools_fused``: 2,048 chains, 500 + 500; K 10, target
  0.85), the funnel held to the JAX gate's limits on v, eight schools' means
  to a plain sampler's on the card (256 chains), both run twice with one
  generator seed and equal bit for bit;
- phases 20-23, the XLA path for any ``logprob_fn`` (autograd gradients,
  chain-batched host loops): phase 20 holds one XLA NUTS step against
  kernel 1 fed the same Philox seed (decisions on ≥ 99% of chains, |Δq| ≤
  1e-3) and counts its host syncs; phase 21 runs the JAX benchmark's
  reference-anchored configs (``benchmarks/run.py:179-416``): the README
  NUTS chain, the linear-regression window adaptation (1,000 steps), the
  25-d dense-metric MVN (512 chains), the 10,240-chain logistic posterior
  with pooled warmup (K 8), these two at 100 of their 200 draws, and the
  funnel at depth 10 (512 chains, its 200 draws cut to 8; its deepest
  trees held instead by one XLA NUTS step at K 10 against kernel 1 with
  ``FunnelPG``, 8,192 chains at ε 0.005, the limits of phase 20); phase
  22 drives the front door's ``xla`` route (one chain, and 64 independent
  chains through the batched ``sample_chains``) and ``pooled`` routes
  (NUTS, HMC, MALA, GHMC), each twice with one seed and equal bit for bit;
  phase 23 holds the XLA ChEES step on kernel 8 (``chees.new_kernel(
  integrate_fn=ops.logistic_integrate_fn(X, y))``) against the autograd
  leapfrog and runs the pooled ChEES front door on it, kernel 8's main
  path;
- phases 24-27, MEADS and checkpoint/resume: phase 24 drives the front
  door's fused MEADS route at the JAX benchmark's
  ``meads_10k_chains_100d_fused_seg`` cell (500 burn-in + 500 draws,
  re-estimation every 8: 126 launches of ``ghmc_segment``), twice with one
  seed and equal bit for bit, held to MALA's limits with acceptance above
  0.5, and times it by phase; phase 25 holds kernels 5 and 6 against their
  plain versions at MEADS's final state (per-chain ε, α and ``(chains,
  dim)`` M⁻¹) and the XLA fold transition against kernel 5 under one Key;
  phase 26 runs the checkpointed MEADS route (``checkpoint_every`` 25:
  200 launches of ``ghmc_transition``) and resumes it after a kill in
  sampling and in burn-in, bit for bit; phase 27 resumes the fused NUTS
  driver and pooled ChEES on kernel 7 bit for bit and runs MEADS on
  ``path="pooled"`` (the XLA fold transition) against phase 5's means;
- phases 28-33, per-chain ε and the fused drivers' options on it: phase 28
  holds kernels 1 and 2 at a per-chain ε (0.5x-2x the tuned scalar) against
  their plain versions (the flagship at 10,240 chains, the funnel at 1,024)
  and a constant ε vector against the scalar run bit for bit, and times
  both kernels at the scalar, the constant vector and the per-chain row in
  one process (the funnel's at 8,192 chains); phase 29 runs the JAX
  benchmark's ``funnel_fused_adaptive`` cell unsorted and with
  ``sort_by_depth`` (kernel 1 a warmup step and a draw), held to the JAX
  gate, with walls, grad-evals/s and lockstep ratios in the order the
  kernel saw the chains; phase 30 its per-chain, quantile-snapped and
  riffled ε cells against their JAX gates; phase 31 the flagship front door
  from ε 0.1 with and without ``search_initial_step_size``; phase 32 the
  flagship NUTS (kernel 2 at the per-chain ε), MALA and GHMC front doors
  with per-chain dual averaging snapped to 8 values; phase 33 a sorted
  funnel run checkpointed, killed and resumed bit for bit;
- phases 34-38, any potential on kernels 1-4 through a functor generated
  from its traced gradient graph (``ops/generic_pg.py``, built in phase 1
  with the sources): phase 34 binds the flagship potential as a plain
  torch callable (X and y closed over), prints the traced ops, the IR
  size, the workspace, ptxas's registers and spills and the blocks per SM,
  and holds the functor's gradient at kernel 1's q_out to float64
  autograd and the plain back end (relative 1e-5); phase 35 holds the four
  generated kernels against their plain versions and against the
  hand-written ``LogisticPGT`` ones (≥ 99% of decisions, |Δq| ≤ 1e-3) and
  times all of them; phase 36 runs the JAX benchmark's
  ``nuts_fused_generic_10k`` cell through ``ops.sample_fused`` (kernel 3 a
  draw, then kernel 4 once), phase 37 its ``mvn25_fused`` (512 and 2,048
  chains) and ``mvn25_dense_fused_adaptive`` cells at their gates, and
  phase 38 the front door on a bare ``logprob_fn`` (the generic fused
  binding: 150 launches of ``nuts_transition_generic``, one of
  ``nuts_sampling_generic``), twice with one seed, equal bit for bit;
- phases 39-43, any potential on the HMC core (kernels 5-7 on a generated
  functor, ``csrc/hmc_generic.cu``; the funnel and eight schools too, on the
  functors traced from ``funnel_pg_t`` and ``schools_pg_t``): phase 39 holds
  kernels 5 (α 0.9), 6 (32 draws, equal to 32 launches of kernel 5 bit for
  bit) and 7 (L 10) on the flagship's generated functor at phases 8, 9 and
  13's state against their plain versions (``generic_pg.run_plain`` as the
  potential) and against ``LogisticPGT``, kernel 7 at α 0 against kernel 5,
  and kernel 7 with a dense M⁻¹ on phase 37's mvn25 functor, and times each
  beside ``LogisticPGT``; phase 40 holds kernels 5-7 on the funnel (8,192
  chains, dim 10, from N(0, 1), ε 0.05) and eight schools (2,048 chains, ε
  0.2) against their plain versions and against the functor of the same
  potential differentiated in the trace, and times both; phase 41 runs the
  MALA, GHMC (α 0.9) and ChEES front doors on the flagship's bare
  ``logprob_fn`` at phases 11, 12 and 14's cells, phase 42 MEADS at phase
  24's and checkpointed at phase 26's 100 + 100, each twice with one seed,
  equal bit for bit, only the ``_generic`` counts moving, held to the
  hand-written route's limits and its means within 4.5 combined MCSE; phase
  43 runs eight schools' ChEES and MEADS front doors (2,048 chains, 500 +
  500) held to phase 19's NUTS means, and eight schools' GHMC and the
  funnel's MALA and ChEES front doors, so that kernels 5-7 run on each
  model's front door, every run's launches checked exactly;
- phases 44-47, a device mesh (one process; a mesh may name the card
  more than once): phase 44 launches kernels 1-5 and 7 (kernel 6 is
  never sharded and keys on its launch's chains) on ``LogisticPGT`` and
  on the flagship's generated functor at chain offsets 0, 2,560, 5,120
  and 7,680 (Philox), joins the four shards and holds them to the whole
  launch bit for bit, and each shard to its plain version fed the same
  offset streams at phase 2's limits; phase 45 runs phase 5's fused NUTS
  front door on ``make_mesh(devices=[cuda:0] * 4)`` and on
  ``make_multislice_mesh(2, devices=[cuda:0] * 4)``, each equal to the
  unsharded run bit for bit (positions, stats, final state, ε, M⁻¹) with
  kernel 1 launched 4 times a warmup step and kernel 2 4 times, and
  records the walls; phase 46 does the same on the 4-shard mesh for phase
  14's fused ChEES front door, phase 24's MEADS cell on the fused
  transition route (kernel 5 a draw, against the unsharded transition
  route) and phase 22's ``pooled_nuts`` cell (the XLA path, whose cuBLAS
  gradient sums a shard's rows in another order than the whole batch's:
  held by its tuned ε and M⁻¹ within relative 1e-3 and its first 10 draws
  chain by chain, 99% of the chains with equal decisions and within 1e-2,
  besides one sharded step and the means); phase 47 runs phase 45 on
  distinct cards when ``torch.cuda.device_count() > 1``, and says that it
  did not run otherwise;
- phases 48-50, the potential compiler's op table: four bare logprobs
  whose functors need its triangular solves, gathers and scatter-adds,
  special functions and axis reductions (P1 ``models.correlated_mvn(25,
  0.5)``, P2 a negative-binomial varying-intercept regression at the radon
  study's 919 observations in 85 counties, P3 a four-component Gaussian
  mixture over 1,000 points, P4 probit regression on the flagship's
  design).  Phase 48 holds kernels 1, 3, 5 and 7 on each generated functor
  against their plain versions (10,240 chains for P1 and P4, 4,096 for P2
  and P3; 99% of decisions equal, |Δq| <= 1e-3), each gradient against
  float64 autograd (within 4x of the plain float32 gradient's error), P1's
  kernel 1 against phase 37's precision-form functor, and times each with
  its bound; phase 49 runs P1 through the fused NUTS (phase 37's adaptive
  dense-M⁻¹ cell: 2,048 chains, 300 + 300, K 8), ChEES (10,240 chains,
  phase 41's schedule) and MEADS (10,240 chains, 500 + 6,000) front doors,
  each twice and equal bit for bit, at the usual acceptance bands,
  divergences below 0.01%, R-hat below 1.01, means within 4.5 MCSE of 0, variances and the tuned M⁻¹'s off-diagonal/diagonal
  ratio within 0.1 of 1 and 0.5, launches exact, then checkpointed MEADS
  (kernel 5 a draw, 100 + 100: finite, launches exact, twice bit for
  bit); phase 50 runs P2 through
  the fused NUTS front door (4,096 chains, 300 + 300) and the pooled XLA
  route (torch.func's gradient; 512 of those chains, 100 + 100 at K 3),
  both from one start made with numpy (0.1·N(0, 1), the mean at the log
  of the mean count), means within 4.5 combined MCSE;
- phases 51-53, the rest of the op table: three bare logprobs written as
  users write them (R1 ``softmax_reg``: multinomial logistic regression,
  1,000 points, 20 features, 5 classes, ``max(dim=1)`` and
  ``[arange(N), y - 1]``; R2 ``weibull_mice``: Weibull regression with
  right censoring on 80 mice, ``isnan``, bool masks, an indexed assignment
  and a tensor exponent; R3 ``sur_solve``: a seemingly-unrelated
  regression through ``torch.linalg.solve`` of a matrix that depends on
  q).  Phase 51 holds kernels 1, 3, 5 and 7 on each against their plain
  versions as phase 48 does (10,240 chains for R1 and R2, 4,096 for R3),
  and kernels 2 and 6 where a front door launches them against kernels 1
  and 5 draw by draw (phase 48 does the same for P1 and P2); phase 52 runs
  R1 through the fused NUTS door (4,096 chains, 150 + 200,
  K 6, a dense M⁻¹) against the pooled XLA route (512 of its chains, 100 + 200, K 4, a
  dense M⁻¹), R2 through the fused NUTS (150 + 1,000) and MEADS (500 +
  8,000) doors, R3 through the fused ChEES (150 + 1,000) and NUTS (150 +
  200) doors, R2's NUTS and R3's doors twice and equal bit for bit, every run at
  §2's limits (R-hat below 1.01) and means within 4.5 combined MCSE of
  each other; phase 53 probes fault G (the pooled XLA route on P2 under
  log φ ~ N(0, 4) from 0.1·N(0, 1), 512 chains, 50 + 50,
  K 4, in float32 and float64: chains stranded at log φ > 10, none in
  float64, the tuned M⁻¹) and ``lgamma`` (the functor's against torch's
  on the card, element by element; P2's gradient, kernel against plain
  and plain against itself);
- phases 54-55, the last of the op table (ROADMAP.md item 1.10c) on six
  bare logprobs (S1 ``gp_se64``: a GP's marginal likelihood through a
  64 × 64 Cholesky factor; S2 ``gp_se64_logdet``: the same through
  ``logdet`` and a general solve; S3 ``lkj_slopes``: varying intercepts
  and slopes under an LKJ prior, written with ``torch.distributions``,
  dim 135; S4 ``ordinal_sorted``: ordered-logistic regression through
  ``torch.sort``; S5 ``matrix_log_cov``: a normal whose covariance is
  exp(A(q)) through ``eigh``; S6 ``lts_topk``: least trimmed squares
  through ``topk``) and ``op_extras`` (``scatter_reduce`` by a data index,
  integer arithmetic on per-chain indices): phase 54 holds kernels 1, 3, 5
  and 7 on each against their plain versions as phase 48 does (kernels 2
  and 6 on S1 against kernels 1 and 5 draw by draw) and S1's kernel 1 on
  chains sent where K is not positive definite (divergent, not raised);
  phase 55 runs S1's fused NUTS, S3's fused ChEES and S5's fused MEADS
  doors (4,096 chains), S1's and S5's against the pooled XLA NUTS route on
  the same model (512 chains), S3's against its fused NUTS door (4,096
  chains), every run at §2's limits and the means within 4.5 combined
  MCSE.

Phase 1 prints each kernel's launch geometry (chains a block, points a
chunk of X, shared memory a block, from ``ops/launch_plan.py``), ptxas's
registers and spills, and for kernels 1-8 the blocks an SM holds (the
occupancy API, float32 and bfloat16 X; kernel 8 float32), failing below
two for any of them (kernel 8 at its 16 chains a block), and the same for
kernels 5-7 on the generated functors of the flagship, the funnel and
eight schools; phases 2 and 8 hold
kernels 1 and 5's gradients at their own q_out against float64, within 4x
of the plain float32 gradient's error; phases 8, 10, 13 and 15 also run
kernels 5, 8, 7 and 3 on ragged chain counts against their plain versions,
and phases 2 and 15
print the lockstep ratio of the NUTS tree sizes (what a block of more
chains would idle).

Launch counts are reset just before each front-door run and read just after;
the ``kernels`` entries of kernels 5 and 6 also carry their MEADS launches
(phases 26 and 24) and their times at MEADS's state (phase 25), those of
kernels 1 and 2 (flagship and funnel) their per-chain ε launches, errors,
times and bounds (phases 28-33), and those of kernels 1-4 their
``generic_*`` fields: the generated functor's time, launches on its main
path (phases 38 and 36), bound, error against plain and against the
hand-written functor (phase 35), and those of kernels 1-5 and 7 their
``offset_check`` (phase 44) and ``mesh_launches`` (phases 45-46's
sharded runs); kernels 1, 3, 5 and 7's entries carry ``generic_ops``, one
record a potential of phases 48-55 (launches on phases 49-50, 52 and
55's front doors, error, times, bound, registers, spills, blocks per SM,
workspace), and kernels 2 and 6's ``generic_ops_launches`` and
``generic_ops_sampling`` (time over a few draws and bound, phases 48, 51
and 54).  Kernels 5-7 on the flagship's, the
funnel's and eight schools' generated functors have entries of their own
(``ghmc_transition_generic``, ``chees_transition_generic (funnel)``, ...):
launches from phases 41-43, errors and times from phases 39-40, registers
and spills from phase 1.
Run from the repository root: ``python3 chip_smoke.py``.  Last, the GHMC
and ChEES front doors (phases 12 and 14) run again with two more generator
seeds and are held to the same limits, every run measured first.  It needs one CUDA
card and ``nvcc``; it exits non-zero, printing no result, when there is no
card or any phase fails.  The line before the last is a JSON object with each
kernel's launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Full measurements are also written to
``chiprun_out/chip_smoke.json``.
"""

import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

DIM, POINTS, CHAINS, K = 100, 1000, 10_240, 6
WARMUP, DRAWS = 150, 200
EPS, IMM = 0.5, 0.34          # phase 2-4 and 8 kernel inputs
DECISION_SHARE = 0.99         # chains whose decisions must match exactly
Q_ATOL = 1e-3                 # |q_kernel - q_plain| on those chains
MCSE_Z = 4.5                  # phases 6, 11, 12: per-dimension mean agreement
PHASE6_CHAINS = 1024
MALA_DRAWS, GHMC_DRAWS, SEGMENT, GHMC_ALPHA = 600, 200, 32, 0.9
LEAPFROG_STEPS = 10           # phases 10 and 13
CHEES_EPS0 = 0.05             # phase 14: initial step size of the search
CHEES_ACCEPT = (0.55, 0.80)   # phase 14: ChEES targets 0.651
MAX_L = 1024                  # ChEES trip-count cap
K7_SHARE = 0.999              # phase 13: kernel 7 vs kernel 5 at alpha 0
RAGGED = (10_248, 10_245, 9)  # phases 8, 10, 13, 15: counts off the block
LOCKSTEP_GROUPS = (8, 16, 32, 64)
# phase 15: with bfloat16 operands an f32 difference in the last bit can
# move a bfloat16 rounding of one gradient operand by one step (2^-8
# relative), so kernel 3 and its plain version agree on q to 1e-2 there
Q_ATOL_BF16 = 1e-2
# phase 16: with bfloat16 operands the chains target exp(-U) of the rounded
# potential.  Two kernel 4 runs (two seeds) are held within MCSE_Z combined
# MCSE of the plain bf16 sampler's means (the same rounded target), and
# within BF16_BIAS_SD posterior sd of phase 5's float32 means, which the
# rounded target's means miss by a fixed amount (7.6 combined MCSE, under
# 0.01 posterior sd, in the first run)
BF16_BIAS_SD = 0.02
BF16_SEEDS = (161, 162)         # phase 16: kernel 4's two runs
BF16_PLAIN_SEED = 163           # phase 16: the plain bf16 witness
# GHMC's and ChEES's means sat 3.88 and 2.27 combined MCSE from NUTS's at
# phases 12 and 14's seeds: two more seeds each tell a bias from chance
EXTRA_SEEDS = (112, 113)
# phase 1: kernel 1 at a dim of each (points, blocks per SM) the NUTS plan
# gives: 128/64/32/16/8 points at two blocks, then 128, 64 and 8 at one
SWEEP_DIMS = (100, 101, 140, 164, 184, 189, 240, 392)
# Split R-hat of a stationary chain with autocorrelation time tau and n
# draws per split chain is about sqrt((n - 1) / (n - tau)), 1.027 for MALA's
# tau of about 16.5 at 600 draws.  MALA and GHMC are held, per dimension, to
# that value (tau from the same run's bulk ESS) plus RHAT_EXCESS.
RHAT_EXCESS = 0.005
RHAT_MAX = 1.01   # PERF.md §2's R-hat limit
# lag-1 autocorrelation of the draw-to-draw moves: near 0 for MALA (-0.073
# on an H100), high when the momentum persists (0.558 at alpha 0.9)
MALA_MOVE_AC, GHMC_MOVE_AC = 0.1, 0.3
# H100 SXM: float32 FLOP/s on the CUDA cores, dense TF32 and bf16
# tensor-core FLOP/s (f32 accumulation), HBM B/s.  Float32-accurate products
# can run on the tensor cores as 3xTF32 (three TF32 products each,
# tests/test_torch_tf32.py), so the least time the card takes for the data
# products is their FLOP over PEAK_TF32 / 3; the CUDA-core bound is recorded
# too.
PEAK_F32, PEAK_TF32, PEAK_BF16, PEAK_BYTES = 67e12, 495e12, 989e12, 3.35e12
PEAK_TF32X3 = PEAK_TF32 / 3
# phases 2 and 8: a kernel's gradient error against float64 at its own
# q_out, at most this many times the plain float32 gradient's there
GRAD_ERR_RATIO = 4.0
GRAD_FLOP = 4 * DIM * POINTS  # X·q and Xᵀ·r, 2 FLOP per multiply-add
DEVICE = "cuda:0"
# phases 18-19: Neal's funnel and eight schools through the fused NUTS
# kernels at the JAX benchmark's cells (benchmarks/run.py:783-815
# funnel_fused_adaptive: dim 10, 8,192 chains, 300 warmup, 200 draws;
# :1640-1673 eight_schools_fused: 2,048 chains, 500 + 500), K 10, target
# acceptance 0.85.  Kernel against plain on single transitions at the JAX
# test's ε 0.2 and K 4 (tests/test_nuts_fused_small.py:306-342): funnel
# trajectories are chaotic near the neck, and expf on the card against
# torch.exp may differ in the last bit
FUNNEL_DIM, FUNNEL_CHAINS, FUNNEL_WARMUP, FUNNEL_DRAWS = 10, 8192, 300, 200
SCHOOLS_CHAINS, SCHOOLS_WARMUP, SCHOOLS_DRAWS = 2048, 500, 500
HIER_K, HIER_TARGET, HIER_EPS, HIER_CHECK_K = 10, 0.85, 0.2, 4
HIER_DRAWS = 4                # kernel 2's timed run, and its plain version's
# (10 before: cut with the plain timings' warm-up calls and eight schools'
# witness to hold the run under its 1,200 s)
# the funnel's limits, the JAX gate's (tests/test_nuts_fused_tpu.py:151-186):
# acceptance above 0.6; v over draws 50 onward: |mean| < 0.8, |sd - 3| < 0.5
FUNNEL_ACCEPT, FUNNEL_BURN, FUNNEL_V_MEAN, FUNNEL_V_SD = 0.6, 50, 0.8, 0.5
# eight schools' witness: the plain sampler on the card (plain transitions,
# the same Stan warmup) at a reduced chain count (the plain version walks
# every leaf of a block's deepest tree in PyTorch calls)
SCHOOLS_WITNESS_CHAINS = 256
# its warmup and draws (cut from 500 + 500, 61.8 s of plain transitions on
# an H100 host, to make room for phases 54-55)
SCHOOLS_WITNESS_WARMUP, SCHOOLS_WITNESS_DRAWS = 150, 150  # 250, 250 before


def log(msg):
    print(msg, flush=True)


T_START = time.perf_counter()


def stamp(record, phases):
    """The script's elapsed seconds once ``phases`` have run."""
    elapsed = time.perf_counter() - T_START
    record.setdefault("elapsed_s", {})[phases] = elapsed
    log(f"elapsed {elapsed:.1f} s after phases {phases}")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def card_identity():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps, warm=True):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls after one
    warm-up call (none with ``warm`` false: an eager plain version the
    phase has already run once, whose seconds a call the run's budget
    cannot spend twice), by CUDA events."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def same_decisions(sk, sp):
    """Chains whose decisions agree: tree shape (stats rows 2-5: doublings,
    leaves, divergent, turning) equal, and the same proposal selected, read
    from its energy (row 0) to 1e-5 relative.  A near-tie uniform can flip a
    selection when the two versions round differently; such a chain is
    counted as disagreeing, not as a position error."""
    shape = (sk[..., 2:6, :] == sp[..., 2:6, :]).all(dim=-2)
    energy = (sk[..., 0, :] - sp[..., 0, :]).abs() <= 1e-5 * sp[..., 0, :].abs(
    ).clamp(min=1.0)
    same = shape & energy
    while same.ndim > 1:  # every draw of a multi-draw run
        same = same.all(dim=0)
    return same


def compare(kernel_out, plain_out, what, atol=Q_ATOL):
    """Decisions equal on >= 99% of chains; q within ``atol`` on those.
    Returns (share, max_abs_err, chains that differ)."""
    qk, _, _, sk = kernel_out
    qp, _, _, sp = plain_out
    same = same_decisions(sk, sp)
    share = float(same.float().mean())
    err = float((qk - qp).abs()[..., same].max()) if bool(same.any()) else math.inf
    check(share >= DECISION_SHARE, f"{what}: decisions agree on {share:.4f}")
    check(err <= atol, f"{what}: max |q| error {err:.3g} on agreeing chains")
    return share, err, int((~same).sum())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flop, moved, peak=PEAK_TF32X3):
    """(ms, what binds, ms on the CUDA cores): the larger of the FLOP over
    the peak of their operands' type (float32 products as 3xTF32 unless
    given) and the bytes over the memory rate; last, the same bound at the
    67 TFLOP/s float32 CUDA-core peak, the best the kernels' CUDA-core
    products could reach."""
    t_op, t_mem = flop / peak, moved / PEAK_BYTES
    t_cc = max(flop / PEAK_F32, t_mem) * 1e3
    return (max(t_op, t_mem) * 1e3, "operations" if t_op >= t_mem else "bytes",
            t_cc)


def grad_errors(torch, pg, data, q_t, g_kernel, what):
    """The largest |∇U − ∇U in float64| of a kernel's gradient ``g_kernel``
    (dim, C) at its own q_out ``q_t``, and of the plain float32 gradient
    there; checks the first is within GRAD_ERR_RATIO of the second."""
    X, XT, y = (d.double() for d in data)
    q64 = q_t.double()
    g64 = XT @ (torch.sigmoid(X @ q64) - y) + q64
    err_k = float((g_kernel.double() - g64).abs().max())
    err_p = float((pg(q_t, *data)[1].double() - g64).abs().max())
    check(err_k <= GRAD_ERR_RATIO * err_p,
          f"{what}: gradient error {err_k:.3g} against float64, the plain "
          f"float32 version's {err_p:.3g}")
    return err_k, err_p


def lockstep(leaves):
    """For groups of 8, 16, 32 and 64 consecutive chains: the sum over groups
    of (most leaves in the group x group size) over the sum of leaves, the
    gradient work a group would do in lockstep over the work it needs."""
    out = {}
    for g in LOCKSTEP_GROUPS:
        x = leaves[: leaves.numel() // g * g].reshape(-1, g).double()
        out[g] = float(x.max(dim=1).values.sum() * g / x.sum())
    return out


# kernel -> (source, the name its C++ entry functions contain)
ENTRIES = {
    "nuts_transition": ("nuts_fused_small.cu", "nuts_transition_kernel"),
    "nuts_sampling": ("nuts_fused_small.cu", "nuts_sampling_kernel"),
    "nuts_transition_std": ("nuts_fused.cu", "nuts_transition_kernel"),
    "nuts_sampling_std": ("nuts_fused.cu", "nuts_sampling_kernel"),
    "ghmc_transition": ("ghmc_fused.cu", "transition_kernel"),
    "ghmc_segment": ("ghmc_fused.cu", "segment_kernel"),
    "chees_transition": ("chees_fused.cu", "transition_kernel"),
    "fused_logistic_hmc": ("fused_hmc.cu", "fused_hmc_kernel"),
    "batched_leapfrog": ("leapfrog.cu", "batched_leapfrog_kernel"),
}
# NUTS kernel -> (source, its occupancy function, sampling flag)
NUTS_OCCUPANCY = {
    "nuts_transition": ("nuts_fused_small.cu", "nuts_blocks_per_sm", 0),
    "nuts_sampling": ("nuts_fused_small.cu", "nuts_blocks_per_sm", 1),
    "nuts_transition_std": ("nuts_fused.cu", "nuts_std_blocks_per_sm", 0),
    "nuts_sampling_std": ("nuts_fused.cu", "nuts_std_blocks_per_sm", 1),
}
# HMC kernel -> (source, its occupancy function, its first argument, X
# types it takes): blocks per SM at the plan's chains a block
HMC_OCCUPANCY = {
    "ghmc_transition": ("ghmc_fused.cu", "ghmc_blocks_per_sm", 0, 2),
    "ghmc_segment": ("ghmc_fused.cu", "ghmc_blocks_per_sm", 1, 2),
    "chees_transition": ("chees_fused.cu", "chees_blocks_per_sm", 0, 2),
    "fused_logistic_hmc": ("fused_hmc.cu", "fused_hmc_blocks_per_sm", None, 1),
}
# kernel -> its core in the launch plan
CORES = {"nuts_transition": "nuts", "nuts_sampling": "nuts",
         "nuts_transition_std": "nuts", "nuts_sampling_std": "nuts",
         "ghmc_transition": "hmc", "ghmc_segment": "hmc",
         "chees_transition": "hmc", "fused_logistic_hmc": "fused_hmc"}


def ptxas_report(log):
    """{kernel: (most registers, most spill-store bytes)} over the entry
    functions of each kernel in ptxas's -v output."""
    per_source, source, entry, spill = {}, None, None, 0
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif "Compiling entry function" in line:
            entry, spill = line.split("'")[1], 0
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes stack frame,")[1].split()[0])
        elif "Used" in line and "registers" in line and entry:
            regs = int(line.split("Used")[1].split()[0])
            per_source.setdefault(source, []).append((entry, regs, spill))
            entry = None
    out = {}
    for name, (src, fn) in ENTRIES.items():
        hits = [(r, s) for e, r, s in per_source.get(src, []) if fn in e]
        if hits:
            out[name] = (max(r for r, _ in hits), max(s for _, s in hits))
    return out


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
    """One entry of the ``kernels`` line; ``chains_per_block`` is the launch
    plan's at the flagship's shape (null for kernel 9, which is elementwise
    over chains × dim)."""
    from aehmc_tpu_torch.ops.launch_plan import launch_plan

    chains = (launch_plan(CORES[name], DIM, K, CHAINS).chains
              if name in CORES else None)
    return dict(name=name, route="cuda", source=f"aehmc_tpu_torch/csrc/{source}",
                replaces=replaces, launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=None, chains_per_block=chains)


def ghmc_compare(torch, q_in, kernel_out, plain_out, what, atol=Q_ATOL):
    """GHMC decisions (accepted, divergent, and the selected energy to 1e-5
    relative) equal on >= 99% of chains in every draw; q within ``atol`` on
    those.  Outputs are ``(positions (D, dim, C), stats (D, 8, C))``.
    Returns (share, max_abs_err, chains that differ)."""
    def moves(pos):
        return (pos != torch.cat([q_in[None], pos[:-1]])).any(dim=1)

    (pk, sk), (pp, sp) = kernel_out, plain_out
    energy = (sk[:, 0] - sp[:, 0]).abs() <= 1e-5 * sp[:, 0].abs().clamp(min=1.0)
    same = ((moves(pk) == moves(pp)) & (sk[:, 4] == sp[:, 4]) & energy).all(0)
    share = float(same.float().mean())
    err = float((pk - pp).abs()[..., same].max()) if bool(same.any()) else math.inf
    check(share >= DECISION_SHARE, f"{what}: decisions agree on {share:.4f}")
    check(err <= atol, f"{what}: max |q| error {err:.3g} on agreeing chains")
    return share, err, int((~same).sum())


def chunked(torch, fn, x, step):
    """``fn`` over slices of the last axis of ``x`` (chains, draws, dim)."""
    return torch.cat([fn(x[:, :, i:i + step]) for i in range(0, x.shape[2], step)])


def mean_mcse(torch, diagnostics, x, with_ess=False):
    """Per-dimension mean and its Monte Carlo standard error of draws ``x
    (chains, draws, dim)``: ``diagnostics.mcse`` (sd with ddof 1 over √ESS),
    chunked over dimensions; with the bulk ESS too when ``with_ess``."""
    mcse, ess = (torch.cat(parts) for parts in zip(*(
        diagnostics.mcse(x[:, :, i:i + 10]) for i in range(0, x.shape[2], 10))))
    mean = x.reshape(-1, x.shape[2]).mean(dim=0)
    return (mean, mcse, ess) if with_ess else (mean, mcse)


def bulk_tail_ess(torch, diagnostics, x):
    """Per-dimension bulk and tail ESS of ``x (chains, draws, dim)``; their
    minimum capped at chains × draws and summed is bench.py's ESS."""
    return (chunked(torch, diagnostics.effective_sample_size, x, 10),
            chunked(torch, diagnostics.tail_effective_sample_size, x, 10))


def move_autocorrelation(x):
    """Mean lag-1 autocorrelation of the moves x[t+1] - x[t] of ``x (chains,
    draws, dim)``, per chain and dimension."""
    d = x[:, 1:] - x[:, :-1]
    d = d - d.mean(dim=1, keepdim=True)
    num = (d[:, 1:] * d[:, :-1]).mean(dim=1)
    var = (d * d).mean(dim=1)
    return float((num / var.clamp(min=1e-30)).mean())


def timed(torch, fn, runs):
    """Median host seconds of ``fn(run)`` over ``runs`` calls, each ending in
    a synchronize, and the last call's result."""
    times, out = [], None
    for r in range(runs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(r)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    return float(np.median(times)), out


def ghmc_phases(torch, ops, diagnostics, data, pot, pg, q0, record,
                nuts_mean, card):
    """Phases 8-12: the GHMC and leapfrog kernels against their plain
    versions, then the MALA and GHMC front doors.  Returns the four kernels'
    entries of the ``kernels`` line."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch.ops import fused_driver as fd
    from aehmc_tpu_torch.ops import ghmc_fused as gf
    from aehmc_tpu_torch.ops.fused_hmc import fused_logistic_hmc_reference
    from aehmc_tpu_torch.ops.leapfrog import batched_leapfrog_reference
    from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
    from aehmc_tpu_torch.ops.philox import MASK32
    from aehmc_tpu_torch.timing import host_ms, kernel_ms

    dev = q0.device
    rng = np.random.default_rng(8)
    pot_grad = lambda q_t: pg(q_t, *data)  # noqa: E731

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    q_t = q0.T.contiguous()
    u0, g0 = pg(q_t, *data)
    p0 = f32(np.sqrt(1.0 / IMM) * rng.standard_normal((DIM, CHAINS)))
    im = torch.full((DIM,), IMM, device=dev)
    ext = dict(noise=f32(np.sqrt(1.0 / IMM) * rng.standard_normal((DIM, CHAINS))),
               u_accept=f32(rng.uniform(size=(1, CHAINS))))
    state = (q_t, u0, g0, p0)

    # ---- phase 8: kernel 5 against the plain version
    shares = []
    for alpha in (0.0, GHMC_ALPHA):
        for rand in (ext, dict(seed=424242)):
            kern = gf.ghmc_transition_cuda(*state, EPS, alpha, im, data, **rand)
            plain = gf.ghmc_transition_plain(*state, EPS, alpha, im, pot_grad,
                                             **rand)
            torch.cuda.synchronize()
            what = (f"kernel 5 (alpha {alpha}, "
                    f"{'Philox' if 'seed' in rand else 'external'})")
            shares.append(ghmc_compare(
                torch, q_t, (kern[0][None], kern[4][None]),
                (plain[0][None], plain[4][None]), what))
    gerr5 = grad_errors(torch, pg, data, kern[0], kern[2], "kernel 5")
    for n_r in RAGGED:  # chain counts that leave the last block part-filled
        idx = torch.arange(n_r, device=dev) % CHAINS
        st_r = tuple(x[:, idx].contiguous() for x in state)
        k_r = gf.ghmc_transition_cuda(*st_r, EPS, 0.0, im, data, seed=808)
        p_r = gf.ghmc_transition_plain(*st_r, EPS, 0.0, im, pot_grad, seed=808)
        torch.cuda.synchronize()
        shares.append(ghmc_compare(
            torch, st_r[0], (k_r[0][None], k_r[4][None]),
            (p_r[0][None], p_r[4][None]), f"kernel 5, {n_r} chains"))
    share5 = min(sh for sh, _, _ in shares)
    err5 = max(e for _, e, _ in shares)

    def k5():  # the main path's case: MALA (alpha 0) under Philox
        return gf.ghmc_transition_cuda(*state, EPS, 0.0, im, data, seed=7)

    def p5():
        return gf.ghmc_transition_plain(*state, EPS, 0.0, im, pot_grad, seed=7)

    ms5, plain_ms5 = cuda_ms(torch, k5, 20), cuda_ms(torch, p5, 5)
    out5 = k5()
    bound5 = bound(CHAINS * GRAD_FLOP,
                   nbytes(*state, im, *data, *out5)
                   + 2 * CHAINS * 4)  # eps and alpha rows
    log(f"phase 8: ghmc_transition vs plain at {CHAINS}x{DIM}, eps {EPS}, "
        f"alpha 0 and {GHMC_ALPHA}, external and Philox randomness, and at "
        f"{RAGGED} chains (alpha 0, Philox): "
        f"decisions equal on >= {share5:.4%} of chains "
        f"({sum(d for _, _, d in shares)} chain-cases differ), max |q| err "
        f"{err5:.3g}; gradient at q_out against float64: kernel "
        f"{gerr5[0]:.3g}, plain float32 {gerr5[1]:.3g}; kernel {ms5:.3f} ms, "
        f"plain {plain_ms5:.3f} ms per "
        f"transition, bound {bound5[0]:.3f} ms ({bound5[1]}) [{card}]")
    record["phase8"] = dict(min_share=share5, max_abs_err=err5, ms=ms5,
                            plain_ms=plain_ms5, bound_ms=bound5[0],
                            bound_ms_cuda_cores=bound5[2], grad_err=gerr5[0],
                            plain_grad_err=gerr5[1])

    # ---- phase 9: kernel 6 (32 draws) == 32 launches of kernel 5, bitwise;
    # and kernel 6 against its plain version
    seed = 987654321
    pos, stats, *final = gf.ghmc_segment_cuda(*state, EPS, GHMC_ALPHA, im, data,
                                              SEGMENT, seed=seed)
    st_k = state
    for t in range(SEGMENT):
        *st_k, st = gf.ghmc_transition_cuda(
            *st_k, EPS, GHMC_ALPHA, im, data,
            seed=(seed + t * DRAW_SEED_STRIDE) & MASK32)
        check(torch.equal(st, stats[t]) and torch.equal(st_k[0], pos[t]),
              f"kernel 6 draw {t} differs from kernel 5")
    check(all(torch.equal(a, b) for a, b in zip(final, st_k)),
          "kernel 6 final state differs from kernel 5")
    pos_p, stats_p, *_ = gf.ghmc_segment_plain(
        *state, EPS, GHMC_ALPHA, im, pot_grad, SEGMENT, seed=seed)
    share6, err6, ndiff6 = ghmc_compare(torch, q_t, (pos, stats),
                                        (pos_p, stats_p),
                                        f"kernel 6 vs plain over {SEGMENT} draws")

    def k6():
        return gf.ghmc_segment_cuda(*state, EPS, 0.0, im, data, SEGMENT,
                                    seed=seed)

    def p6():
        return gf.ghmc_segment_plain(*state, EPS, 0.0, im, pot_grad, SEGMENT,
                                     seed=seed)

    ms6, plain_ms6 = cuda_ms(torch, k6, 5), cuda_ms(torch, p6, 1)
    out6 = k6()
    bound6 = bound(SEGMENT * CHAINS * GRAD_FLOP,
                   nbytes(*state, im, *data, *out6) + 2 * CHAINS * 4)
    log(f"phase 9: ghmc_segment over {SEGMENT} draws == {SEGMENT} "
        f"ghmc_transition launches bit for bit (positions, stats, final "
        f"state, alpha {GHMC_ALPHA}); vs plain: decisions equal on "
        f"{share6:.4%} of chains in every draw ({ndiff6} differ), max |q| "
        f"err {err6:.3g}; kernel {ms6:.2f} ms, plain {plain_ms6:.2f} ms per "
        f"{SEGMENT}-draw segment, bound {bound6[0]:.3f} ms ({bound6[1]}) "
        f"[{card}]")
    record["phase9"] = dict(share=share6, differ=ndiff6, max_abs_err=err6,
                            ms=ms6, plain_ms=plain_ms6, bound_ms=bound6[0],
                            bound_ms_cuda_cores=bound6[2])
    del pos, pos_p, out6

    # ---- phase 10: kernels 8 and 9 against their plain versions
    X, y = data[0], data[2].reshape(-1)
    lf_p = f32(rng.standard_normal((CHAINS, DIM)))
    lam = f32(np.linspace(0.5, 2.0, DIM))
    im_lf = f32(np.linspace(0.8, 1.2, DIM))
    hmc_args = (q0, lf_p, X, y, im, 0.05, LEAPFROG_STEPS)
    lf_args = (q0, lf_p, lam, im_lf, 0.05, LEAPFROG_STEPS)
    ops.reset_launch_counts()  # each kernel's path: its entry point, once
    k8, k9 = ops.fused_logistic_hmc(*hmc_args), ops.batched_leapfrog(*lf_args)
    torch.cuda.synchronize()
    leapfrog_launches = {k: ops.LAUNCHES[k]
                         for k in ("fused_logistic_hmc", "batched_leapfrog")}
    check(all(n == 1 for n in leapfrog_launches.values()),
          f"leapfrog entry points launched {leapfrog_launches}")
    r8 = fused_logistic_hmc_reference(*hmc_args)
    r9 = batched_leapfrog_reference(*lf_args)
    err8 = max(float((a - b).abs().max()) for a, b in zip(k8, r8))
    check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-4) for a, b in zip(k8, r8)),
          f"kernel 8 vs plain: max |err| {err8:.3g}")
    for n_r in RAGGED:  # chain counts that leave the last block part-filled
        idx = torch.arange(n_r, device=dev) % CHAINS
        args_r = (q0[idx].contiguous(), lf_p[idx].contiguous(), *hmc_args[2:])
        k_r = ops.fused_logistic_hmc(*args_r)
        r_r = fused_logistic_hmc_reference(*args_r)
        e_r = max(float((a - b).abs().max()) for a, b in zip(k_r, r_r))
        check(all(torch.allclose(a, b, rtol=1e-4, atol=1e-4)
                  for a, b in zip(k_r, r_r)),
              f"kernel 8 vs plain at {n_r} chains: max |err| {e_r:.3g}")
        err8 = max(err8, e_r)
    check(torch.equal(k9[0], r9[0]) and torch.equal(k9[1], r9[1]),
          "kernel 9 differs from its plain version")
    ms8 = cuda_ms(torch, lambda: ops.fused_logistic_hmc(*hmc_args), 10)
    plain_ms8 = cuda_ms(torch, lambda: fused_logistic_hmc_reference(*hmc_args), 5)

    def launch9():
        return ops.batched_leapfrog(*lf_args)

    # kernel 9 alone on the card, L2 cold and warm (a CUDA graph of 50
    # calls, timing.kernel_ms); the wrapper's host time per call; and
    # back-to-back calls, which read the larger of the two
    ms9_cold = kernel_ms(launch9, 50, cold=True)
    ms9_warm = kernel_ms(launch9, 50)
    host_ms9 = host_ms(launch9, 200)
    ms9 = cuda_ms(torch, launch9, 50)
    plain_ms9 = cuda_ms(torch, lambda: batched_leapfrog_reference(*lf_args), 10)
    bound8 = bound(CHAINS * (LEAPFROG_STEPS + 1) * GRAD_FLOP,
                   nbytes(q0, lf_p, X, y, im, *k8))
    bound9 = bound(9 * CHAINS * DIM * LEAPFROG_STEPS,
                   nbytes(q0, lf_p, lam, im_lf, *k9), PEAK_F32)
    log(f"phase 10: fused_logistic_hmc vs plain at {CHAINS}x{DIM} and at "
        f"{RAGGED} chains, L {LEAPFROG_STEPS}: max |err| {err8:.3g}; kernel "
        f"{ms8:.3f} ms, plain "
        f"{plain_ms8:.3f} ms, bound {bound8[0]:.3f} ms ({bound8[1]}); "
        f"batched_leapfrog == plain bit for bit; kernel {ms9_cold * 1e3:.2f} "
        f"us alone with L2 cold, {ms9_warm * 1e3:.2f} us warm, the wrapper "
        f"{host_ms9 * 1e3:.2f} us of host time a call, back-to-back calls "
        f"{ms9 * 1e3:.2f} us; plain {plain_ms9 * 1e3:.1f} us, bound "
        f"{bound9[0] * 1e3:.2f} us ({bound9[1]}) [{card}]")
    record["phase10"] = dict(err8=err8, ms8=ms8, plain_ms8=plain_ms8,
                             bound_ms8=bound8[0],
                             bound_ms8_cuda_cores=bound8[2], ms9=ms9,
                             ms9_cold=ms9_cold, ms9_warm=ms9_warm,
                             host_ms9=host_ms9, plain_ms9=plain_ms9,
                             bound_ms9=bound9[0])

    # ---- phase 11: the MALA front door at full width
    front = dict(data=data, potential_fn_t=pot, potential_and_grad_t=pg,
                 initial_step_size=0.1, segment_draws=SEGMENT)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = aehmc_tpu_torch.sample(torch.Generator().manual_seed(11), None, q0,
                                 MALA_DRAWS, WARMUP, algorithm="mala",
                                 path="fused", **front)
    torch.cuda.synchronize()
    wall11 = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    segments = -(-MALA_DRAWS // SEGMENT)
    check(launches["ghmc_transition"] == WARMUP
          and launches["ghmc_segment"] == segments,
          f"MALA front door launches {launches}")
    mala = front_door_checks(torch, diagnostics, res, nuts_mean, "MALA")
    mala_ac = move_autocorrelation(res.positions.transpose(0, 1)[:, :, :10])
    del res
    check(mala_ac < MALA_MOVE_AC, f"MALA move autocorrelation {mala_ac}")

    common = dict(potential_and_grad_t=pg)
    t_warm, (state_w, (eps_w, imm_w)) = timed(
        torch, lambda r: fd.ghmc_warmup(
            torch.Generator().manual_seed(30 + r), pot, data, q0, WARMUP,
            initial_step_size=0.1, **common), 3)
    t_samp, (_, pos11, stats11) = timed(
        torch, lambda r: fd.ghmc_sampling(
            torch.Generator().manual_seed(40 + r), pot, data, state_w, eps_w,
            imm_w, MALA_DRAWS, alpha=0.0, segment_draws=SEGMENT, **common), 5)
    evals = float(stats11[:, :, 3].sum())
    bulk, tail = bulk_tail_ess(torch, diagnostics, pos11.transpose(0, 1))
    ess = float(torch.minimum(bulk, tail).clamp(max=CHAINS * MALA_DRAWS).sum())
    ess_s, e2e = ess / t_samp, ess / (t_warm + t_samp)
    del pos11
    log(f"phase 11: MALA front door {CHAINS}x{DIM}, {WARMUP} warmup + "
        f"{MALA_DRAWS} draws in {wall11:.2f} s; launches {launches}; accept "
        f"{mala['accept']:.4f}, divergent {mala['divergent_share']:.2e}, eps "
        f"{mala['step_size']:.4f}, max R-hat {mala['max_rhat']:.4f} (max "
        f"excess over stationary {mala['max_rhat_excess']:.4f}, tau max "
        f"{mala['tau_max']:.2f}), means within {mala['max_z_vs_nuts']:.2f} "
        f"MCSE of NUTS, move autocorrelation {mala_ac:.3f}; "
        f"timed: warmup {t_warm:.3f} s, sampling {t_samp:.3f} s, "
        f"{evals / t_samp / 1e6:.2f}M grad-evals/s, {ess_s / 1e6:.2f}M ESS/s "
        f"sampling, {e2e / 1e6:.2f}M ESS/s end to end, bulk ESS min "
        f"{float(bulk.min()):.0f} median {float(bulk.median()):.0f}, tail ESS "
        f"min {float(tail.min()):.0f} median {float(tail.median()):.0f} of "
        f"{CHAINS * MALA_DRAWS} [{card}]")
    record["phase11"] = dict(wall_s=wall11, launches=launches, **mala,
                             move_autocorrelation=mala_ac,
                             warmup_wall_s=t_warm, sampling_wall_s=t_samp,
                             grad_evals_per_s=evals / t_samp,
                             sampling_ess_per_s=ess_s, e2e_ess_per_s=e2e,
                             bulk_ess_min=float(bulk.min()),
                             bulk_ess_median=float(bulk.median()),
                             tail_ess_min=float(tail.min()),
                             tail_ess_median=float(tail.median()))
    mala_launches = launches

    # ---- phase 12: the GHMC front door, alpha 0.9
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = aehmc_tpu_torch.sample(torch.Generator().manual_seed(12), None, q0,
                                 GHMC_DRAWS, WARMUP, algorithm="ghmc",
                                 path="fused", ghmc_alpha=GHMC_ALPHA, **front)
    torch.cuda.synchronize()
    wall12 = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["ghmc_transition"] == WARMUP
          and launches["ghmc_segment"] == -(-GHMC_DRAWS // SEGMENT),
          f"GHMC front door launches {launches}")
    ghmc = front_door_checks(torch, diagnostics, res, nuts_mean, "GHMC")
    ghmc_ac = move_autocorrelation(res.positions.transpose(0, 1)[:, :, :10])
    del res
    check(ghmc_ac > GHMC_MOVE_AC, f"GHMC move autocorrelation {ghmc_ac}")
    log(f"phase 12: GHMC front door (alpha {GHMC_ALPHA}) {CHAINS}x{DIM}, "
        f"{WARMUP} warmup + {GHMC_DRAWS} draws in {wall12:.2f} s; launches "
        f"{launches}; accept {ghmc['accept']:.4f}, divergent "
        f"{ghmc['divergent_share']:.2e}, eps {ghmc['step_size']:.4f}, max "
        f"R-hat {ghmc['max_rhat']:.4f} (max excess over stationary "
        f"{ghmc['max_rhat_excess']:.4f}, tau max {ghmc['tau_max']:.2f}), "
        f"means within {ghmc['max_z_vs_nuts']:.2f} MCSE of NUTS, move "
        f"autocorrelation {ghmc_ac:.3f} against MALA's {mala_ac:.3f} [{card}]")
    record["phase12"] = dict(wall_s=wall12, launches=launches, **ghmc,
                             move_autocorrelation=ghmc_ac)

    return [
        kernel_entry("ghmc_transition", "ghmc_fused.cu",
                     "aehmc_tpu/ops/ghmc_fused.py:139",
                     mala_launches["ghmc_transition"], err5, ms5, plain_ms5,
                     bound5),
        kernel_entry("ghmc_segment", "ghmc_fused.cu",
                     "aehmc_tpu/ops/ghmc_fused.py:329",
                     mala_launches["ghmc_segment"], err6, ms6, plain_ms6,
                     bound6),
        kernel_entry("fused_logistic_hmc", "fused_hmc.cu",
                     "aehmc_tpu/ops/fused_hmc.py:82",
                     leapfrog_launches["fused_logistic_hmc"], err8, ms8,
                     plain_ms8, bound8),
        dict(kernel_entry("batched_leapfrog", "leapfrog.cu",
                          "aehmc_tpu/ops/leapfrog.py:68",
                          leapfrog_launches["batched_leapfrog"], 0.0,
                          ms9_cold, plain_ms9, bound9),
             ms_warm=ms9_warm, host_ms_per_call=host_ms9,
             ms_back_to_back=ms9),
    ]


def chees_compare(torch, q_in, kern, plain, what, atol=Q_ATOL,
                  energy_rtol=1e-5):
    """ChEES decisions (accepted, divergent, and the kept energy to
    ``energy_rtol`` relative) equal on >= 99% of chains; q, the proposed
    position and the proposed velocity within ``atol`` on those.  Outputs
    are ``(q, u, g, stats (C, 8), q_proposed, v_proposed)``.  Returns
    (share, max_abs_err, chains that differ)."""
    moved_k, moved_p = ((o[0] != q_in).any(dim=1) for o in (kern, plain))
    sk, sp = kern[3], plain[3]
    energy = ((sk[:, 0] - sp[:, 0]).abs()
              <= energy_rtol * sp[:, 0].abs().clamp(min=1.0))
    same = (moved_k == moved_p) & (sk[:, 4] == sp[:, 4]) & energy
    share = float(same.float().mean())
    err = max(float((kern[i] - plain[i]).abs()[same].max()) for i in (0, 4, 5))
    check(share >= DECISION_SHARE, f"{what}: decisions agree on {share:.4f}")
    check(err <= atol, f"{what}: max |q|, |qp|, |vp| error {err:.3g}")
    return share, err, int((~same).sum())


def chees_phases(torch, ops, diagnostics, data, pg, q0, record, nuts_mean,
                 card):
    """Phases 13-14: the ChEES kernel against its plain version and the GHMC
    kernel, then the ChEES front door.  Returns kernel 7's entry."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch import chees, hmc
    from aehmc_tpu_torch.models import logistic_regression
    from aehmc_tpu_torch.ops import chees_fused as cf
    from aehmc_tpu_torch.ops import ghmc_fused as gf

    dev = q0.device
    rng = np.random.default_rng(13)
    pot_grad = lambda q_t: pg(q_t, *data)  # noqa: E731

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    u_t, g_t = pg(q0.T.contiguous(), *data)
    state = (q0, u_t.reshape(-1), g_t.T.contiguous())
    im = torch.full((DIM,), IMM, device=dev)
    steps = torch.full((), LEAPFROG_STEPS, dtype=torch.int32, device=dev)
    ext = dict(momentum=f32(np.sqrt(1.0 / IMM) * rng.standard_normal((CHAINS, DIM))),
               u_accept=f32(rng.uniform(size=CHAINS)))

    # ---- phase 13: kernel 7 against its plain version and kernel 5
    cases = []
    for rand in (ext, dict(seed=131313)):
        kern = cf.chees_transition_cuda(*state, im, EPS, steps, data, **rand)
        plain = cf.chees_transition_plain(*state, im, EPS, LEAPFROG_STEPS,
                                          pot_grad, **rand)
        torch.cuda.synchronize()
        what = f"kernel 7 ({'Philox' if 'seed' in rand else 'external'})"
        cases.append(chees_compare(torch, q0, kern, plain, what))
    n = PHASE6_CHAINS
    A = rng.standard_normal((DIM, DIM))
    dense = f32(IMM * (A @ A.T / (4 * DIM) + np.eye(DIM)))
    eps_c = f32(rng.uniform(0.3, 0.6, size=n))
    small = tuple(x[:n].contiguous() for x in state)
    small_ext = dict(momentum=ext["momentum"][:n].contiguous(),
                     u_accept=ext["u_accept"][:n].contiguous())
    for rand in (small_ext, dict(seed=4242)):
        kern = cf.chees_transition_cuda(*small, dense, eps_c, steps, data, **rand)
        plain = cf.chees_transition_plain(*small, dense, eps_c, LEAPFROG_STEPS,
                                          pot_grad, **rand)
        torch.cuda.synchronize()
        what = (f"kernel 7, {n} chains, per-chain eps, dense M^-1 "
                f"({'Philox' if 'seed' in rand else 'external'})")
        cases.append(chees_compare(torch, small[0], kern, plain, what))
    for n_r in RAGGED:  # chain counts that leave the last block part-filled
        idx = torch.arange(n_r, device=dev) % CHAINS
        st_r = tuple(x[idx].contiguous() for x in state)
        kern = cf.chees_transition_cuda(*st_r, im, EPS, steps, data, seed=777)
        plain = cf.chees_transition_plain(*st_r, im, EPS, LEAPFROG_STEPS,
                                          pot_grad, seed=777)
        torch.cuda.synchronize()
        cases.append(chees_compare(torch, st_r[0], kern, plain,
                                   f"kernel 7, {n_r} chains"))
    share7 = min(sh for sh, _, _ in cases)
    err7 = max(e for _, e, _ in cases)
    k7 = cf.chees_transition_cuda(*state, im, EPS, steps, data, seed=99)
    k5 = gf.ghmc_transition_cuda(q0.T.contiguous(), u_t, g_t, torch.zeros_like(g_t),
                                 EPS, 0.0, im, data, num_steps=LEAPFROG_STEPS,
                                 seed=99)
    torch.cuda.synchronize()
    same75 = float((((k7[0] != q0).any(dim=1) == (k5[0].T != q0).any(dim=1))
                    & (k7[3][:, 4] == k5[4][4])).float().mean())
    check(same75 >= K7_SHARE,
          f"kernel 7 vs kernel 5 at alpha 0: decisions agree on {same75:.4f}")
    bitwise75 = bool(torch.equal(k7[0], k5[0].T))

    def k7_run():
        return cf.chees_transition_cuda(*state, im, EPS, steps, data, seed=7)

    def p7_run():
        return cf.chees_transition_plain(*state, im, EPS, LEAPFROG_STEPS,
                                         pot_grad, seed=7)

    ms7, plain_ms7 = cuda_ms(torch, k7_run, 10), cuda_ms(torch, p7_run, 3)
    out7 = k7_run()
    bound7 = bound(LEAPFROG_STEPS * CHAINS * GRAD_FLOP,
                   nbytes(*state, im, *data, *out7) + 4 + 4)  # eps and L
    log(f"phase 13: chees_transition vs plain at {CHAINS}x{DIM}, L "
        f"{LEAPFROG_STEPS}, eps {EPS}, external and Philox, {n} chains "
        f"with per-chain eps and a dense M^-1, and {RAGGED} chains (Philox): "
        f"decisions equal on >= "
        f"{share7:.4%} of chains ({sum(d for _, _, d in cases)} chain-cases "
        f"differ), max |q|, |qp|, |vp| err {err7:.3g}; vs ghmc_transition at "
        f"alpha 0, same seed: decisions equal on {same75:.4%} (positions bit "
        f"for bit: {bitwise75}); kernel {ms7:.3f} ms, plain {plain_ms7:.3f} "
        f"ms per transition, bound {bound7[0]:.3f} ms ({bound7[1]}) [{card}]")
    record["phase13"] = dict(min_share=share7, max_abs_err=err7,
                             share_vs_kernel5=same75,
                             bitwise_vs_kernel5=bitwise75, ms=ms7,
                             plain_ms=plain_ms7, bound_ms=bound7[0],
                             bound_ms_cuda_cores=bound7[2])

    # ---- phase 14: the ChEES front door at full width
    logprob_fn, _ = logistic_regression(DIM, POINTS, device=dev)
    new_states = torch.func.vmap(lambda q: hmc.new_state(q, logprob_fn))
    t_first, _ = timed(torch, lambda r: new_states(q0), 1)
    t_state, _ = timed(torch, lambda r: new_states(q0), 3)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(14), logprob_fn, q0, DRAWS, WARMUP,
        algorithm="chees", path="fused", data=data, potential_and_grad_t=pg,
        initial_step_size=CHEES_EPS0)
    torch.cuda.synchronize()
    wall14 = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    probes = launches["chees_transition"] - WARMUP - DRAWS
    check(1 <= probes <= 32 and sum(launches.values())
          == launches["chees_transition"],
          f"ChEES front door launches {launches}")
    steps14 = res.diagnostics.num_integration_steps[:, 0]
    check(bool((steps14 >= 1).all() & (steps14 <= MAX_L).all()),
          f"ChEES trip counts out of [1, {MAX_L}]")
    chees_stats = front_door_checks(torch, diagnostics, res, nuts_mean,
                                    "ChEES", accept_range=CHEES_ACCEPT)
    del res

    chees_kernel = cf.make_fused_chees_kernel(None, data,
                                              potential_and_grad_t=pg)
    warm_steps = []  # the trip count of every warmup launch, on the card

    def kernel_fn(key, states_, eps, num_steps, imm):
        warm_steps.append(num_steps)
        return chees_kernel(key, states_, eps, num_steps, imm)

    states = cf.initial_states(None, pg, data, q0)

    def warmup_run(r):
        warm_steps.clear()
        return chees.warmup(torch.Generator().manual_seed(140 + r), None,
                            states, WARMUP, initial_step_size=CHEES_EPS0,
                            kernel_fn=kernel_fn)

    t_warm, wres = timed(torch, warmup_run, 3)
    warm_l = float(torch.stack(warm_steps).sum())
    warm_launches = len(warm_steps)
    # the warmup's kernel time at phase 13's rate per leapfrog step
    warm_kernel_s = warm_l * ms7 / LEAPFROG_STEPS / 1e3
    eps14, h14 = float(wres.step_size), float(wres.trajectory_length)
    check(h14 > eps14, f"ChEES h {h14} not above eps {eps14}")
    t_samp, (_, pos14, info14) = timed(torch, lambda r: chees.sample(
        torch.Generator().manual_seed(150 + r), None, wres.states, DRAWS,
        wres.step_size, wres.trajectory_length, wres.inverse_mass_matrix,
        kernel_fn=kernel_fn), 5)
    steps_sum = float(info14.num_integration_steps.sum())
    evals = steps_sum * CHAINS
    bulk, tail = bulk_tail_ess(torch, diagnostics, pos14.transpose(0, 1))
    ess = float(torch.minimum(bulk, tail).clamp(max=CHAINS * DRAWS).sum())
    ess_s, e2e = ess / t_samp, ess / (t_warm + t_samp)
    del pos14
    log(f"phase 14: ChEES front door {CHAINS}x{DIM}, {WARMUP} warmup from eps "
        f"{CHEES_EPS0} + {DRAWS} draws in {wall14:.2f} s (chain states by "
        f"hmc.new_state {t_state:.3f} s, its first call in the process "
        f"{t_first:.3f} s); launches {probes} "
        f"probes + {WARMUP} + {DRAWS} = {launches['chees_transition']}; "
        f"accept {chees_stats['accept']:.4f}, divergent "
        f"{chees_stats['divergent_share']:.2e}, eps "
        f"{chees_stats['step_size']:.4f}, mean L {float(steps14.float().mean()):.2f}, "
        f"max R-hat {chees_stats['max_rhat']:.4f} (max excess over stationary "
        f"{chees_stats['max_rhat_excess']:.4f}, tau max "
        f"{chees_stats['tau_max']:.2f}), means within "
        f"{chees_stats['max_z_vs_nuts']:.2f} MCSE of NUTS; timed: warmup "
        f"{t_warm:.3f} s (eps {eps14:.4f}, h {h14:.3f}; {warm_launches} "
        f"launches, sum of L {warm_l:.0f}, kernel time at phase 13's rate "
        f"{warm_kernel_s:.3f} s), sampling "
        f"{t_samp:.3f} s, mean L {steps_sum / DRAWS:.2f}, "
        f"{evals / t_samp / 1e6:.2f}M grad-evals/s, {ess_s / 1e6:.2f}M ESS/s "
        f"sampling, {e2e / 1e6:.2f}M ESS/s end to end, bulk ESS min "
        f"{float(bulk.min()):.0f} median {float(bulk.median()):.0f} of "
        f"{CHAINS * DRAWS} [{card}]")
    record["phase14"] = dict(wall_s=wall14, new_state_s=t_state,
                             new_state_first_s=t_first,
                             launches=launches, probes=probes,
                             mean_steps_front_door=float(steps14.float().mean()),
                             **chees_stats, warmup_wall_s=t_warm,
                             sampling_wall_s=t_samp, timed_step_size=eps14,
                             warmup_launches=warm_launches,
                             warmup_sum_steps=warm_l,
                             warmup_kernel_s=warm_kernel_s,
                             timed_trajectory_length=h14,
                             mean_steps=steps_sum / DRAWS,
                             grad_evals_per_s=evals / t_samp,
                             sampling_ess_per_s=ess_s, e2e_ess_per_s=e2e,
                             bulk_ess_min=float(bulk.min()),
                             bulk_ess_median=float(bulk.median()),
                             tail_ess_min=float(tail.min()))
    return kernel_entry("chees_transition", "chees_fused.cu",
                        "aehmc_tpu/ops/chees_fused.py:61",
                        launches["chees_transition"], err7, ms7, plain_ms7,
                        bound7)


def standard_nuts_phases(torch, ops, diagnostics, data, q0, record, nuts_mean,
                         card):
    """Phases 15-16: the standard-layout NUTS kernels against their plain
    versions and kernel 1, then the standard branch of the adaptive driver
    and ``sample_fused_logistic``.  Returns kernels 3 and 4's entries."""
    from aehmc_tpu_torch.ops import nuts_fused as nf
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.ops.fused_driver import sample_fused_adaptive
    from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
    from aehmc_tpu_torch.ops.philox import MASK32

    dev = q0.device
    rng = np.random.default_rng(15)
    X, y = data[0], data[2].reshape(-1)
    im = torch.full((DIM,), IMM, device=dev)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    models = {cdt: nf._logistic_model(X, y, 1.0, cdt)
              for cdt in (torch.float32, torch.bfloat16)}
    u0, g0 = models[torch.float32].pot_grad(q0)
    ext = dict(momentum=f32(np.sqrt(1.0 / IMM) * rng.standard_normal((CHAINS, DIM))),
               directions=f32(np.where(rng.uniform(size=(CHAINS, K)) < 0.5, -1.0, 1.0)),
               u_bias=f32(rng.uniform(size=(CHAINS, K))),
               u_leaf=f32(rng.uniform(size=(CHAINS, 2**K))))

    # ---- phase 15: kernel 3 against its plain version (f32, bf16), against
    # kernel 1, and kernel 4 against 20 launches of kernel 3
    shares, errs = {}, {}
    for cdt, atol in ((torch.float32, Q_ATOL), (torch.bfloat16, Q_ATOL_BF16)):
        model = models[cdt]
        for rand in (ext, dict(seed=515151)):
            kern = nf.nuts_transition_std_cuda(q0, u0, g0, im, EPS, model.data,
                                               max_exp=K, card=model.card, **rand)
            plain = nf.nuts_transition_std_plain(
                q0, u0, g0, im, EPS, model.pot_grad,
                max_exp=K, **rand)
            torch.cuda.synchronize()
            same = same_decisions(kern[3].T, plain[3].T)
            share = float(same.float().mean())
            err = float((kern[0] - plain[0]).abs()[same].max())
            what = (f"kernel 3 ({'bf16' if model.card[1] else 'f32'}, "
                    f"{'Philox' if 'seed' in rand else 'external'})")
            check(share >= DECISION_SHARE, f"{what}: decisions agree on {share:.4f}")
            check(err <= atol, f"{what}: max |q| error {err:.3g}")
            key = "bf16" if model.card[1] else "f32"
            shares[key] = min(shares.get(key, 1.0), share)
            errs[key] = max(errs.get(key, 0.0), err)
    f32m, b16m = models[torch.float32], models[torch.bfloat16]
    k3 = nf.nuts_transition_std_cuda(q0, u0, g0, im, EPS, f32m.data, max_exp=K,
                                     seed=2468)
    k1 = nfs.nuts_transition_cuda(q0.T.contiguous(), u0.T.contiguous(),
                                  g0.T.contiguous(), im, EPS, data, max_exp=K,
                                  seed=2468)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b.T.reshape(a.shape)) for a, b in zip(k3, k1)),
          "kernel 3 on q differs from kernel 1 on q^T")
    for n_r in RAGGED:  # chain counts that leave the last block part-filled
        idx = torch.arange(n_r, device=dev) % CHAINS
        st_r = tuple(x[idx].contiguous() for x in (q0, u0, g0))
        kern = nf.nuts_transition_std_cuda(*st_r, im, EPS, f32m.data,
                                           max_exp=K, seed=5151)
        plain = nf.nuts_transition_std_plain(*st_r, im, EPS, f32m.pot_grad,
                                             max_exp=K, seed=5151)
        torch.cuda.synchronize()
        same = same_decisions(kern[3].T, plain[3].T)
        share = float(same.float().mean())
        err = float((kern[0] - plain[0]).abs()[same].max())
        what = f"kernel 3 (f32, Philox), {n_r} chains"
        check(share >= DECISION_SHARE, f"{what}: decisions agree on {share:.4f}")
        check(err <= Q_ATOL, f"{what}: max |q| error {err:.3g}")
        shares["f32"] = min(shares["f32"], share)
        errs["f32"] = max(errs["f32"], err)
    n4, seed = 20, 97531
    pos, stats, *final = nf.nuts_sampling_std_cuda(
        q0, u0, g0, im, EPS, b16m.data, seed, n4, max_exp=K, card=b16m.card)
    # each draw of kernel 4 (bf16 operands) against the plain bf16
    # transition from the kernel's own state: over a whole run one bf16
    # rounding step (see Q_ATOL_BF16) compounds into other decisions
    st_k = (q0, u0, g0)
    share4b, err4b = 1.0, 0.0
    for t in range(n4):
        seed_t = (seed + t * DRAW_SEED_STRIDE) & MASK32
        plain_t = nf.nuts_transition_std_plain(
            *st_k, im, EPS, b16m.pot_grad, max_exp=K, seed=seed_t)
        *st_k, st = nf.nuts_transition_std_cuda(
            *st_k, im, EPS, b16m.data, max_exp=K, card=b16m.card,
            seed=seed_t)
        check(torch.equal(st, stats[t]) and torch.equal(st_k[0], pos[t]),
              f"kernel 4 draw {t} differs from kernel 3")
        same = same_decisions(st.T, plain_t[3].T)
        share4b = min(share4b, float(same.float().mean()))
        err4b = max(err4b, float((st_k[0] - plain_t[0]).abs()[same].max()))
    check(all(torch.equal(a, b) for a, b in zip(final, st_k)),
          "kernel 4 final state differs from kernel 3")
    check(share4b >= DECISION_SHARE,
          f"kernel 4 (bf16) vs plain per draw: decisions agree on {share4b:.4f}")
    check(err4b <= Q_ATOL_BF16,
          f"kernel 4 (bf16) vs plain per draw: max |q| error {err4b:.3g}")
    # the whole run against the plain version with float32 operands
    pos32, stats32, *_ = nf.nuts_sampling_std_cuda(
        q0, u0, g0, im, EPS, f32m.data, seed, n4, max_exp=K, card=f32m.card)
    pos_p, stats_p, *_ = nf._sampling_plain(
        f32m, q0, u0, g0, im, EPS, seed, n4, max_exp=K,
        divergence_threshold=1000.0, collect_positions=True)
    same4 = same_decisions(stats32.transpose(1, 2), stats_p.transpose(1, 2))
    share4 = float(same4.float().mean())
    err4 = float((pos32 - pos_p).abs()[:, same4].max())
    check(share4 >= DECISION_SHARE,
          f"kernel 4 vs plain: decisions agree on {share4:.4f}")
    check(err4 <= Q_ATOL, f"kernel 4 vs plain: max |q| error {err4:.3g}")
    del pos_p

    def k3_run():
        return nf.nuts_transition_std_cuda(q0, u0, g0, im, EPS, f32m.data,
                                           max_exp=K, seed=11)

    def p3_run():
        return nf.nuts_transition_std_plain(
            q0, u0, g0, im, EPS, f32m.pot_grad,
            max_exp=K, seed=11)

    def k4_run():
        return nf.nuts_sampling_std_cuda(q0, u0, g0, im, EPS, b16m.data, seed,
                                         n4, max_exp=K, card=b16m.card)

    def p4_run(model=b16m):
        return nf._sampling_plain(model, q0, u0, g0, im, EPS, seed, n4,
                                  max_exp=K, divergence_threshold=1000.0,
                                  collect_positions=True)

    ms3, plain_ms3 = cuda_ms(torch, k3_run, 5), cuda_ms(torch, p3_run, 3)
    ms4, plain_ms4 = cuda_ms(torch, k4_run, 3), cuda_ms(torch, p4_run, 1)
    ms4_f32 = cuda_ms(torch, lambda: nf.nuts_sampling_std_cuda(
        q0, u0, g0, im, EPS, f32m.data, seed, n4, max_exp=K), 3)
    plain_ms4_f32 = cuda_ms(torch, lambda: p4_run(f32m), 1)
    out3 = k3_run()
    lockstep15 = lockstep(out3[3][:, 3])
    bound3 = bound(float(out3[3][:, 3].sum()) * GRAD_FLOP,
                   nbytes(q0, u0, g0, im, *f32m.data, *out3))
    # kernel 4's entry is the main path's configuration, bf16 operands: its
    # products are bf16 x bf16 with f32 sums, the bf16 tensor-core peak's work
    bound4 = bound(float(stats[:, :, 3].sum()) * GRAD_FLOP,
                   nbytes(q0, u0, g0, im, *b16m.data, pos, stats, *final),
                   PEAK_BF16)
    bound4_f32 = bound(float(stats32[:, :, 3].sum()) * GRAD_FLOP,
                       nbytes(q0, u0, g0, im, *f32m.data, pos, stats, *final))
    log(f"phase 15: nuts_transition_std vs plain at {CHAINS}x{DIM}, K={K}, "
        f"and at {RAGGED} chains (f32): "
        f"decisions equal on >= {shares['f32']:.4%} (f32) and "
        f"{shares['bf16']:.4%} (bf16 operands) of chains, max |q| err "
        f"{errs['f32']:.3g} / {errs['bf16']:.3g}; Philox kernel 3 on q == "
        f"kernel 1 on q^T bit for bit; nuts_sampling_std over {n4} draws == "
        f"{n4} kernel 3 launches bit for bit (bf16 operands); vs plain bf16 "
        f"per draw: decisions equal on >= {share4b:.4%}, max |q| err "
        f"{err4b:.3g}; vs plain over the run (f32 operands): decisions equal "
        f"on {share4:.4%}, max |q| err {err4:.3g}; kernel 3 {ms3:.3f} ms "
        f"(plain {plain_ms3:.3f}, bound {bound3[0]:.3f} ms {bound3[1]}), "
        f"kernel 4 per {n4} draws: bf16 operands {ms4:.2f} ms (plain "
        f"{plain_ms4:.2f}, bound {bound4[0]:.3f} ms {bound4[1]}, bf16 "
        f"peak), f32 {ms4_f32:.2f} ms (plain {plain_ms4_f32:.2f}, bound "
        f"{bound4_f32[0]:.3f} ms {bound4_f32[1]}); lockstep ratio of kernel "
        f"3's tree sizes for groups of "
        + ", ".join(f"{g}: {r:.4f}" for g, r in lockstep15.items())
        + f" [{card}]")
    record["phase15"] = dict(share_f32=shares["f32"], share_bf16=shares["bf16"],
                             max_abs_err_f32=errs["f32"],
                             max_abs_err_bf16=errs["bf16"], share4=share4,
                             max_abs_err4=err4, share4_bf16=share4b,
                             max_abs_err4_bf16=err4b, ms3=ms3,
                             plain_ms3=plain_ms3, bound_ms3=bound3[0],
                             bound_ms3_cuda_cores=bound3[2],
                             ms4=ms4, plain_ms4=plain_ms4,
                             bound_ms4=bound4[0], ms4_f32=ms4_f32,
                             plain_ms4_f32=plain_ms4_f32,
                             bound_ms4_f32=bound4_f32[0],
                             bound_ms4_f32_cuda_cores=bound4_f32[2],
                             lockstep=lockstep15)
    del pos, pos32

    # ---- phase 16: the standard-layout path at full width
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qf, pos16, stats16, eps16, imm16 = sample_fused_adaptive(
        torch.Generator().manual_seed(16), nf.logistic_potential,
        f32m.data, q0, DRAWS, WARMUP, max_num_expansions=K,
        initial_step_size=0.1)
    torch.cuda.synchronize()
    wall16 = time.perf_counter() - t0
    launches3 = dict(ops.LAUNCHES)
    check(launches3["nuts_transition_std"] == WARMUP + DRAWS
          and sum(launches3.values()) == WARMUP + DRAWS,
          f"standard driver launches {launches3}")
    std_stats = nuts_limits(torch, diagnostics, pos16, stats16[:, :, 1],
                            stats16[:, :, 4], eps16, nuts_mean,
                            "standard-layout NUTS")
    del pos16
    # the plain bf16 sampler from the same start (a float32 potential and
    # gradient, as sample_fused_logistic's): the witness of the rounded
    # target's means
    u16, g16 = f32m.pot_grad(qf)
    pos_w, *_ = nf._sampling_plain(
        b16m, qf, u16, g16, imm16, eps16, BF16_PLAIN_SEED, DRAWS, max_exp=K,
        divergence_threshold=1000.0, collect_positions=True)
    witness = mean_mcse(torch, diagnostics, pos_w.transpose(0, 1))
    del pos_w
    bf16_runs = []
    for seed16 in BF16_SEEDS:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, pos16b, stats16b = nf.sample_fused_logistic(
            torch.Generator().manual_seed(seed16), X, y, qf, DRAWS, eps16,
            imm16, max_num_expansions=K, loop_in_kernel=True)
        torch.cuda.synchronize()
        wall16b = time.perf_counter() - t0
        launches4 = dict(ops.LAUNCHES)
        check(launches4["nuts_sampling_std"] == 1
              and sum(launches4.values()) == 1,
              f"sample_fused_logistic launches {launches4}")
        evals16b = float(stats16b[:, :, 3].sum())
        bf16_runs.append(dict(
            seed=seed16, wall_s=wall16b, launches=launches4,
            grad_evals_per_s=evals16b / wall16b,
            **nuts_limits(torch, diagnostics, pos16b, stats16b[:, :, 1],
                          stats16b[:, :, 4], eps16, nuts_mean,
                          f"sample_fused_logistic (bf16, seed "
                          f"{seed16})", bias_sd=BF16_BIAS_SD,
                          witness=witness)))
        del pos16b
    bf16_stats = bf16_runs[0]
    log(f"phase 16: standard driver {CHAINS}x{DIM}, {WARMUP} warmup + {DRAWS} "
        f"draws in {wall16:.2f} s, launches {launches3['nuts_transition_std']} "
        f"nuts_transition_std; eps {float(eps16):.4f}, accept "
        f"{std_stats['accept']:.4f}, divergent {std_stats['divergent_share']:.2e}, "
        f"max R-hat {std_stats['max_rhat']:.4f}, means within "
        f"{std_stats['max_z_vs_nuts']:.2f} MCSE of NUTS; then "
        f"sample_fused_logistic (bf16 operands) {DRAWS} draws in one "
        f"nuts_sampling_std launch, {bf16_stats['wall_s']:.3f} s, "
        f"{bf16_stats['grad_evals_per_s'] / 1e6:.2f}M grad-evals/s; seeds "
        f"{BF16_SEEDS}: accept "
        + " / ".join(f"{r['accept']:.4f}" for r in bf16_runs)
        + ", divergent "
        + " / ".join(f"{r['divergent_share']:.2e}" for r in bf16_runs)
        + ", max R-hat "
        + " / ".join(f"{r['max_rhat']:.4f}" for r in bf16_runs)
        + ", means within "
        + " / ".join(f"{r['max_z_vs_witness']:.2f}" for r in bf16_runs)
        + " MCSE of the plain bf16 sampler's and "
        + " / ".join(f"{r['max_mean_shift_sd']:.4f}" for r in bf16_runs)
        + " posterior sd ("
        + " / ".join(f"{r['max_z_vs_nuts']:.2f}" for r in bf16_runs)
        + f" MCSE) of float32 NUTS's [{card}]")
    record["phase16"] = dict(wall_s=wall16, launches=launches3,
                             step_size=float(eps16), **std_stats,
                             bf16=bf16_runs)
    return [
        kernel_entry("nuts_transition_std", "nuts_fused.cu",
                     "aehmc_tpu/ops/nuts_fused.py:452",
                     launches3["nuts_transition_std"], errs["f32"], ms3,
                     plain_ms3, bound3),
        kernel_entry("nuts_sampling_std", "nuts_fused.cu",
                     "aehmc_tpu/ops/nuts_fused.py:507",
                     bf16_stats["launches"]["nuts_sampling_std"], err4b, ms4,
                     plain_ms4, bound4),
    ]


def plan_sweep(torch, card):
    """Kernel 1 at dims where the launch plan takes each NUTS tile (points a
    chunk, two blocks per SM or one), float32 data, 10,240 chains: ms per
    transition and ns per gradient, point and dimension, the cost of a
    smaller tile (X·q idles warps below 128 points)."""
    from aehmc_tpu_torch.models import logistic_regression_pg_t
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.ops.launch_plan import launch_plan, two_blocks_fit

    dev = torch.device(DEVICE)
    rows = []
    for dim in SWEEP_DIMS:
        _, pg, data, _ = logistic_regression_pg_t(
            dim, POINTS, matmul_dtype=torch.float32, device=dev)
        rng = np.random.default_rng(dim)
        q_t = torch.tensor(0.1 * rng.standard_normal((dim, CHAINS)),
                           dtype=torch.float32, device=dev)
        u, g = pg(q_t, *data)
        im = torch.full((dim,), IMM, device=dev)

        def k1():
            return nfs.nuts_transition_cuda(q_t, u, g, im, EPS, data,
                                            max_exp=K, seed=dim)

        ms = cuda_ms(torch, k1, 5)
        leaves = float(k1()[3][3].sum())
        plan = launch_plan("nuts", dim, K, CHAINS)
        rows.append(dict(dim=dim, points=plan.points, smem_bytes=plan.smem,
                         two_blocks=two_blocks_fit(plan.smem), ms=ms,
                         ns_per_grad_point_dim=ms * 1e6
                         / (leaves * POINTS * dim)))
    log("  plan sweep, kernel 1 (dim: points, blocks per SM, ms, ns per "
        "gradient-point-dim): " + ", ".join(
            f"{r['dim']}: {r['points']}, {2 if r['two_blocks'] else 1}, "
            f"{r['ms']:.3f}, {r['ns_per_grad_point_dim']:.4g}" for r in rows)
        + f" [{card}]")
    return rows


def bf16_phases(torch, ops, diagnostics, q0, record, nuts_mean, card):
    """Phase 17: the model builder's default data (bfloat16).  Kernels 1, 2,
    5, 6 and 7 against their plain bf16 versions (kernels 2 and 6 also
    against per-draw launches of kernels 1 and 5, bit for bit, and each draw
    against the plain transition from the kernel's own state); the fused
    NUTS front door on those data, held to phase 5's limits with means
    within BF16_BIAS_SD posterior sd of phase 5's; short MALA, GHMC and
    ChEES front doors on them."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch.models import (
        logistic_regression,
        logistic_regression_pg_t,
    )
    from aehmc_tpu_torch.ops import chees_fused as cf
    from aehmc_tpu_torch.ops import ghmc_fused as gf
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
    from aehmc_tpu_torch.ops.philox import MASK32

    dev = q0.device
    pot, pg, data, _ = logistic_regression_pg_t(DIM, POINTS, device=dev)
    check(data[0].dtype == torch.bfloat16 and data[1].dtype == torch.bfloat16,
          f"the builder's default data are {data[0].dtype}, not bfloat16")
    pot_grad = lambda q_t: pg(q_t, *data)  # noqa: E731
    q_t = q0.T.contiguous()
    u0, g0 = pg(q_t, *data)
    im = torch.full((DIM,), IMM, device=dev)
    out = {}

    # kernel 1 against the plain bf16 version
    k1 = nfs.nuts_transition_cuda(q_t, u0, g0, im, EPS, data, max_exp=K,
                                  seed=171717)
    p1 = nfs.nuts_transition_plain(q_t, u0, g0, im, EPS, pot_grad, max_exp=K,
                                   seed=171717)
    torch.cuda.synchronize()
    out["share1"], out["err1"], _ = compare(k1, p1, "kernel 1 (bf16)",
                                            Q_ATOL_BF16)
    # kernel 2 == per-draw kernel 1 bit for bit; each draw against the plain
    # bf16 transition from the kernel's own state
    n2, seed = 20, 1717
    pos, stats, *final = nfs.nuts_sampling_cuda(q_t, u0, g0, im, EPS, data,
                                                 seed, n2, max_exp=K)
    st_k, share2, err2 = (q_t, u0, g0), 1.0, 0.0
    for t in range(n2):
        seed_t = (seed + t * DRAW_SEED_STRIDE) & MASK32
        plain_t = nfs.nuts_transition_plain(*st_k, im, EPS, pot_grad,
                                            max_exp=K, seed=seed_t)
        *st_k, st = nfs.nuts_transition_cuda(*st_k, im, EPS, data, max_exp=K,
                                             seed=seed_t)
        check(torch.equal(st, stats[t]) and torch.equal(st_k[0], pos[t]),
              f"kernel 2 (bf16) draw {t} differs from kernel 1")
        sh, er, _ = compare((st_k[0], None, None, st), plain_t,
                            f"kernel 2 (bf16) draw {t} vs plain", Q_ATOL_BF16)
        share2, err2 = min(share2, sh), max(err2, er)
    check(all(torch.equal(a, b) for a, b in zip(final, st_k)),
          "kernel 2 (bf16) final state differs from kernel 1")
    out.update(share2=share2, err2=err2)
    del pos

    # kernels 5 and 6
    rng = np.random.default_rng(17)
    p0 = torch.tensor(np.sqrt(1.0 / IMM) * rng.standard_normal((DIM, CHAINS)),
                      dtype=torch.float32, device=dev)
    state = (q_t, u0, g0, p0)
    cases = []
    for alpha in (0.0, GHMC_ALPHA):
        kern = gf.ghmc_transition_cuda(*state, EPS, alpha, im, data, seed=1718)
        plain = gf.ghmc_transition_plain(*state, EPS, alpha, im, pot_grad,
                                         seed=1718)
        torch.cuda.synchronize()
        cases.append(ghmc_compare(torch, q_t, (kern[0][None], kern[4][None]),
                                  (plain[0][None], plain[4][None]),
                                  f"kernel 5 (bf16, alpha {alpha})",
                                  Q_ATOL_BF16))
    out.update(share5=min(c[0] for c in cases), err5=max(c[1] for c in cases))
    pos, stats, *final = gf.ghmc_segment_cuda(*state, EPS, GHMC_ALPHA, im,
                                              data, SEGMENT, seed=seed)
    st_k, share6, err6 = state, 1.0, 0.0
    for t in range(SEGMENT):
        seed_t = (seed + t * DRAW_SEED_STRIDE) & MASK32
        plain_t = gf.ghmc_transition_plain(*st_k, EPS, GHMC_ALPHA, im,
                                           pot_grad, seed=seed_t)
        q_prev = st_k[0]
        *st_k, st = gf.ghmc_transition_cuda(*st_k, EPS, GHMC_ALPHA, im, data,
                                            seed=seed_t)
        check(torch.equal(st, stats[t]) and torch.equal(st_k[0], pos[t]),
              f"kernel 6 (bf16) draw {t} differs from kernel 5")
        sh, er, _ = ghmc_compare(torch, q_prev, (st_k[0][None], st[None]),
                                 (plain_t[0][None], plain_t[4][None]),
                                 f"kernel 6 (bf16) draw {t} vs plain",
                                 Q_ATOL_BF16)
        share6, err6 = min(share6, sh), max(err6, er)
    check(all(torch.equal(a, b) for a, b in zip(final, st_k)),
          "kernel 6 (bf16) final state differs from kernel 5")
    out.update(share6=share6, err6=err6)
    del pos

    # kernel 7, and against kernel 5 at alpha 0
    cstate = (q0, u0.reshape(-1), g0.T.contiguous())
    steps = torch.full((), LEAPFROG_STEPS, dtype=torch.int32, device=dev)
    k7 = cf.chees_transition_cuda(*cstate, im, EPS, steps, data, seed=1719)
    p7 = cf.chees_transition_plain(*cstate, im, EPS, LEAPFROG_STEPS, pot_grad,
                                   seed=1719)
    torch.cuda.synchronize()
    # one transition is L 10 steps: a last-bit float32 difference that moves
    # one bfloat16 rounding of q or σ − y in any of them can move the final
    # energy by more than 1e-5 relative (on 3.2% of the chains on an H100),
    # so the kept energy is held to Q_ATOL_BF16 relative; the decisions
    # (accepted, divergent) are held as everywhere
    out["share7"], out["err7"], _ = chees_compare(
        torch, q0, k7, p7, "kernel 7 (bf16)", Q_ATOL_BF16,
        energy_rtol=Q_ATOL_BF16)
    decided = (((k7[0] != q0).any(dim=1) == (p7[0] != q0).any(dim=1))
               & (k7[3][:, 4] == p7[3][:, 4]))
    rel = ((k7[3][:, 0] - p7[3][:, 0]).abs()
           / p7[3][:, 0].abs().clamp(min=1.0))
    out.update(decisions7=float(decided.float().mean()),
               energy7_within_1e5=float((rel <= 1e-5).float().mean()),
               energy7_rel_err=float(rel[decided].max()))
    k5 = gf.ghmc_transition_cuda(q_t, u0, g0, torch.zeros_like(g0), EPS, 0.0,
                                 im, data, num_steps=LEAPFROG_STEPS,
                                 seed=1719)
    check(torch.equal(k7[0], k5[0].T),
          "kernel 7 (bf16) differs from kernel 5 at alpha 0")

    # times of the bf16 instantiations at the main paths' shapes
    out.update(
        ms1=cuda_ms(torch, lambda: nfs.nuts_transition_cuda(
            q_t, u0, g0, im, EPS, data, max_exp=K, seed=11), 5),
        ms2=cuda_ms(torch, lambda: nfs.nuts_sampling_cuda(
            q_t, u0, g0, im, EPS, data, seed, n2, max_exp=K), 3),
        ms5=cuda_ms(torch, lambda: gf.ghmc_transition_cuda(
            *state, EPS, 0.0, im, data, seed=7), 20),
        ms6=cuda_ms(torch, lambda: gf.ghmc_segment_cuda(
            *state, EPS, 0.0, im, data, SEGMENT, seed=7), 5),
        ms7=cuda_ms(torch, lambda: cf.chees_transition_cuda(
            *cstate, im, EPS, steps, data, seed=7), 10))

    # the fused NUTS front door on the default data
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(1717), None, q0, DRAWS, WARMUP,
        algorithm="nuts", path="fused", data=data, potential_fn_t=pot,
        potential_and_grad_t=pg, max_num_expansions=K, initial_step_size=0.1,
        collect_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    out["nuts_wall_s"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["nuts_transition"] == WARMUP
          and launches["nuts_sampling"] == 1
          and sum(launches.values()) == WARMUP + 1,
          f"bf16 NUTS front door launches {launches}")
    diag = res.diagnostics
    out["nuts"] = nuts_limits(
        torch, diagnostics, res.positions, diag.acceptance_probability,
        diag.is_diverging, res.step_size, nuts_mean,
        "NUTS front door (bf16 data)", bias_sd=BF16_BIAS_SD)
    out["nuts"].update(step_size=float(res.step_size), launches=launches)
    del res

    # short MALA, GHMC and ChEES front doors on the default data
    logprob_fn, _ = logistic_regression(DIM, POINTS, device=dev)
    short = {}
    for algorithm, kw, kernels in (
            ("mala", dict(potential_fn_t=pot, initial_step_size=0.1,
                          segment_draws=SEGMENT),
             {"ghmc_transition", "ghmc_segment"}),
            ("ghmc", dict(potential_fn_t=pot, initial_step_size=0.1,
                          segment_draws=SEGMENT, ghmc_alpha=GHMC_ALPHA),
             {"ghmc_transition", "ghmc_segment"}),
            ("chees", dict(initial_step_size=CHEES_EPS0),
             {"chees_transition"})):
        ops.reset_launch_counts()
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(1720), logprob_fn, q0, 64, 50,
            algorithm=algorithm, path="fused", data=data,
            potential_and_grad_t=pg, **kw)
        torch.cuda.synchronize()
        launched = {k for k, v in ops.LAUNCHES.items() if v}
        check(launched == kernels, f"{algorithm} (bf16 data) launched "
              f"{dict(ops.LAUNCHES)}")
        check(bool(torch.isfinite(res.positions.float()).all()),
              f"{algorithm} (bf16 data): non-finite draws")
        short[algorithm] = dict(
            launches={k: v for k, v in ops.LAUNCHES.items() if v},
            accept=float(res.diagnostics.acceptance_probability.mean()),
            step_size=float(res.step_size))
        del res
    out["short_front_doors"] = short
    nuts = out["nuts"]
    log(f"phase 17: builder's default data (bfloat16) at {CHAINS}x{DIM}: "
        f"vs plain bf16, decisions equal on >= kernel 1 {out['share1']:.4%}, "
        f"kernel 2 per draw {out['share2']:.4%}, kernel 5 "
        f"{out['share5']:.4%}, kernel 6 per draw {out['share6']:.4%}, kernel "
        f"7 {out['share7']:.4%}; max |q| err {out['err1']:.3g} / "
        f"{out['err2']:.3g} / {out['err5']:.3g} / {out['err6']:.3g} / "
        f"{out['err7']:.3g}; kernel 7: accepted and divergent equal on "
        f"{out['decisions7']:.4%}, kept energy within 1e-5 relative on "
        f"{out['energy7_within_1e5']:.4%}, at most "
        f"{out['energy7_rel_err']:.3g} relative; kernel 2 == {n2} kernel 1 "
        f"launches and kernel 6 "
        f"== {SEGMENT} kernel 5 launches bit for bit, kernel 7 == kernel 5 "
        f"at alpha 0; kernels 1 {out['ms1']:.3f} ms, 2 {out['ms2']:.2f} ms / "
        f"{n2} draws, 5 {out['ms5']:.4f} ms, 6 {out['ms6']:.3f} ms / "
        f"{SEGMENT} draws, 7 {out['ms7']:.3f} ms at L {LEAPFROG_STEPS}; NUTS "
        f"front door {WARMUP} + {DRAWS} in {out['nuts_wall_s']:.2f} s, "
        f"launches {nuts['launches']}, eps {nuts['step_size']:.4f}, accept "
        f"{nuts['accept']:.4f}, divergent {nuts['divergent_share']:.2e}, max "
        f"R-hat {nuts['max_rhat']:.4f}, means within "
        f"{nuts['max_mean_shift_sd']:.4f} posterior sd "
        f"({nuts['max_z_vs_nuts']:.2f} MCSE) of phase 5's; short front "
        f"doors " + ", ".join(
            f"{a} {v['launches']} accept {v['accept']:.3f}"
            for a, v in short.items()) + f" [{card}]")
    record["phase17"] = out


def extra_seed_runs(torch, ops, diagnostics, data, pot, pg, q0, record,
                    nuts_mean, card, seeds):
    """Phases 12 and 14's front doors again with other generator seeds,
    every run measured before any is held to the limits."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch.models import logistic_regression

    logprob_fn, _ = logistic_regression(DIM, POINTS, device=q0.device)
    runs = []
    for seed in seeds:
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(seed), None, q0, GHMC_DRAWS,
            WARMUP, algorithm="ghmc", path="fused", ghmc_alpha=GHMC_ALPHA,
            data=data, potential_fn_t=pot, potential_and_grad_t=pg,
            initial_step_size=0.1, segment_draws=SEGMENT)
        runs.append(("GHMC", seed, (0.7, 0.9), front_door_checks(
            torch, diagnostics, res, nuts_mean, f"GHMC (seed {seed})",
            checks=False)))
        del res
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(seed), logprob_fn, q0, DRAWS,
            WARMUP, algorithm="chees", path="fused", data=data,
            potential_and_grad_t=pg, initial_step_size=CHEES_EPS0)
        runs.append(("ChEES", seed, CHEES_ACCEPT, front_door_checks(
            torch, diagnostics, res, nuts_mean, f"ChEES (seed {seed})",
            checks=False)))
        del res
    log("phases 12 and 14 at more seeds: " + "; ".join(
        f"{what} seed {seed}: means within {out['max_z_vs_nuts']:.2f} MCSE "
        f"of NUTS, accept {out['accept']:.4f}, max R-hat excess "
        f"{out['max_rhat_excess']:.4f}" for what, seed, _, out in runs)
        + f" [{card}]")
    record["extra_seeds"] = [dict(sampler=what, seed=seed, **out)
                             for what, seed, _, out in runs]
    for what, seed, accept_range, out in runs:
        hold_front_door(out, f"{what} (seed {seed})", accept_range)


# potential+gradient operations per chain and leaf, besides the leapfrog's
# and the kinetic energy's 10 per dimension: the funnel 3(d − 1) + 13, eight
# schools 16 per school + 15 (counted from csrc/hierarchical_pg.cuh)
HIER_PG_FLOP = {"funnel": lambda d: 3 * (d - 1) + 13,
                "eight_schools": lambda d: 16 * (d - 2) + 15}


def hier_start(torch, dim, chains, seed):
    """(dim, chains) float32 positions from N(0, 1) on the card."""
    return torch.tensor(np.random.default_rng(seed).standard_normal(
        (dim, chains)), dtype=torch.float32, device=DEVICE)


def hier_kernel_checks(torch, nfs, name, model, q_t, imm, eps, k, seed):
    """Kernel 1 with the model's functor against the plain transition
    (external and Philox randomness), and kernel 2 over 5 draws equal to 5
    launches of kernel 1 bit for bit, each draw against the plain transition
    from the kernel's own state (single transitions: over chained draws
    the funnel's chaos carries a last-bit difference into the next draw's
    start); from positions ``q_t`` (dim, C) at step size ``eps``, diagonal
    inverse mass ``imm`` and K ``k``.  Returns (least share, largest |Δq|,
    chain-cases that differ)."""
    from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
    from aehmc_tpu_torch.ops.philox import MASK32

    pot, pg, data, _ = model
    dim, chains = q_t.shape
    rng = np.random.default_rng(seed)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=DEVICE)

    u0, g0 = pg(q_t, *data)
    # momentum from N(0, M), M = 1 / imm (diagonal), as the samplers draw it
    ext = dict(momentum=f32(rng.standard_normal((dim, chains)))
               / imm.reshape(dim, 1).sqrt(),
               directions=f32(np.where(rng.uniform(size=(k, chains)) < 0.5,
                                       -1.0, 1.0)),
               u_bias=f32(rng.uniform(size=(k, chains))),
               u_leaf=f32(rng.uniform(size=(2**k, chains))))
    pot_grad = lambda x: pg(x, *data)  # noqa: E731
    out = []
    for rand in (ext, dict(seed=seed)):
        kern = nfs.nuts_transition_cuda(q_t, u0, g0, imm, eps, data,
                                        max_exp=k, potential_and_grad_t=pg,
                                        **rand)
        plain = nfs.nuts_transition_plain(q_t, u0, g0, imm, eps,
                                          pot_grad, max_exp=k, **rand)
        torch.cuda.synchronize()
        out.append(compare(kern, plain, f"kernel 1 ({name}, "
                           f"{'Philox' if 'seed' in rand else 'external'})"))
    n2, seed2 = 5, seed + 1
    pos, stats, *final = nfs.nuts_sampling_cuda(
        q_t, u0, g0, imm, eps, data, seed2, n2, max_exp=k,
        potential_and_grad_t=pg)
    state = (q_t, u0, g0)
    for t in range(n2):
        s_t = (seed2 + t * DRAW_SEED_STRIDE) & MASK32
        plain = nfs.nuts_transition_plain(*state, imm, eps, pot_grad,
                                          max_exp=k, seed=s_t)
        *state, st = nfs.nuts_transition_cuda(
            *state, imm, eps, data, max_exp=k, seed=s_t,
            potential_and_grad_t=pg)
        check(torch.equal(st, stats[t]) and torch.equal(state[0], pos[t]),
              f"kernel 2 ({name}) draw {t} differs from kernel 1")
        out.append(compare((*state, st), plain,
                           f"kernel 2 ({name}) draw {t} vs plain"))
    check(all(torch.equal(a, b) for a, b in zip(final, state)),
          f"kernel 2 ({name}) final state differs from kernel 1")
    return (min(s for s, _, _ in out), max(e for _, e, _ in out),
            sum(d for _, _, d in out))


def hier_front_door(torch, ops, diagnostics, name, model, chains, warmup,
                    draws, seed):
    """The fused NUTS front door at a JAX benchmark cell, twice with the
    same generator seed (launch counts and positions must agree bit for
    bit), then its warmup and sampling timed apart (warmup_fused over
    kernel 1, sample_fused_small in one launch of kernel 2).  Returns the
    first run's result, its measurements and the timed split's."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.ops.fused_driver import warmup_fused

    pot, pg, data, ex = model
    dim = ex.shape[0]
    rng = np.random.default_rng(seed)
    q0 = torch.tensor(0.1 * rng.standard_normal((chains, dim)),
                      dtype=torch.float32, device=DEVICE)
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(seed), None, q0, draws, warmup,
            algorithm="nuts", path="fused", data=data, potential_fn_t=pot,
            potential_and_grad_t=pg, max_num_expansions=HIER_K,
            target_acceptance_rate=HIER_TARGET)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, dict(ops.LAUNCHES), res))
    (wall, launches, res), (wall_b, launches_b, res_b) = runs
    want = {f"nuts_transition_{name}": warmup, f"nuts_sampling_{name}": 1}
    check({k: v for k, v in launches.items() if v} == want
          and launches_b == launches,
          f"{name} front door launches {launches}, then {launches_b}")
    same = (torch.equal(res.positions, res_b.positions)
            and torch.equal(res.final_state, res_b.final_state))
    check(same, f"{name}: the same generator seed gave other positions")
    del res_b

    q0_t = q0.T.contiguous()
    u0, g0 = pg(q0_t, *data)
    transition = nfs.make_fused_nuts_transition_small(
        pot, data, max_num_expansions=HIER_K, potential_and_grad_t=pg,
        transposed_io=True)
    t_warm, ((qw, _, _), eps_w, imm_w) = timed(
        torch, lambda r: warmup_fused(
            torch.Generator().manual_seed(seed + 1), transition, q0,
            u0.T.contiguous(), g0.T.contiguous(), warmup,
            max_num_expansions=HIER_K, target_acceptance_rate=HIER_TARGET),
        1)
    t_samp, (_, pos_s, stats_s) = timed(
        torch, lambda r: nfs.sample_fused_small(
            torch.Generator().manual_seed(seed + 2), pot, data, qw, draws,
            eps_w, imm_w, max_num_expansions=HIER_K, potential_and_grad_t=pg,
            loop_in_kernel=True), 1)
    evals = float(stats_s[:, :, 3].sum())
    bulk, tail = bulk_tail_ess(torch, diagnostics, pos_s.transpose(0, 1))
    ess = float(torch.minimum(bulk, tail).clamp(max=chains * draws).sum())
    diag = res.diagnostics
    out = dict(
        wall_s=wall, wall_s_again=wall_b, launches=launches, same_seed=same,
        accept=float(diag.acceptance_probability.mean()),
        divergences=int(diag.is_diverging.sum()),
        divergent_share=float(diag.is_diverging.float().mean()),
        step_size=float(res.step_size),
        mean_leaves=float(diag.num_integration_steps.float().mean()),
        finite=bool(torch.isfinite(res.positions).all()),
        warmup_wall_s=t_warm, sampling_wall_s=t_samp,
        grad_evals_per_s=evals / t_samp, sampling_ess_per_s=ess / t_samp,
        e2e_ess_per_s=ess / (t_warm + t_samp),
        timed_divergences=int(stats_s[:, :, 4].sum()),
        bulk_ess_min=float(bulk.min()), tail_ess_min=float(tail.min()))
    return res, out


def hier_times(torch, nfs, name, model, res, seed):
    """Kernels 1 and 2 with the model's functor at the front door's shapes
    (its chains, K HIER_K, its tuned ε and M⁻¹, from its final state): held
    against their plain versions (:func:`hier_kernel_checks`, seeds from
    ``seed``), timed (their own time on the card) with them, and their
    bounds.  Returns ((ms, plain ms, bound) of kernel 1, the same of kernel
    2 over HIER_DRAWS draws, the lockstep ratio of kernel 1's tree sizes
    (what sort_by_depth would recover), and hier_kernel_checks' result)."""
    from aehmc_tpu_torch.timing import kernel_ms

    pot, pg, data, ex = model
    dim = ex.shape[0]
    q_t = res.final_state.T.contiguous()
    u, g = pg(q_t, *data)
    imm, eps = res.inverse_mass_matrix, float(res.step_size)
    pot_grad = lambda x: pg(x, *data)  # noqa: E731

    def k1():
        return nfs.nuts_transition_cuda(q_t, u, g, imm, eps, data,
                                        max_exp=HIER_K, seed=11,
                                        potential_and_grad_t=pg)

    def p1():
        return nfs.nuts_transition_plain(q_t, u, g, imm, eps, pot_grad,
                                         max_exp=HIER_K, seed=11)

    def k2():
        return nfs.nuts_sampling_cuda(q_t, u, g, imm, eps, data, 5,
                                      HIER_DRAWS, max_exp=HIER_K,
                                      potential_and_grad_t=pg)

    def p2():
        return nfs._sampling_plain(
            pot_grad, q_t, u, g, imm, eps, 5, HIER_DRAWS, max_exp=HIER_K,
            divergence_threshold=1000.0, collect_positions=True,
            collect_dtype=torch.float32)

    per_leaf = HIER_PG_FLOP[name](dim) + 10 * dim
    checks = hier_kernel_checks(torch, nfs, f"{name} at the tuned state",
                                model, q_t, imm, eps, HIER_K, seed)
    out1, out2 = k1(), k2()
    steps = lockstep(out1[3][3])
    b1 = bound(float(out1[3][3].sum()) * per_leaf,
               nbytes(q_t, u, g, imm, *out1), PEAK_F32)
    b2 = bound(float(out2[1][:, 3].sum()) * per_leaf,
               nbytes(q_t, u, g, imm, *out2), PEAK_F32)
    # each kernel's own time from a CUDA graph of its launches: at eight
    # schools' size a launch can take less than its wrapper's host time,
    # which back-to-back CUDA events would read instead
    ms1, ms2 = kernel_ms(k1, 10), kernel_ms(k2, 5)
    return ((ms1, cuda_ms(torch, p1, 1, warm=False), b1),
            (ms2, cuda_ms(torch, p2, 1, warm=False), b2), steps, checks)


def hier_entries(name, launches, err, times):
    """The ``kernels`` line's entries of kernels 1 and 2 with the model's
    functor (8 chains a block, no X tile)."""
    out = []
    for kernel, line, (ms, plain_ms, bnd) in (
            ("nuts_transition", 459, times[0]),
            ("nuts_sampling", 545, times[1])):
        entry = kernel_entry(f"{kernel}_{name}", "nuts_fused_small.cu",
                             f"aehmc_tpu/ops/nuts_fused_small.py:{line}",
                             launches[f"{kernel}_{name}"], err, ms, plain_ms,
                             bnd)
        out.append(dict(entry, chains_per_block=8))
    return out


def hierarchical_phases(torch, ops, diagnostics, record, card):
    """Phases 18 (Neal's funnel) and 19 (eight schools): kernels 1 and 2
    with the FunnelPG and EightSchoolsPG functors against their plain
    versions, then the fused NUTS front door at the JAX benchmark's cells,
    held to the JAX gate's limits (the funnel) and to the means of a plain
    sampler on the card (eight schools).  Returns the four instantiations'
    entries of the ``kernels`` line."""
    from aehmc_tpu_torch.models import eight_schools_pg_t, neals_funnel_pg_t
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.ops.fused_driver import warmup_fused
    from aehmc_tpu_torch.ops.nuts_fused import derive_draw_seeds

    entries = []
    # ---- phase 18: Neal's funnel, funnel_fused_adaptive's cell
    funnel = neals_funnel_pg_t(FUNNEL_DIM, device=DEVICE)
    share, err, differ = hier_kernel_checks(
        torch, nfs, "funnel", funnel, hier_start(torch, FUNNEL_DIM,
                                                  FUNNEL_CHAINS, 1800),
        torch.ones(FUNNEL_DIM, device=DEVICE), HIER_EPS, HIER_CHECK_K, 1801)
    res, run = hier_front_door(torch, ops, diagnostics, "funnel", funnel,
                               FUNNEL_CHAINS, FUNNEL_WARMUP, FUNNEL_DRAWS,
                               181)
    v = res.positions[FUNNEL_BURN:, :, 0].float()
    v_mean, v_sd = float(v.mean()), float(v.std(correction=0))
    times = hier_times(torch, nfs, "funnel", funnel, res, 1802)
    del res, v
    log(f"phase 18: Neal's funnel (dim {FUNNEL_DIM}): kernels 1 and 2 "
        f"(FunnelPG) vs plain at {FUNNEL_CHAINS} chains, eps {HIER_EPS}, "
        f"K {HIER_CHECK_K}: decisions equal on >= {share:.4%} of chains "
        f"({differ} chain-cases differ), max |q| err {err:.3g}; kernel 2 == "
        f"per-draw kernel 1 bit for bit; front door {FUNNEL_CHAINS} chains, "
        f"{FUNNEL_WARMUP} warmup + {FUNNEL_DRAWS} draws, K {HIER_K}, target "
        f"{HIER_TARGET}: {run['wall_s']:.2f} s (again {run['wall_s_again']:.2f}"
        f" s, positions equal bit for bit), launches {run['launches']}; "
        f"accept {run['accept']:.4f}, eps {run['step_size']:.4f}, mean leaves "
        f"{run['mean_leaves']:.1f}, {run['divergences']} divergences "
        f"({run['divergent_share']:.2e}); v over draws {FUNNEL_BURN}+: mean "
        f"{v_mean:.3f}, sd {v_sd:.3f}; timed: warmup {run['warmup_wall_s']:.3f}"
        f" s, sampling {run['sampling_wall_s']:.3f} s, "
        f"{run['grad_evals_per_s'] / 1e6:.2f}M grad-evals/s, "
        f"{run['sampling_ess_per_s'] / 1e6:.3f}M ESS/s sampling, "
        f"{run['e2e_ess_per_s'] / 1e6:.3f}M ESS/s end to end "
        f"({run['timed_divergences']} divergences); kernel 1 "
        f"{times[0][0]:.3f} ms (plain {times[0][1]:.1f} ms), kernel 2 "
        f"{times[1][0]:.2f} ms (plain {times[1][1]:.1f} ms) per {HIER_DRAWS} "
        f"draws at the tuned state, where kernels 1 and 2 against plain "
        f"(single transitions, K {HIER_K}; kernel 2 == per-draw kernel 1 bit "
        f"for bit) agree on >= {times[3][0]:.4%} of decisions ({times[3][2]} "
        f"chain-cases differ), max |q| err {times[3][1]:.3g}; lockstep ratio "
        f"of kernel 1's tree sizes "
        f"for groups of " + ", ".join(f"{g}: {r:.4f}"
                                      for g, r in times[2].items())
        + f" [{card}]")
    record["phase18"] = dict(share=share, max_abs_err=err, differ=differ,
                             v_mean=v_mean, v_sd=v_sd, **run,
                             ms1=times[0][0], plain_ms1=times[0][1],
                             bound_ms1=times[0][2][0], ms2=times[1][0],
                             plain_ms2=times[1][1], bound_ms2=times[1][2][0],
                             lockstep=times[2], tuned_share=times[3][0],
                             tuned_max_abs_err=times[3][1],
                             tuned_differ=times[3][2])
    check(run["accept"] > FUNNEL_ACCEPT,
          f"funnel mean acceptance {run['accept']}")
    check(abs(v_mean) < FUNNEL_V_MEAN, f"funnel mean of v {v_mean}")
    check(abs(v_sd - 3.0) < FUNNEL_V_SD, f"funnel sd of v {v_sd}")
    check(run["finite"], "funnel: non-finite draws")
    entries += hier_entries("funnel", run["launches"], max(err, times[3][1]),
                            times)

    # ---- phase 19: eight schools, eight_schools_fused's cell
    schools = eight_schools_pg_t(device=DEVICE)
    pot, pg, data, _ = schools
    share, err, differ = hier_kernel_checks(
        torch, nfs, "eight_schools", schools, hier_start(torch, 10,
                                                        SCHOOLS_CHAINS, 1900),
        torch.ones(10, device=DEVICE), HIER_EPS, HIER_CHECK_K, 1901)
    res, run = hier_front_door(torch, ops, diagnostics, "eight_schools",
                               schools, SCHOOLS_CHAINS, SCHOOLS_WARMUP,
                               SCHOOLS_DRAWS, 191)
    times = hier_times(torch, nfs, "eight_schools", schools, res, 1902)
    # the witness: plain transitions on the card, the same warmup and draws
    pot_grad = lambda x: pg(x, *data)  # noqa: E731

    def plain_transition(q, u, g, p, dirs, ub, ul, imm_, eps_, seed=None):
        return nfs.nuts_transition_plain(
            q, u, g, imm_, eps_, pot_grad, max_exp=HIER_K, momentum=p,
            directions=dirs, u_bias=ub, u_leaf=ul, seed=seed)

    n_w = SCHOOLS_WITNESS_CHAINS
    q_w = res.positions.new_tensor(0.1 * np.random.default_rng(192)
                                   .standard_normal((n_w, 10)))
    u_w, g_w = pg(q_w.T.contiguous(), *data)
    gen_w = torch.Generator().manual_seed(193)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (qw, uw, gw), eps_w, imm_w = warmup_fused(
        gen_w, plain_transition, q_w, u_w.T, g_w.T, SCHOOLS_WITNESS_WARMUP,
        max_num_expansions=HIER_K, target_acceptance_rate=HIER_TARGET)
    pos_w, stats_w, _, _, _ = nfs._sampling_plain(
        pot_grad, qw.T.contiguous(), uw.T, gw.T.contiguous(), imm_w, eps_w,
        derive_draw_seeds(gen_w, 1)[0], SCHOOLS_WITNESS_DRAWS, max_exp=HIER_K,
        divergence_threshold=1000.0, collect_positions=True,
        collect_dtype=torch.float32)
    torch.cuda.synchronize()
    wall_w = time.perf_counter() - t0
    witness = mean_mcse(torch, diagnostics, pos_w.permute(2, 0, 1).double())
    mean, mcse = mean_mcse(torch, diagnostics,
                           res.positions.transpose(0, 1).double())
    WITNESS_MEANS["eight schools NUTS"] = (mean, mcse)  # phase 43's
    z = float(((mean - witness[0]).abs()
               / torch.sqrt(mcse**2 + witness[1]**2)).max())
    mu = res.positions[:, :, 0].float()
    log(f"phase 19: eight schools: kernels 1 and 2 (EightSchoolsPG) vs plain "
        f"at {SCHOOLS_CHAINS} chains, eps {HIER_EPS}, K {HIER_CHECK_K}: "
        f"decisions equal on >= {share:.4%} of chains ({differ} chain-cases "
        f"differ), max |q| err {err:.3g}; kernel 2 == per-draw kernel 1 bit "
        f"for bit; front door {SCHOOLS_CHAINS} chains, {SCHOOLS_WARMUP} "
        f"warmup + {SCHOOLS_DRAWS} draws, K {HIER_K}, target {HIER_TARGET}: "
        f"{run['wall_s']:.2f} s (again {run['wall_s_again']:.2f} s, positions "
        f"equal bit for bit), launches {run['launches']}; accept "
        f"{run['accept']:.4f}, eps {run['step_size']:.4f}, mean leaves "
        f"{run['mean_leaves']:.1f}, {run['divergences']} divergences "
        f"({run['divergent_share']:.2e}); mu {float(mu.mean()):.3f} +- "
        f"{float(mu.std()):.3f}; means within {z:.2f} combined MCSE of the "
        f"plain sampler's ({n_w} chains, {SCHOOLS_WARMUP} + {SCHOOLS_DRAWS}, "
        f"{wall_w:.1f} s, {int(stats_w[:, 4].sum())} divergences); timed: "
        f"warmup {run['warmup_wall_s']:.3f} s, sampling "
        f"{run['sampling_wall_s']:.3f} s, {run['grad_evals_per_s'] / 1e6:.2f}M"
        f" grad-evals/s, {run['sampling_ess_per_s'] / 1e6:.3f}M ESS/s "
        f"sampling, {run['e2e_ess_per_s'] / 1e6:.3f}M ESS/s end to end "
        f"({run['timed_divergences']} divergences); kernel 1 "
        f"{times[0][0]:.3f} ms (plain {times[0][1]:.1f} ms), kernel 2 "
        f"{times[1][0]:.2f} ms (plain {times[1][1]:.1f} ms) per {HIER_DRAWS} "
        f"draws at the tuned state, where kernels 1 and 2 against plain "
        f"(single transitions, K {HIER_K}; kernel 2 == per-draw kernel 1 bit "
        f"for bit) agree on >= {times[3][0]:.4%} of decisions ({times[3][2]} "
        f"chain-cases differ), max |q| err {times[3][1]:.3g}; lockstep ratio "
        f"of kernel 1's tree sizes "
        f"for groups of " + ", ".join(f"{g}: {r:.4f}"
                                      for g, r in times[2].items())
        + f" [{card}]")
    record["phase19"] = dict(share=share, max_abs_err=err, differ=differ,
                             max_z_vs_witness=z, witness_chains=n_w,
                             witness_wall_s=wall_w,
                             witness_divergences=int(stats_w[:, 4].sum()),
                             mu_mean=float(mu.mean()), **run,
                             ms1=times[0][0], plain_ms1=times[0][1],
                             bound_ms1=times[0][2][0], ms2=times[1][0],
                             plain_ms2=times[1][1], bound_ms2=times[1][2][0],
                             lockstep=times[2], tuned_share=times[3][0],
                             tuned_max_abs_err=times[3][1],
                             tuned_differ=times[3][2])
    check(z < MCSE_Z, f"eight schools means differ from the plain sampler's "
          f"by {z} MCSE")
    check(run["finite"], "eight schools: non-finite draws")
    entries += hier_entries("eight_schools", run["launches"], max(err, times[3][1]),
                            times)
    return entries


def nuts_limits(torch, diagnostics, positions, accept, divergent, step_size,
                nuts_mean, what, bias_sd=None, witness=None):
    """Phase 5's limits on a NUTS run (``accept`` and ``divergent`` per draw
    and chain), and its means within MCSE_Z combined MCSE of phase 5's, or
    within ``bias_sd`` posterior standard deviations when given; and within
    MCSE_Z combined MCSE of ``witness`` (another run's means and MCSE) when
    given."""
    draws = positions.float().transpose(0, 1)  # (chains, draws, dim)
    rhat = float(chunked(torch, lambda v: diagnostics.potential_scale_reduction(
        v, rank_normalized=True), draws, 20).max())
    mean, mcse = mean_mcse(torch, diagnostics, draws)
    z = float(((mean - nuts_mean[0]).abs()
               / torch.sqrt(mcse**2 + nuts_mean[1]**2)).max())
    sd = draws.reshape(-1, draws.shape[2]).std(dim=0)
    shift_sd = float(((mean - nuts_mean[0]).abs() / sd).max())
    out = dict(accept=float(accept.float().mean()),
               divergent_share=float(divergent.float().mean()), max_rhat=rhat,
               max_z_vs_nuts=z, max_mean_shift_sd=shift_sd,
               finite=bool(torch.isfinite(draws).all()))
    eps = float(step_size)
    check(0.7 <= out["accept"] <= 0.9, f"{what} mean acceptance {out['accept']}")
    check(out["divergent_share"] < 1e-4,
          f"{what} divergent share {out['divergent_share']}")
    check(0.4 <= eps <= 0.65, f"{what} tuned step size {eps}")
    check(rhat < 1.01, f"{what} max R-hat {rhat}")
    if bias_sd is None:
        check(z < MCSE_Z, f"{what} posterior means differ from NUTS by {z} MCSE")
    else:
        check(shift_sd < bias_sd, f"{what} posterior means differ from NUTS "
              f"by {shift_sd} posterior sd ({z} MCSE)")
    if witness is not None:
        out["max_z_vs_witness"] = float(((mean - witness[0]).abs() / torch.sqrt(
            mcse**2 + witness[1]**2)).max())
        check(out["max_z_vs_witness"] < MCSE_Z, f"{what} posterior means "
              f"differ from the witness's by {out['max_z_vs_witness']} MCSE")
    check(out["finite"], f"{what}: non-finite draws")
    return out


def front_door_checks(torch, diagnostics, res, nuts_mean, what,
                      accept_range=(0.7, 0.9), checks=True, rhat_max=None):
    """The limits of a MALA, GHMC, ChEES or MEADS front-door run, set before
    the run: acceptance, divergences, finite draws, each dimension's split
    R-hat within RHAT_EXCESS of its stationary value (or, given
    ``rhat_max``, the maximum below it), and each posterior mean within
    MCSE_Z combined MCSE of the NUTS run's (``nuts_mean``: means and
    MCSE)."""
    diag = res.diagnostics
    x = res.positions.float().transpose(0, 1)  # (chains, draws, dim)
    rhat = chunked(torch, lambda v: diagnostics.potential_scale_reduction(
        v, rank_normalized=True), x, 20)
    mean, mcse, ess = mean_mcse(torch, diagnostics, x, with_ess=True)
    n = x.shape[1] // 2  # draws per split chain
    tau = x.shape[0] * 2 * n / ess
    excess = rhat - torch.sqrt((n - 1) / (n - tau))
    z = (mean - nuts_mean[0]).abs() / torch.sqrt(mcse**2 + nuts_mean[1]**2)
    WITNESS_MEANS.setdefault(what, (mean, mcse))
    out = dict(
        accept=float(diag.acceptance_probability.mean()),
        divergent_share=float(diag.is_diverging.float().mean()),
        step_size=float(torch.as_tensor(res.step_size).float().mean()),
        max_rhat=float(rhat.max()),
        max_rhat_excess=float(excess.max()),
        tau_max=float(tau.max()), tau_median=float(tau.median()),
        max_z_vs_nuts=float(z.max()),
        finite=bool(torch.isfinite(res.positions).all()),
    )
    if checks:
        hold_front_door(out, what, accept_range, rhat_max)
    return out


def hold_front_door(out, what, accept_range=(0.7, 0.9), rhat_max=None):
    """The limits of front_door_checks on its measurements ``out``."""
    check(accept_range[0] <= out["accept"] <= accept_range[1],
          f"{what} mean acceptance {out['accept']}")
    check(out["divergent_share"] < 1e-4,
          f"{what} divergent share {out['divergent_share']}")
    if rhat_max is None:
        check(out["max_rhat_excess"] < RHAT_EXCESS,
              f"{what} R-hat exceeds its stationary value by "
              f"{out['max_rhat_excess']} (max R-hat {out['max_rhat']})")
    else:
        check(out["max_rhat"] < rhat_max,
              f"{what} max R-hat {out['max_rhat']} (limit {rhat_max})")
    check(out["max_z_vs_nuts"] < MCSE_Z,
          f"{what} posterior means differ from NUTS by {out['max_z_vs_nuts']} "
          f"MCSE")
    check(out["finite"], f"{what}: non-finite draws")


# phases 20-23: the XLA path for any logprob_fn (aehmc_tpu_torch.nuts, hmc,
# mala, ghmc, chees.new_kernel, window_adaptation.run, parallel.pooled_warmup)
# at the sizes of the JAX benchmark's reference-anchored configs
# (benchmarks/run.py:179-416), draws cut where noted to keep phases 20-23
# within 150 s: the path is host-bound (about 3 ms a leaf, and a batch walks
# its deepest chain's tree), and its host time moves ±50% between machines
README_EPS, README_STEPS = 0.9, 100                 # config 1
# config 2 (its 1,000 warmup steps cut to 500: 26 s of host loops on an
# H100 machine; the gate, M⁻¹ within relative 1.0 of the
# posterior variance, held at 0.26 after 1,000)
LINREG_POINTS, LINREG_WARMUP, LINREG_EPS0 = 10_000, 500, 0.1
# config 3, 200 draws cut to 100
MVN_DIM, MVN_RHO, MVN_CHAINS, MVN_EPS, MVN_DRAWS = 25, 0.5, 512, 0.8, 100
# config 5, 200 draws cut to 100
LOGISTIC_K, LOGISTIC_WARMUP, LOGISTIC_DRAWS, LOGISTIC_EPS0 = 8, 150, 100, 0.1
# config 4, the funnel at depth 10: 512 chains at ε 0.2 as the JAX bench,
# its 200 draws cut to 8 (40 draws took 73.4 s on an NVIDIA H100 80GB HBM3
# at 700 W); its deepest trees are held against kernel 1 (FunnelPG) instead:
# one XLA NUTS step at K 10 from N(0, 1), phase 18's chain count, at an ε
# that sends about 45% of the chains to 1,023 leaves
FUNNEL_XLA_CHAINS, FUNNEL_XLA_EPS, FUNNEL_XLA_DRAWS = 512, 0.2, 8
FUNNEL_DEEP_EPS = 0.005
# phase 22: the front door's new routes, each run twice with one seed
AUTO_WARMUP, AUTO_DRAWS = 50, 50   # the README example, 10-d N(0, I)
# sample_chains' batch: every chain adapts alone, so early warmup steps
# walk to K's cap somewhere in the batch; K 8 as the pooled NUTS route
# 64 chains (256 before: 34.5 s for the two runs on an H100 host), and the pooled NUTS and HMC runs below halved, to make room for
# phases 54-55
XLA_BATCH, XLA_WARMUP, XLA_DRAWS, XLA_K = 64, 50, 50, 8
POOLED_RUNS = {  # algorithm: (warmup, draws, kwargs)
    "nuts": (50, 50, dict(max_num_expansions=8)),
    "hmc": (25, 25, {}),  # 32 integration steps a draw, the JAX default
    "mala": (150, 50, {}),
    "ghmc": (150, 50, {}),
}
WARMUP_GATE_RTOL = 1.0  # BASELINE.md's warmup gate: M⁻¹ against the variance


def sync_count(torch, fn):
    """``fn()`` and the host synchronisations torch's sync debug mode
    reports while it runs (it sees the ``.item()``/``bool()`` reads and
    blocking copies; not every synchronising call)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught), out


def z_vs_truth(torch, diagnostics, x, truth):
    """The largest |mean − truth| / MCSE over the dimensions of ``x (chains,
    draws, dim)``."""
    mean, mcse = mean_mcse(torch, diagnostics, x)
    return float(((mean - truth).abs() / mcse).max())


def xla_run_stats(torch, diagnostics, x, evals, wall):
    """Grad-evals/s and ESS/s (the minimum of bulk and tail ESS per
    dimension, capped at chains × draws, summed) of draws ``x (chains,
    draws, dim)`` taken in ``wall`` seconds."""
    bulk, tail = bulk_tail_ess(torch, diagnostics, x.float())
    ess = float(torch.minimum(bulk, tail).clamp(
        max=x.shape[0] * x.shape[1]).sum())
    return dict(wall_s=wall, grad_evals_per_s=evals / wall,
                ess_per_s=ess / wall, min_bulk_ess=float(bulk.min()))


def xla_vs_kernel_1(torch, out, info, q_k, stats):
    """The share of chains whose XLA NUTS step (``out``, ``info``) and
    kernel 1 (``q_k`` (dim, C), ``stats``) made the same decisions
    (doublings, leaves, divergent, turning), and the largest |Δq| on
    those."""
    same = ((info.num_doublings == stats[2].to(torch.int32))
            & (info.num_integration_steps == stats[3].to(torch.int32))
            & (info.is_diverging == (stats[4] > 0.5))
            & (info.is_turning == (stats[5] > 0.5)))
    err = (float((out.position - q_k.T)[same].abs().max())
           if bool(same.any()) else math.inf)
    return float(same.float().mean()), err


def vmap_alone_step_s(torch, kernel, seed, state, eps, imm):
    """Median seconds of ``kernel``'s XLA step with the potential's batched
    gradient taken by ``vmap`` of ``grad_and_value`` alone, the way before
    ``_batch.value_and_grad`` functionalized the potential: what
    functionalizing costs the host-bound path."""
    from unittest import mock

    from torch.func import grad_and_value, vmap

    from aehmc_tpu_torch import integrators

    def value_and_grad(potential_fn):
        one, batched = (grad_and_value(potential_fn),
                        vmap(grad_and_value(potential_fn)))

        def vag(q):
            g, u = (batched if q.ndim == 2 else one)(q)
            return u, g

        return vag

    with mock.patch.object(integrators, "value_and_grad", value_and_grad):
        kernel(seed + 1, state, eps, imm)
        return timed(torch, lambda r: kernel(seed, state, eps, imm), 3)[0]


def xla_phases(torch, ops, diagnostics, data, pg, q0, record, nuts_mean,
               card):
    """Phases 20-23.  Returns the kernel-8 launches of phase 23's main path
    (the pooled ChEES front door on ``chees.new_kernel(integrate_fn=kernel
    8)``) and that route's name."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch import chees, keys, nuts, sampling
    from aehmc_tpu_torch import window_adaptation
    from aehmc_tpu_torch.models import (
        correlated_mvn,
        linear_regression,
        logistic_regression,
        logistic_regression_data,
        neals_funnel,
        neals_funnel_pg_t,
        std_normal,
    )
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.parallel import pooled_warmup

    dev = q0.device
    t_start = time.perf_counter()
    logprob_fn, _ = logistic_regression(DIM, POINTS, device=dev)
    imm = torch.full((DIM,), IMM, device=dev)

    # ---- phase 20: the XLA NUTS step against kernel 1, one Philox seed
    seed = 20_2020
    state = nuts.new_state(q0, logprob_fn)
    kernel = nuts.new_kernel(logprob_fn, K)
    kernel(seed + 1, state, EPS, imm)  # first call: autograd warm-up
    t20, (out, info) = timed(torch, lambda r: kernel(seed, state, EPS, imm), 3)
    syncs20, _ = sync_count(torch, lambda: kernel(seed, state, EPS, imm))
    t20_vmap = vmap_alone_step_s(torch, kernel, seed, state, EPS, imm)
    q_t = q0.T.contiguous()
    u0, g0 = pg(q_t, *data)
    qk, _, _, stats = nfs.nuts_transition_cuda(q_t, u0, g0, imm, EPS, data,
                                               max_exp=K, seed=seed)
    share20, err20 = xla_vs_kernel_1(torch, out, info, qk, stats)
    leaves20 = float(info.num_integration_steps.float().mean())
    log(f"phase 20: XLA NUTS step vs kernel 1 at {CHAINS}x{DIM}, K={K}, eps "
        f"{EPS}, one Philox seed: decisions equal on {share20:.4%} of chains, "
        f"max |q| err {err20:.3g}; XLA step {t20 * 1e3:.1f} ms "
        f"({leaves20:.2f} leaves a chain, {syncs20} host syncs a "
        f"transition; {t20_vmap * 1e3:.1f} ms with the gradient batched by "
        f"vmap alone, not functionalized) [{card}]")
    check(share20 >= DECISION_SHARE, f"XLA NUTS vs kernel 1: {share20}")
    check(err20 <= Q_ATOL, f"XLA NUTS vs kernel 1: max |q| err {err20}")
    record["phase20"] = dict(share=share20, max_abs_err=err20, step_ms=t20 * 1e3,
                             step_ms_vmap_alone=t20_vmap * 1e3,
                             host_syncs=syncs20, mean_leaves=leaves20)
    del out, info, state, qk, stats

    # ---- phase 21: the reference-anchored configs on the XLA and pooled paths
    phase21 = {}
    # config 1, readme_nuts: one chain of a 1-D standard normal
    lp1 = std_normal()
    k1 = nuts.new_kernel(lp1)
    one = torch.ones((), device=dev)
    s1 = nuts.new_state(torch.ones((), device=dev), lp1)
    t1, (_, pos1, inf1) = timed(torch, lambda r: sampling.sample_loop(
        keys.Key(21), lambda k, s: k1(k, s, README_EPS, one), s1,
        README_STEPS), 1)
    x1 = pos1.reshape(1, -1, 1)
    z_mean1 = z_vs_truth(torch, diagnostics, x1, 0.0)
    # the sd through the mean of x² (its MCSE by the delta method)
    z_var1 = z_vs_truth(torch, diagnostics, x1**2, 1.0)
    phase21["readme_nuts"] = dict(
        **xla_run_stats(torch, diagnostics, x1,
                        float(inf1.num_integration_steps.sum()), t1),
        z_mean=z_mean1, z_second_moment=z_var1,
        mean=float(pos1.mean()), sd=float(pos1.std()))
    check(z_mean1 < MCSE_Z and z_var1 < MCSE_Z,
          f"config 1: mean {z_mean1} / second moment {z_var1} MCSE off")
    # config 2, linreg_warmup: window_adaptation.run, LINREG_WARMUP steps from 0.1
    lp2, q2 = linear_regression(num_points=LINREG_POINTS, device=dev)
    k2 = nuts.new_kernel(lp2)
    s2 = nuts.new_state(q2, lp2)
    t2, (last2, (eps2, imm2), inf2) = timed(torch, lambda r: window_adaptation.run(
        keys.Key(22), k2, s2, LINREG_WARMUP, initial_step_size=LINREG_EPS0), 1)
    # the posterior variance: the inverse Hessian at the last warmup state
    hess = torch.autograd.functional.hessian(lambda q: -lp2(q),
                                             last2.position)
    var2 = torch.diagonal(torch.linalg.inv(hess.double())).float()
    rel2 = float(((imm2 - var2).abs() / var2).max())
    evals2 = float(inf2.num_integration_steps.sum())
    phase21["linreg_warmup"] = dict(
        wall_s=t2, grad_evals_per_s=evals2 / t2, step_size=float(eps2),
        inverse_mass_matrix=imm2.tolist(), posterior_variance=var2.tolist(),
        max_rel_err=rel2)
    check(0.1 < float(eps2) < 2.0, f"config 2 tuned eps {float(eps2)}")
    check(rel2 < WARMUP_GATE_RTOL, f"config 2 M⁻¹ {imm2.tolist()} against "
          f"the posterior variance {var2.tolist()}")
    # config 3, mvn25_dense: the true covariance as a dense M⁻¹
    lp3 = correlated_mvn(MVN_DIM, MVN_RHO, device=dev)
    cov = torch.full((MVN_DIM, MVN_DIM), MVN_RHO, device=dev)
    cov.fill_diagonal_(1.0)
    k3 = nuts.new_kernel(lp3)
    gen3 = torch.Generator(device=dev).manual_seed(23)
    s3 = nuts.new_state(torch.randn(MVN_CHAINS, MVN_DIM, generator=gen3,
                                    device=dev), lp3)
    t3, (_, pos3, inf3) = timed(torch, lambda r: sampling.sample_loop(
        keys.Key(23), lambda k, s: k3(k, s, MVN_EPS, cov), s3, MVN_DRAWS), 1)
    x3 = pos3.transpose(0, 1)
    z3 = z_vs_truth(torch, diagnostics, x3, 0.0)
    phase21["mvn25_dense"] = dict(
        **xla_run_stats(torch, diagnostics, x3,
                        float(inf3.num_integration_steps.sum()), t3),
        max_z=z3, finite=bool(torch.isfinite(pos3).all()))
    check(z3 < MCSE_Z, f"config 3 means {z3} MCSE from 0")
    check(phase21["mvn25_dense"]["finite"], "config 3: non-finite draws")
    del pos3, x3
    # config 5, logistic_10k: pooled warmup, then draws
    k5 = nuts.new_kernel(logprob_fn, LOGISTIC_K)
    s5 = nuts.new_state(q0, logprob_fn)
    t5w, (s5, (eps5, imm5), _) = timed(torch, lambda r: pooled_warmup(
        keys.Key(25), k5, s5, LOGISTIC_WARMUP,
        initial_step_size=LOGISTIC_EPS0), 1)
    t5, (_, pos5, inf5) = timed(torch, lambda r: sampling.sample_loop(
        keys.Key(26), lambda k, s: k5(k, s, eps5, imm5), s5, LOGISTIC_DRAWS),
        1)
    x5 = pos5.transpose(0, 1)
    rhat5 = float(chunked(torch, lambda v: diagnostics.potential_scale_reduction(
        v, rank_normalized=True), x5, 20).max())
    m5, se5 = mean_mcse(torch, diagnostics, x5)
    z5 = float(((m5 - nuts_mean[0]).abs()
                / torch.sqrt(se5**2 + nuts_mean[1]**2)).max())
    accept5 = float(inf5.acceptance_probability.mean())
    div5 = float(inf5.is_diverging.float().mean())
    phase21["logistic_10k"] = dict(
        **xla_run_stats(torch, diagnostics, x5,
                        float(inf5.num_integration_steps.sum()), t5),
        warmup_wall_s=t5w, step_size=float(eps5), accept=accept5,
        divergent_share=div5, max_rhat=rhat5, max_z_vs_nuts=z5,
        mean_leaves=float(inf5.num_integration_steps.float().mean()),
        finite=bool(torch.isfinite(pos5).all()))
    check(0.7 <= accept5 <= 0.9, f"config 5 acceptance {accept5}")
    check(rhat5 < 1.01, f"config 5 max R-hat {rhat5}")
    check(z5 < MCSE_Z, f"config 5 means {z5} combined MCSE from phase 5's")
    check(div5 < 1e-4, f"config 5 divergent share {div5}")
    check(phase21["logistic_10k"]["finite"], "config 5: non-finite draws")
    del pos5, x5, s5
    # config 4, the funnel at depth 10
    lp4, _ = neals_funnel(FUNNEL_DIM, device=dev)
    k4 = nuts.new_kernel(lp4, 10)
    gen4 = torch.Generator(device=dev).manual_seed(24)
    s4 = nuts.new_state(0.1 * torch.randn(FUNNEL_XLA_CHAINS, FUNNEL_DIM,
                                          generator=gen4, device=dev), lp4)
    ones4 = torch.ones(FUNNEL_DIM, device=dev)
    t4, (_, pos4, inf4) = timed(torch, lambda r: sampling.sample_loop(
        keys.Key(24), lambda k, s: k4(k, s, FUNNEL_XLA_EPS, ones4), s4,
        FUNNEL_XLA_DRAWS), 1)
    phase21["funnel_depth10"] = dict(
        **xla_run_stats(torch, diagnostics, pos4.transpose(0, 1),
                        float(inf4.num_integration_steps.sum()), t4),
        draws=FUNNEL_XLA_DRAWS,
        mean_depth=float(inf4.num_doublings.float().mean()),
        max_depth=int(inf4.num_doublings.max()),
        accept=float(inf4.acceptance_probability.mean()),
        finite=bool(torch.isfinite(pos4).all()))
    check(phase21["funnel_depth10"]["finite"], "funnel: non-finite draws")
    # its deepest trees: one XLA step at K 10 against kernel 1 (FunnelPG)
    _, pg4, data4, _ = neals_funnel_pg_t(FUNNEL_DIM, device=dev)
    q_t = hier_start(torch, FUNNEL_DIM, FUNNEL_CHAINS, 2104)
    t4d, (out, info) = timed(torch, lambda r: k4(
        2105, nuts.new_state(q_t.T.contiguous(), lp4), FUNNEL_DEEP_EPS,
        ones4), 1)
    u0, g0 = pg4(q_t, *data4)
    qk, _, _, stats = nfs.nuts_transition_cuda(
        q_t, u0, g0, ones4, FUNNEL_DEEP_EPS, data4, max_exp=10, seed=2105,
        potential_and_grad_t=pg4)
    share, err = xla_vs_kernel_1(torch, out, info, qk, stats)
    depth = info.num_doublings
    phase21["funnel_k10_vs_kernel_1"] = dict(
        chains=FUNNEL_CHAINS, eps=FUNNEL_DEEP_EPS, share=share,
        max_abs_err=err, step_s=t4d, mean_depth=float(depth.float().mean()),
        depth10_share=float((depth == 10).float().mean()),
        mean_leaves=float(info.num_integration_steps.float().mean()))
    check(share >= DECISION_SHARE, f"funnel K 10: XLA NUTS vs kernel 1 {share}")
    check(err <= Q_ATOL, f"funnel K 10: XLA NUTS vs kernel 1 max |q| err {err}")
    del out, info, qk, stats
    for name, r in phase21.items():
        log(f"phase 21: {name}: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()) + f" [{card}]")
    record["phase21"] = phase21

    # ---- phase 22: the front door's XLA and pooled routes, twice each
    phase22 = {}
    lp10 = std_normal()

    def twice(name, run):
        walls, outs = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(run())
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        a, b = outs
        check(torch.equal(a.positions, b.positions),
              f"{name}: two runs with one seed differ")
        check(bool(torch.isfinite(a.positions).all()), f"{name}: non-finite")
        phase22[name] = dict(wall_s=walls[0], wall_s_again=walls[1])
        return a

    res = twice("auto_1d", lambda: aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(221), lp10,
        torch.zeros(10, device=dev), AUTO_DRAWS, AUTO_WARMUP))
    check(res.positions.shape == (AUTO_DRAWS, 10), "auto route shape")
    phase22["auto_1d"]["z_vs_truth"] = z_vs_truth(
        torch, diagnostics, res.positions[None], 0.0)
    res = twice("xla_2d", lambda: aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(222), lp10,
        torch.zeros(XLA_BATCH, 10, device=dev), XLA_DRAWS, XLA_WARMUP,
        path="xla", max_num_expansions=XLA_K))
    check(res.positions.shape == (XLA_BATCH, XLA_DRAWS, 10), "xla route shape")
    leaves = res.diagnostics.num_integration_steps.float()  # (chains, draws)
    phase22["xla_2d"].update(
        z_vs_truth=z_vs_truth(torch, diagnostics, res.positions, 0.0),
        chains=XLA_BATCH, mean_leaves=float(leaves.mean()),
        # a draw of the batch walks its deepest chain's tree
        mean_leaves_walked=float(leaves.max(dim=0).values.mean()))
    for name in ("auto_1d", "xla_2d"):
        check(phase22[name]["z_vs_truth"] < MCSE_Z,
              f"{name} means {phase22[name]['z_vs_truth']} MCSE from 0")
    for algorithm, (warm, draws, kw) in POOLED_RUNS.items():
        name = f"pooled_{algorithm}"
        res = twice(name, lambda: aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(223), logprob_fn, q0, draws, warm,
            algorithm=algorithm, path="pooled", initial_step_size=0.1, **kw))
        check(res.positions.shape == (draws, CHAINS, DIM),
              f"{name} route shape")
        x = res.positions.transpose(0, 1)
        m, se = mean_mcse(torch, diagnostics, x)
        z = float(((m - nuts_mean[0]).abs()
                   / torch.sqrt(se**2 + nuts_mean[1]**2)).max())
        evals = float(res.diagnostics.num_integration_steps.float().sum())
        phase22[name].update(
            max_z_vs_nuts=z, step_size=float(res.step_size),
            accept=float(res.diagnostics.acceptance_probability.mean()),
            grad_evals_per_s=evals / phase22[name]["wall_s"])
        check(z < MCSE_Z, f"{name} means {z} combined MCSE from phase 5's")
        del res, x
    for name, r in phase22.items():
        log(f"phase 22: {name}: " + ", ".join(
            f"{k} {v:.4g}" for k, v in r.items())
            + " (two runs, equal bit for bit) " + f"[{card}]")
    record["phase22"] = phase22

    # ---- phase 23: the XLA ChEES kernel on kernel 8
    X, y = logistic_regression_data(DIM, POINTS, device=dev)
    binding = ops.logistic_integrate_fn(X, y)
    k_fused = chees.new_kernel(logprob_fn, integrate_fn=binding)
    k_auto = chees.new_kernel(logprob_fn)
    states = nuts.new_state(q0, logprob_fn)
    steps = torch.full((), LEAPFROG_STEPS, dtype=torch.int32, device=dev)
    ms_f = cuda_ms(torch, lambda: k_fused(23, states, EPS, steps, imm), 3)
    ms_a = cuda_ms(torch, lambda: k_auto(23, states, EPS, steps, imm), 3)
    syncs23, (kf, fi) = sync_count(
        torch, lambda: k_fused(23, states, EPS, steps, imm))
    ka, ai = k_auto(23, states, EPS, steps, imm)
    moved_f, moved_a = ((s.position != q0).any(dim=1) for s in (kf, ka))
    same23 = moved_f == moved_a
    share23 = float(same23.float().mean())
    err23 = (float((kf.position - ka.position)[same23].abs().max())
             if bool(same23.any()) else math.inf)
    log(f"phase 23: chees.new_kernel on kernel 8 vs the autograd leapfrog at "
        f"{CHAINS}x{DIM}, L {LEAPFROG_STEPS}, eps {EPS}, one Philox seed: "
        f"accept decisions equal on {share23:.4%}, max |q| err {err23:.3g}; "
        f"a step {ms_f:.2f} ms on kernel 8 ({syncs23} host syncs), "
        f"{ms_a:.2f} ms autograd [{card}]")
    check(share23 >= DECISION_SHARE, f"kernel 8 ChEES step: {share23}")
    check(err23 <= Q_ATOL, f"kernel 8 ChEES step: max |q| err {err23}")
    del kf, ka, fi, ai
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(230), logprob_fn, q0, DRAWS, WARMUP,
        algorithm="chees", path="pooled", initial_step_size=CHEES_EPS0,
        chees_kernel_fn=k_fused)
    torch.cuda.synchronize()
    wall23 = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    k8 = launches["fused_logistic_hmc"]
    probes = k8 - WARMUP - DRAWS
    check(1 <= probes <= 32 and sum(launches.values()) == k8,
          f"XLA ChEES front door launches {launches}")
    stats23 = front_door_checks(torch, diagnostics, res, nuts_mean,
                                "XLA ChEES on kernel 8",
                                accept_range=CHEES_ACCEPT)
    evals23 = float(res.diagnostics.num_integration_steps[:, 0].float().sum()
                    ) * CHAINS
    log(f"phase 23: sample(algorithm='chees', path='pooled') on kernel 8, "
        f"{WARMUP} warmup from eps {CHEES_EPS0} + {DRAWS} draws in "
        f"{wall23:.2f} s; kernel 8 launches {probes} probes + {WARMUP} + "
        f"{DRAWS} = {k8}; accept {stats23['accept']:.4f}, eps "
        f"{stats23['step_size']:.4f}, max R-hat {stats23['max_rhat']:.4f} "
        f"(excess {stats23['max_rhat_excess']:.4f}), means within "
        f"{stats23['max_z_vs_nuts']:.2f} MCSE of NUTS, sampling "
        f"{evals23 / wall23 / 1e6:.2f}M grad-evals/s over the whole run "
        f"[{card}]")
    record["phase23"] = dict(share=share23, max_abs_err=err23, step_ms=ms_f,
                             autograd_step_ms=ms_a, host_syncs=syncs23,
                             wall_s=wall23, launches=launches, **stats23)
    del res
    wall = time.perf_counter() - t_start
    record["phases_20_23_s"] = wall
    log(f"phases 20-23 took {wall:.1f} s [{card}]")
    return k8, ("chees.new_kernel(integrate_fn=ops.logistic_integrate_fn) "
                "through sample(algorithm='chees', path='pooled')")



# phases 24-27: MEADS and checkpoint/resume.  Phase 24 is the JAX
# benchmark's meads_10k_chains_100d_fused_seg cell (benchmarks/run.py:582-605
# with :483-546): the flagship posterior, float32 data, 10,240 chains from
# q0, 500 burn-in and 500 draws, re-estimation every 8 draws, through the
# front door's fused route (kernel 6, one launch an 8-draw segment).
MEADS_WARMUP, MEADS_DRAWS, MEADS_EVERY = 500, 500, 8
MEADS_ACCEPT_MIN = 0.5
# MEADS is a one-step sampler: split R-hat of its stationary chains is
# about sqrt((n - 1) / (n - tau)), which a flat 1.01 cannot hold at n = 250.
# tau is the JAX reference's on the same cell, not this run's
# (benchmarks/results_round3.jsonl, meads_10k_chains_100d_amortized: min ESS
# 473,579 of 10,240 x 500 draws, tau 10.81), so the flat limit on the
# maximum is fixed before the run: 1.0203 + RHAT_EXCESS.  This run's
# excess over its own stationary value is reported beside it.
MEADS_TAU_REF = 10240 * 500 / 473579
MEADS_RHAT_MAX = math.sqrt((MEADS_DRAWS // 2 - 1)
                           / (MEADS_DRAWS // 2 - MEADS_TAU_REF)) + RHAT_EXCESS
# phase 26: checkpointed MEADS through the front door (kernel 5 a draw)
CKPT_WARMUP, CKPT_DRAWS, CKPT_EVERY = 100, 100, 25
# phase 27: the other drivers' resume, and pooled MEADS, at 1,024 chains
SMALL_CHAINS = 1024
SMALL_NUTS, SMALL_EVERY = 50, 20
POOLED_MEADS = 100


def same_bits(a, b, what):
    """Every tensor of two results (trees of tensors) equal bit for bit."""
    def leaves(x):
        if isinstance(x, tuple):
            return [t for item in x for t in leaves(item)]
        return [] if x is None else [x]

    la, lb = leaves(a), leaves(b)
    check(len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and bool((x == y).all())
        for x, y in zip(la, lb)), f"{what}: not equal bit for bit")


def meads_phases(torch, ops, diagnostics, data, pot, pg, q0, record,
                 nuts_mean, card):
    """Phases 24-26: MEADS through the front door on kernel 6, kernels 5 and
    6 against their plain versions at MEADS's state, and checkpointed MEADS
    on kernel 5 with bitwise resume.  Returns kernels 5 and 6's MEADS
    launches and times for the ``kernels`` line."""
    import tempfile

    import aehmc_tpu_torch
    from aehmc_tpu_torch import keys, meads
    from aehmc_tpu_torch.models import logistic_regression
    from aehmc_tpu_torch.ops import ghmc_fused as gf
    from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
    from aehmc_tpu_torch.ops.philox import MASK32
    from aehmc_tpu_torch.parallel import sample_sharded

    dev = q0.device
    logprob_fn, _ = logistic_regression(DIM, POINTS, device=dev)
    front = dict(data=data, potential_fn_t=pot, potential_and_grad_t=pg,
                 meads_recompute_every=MEADS_EVERY)

    # ---- phase 24: the front door's fused MEADS route, twice
    def run24():
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(24), logprob_fn, q0, MEADS_DRAWS,
            MEADS_WARMUP, algorithm="meads", path="fused", **front)

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run24()
    torch.cuda.synchronize()
    wall24 = time.perf_counter() - t0
    launches24 = dict(ops.LAUNCHES)
    segments = -(-MEADS_WARMUP // MEADS_EVERY) + -(-MEADS_DRAWS // MEADS_EVERY)
    check(launches24["ghmc_segment"] == segments
          and launches24["ghmc_transition"] == 0,
          f"MEADS front door launches {launches24} (want {segments} "
          "ghmc_segment, 0 ghmc_transition)")
    out24 = front_door_checks(torch, diagnostics, res, nuts_mean, "MEADS",
                              accept_range=(MEADS_ACCEPT_MIN, 1.0),
                              rhat_max=MEADS_RHAT_MAX)
    hyper = meads.estimate_hyperparams(res.final_state)
    eps_f, alpha_f = hyper.step_size, hyper.alpha
    check(bool(torch.isfinite(eps_f).all() & (eps_f > 0).all()),
          f"MEADS per-fold step sizes {eps_f.tolist()}")
    check(bool(((alpha_f > 0) & (alpha_f < 1)).all()),
          f"MEADS per-fold alpha {alpha_f.tolist()}")
    t0 = time.perf_counter()
    again = run24()
    torch.cuda.synchronize()
    wall24b = time.perf_counter() - t0
    same_bits((res.positions, res.diagnostics, res.final_state),
              (again.positions, again.diagnostics, again.final_state),
              "MEADS front door run twice with one seed")
    del again
    final24 = res.final_state
    del res

    # the same path, timed by phase: the segment function marks where
    # sampling starts (its first call after the burn-in segments)
    segment_fn = gf.make_fused_meads_segment(pot, data,
                                             potential_and_grad_t=pg)
    marks = []

    def marked(*args, **kw):
        if len(marks) == 0 and marked.calls == -(-MEADS_WARMUP // MEADS_EVERY):
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
        marked.calls += 1
        return segment_fn(*args, **kw)

    marked.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    timed24 = sample_sharded(torch.Generator().manual_seed(124), logprob_fn,
                             q0, MEADS_DRAWS, MEADS_WARMUP, algorithm="meads",
                             meads_recompute_every=MEADS_EVERY,
                             meads_segment_fn=marked)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    t_burn, t_samp = marks[0] - t0, t_end - marks[0]
    n_est = -(-MEADS_WARMUP // MEADS_EVERY)
    est_ms = cuda_ms(torch, lambda: meads.estimate_hyperparams(final24), 20)
    bulk, tail = bulk_tail_ess(torch, diagnostics,
                               timed24.positions.transpose(0, 1))
    ess = float(torch.minimum(bulk, tail).clamp(
        max=CHAINS * MEADS_DRAWS).sum())
    del timed24
    evals_s = MEADS_DRAWS * CHAINS / t_samp
    ess_s, e2e = ess / t_samp, ess / (t_burn + t_samp)
    est_share = n_est * est_ms * 1e-3 / t_burn
    log(f"phase 24: MEADS front door (fused, kernel 6) {CHAINS}x{DIM}, "
        f"{MEADS_WARMUP} burn-in + {MEADS_DRAWS} draws, re-estimation every "
        f"{MEADS_EVERY}, in {wall24:.2f} s (again {wall24b:.2f} s); "
        f"launches {launches24}; accept "
        f"{out24['accept']:.4f}, divergent {out24['divergent_share']:.2e}, "
        f"mean eps {out24['step_size']:.4f}, per-fold eps "
        f"{[round(v, 4) for v in eps_f.tolist()]}, alpha "
        f"{[round(v, 4) for v in alpha_f.tolist()]}, max R-hat "
        f"{out24['max_rhat']:.4f} (limit {MEADS_RHAT_MAX:.4f}; max excess "
        f"over stationary, reported "
        f"{out24['max_rhat_excess']:.4f}, tau max {out24['tau_max']:.2f}), "
        f"means within {out24['max_z_vs_nuts']:.2f} MCSE of NUTS; twice with "
        f"one seed, equal bit for bit; timed: burn-in {t_burn:.3f} s, "
        f"sampling {t_samp:.3f} s, {evals_s / 1e6:.2f}M grad-evals/s, "
        f"{ess_s / 1e6:.2f}M ESS/s sampling, {e2e / 1e6:.2f}M ESS/s end to "
        f"end, bulk ESS min {float(bulk.min()):.0f}; one estimation "
        f"{est_ms:.3f} ms, the {n_est} of burn-in {est_share:.1%} of its wall "
        f"[{card}]")
    record["phase24"] = dict(
        wall_s=wall24, second_wall_s=wall24b, launches=launches24, **out24,
        rhat_limit=MEADS_RHAT_MAX,
        fold_step_sizes=eps_f.tolist(), fold_alphas=alpha_f.tolist(),
        burn_in_wall_s=t_burn, sampling_wall_s=t_samp,
        grad_evals_per_s=evals_s, sampling_ess_per_s=ess_s,
        e2e_ess_per_s=e2e, bulk_ess_min=float(bulk.min()),
        tail_ess_min=float(tail.min()), estimation_ms=est_ms,
        estimations_share_of_burn_in=est_share)

    # ---- phase 25: kernels 5 and 6 against their plain versions at
    # MEADS's state: phase 24's final states, their per-fold estimate
    # tiled per chain, one Philox seed
    folded = type(final24)(*(a.reshape((4, CHAINS // 4) + a.shape[1:])
                             for a in final24))
    (q, u, g, p), (eps_c, alpha_c, imm_c) = gf._meads_operands(folded, hyper)
    state = (q.T.contiguous(), u.reshape(1, -1), g.T.contiguous(),
             p.T.contiguous())
    pot_grad = lambda q_t: pg(q_t, *data)  # noqa: E731
    seed = 2525
    args = (eps_c, alpha_c, imm_c)

    def k5():
        return gf.ghmc_transition_cuda(*state, *args, data, seed=seed)

    def p5():
        return gf.ghmc_transition_plain(*state, *args, pot_grad, seed=seed)

    kern, plain = k5(), p5()
    torch.cuda.synchronize()
    share5, err5, nd5 = ghmc_compare(torch, state[0],
                                     (kern[0][None], kern[4][None]),
                                     (plain[0][None], plain[4][None]),
                                     "kernel 5 at MEADS's state")

    def k6():
        return gf.ghmc_segment_cuda(*state, *args, data, MEADS_EVERY,
                                    seed=seed)

    def p6():
        return gf.ghmc_segment_plain(*state, *args, pot_grad, MEADS_EVERY,
                                     seed=seed)

    seg_k, seg_p = k6(), p6()
    share6, err6, nd6 = ghmc_compare(torch, state[0], seg_k[:2], seg_p[:2],
                                     f"kernel 6 at MEADS's state, "
                                     f"{MEADS_EVERY} draws")
    st = state
    for t in range(MEADS_EVERY):  # the segment is its transitions, bitwise
        *st, s_t = gf.ghmc_transition_cuda(
            *st, *args, data, seed=(seed + t * DRAW_SEED_STRIDE) & MASK32)
        check(torch.equal(s_t, seg_k[1][t]) and torch.equal(st[0], seg_k[0][t]),
              f"kernel 6 draw {t} at MEADS's state differs from kernel 5")
    xla_states, xla_info = meads._make_fold_transition(logprob_fn)(
        keys.Key(seed), folded, hyper)
    moved_x = (xla_states.position.reshape(CHAINS, DIM) != q).any(dim=1)
    moved_k = (kern[0] != state[0]).any(dim=0)
    share_x = float((moved_x == moved_k).float().mean())
    check(share_x >= DECISION_SHARE,
          f"XLA fold transition vs kernel 5: accept decisions agree on "
          f"{share_x:.4f}")
    ms5, plain_ms5 = cuda_ms(torch, k5, 20), cuda_ms(torch, p5, 5)
    ms6, plain_ms6 = cuda_ms(torch, k6, 10), cuda_ms(torch, p6, 2)
    rows = nbytes(eps_c, alpha_c, imm_c)
    bound5 = bound(CHAINS * GRAD_FLOP, nbytes(*state, *data, *kern) + rows)
    bound6 = bound(MEADS_EVERY * CHAINS * GRAD_FLOP,
                   nbytes(*state, *data, *seg_k) + rows)
    log(f"phase 25: at MEADS's state (per-chain eps, alpha, (chains, dim) "
        f"M^-1): ghmc_transition vs plain, decisions equal on {share5:.4%} "
        f"({nd5} differ), max |q| err {err5:.3g}; ghmc_segment over "
        f"{MEADS_EVERY} draws vs plain {share6:.4%} ({nd6} differ), max |q| "
        f"err {err6:.3g}, == {MEADS_EVERY} ghmc_transition launches bit for "
        f"bit; the XLA fold transition under the same Key vs kernel 5: accept "
        f"decisions equal on {share_x:.4%}; kernel 5 {ms5:.4f} ms (plain "
        f"{plain_ms5:.3f}, bound {bound5[0]:.4f}), kernel 6 {ms6:.3f} ms "
        f"(plain {plain_ms6:.3f}, bound {bound6[0]:.4f}) per "
        f"{MEADS_EVERY}-draw segment [{card}]")
    record["phase25"] = dict(share5=share5, max_abs_err5=err5, share6=share6,
                             max_abs_err6=err6, share_xla=share_x, ms5=ms5,
                             plain_ms5=plain_ms5, ms6=ms6, plain_ms6=plain_ms6,
                             bound_ms5=bound5[0], bound_ms6=bound6[0])
    del final24, folded, state, kern, plain, seg_k, seg_p, xla_states

    # ---- phase 26: checkpointed MEADS through the front door: kernel 5 a
    # draw, and a run killed in sampling or in burn-in resumed bit for bit
    def run26(path, **kw):
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(26), logprob_fn, q0, CKPT_DRAWS,
            CKPT_WARMUP, algorithm="meads", path="fused",
            checkpoint_every=CKPT_EVERY, checkpoint_path=path, **front, **kw)

    def parts(r):
        return (r.positions, r.diagnostics, r.final_state, r.step_size,
                r.inverse_mass_matrix)

    # a bitwise resume needs kernels that reduce in a fixed order
    csrc = Path(__file__).resolve().parent / "aehmc_tpu_torch" / "csrc"
    atomics = [f.name for f in sorted(csrc.glob("*.cu*"))
               if "atomic" in f.read_text()]
    check(not atomics, f"kernel sources with atomics: {atomics}")
    with tempfile.TemporaryDirectory() as tmp:
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = run26(f"{tmp}/full.npz")
        torch.cuda.synchronize()
        wall26 = time.perf_counter() - t0
        launches26 = dict(ops.LAUNCHES)
        check(launches26["ghmc_transition"] == CKPT_WARMUP + CKPT_DRAWS
              and launches26["ghmc_segment"] == 0,
              f"checkpointed MEADS launches {launches26}")
        ckpt_mb = Path(f"{tmp}/full.npz").stat().st_size / 2**20
        check(run26(f"{tmp}/a.npz", _crash_after_segments=2) is None,
              "the run killed after 2 sampling segments returned")
        t0 = time.perf_counter()
        resumed = run26(f"{tmp}/a.npz", resume=True)
        torch.cuda.synchronize()
        wall_resume = time.perf_counter() - t0
        same_bits(parts(full), parts(resumed),
                  "checkpointed MEADS resumed after 2 sampling segments")
        del resumed
        check(run26(f"{tmp}/b.npz", _crash_after_warmup_segments=1) is None,
              "the run killed after 1 burn-in segment returned")
        check(not Path(f"{tmp}/b.npz").exists()
              and Path(f"{tmp}/b_warmup.npz").exists(),
              "burn-in snapshot missing")
        same_bits(parts(full), parts(run26(f"{tmp}/b.npz", resume=True)),
                  "checkpointed MEADS resumed after 1 burn-in segment")
    check(bool(torch.isfinite(full.positions).all()),
          "checkpointed MEADS: non-finite draws")
    log(f"phase 26: checkpointed MEADS front door (kernel 5 a draw) "
        f"{CHAINS}x{DIM}, {CKPT_WARMUP} + {CKPT_DRAWS}, a snapshot every "
        f"{CKPT_EVERY}, in {wall26:.2f} s (last snapshot {ckpt_mb:.0f} MiB; no "
        f"kernel source uses atomics); "
        f"launches {launches26}; killed after 2 sampling segments and resumed "
        f"({wall_resume:.2f} s), and killed after 1 burn-in segment and "
        f"resumed: positions, diagnostics and final state equal to the "
        f"uninterrupted run bit for bit [{card}]")
    record["phase26"] = dict(wall_s=wall26, launches=launches26,
                             resume_wall_s=wall_resume, snapshot_mib=ckpt_mb)
    return dict(segment=launches24["ghmc_segment"],
                transition=launches26["ghmc_transition"], ms5=ms5, ms6=ms6,
                err5=err5, err6=err6, bound5=bound5[0], bound6=bound6[0])


def checkpoint_phases(torch, ops, diagnostics, data, pot, pg, q0, record,
                      nuts_mean, card):
    """Phase 27: bitwise resume of the fused NUTS driver (kernel 1 a draw)
    and of pooled ChEES on kernel 7, and MEADS on ``path="pooled"`` (the
    XLA fold transition) held to phase 5's means."""
    import tempfile

    import aehmc_tpu_torch
    from aehmc_tpu_torch.models import logistic_regression
    from aehmc_tpu_torch.ops.chees_fused import make_fused_chees_kernel
    from aehmc_tpu_torch.ops.fused_driver import sample_fused_adaptive
    from aehmc_tpu_torch.parallel import sample_sharded

    logprob_fn, _ = logistic_regression(DIM, POINTS, device=q0.device)
    qs = q0[:SMALL_CHAINS].contiguous()
    nuts_kw = dict(potential_fn_t=pot, potential_and_grad_t=pg,
                   max_num_expansions=K, initial_step_size=0.1)

    def nuts27(**kw):
        return sample_fused_adaptive(torch.Generator().manual_seed(271), None,
                                     data, qs, SMALL_NUTS, SMALL_NUTS,
                                     **nuts_kw, **kw)

    chees_kernel = make_fused_chees_kernel(pot, data, potential_and_grad_t=pg)

    def chees27(**kw):
        return sample_sharded(torch.Generator().manual_seed(272), logprob_fn,
                              qs, SMALL_NUTS, SMALL_NUTS, algorithm="chees",
                              chees_kernel_fn=chees_kernel,
                              initial_step_size=CHEES_EPS0,
                              checkpoint_every=SMALL_EVERY, **kw)

    with tempfile.TemporaryDirectory() as tmp:
        ckpt = dict(checkpoint_every=SMALL_EVERY)
        ops.reset_launch_counts()
        full = nuts27(checkpoint_path=f"{tmp}/n.npz", **ckpt)
        launches_n = dict(ops.LAUNCHES)
        check(launches_n["nuts_transition"] == 2 * SMALL_NUTS
              and launches_n["nuts_sampling"] == 0,
              f"checkpointed fused NUTS launches {launches_n}")
        check(nuts27(checkpoint_path=f"{tmp}/n1.npz",
                     _crash_after_segments=1, **ckpt) is None,
              "the killed NUTS run returned")
        same_bits(full, nuts27(checkpoint_path=f"{tmp}/n1.npz", resume=True,
                               **ckpt), "fused NUTS resumed in sampling")
        check(nuts27(checkpoint_path=f"{tmp}/n2.npz",
                     _crash_after_warmup_segments=1, **ckpt) is None,
              "the NUTS run killed in warmup returned")
        same_bits(full, nuts27(checkpoint_path=f"{tmp}/n2.npz", resume=True,
                               **ckpt), "fused NUTS resumed in warmup")
        # the per-draw segments draw what the whole-run kernel draws
        same_bits(full, nuts27(loop_in_kernel=True),
                  "checkpointed fused NUTS against the whole-run kernel")
        ops.reset_launch_counts()
        full_c = chees27(checkpoint_path=f"{tmp}/c.npz")
        launches_c = dict(ops.LAUNCHES)
        check(launches_c["chees_transition"] >= 2 * SMALL_NUTS,
              f"checkpointed ChEES launches {launches_c}")
        check(chees27(checkpoint_path=f"{tmp}/c1.npz",
                      _crash_after_segments=1) is None,
              "the killed ChEES run returned")
        resumed_c = chees27(checkpoint_path=f"{tmp}/c1.npz", resume=True)
        same_bits((full_c.positions, full_c.diagnostics, full_c.final_state,
                   full_c.step_size),
                  (resumed_c.positions, resumed_c.diagnostics,
                   resumed_c.final_state, resumed_c.step_size),
                  "pooled ChEES on kernel 7 resumed")
    del full, full_c, resumed_c

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = aehmc_tpu_torch.sample(torch.Generator().manual_seed(273),
                                 logprob_fn, qs, POOLED_MEADS, POOLED_MEADS,
                                 algorithm="meads", path="pooled",
                                 meads_recompute_every=MEADS_EVERY)
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    mean, mcse = mean_mcse(torch, diagnostics,
                           res.positions.float().transpose(0, 1))
    z = float(((mean - nuts_mean[0]).abs()
               / torch.sqrt(mcse**2 + nuts_mean[1]**2)).max())
    accept = float(res.diagnostics.acceptance_probability.mean())
    check(z < MCSE_Z, f"pooled MEADS means differ from NUTS by {z} MCSE")
    check(bool(torch.isfinite(res.positions).all()),
          "pooled MEADS: non-finite draws")
    log(f"phase 27: at {SMALL_CHAINS} chains: fused NUTS driver, "
        f"{SMALL_NUTS} + {SMALL_NUTS}, a snapshot every {SMALL_EVERY} "
        f"(launches {launches_n}), resumed after a kill in sampling and in "
        f"warmup, and pooled ChEES on kernel 7 (launches {launches_c}) "
        f"resumed in sampling, each equal to its uninterrupted run bit for "
        f"bit, the NUTS one also to the whole-run kernel's; MEADS on "
        f"path='pooled' (XLA fold transition) {POOLED_MEADS} + "
        f"{POOLED_MEADS} in {wall_m:.2f} s, accept {accept:.4f}, means "
        f"within {z:.2f} MCSE of NUTS [{card}]")
    record["phase27"] = dict(nuts_launches=launches_n,
                             chees_launches=launches_c, pooled_meads_wall_s=wall_m,
                             pooled_meads_accept=accept,
                             pooled_meads_max_z_vs_nuts=z)


# phases 28-33: per-chain ε in kernels 1 and 2, and the options of the fused
# drivers that ride on it.  Phase 28 holds both kernels at a per-chain ε
# against their plain versions (the flagship at 10,240 chains; the funnel at
# 1,024, where the plain transition is affordable, timed at 8,192) and a
# constant ε vector against the scalar run bit for bit.  Phases 29-30 run
# the JAX benchmark's funnel cells (benchmarks/run.py:783-815
# funnel_fused_adaptive, unsorted and sorted; :1986
# funnel_fused_per_chain_eps; :2054 funnel_fused_quantile_eps; :1920
# funnel_fused_riffled: 8,192 chains, 300 + 200, K 10, target 0.85,
# sort_by_depth) against their JAX gates (tests/test_nuts_fused_tpu.py:
# 151-186, :397, :428, :245); phase 31 the flagship front door from ε 0.1
# with and without the initial-ε search; phase 32 the flagship NUTS, MALA
# and GHMC front doors with per-chain dual averaging snapped to 8 values
# (150 + 600 draws for MALA and GHMC, as mala_10k_fused); phase 33 a sorted
# funnel run checkpointed and resumed (the JAX gate at :358: 256 chains,
# 50 + 40, K 8, a snapshot every 10).
PC_SPREAD = (0.5, 2.0)        # phase 28: per-chain ε over the tuned scalar
PC_DRAWS = 5                  # phase 28: kernel 2 against the scalar run
PC_TIMED_DRAWS = 20           # phase 28: kernel 2's timed run (flagship)
PC_FUNNEL_CHECK = 1024        # phase 28: funnel chains held against plain
PC_FUNNEL_EPS = 0.05          # phase 28: the funnel's timed ε, near tuned
NECK_V, NECK_P_LOW, EPS_SPREAD = -4.5, 0.02, 3.0
QUANTILES, NECK_P_POOLED = 8, 0.0229 * 0.5
DIV_RATIO, DIV_FLOOR = 1.5, 50
RIFFLE = (0.25, 0.5, 1.0, 2.0)
PC_ONE_STEP_ACCEPT_MIN = 0.7  # phase 32: phase 11's lower limit
SEARCH_EPS0 = 0.1
# phase 33's sorted funnel run (phase 26's are CKPT_*)
SORTED_CKPT_CHAINS, SORTED_CKPT_WARMUP, SORTED_CKPT_DRAWS = 256, 50, 40
SORTED_CKPT_K, SORTED_CKPT_EVERY = 8, 10


def ab_ms(torch, fns, reps):
    """CUDA-event milliseconds a call of each of ``fns``, measured in the
    order A B C, then C B A, in one process and averaged, so that a drift of
    the card's clock over the measurement weighs on each alike."""
    out = [0.0] * len(fns)
    for order in (list(range(len(fns))), list(reversed(range(len(fns))))):
        for i in order:
            out[i] += cuda_ms(torch, fns[i], reps) / 2
    return out


def lockstep_seen(torch, doublings, leaves, sorted_):
    """Lockstep ratios (:func:`lockstep`) over every draw of a run
    (``doublings``, ``leaves``: (draws, chains)) in the order the kernel saw
    the chains: chain order, or under ``sort_by_depth`` the stable order of
    the previous draw's doublings (all 0 before the first draw)."""
    if sorted_:
        depth = torch.cat([torch.zeros_like(doublings[:1]), doublings[:-1]])
        leaves = torch.gather(leaves, 1,
                              torch.argsort(depth, dim=1, stable=True))
    draws, chains = leaves.shape
    out = {}
    for g in LOCKSTEP_GROUPS:
        x = leaves[:, : chains // g * g].reshape(draws, -1, g).double()
        out[g] = float(x.max(dim=2).values.sum() * g / x.sum())
    return out


def lockstep_rows(torch, rows):
    """Lockstep ratios over a list of (chains,) leaf rows, each in the order
    its kernel launch saw the chains."""
    leaves = torch.stack(rows)
    return lockstep_seen(torch, torch.zeros_like(leaves), leaves, False)


def per_chain_kernel_checks(torch, nfs, name, model, q_t, imm, eps_row, k,
                            seed):
    """:func:`hier_kernel_checks` at the per-chain ``eps_row`` (kernel 1
    against the plain transition, kernel 2 against per-draw launches of
    kernel 1 and each draw against plain), then both kernels at a constant
    ε vector equal to the scalar run bit for bit."""
    _, pg, data, _ = model
    out = hier_kernel_checks(torch, nfs, f"{name}, per-chain ε", model, q_t,
                             imm, eps_row, k, seed)
    state = (q_t, *pg(q_t, *data))
    scalar = float(eps_row.median())
    const = torch.full_like(eps_row, scalar)
    for what, run in (
            ("kernel 1", lambda e: nfs.nuts_transition_cuda(
                *state, imm, e, data, max_exp=k, seed=seed,
                potential_and_grad_t=pg)),
            ("kernel 2", lambda e: nfs.nuts_sampling_cuda(
                *state, imm, e, data, seed, PC_DRAWS, max_exp=k,
                potential_and_grad_t=pg))):
        check(all(torch.equal(a, b) for a, b in zip(run(scalar), run(const))),
              f"{what} ({name}) at a constant ε vector differs from the "
              f"scalar run")
    return out


def per_chain_times(torch, nfs, state, imm, eps_row, data, pg, k, draws,
                    per_leaf, peak):
    """Kernel 1 (Philox) and kernel 2 (``draws`` draws) at the scalar ε (the
    row's median), at that value as a constant vector (the same work and
    bits as the scalar run: what reading the row costs) and at the per-chain
    row, by CUDA events in one process; the per-chain runs' bounds."""
    scalar = float(eps_row.median())
    const = torch.full_like(eps_row, scalar)

    def k1(e):
        return lambda: nfs.nuts_transition_cuda(
            *state, imm, e, data, max_exp=k, seed=31, potential_and_grad_t=pg)

    def k2(e):
        return lambda: nfs.nuts_sampling_cuda(
            *state, imm, e, data, 37, draws, max_exp=k,
            potential_and_grad_t=pg)

    t1 = ab_ms(torch, [k1(scalar), k1(const), k1(eps_row)], 5)
    t2 = ab_ms(torch, [k2(scalar), k2(const), k2(eps_row)], 2)
    o1, o2 = k1(eps_row)(), k2(eps_row)()
    b1 = bound(float(o1[3][3].sum()) * per_leaf,
               nbytes(*state, imm, eps_row, *o1), peak)
    b2 = bound(float(o2[1][:, 3].sum()) * per_leaf,
               nbytes(*state, imm, eps_row, *o2), peak)
    return dict(k1_scalar_ms=t1[0], k1_const_ms=t1[1], k1_per_chain_ms=t1[2],
                k2_scalar_ms=t2[0], k2_const_ms=t2[1], k2_per_chain_ms=t2[2],
                k1_bound_ms=b1[0], k1_bound_by=b1[1], k2_bound_ms=b2[0],
                k2_bound_by=b2[1], k2_draws=draws, scalar_eps=scalar)


def per_chain_row(torch, scalar, chains, seed):
    """A per-chain ε row: ``scalar`` times a log-uniform factor in
    PC_SPREAD."""
    lo, hi = np.log(PC_SPREAD[0]), np.log(PC_SPREAD[1])
    f = np.exp(np.random.default_rng(seed).uniform(lo, hi, size=chains))
    return torch.tensor(scalar * f, dtype=torch.float32, device=DEVICE)


def per_chain_kernel_phase(torch, nfs, data, pg, q0, tuned, record, card):
    """Phase 28: kernels 1 and 2 at a per-chain ε, the flagship at phase
    5's tuned ε and M⁻¹ and Neal's funnel; returns the measurements the
    ``kernels`` entries carry."""
    from aehmc_tpu_torch.models import neals_funnel_pg_t

    eps5, imm5 = tuned
    q_t = q0.T.contiguous()
    state = (q_t, *pg(q_t, *data))
    eps_row = per_chain_row(torch, eps5, CHAINS, 2800)
    flag = per_chain_kernel_checks(torch, nfs, "flagship",
                                   (None, pg, data, None), q_t, imm5, eps_row,
                                   K, 2801)
    times = per_chain_times(torch, nfs, state, imm5, eps_row, data, pg, K,
                            PC_TIMED_DRAWS, GRAD_FLOP, PEAK_TF32X3)
    plain_ms = cuda_ms(torch, lambda: nfs.nuts_transition_plain(
        *state, imm5, eps_row, lambda x: pg(x, *data), max_exp=K, seed=31), 1)

    model = neals_funnel_pg_t(FUNNEL_DIM, device=DEVICE)
    _, fpg, fdata, _ = model
    ones = torch.ones(FUNNEL_DIM, device=DEVICE)
    funnel = per_chain_kernel_checks(
        torch, nfs, "funnel", model,
        hier_start(torch, FUNNEL_DIM, PC_FUNNEL_CHECK, 2802), ones,
        per_chain_row(torch, HIER_EPS, PC_FUNNEL_CHECK, 2803), HIER_CHECK_K,
        2804)
    q_f = hier_start(torch, FUNNEL_DIM, FUNNEL_CHAINS, 2805)
    ftimes = per_chain_times(
        torch, nfs, (q_f, *fpg(q_f, *fdata)), ones,
        per_chain_row(torch, PC_FUNNEL_EPS, FUNNEL_CHAINS, 2806), fdata, fpg,
        HIER_K, HIER_DRAWS, HIER_PG_FLOP["funnel"](FUNNEL_DIM)
        + 10 * FUNNEL_DIM, PEAK_F32)

    def fmt(t):
        return (f"kernel 1 {t['k1_scalar_ms']:.4f} ms at the scalar ε, "
                f"{t['k1_const_ms']:.4f} at it as a vector, "
                f"{t['k1_per_chain_ms']:.4f} per chain (bound "
                f"{t['k1_bound_ms']:.4f}, {t['k1_bound_by']}); kernel 2 per "
                f"{t['k2_draws']} draws {t['k2_scalar_ms']:.3f}, "
                f"{t['k2_const_ms']:.3f}, {t['k2_per_chain_ms']:.3f} (bound "
                f"{t['k2_bound_ms']:.4f}, {t['k2_bound_by']})")

    log(f"phase 28: kernels 1 and 2 at a per-chain ε ({PC_SPREAD[0]}x to "
        f"{PC_SPREAD[1]}x the scalar) vs plain: flagship {CHAINS}x{DIM} at "
        f"phase 5's tuned eps {eps5:.4f} and M⁻¹, K {K}: decisions equal on "
        f">= {flag[0]:.4%} ({flag[2]} chain-cases differ), max |q| err "
        f"{flag[1]:.3g}; funnel {PC_FUNNEL_CHECK} chains at eps "
        f"{HIER_EPS} x spread, K {HIER_CHECK_K}: >= {funnel[0]:.4%} "
        f"({funnel[2]} differ), max |q| err {funnel[1]:.3g}; kernel 2 == "
        f"per-draw kernel 1 bit for bit, a constant ε vector == the scalar "
        f"run bit for bit (both kernels, both functors); flagship: "
        f"{fmt(times)}, plain kernel 1 {plain_ms:.2f} ms; funnel "
        f"{FUNNEL_CHAINS} chains at eps {PC_FUNNEL_EPS} x spread, K "
        f"{HIER_K}: {fmt(ftimes)} [{card}]")
    record["phase28"] = dict(
        share=flag[0], max_abs_err=flag[1], differ=flag[2],
        funnel_share=funnel[0], funnel_max_abs_err=funnel[1],
        funnel_differ=funnel[2], plain_ms1=plain_ms, **times,
        **{"funnel_" + k: v for k, v in ftimes.items()})
    return dict(flagship=(flag, times, plain_ms), funnel=(funnel, ftimes))


def funnel_q0(torch, chains, seed):
    return torch.tensor(0.1 * np.random.default_rng(seed).standard_normal(
        (chains, FUNNEL_DIM)), dtype=torch.float32, device=DEVICE)


def funnel_front_door(torch, ops, model, q0, seed, want, what, **options):
    """The fused NUTS front door on the funnel at its cell (HIER_K, target
    HIER_TARGET), launches counted from 0 and held to ``want``.  Returns
    (result, wall, launches)."""
    import aehmc_tpu_torch

    pot, pg, data, _ = model
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(seed), None, q0, FUNNEL_DRAWS,
        FUNNEL_WARMUP, algorithm="nuts", path="fused", data=data,
        potential_fn_t=pot, potential_and_grad_t=pg,
        max_num_expansions=HIER_K, target_acceptance_rate=HIER_TARGET,
        **options)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in ops.LAUNCHES.items() if v}
    check(launches == want, f"{what}: launches {launches}, want {want}")
    return res, wall, launches


def neck(v, chains=None):
    """P(v < NECK_V) over draws FUNNEL_BURN onward, over ``chains`` (a mask)
    or all."""
    v = v[FUNNEL_BURN:]
    if chains is not None:
        v = v[:, chains]
    return float((v < NECK_V).float().mean())


def sorted_funnel_phase(torch, ops, diagnostics, record, card):
    """Phase 29: funnel_fused_adaptive unsorted and sorted through the front
    door (the sorted run twice with one seed, equal bit for bit), the JAX
    gate on both, then warmup and sampling timed apart (kernel 1 a step,
    then kernel 2 in one launch, or kernel 1 a draw when sorted), with the
    lockstep ratios in the order the kernel saw the chains."""
    from aehmc_tpu_torch.models import neals_funnel_pg_t
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.ops.fused_driver import warmup_fused

    model = neals_funnel_pg_t(FUNNEL_DIM, device=DEVICE)
    pot, pg, data, _ = model
    q0 = funnel_q0(torch, FUNNEL_CHAINS, 2900)
    u0, g0 = pg(q0.T.contiguous(), *data)
    transition = nfs.make_fused_nuts_transition_small(
        pot, data, max_num_expansions=HIER_K, potential_and_grad_t=pg,
        transposed_io=True)
    runs = {}
    for sort in (False, True):
        name = "sorted" if sort else "unsorted"
        want = ({"nuts_transition_funnel": FUNNEL_WARMUP + FUNNEL_DRAWS}
                if sort else {"nuts_transition_funnel": FUNNEL_WARMUP,
                              "nuts_sampling_funnel": 1})
        res, wall, launches = funnel_front_door(
            torch, ops, model, q0, 2901, want, f"funnel {name}",
            sort_by_depth=sort)
        diag = res.diagnostics
        v = res.positions[:, :, 0].float()
        vb = v[FUNNEL_BURN:]
        out = dict(wall_s=wall, launches=launches,
                   accept=float(diag.acceptance_probability.mean()),
                   divergences=int(diag.is_diverging.sum()),
                   step_size=float(res.step_size),
                   v_mean=float(vb.mean()), v_sd=float(vb.std(correction=0)),
                   neck_p=neck(v),
                   mean_leaves=float(diag.num_integration_steps.float()
                                     .mean()),
                   lockstep_front_door=lockstep_seen(
                       torch, diag.num_doublings.float(),
                       diag.num_integration_steps.float(), sort))
        check(out["accept"] > FUNNEL_ACCEPT,
              f"funnel {name} mean acceptance {out['accept']}")
        check(abs(out["v_mean"]) < FUNNEL_V_MEAN,
              f"funnel {name} mean of v {out['v_mean']}")
        check(abs(out["v_sd"] - 3.0) < FUNNEL_V_SD,
              f"funnel {name} sd of v {out['v_sd']}")
        check(bool(torch.isfinite(res.positions).all()),
              f"funnel {name}: non-finite draws")
        if sort:
            again, wall_b, _ = funnel_front_door(
                torch, ops, model, q0, 2901, want, "funnel sorted again",
                sort_by_depth=True)
            same_bits(res, again, "the sorted funnel run with one seed")
            out["wall_s_again"] = wall_b
            del again
        del res, v, vb
        seen = []

        def recording(*args, **kwargs):
            o = transition(*args, **kwargs)
            seen.append(o[3][3])
            return o

        t_warm, ((qw, _, _), eps_w, imm_w) = timed(
            torch, lambda r: warmup_fused(
                torch.Generator().manual_seed(2902), recording, q0,
                u0.T.contiguous(), g0.T.contiguous(), FUNNEL_WARMUP,
                max_num_expansions=HIER_K, target_acceptance_rate=HIER_TARGET,
                sort_by_depth=sort), 1)
        warm_leaves = float(torch.stack(seen).sum())
        out["lockstep_warmup"] = lockstep_rows(torch, seen)
        def sampling(eps):
            return lambda r: nfs.sample_fused_small(
                torch.Generator().manual_seed(2903), pot, data, qw,
                FUNNEL_DRAWS, eps, imm_w, max_num_expansions=HIER_K,
                potential_and_grad_t=pg, loop_in_kernel=not sort,
                sort_by_depth=sort, collect_positions=False)

        t_samp, (qf, _, stats_s) = timed(torch, sampling(eps_w), 1)
        samp_leaves = float(stats_s[:, :, 3].sum())
        if sort:
            # the same draws with ε a host float: no wait for the card a
            # draw (a 0-d tensor on the card is read back at each launch)
            t_float, (qf_b, _, _) = timed(torch, sampling(float(eps_w)), 1)
            check(torch.equal(qf_b, qf), "the sorted run with a host-float "
                  "ε made other draws")
            # kernel 1 alone at the run's last state, in the order of the
            # last draw's doublings and in chain order
            q_l = qf.T.contiguous()
            u_l, g_l = pg(q_l, *data)
            order = torch.argsort(stats_s[-1, :, 2], stable=True)

            def k1(idx):
                state = tuple(x[:, idx].contiguous() for x in (q_l, u_l, g_l))
                return lambda: transition(*state, None, None, None, None,
                                          imm_w, float(eps_w), seed=29)

            k1_sorted, k1_chain = ab_ms(
                torch, [k1(order), k1(torch.arange(FUNNEL_CHAINS,
                                                   device=DEVICE))], 10)
            out.update(sampling_wall_s_float_eps=t_float,
                       k1_sorted_order_ms=k1_sorted,
                       k1_chain_order_ms=k1_chain)
        out.update(warmup_wall_s=t_warm, sampling_wall_s=t_samp,
                   warmup_leaves=warm_leaves, sampling_leaves=samp_leaves,
                   grad_evals_per_s=samp_leaves / t_samp,
                   e2e_grad_evals_per_s=(warm_leaves + samp_leaves)
                   / (t_warm + t_samp),
                   lockstep_sampling=lockstep_seen(
                       torch, stats_s[:, :, 2], stats_s[:, :, 3], sort))
        runs[name] = out
        del seen, stats_s

    def fmt(name):
        r = runs[name]
        ls = ", ".join(f"{g}: {x:.3f}"
                       for g, x in r["lockstep_sampling"].items())
        lw = ", ".join(f"{g}: {x:.3f}" for g, x in r["lockstep_warmup"].items())
        return (f"{name}: front door {r['wall_s']:.2f} s, launches "
                f"{r['launches']}, accept {r['accept']:.4f}, "
                f"{r['divergences']} divergences, eps {r['step_size']:.4f}, "
                f"v mean {r['v_mean']:.3f} sd {r['v_sd']:.3f}, P(v < "
                f"{NECK_V}) {r['neck_p']:.4f}; timed warmup "
                f"{r['warmup_wall_s']:.3f} s, sampling "
                f"{r['sampling_wall_s']:.3f} s, "
                f"{r['grad_evals_per_s'] / 1e6:.2f}M grad-evals/s sampling, "
                f"{r['e2e_grad_evals_per_s'] / 1e6:.2f}M end to end; "
                f"lockstep in the kernel's order, warmup {lw}; sampling {ls}")

    srt, uns = runs["sorted"], runs["unsorted"]
    log(f"phase 29: funnel_fused_adaptive ({FUNNEL_CHAINS} chains, "
        f"{FUNNEL_WARMUP} + {FUNNEL_DRAWS}, K {HIER_K}) " + fmt("unsorted")
        + " | " + fmt("sorted")
        + f" (again {srt['wall_s_again']:.2f} s, equal bit for bit); sorted "
        f"per-draw sampling / unsorted whole-run sampling wall: "
        f"{srt['sampling_wall_s'] / uns['sampling_wall_s']:.3f}, with ε a "
        f"host float {srt['sampling_wall_s_float_eps']:.3f} s "
        f"({srt['sampling_wall_s_float_eps'] / uns['sampling_wall_s']:.3f}); "
        f"kernel 1 at the sorted run's last state "
        f"{srt['k1_sorted_order_ms']:.3f} ms in sorted order, "
        f"{srt['k1_chain_order_ms']:.3f} ms in chain order [{card}]")
    record["phase29"] = runs
    return runs


def funnel_eps_phase(torch, ops, record, card):
    """Phase 30: the per-chain, quantile-snapped and riffled ε cells on the
    funnel, sorted, each held to its JAX gate.  Returns the cells'
    launches."""
    from aehmc_tpu_torch.models import neals_funnel_pg_t

    model = neals_funnel_pg_t(FUNNEL_DIM, device=DEVICE)
    q0 = funnel_q0(torch, FUNNEL_CHAINS, 2900)
    want = {"nuts_transition_funnel": FUNNEL_WARMUP + FUNNEL_DRAWS}
    factors = torch.tensor(np.tile(RIFFLE, FUNNEL_CHAINS // len(RIFFLE)),
                           dtype=torch.float32, device=DEVICE)
    cells = (
        ("per_chain_eps", dict(per_chain_step_size=True)),
        ("quantile_eps", dict(per_chain_step_size=True,
                              per_chain_quantiles=QUANTILES)),
        ("riffled", dict(step_size_factors=factors)),
    )
    out = {}
    for name, options in cells:
        res, wall, launches = funnel_front_door(
            torch, ops, model, q0, 3001, want, f"funnel {name}",
            sort_by_depth=True, **options)
        diag = res.diagnostics
        v = res.positions[:, :, 0].float()
        eps = res.step_size
        if name == "riffled":
            low = factors == RIFFLE[0]
        else:
            low = eps <= torch.quantile(eps, 0.25)
        accept = diag.acceptance_probability
        out[name] = dict(
            wall_s=wall, launches=launches,
            accept=float(accept.mean()),
            divergences=int(diag.is_diverging.sum()),
            eps_min=float(eps.min()), eps_median=float(eps.median()),
            eps_max=float(eps.max()), distinct_eps=int(eps.unique().numel()),
            neck_p=neck(v), neck_p_low=neck(v, low),
            accept_low=float(accept[:, low].mean()),
            accept_rest=float(accept[:, ~low].mean()),
            finite=bool(torch.isfinite(res.positions).all()))
        check(out[name]["finite"], f"funnel {name}: non-finite draws")
        check(out[name]["neck_p_low"] > NECK_P_LOW,
              f"funnel {name}: low-ε chains' P(v < {NECK_V}) "
              f"{out[name]['neck_p_low']}")
        del res, v, diag, accept
    pc, qe, rf = out["per_chain_eps"], out["quantile_eps"], out["riffled"]
    check(pc["eps_max"] / pc["eps_min"] > EPS_SPREAD,
          f"per-chain ε spread {pc['eps_max'] / pc['eps_min']}")
    check(qe["distinct_eps"] <= QUANTILES,
          f"{qe['distinct_eps']} distinct snapped ε")
    check(qe["neck_p"] > NECK_P_POOLED, f"quantile ε P(v < {NECK_V}) "
          f"{qe['neck_p']}")
    check(qe["divergences"] <= max(DIV_RATIO * pc["divergences"], DIV_FLOOR),
          f"quantile ε divergences {qe['divergences']}, continuous "
          f"{pc['divergences']}")
    check(rf["accept_low"] > rf["accept_rest"],
          f"riffled: factor {RIFFLE[0]} acceptance {rf['accept_low']} not "
          f"above the rest's {rf['accept_rest']}")

    def fmt(name, r):
        return (f"{name}: {r['wall_s']:.2f} s, accept {r['accept']:.4f} (low "
                f"{r['accept_low']:.4f}, rest {r['accept_rest']:.4f}), "
                f"{r['divergences']} divergences, eps [{r['eps_min']:.4f}, "
                f"{r['eps_median']:.4f}, {r['eps_max']:.4f}] "
                f"({r['distinct_eps']} distinct), P(v < {NECK_V}) "
                f"{r['neck_p']:.4f}, low {r['neck_p_low']:.4f}")

    log(f"phase 30: funnel cells, sorted, {FUNNEL_CHAINS} chains, "
        f"{FUNNEL_WARMUP} + {FUNNEL_DRAWS}, K {HIER_K} (truth P(v < "
        f"{NECK_V}) = 0.0668; launches {want} each): "
        + "; ".join(fmt(n, r) for n, r in out.items()) + f" [{card}]")
    record["phase30"] = out
    return out


def search_phase(torch, ops, diagnostics, data, pot, pg, q0, record,
                 nuts_mean, card):
    """Phase 31: the flagship front door from ε SEARCH_EPS0 with the
    initial-ε search off and on, each held to phase 5's limits; the found ε
    and its probe count (the search alone, on the front door's generator
    seed: it draws first), and each warmup timed alone with its mean
    leaves."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.ops.fused_driver import (
        _generator_normals,
        _probe_value_and_grad,
        find_reasonable_step_size_fused,
        warmup_fused,
    )

    probe = _probe_value_and_grad(data, potential_and_grad_t=pg)
    transition = nfs.make_fused_nuts_transition_small(
        pot, data, max_num_expansions=K, potential_and_grad_t=pg,
        transposed_io=True)
    q_t = q0.T.contiguous()
    u0, g0 = pg(q_t, *data)
    out = {}
    for search in (False, True):
        name = "search" if search else "no search"
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(3100), None, q0, DRAWS, WARMUP,
            algorithm="nuts", path="fused", data=data, potential_fn_t=pot,
            potential_and_grad_t=pg, max_num_expansions=K,
            initial_step_size=SEARCH_EPS0, search_initial_step_size=search,
            collect_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        check(launches == {"nuts_transition": WARMUP, "nuts_sampling": 1},
              f"flagship {name} launches {launches}")
        diag = res.diagnostics
        lim = nuts_limits(torch, diagnostics, res.positions,
                          diag.acceptance_probability, diag.is_diverging,
                          res.step_size, nuts_mean, f"flagship, {name}")
        del res, diag
        seen = []

        def recording(*args, **kwargs):
            o = transition(*args, **kwargs)
            seen.append(o[3][3])
            return o

        t_warm, _ = timed(torch, lambda r: warmup_fused(
            torch.Generator().manual_seed(3100), recording, q0,
            u0.T.contiguous(), g0.T.contiguous(), WARMUP,
            max_num_expansions=K, initial_step_size=SEARCH_EPS0,
            search_initial_step_size=search, probe_value_and_grad=probe), 1)
        out[name] = dict(wall_s=wall, launches=launches, **lim,
                         warmup_wall_s=t_warm,
                         warmup_mean_leaves=float(torch.stack(seen).mean()),
                         first_steps_mean_leaves=float(
                             torch.stack(seen[:10]).mean()))
        del seen
    probes = []
    noise = _generator_normals(torch.Generator().manual_seed(3100),
                               (CHAINS, DIM), q0.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    found = find_reasonable_step_size_fused(
        lambda i: probes.append(i) or noise(i), probe, q0,
        torch.ones(DIM, device=q0.device), initial_step_size=SEARCH_EPS0,
        target_accept=0.8)
    found = float(found)
    search_s = time.perf_counter() - t0
    out["search"].update(found_eps=found, probes=len(probes),
                         search_wall_s=search_s)
    a, b = out["no search"], out["search"]
    log(f"phase 31: flagship front door from eps {SEARCH_EPS0}, {WARMUP} + "
        f"{DRAWS}, K {K}: the search finds eps {found:.4f} in {len(probes)} "
        f"probes ({search_s:.3f} s); warmup {a['warmup_wall_s']:.3f} s -> "
        f"{b['warmup_wall_s']:.3f} s, mean warmup leaves "
        f"{a['warmup_mean_leaves']:.2f} -> {b['warmup_mean_leaves']:.2f} "
        f"(first 10 steps {a['first_steps_mean_leaves']:.2f} -> "
        f"{b['first_steps_mean_leaves']:.2f}); front door "
        f"{a['wall_s']:.2f} -> {b['wall_s']:.2f} s; accept "
        f"{a['accept']:.4f}, {b['accept']:.4f}; max R-hat "
        f"{a['max_rhat']:.4f}, {b['max_rhat']:.4f}; means within "
        f"{a['max_z_vs_nuts']:.2f}, {b['max_z_vs_nuts']:.2f} MCSE of phase "
        f"5's [{card}]")
    record["phase31"] = out


def per_chain_front_doors(torch, ops, diagnostics, data, pot, pg, q0, record,
                          nuts_mean, card):
    """Phase 32: the flagship NUTS (kernel 1 a warmup step, then kernel 2,
    both at the per-chain ε), MALA and GHMC front doors with per-chain dual
    averaging snapped to QUANTILES values, MALA and GHMC also continuous
    (no snap).  NUTS is held to phase 5's limits; MALA and GHMC to phase
    11's, their acceptance from below only (above PC_ONE_STEP_ACCEPT_MIN
    continuous, at least the continuous run's snapped: the snap takes each
    chain to its bucket's least ε).  Returns the NUTS run's launches."""
    import aehmc_tpu_torch

    common = dict(path="fused", data=data, potential_fn_t=pot,
                  potential_and_grad_t=pg, initial_step_size=0.1,
                  per_chain_step_size=True)
    out = {}
    segments = -(-MALA_DRAWS // SEGMENT)
    for algorithm, draws, want, extra in (
            ("nuts", DRAWS, {"nuts_transition": WARMUP, "nuts_sampling": 1},
             dict(max_num_expansions=K, collect_dtype=torch.bfloat16)),
            ("mala", MALA_DRAWS, {"ghmc_transition": WARMUP,
                                  "ghmc_segment": segments},
             dict(segment_draws=SEGMENT)),
            ("ghmc", MALA_DRAWS, {"ghmc_transition": WARMUP,
                                  "ghmc_segment": segments},
             dict(segment_draws=SEGMENT, ghmc_alpha=GHMC_ALPHA))):
        # MALA and GHMC run continuous too, and their acceptance is held
        # from below only: a chain's dual averaging sees one noisy
        # one-step acceptance a step, unpooled, so its averaged log ε
        # lands where the acceptance is above the 0.8 target (0.928
        # continuous, 0.934 snapped in a development call); the snapped
        # run, whose bucket minima lower every chain's ε, at least the
        # continuous run's
        for snap in ((0, QUANTILES) if algorithm != "nuts" else (QUANTILES,)):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = aehmc_tpu_torch.sample(
                torch.Generator().manual_seed(3200), None, q0, draws, WARMUP,
                algorithm=algorithm, per_chain_quantiles=snap, **common,
                **extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            name = algorithm if snap else f"{algorithm} continuous"
            what = f"per-chain {name}"
            launches = {k: v for k, v in ops.LAUNCHES.items() if v}
            check(launches == want, f"{what} launches {launches}")
            eps = res.step_size
            check(eps.shape == (CHAINS,)
                  and eps.unique().numel() <= (snap or CHAINS),
                  f"{what}: ε of shape {tuple(eps.shape)} with "
                  f"{eps.unique().numel()} values")
            if algorithm == "nuts":
                diag = res.diagnostics
                lim = nuts_limits(torch, diagnostics, res.positions,
                                  diag.acceptance_probability,
                                  diag.is_diverging, eps.median(), nuts_mean,
                                  what)
            else:
                base = (out[f"{algorithm} continuous"]["accept"] if snap
                        else PC_ONE_STEP_ACCEPT_MIN)
                lim = front_door_checks(torch, diagnostics, res, nuts_mean,
                                        what, accept_range=(base, 1.0))
            out[name] = dict(wall_s=wall, launches=launches, **lim,
                             eps_min=float(eps.min()),
                             eps_median=float(eps.median()),
                             eps_max=float(eps.max()),
                             distinct_eps=int(eps.unique().numel()))
            del res
    log("phase 32: flagship front doors with per-chain dual averaging "
        f"snapped to {QUANTILES} values: " + "; ".join(
            f"{a}: {r['wall_s']:.2f} s, launches {r['launches']}, eps "
            f"[{r['eps_min']:.4f}, {r['eps_median']:.4f}, "
            f"{r['eps_max']:.4f}] ({r['distinct_eps']} values), accept "
            f"{r['accept']:.4f}, max R-hat {r['max_rhat']:.4f}, means within "
            f"{r['max_z_vs_nuts']:.2f} MCSE of NUTS" for a, r in out.items())
        + f" [{card}]")
    record["phase32"] = out
    return out["nuts"]["launches"]


def sorted_checkpoint_phase(torch, ops, record, card):
    """Phase 33: a sorted funnel run with per-chain dual averaging,
    checkpointed every SORTED_CKPT_EVERY steps, killed in sampling and in
    warmup and resumed, equal to the uninterrupted run bit for bit, which equals
    the unsegmented run."""
    import tempfile

    import aehmc_tpu_torch
    from aehmc_tpu_torch.models import neals_funnel_pg_t

    pot, pg, data, _ = neals_funnel_pg_t(FUNNEL_DIM, device=DEVICE)
    qs = funnel_q0(torch, SORTED_CKPT_CHAINS, 3300)
    kw = dict(algorithm="nuts", path="fused", data=data, potential_fn_t=pot,
              potential_and_grad_t=pg, max_num_expansions=SORTED_CKPT_K,
              sort_by_depth=True, per_chain_step_size=True)

    def run(**extra):
        return aehmc_tpu_torch.sample(torch.Generator().manual_seed(3301),
                                      None, qs, SORTED_CKPT_DRAWS,
                                      SORTED_CKPT_WARMUP, **kw, **extra)

    with tempfile.TemporaryDirectory() as tmp:
        ck = dict(checkpoint_every=SORTED_CKPT_EVERY)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = run(checkpoint_path=f"{tmp}/f.npz", **ck)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        check(launches == {"nuts_transition_funnel": SORTED_CKPT_WARMUP
                           + SORTED_CKPT_DRAWS},
              f"sorted checkpointed launches {launches}")
        check(run(checkpoint_path=f"{tmp}/s.npz", _crash_after_segments=2,
                  **ck) is None, "the killed sorted run returned")
        same_bits(full, run(checkpoint_path=f"{tmp}/s.npz", resume=True,
                            **ck), "the sorted run resumed in sampling")
        check(run(checkpoint_path=f"{tmp}/w.npz",
                  _crash_after_warmup_segments=2, **ck) is None,
              "the sorted run killed in warmup returned")
        same_bits(full, run(checkpoint_path=f"{tmp}/w.npz", resume=True,
                            **ck), "the sorted run resumed in warmup")
    same_bits(full, run(), "the checkpointed sorted run against the "
              "unsegmented one")
    log(f"phase 33: sorted funnel run, per-chain ε, {SORTED_CKPT_CHAINS} "
        f"chains, {SORTED_CKPT_WARMUP} + {SORTED_CKPT_DRAWS}, K "
        f"{SORTED_CKPT_K}, a snapshot every {SORTED_CKPT_EVERY}: {wall:.2f} s, "
        f"launches {launches}; resumed after a kill in sampling and in "
        f"warmup, each equal to the uninterrupted run bit for bit, which "
        f"equals the unsegmented run [{card}]")
    record["phase33"] = dict(wall_s=wall, launches=launches)
    return launches


# phases 34-38: any potential on kernels 1-4 through a functor generated
# from its traced gradient graph (aehmc_tpu_torch/ops/generic_pg.py).
# Phase 34 binds the flagship potential as a plain torch callable (X and y
# closed over) and holds the functor's gradient at kernel 1's own q_out
# against the plain back end and against float64 autograd; phase 35 holds
# kernels 1-4 on generated functors against their plain versions and
# against the hand-written LogisticPGT instantiations at phase 2's state
# (ε 0.5148, M⁻¹ 0.3386 as the JAX cells; K 6); phase 36 runs the JAX
# benchmark's nuts_fused_generic_10k cell (benchmarks/run.py:653-716:
# ops.sample_fused on a standard-layout jnp potential, 10,240 chains,
# 200 draws, internal Philox) from phase 5's final state; phase 37 the
# mvn25_fused (:1318-1372: 512 and 2,048 chains, dense M⁻¹ = the
# covariance, ε 0.8, K 10, 200 draws) and mvn25_dense_fused_adaptive
# (:899-966: 2,048 chains, 300 + 300, K 8, dense self-tuning from ε 0.3)
# cells; phase 38 the front door on a bare logprob_fn (the generic fused
# binding) at phase 5's settings, twice with one seed.
GEN_EPS, GEN_IMM = 0.5148, 0.3386   # phases 35-36: the JAX cells' state
GEN_SEED = 3434                      # phases 34-35: kernels 1 and 3's Philox key
GEN_GRAD_RTOL = 1e-5                 # phase 34: relative error of g
GEN_SAMPLING_DRAWS = 10              # phase 35: kernels 2 and 4 against plain
GEN_MVN_DIM, GEN_MVN_RHO = 25, 0.5
GEN_MVN_CHAINS, GEN_MVN_EPS, GEN_MVN_K, GEN_MVN_DRAWS = (512, 2048), 0.8, 10, 200
GEN_MVN_ADAPT = dict(chains=2048, warmup=300, draws=300, k=8, eps0=0.3)
GEN_MVN_RATIO_TOL = 0.1              # tuned off-diagonal / diagonal of M⁻¹


def generic_potentials(torch, dev):
    """The potentials phases 34-42 bind, each a plain torch callable, and
    their generated functors' texts (built in phase 1 with the sources)."""
    import aehmc_tpu_torch.api as api
    from aehmc_tpu_torch.models import (
        eight_schools_pg_t,
        funnel_pg_t,
        logistic_regression,
        neals_funnel_pg_t,
        schools_pg_t,
    )
    from aehmc_tpu_torch.models.hierarchical import (
        funnel_potential_t,
        schools_potential_t,
    )
    from aehmc_tpu_torch.models.regression import logistic_regression_data
    from aehmc_tpu_torch.ops import generic_pg

    X, y = logistic_regression_data(DIM, POINTS, device=dev)
    y_col = y.reshape(-1, 1)

    def flagship_t(q_t):  # X and y closed over
        # F.softplus, whose traced backward is σ everywhere: the repo's
        # clamp form (models/regression.py:_softplus) differentiates to 1,
        # not σ(0) = 1/2, where a float32 logit is exactly 0 (torch's clamp
        # backward), which the card's sum order meets a few times a run
        logits = X @ q_t
        return (-torch.sum(y_col * logits - torch.nn.functional.softplus(
            logits), dim=0) + 0.5 * torch.sum(q_t * q_t, dim=0))

    def cell_potential(q, Xv, y_row):  # benchmarks/run.py:669-675
        logits = q @ Xv.T
        sp = torch.clamp(logits, min=0.0) + torch.log1p(
            torch.exp(-torch.abs(logits)))
        return (-torch.sum(y_row * logits - sp, dim=-1)
                + 0.5 * torch.sum(q * q, dim=-1))

    def mvn_t(q_t, prec):  # benchmarks/run.py:1339-1340
        return 0.5 * torch.sum(q_t * (prec @ q_t), dim=0)

    cov = np.full((GEN_MVN_DIM, GEN_MVN_DIM), GEN_MVN_RHO, dtype=np.float32)
    np.fill_diagonal(cov, 1.0)
    prec = np.linalg.inv(cov.astype(np.float64)).astype(np.float32)
    cov_t = torch.tensor(cov, device=dev)
    prec_t = torch.tensor(prec, device=dev)
    logprob_fn, _ = logistic_regression(DIM, POINTS, device=dev)
    door_t, door_data = api._generic_fused_binding(logprob_fn, DIM, dev)
    _, _, f_data, _ = neals_funnel_pg_t(FUNNEL_DIM, device=dev)
    _, _, s_data, _ = eight_schools_pg_t(device=dev)
    binds = dict(
        flagship=generic_pg.bind(flagship_t, (), DIM, device=dev),
        cell=generic_pg.bind(cell_potential, (X, y), DIM, layout="std",
                             device=dev),
        mvn=generic_pg.bind(mvn_t, (prec_t,), GEN_MVN_DIM, device=dev),
        door=generic_pg.bind(door_t, door_data, DIM, device=dev),
        # phases 40 and 43: kernels 5-7 run the funnel and eight schools on
        # the functors traced from their hand-written torch functions, as
        # the wrappers bind them (ops/functors.py:generic_bound); phase 40
        # holds them against the potentials differentiated in the trace
        funnel=generic_pg.bind(funnel_pg_t, f_data, FUNNEL_DIM,
                               with_grad=False, device=dev),
        eight_schools=generic_pg.bind(schools_pg_t, s_data, 10,
                                      with_grad=False, device=dev),
        funnel_grad=generic_pg.bind(funnel_potential_t, f_data, FUNNEL_DIM,
                                    device=dev),
        eight_schools_grad=generic_pg.bind(schools_potential_t, s_data, 10,
                                           device=dev),
    )
    return dict(X=X, y=y, flagship_t=flagship_t, cell=cell_potential,
                mvn_t=mvn_t, cov=cov_t, prec=prec_t, logprob_fn=logprob_fn,
                binds=binds)


def geometry_fields(b, chains=CHAINS):
    """A generated functor's geometry (ops/launch_plan.py:generic_geometry):
    its resident operands' bytes, the operands it streams through its tile
    and those it reads from global memory, the tile's rows a chunk and row
    stride, its workspace's place, the factor scratch in which its dense
    nodes keep their matrices (bytes a block, 0: they work in the
    workspace), and the NUTS and HMC blocks' shared memory and blocks an
    SM by shared memory."""
    from aehmc_tpu_torch.ops import launch_plan as lp

    geo = b.geometry
    n = len(b.ir.data_shapes)
    out = dict(resident_bytes=4 * geo.resident_floats,
               streamed=[j for j in range(n) if geo.kind(j) == "streamed"],
               global_operands=[j for j in range(n)
                                if geo.kind(j) == "global"],
               tile_rows=geo.points, row_stride=geo.row_stride,
               tile_bytes=4 * lp.TILE_STAGES * geo.tile_floats,
               workspace_floats=geo.workspace,
               workspace_shared=geo.ws_shared,
               factor_bytes=4 * lp.NUTS_CHAINS * geo.factor_floats)
    for core, k in (("nuts", K), ("hmc", 0)):
        plan = lp.launch_plan(core, b.ir.dim, k, chains, functor="generic",
                              geometry=geo)
        out[f"{core}_smem"] = plan.smem
        out[f"{core}_blocks_per_sm_by_smem"] = \
            2 if lp.two_blocks_fit(plan.smem) else 1
    return out


def geometry_line(name, g, regs=None, spill=None):
    """Phase 1's line of a generated functor's geometry."""
    built = (f"; ptxas {regs} registers, {spill} B spill stores"
             if regs is not None else "")
    return (f"  {name}: resident {g['resident_bytes']} B, streamed "
            f"{g['streamed'] or 'none'} (tile {g['tile_rows']} rows, stride "
            f"{g['row_stride']}, {g['tile_bytes']} B), global "
            f"{g['global_operands'] or 'none'}, workspace "
            f"{g['workspace_floats']} floats "
            f"{'shared' if g['workspace_shared'] else 'global'}, factor "
            f"scratch {g['factor_bytes']} B; smem NUTS "
            f"{g['nuts_smem']} / HMC {g['hmc_smem']} B, blocks an SM "
            f"{g['nuts_blocks_per_sm_by_smem']} / "
            f"{g['hmc_blocks_per_sm_by_smem']}{built}")


def ptxas_most(_build, b):
    """The most registers and spill-store bytes over a built generated
    library's kernels (None before it is built)."""
    regs, spill = [], []
    for line in _build.generated_ptxas_log(b.source).splitlines():
        if "bytes spill stores" in line:
            spill.append(int(line.split("bytes spill stores")[0].split(",")[-1]))
        if "Used" in line and "registers" in line:
            regs.append(int(line.split("Used")[1].split("registers")[0]))
    return max(regs, default=None), max(spill, default=None)


def ptxas_frame(_build, b):
    """The largest stack frame (bytes) over a built generated library's
    functions, None before it is built."""
    frames = [int(line.split("bytes stack frame")[0].split()[-1])
              for line in _build.generated_ptxas_log(b.source).splitlines()
              if "bytes stack frame" in line]
    return max(frames, default=None)


def functor_report(torch, _build, b, plan_dim, chains, k):
    """ptxas's registers, spills and stack frame of the generated kernels,
    nvcc's seconds on their library (None where this process did not build
    it), their blocks per SM at the launch plan's shared memory (two, or
    one where the geometry gives the block a factor scratch two blocks
    cannot hold), and the functor's geometry."""
    from aehmc_tpu_torch.ops.launch_plan import launch_plan, two_blocks_fit

    regs, spill = ptxas_most(_build, b)
    plan = launch_plan("nuts", plan_dim, k, chains, functor="generic",
                       geometry=b.geometry)
    lib = b.library()
    per_sm = {f"{lay}_{kind}": lib.generic_blocks_per_sm(std, s, plan.smem)
              for std, lay in ((0, "t"), (1, "std"))
              for s, kind in ((0, "transition"), (1, "sampling"))}
    want = 2 if two_blocks_fit(plan.smem) else 1
    check(want == 2 or b.geometry.factor_floats > 0,
          f"generic kernels: {plan.smem} B a block without a factor scratch")
    check(min(per_sm.values()) >= want, f"generic kernels: fewer than "
          f"{want} blocks per SM {per_sm}")
    return dict(geometry_fields(b, chains), registers=regs,
                spill_bytes=spill, stack_frame_bytes=ptxas_frame(_build, b),
                build_s=_build.generated_build_seconds(b.source),
                blocks_per_sm=per_sm, smem_bytes=plan.smem)


def mvn_limits(torch, diagnostics, positions, stats, what):
    """The MVN cells' gates: each coordinate's E[x²] within MCSE_Z MCSE of
    1, E[x₀x₁] within MCSE_Z MCSE of ρ, R-hat < 1.01, divergences < 0.01%."""
    x = positions.float().transpose(0, 1)  # (chains, draws, dim)
    sq = x * x
    m2, se2 = mean_mcse(torch, diagnostics, sq)
    cross = (x[:, :, 0] * x[:, :, 1])[:, :, None]
    mc, sec = mean_mcse(torch, diagnostics, cross)
    rhat = float(diagnostics.potential_scale_reduction(
        x, rank_normalized=True).max())
    out = dict(max_var_z=float(((m2 - 1.0).abs() / se2).max()),
               corr01=float(mc[0]), corr01_z=float((mc[0] - GEN_MVN_RHO).abs()
                                                  / sec[0]),
               max_rhat=rhat, divergent_share=float(stats[:, :, 4].mean()),
               accept=float(stats[:, :, 1].mean()))
    check(out["max_var_z"] < MCSE_Z, f"{what}: a variance is "
          f"{out['max_var_z']} MCSE from 1")
    check(out["corr01_z"] < MCSE_Z, f"{what}: the (0, 1) correlation "
          f"{out['corr01']} is {out['corr01_z']} MCSE from {GEN_MVN_RHO}")
    check(rhat < 1.01, f"{what}: max R-hat {rhat}")
    check(out["divergent_share"] < 1e-4,
          f"{what}: divergent share {out['divergent_share']}")
    check(bool(torch.isfinite(x).all()), f"{what}: non-finite draws")
    return out


def ess_total(torch, diagnostics, positions):
    """bench.py's ESS: Σ over dimensions of min(bulk, tail), each capped at
    chains × draws."""
    x = positions.float().transpose(0, 1)
    bulk, tail = bulk_tail_ess(torch, diagnostics, x)
    return float(torch.minimum(bulk, tail).clamp(
        max=x.shape[0] * x.shape[1]).sum())


def generic_phases(torch, ops, diagnostics, gen, data, pg, q0, q_post, record,
                   nuts_mean, card):
    """Phases 34-38; returns the generic fields of kernels 1-4's entries."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch.ops import _build, generic_pg
    from aehmc_tpu_torch.ops import nuts_fused as nf
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
    from aehmc_tpu_torch.ops.philox import MASK32
    from aehmc_tpu_torch.timing import kernel_ms

    dev = q0.device
    b1, b3 = gen["binds"]["flagship"], gen["binds"]["cell"]
    fl_t = gen["flagship_t"]
    X, y = gen["X"], gen["y"]

    # ---- phase 34: the generated functor of the flagship potential
    rep = functor_report(torch, _build, b1, DIM, CHAINS, K)
    q_t = q0.T.contiguous()
    u0, g0 = pg(q_t, *data)
    imm = torch.full((DIM,), GEN_IMM, device=dev)
    philox = dict(seed=GEN_SEED)  # the plain versions draw the same streams
    ops1 = b1.operands((), dev)

    def plain_pg1(q):
        return generic_pg.run_plain(b1.ir, q, ops1)

    def k1():
        return nfs.nuts_transition_cuda(
            q_t, u0, g0, imm, GEN_EPS, (), max_exp=K, potential_and_grad_t=None,
            potential_fn_t=fl_t, **philox)

    def k1_hand():
        return nfs.nuts_transition_cuda(q_t, u0, g0, imm, GEN_EPS, data,
                                        max_exp=K, **philox)

    def p1():
        return nfs.nuts_transition_plain(q_t, u0, g0, imm, GEN_EPS, plain_pg1,
                                         max_exp=K, **philox)

    out_k, out_h, out_p = k1(), k1_hand(), p1()
    torch.cuda.synchronize()
    moved = (out_k[0] != q_t).any(dim=0)
    qm = out_k[0][:, moved]
    u_pl, g_pl = plain_pg1(qm)
    q64 = qm.double().requires_grad_(True)
    X64, y64 = X.double(), y.double()[:, None]
    logits = X64 @ q64
    u64 = (-(y64 * logits - torch.nn.functional.softplus(logits)).sum(0)
           + 0.5 * (q64 * q64).sum(0))
    (g64,) = torch.autograd.grad(u64.sum(), q64)
    gk = out_k[2][:, moved].double()
    grad_rel = float((gk - g64).abs().max() / g64.abs().max())
    grad_rel_plain = float((gk - g_pl.double()).abs().max() / g_pl.abs().max())
    u_rel = float(((out_k[1][0, moved].double() - u64.detach()).abs()
                   / u64.detach().abs()).max())
    check(grad_rel <= GEN_GRAD_RTOL, f"generated gradient {grad_rel:.3g} "
          "relative to float64")
    check(grad_rel_plain <= GEN_GRAD_RTOL, f"generated gradient "
          f"{grad_rel_plain:.3g} relative to the plain back end")
    log(f"phase 34: generated functor of the flagship potential (X, y closed "
        f"over): traced ops {list(b1.ops)}; IR {len(b1.ir.nodes)} nodes, "
        f"workspace {b1.workspace} floats a chain (global: "
        f"{not rep['workspace_shared']}); libraries built in phase 1 "
        f"({record['build_s']:.1f} s with the sources); ptxas "
        f"{rep['registers']} registers, {rep['spill_bytes']} B spill stores "
        f"(most over kernels 1-4); blocks per SM {rep['blocks_per_sm']}; "
        f"gradient at kernel 1's q_out ({int(moved.sum())} chains moved) "
        f"within {grad_rel:.3g} of float64 autograd and {grad_rel_plain:.3g} "
        f"of the plain back end (relative, limit {GEN_GRAD_RTOL}), potential "
        f"{u_rel:.3g}")
    record["phase34"] = dict(ops=list(b1.ops), ir_nodes=len(b1.ir.nodes),
                             grad_rel_err=grad_rel,
                             grad_rel_err_plain=grad_rel_plain,
                             u_rel_err=u_rel, **rep,
                             functors={k: dict(ir_nodes=len(b.ir.nodes),
                                               workspace=b.workspace)
                                       for k, b in gen["binds"].items()})

    # ---- phase 35: kernels 1-4 against plain and against LogisticPGT
    share1, err1, _ = compare(out_k, out_p, "generic kernel 1 vs plain")
    share1h, err1h, _ = compare(out_k, out_h, "generic kernel 1 vs LogisticPGT")
    leaves1 = float(out_k[3][3].sum())
    ms1 = kernel_ms(k1, 3)
    ms1h = kernel_ms(k1_hand, 3)
    plain_ms1 = cuda_ms(torch, p1, 2)
    # the generated functor's products run on the CUDA cores: its bounds
    # are at their 67 TFLOP/s peak
    bound1 = bound(leaves1 * GRAD_FLOP, nbytes(q_t, u0, g0, imm, X, y,
                                               *out_k), PEAK_F32)
    seed = 3535
    n2 = GEN_SAMPLING_DRAWS

    def k2():
        return nfs.nuts_sampling_cuda(
            q_t, u0, g0, imm, GEN_EPS, (), seed, n2, max_exp=K,
            potential_and_grad_t=None, potential_fn_t=fl_t)

    def k2_hand():
        return nfs.nuts_sampling_cuda(q_t, u0, g0, imm, GEN_EPS, data, seed,
                                      n2, max_exp=K)

    def p2():
        return nfs._sampling_plain(
            plain_pg1, q_t, u0, g0, imm, GEN_EPS, seed, n2, max_exp=K,
            divergence_threshold=1000.0, collect_positions=True,
            collect_dtype=torch.float32)

    o2, o2h, o2p = k2(), k2_hand(), p2()
    q, u, g = q_t, u0, g0
    for t in range(n2):
        q, u, g, _ = nfs.nuts_transition_cuda(
            q, u, g, imm, GEN_EPS, (), max_exp=K,
            seed=(seed + t * DRAW_SEED_STRIDE) & MASK32,
            potential_and_grad_t=None, potential_fn_t=fl_t)
    torch.cuda.synchronize()
    check(torch.equal(o2[2], q) and torch.equal(o2[4], g),
          "generic kernel 2 differs from per-draw launches of kernel 1")
    share2, err2, _ = compare((o2[0], None, None, o2[1]),
                              (o2p[0], None, None, o2p[1]),
                              "generic kernel 2 vs plain")
    share2h, err2h, _ = compare((o2[0], None, None, o2[1]),
                                (o2h[0], None, None, o2h[1]),
                                "generic kernel 2 vs LogisticPGT")
    leaves2 = float(o2[1][:, 3].sum())
    ms2 = kernel_ms(k2, 1)
    ms2h = kernel_ms(k2_hand, 1)
    plain_ms2 = cuda_ms(torch, p2, 1, warm=False)
    bound2 = bound(leaves2 * GRAD_FLOP, nbytes(q_t, u0, g0, imm, X, y, *o2),
                   PEAK_F32)
    # kernels 3 and 4: the JAX cell's standard-layout potential
    model = nf._generic_model(gen["cell"], (X, y))
    hand = nf._logistic_model(X, y, 1.0, torch.float32)
    u0s, g0s = model.pot_grad(q0)
    ops3 = b3.operands((X, y), dev)

    def plain_pg3(q):
        uu, gg = generic_pg.run_plain(b3.ir, q.T.contiguous(), ops3)
        return uu.reshape(-1, 1), gg.T

    kw = dict(max_exp=K, divergence_threshold=1000.0)

    def k3():
        return nf._transition(model, q0, u0s, g0s, None, None, None, None,
                              imm, GEN_EPS, seed=GEN_SEED, **kw)

    def k3_hand():
        return nf._transition(hand, q0, u0s, g0s, None, None, None, None,
                              imm, GEN_EPS, seed=GEN_SEED, **kw)

    def p3():
        return nf.nuts_transition_std_plain(
            q0, u0s, g0s, imm, GEN_EPS, plain_pg3, seed=GEN_SEED, **kw)

    def t(out):  # standard layout -> the transposed one compare() reads
        return tuple(None if x is None else x.T for x in out)

    o3, o3h, o3p = k3(), k3_hand(), p3()
    torch.cuda.synchronize()
    share3, err3, _ = compare(t(o3), t(o3p), "generic kernel 3 vs plain")
    share3h, err3h, _ = compare(t(o3), t(o3h), "generic kernel 3 vs LogisticPGT")
    leaves3 = float(o3[3][:, 3].sum())
    ms3, ms3h = kernel_ms(k3, 3), kernel_ms(k3_hand, 3)
    plain_ms3 = cuda_ms(torch, p3, 2)
    bound3 = bound(leaves3 * GRAD_FLOP, nbytes(q0, u0s, g0s, imm, X, y,
                                               *o3), PEAK_F32)

    def k4(m=model):
        return nf._fused_sampling_call(m, q0, u0s, g0s, imm, GEN_EPS, seed, n2,
                                       max_num_expansions=K)

    def p4():
        return nf._sampling_plain(
            nf._Model(plain_pg3, (X, y), None), q0, u0s, g0s, imm, GEN_EPS,
            seed, n2, max_exp=K, divergence_threshold=1000.0,
            collect_positions=True)

    o4, o4h, o4p = k4(), k4(hand), p4()
    torch.cuda.synchronize()

    def t4(out):
        return (out[0].transpose(1, 2), None, None, out[1].transpose(1, 2))

    share4, err4, _ = compare(t4(o4), t4(o4p), "generic kernel 4 vs plain")
    share4h, err4h, _ = compare(t4(o4), t4(o4h),
                                "generic kernel 4 vs LogisticPGT")
    leaves4 = float(o4[1][:, :, 3].sum())
    ms4, ms4h = kernel_ms(k4, 1), kernel_ms(lambda: k4(hand), 1)
    plain_ms4 = cuda_ms(torch, p4, 1, warm=False)
    bound4 = bound(leaves4 * GRAD_FLOP, nbytes(q0, u0s, g0s, imm, X, y, *o4),
                   PEAK_F32)
    log(f"phase 35: generated kernels 1-4 at {CHAINS}x{DIM}, ε {GEN_EPS}, "
        f"M⁻¹ {GEN_IMM}, K {K}, Philox ({n2} draws for kernels 2 and 4): "
        f"decisions "
        f"equal vs plain {share1:.4%} / {share2:.4%} / {share3:.4%} / "
        f"{share4:.4%} (max |q| err {err1:.3g} / {err2:.3g} / {err3:.3g} / "
        f"{err4:.3g}), vs LogisticPGT {share1h:.4%} / {share2h:.4%} / "
        f"{share3h:.4%} / {share4h:.4%} ({err1h:.3g} / {err2h:.3g} / "
        f"{err3h:.3g} / {err4h:.3g}); kernel 2 == {n2} launches of kernel 1 "
        f"bit for bit; ms generic / hand-written / plain / bound: kernel 1 "
        f"{ms1:.3f} / {ms1h:.3f} / {plain_ms1:.3f} / {bound1[0]:.3f}, kernel "
        f"2 per {n2} draws {ms2:.2f} / {ms2h:.2f} / {plain_ms2:.2f} / "
        f"{bound2[0]:.3f}, kernel 3 {ms3:.3f} / {ms3h:.3f} / {plain_ms3:.3f} "
        f"/ {bound3[0]:.3f}, kernel 4 per {n2} draws {ms4:.2f} / {ms4h:.2f} "
        f"/ {plain_ms4:.2f} / {bound4[0]:.3f} [{card}]")
    record["phase35"] = dict(
        share=[share1, share2, share3, share4],
        max_abs_err=[err1, err2, err3, err4],
        share_vs_hand=[share1h, share2h, share3h, share4h],
        max_abs_err_vs_hand=[err1h, err2h, err3h, err4h],
        ms=[ms1, ms2, ms3, ms4], hand_ms=[ms1h, ms2h, ms3h, ms4h],
        plain_ms=[plain_ms1, plain_ms2, plain_ms3, plain_ms4],
        bound_ms=[bound1[0], bound2[0], bound3[0], bound4[0]],
        bound_ms_cuda_cores=[bound1[2], bound2[2], bound3[2], bound4[2]],
        leaves=[leaves1, leaves2, leaves3, leaves4], draws=n2)
    del o2, o2h, o2p, o4, o4h, o4p

    # ---- phase 36: nuts_fused_generic_10k
    def cell_run(potential, run_data, loop, seed_):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, pos, stats = ops.sample_fused(
            torch.Generator().manual_seed(seed_), potential, run_data,
            q_post, DRAWS, GEN_EPS, imm, max_num_expansions=K,
            internal_prng=True, loop_in_kernel=loop)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return pos, stats, wall, dict(ops.LAUNCHES)

    pos_h, st_h, wall_h, _ = cell_run(nf.logistic_potential,
                                      hand.data, True, 36)
    witness = mean_mcse(torch, diagnostics, pos_h.transpose(0, 1))
    cells = {}
    for name, loop, kern, n in (("per_draw", False,
                                  "nuts_transition_std_generic", DRAWS),
                                 ("whole_run", True,
                                  "nuts_sampling_std_generic", 1)):
        pos, stats, wall, launches = cell_run(gen["cell"], (X, y), loop, 36)
        check(launches[kern] == n and sum(launches.values()) == n,
              f"nuts_fused_generic_10k ({name}) launches {launches}")
        limits = nuts_limits(torch, diagnostics, pos, stats[:, :, 1],
                             stats[:, :, 4], GEN_EPS, witness,
                             f"nuts_fused_generic_10k ({name})")
        evals = float(stats[:, :, 3].sum())
        cells[name] = dict(wall_s=wall, launches=launches,
                           grad_evals_per_s=evals / wall,
                           ess_per_s=ess_total(torch, diagnostics, pos) / wall,
                           **limits)
        del pos
    hand_evals = float(st_h[:, :, 3].sum())
    cells["hand_written"] = dict(
        wall_s=wall_h, grad_evals_per_s=hand_evals / wall_h,
        ess_per_s=ess_total(torch, diagnostics, pos_h) / wall_h)
    del pos_h
    log(f"phase 36: nuts_fused_generic_10k, {CHAINS}x{DIM}, {DRAWS} draws "
        f"from phase 5's final state: kernel 3 a draw "
        f"{cells['per_draw']['wall_s']:.3f} s, "
        f"{cells['per_draw']['grad_evals_per_s'] / 1e6:.2f}M grad-evals/s, "
        f"{cells['per_draw']['ess_per_s'] / 1e6:.3f}M ESS/s; kernel 4 once "
        f"{cells['whole_run']['wall_s']:.3f} s, "
        f"{cells['whole_run']['grad_evals_per_s'] / 1e6:.2f}M grad-evals/s, "
        f"{cells['whole_run']['ess_per_s'] / 1e6:.3f}M ESS/s; accept "
        f"{cells['per_draw']['accept']:.4f} / {cells['whole_run']['accept']:.4f}, "
        f"divergent {cells['per_draw']['divergent_share']:.2e} / "
        f"{cells['whole_run']['divergent_share']:.2e}, max R-hat "
        f"{cells['per_draw']['max_rhat']:.4f} / "
        f"{cells['whole_run']['max_rhat']:.4f}, means within "
        f"{cells['per_draw']['max_z_vs_nuts']:.2f} / "
        f"{cells['whole_run']['max_z_vs_nuts']:.2f} MCSE of the hand-written "
        f"route's (kernel 4 on LogisticPGT: {wall_h:.3f} s, "
        f"{cells['hand_written']['grad_evals_per_s'] / 1e6:.2f}M "
        f"grad-evals/s) [{card}]")
    record["phase36"] = cells

    # ---- phase 37: the MVN cells, dense M⁻¹
    mvn = {}
    for chains in GEN_MVN_CHAINS:
        qm0 = torch.tensor(np.random.default_rng(37).standard_normal(
            (chains, GEN_MVN_DIM)), dtype=torch.float32, device=dev)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, pos, stats = ops.sample_fused_small(
            torch.Generator().manual_seed(37), gen["mvn_t"], (gen["prec"],),
            qm0, GEN_MVN_DRAWS, GEN_MVN_EPS, gen["cov"], max_num_expansions=GEN_MVN_K,
            loop_in_kernel=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(ops.LAUNCHES)
        check(launches["nuts_sampling_generic"] == 1
              and sum(launches.values()) == 1, f"mvn25_fused launches "
              f"{launches}")
        mvn[f"fused_{chains}"] = dict(
            wall_s=wall, launches=launches,
            ess_per_s=ess_total(torch, diagnostics, pos) / wall,
            grad_evals_per_s=float(stats[:, :, 3].sum()) / wall,
            **mvn_limits(torch, diagnostics, pos, stats,
                         f"mvn25_fused ({chains} chains)"))
    a = GEN_MVN_ADAPT
    qm0 = torch.tensor(np.random.default_rng(38).standard_normal(
        (a["chains"], GEN_MVN_DIM)), dtype=torch.float32, device=dev)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, pos, stats, eps_a, imm_a = ops.sample_fused_adaptive(
        torch.Generator().manual_seed(39), None, (gen["prec"],), qm0,
        a["draws"], a["warmup"], potential_fn_t=gen["mvn_t"],
        max_num_expansions=a["k"], is_mass_matrix_full=True,
        initial_step_size=a["eps0"], loop_in_kernel=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["nuts_transition_generic"] == a["warmup"]
          and launches["nuts_sampling_generic"] == 1,
          f"mvn25_dense_fused_adaptive launches {launches}")
    off = ~torch.eye(GEN_MVN_DIM, dtype=torch.bool, device=dev)
    ratio = float(imm_a[off].mean() / torch.diagonal(imm_a).mean())
    check(abs(ratio - GEN_MVN_RHO) <= GEN_MVN_RATIO_TOL, f"tuned M⁻¹ off-diagonal/"
          f"diagonal {ratio}")
    mvn["dense_adaptive"] = dict(
        wall_s=wall, launches=launches, step_size=float(eps_a),
        offdiag_ratio=ratio,
        ess_per_s=ess_total(torch, diagnostics, pos) / wall,
        **mvn_limits(torch, diagnostics, pos, stats,
                     "mvn25_dense_fused_adaptive"))
    log("phase 37: " + "; ".join(
        f"{k}: {v['wall_s']:.3f} s, {v['ess_per_s'] / 1e6:.3f}M ESS/s, "
        f"accept {v['accept']:.4f}, E[x²] within {v['max_var_z']:.2f} MCSE "
        f"of 1, corr(0, 1) {v['corr01']:.4f} ({v['corr01_z']:.2f} MCSE), "
        f"max R-hat {v['max_rhat']:.4f}, divergent "
        f"{v['divergent_share']:.2e}" for k, v in mvn.items())
        + f"; tuned ε {float(eps_a):.4f}, M⁻¹ off-diagonal/diagonal "
        f"{ratio:.4f} [{card}]")
    record["phase37"] = mvn
    del pos

    # ---- phase 38: the front door on a bare logprob_fn
    runs = []
    for _ in range(2):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(2038), gen["logprob_fn"], q0, DRAWS,
            WARMUP, algorithm="nuts", path="fused", max_num_expansions=K,
            initial_step_size=0.1, collect_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        runs.append((res, time.perf_counter() - t0, dict(ops.LAUNCHES)))
    (res, wall38, launches38), (res2, _, _) = runs
    check(launches38["nuts_transition_generic"] == WARMUP
          and launches38["nuts_sampling_generic"] == 1
          and sum(launches38.values()) == WARMUP + 1,
          f"front door on a bare logprob_fn: launches {launches38}")
    check(torch.equal(res.positions, res2.positions)
          and torch.equal(torch.as_tensor(res.step_size),
                          torch.as_tensor(res2.step_size)),
          "front door on a bare logprob_fn: two runs with one seed differ")
    diag = res.diagnostics
    door = nuts_limits(torch, diagnostics, res.positions,
                       diag.acceptance_probability, diag.is_diverging,
                       res.step_size, nuts_mean,
                       "front door on a bare logprob_fn")
    log(f"phase 38: front door, bare logprob_fn, {CHAINS}x{DIM}, {WARMUP} "
        f"warmup + {DRAWS} draws in {wall38:.2f} s; launches {launches38}; "
        f"accept {door['accept']:.4f}, divergent {door['divergent_share']:.2e}, "
        f"ε {float(res.step_size):.4f}, max R-hat {door['max_rhat']:.4f}, "
        f"means within {door['max_z_vs_nuts']:.2f} MCSE of phase 5's; twice "
        f"with one seed, equal bit for bit [{card}]")
    record["phase38"] = dict(wall_s=wall38, launches=launches38,
                             step_size=float(res.step_size), **door)
    del res, res2, runs
    cell_launches = cells["per_draw"]["launches"]
    return [
        dict(generic_launches=launches38["nuts_transition_generic"],
             generic_ms=ms1, generic_plain_ms=plain_ms1,
             generic_bound_ms=bound1[0], generic_bound_by=bound1[1],
             generic_max_abs_err=err1, generic_vs_handwritten_max_abs_err=err1h,
             generic_handwritten_ms=ms1h),
        dict(generic_launches=launches38["nuts_sampling_generic"],
             generic_draws=n2, generic_ms=ms2, generic_plain_ms=plain_ms2,
             generic_bound_ms=bound2[0], generic_bound_by=bound2[1],
             generic_max_abs_err=err2, generic_vs_handwritten_max_abs_err=err2h,
             generic_handwritten_ms=ms2h),
        dict(generic_launches=cell_launches["nuts_transition_std_generic"],
             generic_ms=ms3, generic_plain_ms=plain_ms3,
             generic_bound_ms=bound3[0], generic_bound_by=bound3[1],
             generic_max_abs_err=err3, generic_vs_handwritten_max_abs_err=err3h,
             generic_handwritten_ms=ms3h),
        dict(generic_launches=cells["whole_run"]["launches"][
                 "nuts_sampling_std_generic"],
             generic_draws=n2, generic_ms=ms4, generic_plain_ms=plain_ms4,
             generic_bound_ms=bound4[0], generic_bound_by=bound4[1],
             generic_max_abs_err=err4, generic_vs_handwritten_max_abs_err=err4h,
             generic_handwritten_ms=ms4h),
    ]


# phases 39-43: the HMC core (kernels 5-7) on the generated functor and on
# the functors with no X tile, and the MALA, GHMC, ChEES and MEADS front doors
# on a bare logprob_fn
HMC_GEN_SEED = 3939                  # phase 39: kernels 5-7's Philox key
HMC_MVN_CHAINS, HMC_MVN_EPS = 2048, (0.2, 0.4)  # phase 39: kernel 7, dense
FUNNEL_HMC_EPS, SCHOOLS_HMC_EPS = 0.05, HIER_EPS  # phase 40's step sizes
HMC_TIMED_REPS = 10                  # phases 39-40: launches a CUDA graph
# phase 43: the funnel's and eight schools' MALA and GHMC runs, and the
# funnel's ChEES run, held to finite draws and an acceptance above this
# (set before the run: the CPU front-door tests' limit); eight schools'
# ChEES and MEADS to phase 19's NUTS means
HIER_DOOR_ACCEPT_MIN = 0.3
# the means of the hand-written routes' first runs (front_door_checks: phases
# 11, 12, 14, 24) and of phase 19's eight-schools NUTS run, the witnesses
# of phases 41-43
WITNESS_MEANS = {}


def ptxas_entries(log):
    """[(source, entry, registers, spill-store bytes)] of ptxas's -v output
    (sections "== <source>")."""
    out, source, entry, spill = [], None, None, 0
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif "Compiling entry function" in line:
            entry, spill = line.split("'")[1], 0
        elif "bytes spill stores" in line:
            spill = int(line.split("bytes stack frame,")[1].split()[0])
        elif "Used" in line and "registers" in line and entry:
            out.append((source, entry,
                        int(line.split("Used")[1].split()[0]), spill))
            entry = None
    return out


def hmc_kernel_of(entry):
    """5, 6 or 7: the HMC core's kernel an entry function instantiates (the
    (dim, C) layout is GHMC's, the standard one ChEES's), else None."""
    if "3hmc" not in entry:
        return None
    if "segment_kernel" in entry:
        return 6
    std = re.search(r"transition_kernelI\w*?PG\w*?Lb([01])E", entry)
    return None if std is None else (7 if std.group(1) == "1" else 5)


def hmc_functor_report(torch, _build, gen):
    """Phase 1's registers, spills and blocks per SM of kernels 5-7 on the
    generated functors of the flagship, the funnel and eight schools (the
    most over each kernel's instantiations: kernel 7 diagonal and dense)."""
    out = {}
    for name, dim, chains in (("flagship", DIM, CHAINS),
                              ("funnel", FUNNEL_DIM, FUNNEL_CHAINS),
                              ("eight_schools", 10, SCHOOLS_CHAINS)):
        b = gen["binds"][name]
        out[name] = dict(hmc_report(torch, _build, b, dim, chains,
                                    f"{name}'s generated functor"),
                         workspace_floats=b.workspace)
    return out


def hmc_report(torch, _build, b, dim, chains, what):
    """Registers and spills of kernels 5-7 on a generated functor (the most
    over each kernel's instantiations) and their blocks per SM (two, or one
    where a factor scratch takes the room of the second)."""
    from aehmc_tpu_torch.ops.launch_plan import launch_plan, two_blocks_fit

    per = {}
    for _, entry, regs, spill in ptxas_entries(
            _build.generated_ptxas_log(b.source)):
        k = hmc_kernel_of(entry)
        if k and "9GenericPG" in entry:
            r, sp = per.get(k, (0, 0))
            per[k] = (max(r, regs), max(sp, spill))
    check(sorted(per) == [5, 6, 7], f"ptxas reports kernels {sorted(per)} "
          f"on {what}")
    plan = launch_plan("hmc", dim, 0, chains, functor="generic",
                       geometry=b.geometry)
    lib = b.library()
    per_sm = {f"{k}{'_dense' if d else ''}": lib.hmc_generic_blocks_per_sm(
        k, d, plan.smem) for k, d in ((5, 0), (6, 0), (7, 0), (7, 1))}
    want = 2 if two_blocks_fit(plan.smem) else 1
    check(want == 2 or b.geometry.factor_floats > 0,
          f"kernels 5-7 on {what}: {plan.smem} B a block without a factor "
          "scratch")
    check(min(per_sm.values()) >= want, f"kernels 5-7 on {what}: fewer "
          f"than {want} blocks per SM {per_sm}")
    return dict(registers={k: v[0] for k, v in sorted(per.items())},
                spill_bytes={k: v[1] for k, v in sorted(per.items())},
                smem_bytes=plan.smem, blocks_per_sm=per_sm)


def hmc_hold(torch, q_in, kern, ref, what, atol=Q_ATOL):
    """Kernel 5's outputs ``(q, u, g, p, stats)`` against another version's
    (ghmc_compare on one draw)."""
    return ghmc_compare(torch, q_in, (kern[0][None], kern[4][None]),
                        (ref[0][None], ref[4][None]), what, atol)


def segment_by_draws(torch, gf, state, args, data, pot_kw, plain_pg, seed,
                     draws, what):
    """Kernel 6 over ``draws`` draws from ``state`` (Philox ``seed``) equal
    to as many launches of kernel 5 bit for bit, and each of those held
    against the plain transition from the kernel's own state (a last-bit
    difference carried over draws is chaos, not error).  Returns (least
    share, largest |Δq|, chain-cases that differ)."""
    from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
    from aehmc_tpu_torch.ops.philox import MASK32

    pos, stats, *final = gf.ghmc_segment_cuda(*state, *args, data, draws,
                                              seed=seed, **pot_kw)
    st, out = state, []
    for t in range(draws):
        key = (seed + t * DRAW_SEED_STRIDE) & MASK32
        plain = gf.ghmc_transition_plain(*st, *args, plain_pg, seed=key)
        kern = gf.ghmc_transition_cuda(*st, *args, data, seed=key, **pot_kw)
        check(torch.equal(kern[4], stats[t]) and torch.equal(kern[0], pos[t]),
              f"{what}: kernel 6 draw {t} differs from kernel 5")
        out.append(hmc_hold(torch, st[0], kern, plain,
                            f"{what}: draw {t} vs plain"))
        st = kern[:4]
    check(all(torch.equal(a, b) for a, b in zip(final, st)),
          f"{what}: kernel 6's final state differs from kernel 5's")
    del pos
    return (min(s for s, _, _ in out), max(e for _, e, _ in out),
            sum(d for _, _, d in out))


def worst(cases):
    """(least share, largest error, chain-cases that differ) over cases."""
    return (min(c[0] for c in cases), max(c[1] for c in cases),
            sum(c[2] for c in cases))


def hmc_generic_phase(torch, gen, data, pg, q0, record, card):
    """Phase 39: kernels 5, 6 and 7 on the flagship's generated functor at
    phases 8, 9 and 13's state against their plain versions (the same plain
    core with generic_pg.run_plain) and against LogisticPGT; kernel 6 equal
    to 32 launches of kernel 5 bit for bit; kernel 7 at α 0 against kernel
    5; kernel 7 with a dense M⁻¹ on phase 37's mvn25 functor; each timed
    beside LogisticPGT in the same process."""
    from aehmc_tpu_torch.ops import chees_fused as cf
    from aehmc_tpu_torch.ops import generic_pg
    from aehmc_tpu_torch.ops import ghmc_fused as gf
    from aehmc_tpu_torch.timing import kernel_ms

    dev = q0.device
    rng = np.random.default_rng(39)
    b = gen["binds"]["flagship"]
    ops1 = b.operands((), dev)
    X, y = gen["X"], gen["y"]

    def plain_pg(x):
        return generic_pg.run_plain(b.ir, x, ops1)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    gkw = dict(potential_and_grad_t=None, potential_fn_t=gen["flagship_t"])
    q_t = q0.T.contiguous()
    u0, g0 = pg(q_t, *data)
    p0 = f32(np.sqrt(1.0 / IMM) * rng.standard_normal((DIM, CHAINS)))
    im = torch.full((DIM,), IMM, device=dev)
    state = (q_t, u0, g0, p0)
    ext = dict(noise=f32(np.sqrt(1.0 / IMM)
                         * rng.standard_normal((DIM, CHAINS))),
               u_accept=f32(rng.uniform(size=(1, CHAINS))))

    # kernel 5 at α 0.9: external and Philox randomness
    vs_plain, vs_hand = [], []
    for rand in (ext, dict(seed=HMC_GEN_SEED)):
        how = "Philox" if "seed" in rand else "external"
        args = (EPS, GHMC_ALPHA, im)
        kern = gf.ghmc_transition_cuda(*state, *args, (), **gkw, **rand)
        plain = gf.ghmc_transition_plain(*state, *args, plain_pg, **rand)
        hand = gf.ghmc_transition_cuda(*state, *args, data, **rand)
        torch.cuda.synchronize()
        vs_plain.append(hmc_hold(torch, q_t, kern, plain,
                                 f"generic kernel 5 vs plain ({how})"))
        vs_hand.append(hmc_hold(torch, q_t, kern, hand,
                                f"generic kernel 5 vs LogisticPGT ({how})"))
    r5, r5h = worst(vs_plain), worst(vs_hand)

    # kernel 6: 32 draws == 32 launches of kernel 5, each against plain;
    # the whole segment against LogisticPGT's
    seed6 = HMC_GEN_SEED + 1
    r6 = segment_by_draws(torch, gf, state, (EPS, GHMC_ALPHA, im), (), gkw,
                          plain_pg, seed6, SEGMENT, "generic kernel 6")
    seg = gf.ghmc_segment_cuda(*state, EPS, GHMC_ALPHA, im, (), SEGMENT,
                               seed=seed6, **gkw)
    seg_h = gf.ghmc_segment_cuda(*state, EPS, GHMC_ALPHA, im, data, SEGMENT,
                                 seed=seed6)
    r6h = ghmc_compare(torch, q_t, seg[:2], seg_h[:2],
                       f"generic kernel 6 vs LogisticPGT over {SEGMENT} "
                       "draws")
    del seg, seg_h

    # kernel 7, L 10: against plain and LogisticPGT, and at α 0 against
    # kernel 5
    cstate = (q0, u0.reshape(-1), g0.T.contiguous())
    steps = torch.full((), LEAPFROG_STEPS, dtype=torch.int32, device=dev)
    cext = dict(momentum=ext["noise"].T.contiguous(),
                u_accept=ext["u_accept"].reshape(-1))
    vs_plain, vs_hand = [], []
    for rand in (cext, dict(seed=HMC_GEN_SEED + 2)):
        how = "Philox" if "seed" in rand else "external"
        kern = cf.chees_transition_cuda(*cstate, im, EPS, steps, (), **gkw,
                                        **rand)
        plain = cf.chees_transition_plain(*cstate, im, EPS, LEAPFROG_STEPS,
                                          plain_pg, **rand)
        hand = cf.chees_transition_cuda(*cstate, im, EPS, steps, data,
                                        **rand)
        torch.cuda.synchronize()
        vs_plain.append(chees_compare(torch, q0, kern, plain,
                                      f"generic kernel 7 vs plain ({how})"))
        vs_hand.append(chees_compare(
            torch, q0, kern, hand, f"generic kernel 7 vs LogisticPGT ({how})"))
    r7, r7h = worst(vs_plain), worst(vs_hand)
    k7 = cf.chees_transition_cuda(*cstate, im, EPS, steps, (), seed=99, **gkw)
    k5 = gf.ghmc_transition_cuda(q_t, u0, g0, torch.zeros_like(g0), EPS, 0.0,
                                 im, (), num_steps=LEAPFROG_STEPS, seed=99,
                                 **gkw)
    torch.cuda.synchronize()
    same75 = float((((k7[0] != q0).any(dim=1) == (k5[0].T != q0).any(dim=1))
                    & (k7[3][:, 4] == k5[4][4])).float().mean())
    check(same75 >= K7_SHARE, f"generic kernel 7 vs kernel 5 at α 0: "
          f"decisions agree on {same75:.4f}")
    bitwise75 = bool(torch.equal(k7[0], k5[0].T))
    del k7, k5

    # kernel 7 with a dense M⁻¹ (the covariance) on phase 37's mvn25 functor
    bm = gen["binds"]["mvn"]
    opsm = bm.operands((gen["prec"],), dev)

    def plain_mvn(x):
        return generic_pg.run_plain(bm.ir, x, opsm)

    n = HMC_MVN_CHAINS
    qm = f32(rng.standard_normal((n, GEN_MVN_DIM)))
    um, gm = plain_mvn(qm.T.contiguous())
    mstate = (qm, um.reshape(-1), gm.T.contiguous())
    eps_m = f32(rng.uniform(*HMC_MVN_EPS, size=n))
    mkw = dict(potential_and_grad_t=None, potential_fn_t=gen["mvn_t"])
    mvn_cases = []
    for rand in (dict(momentum=f32(rng.standard_normal((n, GEN_MVN_DIM))),
                      u_accept=f32(rng.uniform(size=n))),
                 dict(seed=HMC_GEN_SEED + 3)):
        kern = cf.chees_transition_cuda(*mstate, gen["cov"], eps_m, steps,
                                        (gen["prec"],), **mkw, **rand)
        plain = cf.chees_transition_plain(*mstate, gen["cov"], eps_m,
                                          LEAPFROG_STEPS, plain_mvn, **rand)
        torch.cuda.synchronize()
        mvn_cases.append(chees_compare(
            torch, qm, kern, plain, "generic kernel 7, dense M⁻¹, mvn25 "
            f"({'Philox' if 'seed' in rand else 'external'})"))
    r7m = worst(mvn_cases)

    # times: the main paths' cases (MALA's α 0 and Philox), each beside
    # LogisticPGT's, from a CUDA graph of launches
    def k5g(d=(), kw=gkw):
        return gf.ghmc_transition_cuda(*state, EPS, 0.0, im, d, seed=7, **kw)

    def k6g(d=(), kw=gkw):
        return gf.ghmc_segment_cuda(*state, EPS, 0.0, im, d, SEGMENT, seed=7,
                                    **kw)

    def k7g(d=(), kw=gkw):
        return cf.chees_transition_cuda(*cstate, im, EPS, steps, d, seed=7,
                                        **kw)

    def k7m():
        return cf.chees_transition_cuda(*mstate, gen["cov"], eps_m, steps,
                                        (gen["prec"],), seed=7, **mkw)

    hand = dict(d=data, kw={})
    t = dict(
        ms5=kernel_ms(k5g, HMC_TIMED_REPS),
        hand_ms5=kernel_ms(lambda: k5g(**hand), HMC_TIMED_REPS),
        plain_ms5=cuda_ms(torch, lambda: gf.ghmc_transition_plain(
            *state, EPS, 0.0, im, plain_pg, seed=7), 3),
        ms6=kernel_ms(k6g, 1), hand_ms6=kernel_ms(lambda: k6g(**hand), 1),
        plain_ms6=cuda_ms(torch, lambda: gf.ghmc_segment_plain(
            *state, EPS, 0.0, im, plain_pg, SEGMENT, seed=7), 1),
        ms7=kernel_ms(k7g, 3), hand_ms7=kernel_ms(lambda: k7g(**hand), 3),
        plain_ms7=cuda_ms(torch, lambda: cf.chees_transition_plain(
            *cstate, im, EPS, LEAPFROG_STEPS, plain_pg, seed=7), 1),
        ms7_mvn=kernel_ms(k7m, HMC_TIMED_REPS),
        plain_ms7_mvn=cuda_ms(torch, lambda: cf.chees_transition_plain(
            *mstate, gen["cov"], eps_m, LEAPFROG_STEPS, plain_mvn, seed=7),
            3))
    rows = 2 * CHAINS * 4  # the ε and α rows
    # the generated functor's bounds at the CUDA-core peak (phase 35's)
    b5 = bound(CHAINS * GRAD_FLOP, nbytes(*state, im, X, y, *k5g()) + rows,
               PEAK_F32)
    b6 = bound(SEGMENT * CHAINS * GRAD_FLOP,
               nbytes(*state, im, X, y, *k6g()) + rows, PEAK_F32)
    b7 = bound(LEAPFROG_STEPS * CHAINS * GRAD_FLOP,
               nbytes(*cstate, im, X, y, *k7g()) + 8, PEAK_F32)
    d = GEN_MVN_DIM  # a step: prec·q and M⁻¹p, 2d² each; the draw, 3 more
    b7m = bound(n * (LEAPFROG_STEPS * 4 + 6) * d * d,
                nbytes(*mstate, gen["cov"], gen["prec"], eps_m, *k7m()),
                PEAK_F32)
    log(f"phase 39: kernels 5-7 on the flagship's generated functor at "
        f"{CHAINS}x{DIM}, ε {EPS}, M⁻¹ {IMM}: kernel 5 (α {GHMC_ALPHA}, "
        f"external and Philox) vs plain {r5[0]:.4%} of decisions equal "
        f"({r5[2]} differ), max |q| err {r5[1]:.3g}, vs LogisticPGT "
        f"{r5h[0]:.4%} ({r5h[1]:.3g}); kernel 6 == {SEGMENT} launches of "
        f"kernel 5 bit for bit, each vs plain from its own state >= "
        f"{r6[0]:.4%} ({r6[1]:.3g}), the segment vs LogisticPGT's "
        f"{r6h[0]:.4%} ({r6h[1]:.3g}); kernel 7 (L {LEAPFROG_STEPS}) vs plain "
        f"{r7[0]:.4%} ({r7[1]:.3g}), vs LogisticPGT {r7h[0]:.4%} "
        f"({r7h[1]:.3g}), vs kernel 5 at α 0 {same75:.4%} (positions bit "
        f"for bit: {bitwise75}); kernel 7 with a dense M⁻¹ on the mvn25 "
        f"functor ({n} chains) vs plain {r7m[0]:.4%} ({r7m[1]:.3g}); ms "
        f"generic / LogisticPGT / plain / bound: kernel 5 {t['ms5']:.4f} / "
        f"{t['hand_ms5']:.4f} / {t['plain_ms5']:.3f} / {b5[0]:.4f}, kernel 6 "
        f"per {SEGMENT} draws {t['ms6']:.3f} / {t['hand_ms6']:.3f} / "
        f"{t['plain_ms6']:.2f} / {b6[0]:.3f}, kernel 7 {t['ms7']:.3f} / "
        f"{t['hand_ms7']:.3f} / {t['plain_ms7']:.2f} / {b7[0]:.3f}; mvn25 "
        f"kernel 7 {t['ms7_mvn']:.4f} ms (plain {t['plain_ms7_mvn']:.3f}, "
        f"bound {b7m[0]:.5f}) [{card}]")
    record["phase39"] = dict(
        share=[r5[0], r6[0], r7[0]], max_abs_err=[r5[1], r6[1], r7[1]],
        share_vs_hand=[r5h[0], r6h[0], r7h[0]],
        max_abs_err_vs_hand=[r5h[1], r6h[1], r7h[1]],
        share_7_vs_5=same75, bitwise_7_vs_5=bitwise75,
        mvn_share=r7m[0], mvn_max_abs_err=r7m[1], **t,
        bound_ms=[b5[0], b6[0], b7[0]], bound_ms_mvn=b7m[0],
        bound_ms_cuda_cores=[b5[2], b6[2], b7[2]])
    return dict(errs=(r5[1], r6[1], max(r7[1], r7m[1])),
                errs_hand=(r5h[1], r6h[1], r7h[1]),
                ms=(t["ms5"], t["ms6"], t["ms7"]),
                hand_ms=(t["hand_ms5"], t["hand_ms6"], t["hand_ms7"]),
                plain_ms=(t["plain_ms5"], t["plain_ms6"], t["plain_ms7"]),
                bounds=(b5, b6, b7))


def hier_hmc_flop(name, dim, steps, chains):
    """FLOP of one HMC transition of ``steps`` leapfrog steps on the funnel
    or eight schools: each step the gradient and 6 a dimension, and 8 a
    dimension for the refresh and the two kinetic energies."""
    return chains * (steps * (HIER_PG_FLOP[name](dim) + 6 * dim) + 8 * dim)


def hmc_hier_phase(torch, gen, record, card):
    """Phase 40: kernels 5-7 on the funnel (8,192 chains, dim 10, from N(0,
    1), ε 0.05) and eight schools (2,048 chains, phase 19's data, ε 0.2)
    as the wrappers run them, on the functor traced from the model's
    hand-written torch function (funnel_pg_t, schools_pg_t), each held
    against its plain version (that torch function) and against the
    functor generated from the potential differentiated in the trace (and
    that one against its own plain version); kernel 6 equal to its kernel-5
    launches bit for bit; each timed beside the other functor's."""
    from aehmc_tpu_torch.models import eight_schools_pg_t, neals_funnel_pg_t
    from aehmc_tpu_torch.ops import chees_fused as cf
    from aehmc_tpu_torch.ops import generic_pg
    from aehmc_tpu_torch.ops import ghmc_fused as gf
    from aehmc_tpu_torch.timing import kernel_ms

    out = {}
    for name, model, chains, eps, seed in (
            ("funnel", neals_funnel_pg_t(FUNNEL_DIM, device=DEVICE),
             FUNNEL_CHAINS, FUNNEL_HMC_EPS, 4000),
            ("eight_schools", eight_schools_pg_t(device=DEVICE),
             SCHOOLS_CHAINS, SCHOOLS_HMC_EPS, 4010)):
        pot, pg, data, ex = model
        dim = ex.shape[0]
        rng = np.random.default_rng(seed)
        b = gen["binds"][name + "_grad"]
        opsb = b.operands(data, torch.device(DEVICE))

        def gen_plain(x, b=b, opsb=opsb):
            return generic_pg.run_plain(b.ir, x, opsb)

        def hand_plain(x, pg=pg, data=data):
            return pg(x, *data)

        def f32(a):
            return torch.tensor(a, dtype=torch.float32, device=DEVICE)

        hkw = dict(potential_and_grad_t=pg)
        gkw = dict(potential_and_grad_t=None, potential_fn_t=pot)
        q_t = hier_start(torch, dim, chains, seed)
        u0, g0 = pg(q_t, *data)
        state = (q_t, u0, g0, f32(rng.standard_normal((dim, chains))))
        im = torch.ones(dim, device=DEVICE)
        ext = dict(noise=f32(rng.standard_normal((dim, chains))),
                   u_accept=f32(rng.uniform(size=(1, chains))))
        args = (eps, GHMC_ALPHA, im)
        c5, c5g, c5gp = [], [], []
        for rand in (ext, dict(seed=seed + 1)):
            how = f"{name}, {'Philox' if 'seed' in rand else 'external'}"
            kern = gf.ghmc_transition_cuda(*state, *args, data, **hkw, **rand)
            kgen = gf.ghmc_transition_cuda(*state, *args, data, **gkw, **rand)
            plain = gf.ghmc_transition_plain(*state, *args, hand_plain,
                                             **rand)
            gplain = gf.ghmc_transition_plain(*state, *args, gen_plain,
                                              **rand)
            torch.cuda.synchronize()
            c5.append(hmc_hold(torch, q_t, kern, plain,
                               f"kernel 5 ({how}) vs plain"))
            c5g.append(hmc_hold(torch, q_t, kern, kgen, f"kernel 5 ({how}) "
                                "vs the potential differentiated in the "
                                "trace"))
            c5gp.append(hmc_hold(torch, q_t, kgen, gplain, f"kernel 5 ({how}),"
                                 " the potential differentiated in the trace "
                                 "vs its plain"))
        r6 = segment_by_draws(torch, gf, state, args, data, hkw, hand_plain,
                              seed + 2, SEGMENT, f"kernel 6 ({name})")
        r6g = segment_by_draws(torch, gf, state, args, data, gkw, gen_plain,
                               seed + 2, SEGMENT, f"kernel 6 ({name}, the "
                               "potential differentiated in the trace)")
        seg = gf.ghmc_segment_cuda(*state, *args, data, SEGMENT,
                                   seed=seed + 2, **hkw)
        seg_g = gf.ghmc_segment_cuda(*state, *args, data, SEGMENT,
                                     seed=seed + 2, **gkw)
        r6x = ghmc_compare(torch, q_t, seg[:2], seg_g[:2],
                           f"kernel 6 ({name}) vs the potential "
                           f"differentiated in the trace over {SEGMENT} "
                           "draws")
        del seg, seg_g
        cstate = (q_t.T.contiguous(), u0.reshape(-1), g0.T.contiguous())
        steps = torch.full((), LEAPFROG_STEPS, dtype=torch.int32,
                           device=DEVICE)
        c7, c7g, c7gp = [], [], []
        for rand in (dict(momentum=ext["noise"].T.contiguous(),
                          u_accept=ext["u_accept"].reshape(-1)),
                     dict(seed=seed + 3)):
            how = f"{name}, {'Philox' if 'seed' in rand else 'external'}"
            kern = cf.chees_transition_cuda(*cstate, im, eps, steps, data,
                                            **hkw, **rand)
            kgen = cf.chees_transition_cuda(*cstate, im, eps, steps, data,
                                            **gkw, **rand)
            plain = cf.chees_transition_plain(*cstate, im, eps,
                                              LEAPFROG_STEPS, hand_plain,
                                              **rand)
            gplain = cf.chees_transition_plain(*cstate, im, eps,
                                               LEAPFROG_STEPS, gen_plain,
                                               **rand)
            torch.cuda.synchronize()
            c7.append(chees_compare(torch, cstate[0], kern, plain,
                                    f"kernel 7 ({how}) vs plain"))
            c7g.append(chees_compare(torch, cstate[0], kern, kgen,
                                     f"kernel 7 ({how}) vs the potential "
                                     "differentiated in the trace"))
            c7gp.append(chees_compare(torch, cstate[0], kgen, gplain,
                                      f"kernel 7 ({how}), the potential "
                                      "differentiated in the trace vs its "
                                      "plain"))

        def k5(kw):
            return gf.ghmc_transition_cuda(*state, eps, 0.0, im, data,
                                           seed=7, **kw)

        def k6(kw):
            return gf.ghmc_segment_cuda(*state, eps, 0.0, im, data, SEGMENT,
                                        seed=7, **kw)

        def k7(kw):
            return cf.chees_transition_cuda(*cstate, im, eps, steps, data,
                                            seed=7, **kw)

        t = dict(
            ms5=kernel_ms(lambda: k5(hkw), HMC_TIMED_REPS),
            grad_traced_ms5=kernel_ms(lambda: k5(gkw), HMC_TIMED_REPS),
            plain_ms5=cuda_ms(torch, lambda: gf.ghmc_transition_plain(
                *state, eps, 0.0, im, hand_plain, seed=7), 3),
            ms6=kernel_ms(lambda: k6(hkw), 2),
            grad_traced_ms6=kernel_ms(lambda: k6(gkw), 2),
            plain_ms6=cuda_ms(torch, lambda: gf.ghmc_segment_plain(
                *state, eps, 0.0, im, hand_plain, SEGMENT, seed=7), 1),
            ms7=kernel_ms(lambda: k7(hkw), HMC_TIMED_REPS),
            grad_traced_ms7=kernel_ms(lambda: k7(gkw), HMC_TIMED_REPS),
            plain_ms7=cuda_ms(torch, lambda: cf.chees_transition_plain(
                *cstate, im, eps, LEAPFROG_STEPS, hand_plain, seed=7), 2))
        moved = nbytes(*state, im, *data)
        b5 = bound(hier_hmc_flop(name, dim, 1, chains),
                   moved + nbytes(*k5(hkw)), PEAK_F32)
        b6 = bound(SEGMENT * hier_hmc_flop(name, dim, 1, chains),
                   moved + nbytes(*k6(hkw)), PEAK_F32)
        b7 = bound(hier_hmc_flop(name, dim, LEAPFROG_STEPS, chains),
                   nbytes(*cstate, im, *data, *k7(hkw)) + 8, PEAK_F32)
        r5, r5g, r5gp = worst(c5), worst(c5g), worst(c5gp)
        r7, r7g, r7gp = worst(c7), worst(c7g), worst(c7gp)
        log(f"phase 40: kernels 5-7 on {name} (dim {dim}, {chains} chains "
            f"from N(0, 1), ε {eps}; α {GHMC_ALPHA}, L {LEAPFROG_STEPS}), "
            f"the functor traced from its torch function: vs plain "
            f"{r5[0]:.4%} / {r6[0]:.4%} / {r7[0]:.4%} of decisions equal "
            f"(max |q| err {r5[1]:.3g} / {r6[1]:.3g} / {r7[1]:.3g}; kernel 6 "
            f"== {SEGMENT} launches of kernel 5 bit for bit, each draw from "
            f"its own state), vs the potential differentiated in the trace "
            f"{r5g[0]:.4%} / {r6x[0]:.4%} / {r7g[0]:.4%} ({r5g[1]:.3g} / "
            f"{r6x[1]:.3g} / {r7g[1]:.3g}), that one vs its plain "
            f"{r5gp[0]:.4%} / {r6g[0]:.4%} / {r7gp[0]:.4%}; ms traced / "
            f"differentiated in the trace / plain / bound: kernel 5 "
            f"{t['ms5']:.4f} / {t['grad_traced_ms5']:.4f} / "
            f"{t['plain_ms5']:.3f} / {b5[0]:.5f}, kernel 6 per {SEGMENT} "
            f"draws {t['ms6']:.4f} / {t['grad_traced_ms6']:.4f} / "
            f"{t['plain_ms6']:.2f} / {b6[0]:.5f}, kernel 7 {t['ms7']:.4f} / "
            f"{t['grad_traced_ms7']:.4f} / {t['plain_ms7']:.3f} / "
            f"{b7[0]:.5f} [{card}]")
        out[name] = dict(
            share=[r5[0], r6[0], r7[0]], max_abs_err=[r5[1], r6[1], r7[1]],
            share_vs_grad_traced=[r5g[0], r6x[0], r7g[0]],
            max_abs_err_vs_grad_traced=[r5g[1], r6x[1], r7g[1]],
            grad_traced_share=[r5gp[0], r6g[0], r7gp[0]],
            grad_traced_max_abs_err=[r5gp[1], r6g[1], r7gp[1]], **t,
            bound_ms=[b5[0], b6[0], b7[0]],
            bound_by=[b5[1], b6[1], b7[1]])
    record["phase40"] = out
    return out


def witness_z(torch, diagnostics, positions, witness):
    """The largest |mean − the witness's| over combined MCSE of draws
    ``positions (draws, chains, dim)``."""
    mean, mcse = mean_mcse(torch, diagnostics,
                           positions.float().transpose(0, 1))
    return float(((mean - witness[0]).abs()
                  / torch.sqrt(mcse**2 + witness[1]**2)).max())


def door_twice(torch, ops, run, what):
    """``run()`` twice, launch counts reset before each: the first result,
    its wall and launches; the two results' draws, diagnostics and final
    states must be equal bit for bit."""
    outs = []
    for _ in range(2):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        outs.append((res, time.perf_counter() - t0, dict(ops.LAUNCHES)))
    (res, wall, launches), (res_b, wall_b, launches_b) = outs
    check(launches == launches_b, f"{what}: launches {launches}, then "
          f"{launches_b}")
    same_bits((res.positions, res.diagnostics, res.final_state),
              (res_b.positions, res_b.diagnostics, res_b.final_state),
              f"{what} run twice with one seed")
    return res, wall, wall_b, {k: v for k, v in launches.items() if v}


def bare_front_doors(torch, ops, diagnostics, gen, q0, record, nuts_mean,
                     card):
    """Phases 41 (MALA, GHMC at α 0.9, ChEES) and 42 (MEADS, and MEADS
    checkpointed): the front door on the flagship's bare logprob_fn at the
    hand-written routes' cells and seeds (phases 11, 12, 14, 24, 26), each
    run twice; only the _generic launch counts move.  Returns the main
    paths' launches of kernels 5-7 on the generated functor."""
    import tempfile

    import aehmc_tpu_torch

    lp = gen["logprob_fn"]

    def door(algorithm, draws, warmup, seed, **kw):
        return lambda: aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(seed), lp, q0, draws, warmup,
            algorithm=algorithm, path="fused", **kw)

    ghmc = dict(initial_step_size=0.1, segment_draws=SEGMENT)
    cells = (
        ("MALA", door("mala", MALA_DRAWS, WARMUP, 11, **ghmc),
         {"ghmc_transition_generic": WARMUP,
          "ghmc_segment_generic": -(-MALA_DRAWS // SEGMENT)}, {}),
        ("GHMC", door("ghmc", GHMC_DRAWS, WARMUP, 12, ghmc_alpha=GHMC_ALPHA,
                      **ghmc),
         {"ghmc_transition_generic": WARMUP,
          "ghmc_segment_generic": -(-GHMC_DRAWS // SEGMENT)}, {}),
        ("ChEES", door("chees", DRAWS, WARMUP, 14,
                       initial_step_size=CHEES_EPS0), None,
         dict(accept_range=CHEES_ACCEPT)),
        ("MEADS", door("meads", MEADS_DRAWS, MEADS_WARMUP, 24,
                       meads_recompute_every=MEADS_EVERY),
         {"ghmc_segment_generic": -(-MEADS_WARMUP // MEADS_EVERY)
          + -(-MEADS_DRAWS // MEADS_EVERY)},
         dict(accept_range=(MEADS_ACCEPT_MIN, 1.0), rhat_max=MEADS_RHAT_MAX)),
    )
    out = {}
    for what, run, want, limits in cells:
        res, wall, wall_b, launches = door_twice(
            torch, ops, run, f"{what} front door on a bare logprob_fn")
        if want is None:  # ChEES: the initial-ε probes, then a step a draw
            probes = launches.get("chees_transition_generic", 0) - (
                WARMUP + DRAWS)
            check(1 <= probes <= 32, f"ChEES on a bare logprob_fn: launches "
                  f"{launches}")
            want = {"chees_transition_generic": WARMUP + DRAWS + probes}
            steps = res.diagnostics.num_integration_steps[:, 0]
            check(bool((steps >= 1).all() & (steps <= MAX_L).all()),
                  f"ChEES trip counts out of [1, {MAX_L}]")
        check(launches == want, f"{what} front door on a bare logprob_fn: "
              f"launches {launches}, want {want}")
        lim = front_door_checks(torch, diagnostics, res, nuts_mean,
                                f"{what} (bare logprob_fn)", **limits)
        z = witness_z(torch, diagnostics, res.positions, WITNESS_MEANS[what])
        check(z < MCSE_Z, f"{what} on a bare logprob_fn: means {z} MCSE from "
              "the hand-written route's")
        if what in ("MALA", "GHMC"):
            ac = move_autocorrelation(res.positions.transpose(0, 1)[:, :, :10])
            check(ac < MALA_MOVE_AC if what == "MALA" else ac > GHMC_MOVE_AC,
                  f"{what} on a bare logprob_fn: move autocorrelation {ac}")
            lim["move_autocorrelation"] = ac
        out[what] = dict(wall_s=wall, wall_s_again=wall_b, launches=launches,
                         max_z_vs_handwritten=z, **lim)
        log(f"phase {42 if what == 'MEADS' else 41}: {what} front door on a "
            f"bare logprob_fn (the generated functor) {CHAINS}x{DIM}: "
            f"{wall:.2f} s (again {wall_b:.2f} s, equal bit for bit); "
            f"launches {launches}; accept {lim['accept']:.4f}, divergent "
            f"{lim['divergent_share']:.2e}, eps {lim['step_size']:.4f}, max "
            f"R-hat {lim['max_rhat']:.4f} (excess over stationary "
            f"{lim['max_rhat_excess']:.4f}), means within "
            f"{lim['max_z_vs_nuts']:.2f} MCSE of NUTS and {z:.2f} of the "
            f"hand-written route's [{card}]")
        del res

    # MEADS checkpointed: kernel 5 a draw (phase 26's cut)
    with tempfile.TemporaryDirectory() as tmp:
        runs = iter(("a", "b"))
        res, wall, wall_b, launches = door_twice(
            torch, ops, lambda: door(
                "meads", CKPT_DRAWS, CKPT_WARMUP, 26,
                meads_recompute_every=MEADS_EVERY,
                checkpoint_every=CKPT_EVERY,
                checkpoint_path=f"{tmp}/{next(runs)}.npz")(),
            "checkpointed MEADS on a bare logprob_fn")
    want = {"ghmc_transition_generic": CKPT_WARMUP + CKPT_DRAWS}
    check(launches == want, f"checkpointed MEADS on a bare logprob_fn: "
          f"launches {launches}")
    check(bool(torch.isfinite(res.positions).all()),
          "checkpointed MEADS on a bare logprob_fn: non-finite draws")
    out["MEADS checkpointed"] = dict(
        wall_s=wall, wall_s_again=wall_b, launches=launches,
        accept=float(res.diagnostics.acceptance_probability.mean()))
    log(f"phase 42: checkpointed MEADS front door on a bare logprob_fn "
        f"(kernel 5 a draw, a snapshot every {CKPT_EVERY}) {CHAINS}x{DIM}, "
        f"{CKPT_WARMUP} + {CKPT_DRAWS}: {wall:.2f} s (again {wall_b:.2f} s, "
        f"equal bit for bit); launches {launches}; accept "
        f"{out['MEADS checkpointed']['accept']:.4f} [{card}]")
    del res
    record["phase41"] = {k: v for k, v in out.items()
                         if k in ("MALA", "GHMC", "ChEES")}
    record["phase42"] = {k: v for k, v in out.items() if "MEADS" in k}
    return dict(ghmc_transition=out["MALA"]["launches"][
                    "ghmc_transition_generic"],
                ghmc_segment=out["MALA"]["launches"]["ghmc_segment_generic"],
                chees_transition=out["ChEES"]["launches"][
                    "chees_transition_generic"],
                meads_segment=out["MEADS"]["launches"]["ghmc_segment_generic"],
                meads_transition=launches["ghmc_transition_generic"])


def hier_hmc_front_doors(torch, ops, diagnostics, record, card):
    """Phase 43: eight schools' ChEES and MEADS front doors on its
    hand-written torch function (schools_pg_t, which kernels 5-7 run on the
    functor traced from it) at phase 19's 2,048 chains, 500 + 500, held to
    phase 19's NUTS means; and, so that kernels 5-7 on each hierarchical
    model run on a front door, eight schools' GHMC and the funnel's MALA
    and ChEES front doors (the funnel at phase 18's cell, 8,192 chains, 300
    + 200), held to finite draws and an acceptance above
    HIER_DOOR_ACCEPT_MIN.  Each run's launches are checked exactly: only
    the _generic counters move.  Returns each run's launches."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch.models import (
        eight_schools,
        eight_schools_pg_t,
        neals_funnel,
        neals_funnel_pg_t,
    )

    schools = (eight_schools(device=DEVICE)[0],
               *eight_schools_pg_t(device=DEVICE)[:3])
    funnel = (neals_funnel(FUNNEL_DIM, device=DEVICE)[0],
              *neals_funnel_pg_t(FUNNEL_DIM, device=DEVICE)[:3])
    def ghmc_launches(warmup, draws):  # kernel 5 a warmup step, 6 a segment
        return {"ghmc_transition_generic": warmup,
                "ghmc_segment_generic": -(-draws // SEGMENT)}

    runs = (
        ("eight schools ChEES", schools, "chees", SCHOOLS_CHAINS,
         SCHOOLS_WARMUP, SCHOOLS_DRAWS, {}, None),
        ("eight schools MEADS", schools, "meads", SCHOOLS_CHAINS,
         SCHOOLS_WARMUP, SCHOOLS_DRAWS,
         dict(meads_recompute_every=MEADS_EVERY),
         {"ghmc_segment_generic": -(-SCHOOLS_WARMUP // MEADS_EVERY)
          + -(-SCHOOLS_DRAWS // MEADS_EVERY)}),
        ("eight schools GHMC", schools, "ghmc", SCHOOLS_CHAINS,
         SCHOOLS_WARMUP, GHMC_DRAWS,
         dict(segment_draws=SEGMENT, initial_step_size=0.1),
         ghmc_launches(SCHOOLS_WARMUP, GHMC_DRAWS)),
        ("funnel MALA", funnel, "mala", FUNNEL_CHAINS, FUNNEL_WARMUP,
         FUNNEL_DRAWS, dict(segment_draws=SEGMENT, initial_step_size=0.1),
         ghmc_launches(FUNNEL_WARMUP, FUNNEL_DRAWS)),
        ("funnel ChEES", funnel, "chees", FUNNEL_CHAINS, FUNNEL_WARMUP,
         FUNNEL_DRAWS, {}, None),
    )
    out = {}
    for what, (lp, pot, pg, data), algorithm, chains, warmup, draws, kw, \
            want in runs:
        dim = 10 if "schools" in what else FUNNEL_DIM
        q0 = torch.tensor(0.1 * np.random.default_rng(43).standard_normal(
            (chains, dim)), dtype=torch.float32, device=DEVICE)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(43), lp, q0, draws, warmup,
            algorithm=algorithm, path="fused", data=data, potential_fn_t=pot,
            potential_and_grad_t=pg, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        if want is None:  # ChEES: the initial-ε probes, then a step a draw
            probes = launches.get("chees_transition_generic", 0) - (
                warmup + draws)
            check(1 <= probes <= 32, f"{what}: launches {launches}")
            want = {"chees_transition_generic": warmup + draws + probes}
        check(launches == want, f"{what}: launches {launches}, want {want}")
        accept = float(res.diagnostics.acceptance_probability.mean())
        finite = bool(torch.isfinite(res.positions).all())
        check(finite, f"{what}: non-finite draws")
        check(accept > HIER_DOOR_ACCEPT_MIN, f"{what}: acceptance {accept}")
        row = dict(wall_s=wall, launches=launches, accept=accept,
                   divergent_share=float(
                       res.diagnostics.is_diverging.float().mean()),
                   step_size=float(torch.as_tensor(res.step_size).float()
                                   .mean()))
        if "schools" in what:
            row["max_z_vs_nuts"] = witness_z(
                torch, diagnostics, res.positions,
                WITNESS_MEANS["eight schools NUTS"])
            if algorithm in ("chees", "meads"):
                check(row["max_z_vs_nuts"] < MCSE_Z, f"{what}: means "
                      f"{row['max_z_vs_nuts']} MCSE from phase 19's NUTS")
        else:
            v = res.positions[FUNNEL_BURN:, :, 0].float()
            row.update(v_mean=float(v.mean()), v_sd=float(v.std()))
        out[what] = row
        log(f"phase 43: {what} front door ({chains} chains, {warmup} + "
            f"{draws}) on the functor traced from its torch function: "
            f"{wall:.2f} s; launches "
            f"{launches}; accept {accept:.4f}, divergent "
            f"{row['divergent_share']:.2e}, mean eps {row['step_size']:.4f}"
            + (f", means within {row['max_z_vs_nuts']:.2f} MCSE of phase "
               "19's NUTS" if "max_z_vs_nuts" in row else
               f", v over draws {FUNNEL_BURN}+ mean {row['v_mean']:.3f} sd "
               f"{row['v_sd']:.3f}") + f" [{card}]")
        del res
    record["phase43"] = out
    return {k: v["launches"] for k, v in out.items()}


def hmc_functor_entries(gen39, hier40, door, hier43, ptxas):
    """The ``kernels`` line's entries of kernels 5-7 on the flagship's
    generated functor (launches: phases 41-42's front doors, LogisticPGT's
    time on the same inputs beside it) and on the funnel's and eight
    schools' (launches: phase 43's; the potential differentiated in the
    trace beside it), each with its registers and spills."""
    names = ("ghmc_transition", "ghmc_segment", "chees_transition")
    lines = ("aehmc_tpu/ops/ghmc_fused.py:139",
             "aehmc_tpu/ops/ghmc_fused.py:329",
             "aehmc_tpu/ops/chees_fused.py:61")
    launches = (door["ghmc_transition"], door["ghmc_segment"],
                door["chees_transition"])
    out = []
    for i, (name, line) in enumerate(zip(names, lines)):
        regs = ptxas["flagship"]
        out.append(dict(
            kernel_entry(f"{name}_generic", "hmc_generic.cu", line,
                         launches[i], gen39["errs"][i], gen39["ms"][i],
                         gen39["plain_ms"][i], gen39["bounds"][i]),
            handwritten_ms=gen39["hand_ms"][i],
            vs_handwritten_max_abs_err=gen39["errs_hand"][i],
            meads_launches=(door["meads_transition"], door["meads_segment"],
                            None)[i],
            chains_per_block=8, registers=regs["registers"][5 + i],
            spill_bytes=regs["spill_bytes"][5 + i]))
    for model, runs in (("funnel", {"ghmc_transition": "funnel MALA",
                                    "ghmc_segment": "funnel MALA",
                                    "chees_transition": "funnel ChEES"}),
                        ("eight_schools", {
                            "ghmc_transition": "eight schools GHMC",
                            "ghmc_segment": "eight schools MEADS",
                            "chees_transition": "eight schools ChEES"})):
        h = hier40[model]
        for i, (name, line) in enumerate(zip(names, lines)):
            n = str(5 + i)
            counter = f"{name}_generic"
            out.append(dict(
                kernel_entry(f"{counter} ({model})", "hmc_generic.cu", line,
                             hier43[runs[name]].get(counter, 0),
                             h["max_abs_err"][i], h["ms" + n],
                             h["plain_ms" + n],
                             (h["bound_ms"][i], h["bound_by"][i])),
                chains_per_block=8, grad_traced_ms=h["grad_traced_ms" + n],
                vs_grad_traced_max_abs_err=h["max_abs_err_vs_grad_traced"][i],
                registers=ptxas[model]["registers"][5 + i],
                spill_bytes=ptxas[model]["spill_bytes"][5 + i]))
    return out


# phases 44-47: a device mesh.  Phase 44 holds kernels 1-5 and 7 at a
# chain offset (kernel 6, never sharded, keys on its launch's chains):
# four shards of the flagship's chains, each launched at its
# global offset, joined, equal to the whole launch bit for bit, each shard
# against its plain version fed the same offset streams.  Phase 45 runs
# phase 5's fused NUTS front door on a mesh that names the card four
# times (2,560 chains, 320 blocks of 8 a shard) and on a 2 x 2 multislice
# mesh of it, against the unsharded run; phase 46 the fused ChEES (phase
# 14's cell), the fused MEADS transition route (phase 24's) and the pooled
# XLA NUTS front door (phase 22's pooled_nuts) on the four-shard mesh;
# phase 47 phase 45 on distinct cards where there are more than one.
OFFSET_SHARDS = 4
OFFSET_SEED = 440044
OFFSET_DRAWS = 4              # kernels 2 and 4's draws in phase 44
OFFSET_KERNELS = ("nuts_transition", "nuts_sampling", "nuts_transition_std",
                  "nuts_sampling_std", "ghmc_transition", "chees_transition")
# phase 46's pooled XLA NUTS run on 4 shards against the unsharded one,
# which cuBLAS keeps from agreeing bit for bit: the draws held chain by
# chain (phase 20's share of chains with equal decisions, each within
# POOLED_MESH_QTOL, a fiftieth of the posterior's least standard
# deviation, 0.555, of its unsharded position after 100 warmup steps), and
# the relative gap allowed in the tuned ε and M⁻¹
POOLED_MESH_DRAWS = 10
POOLED_MESH_QTOL = 1e-2
POOLED_MESH_RTOL = 1e-3


def join_shards(torch, parts, axes):
    """Per-shard output tuples joined along each output's chain axis."""
    return tuple(None if ps[0] is None else torch.cat(ps, dim=ax)
                 for ps, ax in zip(zip(*parts), axes))


def offset_phase(torch, gen, data, pg, q0, record, card):
    """Phase 44: kernels 1-5 and 7 at a chain offset on LogisticPGT and on
    the flagship's generated functor.  Returns, for each kernel, its least
    decision share and largest |Δq| against plain over the shards."""
    from aehmc_tpu_torch.ops import chees_fused as cf
    from aehmc_tpu_torch.ops import generic_pg
    from aehmc_tpu_torch.ops import ghmc_fused as gf
    from aehmc_tpu_torch.ops import nuts_fused as nf
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs

    dev = q0.device
    rng = np.random.default_rng(44)
    width = CHAINS // OFFSET_SHARDS
    offsets = range(0, CHAINS, width)
    seed, draws = OFFSET_SEED, OFFSET_DRAWS
    im = torch.full((DIM,), IMM, device=dev)
    X, y = data[0], data[2].reshape(-1)
    b = gen["binds"]["flagship"]
    ops_b = b.operands((), dev)
    b3 = gen["binds"]["cell"]
    ops3 = b3.operands((X, y), dev)

    def plain_cell(q):
        u, g = generic_pg.run_plain(b3.ir, q.T.contiguous(), ops3)
        return u.reshape(-1, 1), g.T

    functors = {
        "LogisticPGT": dict(data=data, kw={}, pg_t=lambda x: pg(x, *data),
                            model=nf._logistic_model(X, y, 1.0,
                                                     torch.float32)),
        "generated": dict(
            data=(), kw=dict(potential_and_grad_t=None,
                             potential_fn_t=gen["flagship_t"]),
            pg_t=lambda x: generic_pg.run_plain(b.ir, x, ops_b),
            model=nf._generic_model(gen["cell"], (X, y)),
            plain_model=nf._Model(plain_cell, (X, y), None)),
    }
    q_t = q0.T.contiguous()
    u_t, g_t = pg(q_t, *data)
    p_t = torch.tensor(np.sqrt(1.0 / IMM) * rng.standard_normal((DIM, CHAINS)),
                       dtype=torch.float32, device=dev)
    steps = torch.full((), LEAPFROG_STEPS, dtype=torch.int32, device=dev)

    def kernels(f):
        """kernel -> (run(lo, hi, plain) -> outputs, each output's chain
        axis, hold(kernel outputs, plain outputs, q_in, what))."""
        d, kw, ppg, model = f["data"], f["kw"], f["pg_t"], f["model"]
        pmodel = f.get("plain_model", model)
        us, gs = model.pot_grad(q0)  # the standard layout's state

        def t_(x, lo, hi):
            return x[:, lo:hi].contiguous()

        def s_(x, lo, hi):
            return x[lo:hi].contiguous()

        def k1(lo, hi, plain):
            st = (t_(q_t, lo, hi), t_(u_t, lo, hi), t_(g_t, lo, hi))
            if plain:
                return nfs.nuts_transition_plain(
                    *st, im, EPS, ppg, max_exp=K, seed=seed, chain_offset=lo)
            return nfs.nuts_transition_cuda(*st, im, EPS, d, max_exp=K,
                                            seed=seed, chain_offset=lo, **kw)

        def k2(lo, hi, plain):
            st = (t_(q_t, lo, hi), t_(u_t, lo, hi), t_(g_t, lo, hi))
            if plain:
                return nfs._sampling_plain(
                    ppg, *st, im, EPS, seed, draws, max_exp=K,
                    divergence_threshold=1000.0, collect_positions=True,
                    collect_dtype=torch.float32, chain_offset=lo)
            return nfs.nuts_sampling_cuda(*st, im, EPS, d, seed, draws,
                                          max_exp=K, chain_offset=lo, **kw)

        def k3(lo, hi, plain):
            st = (s_(q0, lo, hi), s_(us, lo, hi), s_(gs, lo, hi))
            if plain:
                return nf.nuts_transition_std_plain(
                    *st, im, EPS, pmodel.pot_grad, max_exp=K, seed=seed,
                    chain_offset=lo)
            return nf._transition(model, *st, None, None, None, None, im, EPS,
                                  max_exp=K, divergence_threshold=1000.0,
                                  seed=seed, chain_offset=lo)

        def k4(lo, hi, plain):
            st = (s_(q0, lo, hi), s_(us, lo, hi), s_(gs, lo, hi))
            if plain:
                return nf._sampling_plain(
                    pmodel, *st, im, EPS, seed, draws, max_exp=K,
                    divergence_threshold=1000.0, collect_positions=True,
                    chain_offset=lo)
            return nf._fused_sampling_call(model, *st, im, EPS, seed, draws,
                                           max_num_expansions=K,
                                           chain_offset=lo)

        def k5(lo, hi, plain):
            st = tuple(t_(x, lo, hi) for x in (q_t, u_t, g_t, p_t))
            if plain:
                return gf.ghmc_transition_plain(
                    *st, EPS, GHMC_ALPHA, im, ppg, seed=seed, chain_offset=lo)
            return gf.ghmc_transition_cuda(*st, EPS, GHMC_ALPHA, im, d,
                                           seed=seed, chain_offset=lo, **kw)

        def k7(lo, hi, plain):
            st = (s_(q0, lo, hi), s_(u_t.reshape(-1), lo, hi),
                  s_(g_t.T, lo, hi))
            if plain:
                return cf.chees_transition_plain(
                    *st, im, EPS, LEAPFROG_STEPS, ppg, seed=seed,
                    chain_offset=lo)
            return cf.chees_transition_cuda(*st, im, EPS, steps, d,
                                            seed=seed, chain_offset=lo, **kw)

        def nuts_t(k, p, q_in, what):
            return compare(k, p, what)

        def nuts_t2(k, p, q_in, what):
            return compare((k[0], None, None, k[1]), (p[0], None, None, p[1]),
                           what)

        def nuts_s(k, p, q_in, what):
            return compare(tuple(None if x is None else x.T for x in k[:4]),
                           tuple(None if x is None else x.T for x in p[:4]),
                           what)

        def nuts_s2(k, p, q_in, what):
            def t4(o):
                return (o[0].transpose(1, 2), None, None,
                        o[1].transpose(1, 2))
            return compare(t4(k), t4(p), what)

        def ghmc1(k, p, q_in, what):
            return ghmc_compare(torch, q_in, (k[0][None], k[4][None]),
                                (p[0][None], p[4][None]), what)

        def chees(k, p, q_in, what):
            return chees_compare(torch, q_in, k, p, what)

        return {
            "nuts_transition": (k1, (-1,) * 4, nuts_t, lambda lo, hi: t_(q_t, lo, hi)),
            "nuts_sampling": (k2, (-1,) * 5, nuts_t2, lambda lo, hi: t_(q_t, lo, hi)),
            "nuts_transition_std": (k3, (0,) * 4, nuts_s, lambda lo, hi: s_(q0, lo, hi)),
            "nuts_sampling_std": (k4, (1, 1, 0, 0, 0), nuts_s2, lambda lo, hi: s_(q0, lo, hi)),
            "ghmc_transition": (k5, (-1,) * 5, ghmc1, lambda lo, hi: t_(q_t, lo, hi)),
            "chees_transition": (k7, (0,) * 6, chees, lambda lo, hi: s_(q0, lo, hi)),
        }

    out = {}
    for fname, f in functors.items():
        for name, (run, axes, hold, q_in) in kernels(f).items():
            whole = run(0, CHAINS, False)
            parts = [run(lo, lo + width, False) for lo in offsets]
            torch.cuda.synchronize()
            same_bits(tuple(whole), join_shards(torch, parts, axes),
                      f"{name} ({fname}): {OFFSET_SHARDS} shards at offsets "
                      f"{list(offsets)} joined against the whole launch")
            del whole
            held = [hold(part, run(lo, lo + width, True), q_in(lo, lo + width),
                         f"{name} ({fname}) at chain offset {lo} vs plain")
                    for lo, part in zip(offsets, parts)]
            del parts
            out.setdefault(name, {})[fname] = dict(
                bitwise=True, shards=OFFSET_SHARDS, offsets=list(offsets),
                share=min(h[0] for h in held),
                max_abs_err=max(h[1] for h in held))
    for name, r in out.items():
        log(f"phase 44: {name} at chain offsets {list(offsets)} ("
            f"{width} chains a shard): joined shards equal the whole launch "
            "bit for bit on " + " and ".join(r) + "; against plain fed the "
            "same offset streams: " + ", ".join(
                f"{k} decisions {v['share']:.4%}, max |q| err "
                f"{v['max_abs_err']:.3g}" for k, v in r.items())
            + f" [{card}]")
    record["phase44"] = out
    return out


def results_equal(a, b, what):
    """Two front-door results (SampleResult) equal bit for bit: positions,
    diagnostics, final state, step size and M⁻¹."""
    same_bits((a.positions, tuple(a.diagnostics), a.final_state, a.step_size,
               a.inverse_mass_matrix),
              (b.positions, tuple(b.diagnostics), b.final_state, b.step_size,
               b.inverse_mass_matrix), what)


def mesh_run(torch, ops, run, mesh):
    """One front-door run: (result, wall seconds, launch counts)."""
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run(mesh)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0, dict(ops.LAUNCHES)


def draw_agreement(torch, a, b, draws, atol):
    """Chain by chain, two runs' (SampleResult) first ``draws`` draws:
    per draw the share of chains whose decisions (doublings, leaves,
    divergent, turning) are equal and whose positions lie within ``atol``
    of each other, and the largest |Δq| over those chains."""
    da, db = a.diagnostics, b.diagnostics
    same = ((da.num_doublings == db.num_doublings)
            & (da.num_integration_steps == db.num_integration_steps)
            & (da.is_turning == db.is_turning)
            & (da.is_diverging == db.is_diverging))[:draws]
    dq = (a.positions[:draws] - b.positions[:draws]).abs().amax(-1)
    held = same & (dq <= atol)
    return ([float(x) for x in held.float().mean(1)],
            float(dq[held].max()) if bool(held.any()) else math.inf)


def relative_gap(torch, a, b):
    """The largest |a - b| / |a| over the elements."""
    return float(((a - b).abs() / a.abs()).max())


def pooled_mesh_hold(torch, ops, diagnostics, run, logprob_fn, mesh):
    """Phase 46's pooled XLA NUTS front door on ``mesh`` against its
    unsharded run.  The XLA path's gradients come from ``torch.func``, whose
    product over the data points cuBLAS may split differently for a
    shard's rows than for the whole batch's, so the run is held bit for bit
    only where it is, and always: the share of gradient values whose bits
    differ between the whole batch and its shards (recorded); the tuned ε
    and M⁻¹ within relative POOLED_MESH_RTOL of the unsharded run's; each
    of the first POOLED_MESH_DRAWS draws chain by chain (draw_agreement:
    at least DECISION_SHARE of the chains with equal decisions and within
    POOLED_MESH_QTOL; a wrong key or a wrong chain order moves most
    chains); one XLA NUTS step from the unsharded run's final state at its
    tuned ε and M⁻¹ through ``shard_kernel`` against the whole batch's
    (phase 20's limits); and the two runs' means within MCSE_Z combined
    MCSE."""
    from aehmc_tpu_torch import _batch, keys
    from aehmc_tpu_torch.parallel.pooled import shard_kernel
    from aehmc_tpu_torch.sampling import make_kernel

    base, wall0, l0 = mesh_run(torch, ops, run, None)
    res, wall, launches = mesh_run(torch, ops, run, mesh)
    check(sum(launches.values()) == 0 == sum(l0.values()),
          f"pooled NUTS launched a kernel: {launches}")
    bitwise = all(
        a.shape == b.shape and bool((a == b).all())
        for a, b in zip((base.positions, *base.diagnostics, base.step_size,
                         base.inverse_mass_matrix),
                        (res.positions, *res.diagnostics, res.step_size,
                         res.inverse_mass_matrix)))
    # the tuned parameters, and the first draws chain by chain
    eps_gap = relative_gap(torch, base.step_size, res.step_size)
    imm_gap = relative_gap(torch, base.inverse_mass_matrix,
                           res.inverse_mass_matrix)
    shares, draws_err = draw_agreement(torch, base, res, POOLED_MESH_DRAWS,
                                       POOLED_MESH_QTOL)
    # recorded: the shares with equal decisions alone, and within Q_ATOL
    decided = draw_agreement(torch, base, res, POOLED_MESH_DRAWS, math.inf)[0]
    near = draw_agreement(torch, base, res, POOLED_MESH_DRAWS, Q_ATOL)[0]
    held = dict(eps_rel_gap=eps_gap, imm_rel_gap=imm_gap,
                draw_shares=shares, draws_max_abs_err=draws_err,
                draw_decision_shares=decided, draw_shares_q_atol=near)
    log(f"phase 46: pooled NUTS on {mesh.size} shards against unsharded "
        f"(before its checks): tuned ε relative gap {eps_gap:.3g}, M⁻¹ "
        f"{imm_gap:.3g}; the first {POOLED_MESH_DRAWS} draws agree chain by "
        f"chain (equal decisions, |Δq| ≤ {POOLED_MESH_QTOL}) on "
        f"{min(shares):.4%} of the chains or more (per draw "
        f"{[round(x, 5) for x in shares]}), max |q| err {draws_err:.3g}; "
        f"equal decisions alone {[round(x, 5) for x in decided]}; within "
        f"{Q_ATOL} {[round(x, 5) for x in near]}")
    check(eps_gap <= POOLED_MESH_RTOL and imm_gap <= POOLED_MESH_RTOL,
          f"pooled NUTS on a mesh: tuned ε {eps_gap:.3g}, M⁻¹ {imm_gap:.3g} "
          "relative to the unsharded run's")
    check(min(shares) >= DECISION_SHARE,
          f"pooled NUTS on a mesh: the first {POOLED_MESH_DRAWS} draws agree "
          f"chain by chain on {min(shares):.4f} of the chains (max |q| "
          f"error {draws_err})")
    # the gradients of the whole batch against its shards'
    q = base.final_state.position
    vag = _batch.value_and_grad(lambda x: -logprob_fn(x))
    whole = vag(q)
    width = q.shape[0] // mesh.size
    parts = [vag(q[i:i + width].contiguous())
             for i in range(0, q.shape[0], width)]
    differ = [int((w != torch.cat([p[j] for p in parts])).sum())
              for j, w in enumerate(whole)]
    # one XLA NUTS step from the tuned state, whole and sharded
    kernel = make_kernel(logprob_fn, "nuts",
                         max_num_expansions=POOLED_RUNS["nuts"][2][
                             "max_num_expansions"])
    key = keys.Key(4646)
    args = (base.final_state, base.step_size, base.inverse_mass_matrix)
    st_w, info_w = kernel(key, *args)
    st_s, info_s = shard_kernel(kernel, mesh, q.shape[0])(key, *args)
    torch.cuda.synchronize()
    same = ((info_w.num_doublings == info_s.num_doublings)
            & (info_w.num_integration_steps == info_s.num_integration_steps)
            & (info_w.is_turning == info_s.is_turning)
            & (info_w.is_diverging == info_s.is_diverging)
            & ((info_w.energy - info_s.energy).abs()
               <= 1e-5 * info_w.energy.abs().clamp(min=1.0)))
    share = float(same.float().mean())
    err = float((st_w.position - st_s.position).abs()[same].max())
    check(share >= DECISION_SHARE, f"one sharded XLA NUTS step: decisions "
          f"agree on {share:.4f}")
    check(err <= Q_ATOL, f"one sharded XLA NUTS step: max |q| error {err}")
    # the runs' means
    (ma, sa), (mb, sb) = (mean_mcse(torch, diagnostics,
                                    r.positions.transpose(0, 1).double())
                          for r in (base, res))
    z = float(((ma - mb).abs() / torch.sqrt(sa**2 + sb**2)).max())
    check(z < MCSE_Z, f"pooled NUTS on a mesh: means {z} combined MCSE from "
          "the unsharded run's")
    return dict(unsharded_wall_s=wall0, wall_s=wall, unsharded_launches=l0,
                launches=launches, bitwise=bitwise,
                potential_bits_differ=differ[0], grad_bits_differ=differ[1],
                grad_values=whole[1].numel(), step_share=share,
                step_max_abs_err=err, max_z=z, **held)


def mesh_phases(torch, ops, diagnostics, data, pot, pg, q0, record, card):
    """Phases 45-47: the fused NUTS, fused ChEES and fused MEADS
    (transition route) front doors on a mesh against their unsharded runs,
    bit for bit, and the pooled XLA NUTS front door (pooled_mesh_hold),
    with launches and walls.  Returns the launches of kernels 1, 2, 5 and
    7 in phases 45-46's sharded runs."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch.models import logistic_regression
    from aehmc_tpu_torch.ops import ghmc_fused as gf
    from aehmc_tpu_torch.parallel import (
        make_mesh,
        make_multislice_mesh,
        sample_sharded,
    )

    dev = q0.device
    four = make_mesh(devices=[dev] * OFFSET_SHARDS)
    two_by_two = make_multislice_mesh(2, devices=[dev] * OFFSET_SHARDS)

    # ---- phase 45: phase 5's fused NUTS front door
    def nuts(mesh):
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(2026), None, q0, DRAWS, WARMUP,
            algorithm="nuts", path="fused", data=data, potential_fn_t=pot,
            potential_and_grad_t=pg, max_num_expansions=K,
            initial_step_size=0.1, collect_dtype=torch.bfloat16, mesh=mesh)

    base, wall0, l0 = mesh_run(torch, ops, nuts, None)
    check(l0["nuts_transition"] == WARMUP and l0["nuts_sampling"] == 1,
          f"unsharded NUTS front door launches {l0}")
    p45 = dict(unsharded=dict(wall_s=wall0, launches=l0))
    for name, mesh in (("four_shards", four), ("slice2x2", two_by_two)):
        res, wall, launches = mesh_run(torch, ops, nuts, mesh)
        check(launches["nuts_transition"] == OFFSET_SHARDS * WARMUP
              and launches["nuts_sampling"] == OFFSET_SHARDS,
              f"NUTS front door on {name}: launches {launches}")
        results_equal(base, res, f"NUTS front door on {name}")
        p45[name] = dict(wall_s=wall, launches=launches)
        del res
    del base
    log("phase 45: fused NUTS front door " + f"{CHAINS}x{DIM}, {WARMUP} + "
        f"{DRAWS}, K {K}, on [{dev}] x {OFFSET_SHARDS} and a 2 x 2 "
        "multislice mesh of it, equal to the unsharded run bit for bit "
        "(positions, stats, final state, eps, M⁻¹); walls " + ", ".join(
            f"{k} {v['wall_s']:.3f} s" for k, v in p45.items())
        + "; launches " + ", ".join(
            f"{k} {v['launches']['nuts_transition']} + "
            f"{v['launches']['nuts_sampling']}" for k, v in p45.items())
        + f" [{card}]")
    record["phase45"] = p45

    # ---- phase 46: fused ChEES, fused MEADS (transition), pooled XLA NUTS
    logprob_fn, _ = logistic_regression(DIM, POINTS, device=dev)

    def chees(mesh):
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(14), logprob_fn, q0, DRAWS, WARMUP,
            algorithm="chees", path="fused", data=data,
            potential_and_grad_t=pg, initial_step_size=CHEES_EPS0, mesh=mesh)

    def meads(mesh):
        gen = torch.Generator().manual_seed(24)
        if mesh is None:  # the unsharded transition route
            return sample_sharded(
                gen, logprob_fn, q0, MEADS_DRAWS, MEADS_WARMUP,
                algorithm="meads", meads_recompute_every=MEADS_EVERY,
                meads_transition_fn=gf.make_fused_meads_transition(
                    pot, data, potential_and_grad_t=pg))
        return aehmc_tpu_torch.sample(
            gen, logprob_fn, q0, MEADS_DRAWS, MEADS_WARMUP,
            algorithm="meads", path="fused", data=data, potential_fn_t=pot,
            potential_and_grad_t=pg, meads_recompute_every=MEADS_EVERY,
            mesh=mesh)

    warm, draws, kw = POOLED_RUNS["nuts"]

    def pooled(mesh):
        return aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(223), logprob_fn, q0, draws, warm,
            algorithm="nuts", path="pooled", initial_step_size=0.1,
            mesh=mesh, **kw)

    p46, sharded_launches = {}, {}
    for name, run, kernel in (("chees", chees, "chees_transition"),
                              ("meads_transition", meads, "ghmc_transition")):
        base, wall0, l0 = mesh_run(torch, ops, run, None)
        res, wall, launches = mesh_run(torch, ops, run, four)
        results_equal(base, res, f"{name} front door on {OFFSET_SHARDS} "
                      "shards")
        check(launches[kernel] == OFFSET_SHARDS * l0[kernel] > 0
              and sum(launches.values()) == launches[kernel],
              f"{name} on {OFFSET_SHARDS} shards: launches {launches}, "
              f"unsharded {l0}")
        sharded_launches[kernel] = launches[kernel]
        p46[name] = dict(unsharded_wall_s=wall0, wall_s=wall,
                         unsharded_launches=l0, launches=launches,
                         bitwise=True)
        del base, res
    p46["pooled_nuts"] = pooled_mesh_hold(torch, ops, diagnostics, pooled,
                                          logprob_fn, four)
    log("phase 46: on [" + f"{dev}] x {OFFSET_SHARDS} against the unsharded "
        "runs: " + ", ".join(
            f"{k} {v['wall_s']:.3f} s (unsharded {v['unsharded_wall_s']:.3f}"
            f" s; launches { {n: c for n, c in v['launches'].items() if c} };"
            f" bit for bit {v['bitwise']})"
            for k, v in p46.items())
        + "; pooled NUTS's gradients at the start: "
        f"{p46['pooled_nuts']['grad_bits_differ']} of "
        f"{p46['pooled_nuts']['grad_values']} values differ between the "
        f"whole batch and its shards, potentials "
        f"{p46['pooled_nuts']['potential_bits_differ']}; tuned ε relative "
        f"gap {p46['pooled_nuts']['eps_rel_gap']:.3g}, M⁻¹ "
        f"{p46['pooled_nuts']['imm_rel_gap']:.3g}; the first "
        f"{POOLED_MESH_DRAWS} draws agree chain by chain (equal decisions, "
        f"|Δq| ≤ {POOLED_MESH_QTOL}) on "
        f"{min(p46['pooled_nuts']['draw_shares']):.4%} or more, max |q| err "
        f"{p46['pooled_nuts']['draws_max_abs_err']:.3g}; one XLA NUTS step "
        f"from the tuned state: decisions equal on "
        f"{p46['pooled_nuts']['step_share']:.4%}, max |q| err "
        f"{p46['pooled_nuts']['step_max_abs_err']:.3g}; the runs' means "
        f"{p46['pooled_nuts']['max_z']:.2f} combined MCSE apart [{card}]")
    record["phase46"] = p46

    # ---- phase 47: phase 45 on distinct cards
    count = torch.cuda.device_count()
    if count < 2:
        log(f"phase 47: did not run: {count} CUDA device; a mesh of "
            "distinct cards needs two or more")
        record["phase47"] = dict(ran=False, devices=count)
    else:
        # the most cards the chains split over evenly
        n = max(k for k in range(1, count + 1) if CHAINS % k == 0)
        mesh = make_mesh(n)
        base, wall0, _ = mesh_run(torch, ops, nuts, None)
        res, wall, launches = mesh_run(torch, ops, nuts, mesh)
        results_equal(base, res, f"NUTS front door on {mesh.size} cards")
        log(f"phase 47: fused NUTS front door on {mesh.size} cards equal to "
            f"the unsharded run bit for bit; wall {wall:.3f} s against "
            f"{wall0:.3f} s [{card}]")
        record["phase47"] = dict(ran=True, devices=mesh.size, wall_s=wall,
                                 unsharded_wall_s=wall0, launches=launches)
        del base, res
    sharded_launches.update(
        nuts_transition=p45["four_shards"]["launches"]["nuts_transition"],
        nuts_sampling=p45["four_shards"]["launches"]["nuts_sampling"])
    return sharded_launches


# phases 48-50: the potential compiler's op table (ROADMAP.md item 1.10c):
# four potentials that need the new node kinds, each a plain torch logprob
# bound through the generic fused binding (the CPU tests hold the same four
# against JAX twins: tests/test_torch_generic_ops.py), data made from a seed
# with numpy.  P1 mvn25_chol: models.correlated_mvn(25, 0.5), a triangular
# solve (BASELINE.md config 3 at its full width); P2 hier_negbin: a
# varying-intercept negative-binomial regression at the radon study's sizes
# (919 observations, 85 counties, non-centred: dim 89), gathers by county
# and their scatter-add, lgamma and digamma; P3 mixture4: four Gaussians in
# 2-d over 1,000 points, softmax weights (dim 12), logsumexp and
# log_softmax; P4 probit100: probit regression on the flagship's 1,000 x
# 100 design through log_ndtr.  Phase 48 holds kernels 1, 3, 5 and 7 on
# each generated functor against their plain versions (the same plain cores
# on generic_pg.run_plain), each gradient against float64 autograd, P1's
# kernel 1 against phase 37's precision-form functor, and times them;
# phase 49 runs P1 through the fused NUTS, ChEES and MEADS front doors,
# each twice; phase 50 runs P2 through the fused NUTS front door and the
# pooled XLA route, whose torch.func gradient is independent of the
# compiler.
OPS_SEED = 4848
# name: (dim, chains, ε, diagonal M⁻¹, K) of phase 48's kernel checks
OPS_CELLS = {"mvn25_chol": (25, 10_240, 0.5, 1.0, 6),
             "hier_negbin": (89, 4_096, 0.02, 1.0, 6),
             "mixture4": (12, 4_096, 0.03, 1.0, 6),
             "probit100": (DIM, 10_240, 0.15, 1.0, 6)}
OPS_GRAD_CHAINS = 256           # phase 48: chains held against float64
GRAD_LOOP_CHAINS = 32           # ... where vmap refuses the potential
# phases 48 and 51: kernels 2 and 6 where a potential's front doors launch
# them (phases 49-50, 52), held to kernels 1 and 5 over a few draws
OPS_SAMPLING = {"mvn25_chol": (2, 6), "hier_negbin": (2,)}
OPS_SAMPLING_DRAWS = 4
NEGBIN_OBS, NEGBIN_GROUPS = 919, 85
MIXTURE_POINTS = 1000
OPS_DOOR_CHAINS = 10_240         # phase 49: the ChEES and MEADS doors
# phase 49's MEADS door samples 6,000 draws: MEADS (a one-step sampler)
# keeps P1's draws autocorrelated over 37-51 draws, so R-hat falls below
# RHAT_MAX only past about 4,000 (1.0704 at 500, 1.0087 at 4,000)
P1_MEADS_DRAWS = 6000
NEGBIN_CHAINS, NEGBIN_POOLED_CHAINS = 4096, 512  # phase 50
NEGBIN_WARMUP, NEGBIN_DRAWS, NEGBIN_K, NEGBIN_EPS0 = 300, 300, 8, 0.05
# the pooled XLA route is host-bound, and a batch walks its deepest tree,
# so a transition of 512 chains costs 2^K leaves of about 6 ms on an H100
# host; its depth is cut to 3 and its run to 100 + 100 (K 4 and 100 + 200
# before) to keep phases 48-50 within 90 s
NEGBIN_POOLED_WARMUP, NEGBIN_POOLED_DRAWS, NEGBIN_POOLED_K = 100, 100, 3


def negbin_data(num_obs=NEGBIN_OBS, num_groups=NEGBIN_GROUPS, seed=0):
    """County (int64), covariate (float32) and counts (int64) of P2."""
    rng = np.random.default_rng(seed)
    group = rng.integers(0, num_groups, num_obs)
    x = rng.standard_normal(num_obs).astype(np.float32)
    z = rng.standard_normal(num_groups)
    eta = 1.0 + 0.5 * z[group] + 0.4 * x
    phi = 5.0
    y = rng.negative_binomial(phi, phi / (phi + np.exp(eta)))
    return group.astype(np.int64), x, y.astype(np.int64)


def hier_negbin(torch, group, x, y, num_groups, device,
                log_phi_prior=(1.0, 1.0)):
    """P2's log p of (z (G), mu, log_sd, b, log_phi): county intercepts mu
    + exp(log_sd) z gathered by county, NB(y | exp(eta), phi) without its
    constant lgamma(y + 1).  log_phi ~ N(1, 1) keeps phi moderate: near phi
    = 1e6 lgamma(y + phi) - lgamma(phi) is float32 rounding noise
    (``log_phi_prior``: its mean and sd; fault G's probe takes (0, 2))."""
    g, xt, yt = (torch.as_tensor(a, device=device) for a in (group, x, y))
    G = num_groups
    phi_mean, phi_sd = log_phi_prior

    def logprob_fn(q):
        z, mu, log_sd, b, log_phi = q[:G], q[G], q[G + 1], q[G + 2], q[G + 3]
        phi = torch.exp(log_phi)
        eta = mu + torch.exp(log_sd) * z[g] + b * xt
        log_denom = torch.logaddexp(log_phi, eta)
        ll = torch.sum(torch.lgamma(yt + phi) - torch.lgamma(phi)
                       + phi * (log_phi - log_denom)
                       + yt * (eta - log_denom))
        return ll - 0.5 * torch.sum(z * z) - 0.5 * (mu / 5.0) ** 2 \
            - 0.5 * log_sd ** 2 - 0.5 * (b / 2.0) ** 2 \
            - 0.5 * ((log_phi - phi_mean) / phi_sd) ** 2

    return logprob_fn


def mixture_data(num_points=MIXTURE_POINTS, seed=0):
    rng = np.random.default_rng(seed)
    centers = 2.5 * np.array([[-1, -1], [1, -1], [-1, 1], [1, 1]], float)
    labels = rng.choice(4, num_points, p=[0.1, 0.2, 0.3, 0.4])
    return (centers[labels] + rng.standard_normal((num_points, 2))).astype(
        np.float32)


def mixture4(torch, points, device):
    """P3's log p of 8 means then 4 logits: unit-variance components."""
    P = torch.as_tensor(points, device=device)

    def logprob_fn(q):
        mus, logits = q[:8].reshape(4, 2), q[8:12]
        d = P[:, None, :] - mus[None, :, :]
        ll = torch.logsumexp(torch.log_softmax(logits, 0)
                             - 0.5 * torch.sum(d * d, -1), 1)
        return torch.sum(ll) - 0.5 * torch.sum(mus * mus) / 9.0 \
            - 0.5 * torch.sum(logits * logits)

    return logprob_fn


def probit(torch, X, y):
    """P4's log p: y log Φ(Xq) + (1 - y) log Φ(-Xq), N(0, 1) prior."""

    def logprob_fn(q):
        z = X @ q
        return torch.sum(y * torch.special.log_ndtr(z)
                         + (1.0 - y) * torch.special.log_ndtr(-z)) \
            - 0.5 * torch.sum(q * q)

    return logprob_fn


def op_table_potentials(torch, dev):
    """P1-P4: their logprobs, float64 twins (autograd's reference), bindings
    (the front door's potential_t and data rows) and generated functors."""
    import aehmc_tpu_torch.api as api
    from aehmc_tpu_torch.models import correlated_mvn
    from aehmc_tpu_torch.models.regression import logistic_regression_data
    from aehmc_tpu_torch.ops import generic_pg

    group, x, y = negbin_data()
    pts = mixture_data()
    X, yl = logistic_regression_data(DIM, POINTS, device=dev)
    lps = {
        "mvn25_chol": correlated_mvn(GEN_MVN_DIM, GEN_MVN_RHO, device=dev),
        "hier_negbin": hier_negbin(torch, group, x, y, NEGBIN_GROUPS, dev),
        "mixture4": mixture4(torch, pts, dev),
        "probit100": probit(torch, X, yl),
    }
    out = {}
    for name, lp in lps.items():
        dim = OPS_CELLS[name][0]
        pot, rows = api._generic_fused_binding(lp, dim, dev)
        out[name] = dict(lp=lp, pot=pot, rows=tuple(rows),
                         bound=generic_pg.bind(pot, rows, dim, device=dev))
    # float64 twins on the same values (P1: the float32 factor's rows)
    rows1 = out["mvn25_chol"]["rows"]
    by = {r.shape[1]: r for r in rows1}
    d = GEN_MVN_DIM
    loc, chol, const = (by[d].reshape(d).double(),
                        by[d * d].reshape(d, d).double(), by[1].double())

    def mvn64(q):
        z = torch.linalg.solve_triangular(chol, (q - loc)[:, None],
                                          upper=False)[:, 0]
        return const.reshape(()) - 0.5 * torch.dot(z, z)

    twins = {"mvn25_chol": mvn64,
             "hier_negbin": hier_negbin(torch, group, x.astype(np.float64),
                                        y, NEGBIN_GROUPS, dev),
             "mixture4": mixture4(torch, pts.astype(np.float64), dev),
             "probit100": probit(torch, X.double(), yl.double())}
    for name, f in twins.items():
        out[name]["lp64"] = f
    return out


def ir_flop(ir, sweeps=None, work=None):
    """Operations of one gradient of a generated functor, from its IR: an
    elementwise node one an element, a sum, product, maximum or index of a
    maximum one an input element, a matrix product 2mkn, a triangular solve
    n² a right side, an LU solve 2n³/3 and 2n² a right side, a scatter-add
    and a cumulative sum one an element; a Cholesky factor n³/3, a
    log-determinant its LU's 2n³/3, a cyclic Jacobi ``sweeps`` × n(n-1)/2
    rotations × 6n, a sort its comparisons (n² a line up to 32 elements,
    the bitonic network's beyond), a reducing or permuting scatter one an
    input element; an LU factor 2n³/3, its P n², a reduced QR 4mn² -
    4n³/3 (geqrf's and orgqr's), a one-sided Jacobi SVD ``work``'s sweeps
    × n(n-1)/2 pairs × (12m + 6n), a matrix exponential ``work``'s
    products × 2n³ (its linear combinations' n² terms left out)."""
    work = work or {}
    flop = 0
    for n in ir.nodes:
        size = math.prod(n.shape)
        if n.op in ("q", "data", "const", "reshape", "permute", "expand",
                    "slice", "select", "flip", "gather", "take",
                    "diagonal"):
            continue
        if n.op == "lufactor":
            flop += n.shape[0] * 2 * n.shape[-1] ** 3 // 3
            continue
        if n.op == "lu_p":
            flop += size
            continue
        if n.op == "qr":
            b, m, k = ir.nodes[n.args[0]].shape
            flop += b * (4 * m * k * k - 4 * k ** 3 // 3)
            continue
        if n.op == "svd":
            b, m, k = ir.nodes[n.args[0]].shape
            flop += int(b * work.get("svd_sweeps", SVD_SWEEPS)
                        * k * (k - 1) // 2 * (12 * m + 6 * k))
            continue
        if n.op == "mexp":
            b, m, _ = n.shape
            flop += int(b * work.get("mexp_products", 5) * 2 * m ** 3)
            continue
        if n.op in ("scatter_put", "scatter_reduce_chain"):
            flop += math.prod(ir.nodes[n.args[2]].shape)
            continue
        if n.op == "chol":
            flop += n.shape[0] * n.shape[1] ** 3 // 3
            continue
        if n.op == "slogdet":
            flop += n.shape[0] * 2 * ir.nodes[n.args[0]].shape[-1] ** 3 // 3
            continue
        if n.op == "eigh":
            m = n.shape[-1]
            flop += int(n.shape[0] * (JACOBI_SWEEPS if sweeps is None else
                                      sweeps) * m * (m - 1) // 2 * 6 * m)
            continue
        if n.op == "sortidx":
            src = ir.nodes[n.args[0]].shape
            length = src[n.params[0]]
            lines = math.prod(src) // length
            if length <= 32:
                flop += lines * length * length
            else:
                width = 1 << (length - 1).bit_length()
                stages = width.bit_length() - 1
                flop += lines * width // 2 * stages * (stages + 1) // 2
            continue
        if n.op in ("scatter_perm", "scatter_reduce"):
            flop += math.prod(ir.nodes[n.args[2]].shape)
            continue
        if n.op == "prod":
            flop += math.prod(ir.nodes[n.args[0]].shape)
            continue
        if n.op == "mm":
            (m, k), (_, cols) = ir.nodes[n.args[0]].shape, ir.nodes[
                n.args[1]].shape
            flop += 2 * m * k * cols
        elif n.op in ("sum", "amax"):
            flop += math.prod(ir.nodes[n.args[0]].shape)
        elif n.op == "trsolve":
            batch, rows, cols = n.shape
            flop += batch * cols * rows * rows
        elif n.op == "scatter_add":
            flop += math.prod(ir.nodes[n.args[2]].shape)
        elif n.op == "lusolve":  # LU (2n³/3) and two substitutions (2n²k)
            batch, rows, cols = n.shape
            flop += batch * (2 * rows ** 3 // 3 + 2 * rows * rows * cols)
        elif n.op == "argmax":
            flop += math.prod(ir.nodes[n.args[0]].shape)
        else:
            flop += size
    return flop


def grad_vs_float64(torch, lp64, q_t, g_kernel, g_plain):
    """max |g - g64| / max |g64| of the kernel's and the plain float32
    gradients at the first OPS_GRAD_CHAINS columns of ``q_t (dim, C)``, g64
    float64 autograd of the twin (vmapped, functionalized: vmap refuses an
    in-place write; log_ndtr has no batching rule, so the columns are
    few)."""
    from aehmc_tpu_torch.ops.generic_pg import no_validation

    n = OPS_GRAD_CHAINS
    q_t, g_kernel, g_plain = q_t[:, :n], g_kernel[:, :n], g_plain[:, :n]
    grad = torch.func.vmap(torch.func.grad(torch.func.functionalize(
        lambda q: -lp64(q))), in_dims=1, out_dims=1)
    try:
        with no_validation():  # torch.distributions' host checks under vmap
            g64 = grad(q_t.double())
    except RuntimeError:  # a write under a bool mask, which vmap refuses:
        n = min(GRAD_LOOP_CHAINS, q_t.shape[1])  # fewer, one at a time
        q_t, g_kernel, g_plain = q_t[:, :n], g_kernel[:, :n], g_plain[:, :n]
        one = torch.func.grad(lambda q: -lp64(q))
        with no_validation():
            g64 = torch.stack([one(q_t[:, c].double()) for c in range(n)], 1)
    scale = float(g64.abs().max())
    return (float((g_kernel.double() - g64).abs().max()) / scale,
            float((g_plain.double() - g64).abs().max()) / scale)


def nuts_sampling_by_draws(torch, nfs, state, imm, eps, rows, k, seed,
                           draws, gkw, what):
    """Kernel 2 over ``draws`` draws from ``state`` equal to as many
    launches of kernel 1 bit for bit (kernel 1 is held against its plain
    version on the same functor).  Returns the gradients it evaluated."""
    from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE
    from aehmc_tpu_torch.ops.philox import MASK32

    pos, stats, *final = nfs.nuts_sampling_cuda(*state, imm, eps, rows, seed,
                                                 draws, max_exp=k, **gkw)
    st = state
    for t in range(draws):
        key = (seed + t * DRAW_SEED_STRIDE) & MASK32
        *st, s_t = nfs.nuts_transition_cuda(*st, imm, eps, rows, max_exp=k,
                                            seed=key, **gkw)
        check(torch.equal(s_t, stats[t]) and torch.equal(st[0], pos[t]),
              f"{what}: kernel 2 draw {t} differs from kernel 1")
    check(all(torch.equal(a, b) for a, b in zip(final, st)),
          f"{what}: kernel 2's final state differs from kernel 1's")
    return float(stats[:, 3].sum())


def op_kernel_phase(torch, pots, gen, record, card, phase=48,
                    cells=None, sampling=None, starts=None):
    """Phase 48 (51): kernels 1, 3, 5 and 7 on P1-P4's (R1-R3's) generated
    functors against their plain versions, timed beside their bounds; and
    kernels 2 and 6 (``sampling``: the kernels a potential's front doors
    launch) against kernels 1 and 5 draw by draw, timed beside theirs.  The
    state is 0.1·N(0, 1), plus ``starts[name]`` where given."""
    cells = OPS_CELLS if cells is None else cells
    starts = {} if starts is None else starts
    sampling = OPS_SAMPLING if sampling is None else sampling
    from aehmc_tpu_torch.ops import _build, generic_pg
    from aehmc_tpu_torch.ops import chees_fused as cf
    from aehmc_tpu_torch.ops import ghmc_fused as gf
    from aehmc_tpu_torch.ops import nuts_fused as nf
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.timing import kernel_ms

    dev = torch.device(DEVICE)
    out = {}
    t_phase = time.perf_counter()
    for name, p in pots.items():
        dim, chains, eps, imm_v, k = cells[name]
        b, rows = p["bound"], p["rows"]
        ops_b = b.operands(rows, dev)
        rng = np.random.default_rng(OPS_SEED)
        q = 0.1 * rng.standard_normal((dim, chains))
        if name in starts:
            q += np.asarray(starts[name], np.float64)[:, None]
        q_t = torch.tensor(q, dtype=torch.float32, device=dev)
        sweeps = eigh_sweeps(torch, b.ir, q_t, ops_b)  # 0 without eigh
        work = factor_work(torch, b.ir, q_t, ops_b)   # {} without mexp, svd
        flop = ir_flop(b.ir, sweeps, work)

        def plain_pg(x):
            return generic_pg.run_plain(b.ir, x, ops_b)

        u0, g0 = plain_pg(q_t)
        imm = torch.full((dim,), imm_v, device=dev)
        gkw = dict(potential_and_grad_t=None, potential_fn_t=p["pot"])
        seed = OPS_SEED + 1

        # kernel 1
        def k1():
            return nfs.nuts_transition_cuda(q_t, u0, g0, imm, eps, rows,
                                            max_exp=k, seed=seed, **gkw)

        def p1():
            return nfs.nuts_transition_plain(q_t, u0, g0, imm, eps, plain_pg,
                                             max_exp=k, seed=seed)

        o1, o1p = k1(), p1()
        torch.cuda.synchronize()
        r1 = compare(o1, o1p, f"{name}: generated kernel 1 vs plain")
        moved = (o1[0] != q_t).any(dim=0)
        g_pl = plain_pg(o1[0][:, moved])[1]
        gerr = grad_vs_float64(torch, p["lp64"], o1[0][:, moved],
                               o1[2][:, moved], g_pl)
        check(gerr[0] <= max(GRAD_ERR_RATIO * gerr[1], GEN_GRAD_RTOL),
              f"{name}: kernel 1's gradient {gerr[0]:.3g} from float64, the "
              f"plain float32 one's {gerr[1]:.3g}")
        leaves1 = float(o1[3][3].sum())
        moved_bytes = nbytes(*ops_b)
        b1 = bound(leaves1 * flop, nbytes(q_t, u0, g0, imm, *o1)
                   + moved_bytes, PEAK_F32)
        t1 = (kernel_ms(k1, 3), cuda_ms(torch, p1, 1, warm=False))

        # kernel 3: the standard layout, the same functor
        q_s, u_s, g_s = q_t.T.contiguous(), u0.reshape(-1, 1), g0.T.contiguous()

        def plain_pg3(x):
            uu, gg = plain_pg(x.T.contiguous())
            return uu.reshape(-1, 1), gg.T

        def k3():
            return nf.nuts_transition_std_cuda(
                q_s, u_s, g_s, imm, eps, rows, max_exp=k, seed=seed,
                bound=b)

        def p3():
            return nf.nuts_transition_std_plain(q_s, u_s, g_s, imm, eps,
                                                plain_pg3, max_exp=k,
                                                seed=seed)

        o3, o3p = k3(), p3()
        torch.cuda.synchronize()
        tr = lambda o: tuple(None if x is None else x.T for x in o)  # noqa
        r3 = compare(tr(o3), tr(o3p), f"{name}: generated kernel 3 vs plain")
        leaves3 = float(o3[3][:, 3].sum())
        b3 = bound(leaves3 * flop, nbytes(q_s, u_s, g_s, imm, *o3)
                   + moved_bytes, PEAK_F32)
        t3 = (kernel_ms(k3, 3), cuda_ms(torch, p3, 1, warm=False))

        # kernel 5 (MALA's α 0, one leapfrog step) and kernel 7 (L 10)
        p0 = torch.tensor(rng.standard_normal((dim, chains)),
                          dtype=torch.float32, device=dev)
        state = (q_t, u0, g0, p0)

        def k5():
            return gf.ghmc_transition_cuda(*state, eps, 0.0, imm, rows,
                                           seed=seed, **gkw)

        def p5():
            return gf.ghmc_transition_plain(*state, eps, 0.0, imm, plain_pg,
                                            seed=seed)

        o5, o5p = k5(), p5()
        torch.cuda.synchronize()
        r5 = hmc_hold(torch, q_t, o5, o5p, f"{name}: generated kernel 5 vs "
                      "plain")
        b5 = bound(chains * flop, nbytes(*state, imm, *o5) + moved_bytes,
                   PEAK_F32)
        t5 = (kernel_ms(k5, HMC_TIMED_REPS), cuda_ms(torch, p5, 3))
        cstate = (q_s, u0.reshape(-1), g_s)
        steps = torch.full((), LEAPFROG_STEPS, dtype=torch.int32, device=dev)

        def k7():
            return cf.chees_transition_cuda(*cstate, imm, eps, steps, rows,
                                            seed=seed, **gkw)

        def p7():
            return cf.chees_transition_plain(*cstate, imm, eps,
                                             LEAPFROG_STEPS, plain_pg,
                                             seed=seed)

        o7, o7p = k7(), p7()
        torch.cuda.synchronize()
        r7 = chees_compare(torch, q_s, o7, o7p, f"{name}: generated kernel 7 "
                           "vs plain")
        b7 = bound(LEAPFROG_STEPS * chains * flop,
                   nbytes(*cstate, imm, *o7) + moved_bytes, PEAK_F32)
        t7 = (kernel_ms(k7, 3), cuda_ms(torch, p7, 1, warm=False))
        # kernels 2 and 6, where this potential's front doors launch them
        extra = {}
        if 2 in sampling.get(name, ()):
            state1 = (q_t, u0, g0)
            leaves2 = nuts_sampling_by_draws(
                torch, nfs, state1, imm, eps, rows, k, seed + 7,
                OPS_SAMPLING_DRAWS, gkw, f"{name}: generated")
            t2 = cuda_ms(torch, lambda: nfs.nuts_sampling_cuda(
                *state1, imm, eps, rows, seed + 7, OPS_SAMPLING_DRAWS,
                max_exp=k, **gkw), 1)
            b2 = bound(leaves2 * flop, nbytes(*state1, imm) * 2 + moved_bytes
                       + OPS_SAMPLING_DRAWS * nbytes(q_t), PEAK_F32)
            extra["nuts_sampling"] = dict(
                draws=OPS_SAMPLING_DRAWS, ms=t2, bound_ms=b2[0],
                bound_by=b2[1], gradients=leaves2, equal_to_kernel_1=True)
        if 6 in sampling.get(name, ()):
            args6 = (eps, GHMC_ALPHA, imm)
            r6 = segment_by_draws(torch, gf, state, args6, rows, gkw,
                                  plain_pg, seed + 8, OPS_SAMPLING_DRAWS,
                                  f"{name}: generated")
            t6 = cuda_ms(torch, lambda: gf.ghmc_segment_cuda(
                *state, *args6, rows, OPS_SAMPLING_DRAWS, seed=seed + 8,
                **gkw), 3)
            b6 = bound(OPS_SAMPLING_DRAWS * chains * flop,
                       nbytes(*state, imm) * 2 + moved_bytes
                       + OPS_SAMPLING_DRAWS * nbytes(q_t), PEAK_F32)
            extra["ghmc_segment"] = dict(
                draws=OPS_SAMPLING_DRAWS, ms=t6, bound_ms=b6[0],
                bound_by=b6[1], gradients=OPS_SAMPLING_DRAWS * chains,
                share=r6[0], max_abs_err=r6[1])
        nuts_rep = functor_report(torch, _build, b, dim, chains, k)
        hmc_rep = hmc_report(torch, _build, b, dim, chains,
                             f"{name}'s generated functor")
        res = dict(
            dim=dim, chains=chains, eps=eps, max_exp=k, ir_nodes=len(b.ir.nodes),
            node_kinds=sorted({n.op for n in b.ir.nodes}), flop_a_gradient=flop,
            jacobi_sweeps=sweeps, factor_work=work,
            grad_rel_err=gerr[0], plain_grad_rel_err=gerr[1],
            nuts_functor=nuts_rep, hmc_functor=hmc_rep,
            kernels={})
        for kname, r, bnd, t, leaves in (
                ("nuts_transition", r1, b1, t1, leaves1),
                ("nuts_transition_std", r3, b3, t3, leaves3),
                ("ghmc_transition", r5, b5, t5, chains),
                ("chees_transition", r7, b7, t7,
                 LEAPFROG_STEPS * chains)):
            res["kernels"][kname] = dict(
                share=r[0], max_abs_err=r[1], differ=r[2], ms=t[0],
                plain_ms=t[1], bound_ms=bnd[0], bound_by=bnd[1],
                gradients=leaves)
        res["sampling"] = extra
        out[name] = res
        del o1, o1p, o3, o3p, o5, o5p, o7, o7p
        log(f"phase {phase}: {name} (dim {dim}, {chains} chains, ε {eps}, "
            f"K {k}; "
            f"IR {len(b.ir.nodes)} nodes of {', '.join(res['node_kinds'])}; "
            f"{flop} operations a gradient; workspace {b.workspace} floats a "
            f"chain, {'shared' if nuts_rep['workspace_shared'] else 'global'}"
            f"): decisions equal vs plain, kernels 1 / 3 / 5 / 7: "
            + " / ".join(f"{v['share']:.4%}" for v in res["kernels"].values())
            + " (max |q| err "
            + " / ".join(f"{v['max_abs_err']:.3g}"
                         for v in res["kernels"].values())
            + f"); gradient {gerr[0]:.3g} from float64 (plain float32 "
            f"{gerr[1]:.3g}); ms kernel / plain / bound: "
            + ", ".join(f"{kn} {v['ms']:.4f} / {v['plain_ms']:.3f} / "
                        f"{v['bound_ms']:.5f} ({v['bound_by']})"
                        for kn, v in res["kernels"].items())
            + f"; ptxas kernels 1-4 {nuts_rep['registers']} registers, "
            f"{nuts_rep['spill_bytes']} B spills, stack frames up to "
            f"{nuts_rep['stack_frame_bytes']} B, blocks per SM "
            f"{nuts_rep['blocks_per_sm']}; library built in "
            + (f"{nuts_rep['build_s']:.1f} s" if nuts_rep['build_s']
               else "(not built here)")
            + "; kernels 5-7 registers "
            f"{hmc_rep['registers']}, spills {hmc_rep['spill_bytes']}, "
            f"blocks per SM {hmc_rep['blocks_per_sm']}"
            + "".join(f"; {kn} over {v['draws']} draws (equal to kernel "
                      f"{1 if kn == 'nuts_sampling' else 5} draw by draw) "
                      f"{v['ms']:.4f} ms / bound {v['bound_ms']:.5f} "
                      f"({v['bound_by']})" for kn, v in extra.items())
            + f" [{card}]")

    if "mvn25_chol" not in pots:
        wall = time.perf_counter() - t_phase
        log(f"phase {phase} in {wall:.1f} s [{card}]")
        record[f"phase{phase}"] = dict(wall_s=wall, **out)
        return out

    # P1's kernel 1 against phase 37's precision-form functor on one state
    b1, rows1 = pots["mvn25_chol"]["bound"], pots["mvn25_chol"]["rows"]
    dim, chains, eps, imm_v, k = OPS_CELLS["mvn25_chol"]
    rng = np.random.default_rng(OPS_SEED + 2)
    q_t = torch.tensor(rng.standard_normal((dim, chains)),
                       dtype=torch.float32, device=dev)
    imm = torch.full((dim,), imm_v, device=dev)
    ops1 = b1.operands(rows1, dev)
    u_c, g_c = generic_pg.run_plain(b1.ir, q_t, ops1)
    bm = gen["binds"]["mvn"]
    u_p, g_p = generic_pg.run_plain(bm.ir, q_t,
                                    bm.operands((gen["prec"],), dev))
    chol_k = nfs.nuts_transition_cuda(
        q_t, u_c, g_c, imm, eps, rows1, max_exp=k, seed=OPS_SEED + 3,
        potential_and_grad_t=None, potential_fn_t=pots["mvn25_chol"]["pot"])
    prec_k = nfs.nuts_transition_cuda(
        q_t, u_p, g_p, imm, eps, (gen["prec"],), max_exp=k,
        seed=OPS_SEED + 3, potential_and_grad_t=None,
        potential_fn_t=gen["mvn_t"])
    torch.cuda.synchronize()
    offset = float((u_c - u_p).mean())  # the normalising constant
    shifted = chol_k[3].clone()
    shifted[0] -= offset
    r_vs = compare((chol_k[0], None, None, shifted),
                   (prec_k[0], None, None, prec_k[3]),
                   "mvn25_chol kernel 1 vs the precision-form functor")
    out["mvn25_chol"]["vs_precision_form"] = dict(
        share=r_vs[0], max_abs_err=r_vs[1], differ=r_vs[2],
        constant=offset)
    wall = time.perf_counter() - t_phase
    log(f"phase 48: mvn25_chol kernel 1 vs phase 37's precision-form functor "
        f"on one state ({chains} chains, energies less the normalising "
        f"constant {offset:.4f}): decisions equal on {r_vs[0]:.4%}, max |q| "
        f"err {r_vs[1]:.3g}; phase 48 in {wall:.1f} s [{card}]")
    record["phase48"] = dict(wall_s=wall, **out)
    return out


def max_rhat(torch, diagnostics, x):
    """The largest rank-normalized split R-hat over the dimensions of ``x
    (chains, draws, dim)``, five dimensions at a time."""
    return float(chunked(torch, lambda v: diagnostics.potential_scale_reduction(
        v, rank_normalized=True), x, 5).max())


def mvn_door_limits(torch, diagnostics, res, what, accept_range):
    """Phase 49's gates on a P1 front-door run: acceptance, divergences,
    R-hat below RHAT_MAX, each mean within MCSE_Z MCSE of 0 and each
    variance within GEN_MVN_RATIO_TOL of 1."""
    x = res.positions.float().transpose(0, 1)  # (chains, draws, dim)
    mean, mcse = mean_mcse(torch, diagnostics, x)
    var = x.reshape(-1, x.shape[2]).var(dim=0)
    diag = res.diagnostics
    out = dict(accept=float(diag.acceptance_probability.mean()),
               divergent_share=float(diag.is_diverging.float().mean()),
               max_rhat=max_rhat(torch, diagnostics, x),
               max_mean_z=float((mean.abs() / mcse).max()),
               max_var_err=float((var - 1.0).abs().max()),
               finite=bool(torch.isfinite(x).all()))
    check(accept_range[0] <= out["accept"] <= accept_range[1],
          f"{what}: mean acceptance {out['accept']}")
    check(out["divergent_share"] < 1e-4,
          f"{what}: divergent share {out['divergent_share']}")
    check(out["max_rhat"] < RHAT_MAX, f"{what}: max R-hat {out['max_rhat']}")
    check(out["max_mean_z"] < MCSE_Z, f"{what}: a mean is "
          f"{out['max_mean_z']} MCSE from 0")
    check(out["max_var_err"] <= GEN_MVN_RATIO_TOL, f"{what}: a variance is "
          f"{out['max_var_err']} from 1")
    check(out["finite"], f"{what}: non-finite draws")
    return out


def op_mvn_doors(torch, ops, diagnostics, pots, record, card):
    """Phase 49: P1 (models.correlated_mvn(25, 0.5), a bare logprob) through
    the fused NUTS (dense M⁻¹, phase 37's adaptive cell), ChEES, MEADS and
    checkpointed MEADS (kernel 5 a draw) front doors, each twice with one
    seed."""
    import tempfile

    import aehmc_tpu_torch

    lp = pots["mvn25_chol"]["lp"]
    dev = torch.device(DEVICE)
    a = GEN_MVN_ADAPT
    q_n = torch.tensor(np.random.default_rng(49).standard_normal(
        (a["chains"], GEN_MVN_DIM)), dtype=torch.float32, device=dev)
    q_h = torch.tensor(np.random.default_rng(50).standard_normal(
        (OPS_DOOR_CHAINS, GEN_MVN_DIM)), dtype=torch.float32, device=dev)
    t_phase = time.perf_counter()
    out = {}
    runs = (
        ("NUTS", lambda: aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(4901), lp, q_n, a["draws"],
            a["warmup"], algorithm="nuts", path="fused",
            max_num_expansions=a["k"], is_mass_matrix_full=True,
            initial_step_size=a["eps0"]), (0.7, 0.9)),
        ("ChEES", lambda: aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(4902), lp, q_h, DRAWS, WARMUP,
            algorithm="chees", path="fused", initial_step_size=CHEES_EPS0),
         CHEES_ACCEPT),
        ("MEADS", lambda: aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(4903), lp, q_h, P1_MEADS_DRAWS,
            MEADS_WARMUP, algorithm="meads", path="fused",
            meads_recompute_every=MEADS_EVERY), (MEADS_ACCEPT_MIN, 1.0)),
    )
    for what, run, accept_range in runs:
        res, wall, wall_b, launches = door_twice(
            torch, ops, run, f"mvn25_chol {what} front door")
        if what == "NUTS":
            want = {"nuts_transition_generic": a["warmup"],
                    "nuts_sampling_generic": 1}
        elif what == "ChEES":
            probes = launches.get("chees_transition_generic", 0) - (
                WARMUP + DRAWS)
            check(1 <= probes <= 32, f"mvn25_chol ChEES launches {launches}")
            want = {"chees_transition_generic": WARMUP + DRAWS + probes}
        else:
            want = {"ghmc_segment_generic": -(-MEADS_WARMUP // MEADS_EVERY)
                    + -(-P1_MEADS_DRAWS // MEADS_EVERY)}
        check(launches == want, f"mvn25_chol {what} front door: launches "
              f"{launches}, want {want}")
        lim = mvn_door_limits(torch, diagnostics, res,
                              f"mvn25_chol {what} front door", accept_range)
        extra = {}
        if what == "NUTS":
            imm_a = res.inverse_mass_matrix
            off = ~torch.eye(GEN_MVN_DIM, dtype=torch.bool, device=dev)
            ratio = float(imm_a[off].mean() / torch.diagonal(imm_a).mean())
            check(abs(ratio - GEN_MVN_RHO) <= GEN_MVN_RATIO_TOL,
                  f"mvn25_chol NUTS: tuned M⁻¹ off-diagonal/diagonal {ratio}")
            extra = dict(offdiag_ratio=ratio)
        out[what] = dict(wall_s=wall, wall_s_again=wall_b, launches=launches,
                         step_size=float(torch.as_tensor(
                             res.step_size).float().mean()), **lim, **extra)
        log(f"phase 49: mvn25_chol (models.correlated_mvn(25, 0.5), a bare "
            f"logprob) {what} front door, {res.positions.shape[1]} chains: "
            f"{wall:.2f} s (again {wall_b:.2f} s, equal bit for bit); "
            f"launches {launches}; accept {lim['accept']:.4f}, divergent "
            f"{lim['divergent_share']:.2e}, ε {out[what]['step_size']:.4f}, "
            f"{res.positions.shape[0]} draws, max R-hat {lim['max_rhat']:.4f}"
            f" (limit {RHAT_MAX}), means within "
            f"{lim['max_mean_z']:.2f} MCSE of 0, variances within "
            f"{lim['max_var_err']:.4f} of 1"
            + (f", M⁻¹ off-diagonal/diagonal {extra['offdiag_ratio']:.4f}"
               if extra else "") + f" [{card}]")
        del res
    # MEADS checkpointed: kernel 5 a draw (phase 42's cut)
    with tempfile.TemporaryDirectory() as tmp:
        paths = iter(("a", "b"))
        res, wall, wall_b, launches = door_twice(
            torch, ops, lambda: aehmc_tpu_torch.sample(
                torch.Generator().manual_seed(4904), lp, q_h, CKPT_DRAWS,
                CKPT_WARMUP, algorithm="meads", path="fused",
                meads_recompute_every=MEADS_EVERY,
                checkpoint_every=CKPT_EVERY,
                checkpoint_path=f"{tmp}/{next(paths)}.npz"),
            "mvn25_chol checkpointed MEADS front door")
    want = {"ghmc_transition_generic": CKPT_WARMUP + CKPT_DRAWS}
    check(launches == want, f"mvn25_chol checkpointed MEADS: launches "
          f"{launches}")
    check(bool(torch.isfinite(res.positions).all()),
          "mvn25_chol checkpointed MEADS: non-finite draws")
    out["MEADS checkpointed"] = dict(
        wall_s=wall, wall_s_again=wall_b, launches=launches,
        accept=float(res.diagnostics.acceptance_probability.mean()))
    log(f"phase 49: mvn25_chol checkpointed MEADS front door (kernel 5 a "
        f"draw) {OPS_DOOR_CHAINS} chains, {CKPT_WARMUP} + {CKPT_DRAWS}: "
        f"{wall:.2f} s (again {wall_b:.2f} s, equal bit for bit); launches "
        f"{launches}; accept {out['MEADS checkpointed']['accept']:.4f} "
        f"[{card}]")
    del res
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 49 in {out['wall_s']:.1f} s [{card}]")
    record["phase49"] = out
    return out


def op_negbin_doors(torch, ops, diagnostics, pots, record, card):
    """Phase 50: P2 through the fused NUTS front door (its generated
    functor: gathers, their scatter-add, lgamma, digamma) and through the
    pooled XLA route (torch.func's gradient), both from one start made
    with numpy (0.1·N(0, 1), mu at the log of the mean count); means
    within MCSE_Z combined MCSE.  With mu at 0 the first trajectories turn
    the potential's fall into momentum that throws some chains far out in
    log φ; the start near the data's scale spares the comparison that
    transient."""
    import aehmc_tpu_torch

    lp = pots["hier_negbin"]["lp"]
    dev = torch.device(DEVICE)
    dim = OPS_CELLS["hier_negbin"][0]
    _, _, counts = negbin_data()
    start = 0.1 * np.random.default_rng(51).standard_normal(
        (NEGBIN_CHAINS, dim))
    start[:, NEGBIN_GROUPS] += np.log(counts.mean())
    start = torch.tensor(start, dtype=torch.float32, device=dev)
    t_phase = time.perf_counter()
    runs = {}
    for what, path, warmup, draws, k in (
            ("fused", "fused", NEGBIN_WARMUP, NEGBIN_DRAWS, NEGBIN_K),
            ("pooled", "pooled", NEGBIN_POOLED_WARMUP, NEGBIN_POOLED_DRAWS,
             NEGBIN_POOLED_K)):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        chains = NEGBIN_CHAINS if path == "fused" else NEGBIN_POOLED_CHAINS
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(5000), lp, start[:chains], draws,
            warmup, algorithm="nuts", path=path, max_num_expansions=k,
            initial_step_size=NEGBIN_EPS0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        want = ({"nuts_transition_generic": warmup,
                 "nuts_sampling_generic": 1} if path == "fused" else {})
        check(launches == want, f"hier_negbin {what}: launches {launches}")
        x = res.positions.float().transpose(0, 1)
        check(bool(torch.isfinite(x).all()), f"hier_negbin {what}: "
              "non-finite draws")
        mean, mcse = mean_mcse(torch, diagnostics, x)
        rhat = diagnostics.potential_scale_reduction(x, rank_normalized=True)
        diag = res.diagnostics
        runs[what] = dict(
            chains=x.shape[0], warmup=warmup, draws=draws, wall_s=wall,
            launches=launches, mean=mean, mcse=mcse,
            max_rhat=float(rhat.max()),
            max_chain_mean_log_phi=float(x[:, :, -1].mean(dim=1).max()),
            accept=float(diag.acceptance_probability.float().mean()),
            divergent_share=float(diag.is_diverging.float().mean()),
            mean_doublings=float(diag.num_doublings.float().mean()),
            step_size=float(torch.as_tensor(res.step_size).float().mean()))
        del res, x
    f, p = runs["fused"], runs["pooled"]
    z = ((f["mean"] - p["mean"]).abs()
         / torch.sqrt(f["mcse"]**2 + p["mcse"]**2))
    zmax = float(z.max())
    for r in runs.values():
        r["mean"], r["mcse"] = r["mean"].tolist(), r["mcse"].tolist()
    wall = time.perf_counter() - t_phase
    record["phase50"] = dict(wall_s=wall, max_z=zmax, z=z.tolist(), **runs)
    log(f"phase 50: hier_negbin (919 observations, 85 counties, dim {dim}): "
        + "; ".join(f"{name} NUTS {r['chains']} chains {r['warmup']} + "
                    f"{r['draws']} in {r['wall_s']:.2f} s (launches "
                    f"{r['launches']}, accept {r['accept']:.4f}, divergent "
                    f"{r['divergent_share']:.2e}, ε {r['step_size']:.4f}, "
                    f"doublings {r['mean_doublings']:.2f}, max R-hat "
                    f"{r['max_rhat']:.4f}, largest chain mean of log φ "
                    f"{r['max_chain_mean_log_phi']:.4f})"
                    for name, r in runs.items())
        + f": means within {zmax:.2f} combined MCSE (limit {MCSE_Z}); phase "
        f"50 in {wall:.1f} s [{card}]")
    check(zmax < MCSE_Z, f"hier_negbin: the fused route's means are {zmax} "
          "combined MCSE from the pooled XLA route's")
    return runs


def op_table_fields(kernels, ops48, doors49, runs50):
    """The ``generic_ops`` fields of kernels 1, 3, 5 and 7's entries (and
    the main-path launches of kernels 2 and 6): each P's launches on this
    slice's front doors, error, times, bound, registers, spills, blocks per
    SM and workspace."""
    door = {"mvn25_chol": {
        **doors49["NUTS"]["launches"], **doors49["ChEES"]["launches"],
        **doors49["MEADS"]["launches"],
        **doors49["MEADS checkpointed"]["launches"]},
        "hier_negbin": runs50["fused"]["launches"]}
    for entry in kernels:
        name = entry["name"]
        if name in ("nuts_sampling", "ghmc_segment"):
            entry["generic_ops_launches"] = {
                p: door.get(p, {}).get(f"{name}_generic", 0) for p in ops48}
        if name not in ("nuts_transition", "nuts_transition_std",
                        "ghmc_transition", "chees_transition"):
            continue
        entry["generic_ops"] = {
            p: functor_fields(name, res, door.get(p, {}))
            for p, res in ops48.items()}


def functor_fields(name, res, launches):
    """Kernel ``name``'s record on one potential of phase 48 or 51
    (``res``): its launches on the front doors (``launches``), error,
    times, bound, registers, spills, blocks per SM and workspace."""
    hmc_index = {"ghmc_transition": 5, "chees_transition": 7}
    k = res["kernels"][name]
    if name in hmc_index:
        rep = res["hmc_functor"]
        regs = rep["registers"][hmc_index[name]]
        spill = rep["spill_bytes"][hmc_index[name]]
        per_sm = rep["blocks_per_sm"][str(hmc_index[name])]
    else:
        rep = res["nuts_functor"]
        regs, spill = rep["registers"], rep["spill_bytes"]
        per_sm = rep["blocks_per_sm"][
            "std_transition" if name.endswith("std") else "t_transition"]
    return dict(
        launches=launches.get(f"{name}_generic", 0),
        max_abs_err=k["max_abs_err"], ms=k["ms"], plain_ms=k["plain_ms"],
        bound_ms=k["bound_ms"], bound_by=k["bound_by"], registers=regs,
        spill_bytes=spill, blocks_per_sm=per_sm,
        workspace_floats=res["nuts_functor"]["workspace_floats"],
        workspace_shared=res["nuts_functor"]["workspace_shared"])


# Phases 51-53: the rest of the op table (ROADMAP item 1.10c) on three
# bare logprobs written the way users write them, data made from a seed
# with numpy (tests/test_torch_generic_ops.py holds their JAX twins).  R1
# softmax_reg: multinomial logistic regression on 1,000 points, 20 features
# and 5 classes (dim 100), labels 1..5 as R and Stan hold them, the row
# maximum by max(dim=1) and the log-likelihood read at [arange(N), y - 1];
# R2 weibull_mice: Weibull regression with right censoring after BUGS
# Examples Vol. 1 "Mice" (80 mice in 4 groups, dim 5): isnan, bool masks,
# an indexed assignment, a tensor exponent; R3 sur_solve: a seemingly
# unrelated regression, 10 equations, 200 observations, 5 regressors each
# (dim 60), through a general solve whose matrix depends on q.  Phase 51
# holds kernels 1, 3, 5 and 7 on each against their plain versions (and
# kernels 2 and 6 where a door launches them against kernels 1 and 5);
# phase 52 runs the front doors; phase 53 probes fault G and lgamma.
REST_CELLS = {"softmax_reg": (100, 10_240, 0.05, 1.0, 6),
              "weibull_mice": (5, 10_240, 0.005, 1.0, 6),
              "sur_solve": (60, 4_096, 0.02, 1.0, 6)}
REST_SAMPLING = {"softmax_reg": (2,), "weibull_mice": (2, 6),
                 "sur_solve": (2,)}
SOFTMAX_POINTS, SOFTMAX_FEATURES, SOFTMAX_CLASSES = 1000, 20, 5
MICE_GROUPS, MICE_PER_GROUP = 4, 20
SUR_EQ, SUR_OBS, SUR_REG = 10, 200, 5
# phase 52's schedules (warmup, draws).  Every run holds R-hat below
# RHAT_MAX, so each door samples past its autocorrelation: R2's NUTS and
# R3's ChEES keep τ near 6 draws (R-hat 1.0255 and 1.0240 at 200 draws,
# 1.0051 and 1.0049 at 1,000), R2's MEADS near 70-97 (1.142 at 500,
# 1.0083 at 8,000).  R1 is not identified along each feature's five
# weights' sum, where its posterior is the prior's (sd 1/√5) and narrow
# elsewhere: no diagonal M⁻¹ scales that direction, so with one its trees
# run 5 doublings at ε 0.097 and R-hat needs 500 draws (225 s a run of
# 10,240 chains on an H100 80GB HBM3 at 700 W); R1's doors take a dense
# M⁻¹ (3 doublings, ε 0.53, R-hat 0.998 at 200 draws), the fused and the
# pooled alike.
REST_POOLED = dict(chains=512, warmup=100, draws=200, k=4)
R2_NUTS = (150, 1000)
R2_MEADS = (MEADS_WARMUP, 8000)
R3_CHEES = (150, 1000)
# R1's fused door (phase 52) runs 4,096 chains (10,240 before: 29.7 s a
# run, twice), its pooled reference 100 warmup steps (150), and fault G's
# probe 50 + 50 (100 + 200 before, 0 chains stranded in either precision),
# to make room for phases 54-55 within chip_smoke's time limit
R1_CHAINS = 4096
FAULT_G = dict(chains=512, warmup=50, draws=50, k=4, far=10.0,
               prior=(0.0, 2.0))                          # log φ ~ N(0, 4)


def softmax_data(num_points=SOFTMAX_POINTS, num_features=SOFTMAX_FEATURES,
                 num_classes=SOFTMAX_CLASSES, seed=0):
    """R1's design (float32) and labels 1..K (int64)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((num_points, num_features)).astype(np.float32)
    W = rng.standard_normal((num_features, num_classes))
    logits = X @ W / np.sqrt(num_features)
    p = np.exp(logits - logits.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    u = rng.uniform(size=(num_points, 1))
    y = 1 + np.minimum((u > np.cumsum(p, 1)).sum(1), num_classes - 1)
    return X, y.astype(np.int64)


def softmax_reg(torch, X, y, num_classes, device):
    """R1's log p: W (features, classes) from q, N(0, 1) prior."""
    Xt, yt = torch.as_tensor(X, device=device), torch.as_tensor(y,
                                                                device=device)
    N, P = Xt.shape

    def logprob_fn(q):
        logits = Xt @ q.reshape(P, num_classes)
        m = logits.max(dim=1, keepdim=True).values
        lse = m + torch.log(torch.sum(torch.exp(logits - m), dim=1,
                                      keepdim=True))
        ll = (logits - lse)[torch.arange(N, device=device), yt - 1].sum()
        return ll - 0.5 * torch.sum(q * q)

    return logprob_fn


def weibull_data(num_groups=MICE_GROUPS, per_group=MICE_PER_GROUP, seed=0):
    """R2's group (int64), failure times (float32, NaN where censored) and
    censoring times, from S(t) = exp(-exp(beta_g) t^r), r 1.5."""
    rng = np.random.default_rng(seed)
    group = np.repeat(np.arange(num_groups), per_group)
    beta = rng.normal(-4.0, 0.5, num_groups)
    r = 1.5
    t = (-np.log(rng.uniform(size=group.size)) / np.exp(beta[group])) ** (
        1.0 / r)
    c = rng.uniform(10.0, 30.0, group.size)
    t = np.where(t > c, np.nan, t)
    return (group.astype(np.int64), t.astype(np.float32),
            c.astype(np.float32))


def weibull_mice(torch, group, t, c, num_groups, device):
    """R2's log p of (beta (G), log r): N(0, 10) and N(0, 1) priors."""
    g, tt, ct = (torch.as_tensor(a, device=device) for a in (group, t, c))
    G, M = num_groups, len(group)

    def logprob_fn(q):
        beta, log_r = q[:G], q[G]
        r = torch.exp(log_r)
        obs = ~torch.isnan(tt)
        ll = torch.zeros(M, dtype=q.dtype, device=device)
        ll[obs] = log_r + (r - 1.0) * torch.log(tt[obs]) + beta[g[obs]] \
            - torch.exp(beta[g[obs]]) * tt[obs] ** r
        ll[~obs] = -torch.exp(beta[g[~obs]]) * ct[~obs] ** r
        return ll.sum() - 0.5 * torch.sum((beta / 10.0) ** 2) \
            - 0.5 * log_r ** 2

    return logprob_fn


def sur_data(num_eq=SUR_EQ, num_obs=SUR_OBS, num_reg=SUR_REG, seed=0):
    """R3's X (N, K, p), Y (N, K) and fixed correlation Omega (K, K)."""
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((num_eq, num_eq))
    S = A @ A.T + num_eq * np.eye(num_eq)
    d = 1.0 / np.sqrt(np.diag(S))
    omega = S * d[:, None] * d[None, :]
    X = rng.standard_normal((num_obs, num_eq, num_reg))
    beta = rng.standard_normal((num_eq, num_reg))
    tau = np.exp(rng.normal(0.0, 0.3, num_eq))
    sigma = tau[:, None] * tau[None, :] * omega
    eps = rng.standard_normal((num_obs, num_eq)) @ np.linalg.cholesky(
        sigma).T
    Y = (X * beta).sum(-1) + eps
    return (X.astype(np.float32), Y.astype(np.float32),
            omega.astype(np.float32))


def sur_solve(torch, X, Y, omega, device):
    """R3's log p of (beta (K, p), log tau (K)), N(0, 1) priors."""
    Xt, Yt, Om = (torch.as_tensor(a, device=device) for a in (X, Y, omega))
    N, K, P = Xt.shape

    def logprob_fn(q):
        beta, log_tau = q[:K * P].reshape(K, P), q[K * P:]
        tau = torch.exp(log_tau)
        Sigma = tau[:, None] * tau[None, :] * Om
        R = Yt - torch.sum(Xt * beta, -1)
        return -0.5 * (R.T * torch.linalg.solve(Sigma, R.T)).sum() \
            - N * log_tau.sum() - 0.5 * torch.sum(q * q)

    return logprob_fn


def rest_potentials(torch, dev):
    """R1-R3: logprobs, float64 twins, bindings and generated functors."""
    import aehmc_tpu_torch.api as api
    from aehmc_tpu_torch.ops import generic_pg

    X, y = softmax_data()
    group, t, c = weibull_data()
    Xs, Ys, om = sur_data()
    lps = {"softmax_reg": softmax_reg(torch, X, y, SOFTMAX_CLASSES, dev),
           "weibull_mice": weibull_mice(torch, group, t, c, MICE_GROUPS,
                                        dev),
           "sur_solve": sur_solve(torch, Xs, Ys, om, dev)}
    twins = {"softmax_reg": softmax_reg(torch, X.astype(np.float64), y,
                                        SOFTMAX_CLASSES, dev),
             "weibull_mice": weibull_mice(
                 torch, group, t.astype(np.float64), c.astype(np.float64),
                 MICE_GROUPS, dev),
             "sur_solve": sur_solve(torch, *(a.astype(np.float64)
                                             for a in (Xs, Ys, om)), dev)}
    out = {}
    for name, lp in lps.items():
        dim = REST_CELLS[name][0]
        pot, rows = api._generic_fused_binding(lp, dim, dev)
        out[name] = dict(lp=lp, lp64=twins[name], pot=pot, rows=tuple(rows),
                         bound=generic_pg.bind(pot, rows, dim, device=dev))
    return out


def door_limits(torch, diagnostics, res, what, accept_range,
                rhat_max=RHAT_MAX):
    """PERF.md §2's limits on a front-door run: acceptance, divergences
    below 0.01%, R-hat below ``rhat_max`` (None: recorded only), finite
    draws.  Returns them with each coordinate's mean and MCSE."""
    x = res.positions.float().transpose(0, 1)  # (chains, draws, dim)
    check(bool(torch.isfinite(x).all()), f"{what}: non-finite draws")
    mean, mcse = mean_mcse(torch, diagnostics, x)
    diag = res.diagnostics
    out = dict(accept=float(diag.acceptance_probability.float().mean()),
               divergent_share=float(diag.is_diverging.float().mean()),
               max_rhat=max_rhat(torch, diagnostics, x),
               step_size=float(torch.as_tensor(res.step_size).float().mean()),
               chains=x.shape[0], draws=x.shape[1], mean=mean, mcse=mcse)
    log(f"  {what}: accept {out['accept']:.4f}, divergent "
        f"{out['divergent_share']:.2e}, ε {out['step_size']:.4g}, doublings "
        f"{float(diag.num_doublings.float().mean()):.2f}, max R-hat "
        f"{out['max_rhat']:.4f}")
    check(out["divergent_share"] < 1e-4,
          f"{what}: divergent share {out['divergent_share']}")
    check(accept_range[0] <= out["accept"] <= accept_range[1],
          f"{what}: mean acceptance {out['accept']}")
    check(rhat_max is None or out["max_rhat"] < rhat_max,
          f"{what}: max R-hat {out['max_rhat']}")
    return out


def agree(torch, a, b, what):
    """The largest |mean difference| over its combined MCSE; at most
    MCSE_Z."""
    z = float(((a["mean"] - b["mean"]).abs()
               / torch.sqrt(a["mcse"] ** 2 + b["mcse"] ** 2)).max())
    check(z < MCSE_Z, f"{what}: means {z} combined MCSE apart")
    return z


def rest_doors(torch, ops, diagnostics, pots, record, card):
    """Phase 52: R1 through the fused NUTS door (R1_CHAINS chains, 150 + 200,
    K 6, a dense M⁻¹) against the pooled XLA route (512 of its chains, 100
    + 200, K 4, a dense M⁻¹) from one numpy start; R2 through the fused
    NUTS and MEADS doors (10,240 chains), against each other; R3 through
    the fused ChEES door (4,096 chains) against its fused NUTS door.  R2's
    NUTS and R3's ChEES doors run twice with one seed, equal bit for bit
    (R1's NUTS and R2's MEADS, the longest, once); launches
    exact; every run within §2's limits, R-hat below RHAT_MAX."""
    import aehmc_tpu_torch

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    out = {}

    def start(name, chains, seed, scale=0.1):
        q = scale * np.random.default_rng(seed).standard_normal(
            (chains, REST_CELLS[name][0]))
        return torch.tensor(q, dtype=torch.float32, device=dev)

    def nuts_launches(warmup):
        return {"nuts_transition_generic": warmup, "nuts_sampling_generic": 1}

    def fused(name, what, run, want, accept_range):
        res, wall, wall_b, launches = door_twice(torch, ops, run,
                                                 f"{name} {what} front door")
        if callable(want):
            want = want(launches)
        check(launches == want, f"{name} {what}: launches {launches}, want "
              f"{want}")
        lim = door_limits(torch, diagnostics, res, f"{name} {what}",
                          accept_range)
        out[f"{name} {what}"] = dict(wall_s=wall, wall_s_again=wall_b,
                                     launches=launches, **lim)
        return lim

    def once(name, what, run, want, accept_range):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        check(launches == want, f"{name} {what}: launches {launches}, want "
              f"{want}")
        lim = door_limits(torch, diagnostics, res, f"{name} {what}",
                          accept_range)
        out[f"{name} {what}"] = dict(wall_s=wall, launches=launches, **lim)
        return lim

    # R1: fused NUTS against the pooled XLA route, both with a dense M⁻¹
    q1 = start("softmax_reg", R1_CHAINS, 5201)
    lp1 = pots["softmax_reg"]["lp"]
    a = once("softmax_reg", "NUTS", lambda: aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(5202), lp1, q1, DRAWS, WARMUP,
        algorithm="nuts", path="fused", max_num_expansions=K,
        is_mass_matrix_full=True), nuts_launches(WARMUP), (0.7, 0.9))
    pc = REST_POOLED
    b = once("softmax_reg", "pooled", lambda: aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(5203), lp1, q1[:pc["chains"]],
        pc["draws"], pc["warmup"], algorithm="nuts", path="pooled",
        max_num_expansions=pc["k"], is_mass_matrix_full=True), {},
        (0.7, 0.9))
    z1 = agree(torch, a, b, "softmax_reg fused NUTS against pooled XLA")

    # R2: fused NUTS against fused MEADS, both from β near its scale
    lp2 = pots["weibull_mice"]["lp"]
    q2 = start("weibull_mice", CHAINS, 5204)
    q2[:, :MICE_GROUPS] -= 4.0
    (w, n) = R2_NUTS
    a = fused("weibull_mice", "NUTS", lambda: aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(5205), lp2, q2, n, w,
        algorithm="nuts", path="fused", max_num_expansions=K),
        nuts_launches(w), (0.7, 0.9))
    (w, n) = R2_MEADS
    b = once("weibull_mice", "MEADS", lambda: aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(5206), lp2, q2, n, w,
        algorithm="meads", path="fused", meads_recompute_every=MEADS_EVERY),
        {"ghmc_segment_generic": -(-w // MEADS_EVERY)
         + -(-n // MEADS_EVERY)}, (MEADS_ACCEPT_MIN, 1.0))
    z2 = agree(torch, a, b, "weibull_mice fused NUTS against fused MEADS")

    # R3: fused ChEES against fused NUTS
    lp3 = pots["sur_solve"]["lp"]
    q3 = start("sur_solve", REST_CELLS["sur_solve"][1], 5207)
    (w, n) = R3_CHEES

    def chees_launches(launches):
        probes = launches.get("chees_transition_generic", 0) - (w + n)
        check(1 <= probes <= 32, f"sur_solve ChEES launches {launches}")
        return {"chees_transition_generic": w + n + probes}

    a = fused("sur_solve", "ChEES", lambda: aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(5208), lp3, q3, n, w,
        algorithm="chees", path="fused", initial_step_size=CHEES_EPS0),
        chees_launches, CHEES_ACCEPT)
    b = once("sur_solve", "NUTS", lambda: aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(5209), lp3, q3, DRAWS, WARMUP,
        algorithm="nuts", path="fused", max_num_expansions=K),
        nuts_launches(WARMUP), (0.7, 0.9))
    z3 = agree(torch, a, b, "sur_solve fused ChEES against fused NUTS")
    wall = time.perf_counter() - t_phase
    for name, r in out.items():
        log(f"phase 52: {name}, {r['chains']} chains, {r['draws']} draws: "
            f"{r['wall_s']:.2f} s"
            + (f" (again {r['wall_s_again']:.2f} s, equal bit for bit)"
               if "wall_s_again" in r else "")
            + f"; launches {r['launches']}; accept {r['accept']:.4f}, "
            f"divergent {r['divergent_share']:.2e}, ε {r['step_size']:.4f}, "
            f"max R-hat {r['max_rhat']:.4f} (limit {RHAT_MAX}) [{card}]")
        r["mean"], r["mcse"] = r["mean"].tolist(), r["mcse"].tolist()
    log(f"phase 52: means within {z1:.2f} (softmax_reg fused NUTS / pooled "
        f"XLA), {z2:.2f} (weibull_mice NUTS / MEADS), {z3:.2f} (sur_solve "
        f"ChEES / NUTS) combined MCSE (limit {MCSE_Z}); phase 52 in "
        f"{wall:.1f} s [{card}]")
    record["phase52"] = dict(wall_s=wall, z=dict(softmax_reg=z1,
                                                  weibull_mice=z2,
                                                  sur_solve=z3), **out)
    return out


def fault_g_probe(torch, ops, record, card):
    """Phase 53 (a), fault G (ROADMAP.md §3): the pooled XLA NUTS route on
    P2 under log φ ~ N(0, 4) from 0.1·N(0, 1) made with numpy, as phase 50
    runs it (the first 512 of its start's 4,096 rows, its seed, ε0 and
    schedule: FAULT_G's, K 4), in float32 and in float64: chains with log
    φ > 10 at the first draw, the tuned M⁻¹ of log φ, divergences.  A
    witness: it fails if a kernel ran or if a float64 chain ends warmup or
    sampling at log φ > 10; float32's count is recorded (ROADMAP.md §3:
    float32 alone stranding chains is not a fault)."""
    import aehmc_tpu_torch

    dev = torch.device(DEVICE)
    f = FAULT_G
    group, x, y = negbin_data()
    start = 0.1 * np.random.default_rng(51).standard_normal(
        (NEGBIN_CHAINS, OPS_CELLS["hier_negbin"][0]))[:f["chains"]]
    out = {}
    for dtype in (torch.float32, torch.float64):
        xd = x.astype(np.float64) if dtype == torch.float64 else x
        lp = hier_negbin(torch, group, xd, y, NEGBIN_GROUPS, dev,
                         log_phi_prior=f["prior"])
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(5000), lp,
            torch.tensor(start, dtype=dtype, device=dev), f["draws"],
            f["warmup"], algorithm="nuts", path="pooled",
            max_num_expansions=f["k"], initial_step_size=NEGBIN_EPS0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not any(ops.LAUNCHES.values()), "fault G probe: a kernel ran")
        lphi = res.positions[..., -1].double()  # (draws, chains)
        if lphi.shape[0] != f["draws"]:
            lphi = lphi.T
        div = res.diagnostics.is_diverging.float()
        far = lphi[0] > f["far"]
        name = str(dtype).split(".")[1]
        out[name] = dict(
            wall_s=wall, stranded=int(far.sum()),
            stranded_at_last_draw=int((lphi[-1] > f["far"]).sum()),
            imm_log_phi=float(torch.as_tensor(
                res.inverse_mass_matrix).reshape(-1)[-1]),
            max_chain_mean_log_phi=float(lphi.mean(0).max()),
            divergent_share=float(div.mean()),
            stranded_divergent_share=float(div.T[far].mean())
            if bool(far.any()) else None,
            step_size=float(torch.as_tensor(res.step_size).float().mean()))
        del res
        r = out[name]
        log(f"phase 53: fault G probe, pooled XLA NUTS on hier_negbin under "
            f"log φ ~ N(0, 4), {name}, {f['chains']} chains, {f['warmup']} + "
            f"{f['draws']}, K {f['k']}: {r['stranded']} chains with log φ > "
            f"{f['far']} at the first draw ({r['stranded_at_last_draw']} at "
            f"the last), M⁻¹ of log φ {r['imm_log_phi']:.4g}, largest chain "
            f"mean of log φ {r['max_chain_mean_log_phi']:.4f}, divergent "
            f"{r['divergent_share']:.3e}, ε {r['step_size']:.4g}; "
            f"{wall:.1f} s [{card}]")
    f64 = out["float64"]
    check(f64["stranded"] == 0 and f64["stranded_at_last_draw"] == 0,
          f"fault G: float64 strands chains at log φ > {f['far']}: {f64}")
    record["phase53_fault_g"] = out
    return out


_LGAMMA = {}


def lgamma_binding(torch, dev):
    """The binding of ``lgamma(q[0])`` phase 53 runs (one per device, so
    phase 1 builds its functor with the others)."""
    import aehmc_tpu_torch.api as api

    if dev not in _LGAMMA:
        _LGAMMA[dev] = api._generic_fused_binding(
            lambda q: torch.lgamma(q[0]), 1, dev)
    return _LGAMMA[dev]


def lgamma_probe(torch, ops48, pots, record, card):
    """Phase 53 (b): the generated functor's lgamma (CUDA's lgammaf) and
    digamma (ATen's formula transcribed) against torch's on the card, each
    element a chain (kernel 5 at ε 0, its move accepted: its u and g are
    the functor's at q); P2's gradient, kernel against plain at phase 48's
    state, and the plain one against itself (its scatter-add is
    index_add's); and phase 48's decision agreement on P2."""
    from aehmc_tpu_torch.ops import generic_pg
    from aehmc_tpu_torch.ops import ghmc_fused as gf

    dev = torch.device(DEVICE)
    n = 10_240
    x = torch.tensor(np.exp(np.random.default_rng(53).uniform(
        np.log(0.05), np.log(300.0), (1, n))), dtype=torch.float32,
        device=dev)
    pot, rows = lgamma_binding(torch, dev)
    big = torch.full((1, n), 1e30, device=dev)
    gkw = dict(potential_and_grad_t=None, potential_fn_t=pot)
    o = gf.ghmc_transition_cuda(x, big, torch.zeros_like(x),
                                torch.zeros_like(x), 0.0, 0.0,
                                torch.ones(1, device=dev), rows, seed=5301,
                                **gkw)
    torch.cuda.synchronize()
    check(torch.equal(o[0], x), "lgamma probe: q moved at ε 0")
    u_k, g_k = -o[1].reshape(-1), -o[2].reshape(-1)
    u_t, g_t = torch.lgamma(x).reshape(-1), torch.digamma(x).reshape(-1)

    def ulps(a, b):
        ia = a.view(torch.int32).long()
        ib = b.view(torch.int32).long()
        return (ia - ib).abs()

    res = dict(lgamma_equal=float((u_k == u_t).float().mean()),
               lgamma_max_ulp=int(ulps(u_k, u_t).max()),
               digamma_equal=float((g_k == g_t).float().mean()),
               digamma_max_ulp=int(ulps(g_k, g_t).max()))
    # P2's gradient: kernel 5 at ε 0 against plain, and plain twice
    b2, rows2 = pots["hier_negbin"]["bound"], pots["hier_negbin"]["rows"]
    dim, chains = OPS_CELLS["hier_negbin"][:2]
    q_t = torch.tensor(0.1 * np.random.default_rng(OPS_SEED).standard_normal(
        (dim, chains)), dtype=torch.float32, device=dev)
    ops_b = b2.operands(rows2, dev)
    u_p, g_p = generic_pg.run_plain(b2.ir, q_t, ops_b)
    u_p2, g_p2 = generic_pg.run_plain(b2.ir, q_t, ops_b)
    o = gf.ghmc_transition_cuda(
        q_t, torch.full((1, chains), 1e30, device=dev), g_p,
        torch.zeros_like(q_t), 0.0, 0.0, torch.ones(dim, device=dev), rows2,
        seed=5302, potential_and_grad_t=None,
        potential_fn_t=pots["hier_negbin"]["pot"])
    torch.cuda.synchronize()
    scale = float(g_p.abs().max())
    res.update(
        p2_grad_kernel_vs_plain=float((o[2] - g_p).abs().max()) / scale,
        p2_u_kernel_vs_plain=float(((o[1] - u_p).abs()
                                    / u_p.abs().clamp(min=1.0)).max()),
        p2_grad_plain_vs_plain=float((g_p2 - g_p).abs().max()) / scale,
        p2_plain_equal_to_itself=bool(torch.equal(g_p, g_p2)),
        p2_kernel_1_decisions=ops48["hier_negbin"]["kernels"][
            "nuts_transition"]["share"],
        p2_kernel_3_decisions=ops48["hier_negbin"]["kernels"][
            "nuts_transition_std"]["share"])
    log(f"phase 53: lgamma, {n} values in [0.05, 300]: the functor's equal "
        f"to torch's on the card on {res['lgamma_equal']:.4%} (max "
        f"{res['lgamma_max_ulp']} ulp), digamma {res['digamma_equal']:.4%} "
        f"(max {res['digamma_max_ulp']} ulp); hier_negbin's gradient "
        f"(phase 48's state), kernel 5 at ε 0 against plain "
        f"{res['p2_grad_kernel_vs_plain']:.3g} of its largest, u "
        f"{res['p2_u_kernel_vs_plain']:.3g}; plain against itself "
        f"{res['p2_grad_plain_vs_plain']:.3g} (equal bit for bit: "
        f"{res['p2_plain_equal_to_itself']}); phase 48's decisions equal "
        f"on {res['p2_kernel_1_decisions']:.4%} (kernel 1), "
        f"{res['p2_kernel_3_decisions']:.4%} (kernel 3) [{card}]")
    record["phase53_lgamma"] = res
    return res


def rest_table_fields(kernels, ops51, doors52):
    """R1-R3's records in kernels 1, 3, 5 and 7's ``generic_ops`` (times,
    bound, error, launches on phase 52's doors) and kernels 2 and 6's
    ``generic_ops_sampling`` (phases 48 and 51: time over a few draws,
    bound, launches on the doors)."""
    door = {}
    for what, r in doors52.items():
        name = what.split()[0]
        for k, v in r["launches"].items():
            door.setdefault(name, {})
            door[name][k] = door[name].get(k, 0) + v
    for entry in kernels:
        name = entry["name"]
        if name in ("nuts_sampling", "ghmc_segment"):
            entry.setdefault("generic_ops_launches", {}).update({
                p: door.get(p, {}).get(f"{name}_generic", 0) for p in ops51})
        if name in ("nuts_transition", "nuts_transition_std",
                    "ghmc_transition", "chees_transition"):
            entry["generic_ops"].update({
                p: functor_fields(name, res, door.get(p, {}))
                for p, res in ops51.items()})


def sampling_table_fields(kernels, *phases):
    """Kernels 2 and 6's ``generic_ops_sampling``: each potential's time
    over a few draws, bound and gradients (phases 48 and 51)."""
    for entry in kernels:
        if entry["name"] not in ("nuts_sampling", "ghmc_segment"):
            continue
        fields = {}
        for res in phases:
            for p, r in res.items():
                if entry["name"] in r.get("sampling", {}):
                    fields[p] = r["sampling"][entry["name"]]
        entry["generic_ops_sampling"] = fields


# Phases 54-55: the last of the op table (ROADMAP item 1.10c): Cholesky
# factors, log-determinants, symmetric eigendecompositions, sorts, top-k,
# cumulative products, scatter_reduce and integer arithmetic on a per-chain
# index, on six bare logprobs and one test-only potential, data made from
# a seed with numpy (tests/test_torch_op_table_last.py holds their JAX
# twins at small sizes).  S1 gp_se64: a GP's marginal likelihood, squared-
# exponential kernel on 64 points (Stan Users Guide, "Fitting a Gaussian
# process": cholesky_decompose, multi_normal_cholesky), dim 3; S2
# gp_se64_logdet: S1 through logdet and linalg.solve; S3 lkj_slopes: varying
# intercepts and slopes, LKJCholesky(4, 2) through CorrCholeskyTransform,
# written with torch.distributions (Stan Users Guide, "Multivariate priors
# for hierarchical models"), 30 groups, 600 observations, dim 135; S4
# ordinal_sorted: ordered-logistic regression, 5 categories, cut-points
# torch.sort of four free values (Stan Users Guide, "Ordered logistic
# regression"), 1,000 observations, 10 predictors, dim 14; S5
# matrix_log_cov: a 5-d normal with covariance exp(A(q)) through eigh
# (Leonard and Hsu 1992), 200 rows, dim 20; S6 lts_topk: least trimmed
# squares, the 150 smallest of 200 squared residuals through topk
# (Rousseeuw 1984), 5 predictors, dim 6; op_extras: scatter_reduce (sum,
# mean, amax, amin, with and without the base) by a 40-entry index into 6
# groups and w[(argmax + 1) % 4], M[i, j] with per-chain i, j (dim 7).
# Phase 54 holds kernels 1, 3, 5 and 7 on each against their plain versions
# (kernels 2 and 6 on S1 against kernels 1 and 5 draw by draw) and S1's
# kernel 1 on chains sent where K is not positive definite; phase 55 runs
# S1's fused NUTS, S3's fused ChEES and S5's fused MEADS doors, S1's and
# S5's against the pooled XLA NUTS route on the same model, S3's against
# its fused NUTS door.
LAST_SEED = 5454
GP_POINTS, GP_JITTER = 64, 1e-6
LKJ_COEF, LKJ_GROUPS, LKJ_OBS = 4, 30, 600
# S3's residual sd: its 20 observations a group determine each group's
# coefficients to about LKJ_NOISE / sqrt(20) ~ 0.45 against their spread
# tau ~ 0.6, so the correlation factor is informed but not pinned (with
# sd 0.5 the 30 groups pin every z_j and L can move only with all of them:
# R-hat 1.40 after 1,000 ChEES draws, 1.04 after pooled NUTS's 200)
LKJ_NOISE = 2.0
ORD_OBS, ORD_PRED = 1000, 10
MLC_DIM, MLC_ROWS = 5, 200
LTS_POINTS, LTS_PRED, LTS_KEEP = 200, 5, 150
SR_GROUPS, SR_ENTRIES, SR_DIM = 6, 40, 4
# name: (dim, chains, ε, diagonal M⁻¹, K) of phase 54's kernel checks
LAST_CELLS = {"gp_se64": (3, 1_024, 0.02, 1.0, 4),
              "gp_se64_logdet": (3, 1_024, 0.02, 1.0, 4),
              "lkj_slopes": (135, 4_096, 0.02, 1.0, 6),
              "ordinal_sorted": (14, 4_096, 0.01, 1.0, 6),
              "matrix_log_cov": (20, 4_096, 0.01, 1.0, 6),
              "lts_topk": (6, 4_096, 0.01, 1.0, 6),
              "op_extras": (7, 4_096, 0.05, 1.0, 6)}
LAST_SAMPLING = {"gp_se64": (2, 6)}
# S4's cut-points start spread as the data's (-1.5, -0.5, 0.5, 1.5): at
# 0.1·N(0, 1) they nearly coincide, each category's probability is a
# difference of nearly equal sigmoids and the gradient reaches 1e5
LAST_STARTS = {"ordinal_sorted": [0.0] * ORD_PRED + [-1.5, -0.5, 0.5, 1.5]}
JACOBI_SWEEPS = 16   # the functor's most sweeps of cyclic Jacobi
# phase 54's witness: S1's chains sent by a unit step to alpha e^6, rho
# e^4, sigma e^-20, where K is numerically singular and its float32
# Cholesky meets a pivot that is not positive: divergent, not raised
NON_PD_Q = (6.0, 4.0, -20.0)
NON_PD_CHAINS = 64
# phase 55's doors (algorithm, warmup, draws) on 4,096 chains, and the
# pooled XLA NUTS route (512 chains) each is held to.  Lengths from a probe
# of R-hat by draws (NVIDIA H100 80GB HBM3, 700 W):
# S1's NUTS 1.0048 at 200 draws; S3's ChEES from 500 warmup steps 1.0104 /
# 1.0052 / 1.0026 at 500 / 1,000 / 2,000 (4.2 ms a step); S5's MEADS
# 1.0278 / 1.0137 / 1.0070 / 1.0034 at 500 / 1,000 / 2,000 / 4,000.
# S1's door, cut to 1,024 chains when it took 52.3 s at 4,096 (22.19 s at
# 1,024), takes 9.51 s at 4,096 since the functor's dense linear algebra
# was redesigned (PERF.md §6)
LAST_DOOR_CHAINS = 4096
LAST_DOORS = {"gp_se64": ("nuts", 150, 200),
              "lkj_slopes": ("chees", 500, 1000),
              "matrix_log_cov": ("meads", 500, 3000)}
LAST_POOLED = dict(chains=512, warmup=100, draws=100, k=4)
# S3's reference: its fused NUTS door, held to R-hat below RHAT_MAX.  The
# pooled XLA route did not mix within a run's time (R-hat 1.137 at K 3 and
# 100 + 100 with a dense M⁻¹, 70-79 s a run).  Lengths from a probe of
# R-hat by draws (NVIDIA H100 80GB HBM3, 700 W; the door's start and seed):
# 1.0396 / 1.0197 / 1.0099 / 1.0051 at 100 / 200 / 400 / 800 draws after
# 300 warmup steps (4.06 s a run); after 150, 1.0100 at 400 draws (a dense
# M⁻¹ 1.0073, 7.28 s)
LAST_REF_S3 = dict(chains=4096, warmup=300, draws=800, k=K, dense=False)


def gp_data(num_points=GP_POINTS, seed=0):
    """S1/S2: sorted inputs on [-5, 5], a smooth function plus noise."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(-5.0, 5.0, num_points))
    y = np.sin(x) + 0.5 * np.cos(2.0 * x) + 0.3 * rng.standard_normal(
        num_points)
    return x.astype(np.float32), y.astype(np.float32)


def gp_se(torch, x, y, device, logdet=False, nan_factor=False):
    """S1 (S2 with ``logdet``): q = (log alpha, log rho, log sigma).  With
    ``nan_factor`` the factor is ``cholesky_ex``'s, NaN where K is not
    positive definite (JAX's rule, the fused routes' too): the XLA path
    runs the logprob as it stands, where torch's cholesky raises."""
    X, Y = (torch.as_tensor(a, device=device) for a in (x, y))
    n = X.shape[0]

    def logprob_fn(q):
        alpha, rho, sigma = torch.exp(q[0]), torch.exp(q[1]), torch.exp(q[2])
        d = (X[:, None] - X[None, :]) / rho
        K = alpha * alpha * torch.exp(-0.5 * d * d) + (
            sigma * sigma + GP_JITTER) * torch.eye(n, dtype=X.dtype,
                                                   device=device)
        if logdet:
            ll = -0.5 * torch.dot(Y, torch.linalg.solve(K, Y)) \
                - 0.5 * torch.logdet(K)
        else:
            if nan_factor:
                L, info = torch.linalg.cholesky_ex(K)
                L = torch.where(info != 0, math.nan, L)
            else:
                L = torch.linalg.cholesky(K)
            z = torch.linalg.solve_triangular(L, Y[:, None], upper=False)
            ll = -0.5 * torch.sum(z * z) - torch.sum(torch.log(
                torch.diagonal(L)))
        return ll - 0.5 * (q[0] ** 2 + q[1] ** 2 + (q[2] + 1.0) ** 2)

    return logprob_fn


def lkj_data(num_coef=LKJ_COEF, num_groups=LKJ_GROUPS, num_obs=LKJ_OBS,
             seed=0):
    """S3: group (int64), covariates with an intercept (float32), y."""
    rng = np.random.default_rng(seed)
    K, J, N = num_coef, num_groups, num_obs
    A = rng.standard_normal((K, K))
    S = A @ A.T + K * np.eye(K)
    d = 1.0 / np.sqrt(np.diag(S))
    L = np.linalg.cholesky(S * d[:, None] * d[None, :])
    tau = np.exp(rng.normal(-0.5, 0.3, K))
    mu = rng.normal(0.0, 1.0, K)
    beta = mu + (rng.standard_normal((J, K)) @ L.T) * tau
    group = np.arange(N) % J
    x = np.concatenate([np.ones((N, 1)), rng.standard_normal((N, K - 1))], 1)
    y = (x * beta[group]).sum(1) + LKJ_NOISE * rng.standard_normal(N)
    return group.astype(np.int64), x.astype(np.float32), y.astype(np.float32)


def lkj_slopes(torch, group, x, y, num_groups, device):
    """S3: q = (mu (K), log tau (K), the factor's K(K-1)/2 unconstrained
    values, z (J K), log sigma), written with torch.distributions."""
    import torch.distributions as dist

    g, X, Y = (torch.as_tensor(a, device=device) for a in (group, x, y))
    K, J = X.shape[1], num_groups
    m = K * (K - 1) // 2

    def logprob_fn(q):
        mu, log_tau = q[:K], q[K:2 * K]
        raw, z = q[2 * K:2 * K + m], q[2 * K + m:2 * K + m + J * K]
        log_sigma = q[-1]
        corr = dist.transforms.CorrCholeskyTransform()
        L = corr(raw)
        lp = dist.LKJCholesky(K, torch.tensor(2.0, dtype=q.dtype,
                                              device=device)).log_prob(L) \
            + corr.log_abs_det_jacobian(raw, L)
        Z = z.reshape(J, K)
        lp = lp + dist.MultivariateNormal(
            torch.zeros(K, dtype=q.dtype, device=device),
            scale_tril=torch.eye(K, dtype=q.dtype, device=device)).log_prob(
            Z).sum()
        beta = mu + (Z @ L.T) * torch.exp(log_tau)
        eta = torch.sum(X * beta[g], -1)
        lp = lp + dist.Normal(eta, torch.exp(log_sigma)).log_prob(Y).sum()
        return lp + dist.Normal(0.0, 5.0).log_prob(mu).sum() \
            + dist.Normal(0.0, 1.0).log_prob(log_tau).sum() \
            + dist.Normal(0.0, 1.0).log_prob(log_sigma)

    return logprob_fn


def ordinal_data(num_obs=ORD_OBS, num_pred=ORD_PRED, seed=0):
    """S4: predictors (float32), 5 ordered categories 1..5 (int64)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((num_obs, num_pred))
    beta = rng.normal(0.0, 1.0, num_pred)
    cuts = np.array([-1.5, -0.5, 0.5, 1.5])
    latent = X @ beta + rng.logistic(size=num_obs)
    y = 1 + np.searchsorted(cuts, latent)
    return X.astype(np.float32), y.astype(np.int64)


def ordinal_sorted(torch, X, y, device):
    """S4: q = (beta (P), c_raw (4)); cut-points torch.sort(c_raw)."""
    Xt, yt = (torch.as_tensor(a, device=device) for a in (X, y))
    N, P = Xt.shape

    def logprob_fn(q):
        beta, c = q[:P], torch.sort(q[P:P + 4]).values
        cum = torch.sigmoid(c[None, :] - (Xt @ beta)[:, None])
        cum = torch.cat([torch.zeros(N, 1, dtype=q.dtype, device=device), cum,
                         torch.ones(N, 1, dtype=q.dtype, device=device)], 1)
        p = cum[:, 1:] - cum[:, :-1]
        ll = torch.log(p[torch.arange(N, device=device), yt - 1]).sum()
        return ll - 0.5 * torch.sum((beta / 2.5) ** 2) \
            - 0.5 * torch.sum((q[P:P + 4] / 5.0) ** 2)

    return logprob_fn


def mlc_data(num_dim=MLC_DIM, num_rows=MLC_ROWS, seed=0):
    """S5: rows of a normal with well separated log-eigenvalues."""
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((num_dim, num_dim)))
    lam = np.linspace(-1.0, 1.0, num_dim)
    cov = (V * np.exp(lam)) @ V.T
    mu = rng.standard_normal(num_dim)
    Y = mu + rng.standard_normal((num_rows, num_dim)) @ np.linalg.cholesky(
        cov).T
    return Y.astype(np.float32)


def matrix_log_cov(torch, Y, device):
    """S5: q = (mu (K), A's lower triangle); Sigma = V exp(Lambda) V^T."""
    Yt = torch.as_tensor(Y, device=device)
    n, K = Yt.shape
    rows, cols = (torch.as_tensor(a, device=device)
                  for a in np.tril_indices(K))

    def logprob_fn(q):
        mu, a = q[:K], q[K:]
        A = torch.zeros(K, K, dtype=q.dtype, device=device)
        A[rows, cols] = a
        A[cols, rows] = a
        lam, V = torch.linalg.eigh(A)
        prec = (V * torch.exp(-lam)) @ V.T
        R = Yt - mu
        return -0.5 * torch.sum((R @ prec) * R) - 0.5 * n * torch.sum(lam) \
            - 0.5 * torch.sum((mu / 10.0) ** 2) - 0.5 * torch.sum(a * a)

    return logprob_fn


def lts_data(num_points=LTS_POINTS, num_pred=LTS_PRED, seed=0):
    """S6: design and responses, a tenth of them outliers."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((num_points, num_pred))
    beta = rng.normal(0.0, 1.0, num_pred)
    y = X @ beta + 0.5 * rng.standard_normal(num_points)
    bad = rng.choice(num_points, num_points // 10, replace=False)
    y[bad] += rng.choice([-1.0, 1.0], bad.size) * 8.0
    return X.astype(np.float32), y.astype(np.float32)


def lts_topk(torch, X, y, h, device):
    """S6: q = (beta (P), log sigma); the h smallest squared residuals."""
    Xt, yt = (torch.as_tensor(a, device=device) for a in (X, y))
    P = Xt.shape[1]

    def logprob_fn(q):
        beta, log_sigma = q[:P], q[P]
        r2 = (yt - Xt @ beta) ** 2
        kept = torch.topk(r2, h, largest=False).values
        return -0.5 * torch.sum(kept) * torch.exp(-2.0 * log_sigma) \
            - h * log_sigma - 0.5 * torch.sum((beta / 5.0) ** 2) \
            - 0.5 * log_sigma ** 2

    return logprob_fn


def extras_data(seed=6):
    """op_extras: a 40-entry index into 6 groups (each hit), the design of
    the scattered values and the bases."""
    rng = np.random.default_rng(seed)
    idx = np.concatenate([np.arange(SR_GROUPS), rng.integers(
        0, SR_GROUPS, SR_ENTRIES - SR_GROUPS)])
    A = rng.standard_normal((SR_ENTRIES, SR_DIM))
    base = rng.uniform(0.5, 1.5, SR_GROUPS)
    return idx.astype(np.int64), A.astype(np.float32), base.astype(np.float32)


def op_extras(torch, idx, A, base, device):
    """scatter_reduce (sum, mean, amax, amin; with and without the base)
    by a data index, and integer arithmetic on per-chain indices."""
    it, At, bt = (torch.as_tensor(a, device=device) for a in (idx, A, base))
    w = torch.tensor([1.0, 2.5, -1.0, 0.5], dtype=At.dtype, device=device)
    M = (torch.arange(12.0, dtype=At.dtype, device=device).reshape(3, 4)
         / 7.0 - 0.8)

    def logprob_fn(q):
        s = At @ q[:SR_DIM]
        lp = -0.5 * torch.sum(q * q)
        for reduce in ("sum", "mean", "amax", "amin"):
            for include_self in (True, False):
                out = bt.scatter_reduce(0, it, s, reduce=reduce,
                                        include_self=include_self)
                lp = lp - 0.05 * torch.sum(out * out)
        k = (torch.argmax(q[:4], dim=0, keepdim=True) + 1) % 4
        i = torch.argmax(q[4:7], dim=0, keepdim=True)
        j = torch.argmin(q[:4], dim=0, keepdim=True) * 2 - 3
        return lp + torch.sum(w[k] * q[0] + M[i, j] * q[4])

    return logprob_fn


def last_potentials(torch, dev):
    """S1-S6 and op_extras: logprobs, float64 twins, bindings, functors."""
    import aehmc_tpu_torch.api as api
    from aehmc_tpu_torch.ops import generic_pg

    def f64(*arrays):
        return [a.astype(np.float64) if a.dtype == np.float32 else a
                for a in arrays]

    x, y = gp_data()
    g, X3, Y3 = lkj_data()
    Xo, yo = ordinal_data()
    Ym = mlc_data()
    Xl, yl = lts_data()
    ex = extras_data()
    pairs = {
        "gp_se64": lambda *a: gp_se(torch, *a, dev), "gp_se64_logdet":
        lambda *a: gp_se(torch, *a, dev, logdet=True),
        "lkj_slopes": lambda *a: lkj_slopes(torch, *a, LKJ_GROUPS, dev),
        "ordinal_sorted": lambda *a: ordinal_sorted(torch, *a, dev),
        "matrix_log_cov": lambda *a: matrix_log_cov(torch, *a, dev),
        "lts_topk": lambda *a: lts_topk(torch, *a, LTS_KEEP, dev),
        "op_extras": lambda *a: op_extras(torch, *a, dev)}
    data = {"gp_se64": (x, y), "gp_se64_logdet": (x, y),
            "lkj_slopes": (g, X3, Y3), "ordinal_sorted": (Xo, yo),
            "matrix_log_cov": (Ym,), "lts_topk": (Xl, yl), "op_extras": ex}
    out = {}
    for name, make in pairs.items():
        dim = LAST_CELLS[name][0]
        lp = make(*data[name])
        pot, rows = api._generic_fused_binding(lp, dim, dev)
        out[name] = dict(lp=lp, lp64=make(*f64(*data[name])), pot=pot,
                         rows=tuple(rows),
                         bound=generic_pg.bind(pot, rows, dim, device=dev))
    # the pooled XLA reference's S1: the same density, NaN for a failed
    # factor rather than torch's exception
    out["gp_se64"]["lp_xla"] = gp_se(torch, x, y, dev, nan_factor=True)
    return out


def jacobi_sweeps(A, tol=1e-7, most=JACOBI_SWEEPS):
    """The mean sweeps the functor's cyclic Jacobi (its stopping rule:
    off-diagonal Frobenius norm at most ``tol`` of the matrix's) takes on
    the symmetric matrices ``A (m, n, n)``, in float64 with numpy."""
    counts = []
    for a in np.asarray(A, np.float64):
        a = a.copy()
        n = a.shape[0]
        norm2 = (a * a).sum()
        sweeps = 0
        while sweeps < most:
            off = (a * a).sum() - (np.diag(a) ** 2).sum()
            if not off > tol * tol * norm2:
                break
            sweeps += 1
            for p in range(n - 1):
                for q in range(p + 1, n):
                    if a[p, q] == 0.0:
                        continue
                    theta = (a[q, q] - a[p, p]) / (2.0 * a[p, q])
                    t = np.sign(theta or 1.0) / (abs(theta)
                                                 + math.sqrt(theta ** 2 + 1))
                    c = 1.0 / math.sqrt(t * t + 1.0)
                    s = t * c
                    rot = np.eye(n)
                    rot[p, p] = rot[q, q] = c
                    rot[p, q], rot[q, p] = s, -s
                    a = rot.T @ a @ rot
        counts.append(sweeps)
    return float(np.mean(counts))


def eigh_sweeps(torch, ir, q_t, operands, chains=256):
    """The mean Jacobi sweeps of the IR's eigendecompositions at the first
    ``chains`` columns of ``q_t``: the plain back end run node by node up
    to each ``eigh`` node's matrices."""
    from aehmc_tpu_torch.ops import generic_pg

    data = generic_pg.all_operands(ir, operands)
    q = q_t[:, :chains].double()
    vals, sweeps = [], []
    for n in ir.nodes:
        args = [vals[a] for a in n.args]
        if n.op == "q":
            v = q
        elif n.op == "data":
            v = data[n.params[0]].to(
                device=q.device, dtype=torch.int64 if n.dtype == "i"
                else torch.float64).reshape(*n.shape, 1)
        else:
            v = generic_pg._plain_node(n, args, torch.float64, q.device)
        if n.op == "eigh":
            A = args[0].movedim(-1, 0)
            A = A.expand(q.shape[1], *A.shape[1:]).reshape(-1, *A.shape[2:])
            sweeps.append(jacobi_sweeps(A.cpu().numpy()))
        vals.append(v)
    return float(np.mean(sweeps)) if sweeps else 0.0


MEXP_THETA = (1.192092800768788e-07, 5.978858893805233e-04,
              5.116619363445086e-02, 5.800524627688768e-01,
              1.461661507209034e+00, 3.010066362817634e+00)
SVD_SWEEPS = 30   # the functor's most sweeps of one-sided Jacobi


def mexp_products(A):
    """The matrix products the functor's matrix exponential (ATen's float
    degree choice) takes on each of ``A (m, n, n)``: degree 1, 2, 4, 8, 12
    or 18 (0, 1, 2, 3, 4, 5 products) by the 1-norm, then one a squaring."""
    A = np.asarray(A, np.float32)
    norm = np.abs(A).sum(-2).max(-1)
    out = []
    for x in norm:
        if x <= MEXP_THETA[0]:
            out.append(0)
        elif x <= MEXP_THETA[1]:
            out.append(1)
        elif x <= MEXP_THETA[2]:
            out.append(2)
        elif x <= MEXP_THETA[3]:
            out.append(3)
        elif x < MEXP_THETA[4]:
            out.append(4)
        else:
            s = max(0, math.ceil(math.log2(x / MEXP_THETA[5])))
            out.append(5 + s)
    return np.asarray(out, np.float64)


def onesided_sweeps(A, most=SVD_SWEEPS):
    """The sweeps the functor's one-sided Jacobi (its stopping rule: a sweep
    that rotates no pair, a pair rotated where its cosine exceeds sqrt(m)
    float32 eps) takes on ``A (k, m, n)`` (m >= n), in float64 with
    numpy."""
    counts = []
    for a in np.asarray(A, np.float64):
        W = a.copy()
        m, n = W.shape
        tol = 1.1920929e-07 * math.sqrt(m)
        sweeps = 0
        while sweeps < most:
            rotated = False
            for p in range(n - 1):
                for q in range(p + 1, n):
                    al, be = W[:, p] @ W[:, p], W[:, q] @ W[:, q]
                    g = W[:, p] @ W[:, q]
                    if not abs(g) > tol * math.sqrt(al * be):
                        continue
                    rotated = True
                    zeta = (be - al) / (2.0 * g)
                    t = math.copysign(1.0, zeta) / (abs(zeta) + math.sqrt(
                        1.0 + zeta * zeta))
                    c = 1.0 / math.sqrt(1.0 + t * t)
                    sn = c * t
                    wp, wq = W[:, p].copy(), W[:, q].copy()
                    W[:, p], W[:, q] = c * wp - sn * wq, sn * wp + c * wq
            sweeps += 1
            if not rotated:
                break
        counts.append(sweeps)
    return float(np.mean(counts))


def factor_work(torch, ir, q_t, operands, chains=64):
    """The data-dependent work of the IR's matrix exponentials (products a
    matrix) and SVDs (sweeps a matrix) at the first ``chains`` columns of
    ``q_t``: the plain back end run node by node up to each node's
    matrices (the mean over them)."""
    from aehmc_tpu_torch.ops import generic_pg

    if not any(n.op in ("mexp", "svd") for n in ir.nodes):
        return {}
    data = generic_pg.all_operands(ir, operands)
    q = q_t[:, :chains].double()
    vals, work = [], {"mexp_products": [], "svd_sweeps": []}
    for n in ir.nodes:
        args = [vals[a] for a in n.args]
        if n.op == "q":
            v = q
        elif n.op == "data":
            v = data[n.params[0]].to(
                device=q.device, dtype=torch.int64 if n.dtype == "i"
                else torch.float64).reshape(*n.shape, 1)
        else:
            v = generic_pg._plain_node(n, args, torch.float64, q.device)
        if n.op in ("mexp", "svd"):
            A = args[0].movedim(-1, 0)
            A = A.expand(q.shape[1], *A.shape[1:]).reshape(-1, *A.shape[2:])
            if n.op == "mexp":
                work["mexp_products"].append(float(np.mean(mexp_products(
                    A.cpu().numpy()))))
            else:
                work["svd_sweeps"].append(onesided_sweeps(
                    A[:16].cpu().numpy()))
        vals.append(v)
    return {k: float(np.mean(v)) for k, v in work.items() if v}


def non_pd_witness(torch, p, record, card):
    """Phase 54 (b): kernel 1 on S1's functor, NON_PD_CHAINS of 4,096
    chains sent by a unit step (external momentum) to NON_PD_Q, where K's
    float32 Cholesky fails: those chains divergent and unmoved, their
    energy not finite, nothing raised; the plain version the same."""
    from aehmc_tpu_torch.ops import generic_pg
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs

    dev = torch.device(DEVICE)
    b, rows = p["bound"], p["rows"]
    chains, bad = LAST_CELLS["gp_se64"][1], NON_PD_CHAINS
    rng = np.random.default_rng(LAST_SEED + 9)
    q = 0.1 * rng.standard_normal((3, chains))
    q[2] -= 1.0
    p0 = rng.standard_normal((3, chains))
    p0[:, :bad] = np.asarray(NON_PD_Q)[:, None] - q[:, :bad]
    q_t, mom = (torch.tensor(a, dtype=torch.float32, device=dev)
                for a in (q, p0))
    ops_b = b.operands(rows, dev)

    def plain_pg(x):
        return generic_pg.run_plain(b.ir, x, ops_b)

    u0, g0 = plain_pg(q_t)
    k = 2
    ext = dict(momentum=mom,
               directions=torch.ones(k, chains, device=dev),
               u_bias=torch.tensor(rng.uniform(size=(k, chains)),
                                   dtype=torch.float32, device=dev),
               u_leaf=torch.tensor(rng.uniform(size=(2 ** k, chains)),
                                   dtype=torch.float32, device=dev))
    imm = torch.ones(3, device=dev)
    out = nfs.nuts_transition_cuda(q_t, u0, g0, imm, 1.0, rows, max_exp=k,
                                   potential_and_grad_t=None,
                                   potential_fn_t=p["pot"], **ext)
    ref = nfs.nuts_transition_plain(q_t, u0, g0, imm, 1.0, plain_pg,
                                    max_exp=k, **ext)
    torch.cuda.synchronize()
    u_bad, _ = plain_pg(torch.tensor(np.tile(np.asarray(NON_PD_Q)[:, None],
                                             (1, 8)), dtype=torch.float32,
                                     device=dev))
    res = dict(chains=chains, sent=bad,
               potential_nan=bool(torch.isnan(u_bad).all()))
    for what, o in (("kernel", out), ("plain", ref)):
        div = o[3][4, :bad]
        res[what] = dict(divergent=int((div == 1.0).sum()),
                         unmoved=bool(torch.equal(o[0][:, :bad],
                                                  q_t[:, :bad])),
                         finite=bool(torch.isfinite(o[0]).all()))
        check(res[what]["divergent"] == bad and res[what]["unmoved"]
              and res[what]["finite"], f"S1 witness, {what}: {res[what]}")
    check(res["potential_nan"], "S1 witness: the potential is finite there")
    log(f"phase 54: S1's witness, {bad} of {chains} chains sent to log "
        f"(alpha, rho, sigma) = {NON_PD_Q}, where K is not positive definite "
        f"in float32: the potential NaN, kernel 1 and its plain version "
        f"divergent on {res['kernel']['divergent']} / "
        f"{res['plain']['divergent']} of them, unmoved, nothing raised "
        f"[{card}]")
    record.setdefault("phase54", {})["non_pd_witness"] = res
    return res


def last_doors(torch, ops, diagnostics, pots, record, card):
    """Phase 55: S1's fused NUTS, S3's fused ChEES and S5's fused MEADS
    doors (LAST_DOOR_CHAINS chains; LAST_DOORS' lengths), each within
    §2's limits (R-hat below RHAT_MAX), launches exact, its means within
    MCSE_Z combined MCSE of a reference's on the same model from the same
    start, which holds §2's limits too: the pooled XLA NUTS route
    (LAST_POOLED) on S1 and S5, S3's fused NUTS door (LAST_REF_S3)."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch.ops.generic_pg import no_validation

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    out, z = {}, {}
    accept = {"nuts": (0.7, 0.9), "chees": CHEES_ACCEPT,
              "meads": (MEADS_ACCEPT_MIN, 1.0)}
    for n, (name, (algo, w, d)) in enumerate(LAST_DOORS.items()):
        dim = LAST_CELLS[name][0]
        chains = LAST_DOOR_CHAINS
        q0 = torch.tensor(0.1 * np.random.default_rng(
            LAST_SEED + 20 + n).standard_normal((chains, dim)),
            dtype=torch.float32, device=dev)
        lp = pots[name]["lp"]
        kw = {"nuts": dict(max_num_expansions=K),
              "chees": dict(initial_step_size=CHEES_EPS0),
              "meads": dict(meads_recompute_every=MEADS_EVERY)}[algo]
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(LAST_SEED + 30 + n), lp, q0, d, w,
            algorithm=algo, path="fused", **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: v for k, v in ops.LAUNCHES.items() if v}
        if algo == "nuts":
            want = {"nuts_transition_generic": w, "nuts_sampling_generic": 1}
        elif algo == "meads":
            want = {"ghmc_segment_generic": -(-w // MEADS_EVERY)
                    + -(-d // MEADS_EVERY)}
        else:
            probes = launches.get("chees_transition_generic", 0) - (w + d)
            check(1 <= probes <= 32, f"{name} ChEES launches {launches}")
            want = {"chees_transition_generic": w + d + probes}
        check(launches == want, f"{name} {algo}: launches {launches}, want "
              f"{want}")
        a = door_limits(torch, diagnostics, res, f"{name} fused {algo}",
                        accept[algo])
        x = res.positions.float().transpose(0, 1)  # R-hat at shorter runs
        a["rhat_by_draws"] = {m: max_rhat(torch, diagnostics, x[:, :m])
                              for m in (d // 4, d // 2)}
        del x, res
        out[f"{name} {algo}"] = dict(wall_s=wall, launches=launches, **a)
        fused = name == "lkj_slopes"
        route = "fused" if fused else "pooled"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if fused:
            rc = LAST_REF_S3
            ref = aehmc_tpu_torch.sample(
                torch.Generator().manual_seed(LAST_SEED + 40 + n), lp,
                q0[:rc["chains"]], rc["draws"], rc["warmup"],
                algorithm="nuts", path="fused", max_num_expansions=rc["k"],
                is_mass_matrix_full=rc["dense"])
        else:
            with no_validation():  # torch.distributions' checks under vmap
                ref = aehmc_tpu_torch.sample(
                    torch.Generator().manual_seed(LAST_SEED + 40 + n),
                    pots[name].get("lp_xla", lp),
                    q0[:LAST_POOLED["chains"]], LAST_POOLED["draws"],
                    LAST_POOLED["warmup"], algorithm="nuts", path="pooled",
                    max_num_expansions=LAST_POOLED["k"])
        torch.cuda.synchronize()
        wall_ref = time.perf_counter() - t0
        b = door_limits(torch, diagnostics, ref, f"{name} {route} NUTS",
                        (0.7, 0.9) if fused else (0.6, 0.95))
        out[f"{name} {route}"] = dict(wall_s=wall_ref, **b)
        z[name] = agree(torch, a, b, f"{name} fused {algo} against {route} "
                        "NUTS")
    wall = time.perf_counter() - t_phase
    for what, r in out.items():
        log(f"phase 55: {what}, {r['chains']} chains, {r['draws']} draws: "
            f"{r['wall_s']:.2f} s"
            + (f"; launches {r['launches']}" if "launches" in r else "")
            + f"; accept {r['accept']:.4f}, divergent "
            f"{r['divergent_share']:.2e}, ε {r['step_size']:.4f}, max R-hat "
            f"{r['max_rhat']:.4f} (limit {RHAT_MAX}"
            + (f"; at fewer draws {r['rhat_by_draws']}"
               if "rhat_by_draws" in r else "") + f") [{card}]")
        r["mean"], r["mcse"] = r["mean"].tolist(), r["mcse"].tolist()
    log("phase 55: means within " + ", ".join(
        f"{v:.2f} ({k})" for k, v in z.items()) + f" combined MCSE of the "
        f"reference route (pooled XLA NUTS on S1, S5; fused NUTS on S3; "
        f"limit {MCSE_Z}); phase 55 in {wall:.1f} s "
        f"[{card}]")
    record["phase55"] = dict(wall_s=wall, z=z, **out)
    return out


def last_table_fields(kernels, ops54, doors55):
    """S1-S6's and op_extras' records in kernels 1, 3, 5 and 7's
    ``generic_ops`` (launches on phase 55's doors) and kernels 2 and 6's
    ``generic_ops_launches``."""
    door = {}
    for what, r in doors55.items():
        for k, v in r.get("launches", {}).items():
            door.setdefault(what.split()[0], {})[k] = v
    for entry in kernels:
        name = entry["name"]
        if name in ("nuts_sampling", "ghmc_segment"):
            entry.setdefault("generic_ops_launches", {}).update({
                p: door.get(p, {}).get(f"{name}_generic", 0) for p in ops54})
        if name in ("nuts_transition", "nuts_transition_std",
                    "ghmc_transition", "chees_transition"):
            entry["generic_ops"].update({
                p: functor_fields(name, res, door.get(p, {}))
                for p, res in ops54.items()})



# Phases 56-57: the everyday ops (ROADMAP item 1.10c, reopened): xlogy and
# log_sigmoid for torch.distributions' Poisson, Gamma, Beta, Dirichlet,
# Bernoulli and NegativeBinomial, the special functions, vector norms,
# logcumsumexp, cummax, cross, cdist, the LU family, QR, the SVD, pinv,
# lstsq, the matrix exponential, the scatters by a per-chain index and the
# write under a mask that depends on q, on four bare logprobs written the
# way users write them and one test-only potential, data made from a seed
# with numpy (tests/test_torch_op_table_rest.py holds their JAX twins at
# small sizes).  U1 zip_radon: a zero-inflated Poisson varying-intercept
# regression on the radon layout (919 observations in 85 counties, Gelman
# and Hill 2007 ch. 12; synthetic counts), non-centred county intercepts
# under a Gamma(2, 2) precision, written with torch.distributions, dim 89;
# U2 cox_lung: the Cox partial likelihood (Breslow, no ties) at the size of
# R's survival::lung (228 patients, ~165 events, 7 covariates), its risk
# sets a logcumsumexp, dim 7; U3 ctmc_cav: msm's CAV illness-death model
# (Jackson 2011; 622 patients' 2,846 transitions, 20 distinct intervals),
# P(dt) = matrix_exp(Q dt), 7 log rates; U4 ppca_qr: probabilistic PCA
# (N 500, D 10, rank 3) with loadings the Q of linalg.qr (after Nirwan and
# Bertschinger 2019), through inv and det, dim 34; the CPU tests'
# test-only cases, summed into three functors: everyday_special (special
# functions, norms and scans, LKJCholesky with a concentration that depends
# on q, the per-chain scatters; dim 21), everyday_linalg (the LU and SVD
# families; dim 6) and everyday_families (the everyday families; dim 23).
# Phase
# 56 holds kernels 1, 3, 5 and 7 on each against their plain versions and
# probes the special functions against torch's on the card; phase 57 runs
# U1's fused NUTS, U2's fused ChEES, U3's fused MEADS and U4's fused NUTS
# (dense M⁻¹) doors twice each against the pooled XLA NUTS route.
EVERYDAY_SEED = 5656
ZIP_OBS, ZIP_COUNTIES = 919, 85
COX_OBS, COX_COV = 228, 7
CAV_INTERVALS, CAV_OBS = 20, 2846
PPCA_OBS, PPCA_DIM, PPCA_RANK = 500, 10, 3
# name: (dim, chains, ε, diagonal M⁻¹, K) of phase 56's kernel checks
# (U4 and the LU and SVD families at 1,024 chains: their plain versions,
# torch's batched LU, QR and SVD, take 12 s a transition at 4,096; U3 at
# 4,096: its 2,048-chain state gave kernel 1 a |Δq| of 0.226 against plain
# on one chain whose decisions agreed, its 4,096-chain state 2.0e-5)
EVERYDAY_CELLS = {"zip_radon": (89, 2_048, 0.01, 1.0, 6),
                  "cox_lung": (7, 2_048, 0.02, 1.0, 6),
                  "ctmc_cav": (7, 4_096, 0.01, 1.0, 6),
                  "ppca_qr": (34, 1_024, 0.002, 1.0, 6),
                  "everyday_special": (21, 4_096, 0.01, 1.0, 6),
                  "everyday_linalg": (6, 1_024, 0.01, 1.0, 6),
                  "everyday_families": (23, 4_096, 0.01, 1.0, 6)}
# the test-only cases, in three functors (one would take nvcc minutes)
EVERYDAY_EXTRAS = {
    "everyday_special": ("special", "scans", "lkj", "chain_scatters"),
    "everyday_linalg": ("lu_family", "svd_family"),
    "everyday_families": ("families",)}
CAV_FROM = np.array([0, 0, 1, 1, 1, 2, 2])
CAV_TO = np.array([1, 3, 0, 2, 3, 1, 3])
CAV_RATES = np.array([0.10, 0.04, 0.25, 0.14, 0.08, 0.10, 0.30])
# U3's log rates are capped at 10 (e^10 a year): torch's matrix_exp on the
# card never returns from a matrix of infinite norm (its number of
# squarings is an int64 of +inf), and exp(q) overflows on a divergent
# trajectory
CAV_LOG_RATE_MAX = 10.0
# U1's mu and log precision near the data's, U3's log rates near the data's
EVERYDAY_STARTS = {
    "zip_radon": [0.0] * ZIP_COUNTIES + [0.8, 1.4, 0.0, 0.0],
    "ctmc_cav": list(np.log(CAV_RATES))}
# phase 57's doors (algorithm, warmup, draws, dense M⁻¹) on 4,096 chains,
# each run twice, and the route each is held to (EVERYDAY_REFS).  Lengths
# from probes of R-hat by draws (NVIDIA H100 80GB HBM3, 700 W): U1's NUTS
# 1.0099 at 200 draws, 1.0063 at 300; U2's ChEES 1.0035 at 200; U3's
# MEADS 1.0134 at 800, 1.0044 at 2,400; U4's dense NUTS 1.0020 at 300
EVERYDAY_DOOR_CHAINS = 4096
EVERYDAY_DOORS = {"zip_radon": ("nuts", 150, 300, False),
                  "cox_lung": ("chees", 200, 400, False),
                  "ctmc_cav": ("meads", 300, 2400, False),
                  "ppca_qr": ("nuts", 200, 300, True)}
# the reference runs: the pooled XLA NUTS route (host bound: U1 23.8-48.5
# s at 512-256 chains and 100 + 100 on two hosts, U2 13.3-24.5 s), but on
# U3 and U4 the fused NUTS door (U4's with another seed): on U3 the pooled
# route's vmapped gradient through torch's CUDA matrix_exp did not finish
# 5 + 5 steps of 64 chains in 10 minutes; on U4 it takes 0.23 s a step
# (54.3 s for 256 chains, 200 + 40, K 3, dense, whose R-hat 1.0098 it
# needed), more than the whole run's 1,200 s leaves
EVERYDAY_REFS = {
    "zip_radon": dict(path="pooled", chains=512, warmup=60, draws=60, k=4,
                      dense=False),
    "cox_lung": dict(path="pooled", chains=512, warmup=60, draws=60, k=4,
                     dense=False),
    "ctmc_cav": dict(path="fused", chains=4096, warmup=150, draws=200, k=K,
                     dense=False),
    "ppca_qr": dict(path="fused", chains=4096, warmup=200, draws=300, k=K,
                    dense=True)}
# the special-function probe: inputs a chain, each function's range
PROBE_CHAINS = 10_240
PROBE_ULP = 4     # each function within 4 ulp of torch's on the card


def zip_data(num_obs=ZIP_OBS, num_counties=ZIP_COUNTIES, seed=0):
    """U1: county of each observation (every county seen, the sizes
    skewed), floor (float32), zero-inflated Poisson counts (float32)."""
    rng = np.random.default_rng(seed)
    extra = rng.multinomial(num_obs - num_counties,
                            rng.dirichlet(np.full(num_counties, 0.5)))
    county = np.repeat(np.arange(num_counties), 1 + extra)
    floor = (rng.uniform(size=num_obs) < 0.17).astype(np.float64)
    alpha = rng.normal(0.8, 0.5, num_counties)
    rate = np.exp(alpha[county] - 0.6 * floor)
    y = np.where(rng.uniform(size=num_obs) < 0.25, 0, rng.poisson(rate))
    return (county.astype(np.int64), floor.astype(np.float32),
            y.astype(np.float32))


def zip_radon(torch, county, floor, y, num_counties, device):
    """U1: q = (z (J), mu, log prec, beta, zl), alpha = mu + z / sqrt(prec);
    Poisson, Bernoulli(logits=), Gamma, Normal, logsigmoid, logsumexp."""
    import torch.distributions as dist
    import torch.nn.functional as F

    c, f, Y = (torch.as_tensor(a, device=device) for a in (county, floor, y))
    J = num_counties

    def logprob_fn(q):
        z, mu, log_prec, beta, zl = (q[:J], q[J], q[J + 1], q[J + 2],
                                     q[J + 3])
        alpha = mu + z * torch.exp(-0.5 * log_prec)
        pois = dist.Poisson(torch.exp(alpha[c] + beta * f)).log_prob(Y)
        log_pi = F.logsigmoid(zl)
        log_1m = dist.Bernoulli(logits=zl).log_prob(
            torch.zeros((), dtype=q.dtype, device=device))
        at_zero = torch.logsumexp(torch.stack(
            [log_pi.expand_as(pois), log_1m + pois]), 0)
        ll = torch.where(Y == 0, at_zero, log_1m + pois).sum()
        two = torch.tensor(2.0, dtype=q.dtype, device=device)
        lp = dist.Gamma(two, two).log_prob(torch.exp(log_prec)) + log_prec
        lp = lp + dist.Normal(0.0, 1.0).log_prob(z).sum()
        return ll + lp + dist.Normal(0.0, 5.0).log_prob(mu) \
            + dist.Normal(0.0, 5.0).log_prob(beta) \
            + dist.Normal(0.0, 2.0).log_prob(zl)

    return logprob_fn


def cox_data(num_obs=COX_OBS, num_cov=COX_COV, seed=0):
    """U2: covariates and events sorted by time, descending (no ties)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((num_obs, num_cov))
    beta = rng.normal(0.0, 0.5, num_cov)
    t = rng.exponential(1.0 / np.exp(X @ beta))
    cens = rng.exponential(2.6, num_obs)
    time, event = np.minimum(t, cens), (t <= cens).astype(np.float64)
    order = np.argsort(-time)
    return X[order].astype(np.float32), event[order].astype(np.float32)


def cox_lung(torch, X, event, device):
    """U2: q = beta; the partial likelihood through logcumsumexp."""
    import torch.distributions as dist

    Xt, Et = (torch.as_tensor(a, device=device) for a in (X, event))

    def logprob_fn(q):
        eta = Xt @ q
        ll = torch.sum(Et * (eta - torch.logcumsumexp(eta, 0)))
        return ll + dist.Normal(0.0, 1.0).log_prob(q).sum()

    return logprob_fn


def ctmc_data(num_intervals=CAV_INTERVALS, num_obs=CAV_OBS, seed=0):
    """U3: distinct intervals and transition counts drawn from the model."""
    import scipy.linalg

    rng = np.random.default_rng(seed)
    dt = np.sort(rng.choice(np.arange(1, 61) * 0.05, num_intervals,
                            replace=False))
    Q = np.zeros((4, 4))
    Q[CAV_FROM, CAV_TO] = CAV_RATES
    Q -= np.diag(Q.sum(1))
    counts = np.zeros((num_intervals, 3, 4))
    which = rng.integers(0, num_intervals, num_obs)
    start = rng.choice(3, num_obs, p=[0.6, 0.25, 0.15])
    for k in range(num_intervals):
        P = scipy.linalg.expm(Q * dt[k])
        for i in range(3):
            m = int(np.sum((which == k) & (start == i)))
            counts[k, i] = rng.multinomial(m, P[i] / P[i].sum())
    return dt.astype(np.float32), counts.astype(np.float32)


def ctmc_cav(torch, dt, counts, device):
    """U3: q = 7 log rates; P = matrix_exp(Q dt) at each interval."""
    import torch.distributions as dist

    Dt, Ct = (torch.as_tensor(a, device=device) for a in (dt, counts))
    rows, cols = (torch.as_tensor(a, device=device) for a in (CAV_FROM,
                                                              CAV_TO))

    def logprob_fn(q):
        Q = torch.zeros(4, 4, dtype=q.dtype, device=device)
        Q[rows, cols] = torch.exp(torch.clamp(q, max=CAV_LOG_RATE_MAX))
        Q = Q - torch.diag(Q.sum(1))
        P = torch.linalg.matrix_exp(Q * Dt[:, None, None])
        return torch.sum(Ct * torch.log(P[:, :3, :])) \
            + dist.Normal(-2.0, 1.0).log_prob(q).sum()

    return logprob_fn


def ppca_data(num_obs=PPCA_OBS, num_dim=PPCA_DIM, rank=PPCA_RANK, seed=0):
    """U4: the scatter Y^T Y and the anchor W0 (twice the scatter's leading
    eigenvectors, each with its largest component positive)."""
    rng = np.random.default_rng(seed)
    V, _ = np.linalg.qr(rng.standard_normal((num_dim, rank)))
    lam = np.array([9.0, 4.0, 2.0])[:rank]
    Y = (rng.standard_normal((num_obs, rank)) * np.sqrt(lam)) @ V.T \
        + 0.5 * rng.standard_normal((num_obs, num_dim))
    S = Y.T @ Y
    _, E = np.linalg.eigh(S)
    E = E[:, ::-1][:, :rank]
    E = E * np.sign(E[np.abs(E).argmax(0), np.arange(rank)])
    return S.astype(np.float32), (2.0 * E).astype(np.float32), num_obs


def ppca_qr(torch, S, W0, num_obs, device):
    """U4: q = (W (D K), log lam (K), log sigma); U the Q of qr(W0 + W)."""
    import torch.distributions as dist

    St, Wt = (torch.as_tensor(a, device=device) for a in (S, W0))
    D, K = Wt.shape

    def logprob_fn(q):
        U = torch.linalg.qr(q[:D * K].reshape(D, K) + Wt).Q
        lam = torch.exp(q[D * K:D * K + K])
        C = (U * lam) @ U.T + torch.exp(2.0 * q[-1]) * torch.eye(
            D, dtype=q.dtype, device=device)
        ll = -0.5 * num_obs * torch.log(torch.det(C)) \
            - 0.5 * torch.sum(torch.linalg.inv(C) * St)
        return ll + dist.Normal(0.0, 1.0).log_prob(q[:D * K]).sum() \
            + dist.Normal(0.0, 2.0).log_prob(q[D * K:]).sum()

    return logprob_fn


def everyday_extras(torch, data, which, device):
    """The CPU tests' test-only cases ``which`` (special 6, scans 8, LU
    family 3, SVD family 3, families 23, LKJ concentration 2, chain
    scatters 5: q's slices in that order), their logprobs summed."""
    import torch.distributions as dist
    import torch.nn.functional as F  # noqa: F401

    t = {k: torch.as_tensor(v, device=device) for k, v in data.items()}
    W, Xa, M, B, Ms, Ys = (t[k] for k in ("w", "xa", "m", "b", "ms", "ys"))
    n = Xa.shape[0]

    def special(q):
        a = torch.atan2(q[0], q[1] + 3.0) ** 2
        b = torch.erfinv(0.875 * torch.tanh(q[2])) ** 2
        p = torch.sigmoid(q[3])
        c = torch.logit(p) ** 2 + torch.logit(p, eps=1e-3) ** 2
        kappa = torch.exp(q[4])
        vm = torch.sum(kappa * torch.cos(W - q[5])) - W.shape[0] * (
            torch.log(torch.special.i0e(kappa)) + kappa)
        bessel = torch.special.i0(q[5]) + torch.special.i1(q[4])
        x = torch.exp(q[:3]) + 0.5
        gam = torch.sum(torch.digamma(x)) + torch.sum(torch.polygamma(1, x))
        xl = torch.sum(torch.special.xlog1py(W[:3], torch.exp(q[:3])))
        return vm - a - b - 0.125 * c + 0.125 * (gam - bessel + xl)

    def scans(q):
        v = q[:6].reshape(2, 3)
        norms = torch.linalg.vector_norm(q[:6]) \
            + torch.linalg.vector_norm(q[:6], 1) \
            + torch.linalg.vector_norm(q[:6], float("inf")) \
            + torch.linalg.vector_norm(q[:6], -float("inf")) \
            + torch.linalg.vector_norm(q[:6], 3.0) \
            + torch.linalg.vector_norm(q[:6] + 2.0, 0.5) \
            + torch.linalg.vector_norm(v, 2, dim=1, keepdim=True).sum()
        cr = torch.sum(torch.linalg.cross(v[0], v[1]) * torch.tensor(
            [1.0, -2.0, 0.5], dtype=q.dtype, device=device))
        cm = torch.sum(torch.cummax(q, 0).values) \
            - torch.sum(torch.cummin(q, 0).values)
        Z = Xa / torch.exp(q[6:8])
        K = torch.exp(-0.5 * torch.cdist(Z, Z) ** 2) + 0.125 * torch.eye(
            n, dtype=q.dtype, device=device)
        gp = -torch.logdet(K) + 0.015625 * torch.sum(torch.cdist(Z, Z, p=1.0)) \
            - 0.015625 * torch.sum(torch.cdist(Z, Z[:3], p=3.0))
        return gp + 0.25 * cr + 0.1875 * cm - 0.125 * norms

    def lu_family(q):
        A = M + 0.25 * torch.outer(q, q) + torch.diag(0.1875 * q)
        LU, piv = torch.linalg.lu_factor(A)
        x1 = torch.linalg.lu_solve(LU, piv, B)
        x2 = torch.linalg.lu_solve(LU, piv, B, adjoint=True)
        P, L, U = torch.lu_unpack(LU, piv)
        S = A @ A.T + torch.eye(3, dtype=q.dtype, device=device)
        ci = torch.cholesky_inverse(torch.linalg.cholesky(S))
        return -0.5 * torch.sum(x1 * x1) - 0.25 * torch.sum(x2 * x2) \
            - 0.125 * torch.sum((P @ L @ U) * M) - 0.0625 * torch.sum(L * U) \
            + 0.1875 * torch.det(A) \
            - 0.125 * torch.sum(torch.linalg.inv(A) ** 2) \
            - 0.1875 * torch.sum(ci * M)

    def svd_family(q):
        A = Ms + torch.outer(torch.ones(Ms.shape[0], dtype=q.dtype,
                                        device=device), 0.25 * q)
        s = torch.linalg.svdvals(A)
        U, S, Vh = torch.linalg.svd(A, full_matrices=False)
        Uw, Sw, Vhw = torch.linalg.svd(A.T, full_matrices=False)
        polar = torch.sum((U @ Vh) * Ms) + torch.sum((Uw @ Vhw) * Ms.T)
        proj = torch.sum(((U * S) @ U.T) * (Ms @ Ms.T))
        x = torch.linalg.lstsq(A, Ys).solution
        return torch.sum(torch.log(s)) + 0.125 * polar - 0.015625 * proj \
            - 0.125 * torch.sum(torch.linalg.pinv(A) ** 2) \
            - 0.5 * torch.sum(x * x) + 0.0625 * torch.sum(Sw)

    def families(q):
        sb = dist.transforms.StickBreakingTransform()
        x = sb(q[0:3])
        lp = dist.Dirichlet(t["conc"]).log_prob(x) \
            + sb.log_abs_det_jacobian(q[0:3], x)
        lp = lp + dist.Beta(torch.exp(q[3]), torch.exp(q[4])).log_prob(
            t["beta_x"]).sum()
        lp = lp + dist.NegativeBinomial(torch.exp(q[5]), logits=q[6]).log_prob(
            t["nb"]).sum()
        lp = lp + dist.Geometric(logits=q[7]).log_prob(t["geo"]).sum()
        lp = lp + dist.Multinomial(5, logits=q[8:11]).log_prob(t["mult"])
        return lp + dist.LowRankMultivariateNormal(
            q[11:14], q[14:20].reshape(3, 2), torch.exp(q[20:23])).log_prob(
            t["lr"])

    def lkj(q):
        return dist.LKJCholesky(3, torch.exp(q[0])).log_prob(t["lkj_l"]) \
            + q[0]

    def chain_scatters(q):
        b = t["base"]
        am = torch.argmax(q[:3], 0, keepdim=True)
        k = (am + torch.tensor([0, 1, 2, 1, 0], device=device)) % 3
        r1 = b.scatter_reduce(0, k, 2.0 * q, "amax", include_self=False)
        r2 = b.scatter_reduce(0, k, q, "mean")
        w = b.scatter(0, (am + torch.tensor([0, 2, 1], device=device)) % 3,
                      q[2:])
        return -0.5 * torch.sum(r1 * r1) - 0.5 * torch.sum(r2 * r2) \
            - 0.5 * torch.sum(w * w)

    parts = {"special": (special, 6), "scans": (scans, 8),
             "lu_family": (lu_family, 3), "svd_family": (svd_family, 3),
             "families": (families, 23), "lkj": (lkj, 2),
             "chain_scatters": (chain_scatters, 5)}
    parts = [parts[k] for k in which]

    def logprob_fn(q):
        lp, at = -0.5 * torch.sum(q * q), 0
        for f, d in parts:
            lp = lp + f(q[at:at + d])
            at += d
        return lp

    return logprob_fn


def everyday_extras_data(seed=7):
    """The test-only cases' data (the CPU tests')."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    out = dict(w=rng.uniform(-math.pi, math.pi, 8).astype(f32),
               xa=rng.standard_normal((6, 2)).astype(f32),
               m=np.array([[2.0, 0.5, 0.1], [0.3, 0.1, 1.5],
                           [0.2, 1.8, 0.4]], f32),
               b=np.array([[1.0, 0.5], [2.0, -1.0], [0.5, 0.3]], f32))
    out["ms"] = (rng.standard_normal((5, 3)) + 2.0 * np.eye(5, 3)).astype(f32)
    out["ys"] = rng.standard_normal((5, 2)).astype(f32)
    fam = np.random.default_rng(3)
    out.update(conc=fam.uniform(1.0, 3.0, 4).astype(f32),
               beta_x=np.array([0.3, 0.7], f32),
               nb=fam.integers(0, 9, 5).astype(f32),
               geo=np.array([0.0, 1.0, 4.0], f32),
               mult=np.array([3.0, 0.0, 2.0], f32),
               lr=fam.standard_normal(3).astype(f32))
    out["lkj_l"] = np.linalg.cholesky(np.array(
        [[1.0, 0.3, -0.2], [0.3, 1.0, 0.1], [-0.2, 0.1, 1.0]])).astype(f32)
    out["base"] = np.array([0.5, 1.0, 1.5], f32)
    return out


def everyday_potentials(torch, dev, names=None):
    """U1-U4 and the test-only cases' three functors (or those of
    ``names``): logprobs, float64 twins, bindings, functors."""
    import aehmc_tpu_torch.api as api
    from aehmc_tpu_torch.ops import generic_pg

    def f64(*arrays):
        return [a.astype(np.float64) if isinstance(a, np.ndarray)
                and a.dtype == np.float32 else a for a in arrays]

    ex = everyday_extras_data()
    makers = {
        "zip_radon": (lambda *a: zip_radon(torch, *a, ZIP_COUNTIES, dev),
                      zip_data()),
        "cox_lung": (lambda *a: cox_lung(torch, *a, dev), cox_data()),
        "ctmc_cav": (lambda *a: ctmc_cav(torch, *a, dev), ctmc_data()),
        "ppca_qr": (lambda *a: ppca_qr(torch, *a, dev), ppca_data())}
    for name, which in EVERYDAY_EXTRAS.items():
        makers[name] = ((lambda w: lambda d: everyday_extras(
            torch, d, w, dev))(which), (ex,))
    ex64 = {k: v.astype(np.float64) if v.dtype == np.float32 else v
            for k, v in ex.items()}
    out = {}
    for name, (make, data) in makers.items():
        if names is not None and name not in names:
            continue
        dim = EVERYDAY_CELLS[name][0]
        lp = make(*data)
        lp64 = make(ex64) if name in EVERYDAY_EXTRAS else make(*f64(*data))
        pot, rows = api._generic_fused_binding(lp, dim, dev)
        out[name] = dict(lp=lp, lp64=lp64, pot=pot, rows=tuple(rows),
                         bound=generic_pg.bind(pot, rows, dim, device=dev))
    return out


def probe_pg(torch):
    """The special-function probe's potential and gradient, traced as it
    stands (one functor): u = atan2(q0, q1); g = (erfinv(q2), i0e(q3),
    i1e(q3), polygamma(1, q4), logit(q5), log_sigmoid(q6), xlogy(q0, q7),
    q7)."""
    import torch.nn.functional as F

    def pg(q_t):
        u = torch.atan2(q_t[0], q_t[1])
        g = torch.stack([torch.erfinv(q_t[2]), torch.special.i0e(q_t[3]),
                         torch.special.i1e(q_t[3]),
                         torch.polygamma(1, q_t[4]), torch.logit(q_t[5]),
                         F.logsigmoid(q_t[6]), torch.xlogy(q_t[0], q_t[7]),
                         q_t[7]])
        return u, g

    return pg


_PROBE = {}


def probe_binding(torch, dev):
    """The probe's bound functor (one per device, so phase 1 builds it with
    the others)."""
    from aehmc_tpu_torch.ops import generic_pg

    if dev not in _PROBE:
        pg = probe_pg(torch)
        _PROBE[dev] = (pg, generic_pg.bind(pg, (), 8, with_grad=False,
                                           device=dev))
    return _PROBE[dev]


# each probed function: (its name, the inputs' ranges: a uniform (lo, hi)
# or a log-uniform ("log", lo, hi), torch's function on the card)
PROBE_INPUTS = ((-5.0, 5.0), (-5.0, 5.0), (-0.999, 0.999), (-30.0, 30.0),
                ("log", 0.05, 50.0), (0.001, 0.999), (-30.0, 30.0),
                ("log", 0.05, 50.0))


def everyday_probe(torch, record, card):
    """Phase 56 (b): the generated functor's atan2 (CUDA's atan2f), erfinv
    (erfinvf), i0e and i1e (Cephes's series, ATen's orders), polygamma(1,
    ·) (ATen's trigamma), logit, log_sigmoid and xlogy (ATen's formulas)
    against torch's on the card, PROBE_CHAINS inputs each (kernel 5 at ε
    0, its move accepted: its u and g are the functor's at q): the share
    equal bit for bit and the largest distance in ulp, held to PROBE_ULP."""
    import torch.nn.functional as F
    from aehmc_tpu_torch.ops import ghmc_fused as gf

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(EVERYDAY_SEED + 5)
    cols = []
    for r in PROBE_INPUTS:
        if r[0] == "log":
            cols.append(np.exp(rng.uniform(np.log(r[1]), np.log(r[2]),
                                           PROBE_CHAINS)))
        else:
            cols.append(rng.uniform(r[0], r[1], PROBE_CHAINS))
    q = torch.tensor(np.stack(cols), dtype=torch.float32, device=dev)
    pg, _ = probe_binding(torch, dev)
    big = torch.full((1, PROBE_CHAINS), 1e30, device=dev)
    o = gf.ghmc_transition_cuda(q, big, torch.zeros_like(q),
                                torch.zeros_like(q), 0.0, 0.0,
                                torch.ones(8, device=dev), (), seed=5601,
                                potential_and_grad_t=pg, potential_fn_t=None)
    torch.cuda.synchronize()
    check(torch.equal(o[0], q), "special-function probe: q moved at ε 0")
    u_k, g_k = o[1].reshape(-1), o[2]
    ref = {"atan2": (u_k, torch.atan2(q[0], q[1])),
           "erfinv": (g_k[0], torch.erfinv(q[2])),
           "i0e": (g_k[1], torch.special.i0e(q[3])),
           "i1e": (g_k[2], torch.special.i1e(q[3])),
           "polygamma(1, ·)": (g_k[3], torch.polygamma(1, q[4])),
           "logit": (g_k[4], torch.logit(q[5])),
           "log_sigmoid": (g_k[5], F.logsigmoid(q[6])),
           "xlogy": (g_k[6], torch.xlogy(q[0], q[7]))}

    def ulps(a, b):
        ia = a.contiguous().view(torch.int32).long()
        ib = b.contiguous().view(torch.int32).long()
        ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
        ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
        return (ia - ib).abs()

    res = {}
    for name, (k, t) in ref.items():
        res[name] = dict(equal=float((k == t).float().mean()),
                         max_ulp=int(ulps(k, t).max()))
        check(res[name]["max_ulp"] <= PROBE_ULP,
              f"special-function probe: {name} {res[name]['max_ulp']} ulp "
              f"from torch's")
    ranges = dict(zip(("atan2 (q0, q1)", "atan2 (q1)", "erfinv", "i0e, i1e",
                       "polygamma", "logit", "log_sigmoid", "xlogy's y"),
                      [str(r) for r in PROBE_INPUTS]))
    log(f"phase 56: special functions, {PROBE_CHAINS} float32 inputs each "
        f"(ranges {ranges}; xlogy's x atan2's first): the functor's equal "
        f"to torch's on the card on "
        + ", ".join(f"{k} {v['equal']:.4%} (max {v['max_ulp']} ulp)"
                    for k, v in res.items())
        + f" (limit {PROBE_ULP} ulp) [{card}]")
    record["phase56_probe"] = dict(ranges=ranges, **res)
    return res


# phase 56's dense-node probe: each chain's q holds two 4 x 4 matrices (a
# warp pass of the emitted matrix exponential), two 8 x 8 and one 10 x 10
# (the emitted SVD, U4's size); the functor's rows are their exponentials,
# the singular values, U Vᵀ and U diag(s) Uᵀ.  The exponentials' 1-norms:
# one in each of ATen's six degree intervals and one beyond the last (2
# squarings), a chain's two matrices in different intervals; the SVD's
# matrices random, of rank 9 and with a repeated singular value in turn.
DENSE_PROBE_DIM = 32 + 128 + 210
DENSE_PROBE_CHAINS = 7 * 128
DENSE_PROBE_NORMS = (5e-8, 2e-4, 0.02, 0.3, 1.0, 2.5, 12.0)
# limits, fixed before the run: relative to each matrix's largest element
# against float64 torch on the card (tests/test_torch_dense_nodes.py's
# MEXP_F64_RTOL and SVD_F64_RTOL)
DENSE_PROBE_MEXP_RTOL = 1e-5
DENSE_PROBE_SVD_RTOL = 3e-5


def dense_probe_pg(torch):
    """The dense-node probe's potential and gradient, traced as it stands
    (see DENSE_PROBE_DIM)."""

    def pg(q_t):
        q = q_t.T.contiguous()
        e4 = torch.linalg.matrix_exp(
            q[:, :32].contiguous().reshape(-1, 2, 4, 4))
        e8 = torch.linalg.matrix_exp(
            q[:, 32:160].contiguous().reshape(-1, 2, 8, 8))
        U, S, Vh = torch.linalg.svd(q[:, 160:260].reshape(-1, 10, 10),
                                    full_matrices=False)
        g = torch.cat([e4.reshape(-1, 32), e8.reshape(-1, 128), S,
                       (U @ Vh).reshape(-1, 100),
                       ((U * S[:, None, :]) @ U.mT).reshape(-1, 100)], 1).T
        return g.sum(0), g

    return pg


def dense_probe_binding(torch, dev):
    """The dense-node probe's bound functor (one per device, built in phase
    1 with the others)."""
    from aehmc_tpu_torch.ops import generic_pg

    if ("dense", dev) not in _PROBE:
        pg = dense_probe_pg(torch)
        _PROBE["dense", dev] = (pg, generic_pg.bind(
            pg, (), DENSE_PROBE_DIM, with_grad=False, device=dev))
    return _PROBE["dense", dev]


def dense_probe_inputs(chains=DENSE_PROBE_CHAINS, seed=EVERYDAY_SEED + 6):
    """q (DENSE_PROBE_DIM, chains) of the dense-node probe (float32)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((chains, DENSE_PROBE_DIM))
    nn = len(DENSE_PROBE_NORMS)
    for c in range(chains):
        at = 0
        for n in (4, 8):
            for k in range(2):
                M = rng.standard_normal((n, n))
                norm = DENSE_PROBE_NORMS[(c + 3 * k) % nn]
                q[c, at:at + n * n] = (M * norm / np.abs(M).sum(0).max()
                                       ).reshape(-1)
                at += n * n
        A = rng.standard_normal((10, 10))
        if c % 3 == 1:
            A[:, -1] = A[:, :-1] @ rng.standard_normal(9)
        elif c % 3 == 2:
            U, _ = np.linalg.qr(rng.standard_normal((10, 10)))
            V, _ = np.linalg.qr(rng.standard_normal((10, 10)))
            A = (U * np.array([3.0, 2.0, 2.0, *np.linspace(1.5, 0.5, 7)])
                 ) @ V.T
        q[c, 160:260] = A.reshape(-1)
    return np.ascontiguousarray(q.T, np.float32)


def dense_node_probe(torch, record, card):
    """Phase 56 (c): the emitted matrix exponential (n 4, two matrices a
    warp pass, and 8) and SVD (10 x 10) on the card (kernel 5 at ε 0, its
    move accepted: its g is the functor's rows at q), against float64
    torch on the card, relative to each matrix's largest element, held to
    DENSE_PROBE_MEXP_RTOL and DENSE_PROBE_SVD_RTOL: each degree interval's
    worst exponential, the SVD's worst singular values, U Vᵀ (full-rank
    matrices) and U diag(s) Uᵀ."""
    from aehmc_tpu_torch.ops import ghmc_fused as gf

    dev = torch.device(DEVICE)
    C = DENSE_PROBE_CHAINS
    q = torch.tensor(dense_probe_inputs(), device=dev)
    pg, _ = dense_probe_binding(torch, dev)
    o = gf.ghmc_transition_cuda(q, torch.full((1, C), 1e30, device=dev),
                                torch.zeros_like(q), torch.zeros_like(q), 0.0,
                                0.0, torch.ones(DENSE_PROBE_DIM, device=dev),
                                (), seed=5602, potential_and_grad_t=pg,
                                potential_fn_t=None)
    torch.cuda.synchronize()
    check(torch.equal(o[0], q), "dense-node probe: q moved at ε 0")
    g, q64 = o[2].T.double(), q.T.double()

    def rel(a, b):  # (matrices,) of |a - b| over each b's largest element
        a, b = a.flatten(1), b.flatten(1)
        return ((a - b).abs().amax(1) / b.abs().amax(1)).cpu()

    res, nn = {}, len(DENSE_PROBE_NORMS)
    at = 0
    for n in (4, 8):
        for k in range(2):
            A = q64[:, at:at + n * n].reshape(C, n, n)
            err = rel(g[:, at:at + n * n].reshape(C, n, n),
                      torch.linalg.matrix_exp(A))
            cls = (torch.arange(C) + 3 * k) % nn
            for i, norm in enumerate(DENSE_PROBE_NORMS):
                key = f"mexp n {n}, norm {norm}"
                res[key] = max(res.get(key, 0.0), float(err[cls == i].max()))
            at += n * n
    A = q64[:, 160:260].reshape(C, 10, 10)
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    full = torch.arange(C) % 3 != 1
    res["svd s"] = float(rel(g[:, 160:170], S).max())
    res["svd U Vᵀ"] = float(rel(g[:, 170:270].reshape(C, 10, 10),
                                U @ Vh)[full].max())
    res["svd U diag(s) Uᵀ"] = float(rel(
        g[:, 270:370].reshape(C, 10, 10), (U * S[:, None, :]) @ U.mT).max())
    for key, err in res.items():
        limit = (DENSE_PROBE_SVD_RTOL if key.startswith("svd")
                 else DENSE_PROBE_MEXP_RTOL)
        check(err <= limit, f"dense-node probe: {key} {err:.3g} of the "
              f"largest element from float64 torch (limit {limit})")
    log(f"phase 56: dense-node probe, {C} chains (kernel 5 at ε 0): the "
        "emitted matrix exponential and SVD against float64 torch on the "
        "card, worst error over each matrix's largest element: "
        + ", ".join(f"{k} {v:.3g}" for k, v in res.items())
        + f" (limits {DENSE_PROBE_MEXP_RTOL}, svd {DENSE_PROBE_SVD_RTOL}) "
        f"[{card}]")
    record["phase56_dense_probe"] = dict(chains=C, max_rel_err=res)
    return res


def background_build(build, texts):
    """Build the generated functors ``texts`` in a thread, the compilers at
    nice 10; returns a function that waits for it and raises what it
    raised."""
    import threading

    failed = []

    def run():
        try:
            build._build_missing((), tuple(dict.fromkeys(texts)), nice=10)
        except Exception as err:  # noqa: BLE001 - raised again on join
            failed.append(err)

    thread = threading.Thread(target=run, daemon=True)
    thread.start()

    def join():
        thread.join()
        if failed:
            raise failed[0]

    return join


def everyday_doors(torch, ops, diagnostics, pots, record, card):
    """Phase 57: U1's fused NUTS, U2's fused ChEES, U3's fused MEADS and
    U4's fused NUTS (dense M⁻¹) doors (EVERYDAY_DOOR_CHAINS chains,
    EVERYDAY_DOORS' lengths), each run twice with one seed and equal bit
    for bit, within §2's limits (R-hat below RHAT_MAX), launches exact, its
    means within MCSE_Z combined MCSE of its reference's on the same model
    from the same numpy start (EVERYDAY_REFS: the pooled XLA NUTS route on
    U1 and U2, the fused NUTS door on U3 and U4)."""
    import aehmc_tpu_torch
    from aehmc_tpu_torch.ops.generic_pg import no_validation

    dev = torch.device(DEVICE)
    t_phase = time.perf_counter()
    out, z = {}, {}
    accept = {"nuts": (0.7, 0.9), "chees": CHEES_ACCEPT,
              "meads": (MEADS_ACCEPT_MIN, 1.0)}
    for n, (name, (algo, w, d, dense)) in enumerate(EVERYDAY_DOORS.items()):
        dim = EVERYDAY_CELLS[name][0]
        start = np.asarray(EVERYDAY_STARTS.get(name, np.zeros(dim)))
        q0 = torch.tensor(start + 0.1 * np.random.default_rng(
            EVERYDAY_SEED + 20 + n).standard_normal((EVERYDAY_DOOR_CHAINS,
                                                     dim)),
            dtype=torch.float32, device=dev)
        lp = pots[name]["lp"]
        kw = {"nuts": dict(max_num_expansions=K,
                           is_mass_matrix_full=dense),
              "chees": dict(initial_step_size=CHEES_EPS0),
              "meads": dict(meads_recompute_every=MEADS_EVERY)}[algo]
        runs = []
        for rep in range(2):
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = aehmc_tpu_torch.sample(
                torch.Generator().manual_seed(EVERYDAY_SEED + 30 + n), lp,
                q0, d, w, algorithm=algo, path="fused", **kw)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0, res,
                         {k: v for k, v in ops.LAUNCHES.items() if v}))
        (wall, res, launches), (wall2, res2, _) = runs
        equal = bool(torch.equal(res.positions, res2.positions))
        check(equal, f"{name} fused {algo}: a rerun with one seed differs")
        del res2
        if algo == "nuts":
            want = {"nuts_transition_generic": w, "nuts_sampling_generic": 1}
        elif algo == "meads":
            want = {"ghmc_segment_generic": -(-w // MEADS_EVERY)
                    + -(-d // MEADS_EVERY)}
        else:
            probes = launches.get("chees_transition_generic", 0) - (w + d)
            check(1 <= probes <= 32, f"{name} ChEES launches {launches}")
            want = {"chees_transition_generic": w + d + probes}
        check(launches == want, f"{name} {algo}: launches {launches}, want "
              f"{want}")
        a = door_limits(torch, diagnostics, res, f"{name} fused {algo}",
                        accept[algo])
        del res
        out[f"{name} {algo}"] = dict(wall_s=wall, rerun_wall_s=wall2,
                                     rerun_equal=equal, launches=launches,
                                     **a)
        rc = EVERYDAY_REFS[name]
        pooled = rc["path"] == "pooled"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with no_validation():  # torch.distributions' checks under vmap
            ref = aehmc_tpu_torch.sample(
                torch.Generator().manual_seed(EVERYDAY_SEED + 40 + n), lp,
                q0[:rc["chains"]], rc["draws"], rc["warmup"],
                algorithm="nuts", path=rc["path"], max_num_expansions=rc["k"],
                is_mass_matrix_full=rc["dense"])
        torch.cuda.synchronize()
        wall_ref = time.perf_counter() - t0
        what = f"{name} {rc['path']} NUTS"
        # the pooled route's R-hat is recorded, the fused route's held
        b = door_limits(torch, diagnostics, ref, what,
                        (0.6, 0.95) if pooled else (0.7, 0.9),
                        rhat_max=None if pooled else RHAT_MAX)
        out[f"{name} {rc['path']}"] = dict(wall_s=wall_ref, **b)
        z[name] = agree(torch, a, b, f"{name} fused {algo} against "
                        + ("pooled XLA NUTS" if pooled else "fused NUTS"))
    wall = time.perf_counter() - t_phase
    for what, r in out.items():
        log(f"phase 57: {what}, {r['chains']} chains, {r['draws']} draws: "
            f"{r['wall_s']:.2f} s"
            + (f" (rerun {r['rerun_wall_s']:.2f} s, equal bit for bit: "
               f"{r['rerun_equal']})" if "rerun_equal" in r else "")
            + (f"; launches {r['launches']}" if "launches" in r else "")
            + f"; accept {r['accept']:.4f}, divergent "
            f"{r['divergent_share']:.2e}, ε {r['step_size']:.4f}, max R-hat "
            f"{r['max_rhat']:.4f} (limit {RHAT_MAX}) [{card}]")
        r["mean"], r["mcse"] = r["mean"].tolist(), r["mcse"].tolist()
    log("phase 57: means within " + ", ".join(
        f"{v:.2f} ({k})" for k, v in z.items()) + " combined MCSE of the "
        f"reference route (pooled XLA NUTS on U1, U2; fused NUTS on U3, U4; "
        f"limit {MCSE_Z}); phase 57 in {wall:.1f} s [{card}]")
    record["phase57"] = dict(wall_s=wall, z=z, **out)
    return out


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import aehmc_tpu_torch
    from aehmc_tpu_torch import diagnostics
    from aehmc_tpu_torch.models import logistic_regression_pg_t
    from aehmc_tpu_torch import ops
    from aehmc_tpu_torch.ops import _build
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.ops.fused_driver import warmup_fused
    from aehmc_tpu_torch.ops.launch_plan import launch_plan
    from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE, derive_draw_seeds
    from aehmc_tpu_torch.ops.philox import MASK32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    record = {}

    # ---- phase 1: identity and build
    card = card_identity()
    kind = torch.cuda.get_device_name(0)
    # the six sources build while the potentials are traced (a trace is one
    # core's work), and so do phases 34-43's functors once traced (phase 1
    # reports kernels 5-7 on three of them); the others of phases 48-57
    # build at a low priority beside phases 18-47
    from concurrent.futures import ThreadPoolExecutor
    from aehmc_tpu_torch.ops import generic_pg

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        sources = pool.submit(_build.build_all)
        gen_pots = generic_potentials(torch, dev)  # phases 34-38's functors
        functors = pool.submit(_build._build_missing, (), tuple(
            dict.fromkeys(b.source for b in gen_pots["binds"].values())))
        op_pots = op_table_potentials(torch, dev)  # phases 48-50's
        rest_pots = rest_potentials(torch, dev)    # phases 51-52's
        last_pots = last_potentials(torch, dev)    # phases 54-55's
        every_pots = everyday_potentials(torch, dev)  # phases 56-57's
        _, probe = probe_binding(torch, dev)       # phase 56's probes
        _, dense_probe = dense_probe_binding(torch, dev)
        lg = generic_pg.bind(*lgamma_binding(torch, dev), 1, device=dev)
        trace_s = time.perf_counter() - t0
        functors.result()
        sources.result()
    later = ([p["bound"].source for p in op_pots.values()]
             + [p["bound"].source for p in rest_pots.values()]
             + [p["bound"].source for p in last_pots.values()]
             + [lg.source]
             + [p["bound"].source for p in every_pots.values()]
             + [probe.source, dense_probe.source])
    build_s = time.perf_counter() - t0
    log(card)
    log(f"phase 1: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, kernels built/loaded in {build_s:.1f} s "
        f"(with {len(gen_pots['binds'])} generated functors, "
        f"traced in the first {trace_s:.1f} s while the sources built; "
        f"phases 48-57's {len(set(later))} build beside phases 18-47)")
    ptxas = ptxas_report(_build.ptxas_log())
    geometry = {}
    for name in ENTRIES:
        plan = (launch_plan(CORES[name], DIM, K, CHAINS) if name in CORES
                else None)
        regs, spill = ptxas.get(name, (None, None))
        geometry[name] = dict(
            chains=plan and plan.chains, points=plan and plan.points,
            smem_bytes=plan and plan.smem, blocks=plan and plan.blocks,
            registers=regs, spill_bytes=spill)
        if name in NUTS_OCCUPANCY:  # blocks per SM, float32 and bf16 X
            source, fn, sampling = NUTS_OCCUPANCY[name]
            lib = _build.load_kernels(source)
            per_sm = {}
            for x_dtype in (torch.float32, torch.bfloat16):
                xp = launch_plan("nuts", DIM, K, CHAINS, x_dtype)
                per_sm[str(x_dtype).split(".")[1]] = dict(
                    chains=xp.chains, points=xp.points, smem_bytes=xp.smem,
                    blocks_per_sm=getattr(lib, fn)(
                        sampling, int(x_dtype == torch.bfloat16), xp.smem))
            geometry[name]["per_sm"] = per_sm
            check(all(v["blocks_per_sm"] >= 2 for v in per_sm.values()),
                  f"{name}: fewer than two blocks per SM {per_sm}")
        if name in HMC_OCCUPANCY:  # at the plan's chains a block
            source, fn, first, n_types = HMC_OCCUPANCY[name]
            lib = _build.load_kernels(source)
            per_sm = {}
            for x_dtype in (torch.float32, torch.bfloat16)[:n_types]:
                xp = launch_plan(CORES[name], DIM, K, CHAINS, x_dtype)
                args = (xp.chains, xp.smem) if first is None else (
                    first, int(x_dtype == torch.bfloat16), xp.chains, xp.smem)
                per_sm[str(x_dtype).split(".")[1]] = dict(
                    chains=xp.chains, points=xp.points, smem_bytes=xp.smem,
                    blocks_per_sm=getattr(lib, fn)(*args))
            geometry[name]["per_sm"] = per_sm
            check(all(v["blocks_per_sm"] >= 2 for v in per_sm.values()),
                  f"{name}: fewer than two blocks per SM {per_sm}")
        occ = ""
        if "per_sm" in geometry[name]:
            occ = "; blocks per SM " + ", ".join(
                f"{k} X ({v['chains']} chains, {v['points']} points, "
                f"{v['smem_bytes']} B) {v['blocks_per_sm']}"
                for k, v in geometry[name]["per_sm"].items())
        log(f"  {name}: " + (f"{plan.blocks} blocks of {plan.chains} chains, "
                             f"X in chunks of {plan.points} points, "
                             f"{plan.smem} B of shared memory a block; "
                             if plan else "")
            + f"ptxas {regs} registers, {spill} B spill stores (the most "
            f"over its instantiations)" + occ)
    # kernels 1 and 2 with the hierarchical functors (no X tile), at the
    # funnel's and eight schools' dim 10 and K HIER_K
    lib = _build.load_kernels("nuts_fused_small.cu")
    for number, name in ((1, "funnel"), (2, "eight_schools")):
        plan = launch_plan("nuts", FUNNEL_DIM, HIER_K, FUNNEL_CHAINS,
                           functor=name)
        per_sm = {kind: lib.nuts_pot_blocks_per_sm(number, sampling, plan.smem)
                  for kind, sampling in (("transition", 0), ("sampling", 1))}
        geometry[f"nuts_{name}"] = dict(smem_bytes=plan.smem, **per_sm)
        log(f"  nuts_transition_{name}, nuts_sampling_{name}: "
            f"{plan.blocks} blocks of {plan.chains} chains at dim "
            f"{FUNNEL_DIM}, no X tile, {plan.smem} B of shared memory a block; "
            f"blocks per SM {per_sm}")
        check(min(per_sm.values()) >= 2,
              f"{name}: fewer than two blocks per SM {per_sm}")
    # kernels 5-7 on the generated functors of the flagship, the funnel and
    # eight schools
    hmc_functors = hmc_functor_report(torch, _build, gen_pots)
    geometry["hmc_functors"] = hmc_functors
    for name, rep in hmc_functors.items():
        log(f"  ghmc_transition, ghmc_segment, chees_transition on {name}: "
            f"ptxas registers {rep['registers']}, spill stores "
            f"{rep['spill_bytes']} B (kernels 5, 6, 7); {rep['smem_bytes']} "
            f"B of shared memory a block; blocks per SM "
            f"{rep['blocks_per_sm']}")
    # every generated functor's geometry (registers and spills of those
    # built here; the others' in their phases, 48, 51, 54 and 56)
    functors = dict(gen_pots["binds"])
    for group in (op_pots, rest_pots, last_pots, every_pots):
        functors.update({k: v["bound"] for k, v in group.items()})
    functors.update(special_probe=probe, lgamma_probe=lg)
    geometry["generic_functors"] = {}
    log("  generated functors' geometries (NUTS K "
        f"{K}, {CHAINS} chains; blocks an SM by shared memory):")
    for name, b in functors.items():
        g = geometry_fields(b)
        regs, spill = (ptxas_most(_build, b) if name in gen_pots["binds"]
                       else (None, None))
        geometry["generic_functors"][name] = dict(g, registers=regs,
                                                  spill_bytes=spill)
        log(geometry_line(name, g, regs, spill))
    nuts_plan = launch_plan("nuts", DIM, K, CHAINS)
    check((nuts_plan.points, nuts_plan.smem) == (128, 111_792),
          f"NUTS plan at dim {DIM}, K {K}: {nuts_plan}")
    hmc_plans = [launch_plan(core, DIM, 0, CHAINS)
                 for core in ("hmc", "fused_hmc")]
    check([(p.chains, p.points) for p in hmc_plans] == [(8, 128), (16, 128)],
          f"HMC plans at dim {DIM}: {hmc_plans}")
    sweep = plan_sweep(torch, card)
    record.update(card=card, kind=kind, build_s=build_s, trace_s=trace_s,
                  geometry=geometry, plan_sweep=sweep)

    # the flagship's float32 data (bench.py's); phase 17 takes the builder's
    # default, bfloat16
    pot, pg, data, _ = logistic_regression_pg_t(
        DIM, POINTS, matmul_dtype=torch.float32, device=dev)
    pot_grad = lambda q_t: pg(q_t, *data)  # noqa: E731
    rng = np.random.default_rng(0)
    # bench.py's init: the zero example position plus 0.1 N(0, 1)
    q0 = torch.tensor(0.1 * rng.standard_normal((CHAINS, DIM)),
                      dtype=torch.float32, device=dev)
    q_t = q0.T.contiguous()
    u0, g0 = pg(q_t, *data)
    imm = torch.full((DIM,), IMM, device=dev)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=dev)

    ext = dict(
        momentum=f32(np.sqrt(1.0 / IMM) * rng.standard_normal((DIM, CHAINS))),
        directions=f32(np.where(rng.uniform(size=(K, CHAINS)) < 0.5, -1.0, 1.0)),
        u_bias=f32(rng.uniform(size=(K, CHAINS))),
        u_leaf=f32(rng.uniform(size=(2**K, CHAINS))),
    )

    # ---- phase 2: kernel 1 against the plain version, external randomness
    def k1_ext():
        return nfs.nuts_transition_cuda(q_t, u0, g0, imm, EPS, data,
                                        max_exp=K, **ext)

    def p1_ext():
        return nfs.nuts_transition_plain(q_t, u0, g0, imm, EPS, pot_grad,
                                         max_exp=K, **ext)

    out_k, out_p = k1_ext(), p1_ext()
    torch.cuda.synchronize()
    share, err1, ndiff = compare(out_k, out_p,
                                 "kernel 1 (external randomness)")
    gerr1 = grad_errors(torch, pg, data, out_k[0], out_k[2], "kernel 1")
    ms1, plain_ms1 = cuda_ms(torch, k1_ext, 5), cuda_ms(torch, p1_ext, 3)
    leaves = float(out_k[3][3].mean())
    lockstep2 = lockstep(out_k[3][3])
    bound1 = bound(float(out_k[3][3].sum()) * GRAD_FLOP,
                   nbytes(q_t, u0, g0, imm, *data, *ext.values(), *out_k))
    log(f"phase 2: nuts_transition vs plain at {CHAINS}x{DIM}, K={K}: "
        f"decisions equal on {share:.4%} of chains ({ndiff} differ), max |q| "
        f"err {err1:.3g}; gradient at q_out against float64: kernel "
        f"{gerr1[0]:.3g}, plain float32 {gerr1[1]:.3g}; "
        f"kernel {ms1:.3f} ms, plain {plain_ms1:.3f} ms per transition "
        f"(mean {leaves:.1f} leaves/chain; lockstep ratio for groups of "
        + ", ".join(f"{g}: {r:.4f}" for g, r in lockstep2.items())
        + f") [{card}]")
    record["phase2"] = dict(share=share, differ=ndiff, max_abs_err=err1, ms=ms1,
                            plain_ms=plain_ms1, mean_leaves=leaves,
                            lockstep=lockstep2, grad_err=gerr1[0],
                            plain_grad_err=gerr1[1])

    # ---- phase 3: Philox randomness, kernel 1 against the plain version
    seed = 123456789
    out_k = nfs.nuts_transition_cuda(q_t, u0, g0, imm, EPS, data, max_exp=K,
                                     seed=seed)
    out_p = nfs.nuts_transition_plain(q_t, u0, g0, imm, EPS, pot_grad,
                                      max_exp=K, seed=seed)
    torch.cuda.synchronize()
    share3, err3, ndiff3 = compare(out_k, out_p, "kernel 1 (Philox)")
    log(f"phase 3: Philox nuts_transition vs plain fed the same streams: "
        f"decisions equal on {share3:.4%} ({ndiff3} differ), max |q| err "
        f"{err3:.3g}")
    record["phase3"] = dict(share=share3, differ=ndiff3, max_abs_err=err3)

    # ---- phase 4: kernel 2 (20 draws) == 20 launches of kernel 1, bitwise;
    # and kernel 2 against its plain version
    n4 = 20

    def k2(cdt=torch.float32):
        return nfs.nuts_sampling_cuda(q_t, u0, g0, imm, EPS, data, seed, n4,
                                      max_exp=K, collect_dtype=cdt)

    def p2():
        return nfs._sampling_plain(
            pot_grad, q_t, u0, g0, imm, EPS, seed, n4, max_exp=K,
            divergence_threshold=1000.0, collect_positions=True,
            collect_dtype=torch.float32,
        )

    pos, stats, qf, uf, gf = k2()
    q, u, g = q_t, u0, g0
    for t in range(n4):
        q, u, g, st = nfs.nuts_transition_cuda(
            q, u, g, imm, EPS, data, max_exp=K,
            seed=(seed + t * DRAW_SEED_STRIDE) & MASK32,
        )
        check(torch.equal(st, stats[t]) and torch.equal(q, pos[t]),
              f"kernel 2 draw {t} differs from kernel 1")
    check(torch.equal(q, qf) and torch.equal(u, uf) and torch.equal(g, gf),
          "kernel 2 final state differs from kernel 1")
    pos16 = k2(torch.bfloat16)[0]
    check(torch.equal(pos16, pos.to(torch.bfloat16)),
          "bf16 store is not the rounding of the float32 store")
    pos_p, stats_p, qf_p, _, _ = p2()
    share4, err4, ndiff4 = compare((pos, None, None, stats),
                                   (pos_p, None, None, stats_p),
                                   f"kernel 2 vs plain over {n4} draws")
    ms2, plain_ms2 = cuda_ms(torch, k2, 3), cuda_ms(torch, p2, 1)
    bound2 = bound(float(stats[:, 3].sum()) * GRAD_FLOP,
                   nbytes(q_t, u0, g0, imm, *data, pos, stats, qf, uf, gf))
    log(f"phase 4: nuts_sampling over {n4} draws == {n4} nuts_transition "
        f"launches bit for bit (positions, stats, final state; bf16 store = "
        f"rounded f32); vs plain: decisions equal on {share4:.4%} of chains "
        f"in every draw ({ndiff4} differ), max |q| err {err4:.3g}; kernel "
        f"{ms2:.2f} ms, plain "
        f"{plain_ms2:.2f} ms per {n4}-draw run [{card}]")
    record["phase4"] = dict(share=share4, differ=ndiff4, max_abs_err=err4,
                            ms=ms2,
                            plain_ms=plain_ms2, draws=n4)

    # ---- phase 5: the flagship through the front door
    gen = torch.Generator().manual_seed(2026)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = aehmc_tpu_torch.sample(
        gen, None, q0, DRAWS, WARMUP, algorithm="nuts", path="fused",
        data=data, potential_fn_t=pot, potential_and_grad_t=pg,
        max_num_expansions=K, initial_step_size=0.1,
        collect_dtype=torch.bfloat16,
    )
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    check(launches["nuts_transition"] == WARMUP,
          f"{launches['nuts_transition']} nuts_transition launches")
    check(launches["nuts_sampling"] >= 1, "nuts_sampling never launched")
    diag = res.diagnostics
    accept = float(diag.acceptance_probability.mean())
    div_share = float(diag.is_diverging.float().mean())
    eps = float(res.step_size)
    draws = res.positions.float().transpose(0, 1)  # (chains, draws, dim)
    finite = bool(torch.isfinite(draws).all())
    rhat = max(float(diagnostics.potential_scale_reduction(
        draws[:, :, i:i + 20], rank_normalized=True).max())
        for i in range(0, DIM, 20))
    log(f"phase 5: front door {CHAINS}x{DIM}, {WARMUP} warmup + {DRAWS} "
        f"draws in {wall5:.2f} s; launches {launches}; accept {accept:.4f}, "
        f"divergent {div_share:.2e} of transitions, eps {eps:.4f}, max "
        f"R-hat {rhat:.4f}, finite {finite}")
    check(0.7 <= accept <= 0.9, f"mean acceptance {accept}")
    check(div_share < 1e-4, f"divergent share {div_share}")
    check(0.4 <= eps <= 0.65, f"tuned step size {eps}")
    check(rhat < 1.01, f"max R-hat {rhat}")
    check(finite, "non-finite draws")
    record["phase5"] = dict(wall_s=wall5, launches=launches, accept=accept,
                            divergent_share=div_share, step_size=eps,
                            max_rhat=rhat)
    nuts_mean = mean_mcse(torch, diagnostics, draws)  # phases 11-12 reference
    tuned5 = (eps, res.inverse_mass_matrix)  # phase 28's state
    q_post = res.final_state.contiguous()  # phase 36's start
    del res, draws

    # ---- phase 6: 1,024 chains through the kernels and the plain versions
    n6 = PHASE6_CHAINS
    q6 = q0[:n6]
    res_k = aehmc_tpu_torch.sample(
        torch.Generator().manual_seed(61), None, q6, DRAWS, WARMUP,
        data=data, potential_fn_t=pot, potential_and_grad_t=pg,
        max_num_expansions=K, initial_step_size=0.1,
    )

    def plain_transition(q, u, g, p, dirs, ub, ul, imm_, eps_, seed=None):
        return nfs.nuts_transition_plain(
            q, u, g, imm_, eps_, pot_grad, max_exp=K, momentum=p,
            directions=dirs, u_bias=ub, u_leaf=ul, seed=seed,
        )

    gen6 = torch.Generator().manual_seed(62)
    u6, g6 = pg(q6.T.contiguous(), *data)
    (qw, uw, gw), eps6, imm6 = warmup_fused(
        gen6, plain_transition, q6, u6.T, g6.T, WARMUP,
        max_num_expansions=K, initial_step_size=0.1,
    )
    pos6, _, _, _, _ = nfs._sampling_plain(
        pot_grad, qw.T.contiguous(), uw.T, gw.T.contiguous(), imm6, eps6,
        derive_draw_seeds(gen6, 1)[0], DRAWS, max_exp=K,
        divergence_threshold=1000.0, collect_positions=True,
        collect_dtype=torch.float32,
    )
    a = res_k.positions.transpose(0, 1).double()   # (chains, draws, dim)
    b = pos6.permute(2, 0, 1).double()

    (ma, sa), (mb, sb) = (mean_mcse(torch, diagnostics, x) for x in (a, b))
    z = ((ma - mb).abs() / torch.sqrt(sa**2 + sb**2)).max()
    log(f"phase 6: {n6} chains, kernels vs plain versions on the card: "
        f"per-dimension posterior means differ by at most {float(z):.2f} "
        f"MCSE (limit {MCSE_Z}); eps {float(res_k.step_size):.4f} vs "
        f"{float(eps6):.4f}")
    check(float(z) < MCSE_Z, f"posterior means differ by {float(z)} MCSE")
    record["phase6"] = dict(max_z=float(z), eps_kernel=float(res_k.step_size),
                            eps_plain=float(eps6))

    # ---- phase 7: timing, as bench.py measures it (warmup median of 3,
    # sampling median of 5, build excluded)
    transition = nfs.make_fused_nuts_transition_small(
        pot, data, max_num_expansions=K, potential_and_grad_t=pg,
        transposed_io=True,
    )
    u0s, g0s = u0.T.contiguous(), g0.T.contiguous()

    t_warm, ((qw, _, _), eps7, imm7) = timed(
        torch,
        lambda r: warmup_fused(torch.Generator().manual_seed(10 + r),
                               transition, q0, u0s, g0s, WARMUP,
                               max_num_expansions=K, initial_step_size=0.1),
        3,
    )
    t_samp, (_, pos7, stats7) = timed(
        torch,
        lambda r: nfs.sample_fused_small(
            torch.Generator().manual_seed(20 + r), pot, data, qw, DRAWS,
            eps7, imm7, max_num_expansions=K, potential_and_grad_t=pg,
            collect_dtype=torch.bfloat16, loop_in_kernel=True,
        ),
        5,
    )
    evals = float(stats7[:, :, 3].sum())
    x = pos7.transpose(0, 1)
    ess = torch.cat([
        torch.minimum(
            diagnostics.effective_sample_size(x[:, :, i:i + 10].float()),
            diagnostics.tail_effective_sample_size(x[:, :, i:i + 10].float()),
        )
        for i in range(0, DIM, 10)
    ]).clamp(max=CHAINS * DRAWS)
    ess_s = float(ess.sum()) / t_samp
    e2e = ess_s * t_samp / (t_warm + t_samp)
    log(f"phase 7: warmup {t_warm:.3f} s, sampling {t_samp:.3f} s, "
        f"{evals / t_samp / 1e6:.2f}M grad-evals/s, {ess_s / 1e6:.2f}M ESS/s "
        f"sampling, {e2e / 1e6:.2f}M ESS/s end to end, tuned eps "
        f"{float(eps7):.4f}, min ESS {float(ess.min()):.0f} [{card}]")
    record["phase7"] = dict(warmup_wall_s=t_warm, sampling_wall_s=t_samp,
                            grad_evals_per_s=evals / t_samp,
                            sampling_ess_per_s=ess_s, e2e_ess_per_s=e2e,
                            step_size=float(eps7), min_ess=float(ess.min()))

    del pos7, x
    record["phase2"].update(bound_ms=bound1[0], bound_ms_cuda_cores=bound1[2])
    record["phase4"].update(bound_ms=bound2[0], bound_ms_cuda_cores=bound2[2])
    ghmc = ghmc_phases(torch, ops, diagnostics, data, pot, pg, q0, record,
                       nuts_mean, card)
    chees_entry = chees_phases(torch, ops, diagnostics, data, pg, q0, record,
                               nuts_mean, card)
    standard = standard_nuts_phases(torch, ops, diagnostics, data, q0, record,
                                    nuts_mean, card)
    bf16_phases(torch, ops, diagnostics, q0, record, nuts_mean, card)
    extra_seed_runs(torch, ops, diagnostics, data, pot, pg, q0, record,
                    nuts_mean, card, EXTRA_SEEDS)
    stamp(record, "1-17")
    # phases 48-57's functors build at a low priority beside phases 18-47
    # (their walls mostly the card's), after the timed phases 2-17
    later_build = background_build(_build, later)
    hierarchical = hierarchical_phases(torch, ops, diagnostics, record, card)
    stamp(record, "18-19")
    k8_launches, k8_route = xla_phases(torch, ops, diagnostics, data, pg, q0,
                                       record, nuts_mean, card)
    stamp(record, "20-23")
    # kernel 8's main path is the XLA ChEES kernel's (phase 23); phase 10's
    # count, its launches through the entry point, is kept beside it
    k8_entry = next(e for e in ghmc if e["name"] == "fused_logistic_hmc")
    k8_entry.update(launches=k8_launches, main_path=k8_route,
                    entry_point_launches=k8_entry["launches"])
    meads_k = meads_phases(torch, ops, diagnostics, data, pot, pg, q0,
                           record, nuts_mean, card)
    checkpoint_phases(torch, ops, diagnostics, data, pot, pg, q0, record,
                      nuts_mean, card)
    # kernels 5 and 6 on MEADS's routes: kernel 6 the fused default (phase
    # 24), kernel 5 the checkpointed route (phase 26), at MEADS's state
    for entry, role in zip(ghmc[:2], ("transition", "segment")):
        n = "5" if role == "transition" else "6"
        entry.update(meads_launches=meads_k[role],
                     meads_ms=meads_k["ms" + n],
                     meads_max_abs_err=meads_k["err" + n],
                     meads_bound_ms=meads_k["bound" + n])
    # phases 28-33: per-chain ε in kernels 1 and 2 and the driver options
    # on it; the entries of kernels 1 and 2 carry its measurements
    stamp(record, "24-27")
    per_chain = per_chain_kernel_phase(torch, nfs, data, pg, q0, tuned5,
                                       record, card)
    sorted_runs = sorted_funnel_phase(torch, ops, diagnostics, record, card)
    cells = funnel_eps_phase(torch, ops, record, card)
    search_phase(torch, ops, diagnostics, data, pot, pg, q0, record,
                 nuts_mean, card)
    pc_launches = per_chain_front_doors(torch, ops, diagnostics, data, pot,
                                        pg, q0, record, nuts_mean, card)
    ckpt_launches = sorted_checkpoint_phase(torch, ops, record, card)
    # phases 34-38: kernels 1-4 on generated functors; their entries carry
    # the generic fields
    stamp(record, "28-33")
    generic = generic_phases(torch, ops, diagnostics, gen_pots, data, pg, q0,
                             q_post, record, nuts_mean, card)
    # phases 39-43: kernels 5-7 on the generated and hierarchical functors,
    # the HMC-core front doors on a bare logprob_fn, eight schools and the
    # funnel on the HMC-core routes
    gen39 = hmc_generic_phase(torch, gen_pots, data, pg, q0, record, card)
    hier40 = hmc_hier_phase(torch, gen_pots, record, card)
    door = bare_front_doors(torch, ops, diagnostics, gen_pots, q0, record,
                            nuts_mean, card)
    hier43 = hier_hmc_front_doors(torch, ops, diagnostics, record, card)
    # phases 44-47: a device mesh; kernels 1-5 and 7 at a chain offset
    stamp(record, "34-43")
    offsets = offset_phase(torch, gen_pots, data, pg, q0, record, card)
    mesh_launches = mesh_phases(torch, ops, diagnostics, data, pot, pg, q0,
                                record, card)
    # phases 48-50: the op table's potentials on kernels 1, 3, 5 and 7 and
    # through the fused front doors
    stamp(record, "44-47")
    t_wait = time.perf_counter()
    later_build()  # joined: raises what the build raised
    log(f"phases 48-57's functors built beside phases 18-47 (waited "
        f"{time.perf_counter() - t_wait:.1f} s for them) [{card}]")
    ops48 = op_kernel_phase(torch, op_pots, gen_pots, record, card)
    doors49 = op_mvn_doors(torch, ops, diagnostics, op_pots, record, card)
    runs50 = op_negbin_doors(torch, ops, diagnostics, op_pots, record, card)
    # phases 51-53: the rest of the op table on R1-R3, on kernels 1-7 and
    # through the front doors; fault G's and lgamma's probes
    stamp(record, "48-50")
    ops51 = op_kernel_phase(torch, rest_pots, gen_pots, record, card,
                            phase=51, cells=REST_CELLS,
                            sampling=REST_SAMPLING)
    doors52 = rest_doors(torch, ops, diagnostics, rest_pots, record, card)
    t53 = time.perf_counter()
    fault_g_probe(torch, ops, record, card)
    lgamma_probe(torch, ops48, op_pots, record, card)
    log(f"phase 53 in {time.perf_counter() - t53:.1f} s [{card}]")
    # phases 54-55: the last of the op table on S1-S6 and op_extras, on
    # kernels 1-7 (S1's witness where K is not positive definite) and
    # through the fused NUTS, ChEES and MEADS doors
    stamp(record, "51-53")
    ops54 = op_kernel_phase(torch, last_pots, gen_pots, record, card,
                            phase=54, cells=LAST_CELLS,
                            sampling=LAST_SAMPLING, starts=LAST_STARTS)
    non_pd_witness(torch, last_pots["gp_se64"], record, card)
    doors55 = last_doors(torch, ops, diagnostics, last_pots, record, card)
    stamp(record, "54-55")
    # phases 56-57: the everyday ops on U1-U4 and the test-only cases, on
    # kernels 1,
    # 3, 5 and 7 (and the special functions against torch's), and through
    # the fused NUTS, ChEES, MEADS and dense-NUTS doors
    ops56 = op_kernel_phase(torch, every_pots, gen_pots, record, card,
                            phase=56, cells=EVERYDAY_CELLS, sampling={},
                            starts=EVERYDAY_STARTS)
    everyday_probe(torch, record, card)
    dense_node_probe(torch, record, card)
    doors57 = everyday_doors(torch, ops, diagnostics, every_pots, record,
                             card)
    stamp(record, "56-57")

    kernels = [
        kernel_entry("nuts_transition", "nuts_fused_small.cu",
                     "aehmc_tpu/ops/nuts_fused_small.py:459",
                     launches["nuts_transition"], err1, ms1, plain_ms1,
                     bound1),
        kernel_entry("nuts_sampling", "nuts_fused_small.cu",
                     "aehmc_tpu/ops/nuts_fused_small.py:545",
                     launches["nuts_sampling"], err4, ms2, plain_ms2, bound2),
        *hierarchical,
        *standard,
        *ghmc[:2],
        chees_entry,
        *ghmc[2:],
        *hmc_functor_entries(gen39, hier40, door, hier43, hmc_functors),
    ]
    for entry, n, launches_pc in (
            (kernels[0], "1", pc_launches["nuts_transition"]),
            (kernels[1], "2", pc_launches["nuts_sampling"])):
        (_, err, _), t, plain_ms = per_chain["flagship"]
        entry.update(per_chain_launches=launches_pc,
                     per_chain_max_abs_err=err,
                     per_chain_ms=t[f"k{n}_per_chain_ms"],
                     per_chain_const_ms=t[f"k{n}_const_ms"],
                     per_chain_scalar_ms=t[f"k{n}_scalar_ms"],
                     per_chain_bound_ms=t[f"k{n}_bound_ms"],
                     per_chain_bound_by=t[f"k{n}_bound_by"])
        if n == "1":
            entry.update(per_chain_plain_ms=plain_ms)
        else:
            entry.update(per_chain_draws=t["k2_draws"])
    for entry, n in zip(hierarchical[:2], ("1", "2")):
        (_, err, _), t = per_chain["funnel"]
        kernel = "nuts_transition_funnel" if n == "1" else "nuts_sampling_funnel"
        entry.update(
            sorted_launches=sorted_runs["sorted"]["launches"].get(kernel, 0),
            per_chain_cell_launches={c: r["launches"].get(kernel, 0)
                                     for c, r in cells.items()},
            checkpointed_sorted_launches=ckpt_launches.get(kernel, 0),
            per_chain_max_abs_err=err,
            per_chain_ms=t[f"k{n}_per_chain_ms"],
            per_chain_const_ms=t[f"k{n}_const_ms"],
            per_chain_scalar_ms=t[f"k{n}_scalar_ms"],
            per_chain_bound_ms=t[f"k{n}_bound_ms"],
            per_chain_bound_by=t[f"k{n}_bound_by"])
    for entry in kernels:
        names = ("nuts_transition", "nuts_sampling", "nuts_transition_std",
                 "nuts_sampling_std")
        if entry["name"] in names and "generic_ms" not in entry:
            entry.update(generic[names.index(entry["name"])])
    for entry in kernels:
        if entry["name"] in OFFSET_KERNELS:
            entry.update(offset_check=offsets[entry["name"]],
                         mesh_launches=mesh_launches.get(entry["name"]))
    op_table_fields(kernels, ops48, doors49, runs50)
    rest_table_fields(kernels, ops51, doors52)
    last_table_fields(kernels, ops54, doors55)
    last_table_fields(kernels, ops56, doors57)
    sampling_table_fields(kernels, ops48, ops51, ops54)
    record["kernels"] = kernels
    out_dir = Path(__file__).resolve().parent / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
