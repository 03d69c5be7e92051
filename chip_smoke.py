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
  the two leapfrog kernels (``fused_logistic_hmc``, ``batched_leapfrog``);
- phase 11, fused MALA: 150 warmup steps from ε 0.1 and 600 float32 draws
  in segments of 32 (the JAX benchmark's ``mala_10k_fused`` cell);
- phase 12, fused GHMC at α 0.9: 150 warmup steps and 200 draws.

Launch counts are reset just before each front-door run and read just after.
Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card and ``nvcc``; it exits non-zero, printing no result, when there is no
card or any phase fails.  The line before the last is a JSON object with each
kernel's launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Full measurements are also written to
``chiprun_out/chip_smoke.json``.
"""

import json
import math
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
LEAPFROG_STEPS = 10           # phase 10
# Split R-hat of a stationary chain with autocorrelation time tau and n
# draws per split chain is about sqrt((n - 1) / (n - tau)), 1.027 for MALA's
# tau of about 16.5 at 600 draws.  MALA and GHMC are held, per dimension, to
# that value (tau from the same run's bulk ESS) plus RHAT_EXCESS.
RHAT_EXCESS = 0.005
# lag-1 autocorrelation of the draw-to-draw moves: near 0 for MALA (-0.073
# on an H100), high when the momentum persists (0.558 at alpha 0.9)
MALA_MOVE_AC, GHMC_MOVE_AC = 0.1, 0.3
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12  # H100 SXM: f32 FLOP/s (no tensor cores), HBM B/s
GRAD_FLOP = 4 * DIM * POINTS  # X·q and Xᵀ·r, 2 FLOP per multiply-add
DEVICE = "cuda:0"


def log(msg):
    print(msg, flush=True)


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


def cuda_ms(torch, fn, reps):
    """Mean milliseconds per call of ``fn`` over ``reps`` calls after one
    warm-up call, by CUDA events."""
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


def compare(kernel_out, plain_out, what):
    """Decisions equal on >= 99% of chains; q within 1e-3 on those.
    Returns (share, max_abs_err, chains that differ)."""
    qk, _, _, sk = kernel_out
    qp, _, _, sp = plain_out
    same = same_decisions(sk, sp)
    share = float(same.float().mean())
    err = float((qk - qp).abs()[..., same].max()) if bool(same.any()) else math.inf
    check(share >= DECISION_SHARE, f"{what}: decisions agree on {share:.4f}")
    check(err <= Q_ATOL, f"{what}: max |q| error {err:.3g} on agreeing chains")
    return share, err, int((~same).sum())


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flop, moved):
    """(ms, what binds): the larger of the FLOP over the float32 peak and the
    bytes over the memory rate."""
    t_op, t_mem = flop / PEAK_F32, moved / PEAK_BYTES
    return max(t_op, t_mem) * 1e3, "operations" if t_op >= t_mem else "bytes"


def kernel_entry(name, source, replaces, launches, err, ms, plain_ms, bnd):
    return dict(name=name, route="cuda", source=f"aehmc_tpu_torch/csrc/{source}",
                replaces=replaces, launches=launches, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=None)


def ghmc_compare(torch, q_in, kernel_out, plain_out, what):
    """GHMC decisions (accepted, divergent, and the selected energy to 1e-5
    relative) equal on >= 99% of chains in every draw; q within 1e-3 on
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
    check(err <= Q_ATOL, f"{what}: max |q| error {err:.3g} on agreeing chains")
    return share, err, int((~same).sum())


def chunked(torch, fn, x, step):
    """``fn`` over slices of the last axis of ``x`` (chains, draws, dim)."""
    return torch.cat([fn(x[:, :, i:i + step]) for i in range(0, x.shape[2], step)])


def mean_mcse(torch, diagnostics, x, ess=None):
    """Per-dimension mean and its Monte Carlo standard error (sd / √ESS) of
    draws ``x (chains, draws, dim)``."""
    if ess is None:
        ess = chunked(torch, diagnostics.effective_sample_size, x, 10)
    flat = x.reshape(-1, x.shape[2])
    return flat.mean(dim=0), flat.std(dim=0) / torch.sqrt(ess)


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
        f"alpha 0 and {GHMC_ALPHA}, external and Philox randomness: "
        f"decisions equal on >= {share5:.4%} of chains "
        f"({sum(d for _, _, d in shares)} chain-cases differ), max |q| err "
        f"{err5:.3g}; kernel {ms5:.3f} ms, plain {plain_ms5:.3f} ms per "
        f"transition, bound {bound5[0]:.3f} ms ({bound5[1]}) [{card}]")
    record["phase8"] = dict(min_share=share5, max_abs_err=err5, ms=ms5,
                            plain_ms=plain_ms5, bound_ms=bound5[0])

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
                            ms=ms6, plain_ms=plain_ms6, bound_ms=bound6[0])
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
    check(torch.equal(k9[0], r9[0]) and torch.equal(k9[1], r9[1]),
          "kernel 9 differs from its plain version")
    ms8 = cuda_ms(torch, lambda: ops.fused_logistic_hmc(*hmc_args), 10)
    plain_ms8 = cuda_ms(torch, lambda: fused_logistic_hmc_reference(*hmc_args), 5)
    ms9 = cuda_ms(torch, lambda: ops.batched_leapfrog(*lf_args), 50)
    plain_ms9 = cuda_ms(torch, lambda: batched_leapfrog_reference(*lf_args), 10)
    bound8 = bound(CHAINS * (LEAPFROG_STEPS + 1) * GRAD_FLOP,
                   nbytes(q0, lf_p, X, y, im, *k8))
    bound9 = bound(9 * CHAINS * DIM * LEAPFROG_STEPS,
                   nbytes(q0, lf_p, lam, im_lf, *k9))
    log(f"phase 10: fused_logistic_hmc vs plain at {CHAINS}x{DIM}, L "
        f"{LEAPFROG_STEPS}: max |err| {err8:.3g}; kernel {ms8:.3f} ms, plain "
        f"{plain_ms8:.3f} ms, bound {bound8[0]:.3f} ms ({bound8[1]}); "
        f"batched_leapfrog == plain bit for bit; kernel {ms9 * 1e3:.1f} us, "
        f"plain {plain_ms9 * 1e3:.1f} us, bound {bound9[0] * 1e3:.1f} us "
        f"({bound9[1]}) [{card}]")
    record["phase10"] = dict(err8=err8, ms8=ms8, plain_ms8=plain_ms8,
                             bound_ms8=bound8[0], ms9=ms9,
                             plain_ms9=plain_ms9, bound_ms9=bound9[0])

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
        kernel_entry("batched_leapfrog", "leapfrog.cu",
                     "aehmc_tpu/ops/leapfrog.py:68",
                     leapfrog_launches["batched_leapfrog"], 0.0, ms9,
                     plain_ms9, bound9),
    ]


def front_door_checks(torch, diagnostics, res, nuts_mean, what):
    """The limits of a MALA or GHMC front-door run, set before the run:
    acceptance, divergences, finite draws, each dimension's split R-hat
    within RHAT_EXCESS of its stationary value, and each posterior mean
    within MCSE_Z combined MCSE of the NUTS run's (``nuts_mean``: means and
    MCSE)."""
    diag = res.diagnostics
    x = res.positions.transpose(0, 1)  # (chains, draws, dim)
    rhat = chunked(torch, lambda v: diagnostics.potential_scale_reduction(
        v, rank_normalized=True), x, 20)
    ess = chunked(torch, diagnostics.effective_sample_size, x, 10)
    n = x.shape[1] // 2  # draws per split chain
    tau = x.shape[0] * 2 * n / ess
    excess = rhat - torch.sqrt((n - 1) / (n - tau))
    mean, mcse = mean_mcse(torch, diagnostics, x, ess)
    z = (mean - nuts_mean[0]).abs() / torch.sqrt(mcse**2 + nuts_mean[1]**2)
    out = dict(
        accept=float(diag.acceptance_probability.mean()),
        divergent_share=float(diag.is_diverging.float().mean()),
        step_size=float(res.step_size),
        max_rhat=float(rhat.max()),
        max_rhat_excess=float(excess.max()),
        tau_max=float(tau.max()), tau_median=float(tau.median()),
        max_z_vs_nuts=float(z.max()),
        finite=bool(torch.isfinite(res.positions).all()),
    )
    check(0.7 <= out["accept"] <= 0.9, f"{what} mean acceptance {out['accept']}")
    check(out["divergent_share"] < 1e-4,
          f"{what} divergent share {out['divergent_share']}")
    check(out["max_rhat_excess"] < RHAT_EXCESS,
          f"{what} R-hat exceeds its stationary value by "
          f"{out['max_rhat_excess']} (max R-hat {out['max_rhat']})")
    check(out["max_z_vs_nuts"] < MCSE_Z,
          f"{what} posterior means differ from NUTS by {out['max_z_vs_nuts']} "
          f"MCSE")
    check(out["finite"], f"{what}: non-finite draws")
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
    from aehmc_tpu_torch.ops.nuts_fused import DRAW_SEED_STRIDE, derive_draw_seeds
    from aehmc_tpu_torch.ops.philox import MASK32

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(DEVICE)
    record = {}

    # ---- phase 1: identity and build
    card = card_identity()
    kind = torch.cuda.get_device_name(0)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    log(card)
    log(f"phase 1: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, kernels built/loaded in {build_s:.1f} s")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line or line.startswith("=="):
            log(f"  ptxas: {line.strip()}")
    record.update(card=card, kind=kind, build_s=build_s)

    pot, pg, data, _ = logistic_regression_pg_t(DIM, POINTS, device=dev)
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
    ms1, plain_ms1 = cuda_ms(torch, k1_ext, 5), cuda_ms(torch, p1_ext, 3)
    leaves = float(out_k[3][3].mean())
    bound1 = bound(float(out_k[3][3].sum()) * GRAD_FLOP,
                   nbytes(q_t, u0, g0, imm, *data, *ext.values(), *out_k))
    log(f"phase 2: nuts_transition vs plain at {CHAINS}x{DIM}, K={K}: "
        f"decisions equal on {share:.4%} of chains ({ndiff} differ), max |q| "
        f"err {err1:.3g}; "
        f"kernel {ms1:.3f} ms, plain {plain_ms1:.3f} ms per transition "
        f"(mean {leaves:.1f} leaves/chain) [{card}]")
    record["phase2"] = dict(share=share, differ=ndiff, max_abs_err=err1, ms=ms1,
                            plain_ms=plain_ms1, mean_leaves=leaves)

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
    record["phase2"]["bound_ms"] = bound1[0]
    record["phase4"]["bound_ms"] = bound2[0]
    ghmc = ghmc_phases(torch, ops, diagnostics, data, pot, pg, q0, record,
                       nuts_mean, card)

    kernels = [
        kernel_entry("nuts_transition", "nuts_fused_small.cu",
                     "aehmc_tpu/ops/nuts_fused_small.py:459",
                     launches["nuts_transition"], err1, ms1, plain_ms1,
                     bound1),
        kernel_entry("nuts_sampling", "nuts_fused_small.cu",
                     "aehmc_tpu/ops/nuts_fused_small.py:545",
                     launches["nuts_sampling"], err4, ms2, plain_ms2, bound2),
        *ghmc,
    ]
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
