#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Builds both CUDA NUTS kernels from ``aehmc_tpu_torch/csrc``, holds each
against its plain PyTorch version at the flagship shape, then drives the
flagship through the port's front door (``aehmc_tpu_torch.sample``): 10,240
chains of the 100-d, 1,000-point logistic regression, 150 Stan warmup steps
and 200 draws with max_num_expansions=6 and bf16 draw storage.

Run from the repository root: ``python3 chip_smoke.py``.  It needs one CUDA
card and ``nvcc``; it exits non-zero, printing no result, when there is no
card or any phase fails.  The line before the last is a JSON object with each
kernel's launches, error and times; the last line is
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
EPS, IMM = 0.5, 0.34          # phase 2-4 kernel inputs
DECISION_SHARE = 0.99         # chains whose decisions must match exactly
Q_ATOL = 1e-3                 # |q_kernel - q_plain| on those chains
MCSE_Z = 4.5                  # phase 6: per-dimension mean agreement
PHASE6_CHAINS = 1024
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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import aehmc_tpu_torch
    from aehmc_tpu_torch import diagnostics
    from aehmc_tpu_torch.models import logistic_regression_pg_t
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
    _build.load_kernels()
    build_s = time.perf_counter() - t0
    log(card)
    log(f"phase 1: {kind}, torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, kernels built/loaded in {build_s:.1f} s")
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "spill" in line:
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
    nfs.reset_launch_counts()
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
    launches = dict(nfs.LAUNCHES)
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

    def mean_mcse(x):
        ess = diagnostics.effective_sample_size(x)
        sd = x.reshape(-1, DIM).std(dim=0)
        return x.reshape(-1, DIM).mean(dim=0), sd / torch.sqrt(ess)

    (ma, sa), (mb, sb) = mean_mcse(a), mean_mcse(b)
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

    def timed(fn, runs):
        times, out = [], None
        for r in range(runs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(r)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return float(np.median(times)), out

    t_warm, ((qw, _, _), eps7, imm7) = timed(
        lambda r: warmup_fused(torch.Generator().manual_seed(10 + r),
                               transition, q0, u0s, g0s, WARMUP,
                               max_num_expansions=K, initial_step_size=0.1),
        3,
    )
    t_samp, (_, pos7, stats7) = timed(
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

    kernels = [
        dict(name="nuts_transition", route="cuda",
             source="aehmc_tpu_torch/csrc/nuts_fused_small.cu",
             replaces="aehmc_tpu/ops/nuts_fused_small.py:459",
             launches=launches["nuts_transition"], max_abs_err=err1,
             ms=ms1, plain_ms=plain_ms1),
        dict(name="nuts_sampling", route="cuda",
             source="aehmc_tpu_torch/csrc/nuts_fused_small.cu",
             replaces="aehmc_tpu/ops/nuts_fused_small.py:545",
             launches=launches["nuts_sampling"], max_abs_err=err4,
             ms=ms2, plain_ms=plain_ms2),
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
