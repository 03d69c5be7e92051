"""Kernel times and end-to-end walls of the port on one CUDA card, at the
shapes ``chip_smoke.py`` uses (10,240 chains of the 100-d, 1,000-point
logistic regression).

Prints one JSON line: the CUDA-event mean of kernels 1-8 (``ms``; kernels
1-7 also with the model builder's default bfloat16 data where the tree's
kernels take them, else null), the card's SM clock read by ``nvidia-smi``
just after each reading (``sm_mhz``), and the host wall of one front-door
run each of fused NUTS, MALA and ChEES and of the standard-layout driver
(``wall_s``, after one untimed run of each).  Run it from a checkout's root,
``python3 -m aehmc_tpu_torch.timing``; copied into another checkout's
package it times that tree, so one call can time two trees in turns
(parent, change, change, parent).

Kernel 5 is also timed at its launch alone (``5 ghmc_transition (launch
only)``: the operands, the rows of ε and α and the plan prepared once, the
C launcher called directly), so the difference from the wrapper's reading
is the wrapper's own device work.

``--leapfrog`` times kernel 9 alone (``batched_leapfrog`` at 10,240 × 100,
L 10): its kernel time with L2 cold and warm (:func:`kernel_ms`), the
wrapper's host time a call (:func:`host_ms`) and back-to-back calls
(:func:`cuda_ms`, which reads the larger of the two), and prints them as one
JSON line; nothing else is timed.

``--schools-doors`` times eight schools' ChEES and MEADS front doors on
``models.schools_pg_t`` (chip_smoke phase 43's cell: 2,048 chains, 500 +
500), each three times in one process, the third under ``cProfile``, and
prints their walls and the profile's top entries (the host's share of a
front door whose kernels take microseconds); nothing else is timed.

``--outputs PATH`` also writes the outputs of kernels 1-8 at fixed seeds
and inputs, float32 and with bfloat16 operands (kernels 1-7), to an
``.npz`` (a kernel a tree cannot run with bfloat16 data is left out), so
two trees' outputs can be compared bit for bit: ``--compare A.npz B.npz``
prints, as one JSON line, which arrays of the two files are equal bit for
bit and which one file lacks (no card needed).
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

DIM, POINTS, CHAINS, K, EPS, IMM = 100, 1000, 10_240, 6, 0.5, 0.34
WARMUP, DRAWS, MALA_DRAWS, STEPS = 150, 200, 600, 10
# kernel_ms: bytes read before each launch to take the launch's inputs out
# of the 50 MB L2 (cold), launches captured in one CUDA graph, and timed
# replays of it (the median is kept)
FLUSH_BYTES, GRAPH_REPLAYS = 256 << 20, 5


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls after one warm-up."""
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


def graph_ms(launch, reps):
    """Device milliseconds a call of ``launch`` takes inside a CUDA graph of
    ``reps`` calls: the median over GRAPH_REPLAYS replays, each timed with
    CUDA events, over ``reps``.  No host time is in it; each call's reading
    holds the graph's gap between its launches (about a microsecond on an
    H100)."""
    launch()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(GRAPH_REPLAYS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


def kernel_ms(launch, reps, cold=False):
    """Device milliseconds of one call of ``launch`` (its kernels alone, no
    host time), from a CUDA graph of ``reps`` calls (:func:`graph_ms`).
    ``cold`` reads FLUSH_BYTES before each call, in the graph, so that L2
    holds none of its inputs and no dirty line for it to write back, and
    takes away the time of a graph of the reads alone: the difference also
    holds the write-back of the lines the call leaves dirty in L2, which
    the next read evicts, so every byte the call writes reaches memory in
    it.  Otherwise its inputs stay in L2 from the call before (warm)."""
    if not cold:
        return graph_ms(launch, reps)
    flush = torch.zeros(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    total = torch.zeros((), dtype=torch.float32, device="cuda")

    def read():
        torch.sum(flush, dim=0, out=total)

    def read_and_launch():
        read()
        launch()

    return graph_ms(read_and_launch, reps) - graph_ms(read, reps)


def host_ms(launch, reps):
    """Mean host milliseconds a call of ``launch`` takes to return (the
    kernel is queued, not waited for), over ``reps`` calls."""
    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        launch()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def leapfrog_times(card):
    """Kernel 9 at 10,240 × 100, L 10: through the wrapper, its kernel ms
    with L2 cold and warm (:func:`kernel_ms`), the wrapper's host ms a call
    and back-to-back ms (:func:`cuda_ms`); its C launcher alone (operands
    prepared once) cold and warm; and, as a yardstick, ``torch.cat`` of q
    and p (one kernel that copies the same bytes).  Each reading with the
    SM clock just after."""
    from aehmc_tpu_torch.ops import _build, batched_leapfrog

    rng = np.random.default_rng(9)
    q, p = (torch.tensor(rng.standard_normal((CHAINS, DIM)),
                         dtype=torch.float32, device="cuda")
            for _ in range(2))
    lam, im = (torch.linspace(a, b, DIM, device="cuda")
               for a, b in ((0.5, 2.0), (0.8, 1.2)))
    q_out, p_out = torch.empty_like(q), torch.empty_like(p)
    launcher = _build.load_kernels("leapfrog.cu").batched_leapfrog_launch
    args = (q.data_ptr(), p.data_ptr(), lam.data_ptr(), im.data_ptr(), 0.05,
            STEPS, DIM, CHAINS, q_out.data_ptr(), p_out.data_ptr())

    def k9():
        return batched_leapfrog(q, p, lam, im, 0.05, STEPS)

    def alone():  # the C launcher on the current stream (a graph's too)
        return launcher(*args, torch.cuda.current_stream().cuda_stream)

    readings = {
        "cold_ms": lambda: kernel_ms(k9, 50, cold=True),
        "warm_ms": lambda: kernel_ms(k9, 50),
        "host_ms": lambda: host_ms(k9, 200),
        "host: two outputs_ms": lambda: host_ms(
            lambda: (torch.empty_like(q), torch.empty_like(p)), 200),
        "host: current stream_ms": lambda: host_ms(
            lambda: torch.cuda.current_stream(q.device).cuda_stream, 200),
        "host: raw stream_ms": lambda: host_ms(
            lambda: torch._C._cuda_getCurrentRawStream(q.device.index), 200),
        "back_to_back_ms": lambda: cuda_ms(k9, 50),
        "cat_cold_ms": lambda: kernel_ms(lambda: torch.cat([q, p]), 50,
                                         cold=True),
        "cat_warm_ms": lambda: kernel_ms(lambda: torch.cat([q, p]), 50),
        "alone host_ms": lambda: host_ms(alone, 200),
        "alone cold_ms": lambda: kernel_ms(alone, 50, cold=True),
        "alone warm_ms": lambda: kernel_ms(alone, 50),
    }
    out, sm_mhz = {}, {}
    for label, fn in readings.items():
        out[label] = fn()
        sm_mhz[label] = sm_clock_mhz()
    return {"card": card, "tree": os.getcwd(), "leapfrog": out,
            "sm_mhz": sm_mhz}


def wall_s(fn):
    """Host seconds of the second of two calls, each ending in a
    synchronize."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def sm_clock_mhz():
    """The card's current SM clock (MHz), or None when nvidia-smi cannot
    tell."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True)
    try:
        return float(out.stdout.split()[0])
    except (IndexError, ValueError):
        return None


def ghmc_launch_only(gf, state, im, data):
    """Kernel 5's launch alone at α 0 under Philox: the operands, the rows of
    ε and α and the plan prepared once, then a call of the C launcher per
    launch (trees whose launcher also takes ε and α as scalars get the
    rows all the same)."""
    from aehmc_tpu_torch.ops._build import check_launch, load_kernels

    q_t, u0, g0, p0 = state
    got = gf._cuda_operands(q_t, u0, g0, p0, EPS, 0.0, im, data)
    ops, per_chain, plan, sizes = (got[0], *got[-3:])
    dim, num_points, num_chains = sizes[0], data[0].shape[0], sizes[-1]
    scalars = (0.0, 0.0) if len(got) == 5 else ()
    dev = q_t.device
    rows = [torch.full((num_chains,), v, dtype=torch.float32, device=dev)
            for v in (EPS, 0.0)]
    q_out, g_out, p_out = (torch.empty_like(q_t) for _ in range(3))
    u_out = torch.empty((1, num_chains), dtype=torch.float32, device=dev)
    stats = torch.empty((8, num_chains), dtype=torch.float32, device=dev)
    lib = load_kernels("ghmc_fused.cu")
    ptr = {k: v.data_ptr() for k, v in ops.items() if v is not None}
    # the Philox key 7 at chain offset 0
    args = (ptr["q"], ptr["u"], ptr["g"], ptr["p"], None, None, 1, 7, 0,
            ptr["X"], int(ops["X"].dtype == torch.bfloat16), ptr["y"],
            rows[0].data_ptr(), rows[1].data_ptr(), *scalars, ptr["im"],
            int(per_chain), 1000.0, dim, num_points, num_chains, 1,
            q_out.data_ptr(), u_out.data_ptr(), g_out.data_ptr(),
            p_out.data_ptr(), stats.data_ptr(), *plan.args(),
            torch.cuda.current_stream(dev).cuda_stream)
    check_launch(lib, lib.ghmc_transition_launch(*args), "ghmc_transition")
    return lambda: lib.ghmc_transition_launch(*args)


def schools_doors(card):
    """Eight schools' ChEES and MEADS front doors, three runs each (the
    first builds and binds, the third is profiled): walls, launches and
    the profile's 25 top cumulative entries."""
    import cProfile
    import io
    import pstats

    import aehmc_tpu_torch
    from aehmc_tpu_torch import ops
    from aehmc_tpu_torch.models import eight_schools, eight_schools_pg_t

    lp = eight_schools(device="cuda")[0]
    pot, pg, data, _ = eight_schools_pg_t(device="cuda")
    q0 = torch.tensor(0.1 * np.random.default_rng(43).standard_normal(
        (2048, 10)), dtype=torch.float32, device="cuda")

    def run(algorithm, **kw):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(43), lp, q0, 500, 500,
            algorithm=algorithm, path="fused", data=data, potential_fn_t=pot,
            potential_and_grad_t=pg, **kw)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0,
                {k: v for k, v in ops.LAUNCHES.items() if v})

    out = {"card": card}
    for algorithm, kw in (("chees", {}),
                          ("meads", dict(meads_recompute_every=8))):
        walls = [run(algorithm, **kw)[0]]
        wall, launches = run(algorithm, **kw)
        walls.append(wall)
        prof = cProfile.Profile()
        prof.enable()
        walls.append(run(algorithm, **kw)[0])
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(
            25)
        out[algorithm] = dict(wall_s=walls, launches=launches,
                              profile=text.getvalue())
    return out


def compare_outputs(path_a, path_b):
    """{"equal": [...], "differ": [...], "only_in_one": [...]} over the
    arrays of two ``--outputs`` files, compared bit for bit."""
    a, b = np.load(path_a), np.load(path_b)
    out = {"equal": [], "differ": [], "only_in_one": sorted(
        set(a.files) ^ set(b.files))}
    for key in sorted(set(a.files) & set(b.files)):
        x, y = a[key], b[key]
        same = (x.shape == y.shape and x.dtype == y.dtype
                and x.tobytes() == y.tobytes())
        out["equal" if same else "differ"].append(key)
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--outputs", help="write kernels 1-8's outputs at "
                        "fixed seeds to this .npz")
    parser.add_argument("--compare", nargs=2, metavar="NPZ",
                        help="compare two --outputs files bit for bit")
    parser.add_argument("--leapfrog", action="store_true",
                        help="time kernel 9 alone, and nothing else")
    parser.add_argument("--schools-doors", action="store_true",
                        help="time and profile eight schools' ChEES and "
                        "MEADS front doors, and nothing else")
    args = parser.parse_args(argv)
    if args.compare:
        print(json.dumps(compare_outputs(*args.compare)), flush=True)
        return 0

    import aehmc_tpu_torch
    from aehmc_tpu_torch.models import (
        logistic_regression,
        logistic_regression_pg_t,
    )
    from aehmc_tpu_torch.ops import _build
    from aehmc_tpu_torch.ops import chees_fused as cf
    from aehmc_tpu_torch.ops import fused_hmc as fh
    from aehmc_tpu_torch.ops import ghmc_fused as gf
    from aehmc_tpu_torch.ops import nuts_fused as nf
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.ops.fused_driver import sample_fused_adaptive

    if not torch.cuda.is_available():
        print("timing: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    if args.leapfrog:
        print(json.dumps(leapfrog_times(card)), flush=True)
        return 0
    if args.schools_doors:
        print(json.dumps(schools_doors(card)), flush=True)
        return 0
    _build.build_all()
    dev = torch.device("cuda")
    # the flagship's float32 data, as bench.py measures it
    pot, pg, data, _ = logistic_regression_pg_t(
        DIM, POINTS, matmul_dtype=torch.float32, device=dev)
    try:  # the builder's bfloat16 data, where the tree's kernels take them
        data16 = logistic_regression_pg_t(
            DIM, POINTS, matmul_dtype=torch.bfloat16, device=dev)[2]
    except NotImplementedError:
        data16 = None
    rng = np.random.default_rng(0)
    q0 = torch.tensor(0.1 * rng.standard_normal((CHAINS, DIM)),
                      dtype=torch.float32, device=dev)
    q_t = q0.T.contiguous()
    u0, g0 = pg(q_t, *data)
    im = torch.full((DIM,), IMM, device=dev)
    p0 = torch.tensor(np.sqrt(1 / IMM) * rng.standard_normal((DIM, CHAINS)),
                      dtype=torch.float32, device=dev)
    steps = torch.full((), STEPS, dtype=torch.int32, device=dev)
    X, y = data[0], data[2].reshape(-1)
    f32m = nf._logistic_model(X, y, 1.0, torch.float32)
    b16m = nf._logistic_model(X, y, 1.0, torch.bfloat16)
    us, gs = f32m.pot_grad(q0)
    cstate = (q0, u0.reshape(-1), g0.T.contiguous())
    lf_p = torch.tensor(rng.standard_normal((CHAINS, DIM)),
                        dtype=torch.float32, device=dev)

    def k1(d):
        return nfs.nuts_transition_cuda(q_t, u0, g0, im, EPS, d, max_exp=K,
                                        seed=11)

    def k2(d):
        return nfs.nuts_sampling_cuda(q_t, u0, g0, im, EPS, d, 5, 20,
                                      max_exp=K)

    def k3(m):
        return nf.nuts_transition_std_cuda(q0, us, gs, im, EPS, m.data,
                                           max_exp=K, card=m.card, seed=11)

    def k4(m):
        return nf.nuts_sampling_std_cuda(q0, us, gs, im, EPS, m.data, 5, 20,
                                         max_exp=K, card=m.card)

    kernels = {  # name: (call, repetitions)
        "1 nuts_transition": (lambda: k1(data), 10),
        "2 nuts_sampling (20 draws)": (lambda: k2(data), 3),
        "3 nuts_transition_std": (lambda: k3(f32m), 10),
        "4 nuts_sampling_std (20 draws, bf16)": (lambda: k4(b16m), 3),
        "4 nuts_sampling_std (20 draws, f32)": (lambda: k4(f32m), 3),
        "5 ghmc_transition": (lambda: gf.ghmc_transition_cuda(
            q_t, u0, g0, p0, EPS, 0.0, im, data, seed=7), 40),
        "5 ghmc_transition (launch only)": (
            ghmc_launch_only(gf, (q_t, u0, g0, p0), im, data), 40),
        "6 ghmc_segment (32 draws)": (lambda: gf.ghmc_segment_cuda(
            q_t, u0, g0, p0, EPS, 0.0, im, data, 32, seed=7), 5),
        "7 chees_transition (L 10)": (lambda: cf.chees_transition_cuda(
            *cstate, im, EPS, steps, data, seed=7), 20),
        "8 fused_logistic_hmc (L 10)": (lambda: fh.fused_logistic_hmc_cuda(
            q0, lf_p, X, y, im, 0.05, STEPS), 20),
        "3 nuts_transition_std (bf16)": (lambda: k3(b16m), 10),
    }
    if data16 is not None:
        kernels.update({
            "1 nuts_transition (bf16)": (lambda: k1(data16), 10),
            "2 nuts_sampling (20 draws, bf16)": (lambda: k2(data16), 3),
            "5 ghmc_transition (bf16)": (lambda: gf.ghmc_transition_cuda(
                q_t, u0, g0, p0, EPS, 0.0, im, data16, seed=7), 40),
            "6 ghmc_segment (32 draws, bf16)": (lambda: gf.ghmc_segment_cuda(
                q_t, u0, g0, p0, EPS, 0.0, im, data16, 32, seed=7), 5),
            "7 chees_transition (L 10, bf16)": (
                lambda: cf.chees_transition_cuda(*cstate, im, EPS, steps,
                                                 data16, seed=7), 20),
        })
    ms, sm_mhz = {}, {}
    for name, (fn, reps) in kernels.items():
        ms[name] = cuda_ms(fn, reps)
        sm_mhz[name] = sm_clock_mhz()

    def k5(d):
        return gf.ghmc_transition_cuda(q_t, u0, g0, p0, EPS, 0.0, im, d,
                                       seed=7)

    def k6(d):  # the final state and stats (the positions are 131 MB)
        return gf.ghmc_segment_cuda(q_t, u0, g0, p0, EPS, 0.9, im, d, 32,
                                    seed=7, collect_positions=False)

    def k7(d):
        return cf.chees_transition_cuda(*cstate, im, EPS, steps, d, seed=7)

    if args.outputs:
        outs = {"k1_f32": k1(data), "k2_f32": k2(data),
                "k3_f32": k3(f32m), "k3_bf16": k3(b16m),
                "k4_f32": k4(f32m), "k4_bf16": k4(b16m),
                "k5_f32": k5(data), "k6_f32": k6(data), "k7_f32": k7(data),
                "k8_f32": fh.fused_logistic_hmc_cuda(q0, lf_p, X, y, im,
                                                     0.05, STEPS)}
        if data16 is not None:
            outs.update(k1_bf16=k1(data16), k2_bf16=k2(data16),
                        k5_bf16=k5(data16), k6_bf16=k6(data16),
                        k7_bf16=k7(data16))
        arrays = {f"{name}_{i}": t.cpu().numpy()
                  for name, out in outs.items()
                  for i, t in enumerate(out) if t is not None}
        np.savez(args.outputs, **arrays)

    logprob_fn, _ = logistic_regression(DIM, POINTS, device=dev)
    front = dict(data=data, potential_fn_t=pot, potential_and_grad_t=pg)
    walls = {
        "fused NUTS": lambda: aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(2026), None, q0, DRAWS, WARMUP,
            algorithm="nuts", path="fused", max_num_expansions=K,
            initial_step_size=0.1, collect_dtype=torch.bfloat16, **front),
        "fused MALA": lambda: aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(11), None, q0, MALA_DRAWS, WARMUP,
            algorithm="mala", path="fused", initial_step_size=0.1,
            segment_draws=32, **front),
        "fused ChEES": lambda: aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(14), logprob_fn, q0, DRAWS, WARMUP,
            algorithm="chees", path="fused", data=data,
            potential_and_grad_t=pg, initial_step_size=0.05),
        "standard driver": lambda: sample_fused_adaptive(
            torch.Generator().manual_seed(16), nf.logistic_potential,
            f32m.data, q0, DRAWS, WARMUP, max_num_expansions=K,
            initial_step_size=0.1),
        "sample_fused_logistic (bf16)": lambda: nf.sample_fused_logistic(
            torch.Generator().manual_seed(161), X, y, q0, DRAWS, 0.5, IMM,
            max_num_expansions=K, loop_in_kernel=True),
    }
    out = {}
    for name, fn in walls.items():
        out[name] = wall_s(fn)
        sm_mhz[name] = sm_clock_mhz()
    print(json.dumps({"card": card, "tree": os.getcwd(), "ms": ms,
                      "wall_s": out, "sm_mhz": sm_mhz}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
