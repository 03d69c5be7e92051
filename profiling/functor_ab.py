"""Time kernels 1 and 7 on every generated functor chip_smoke.py runs, in
one tree's package, for A/B runs of two trees in one chip session.

The functors: the flagship's traced logistic potential (10,240 chains,
ε 0.05), P1-P4 (phase 48's cells, ``OPS_CELLS``), R1-R3 (``REST_CELLS``),
S1-S6 and ``op_extras`` (``LAST_CELLS``, ``LAST_STARTS``), U1-U4 and the
test-only functors (``EVERYDAY_CELLS``, ``EVERYDAY_STARTS``); each from
0.1·N(0, 1) (seed 4848) plus its start, M⁻¹ 1, K as its cell, kernel 7 at
L 10.  Each functor's text is hashed, so two trees' runs show which
functors' texts the change left as they were.  Every library is built
first, one nvcc each, all at once.

Run from the root of a checkout (``--pkg`` imports the package from
another directory, say a parent commit unpacked into ``scratch/``):

    python profiling/functor_ab.py --out FILE [--pkg DIR] [--names a,b]

Prints one JSON line per functor and writes them all to ``--out``.
"""
import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=ROOT)
    ap.add_argument("--out", required=True)
    ap.add_argument("--names", default="")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.pkg))
    sys.path.insert(1, ROOT)
    import torch

    import aehmc_tpu_torch
    import chip_smoke as cs
    from aehmc_tpu_torch.ops import _build, generic_pg
    from aehmc_tpu_torch.ops import chees_fused as cf
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.timing import kernel_ms

    assert aehmc_tpu_torch.__file__.startswith(os.path.abspath(args.pkg))
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    # name: (bound, rows, potential, (dim, chains, ε, M⁻¹, K), start)
    cases = {}
    gen = cs.generic_potentials(torch, dev)
    cases["flagship"] = (gen["binds"]["flagship"], (), gen["flagship_t"],
                         (cs.DIM, 10_240, 0.05, 1.0, cs.K), None)
    for pots, cells, starts in (
            (cs.op_table_potentials(torch, dev), cs.OPS_CELLS, {}),
            (cs.rest_potentials(torch, dev), cs.REST_CELLS, {}),
            (cs.last_potentials(torch, dev), cs.LAST_CELLS, cs.LAST_STARTS),
            (cs.everyday_potentials(torch, dev), cs.EVERYDAY_CELLS,
             cs.EVERYDAY_STARTS)):
        for name, p in pots.items():
            cases[name] = (p["bound"], p["rows"], p["pot"], cells[name],
                           starts.get(name))
    if args.names:
        cases = {k: v for k, v in cases.items()
                 if k in args.names.split(",")}
    texts = tuple(dict.fromkeys(c[0].source for c in cases.values()))
    _build._build_missing((), texts)
    print(f"{args.pkg}: {len(cases)} functors traced and built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    card = cs.card_identity()
    out = dict(pkg=args.pkg, card=card, runs={})
    steps = torch.full((), cs.LEAPFROG_STEPS, dtype=torch.int32, device=dev)
    for name, (b, rows, pot, (dim, chains, eps, imm_v, k), start) in \
            cases.items():
        rng = np.random.default_rng(cs.OPS_SEED)
        q = 0.1 * rng.standard_normal((dim, chains))
        if start is not None:
            q += np.asarray(start, np.float64)[:, None]
        q_t = torch.tensor(q, dtype=torch.float32, device=dev)
        u0, g0 = generic_pg.run_plain(b.ir, q_t, b.operands(rows, dev))
        imm = torch.full((dim,), imm_v, device=dev)
        kw = dict(potential_and_grad_t=None, potential_fn_t=pot)
        q_s, g_s = q_t.T.contiguous(), g0.T.contiguous()

        def k1():
            return nfs.nuts_transition_cuda(q_t, u0, g0, imm, eps, rows,
                                            max_exp=k, seed=cs.OPS_SEED + 1,
                                            **kw)

        def k7():
            return cf.chees_transition_cuda(q_s, u0.reshape(-1), g_s, imm,
                                            eps, steps, rows,
                                            seed=cs.OPS_SEED + 1, **kw)

        k1(), k7()
        torch.cuda.synchronize()
        rec = dict(sha=hashlib.sha256(b.source.encode()).hexdigest()[:16],
                   chains=chains, k1_ms=kernel_ms(k1, 3),
                   k7_ms=kernel_ms(k7, 3))
        out["runs"][name] = rec
        print(name, json.dumps(rec), flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=1)


if __name__ == "__main__":
    main()
