"""Whether two trees' generated functors give the same results bit for bit.

Runs, in one tree's package, the front doors whose kernels take a generated
functor at chip_smoke.py's phases 36 and 41 (and 38's NUTS door), from the
same seeded states, and saves every result; given a second file, compares
the two bit for bit.  The state: 0.1·N(0, 1) starts (seed 5) walked 150
draws by the hand-written fused NUTS route (LogisticPGT, which neither
tree changes) to the posterior; then

- phase 36: ``ops.sample_fused`` on the standard-layout cell potential
  (kernels 3, a launch a draw, and 4, one launch), seed 36, 200 draws;
- phase 38: the fused NUTS front door on the flagship's bare logprob
  (kernels 1 and 2), seed 5, 150 + 200;
- phase 41: the MALA, GHMC (α 0.9) and ChEES front doors on the same
  logprob (kernels 5, 6 and 7), seeds 11, 12 and 14;
- phase 54 (``--last``): kernels 1 and 2 (4 draws) on S1 ``gp_se64`` and
  kernel 1 on S2 ``gp_se64_logdet`` at phase 54's cell (1,024 chains from
  0.1·N(0, 1), seed 54, ε 0.02, K 4): their positions, potentials,
  gradients and statistics, through which a node whose order of terms
  changed shows (``--only-last`` runs these alone);
- phase 56 (``--only-everyday``, alone): kernels 1 and 2 (4 draws) on U3
  ``ctmc_cav`` and U4 ``ppca_qr`` at phase 56's cells (EVERYDAY_CELLS and
  EVERYDAY_STARTS, seed 56), through their matrix exponentials, QR and
  SVD.

Run from the root of a checkout (``--pkg`` imports the package from
another directory, say one that profiling/decompose_generic.py staged):

    python profiling/bits_vs_parent.py --out A.pt [--pkg DIR] [--against B.pt]
        [--last] [--only-last] [--only-everyday]
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pkg", default=ROOT)
    ap.add_argument("--out", required=True)
    ap.add_argument("--against")
    ap.add_argument("--last", action="store_true")
    ap.add_argument("--only-last", action="store_true")
    ap.add_argument("--only-everyday", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.pkg))
    sys.path.insert(1, ROOT)
    import torch

    import aehmc_tpu_torch
    import chip_smoke as cs
    from aehmc_tpu_torch import ops
    from aehmc_tpu_torch.ops import nuts_fused as nf

    assert aehmc_tpu_torch.__file__.startswith(os.path.abspath(args.pkg))
    dev = torch.device("cuda:0")
    t0 = time.perf_counter()
    out = {}
    if args.last or args.only_last:
        out.update(last_kernels(torch, cs, dev))
    if args.only_everyday:
        out.update(everyday_kernels(torch, cs, dev))
    if not (args.only_last or args.only_everyday):
        out.update(doors(torch, cs, dev, aehmc_tpu_torch, ops, nf))
    torch.cuda.synchronize()
    out["launches"] = dict(ops.LAUNCHES)
    print(f"{args.pkg}: {len(out) - 1} results in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    torch.save(out, args.out)
    if args.against:
        ref = torch.load(args.against)
        same = {k: bool(torch.equal(v, ref[k])) for k, v in out.items()
                if k != "launches" and k in ref}
        print({"bit_for_bit": same, "all": all(same.values())}, flush=True)
        for k, v in out.items():
            if k != "launches" and k in same and not same[k]:
                d = (v.double() - ref[k].double()).abs()
                d = d[torch.isfinite(d)]
                print(k, "max |diff|", float(d.max()) if d.numel() else 0.0,
                      "differing share",
                      float((v != ref[k]).float().mean()), flush=True)


def last_kernels(torch, cs, dev):
    """Phase 54's S1 and S2 launches (see the module)."""
    from aehmc_tpu_torch.ops import generic_pg
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs

    pots = cs.last_potentials(torch, dev)
    out = {}
    for name in ("gp_se64", "gp_se64_logdet"):
        dim, chains, eps, imm_v, k = cs.LAST_CELLS[name]
        p = pots[name]
        b, rows = p["bound"], p["rows"]
        q = np.random.default_rng(54).standard_normal((dim, chains))
        q_t = torch.tensor(0.1 * q, dtype=torch.float32, device=dev)
        u0, g0 = generic_pg.run_plain(b.ir, q_t, b.operands(rows, dev))
        imm = torch.full((dim,), imm_v, device=dev)
        kw = dict(potential_and_grad_t=None, potential_fn_t=p["pot"])
        o1 = nfs.nuts_transition_cuda(q_t, u0, g0, imm, eps, rows,
                                      max_exp=k, seed=541, **kw)
        out[f"phase54/{name}/k1/q"] = o1[0].cpu()
        out[f"phase54/{name}/k1/u"] = o1[1].cpu()
        out[f"phase54/{name}/k1/g"] = o1[2].cpu()
        out[f"phase54/{name}/k1/stats"] = o1[3].cpu()
        if name == "gp_se64":
            o2 = nfs.nuts_sampling_cuda(q_t, u0, g0, imm, eps, rows, 542,
                                        cs.OPS_SAMPLING_DRAWS, max_exp=k,
                                        **kw)
            out[f"phase54/{name}/k2/positions"] = o2[0].cpu()
            out[f"phase54/{name}/k2/stats"] = o2[1].cpu()
    return out


def everyday_kernels(torch, cs, dev):
    """Phase 56's U3 and U4 launches (see the module)."""
    from aehmc_tpu_torch.ops import generic_pg
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs

    names = ("ctmc_cav", "ppca_qr")
    pots = cs.everyday_potentials(torch, dev, names)
    out = {}
    for name in names:
        dim, chains, eps, imm_v, k = cs.EVERYDAY_CELLS[name]
        p = pots[name]
        b, rows = p["bound"], p["rows"]
        q = 0.1 * np.random.default_rng(56).standard_normal((dim, chains))
        q += np.asarray(cs.EVERYDAY_STARTS.get(name, np.zeros(dim)))[:, None]
        q_t = torch.tensor(q, dtype=torch.float32, device=dev)
        u0, g0 = generic_pg.run_plain(b.ir, q_t, b.operands(rows, dev))
        imm = torch.full((dim,), imm_v, device=dev)
        kw = dict(potential_and_grad_t=None, potential_fn_t=p["pot"])
        o1 = nfs.nuts_transition_cuda(q_t, u0, g0, imm, eps, rows,
                                      max_exp=k, seed=561, **kw)
        for i, part in enumerate(("q", "u", "g", "stats")):
            out[f"phase56/{name}/k1/{part}"] = o1[i].cpu()
        o2 = nfs.nuts_sampling_cuda(q_t, u0, g0, imm, eps, rows, 562,
                                    cs.OPS_SAMPLING_DRAWS, max_exp=k, **kw)
        out[f"phase56/{name}/k2/positions"] = o2[0].cpu()
        out[f"phase56/{name}/k2/stats"] = o2[1].cpu()
    return out


def doors(torch, cs, dev, aehmc_tpu_torch, ops, nf):
    """Phases 36, 38 and 41 (see the module)."""
    gen = cs.generic_potentials(torch, dev)
    X, y = gen["X"], gen["y"]
    g = torch.Generator(device="cpu").manual_seed(5)
    q0 = (0.1 * torch.randn(cs.CHAINS, cs.DIM, generator=g)).to(dev)
    imm = torch.full((cs.DIM,), cs.GEN_IMM, device=dev)
    hand = nf._logistic_model(X, y, 1.0, torch.float32)
    _, pos, _ = ops.sample_fused(
        torch.Generator().manual_seed(5), nf.logistic_potential, hand.data,
        q0, 150, cs.GEN_EPS, imm, max_num_expansions=cs.K,
        internal_prng=True, loop_in_kernel=True)
    q_post = pos[-1].contiguous()
    out = {}
    for name, loop in (("per_draw", False), ("whole_run", True)):
        _, p, st = ops.sample_fused(
            torch.Generator().manual_seed(36), gen["cell"], (X, y), q_post,
            cs.DRAWS, cs.GEN_EPS, imm, max_num_expansions=cs.K,
            internal_prng=True, loop_in_kernel=loop)
        out[f"phase36/{name}/positions"] = p.cpu()
        out[f"phase36/{name}/stats"] = st.cpu()
    lp = gen["logprob_fn"]

    def door(algorithm, draws, seed, **kw):
        res = aehmc_tpu_torch.sample(
            torch.Generator().manual_seed(seed), lp, q_post, draws,
            cs.WARMUP, algorithm=algorithm, path="fused", **kw)
        return res.positions.cpu()

    ghmc = dict(initial_step_size=0.1, segment_draws=cs.SEGMENT)
    out["phase38/nuts"] = door("nuts", cs.DRAWS, 5)
    out["phase41/mala"] = door("mala", cs.MALA_DRAWS, 11, **ghmc)
    out["phase41/ghmc"] = door("ghmc", cs.GHMC_DRAWS, 12,
                               ghmc_alpha=cs.GHMC_ALPHA, **ghmc)
    out["phase41/chees"] = door("chees", cs.DRAWS, 14,
                                initial_step_size=cs.CHEES_EPS0)
    return out


if __name__ == "__main__":
    main()
