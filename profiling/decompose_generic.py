"""Decompose the time of kernels 7, 3 and 1 on generated potential functors.

``ncu`` does not run on the card's machine, so this script builds variants
of a generated functor's text and times them on the card:

- ``probe``: clock64() stamps around each of the functor's top-level
  statements, which lane 0 of each warp adds into per-warp counters of a
  device array (one a translation unit: the NUTS and HMC templates each
  read back their own).  Categories: the k-loop of a warp-each product
  (operand loads and fused multiply-adds), its ``warp_sum``s and stores,
  loop groups holding a one-lane-an-output product, the other loop groups
  (elementwise values, lane-strided sums, workspace traffic), the warp
  reductions after them, the tile's chunk waits and block barriers
  (``chunk_ready``), sequential nodes, scalar statements, the whole call,
  and the time between a warp's calls (the core's work and its block
  barrier).  The dense linear algebra is split by node kind (the emitter's
  methods are wrapped to mark each node's statements): ``chol``,
  ``trsolve_1`` (a triangular solve of one right side), ``trsolve_n``
  (several), ``lusolve``, ``slogdet``, ``lufactor``, ``mexp`` (a batch of
  matrix exponentials, its arguments' copies included), ``qr``, ``svd``,
  and ``ws_mm`` (a loop group holding a matrix product of two workspace
  matrices);
- ``noload``: every read of a float data operand replaced by a value of
  its index (the loads' share, by difference; kernel 7 only, whose work
  does not depend on the values);
- ``wsshared``: the workspace in shared memory whatever it costs in
  blocks an SM (one NUTS block an SM where two do not fit), against the
  plan's choice;
- ``l2``: the plain text at ``--l2-chains`` chains (default 128: S1's
  workspace, 115 KB a chain, then fits the 50 MB L2; at 1,024 chains it
  does not), each block alone on its SM at either count, so the time a
  launch against the base run's is where the workspace's matrices live,
  L2 against HBM;
- ``fglobal``: the dense nodes' matrices in global memory (the
  workspace), where the geometry puts them in a factor scratch in shared
  memory (a tree whose ``launch_plan`` has ``generic_factor_shared``);
  ``fshared``: in the factor scratch wherever one NUTS block holds it,
  where the geometry leaves them in the workspace;
- ``untiled``: a product of two workspace matrices one output a lane at a
  time, not in tiles of two rows (``_Emitter.ws_product``);
- ``c4096``: the plain text at 4,096 chains (512 blocks), and
  ``fglobal4096`` / ``fshared4096`` those texts there: one block an SM
  against two at a count that fills the card more than once.

Run from the root of a checkout (this script stays in the tree; ``--tree``
takes the package from another checkout, say a parent commit unpacked into
``scratch/``):

    python profiling/decompose_generic.py [--tree DIR] [--out FILE]
        [--names flagship,cell,probit100,softmax_reg] [--chains N]
        [--variants base,probe,noload,wsshared,l2,fglobal,fshared,untiled,
                    c4096,fglobal4096,fshared4096]

``--names gp_se64,gp_se64_logdet`` (S1, S2) runs kernels 1 and 3 (and
kernel 2 on S1, 4 draws) at chip_smoke.py's phase 54 cell: 1,024 chains,
ε 0.02, K 4.  ``--names ctmc_cav,ppca_qr`` (U3, U4) runs kernels 1, 2 (4
draws) and 3 at phase 56's cells (``EVERYDAY_CELLS``: U3 4,096 chains, ε
0.01, its start at the data's log rates; U4 1,024 chains, ε 0.002; K 6).

The base texts of the named potentials are built first, each library by
its own nvcc and all at once, and each one's seconds are reported
(``build_s_by_name``): nvcc's time on a functor, the cost an inlined body
adds.

The package is copied into ``scratch/decompose/<tag>/`` and given the
profile buffer there (``--reuse`` keeps an earlier run's copy and
libraries: parent, change, change, parent in one session builds each tree
once); nothing of the tree itself changes.  Prints one JSON
line per run and writes them all to ``--out`` (default
``profiling/out/decompose.json``, which git ignores).
"""
import argparse
import ctypes
import json
import os
import re
import shutil
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ["chol", "trsolve_1", "trsolve_n", "lusolve", "slogdet", "lufactor",
         "mexp", "qr", "svd", "ws_mm"]
CATS = ["we_loop", "we_sum", "loop_contract", "loop_elem", "loop_post",
        "chunk_wait", "sequential", "scalar", *KINDS, "total", "between",
        "calls"]
C = {name: i for i, name in enumerate(CATS)}
DRAWS_K2 = 4  # kernel 2's draws (chip_smoke.py's OPS_SAMPLING_DRAWS)
SLOTS = 32  # counters a warp; the last holds the warp's last exit stamp
LAST = SLOTS - 1


def stage(tree, tag, reuse=False):
    """A copy of ``tree``'s package with the profile buffer and readers
    (with ``reuse``, the copy an earlier run of the same tag staged, and
    the libraries it built)."""
    dst = os.path.join(ROOT, "scratch", "decompose", tag)
    if reuse and os.path.isdir(dst):
        return dst
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(tree, "aehmc_tpu_torch"),
                    os.path.join(dst, "aehmc_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    csrc = os.path.join(dst, "aehmc_tpu_torch", "csrc")
    path = os.path.join(csrc, "generic_pg.cuh")
    text = open(path).read()
    text = text.replace(
        "namespace aehmc {\nnamespace generic {",
        "namespace aehmc {\nstatic __device__ unsigned long long "
        f"gpg_prof[4096 * 8 * {SLOTS}];\nnamespace generic {{", 1)
    open(path, "w").write(text)
    for name, tag_ in (("nuts_generic.cu", "nuts"), ("hmc_generic.cu", "hmc")):
        path = os.path.join(csrc, name)
        with open(path, "a") as fh:
            fh.write(f'''
extern "C" int gpg_prof_{tag_}(unsigned long long* out, int n, int reset) {{
  cudaError_t e = cudaSuccess;
  if (out) e = cudaMemcpyFromSymbol(out, aehmc::gpg_prof, (size_t)n * 8);
  if (reset) {{
    void* p;
    cudaGetSymbolAddress(&p, aehmc::gpg_prof);
    e = cudaMemset(p, 0, sizeof(aehmc::gpg_prof));
  }}
  return (int)e;
}}
''')
    # the caller's chip_smoke.py: the same potentials on either package
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
    return dst


# ------------------------------------------------------ text variants --
def _blocks(lines, start, indent):
    """Top-level statements of the body from ``start`` at ``indent``:
    (first, last) line indices, a block running to its closing brace."""
    out, i = [], start
    pad = " " * indent
    while i < len(lines):
        line = lines[i]
        if not line.startswith(pad) or line.startswith(pad + " ") or \
                line.strip() in ("}", "};"):
            if line.startswith(pad + " ") or line == "":
                i += 1
                continue
            break
        j = i
        if line.rstrip().endswith("{"):
            while lines[j] != pad + "}":
                j += 1
        out.append((i, j))
        i = j + 1
    return out


def _category(block):
    text = "\n".join(block)
    first = block[0].strip()
    if first.startswith("for (int ch"):
        return None  # split inside
    if first.startswith("for (int o0"):
        return None
    if first.startswith("for (int i = lane") or first.startswith(
            "for (int i = c0"):
        return "loop_contract" if "for (int k = 0" in text or \
            "for (int k = c0" in text else "loop_elem"
    if re.match(r"const float r\d+ = (warp_sum|gpg_warp_max|gpg_warp_prod)",
                first) or first == "__syncwarp();":
        return "loop_post"
    if first.startswith("for ") or first.startswith("if (") is False and \
            first.endswith("{"):
        return "sequential"
    return "scalar"


def probe_text(text):
    """The functor's text with its statements stamped (see the module)."""
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines) if "operator()(" in ln)
    body0 = next(i for i in range(start, len(lines))
                 if lines[i].startswith("    ") and "= data.ptr" not in
                 lines[i] and "int_row(" not in lines[i] and "S.res" not in
                 lines[i] and "(void)" not in lines[i] and "const " not in
                 lines[i][:10] and "float* __restrict__" not in lines[i]
                 and i > start + 3)
    out = lines[:body0]
    out += ["    const long long _te = clock64();",
            "    unsigned long long* _pf = aehmc::gpg_prof + "
            f"((size_t)blockIdx.x * 8 + c) * {SLOTS};",
            "    if (lane == 0) { if (_pf[%d]) _pf[%d] += _te - _pf[%d]; "
            "_pf[%d] += 1; }" % (LAST, C["between"], LAST, C["calls"])]
    n = 0
    blocks = _blocks(lines, body0, 4)
    end = blocks[-1][1] + 1
    kind = None  # the node kind a marker opened (see marked_text)
    for a, b in blocks:
        block = lines[a:b + 1]
        first = block[0].strip()
        n += 1
        if first.startswith("// @kind "):
            kind = first.split()[-1]
            continue
        if first == "// @end":
            kind = None
            continue
        if kind is not None:
            out += [f"    long long _s{n} = clock64();"] + block + [
                f"    if (lane == 0) _pf[{C[kind]}] += clock64() - _s{n};"]
            continue
        if first.startswith(("for (int o0", "for (int ch", "for (int gi")):
            out += _split_loop(block, n)
            continue
        if first.startswith("if (lane == 0) S.nu[c]"):
            out += block
            continue
        cat = _category(block)
        if first.startswith("const float r") or first.startswith("float a") \
                or first.startswith("const int ") or first.startswith(
                    "const float t"):
            # declarations the rest reads: stamp without a scope
            out += [f"    long long _s{n} = clock64();"] + block + [
                f"    if (lane == 0) _pf[{C[cat]}] += clock64() - _s{n};"]
            continue
        out += [f"    long long _s{n} = clock64();"] + block + [
            f"    if (lane == 0) _pf[{C[cat]}] += clock64() - _s{n};"]
    out += ["    if (lane == 0) { const long long _tx = clock64(); "
            f"_pf[{C['total']}] += _tx - _te; _pf[{LAST}] = _tx; }}"]
    out += lines[end:]
    return "\n".join(out)


def _ws_matrix(ir, nid, stored):
    """Whether operand ``nid`` of a product is a workspace matrix seen
    through views."""
    from_views = nid
    while ir.nodes[from_views].op in ("reshape", "permute", "expand",
                                      "slice", "select", "flip"):
        from_views = ir.nodes[from_views].args[0]
    n = ir.nodes[from_views]
    return from_views in stored and len([d for d in n.shape if d > 1]) >= 2


def marked_text(gp, ir):
    """The functor's text with each dense linear algebra node's statements
    between ``// @kind <kind>`` and ``// @end`` comments (probe_text
    attributes them to the kind): the emitter's node methods, and loop
    groups holding a product of two workspace matrices, wrapped while it
    emits.  Comments only: the code is the plain text's."""
    E = gp._Emitter
    saved = {}

    def wrap(name, kind_of):
        orig = getattr(E, name)
        saved[name] = orig

        def method(self, nid, lines, *a, **kw):
            kind = kind_of(self, nid)
            if kind:
                lines.append(f"// @kind {kind}")
            res = orig(self, nid, lines, *a, **kw)
            if kind:
                lines.append("// @end")
            return res
        setattr(E, name, method)

    def solve_kind(self, nid):
        return "trsolve_1" if self.ir.nodes[nid].shape[-1] == 1 \
            else "trsolve_n"

    for name in ("chol", "lusolve", "slogdet", "lufactor", "mexp", "qr",
                 "svd"):
        if hasattr(E, name):
            wrap(name, lambda self, nid, name=name: name)
    wrap("trsolve", solve_kind)

    orig_group = E.loop_group
    saved["loop_group"] = orig_group

    def loop_group(self, n, roots, lines, unit=0):
        mm = any(r != "g" and self.ir.nodes[r].op == "mm" and all(
            _ws_matrix(self.ir, a, self.stored)
            for a in self.ir.nodes[r].args) for r in roots)
        if mm:
            lines.append("// @kind ws_mm")
        res = orig_group(self, n, roots, lines, unit)
        if mm:
            lines.append("// @end")
        return res
    E.loop_group = loop_group
    try:
        return gp.emit_cuda(ir)
    finally:
        for name, orig in saved.items():
            setattr(E, name, orig)


def _split_loop(block, n):
    """A warp-each or chunk loop: its k-loops (loads and multiply-adds),
    its warp sums, its chunk wait and refill, and its sum passes."""
    out = []
    t = f"_k{n}"
    out.append(f"    long long {t} = clock64();")
    i = 0
    while i < len(block):
        line = block[i]
        s = line.strip()
        ind = line[:len(line) - len(line.lstrip())]
        if s == "chunk_ready();":
            out.append(f"{ind}{t} = clock64();")
            out.append(line)
            i += 1
            while not block[i].strip().startswith("const float* __restrict"
                                                  "__ T ="):
                out.append(block[i])
                i += 1
            out.append(f"{ind}if (lane == 0) _pf[{C['chunk_wait']}] += "
                       f"clock64() - {t};")
            out.append(f"{ind}{t} = clock64();")
            continue
        if s.startswith(("for (int k = lane", "for (int k = c0 + lane")):
            out.append(f"{ind}{t} = clock64();")
            depth = 0
            while True:
                out.append(block[i])
                depth += block[i].count("{") - block[i].count("}")
                i += 1
                if depth == 0:
                    break
            out.append(f"{ind}if (lane == 0) _pf[{C['we_loop']}] += "
                       f"clock64() - {t};")
            out.append(f"{ind}{t} = clock64();")
            continue
        if s.startswith(("for (int i = lane", "for (int i = c0",
                         "for (int k = c0; ")):
            cat = "loop_contract"
            out.append(f"{ind}{t} = clock64();")
            depth = 0
            while True:
                out.append(block[i])
                depth += block[i].count("{") - block[i].count("}")
                i += 1
                if depth == 0:
                    break
            out.append(f"{ind}if (lane == 0) _pf[{C[cat]}] += "
                       f"clock64() - {t};")
            continue
        if s.startswith("const float sum = gpg_warp_sums"):
            out += [line, block[i + 1]]
            out.append(f"{ind}if (lane == 0) _pf[{C['we_sum']}] += "
                       f"clock64() - {t};")
            i += 2
            continue
        if s.startswith("acc") and "warp_sum" in s or s.startswith(
                "if (lane == 0) ws["):
            out.append(line)
            if s.startswith("if (lane == 0) ws[") and (
                    i + 1 >= len(block) or not block[i + 1].strip()
                    .startswith("acc")):
                out.append(f"{ind}if (lane == 0) _pf[{C['we_sum']}] += "
                           f"clock64() - {t};")
            i += 1
            continue
        out.append(line)
        i += 1
    return out


def noload_text(text):
    """Every read of a float data operand (global or from the tile) made a
    value of its index."""
    floats = set(re.findall(r"const float\* __restrict__ (D\d+) = data",
                            text))
    body = text[text.index("operator()("):]
    head = text[:text.index("operator()(")]
    for d in floats:
        body = re.sub(r"__ldg\(%s \+ ([^;]*)\);" % d,
                      r"((float)((\1) & 7) * 0.125f);", body)
    body = re.sub(r"= T\[([^;]*)\];", r"= ((float)((\1) & 7) * 0.125f);",
                  body)
    return head + body


def ptxas_summary(log):
    """{function: [registers or None, stack frame bytes, spill store bytes,
    spill load bytes]} from nvcc's -Xptxas -v output: every entry function
    and every function compiled out of line."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[1].strip()
        elif "bytes stack frame" in line and fn:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)[:3]]
            out.setdefault(fn, [None])[1:] = nums
        elif "Compiling entry function" in line:
            fn = line.split("'")[1]
        elif "Used" in line and "registers" in line and fn:
            out.setdefault(fn, [None, None, None, None])[0] = int(
                line.split("Used")[1].split()[0])
    return out


# ------------------------------------------------------------ the runs --
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--tag", default="tree")
    ap.add_argument("--out", default=os.path.join(ROOT, "profiling", "out",
                                                  "decompose.json"))
    ap.add_argument("--names", default="flagship,cell,probit100,softmax_reg")
    ap.add_argument("--variants", default="base,probe,noload,wsshared")
    ap.add_argument("--chains", type=int, default=10_240)
    ap.add_argument("--l2-chains", type=int, default=128)
    ap.add_argument("--reuse", action="store_true",
                    help="keep the copy (and libraries) of an earlier run "
                    "of the same --tag")
    args = ap.parse_args()
    dst = stage(os.path.abspath(args.tree), args.tag, args.reuse)
    sys.path.insert(0, dst)
    import numpy as np
    import torch

    import chip_smoke as cs
    from aehmc_tpu_torch.ops import _build
    from aehmc_tpu_torch.ops import chees_fused as cf
    from aehmc_tpu_torch.ops import generic_pg as gp
    from aehmc_tpu_torch.ops import launch_plan as lp
    from aehmc_tpu_torch.ops import nuts_fused as nf
    from aehmc_tpu_torch.ops import nuts_fused_small as nfs
    from aehmc_tpu_torch.timing import kernel_ms

    assert gp.__file__.startswith(dst), gp.__file__
    dev = torch.device("cuda:0")
    names = args.names.split(",")
    flag = {"flagship", "cell", "probit100", "softmax_reg"} & set(names)
    # name: (bound, rows, potential, dim, kernels, ε, K, chains)
    cases = {}
    if flag:
        gen = cs.generic_potentials(torch, dev)
        ops = cs.op_table_potentials(torch, dev)
        rest = cs.rest_potentials(torch, dev)
        cases.update({
            "flagship": (gen["binds"]["flagship"], (), gen["flagship_t"],
                         100, ("k7", "k3"), 0.05, 6, args.chains),
            "cell": (gen["binds"]["cell"], (gen["X"], gen["y"]), None, 100,
                     ("k3",), 0.05, 6, args.chains),
            "probit100": (ops["probit100"]["bound"],
                          ops["probit100"]["rows"], ops["probit100"]["pot"],
                          100, ("k7", "k3"), 0.05, 6, args.chains),
            "softmax_reg": (rest["softmax_reg"]["bound"],
                            rest["softmax_reg"]["rows"],
                            rest["softmax_reg"]["pot"], 100, ("k7", "k3"),
                            0.05, 6, args.chains)})
    last = (cs.last_potentials(torch, dev)
            if {"gp_se64", "gp_se64_logdet"} & set(names) else {})
    for name, kernels in (("gp_se64", ("k1", "k2", "k3")),
                          ("gp_se64_logdet", ("k1", "k3"))):
        if name in last:
            dim, chains, eps, _, k = cs.LAST_CELLS[name]
            cases[name] = (last[name]["bound"], last[name]["rows"],
                           last[name]["pot"], dim, kernels, eps, k, chains)
    every = [n for n in ("ctmc_cav", "ppca_qr") if n in names]
    every_pots = cs.everyday_potentials(torch, dev, every) if every else {}
    starts = {}  # name: the state's mean (phase 56's EVERYDAY_STARTS)
    for name in every:
        dim, chains, eps, _, k = cs.EVERYDAY_CELLS[name]
        cases[name] = (every_pots[name]["bound"], every_pots[name]["rows"],
                       every_pots[name]["pot"], dim, ("k1", "k2", "k3"), eps,
                       k, chains)
        if name in cs.EVERYDAY_STARTS:
            starts[name] = np.asarray(cs.EVERYDAY_STARTS[name], np.float64)
    variants = args.variants.split(",")
    chains_of = {"l2": args.l2_chains, "c4096": 4096, "fglobal4096": 4096,
                 "fshared4096": 4096}

    class Patch:
        """``obj.attr`` replaced by ``fn`` while emitting and launching a
        variant."""

        def __init__(self, obj, attr, fn):
            self.obj, self.attr, self.fn = obj, attr, fn

        def __enter__(self):
            self.f = getattr(self.obj, self.attr)
            setattr(self.obj, self.attr, self.fn)

        def __exit__(self, *a):
            setattr(self.obj, self.attr, self.f)

    one_block = getattr(lp, "generic_factor_shared", None)

    def patch_of(v):
        if v == "wsshared":
            return Patch(lp, "generic_workspace_shared",
                         lambda dim, w, fixed=0: w > 0)
        if v.startswith("fglobal"):
            return Patch(lp, "generic_factor_shared", lambda *a, **kw: False)
        if v.startswith("fshared"):
            return Patch(lp, "generic_factor_shared",
                         lambda dim, f, fixed=0, lu=False:
                         one_block(dim, f, fixed, True))
        if v == "untiled":
            return Patch(gp._Emitter, "ws_product", lambda self, nid: False)
        return None

    def fits_hmc_shared(b):  # at one NUTS block an SM, if not two
        geo = getattr(b, "geometry", None)
        fixed = geo.fixed_floats if geo is not None else 0
        smem = 4 * (17 * 8 * lp.state_stride(b.ir.dim) + 8 + fixed
                    + 8 * b.workspace)
        return smem <= lp.SMEM_LIMIT

    texts, geos = {}, {}
    for name in names:
        b = cases[name][0]
        for v in variants:
            if v == "wsshared" and not fits_hmc_shared(b):
                continue
            if v.startswith("fglobal") and (
                    one_block is None
                    or not getattr(b.geometry, "factor_floats", 0)):
                continue
            if v.startswith("fshared") and (
                    one_block is None
                    or getattr(b.geometry, "factor_floats", 0)):
                continue
            if v == "untiled" and not hasattr(gp._Emitter, "ws_product"):
                continue
            if v in ("wsshared", "fglobal", "fglobal4096", "fshared",
                     "fshared4096", "untiled"):
                with patch_of(v):
                    texts[(name, v)] = gp.emit_cuda(b.ir)
                    if hasattr(gp, "geometry_of"):
                        geos[(name, v)] = gp.geometry_of(b.ir)
            elif v == "probe":
                texts[(name, v)] = probe_text(marked_text(gp, b.ir))
            elif v == "noload":
                texts[(name, v)] = noload_text(b.source)
            else:
                texts[(name, v)] = b.source
    # each named potential's base library by its own nvcc, all at once
    build_s_by_name, failed = {}, []

    def timed_build(name, text):
        t = time.perf_counter()
        try:
            _build._build_missing((), (text,))
        except Exception as err:  # noqa: BLE001 - raised after the join
            failed.append(err)
        build_s_by_name[name] = time.perf_counter() - t

    t0 = time.perf_counter()
    base = {name: texts[(name, "base")] for name in names
            if (name, "base") in texts}
    threads = [threading.Thread(target=timed_build, args=item)
               for item in base.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if failed:
        raise failed[0]
    print("built", ", ".join(f"{k} in {v:.1f} s"
                             for k, v in build_s_by_name.items()), flush=True)
    _build.build_all(generated=tuple(set(texts.values())))
    res = dict(tree=args.tree, tag=args.tag, chains=args.chains,
               build_s=time.perf_counter() - t0,
               build_s_by_name=build_s_by_name, runs={},
               ptxas={name: ptxas_summary(_build.generated_ptxas_log(text))
                      for name, text in base.items()})
    for name, rep in res["ptxas"].items():
        print(args.tag, name, "ptxas", json.dumps(rep), flush=True)
    print(f"built {len(set(texts.values()))} libraries in "
          f"{res['build_s']:.1f} s", flush=True)
    rng = np.random.default_rng(19)
    for name in names:
        b, rows, pot, dim, kernels, eps, k, chains0 = cases[name]
        ops_b = b.operands(rows, dev)
        imm = torch.ones(dim, device=dev)
        steps = torch.full((), 10, dtype=torch.int32, device=dev)
        src0, geo0 = b.source, getattr(b, "geometry", None)
        states = {}
        for v in variants:
            if (name, v) not in texts:
                continue
            chains = chains_of.get(v, chains0)
            if chains not in states:
                q = torch.tensor(0.1 * rng.standard_normal((chains, dim))
                                 + starts.get(name, 0.0),
                                 dtype=torch.float32, device=dev)
                u0, g0 = gp.run_plain(b.ir, q.T.contiguous(), ops_b)
                states[chains] = (q, u0.reshape(-1), g0.T.contiguous())
            q, u0, g0 = states[chains]
            b.source = texts[(name, v)]
            if geo0 is not None:
                b.geometry = geos.get((name, v), geo0)
            lib = b.library()
            ctx = patch_of(v)
            if ctx:
                ctx.__enter__()
            try:
                for kern in kernels:
                    if v == "noload" and kern != "k7":
                        continue
                    gkw = (dict(potential_and_grad_t=None,
                                potential_fn_t=pot) if pot else {})
                    if kern == "k7":
                        def f(kw=gkw):
                            return cf.chees_transition_cuda(
                                q, u0, g0, imm, eps, steps, rows, seed=7,
                                **kw)
                        tag = "hmc"
                    elif kern == "k1":
                        q_t, u_t, g_t = (q.T.contiguous(), u0.reshape(1, -1),
                                         g0.T.contiguous())

                        def f(kw=gkw):
                            return nfs.nuts_transition_cuda(
                                q_t, u_t, g_t, imm, eps, rows, max_exp=k,
                                seed=7, **kw)
                        tag = "nuts"
                    elif kern == "k2":
                        q_t, u_t, g_t = (q.T.contiguous(), u0.reshape(1, -1),
                                         g0.T.contiguous())

                        def f(kw=gkw):
                            return nfs.nuts_sampling_cuda(
                                q_t, u_t, g_t, imm, eps, rows, 9, DRAWS_K2,
                                max_exp=k, **kw)
                        tag = "nuts"
                    else:
                        def f():
                            return nf.nuts_transition_std_cuda(
                                q, u0.reshape(-1, 1), g0, imm, eps, rows,
                                max_exp=k, seed=7, bound=b)
                        tag = "nuts"
                    out = f()
                    torch.cuda.synchronize()
                    rec = dict(chains=chains,
                               ms=(cs.cuda_ms(torch, f, 1) if kern == "k2"
                                   else kernel_ms(f, 3)))
                    if kern == "k3":
                        rec["leaves"] = float(out[3][:, 3].sum())
                    elif kern == "k1":
                        rec["leaves"] = float(out[3][3].sum())
                    if v == "probe" and kern != "k2":
                        n = ((chains + 7) // 8) * 8 * SLOTS
                        buf = (ctypes.c_ulonglong * n)()
                        getattr(lib, f"gpg_prof_{tag}")(None, 0, 1)
                        f()
                        torch.cuda.synchronize()
                        getattr(lib, f"gpg_prof_{tag}")(buf, n, 0)
                        a = np.frombuffer(buf, dtype=np.uint64).reshape(
                            -1, SLOTS).astype(np.float64)
                        tot = a[:, C["total"]].sum() + a[:, C["between"]].sum()
                        rec["shares"] = {c: float(a[:, C[c]].sum() / tot)
                                         for c in CATS[:-1]}
                        rec["calls_per_warp"] = float(a[:, C["calls"]].mean())
                        calls = a[:, C["calls"]].sum()
                        rec["cycles_per_call"] = {
                            c: float(a[:, C[c]].sum() / calls)
                            for c in CATS[:-2]}
                    res["runs"][f"{name}/{kern}/{v}"] = rec
                    print(args.tag, name, kern, v, json.dumps(rec),
                          flush=True)
            finally:
                if ctx:
                    ctx.__exit__()
        b.source = src0
        if geo0 is not None:
            b.geometry = geo0
    if not flag:
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(res, fh, indent=1)
        return
    # LogisticPGT on the same inputs, in the same process
    X, y = gen["X"], gen["y"]
    data = (X, X.T.contiguous(), y.reshape(-1, 1))
    q = torch.tensor(0.1 * rng.standard_normal((chains, 100)),
                     dtype=torch.float32, device=dev)
    b = gen["binds"]["flagship"]
    u0, g0 = gp.run_plain(b.ir, q.T.contiguous(), b.operands((), dev))
    u0, g0 = u0.reshape(-1), g0.T.contiguous()
    imm = torch.ones(100, device=dev)
    steps = torch.full((), 10, dtype=torch.int32, device=dev)
    hand = nf._logistic_model(X, y, 1.0, torch.float32)
    res["runs"]["logistic/k7/hand"] = dict(ms=kernel_ms(
        lambda: cf.chees_transition_cuda(q, u0, g0, imm, 0.05, steps, data,
                                         seed=7), 3))
    res["runs"]["logistic/k3/hand"] = dict(ms=kernel_ms(
        lambda: nf._transition(hand, q, u0.reshape(-1, 1), g0, None, None,
                               None, None, imm, 0.05, seed=7, max_exp=6,
                               divergence_threshold=1000.0), 3))
    print(args.tag, "logistic", json.dumps(res["runs"]["logistic/k7/hand"]),
          json.dumps(res["runs"]["logistic/k3/hand"]), flush=True)
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
