"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source for ``sm_90a`` into a shared library of its
own with a plain C interface, which ``load_kernels(source)`` loads with
``ctypes``; ``build_all`` compiles every source in parallel, one ``nvcc``
each, all started together.  The libraries
live in ``aehmc_tpu_torch/_build/`` (listed in ``.gitignore``) under names
keyed by a hash of the source, the shared headers and the flags, so an edit
rebuilds and an unchanged tree reuses them.  Nothing is built when the
module is imported.

A potential with no hand-written functor gets one generated from its traced
gradient graph (:mod:`aehmc_tpu_torch.ops.generic_pg`):
``load_generated(text)`` writes the functor to
``_build/generic_<hash>.cu``, keyed on its text (which holds its geometry:
its resident operands, tile rows and row stride, workspace placement,
``launch_plan.generic_geometry``), the headers, the templates
``csrc/nuts_generic.cu`` (kernels 1-4) and ``csrc/hmc_generic.cu``
(kernels 5-7) and the flags, compiles both templates with that file in
their include slot into one library, ``_build/libgeneric_<hash>.so``, at
the first bind of the potential, and loads it, so a potential bound once
serves all seven kernels; ``build_all(generated=texts)`` builds such
libraries in the same parallel batch as the sources.

Compile flags: no ``--use_fast_math`` (the kernels keep IEEE ``expf``,
``logf``, divisions and square roots), and ``-fmad=false`` so the compiler
contracts no multiply-add: the kernels' products use explicit ``fmaf``, and
everything else rounds as the plain PyTorch version writes it.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
HEADERS = ("common.cuh", "logistic_pg.cuh", "hierarchical_pg.cuh",
           "nuts_core.cuh", "hmc_core.cuh", "generic_pg.cuh")
# the templates of the library built on a generated functor, compiled into
# one: the NUTS kernels 1-4 and the HMC kernels 5-7
GENERIC_TEMPLATES = ("nuts_generic.cu", "hmc_generic.cu")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# the launch plan (blocks, points a chunk, X's row stride, shared memory,
# chains a block), then the stream
_GEOMETRY = [_I] * 5 + [_P]
# a generated functor: data pointers, lengths, their count, the workspace
_TABLE = [_P, _P, _I, _P]
# the randomness of a transition: the Philox flag, its key and chain0 (the
# launch's first global chain, a shard's offset); of a whole NUTS run: the
# key, chain0 and the draws (the GHMC segment, never sharded, takes no
# chain0)
_SEEDED, _KEYED = [_I, _U, _U], [_U, _U, _I]
# kernels 5 and 6 after the potential: eps, alpha rows, their scalars, M⁻¹,
# per-chain flag, threshold, then dim, C, L
_GHMC_PARAMS = [_P, _P, _F, _F, _P, _I, _F, _I, _I, _I]
# kernel 7 after the potential: eps row, M⁻¹, L⁻ᵀ, dense flag, L on the
# card, threshold, then dim, C
_CHEES_PARAMS = [_P] * 3 + [_I, _P, _F, _I, _I]
# source -> {C function: argtypes}
SIGNATURES = {
    "nuts_fused_small.cu": {
        "nuts_transition_launch": [_P] * 7 + _SEEDED + [_P, _I] + [_P] * 3
        + [_I, _F, _P, _F, _I, _I, _I, _I] + [_P] * 5 + _GEOMETRY,
        "nuts_sampling_launch": [_P] * 3 + _KEYED + [_P, _I] + [_P] * 3
        + [_I, _F, _P, _F, _I, _I, _I, _I] + [_P, _I] + [_P] * 5 + _GEOMETRY,
        "nuts_blocks_per_sm": [_I] * 3,
        "nuts_transition_pot_launch": [_P] * 7 + _SEEDED + [_I, _P, _P, _I]
        + [_P] * 2 + [_I, _F, _P, _F, _I, _I, _I] + [_P] * 5 + _GEOMETRY,
        "nuts_sampling_pot_launch": [_P] * 3 + _KEYED + [_I, _P, _P, _I]
        + [_P] * 2 + [_I, _F, _P, _F, _I, _I, _I] + [_P, _I] + [_P] * 5
        + _GEOMETRY,
        "nuts_pot_blocks_per_sm": [_I] * 3,
    },
    "nuts_fused.cu": {
        "nuts_transition_std_launch": [_P] * 7 + _SEEDED + [_P] * 3
        + [_F] * 3 + [_I] * 5 + [_P] * 5 + _GEOMETRY,
        "nuts_sampling_std_launch": [_P] * 3 + _KEYED + [_P] * 3
        + [_F] * 3 + [_I] * 5 + [_P] * 6 + _GEOMETRY,
        "nuts_std_blocks_per_sm": [_I] * 3,
    },
    "chees_fused.cu": {
        "chees_transition_launch": [_P] * 5 + _SEEDED + [_P, _I] + [_P] * 4
        + [_I, _P, _F] + [_I] * 3 + [_P] * 6 + _GEOMETRY,
        "chees_blocks_per_sm": [_I] * 4,
    },
    "ghmc_fused.cu": {
        "ghmc_transition_launch": [_P] * 6 + _SEEDED + [_P, _I] + [_P] * 3
        + [_F, _F, _P] + [_I, _F, _I, _I, _I, _I] + [_P] * 5 + _GEOMETRY,
        "ghmc_segment_launch": [_P] * 6 + [_I, _U, _I] + [_P, _I] + [_P] * 3
        + [_F, _F, _P] + [_I, _F, _I, _I, _I, _I] + [_P] * 6 + _GEOMETRY,
        "ghmc_blocks_per_sm": [_I] * 4,
    },
    "fused_hmc.cu": {
        "fused_hmc_launch": [_P] * 5 + [_F, _I, _F, _I, _I, _I] + [_P] * 2
        + _GEOMETRY,
        "fused_hmc_blocks_per_sm": [_I] * 2,
    },
    "leapfrog.cu": {
        "batched_leapfrog_launch": [_P] * 4 + [_F, _I, _I, _I] + [_P] * 3,
    },
}

# C function of a library built on a generated functor -> argtypes
GENERIC_SIGNATURES = {
    "generic_transition_launch": [_I] + [_P] * 7 + _SEEDED + [_P, _P, _I, _P]
    + [_P, _P, _I, _F, _P, _F, _I, _I, _I] + [_P] * 5 + _GEOMETRY,
    "generic_sampling_launch": [_I] + [_P] * 3 + _KEYED + [_P, _P, _I, _P]
    + [_P, _P, _I, _F, _P, _F, _I, _I, _I] + [_P, _I] + [_P] * 5 + _GEOMETRY,
    "generic_blocks_per_sm": [_I] * 3,
    "ghmc_transition_generic_launch": [_P] * 6 + _SEEDED + _TABLE
    + _GHMC_PARAMS + [_P] * 5 + _GEOMETRY,
    "ghmc_segment_generic_launch": [_P] * 6 + [_I, _U, _I] + _TABLE
    + _GHMC_PARAMS + [_P] * 6 + _GEOMETRY,
    "chees_transition_generic_launch": [_P] * 5 + _SEEDED + _TABLE
    + _CHEES_PARAMS + [_P] * 6 + _GEOMETRY,
    "hmc_generic_blocks_per_sm": [_I] * 3,
}

# seconds and compiler output of the builds this process ran (empty when
# every library was already built; ptxas_log() reads every build's)
BUILD_INFO = {}
# library (a source, or a generated functor's file) -> seconds its nvcc took
# from the start of the batch that built it (the builds run in parallel)
BUILD_SECONDS = {}
_libs = {}  # source -> loaded library
# generated functor text -> loaded library: the wrappers look a potential's
# library up at every launch, and its path hashes the headers read from
# disk (2.2 ms a launch on an H100 machine's host, PERF.md §6)
_generated_libs = {}


def _nvcc() -> str:
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built on a machine with the "
            "CUDA toolkit (set CUDA_HOME)"
        )
    return found


def _digest(names, extra: str = "") -> str:
    digest = hashlib.sha256()
    for name in names:
        digest.update((CSRC / name).read_bytes())
    digest.update(extra.encode())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def library_path(source: str) -> Path:
    return BUILD_DIR / f"lib{Path(source).stem}_{_digest((*HEADERS, source))}.so"


def generated_path(text: str) -> Path:
    """The library built on a generated functor's ``text``; its source is
    the ``.cu`` file of the same name beside it."""
    key = _digest((*HEADERS, *GENERIC_TEMPLATES), text)
    return BUILD_DIR / f"libgeneric_{key}.so"


def _functor_file(text: str) -> Path:
    return generated_path(text).with_name(
        generated_path(text).stem[3:] + ".cu")


def _build_missing(sources, generated=(), nice=0) -> None:
    """Start one nvcc per library of ``sources`` and of the ``generated``
    functor texts not built yet, all at once, and wait; ``nice`` lowers
    the compilers' priority (a build beside work that times the host)."""
    jobs = {}
    t0 = time.perf_counter()
    targets = [(source, library_path(source), [str(CSRC / source)])
               for source in sources]
    for text in generated:
        functor = _functor_file(text)
        targets.append((functor.name, generated_path(text), [
            f"-I{BUILD_DIR}", f"-DAEHMC_GENERIC_PG={functor.name}",
            *(str(CSRC / t) for t in GENERIC_TEMPLATES)]))
    for name, out, args in targets:
        if out.exists() or name in jobs:
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        if name.startswith("generic_"):
            functor = BUILD_DIR / name
            text = next(t for t in generated if _functor_file(t) == functor)
            tmp_src = functor.with_name(f"{functor.name}.{os.getpid()}.tmp")
            tmp_src.write_text(text)
            os.replace(tmp_src, functor)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *args]
        jobs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            preexec_fn=(lambda: os.nice(nice)) if nice else None,
        ))
    # each library's output, and its seconds from the batch's start to its
    # nvcc's exit
    said = {}

    def wait(name, proc):
        said[name] = (proc.communicate()[0], time.perf_counter() - t0)

    waits = [threading.Thread(target=wait, args=(name, job[2]))
             for name, job in jobs.items()]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    logs, failed = [], []
    for source, (out, tmp, proc) in jobs.items():
        text, BUILD_SECONDS[source] = said[source]
        logs.append(f"== {source}\n{text}")
        if proc.returncode:
            failed.append(f"nvcc failed on {source} ({proc.returncode}):\n{text}")
        else:
            out.with_suffix(".log").write_text(text)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    if jobs:
        BUILD_INFO.update(seconds=time.perf_counter() - t0,
                          log="\n".join(logs))


def ptxas_log() -> str:
    """nvcc's output (ptxas's registers and spills) of every library built
    from the current sources, one "== <source>" section each."""
    return "\n".join(
        f"== {source}\n{library_path(source).with_suffix('.log').read_text()}"
        for source in SIGNATURES
        if library_path(source).with_suffix(".log").exists())


def build_all(generated=()) -> None:
    """Build every library not built yet, the sources and the libraries of
    the ``generated`` functor texts in parallel."""
    _build_missing(SIGNATURES, tuple(generated))


def load_kernels(source: str) -> ctypes.CDLL:
    """Build (once per source hash) and load the library of ``source``."""
    if source not in _libs:
        _build_missing((source,))
        lib = ctypes.CDLL(str(library_path(source)))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return _libs[source]


def load_generated(text: str) -> ctypes.CDLL:
    """Build (once per text) and load the kernels 1-7 on a generated functor
    (``csrc/nuts_generic.cu`` and ``csrc/hmc_generic.cu`` with ``text`` in
    their include slot, one library)."""
    if text not in _generated_libs:
        _build_missing((), (text,))
        lib = ctypes.CDLL(str(generated_path(text)))
        for name, argtypes in GENERIC_SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _generated_libs[text] = lib
    return _generated_libs[text]


def generated_ptxas_log(text: str) -> str:
    """nvcc's output (ptxas's registers and spills) of the library built on
    a generated functor, or "" when this tree has not built it."""
    log = generated_path(text).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def generated_build_seconds(text: str):
    """nvcc's seconds on the library of a generated functor, or None when
    this process did not build it."""
    return BUILD_SECONDS.get(_functor_file(text).name)


def check_launch(lib, err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        raise RuntimeError(
            f"{name} launch failed: {lib.error_string(err).decode()}"
        )


def require_f32_cuda(name, t, shape, device) -> None:
    """Check a kernel operand: float32, on ``device``, of ``shape``,
    contiguous."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, the chains on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_x_cuda(X, num_points, dim, device) -> None:
    """Check the data matrix of a logistic kernel: float32 or bfloat16, on
    ``device``, ``(points, dim)``."""
    if not isinstance(X, torch.Tensor):
        raise TypeError(f"X must be a tensor, got {type(X).__name__}")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if X.device != device:
        raise ValueError(f"X is on {X.device}, the chains on {device}")
    if tuple(X.shape) != (num_points, dim):
        raise ValueError(f"X has shape {tuple(X.shape)}, expected "
                         f"{(num_points, dim)}")
