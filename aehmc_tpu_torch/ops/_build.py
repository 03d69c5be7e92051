"""Build and load the CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles the sources for ``sm_90a`` into a shared library with a
plain C interface, which is loaded with ``ctypes``.  The library lives in
``aehmc_tpu_torch/_build/`` (listed in ``.gitignore``) under a name keyed by
a hash of the sources and flags, so an edit rebuilds and an unchanged tree
reuses the library.  Nothing is built when the module is imported.

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
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parents[1]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
SOURCES = ("nuts_fused_small.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
)

# seconds and compiler output of the build this process ran (empty when the
# library was already built)
BUILD_INFO = {}

_lib = None

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_SIGNATURES = {
    "nuts_transition_launch": [_P] * 7 + [_I, _U] + [_P] * 5
    + [_I, _F, _F, _I, _I, _I, _I] + [_P] * 5,
    "nuts_sampling_launch": [_P] * 3 + [_U, _I] + [_P] * 5
    + [_I, _F, _F, _I, _I, _I, _I] + [_P, _I] + [_P] * 5,
}


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


def library_path() -> Path:
    digest = hashlib.sha256()
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libaehmc_kernels_{digest.hexdigest()[:16]}.so"


def load_kernels() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in SOURCES)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True, check=False)
        if res.returncode:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)
        BUILD_INFO.update(seconds=time.perf_counter() - t0,
                          log=res.stdout + res.stderr)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    _lib = lib
    return lib


def check_launch(lib: ctypes.CDLL, err: int, name: str) -> None:
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
