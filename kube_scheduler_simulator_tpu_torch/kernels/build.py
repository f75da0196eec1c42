"""Build and load the port's CUDA kernels.

The sources under csrc/ are compiled with nvcc into a shared library with
a plain C interface, loaded with ctypes (no PyTorch headers, so the build
takes seconds).  The library goes to build/kss_torch_kernels/ at the root
of the checkout, named by a hash of the sources and flags, so a fresh
checkout builds it on first use and later calls reuse it.  Nothing is
compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kss_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17",
    # float64 paths must round after every operation, as the reference's
    # separate jnp ops do: no fused multiply-add
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

class BuildResult:
    """What `build` did: the library path, whether it compiled (False when
    a library with the same hash was already there), its seconds and the
    compiler's messages (ptxas register and spill counts)."""

    def __init__(self, path: Path, compiled: bool, seconds: float, log: str):
        self.path = path
        self.compiled = compiled
        self.seconds = seconds
        self.log = log


def _sources() -> list[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def library_path() -> Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libkss_step_{h.hexdigest()[:16]}.so"


def build() -> BuildResult:
    """Compile csrc/step.cu (which includes the .cuh files) unless the
    library for these sources exists."""
    out = library_path()
    if out.exists():
        return BuildResult(out, False, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / "step.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return BuildResult(out, True, seconds, log)


@functools.cache
def load() -> ctypes.CDLL:
    """The built library with its C functions' signatures declared.  Built,
    hashed and opened once per process: later launches reuse it."""
    lib = ctypes.CDLL(str(build().path))
    lib.kss_step_args_size.argtypes = []
    lib.kss_step_args_size.restype = ctypes.c_int
    lib.kss_step_chunk.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.kss_step_chunk.restype = ctypes.c_int
    return lib
