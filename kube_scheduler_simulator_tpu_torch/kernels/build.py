"""Build and load the port's CUDA kernels.

Each .cu source under csrc/ is compiled with nvcc into a shared library
of its own with a plain C interface, loaded with ctypes (no PyTorch
headers, so a build takes seconds).  `build()` starts one nvcc per source,
all at once, and waits for them.  The libraries go to
build/kss_torch_kernels/ at the root of the checkout, named by the source
and a hash of all of csrc/ and the flags, so a fresh checkout builds them
on first use and later calls reuse them.  Nothing is compiled or loaded
at import time.
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
    """What `build` did for one source: the library path, whether it
    compiled (False when a library with the same hash was already there),
    its seconds and the compiler's messages (ptxas register and spill
    counts)."""

    def __init__(self, path: Path, compiled: bool, seconds: float, log: str):
        self.path = path
        self.compiled = compiled
        self.seconds = seconds
        self.log = log


# C functions of each library: name -> (argtypes, restype)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "step": {"kss_step_args_size": ([], _I), "kss_step_chunk": ([_P, _P], _I)},
    "spec_eval": {"kss_step_args_size": ([], _I), "kss_spec_eval": ([_P, _P], _I),
                  "kss_spec_oracle": ([_P, _I, _P, _P, _I, _I, _P, _P], _I)},
    "spec_round": {"kss_step_args_size": ([], _I), "kss_spec_round": ([_P, _P], _I)},
    "spec_commit": {"kss_step_args_size": ([], _I),
                    "kss_spec_commit": ([_P, _P, _I, _I, _P], _I)},
    "grid": {"kss_grid_args_size": ([], _I), "kss_grid_append": ([_P, _P], _I),
             "kss_grid_emit": ([_P, _P], _I)},
    "attribution": {"kss_att_args_size": ([], _I),
                    "kss_chunk_attribution": ([_P, _P], _I)},
    "gang": {"kss_quorum_slice": ([_P, _I, _I, _P, _P, _P], _I)},
    "phased": {"kss_step_args_size": ([], _I), "kss_phased_eval": ([_P, _P], _I),
               "kss_renormalize_row": ([_P, _I, _P, _P, _P, _P, _P], _I)},
}


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


@functools.cache
def _digest() -> str:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(stem: str = "step") -> Path:
    return BUILD_DIR / f"libkss_{stem}_{_digest()}.so"


def build() -> dict[str, BuildResult]:
    """Compile every csrc/*.cu (each includes the .cuh files it needs)
    whose library for these sources does not exist: one nvcc per source,
    started together.  -> {source stem: BuildResult}."""
    results = {stem: BuildResult(library_path(stem), False, 0.0, "")
               for stem in SIGNATURES if library_path(stem).exists()}
    missing = [stem for stem in SIGNATURES if stem not in results]
    if not missing:
        return results
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for stem in missing:
        out = library_path(stem)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running[stem] = (proc, tmp, out, time.perf_counter())
    failed = []
    for stem, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {stem}.cu failed ({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        results[stem] = BuildResult(out, True, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {stem: results[stem] for stem in SIGNATURES}


@functools.cache
def load(stem: str = "step") -> ctypes.CDLL:
    """The library built from csrc/<stem>.cu with its C functions'
    signatures declared.  Built, hashed and opened once per process: later
    launches reuse it."""
    lib = ctypes.CDLL(str(build()[stem].path))
    for name, (argtypes, restype) in SIGNATURES[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib
