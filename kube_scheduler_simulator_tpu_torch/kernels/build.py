"""Build and load the port's CUDA kernels and its host relay.

Each .cu source under csrc/ is compiled with nvcc into a shared library
of its own with a plain C interface, loaded with ctypes (no PyTorch
headers, so a build takes seconds).  `build()` starts one nvcc per source,
all at once, and waits for them.  The host-only sources (HOST_SIGNATURES:
csrc/relay.cpp, the relay of a mesh across hosts, plain C++ with no CUDA)
are compiled with the host's g++, only where a list names them or `load`
asks for one, so that they build where there is no CUDA toolkit too.  The
libraries go to build/kss_torch_kernels/ at the root of the checkout,
named by the source and a hash of all of csrc/'s CUDA sources (a host
source: of itself) and the flags, so a fresh checkout builds them on
first use and later calls reuse them.  Nothing is compiled or loaded at
import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
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
    "step": {"kss_step_args_size": ([], _I), "kss_step_chunk": ([_P, _I, _I, _P], _I),
             "kss_step_plan": ([_P, _I, _I, _P, _P, _P], _I), "kss_mesh_max_shards": ([], _I),
             "kss_step_cards_plan": ([_P, _I, _I, _I, _P, _P, _P, _P], _I),
             "kss_step_cards": ([_P, _I, _I, _P, _I, _P], _I),
             "kss_peer_args_size": ([], _I), "kss_enable_peer": ([_I, _I], _I),
             "kss_ipc_export": ([_I, ctypes.c_longlong, _P, _P], _I),
             "kss_ipc_open": ([_I, _P, _P], _I), "kss_ipc_close": ([_I, _P, _I], _I),
             "kss_mapped_alloc": ([_I, ctypes.c_longlong, _P, _P], _I),
             "kss_mapped_free": ([_P], _I)},
    "spec_eval": {"kss_step_args_size": ([], _I),
                  "kss_eval_plan": ([_P, _I, _I, _I, _P, _P, _P], _I),
                  "kss_spec_eval": ([_P, _I, _I, _I, _I, _P], _I),
                  "kss_eval_cards_plan": ([_P, _I, _I, _I, _P, _P, _P, _P, _P], _I),
                  "kss_eval_cards": ([_P, _I, _I, _P, _I, _P], _I)},
    "spec_round": {"kss_step_args_size": ([], _I), "kss_round_plan": ([_P, _I, _P, _P, _P, _P], _I),
                   "kss_spec_round": ([_P, _I, _I, _P], _I)},
    "spec_commit": {"kss_step_args_size": ([], _I),
                    "kss_commit_plan": ([_P, _P], _I),
                    "kss_spec_commit": ([_P, _P, _I, _I, _P], _I)},
    "grid": {"kss_grid_args_size": ([], _I), "kss_grid_append": ([_P, _P], _I),
             "kss_grid_emit": ([_P, _P], _I)},
    "attribution": {"kss_att_args_size": ([], _I),
                    "kss_chunk_attribution": ([_P, _P], _I)},
    "gang": {"kss_quorum_slice": ([_P, _I, _I, _P, _P, _I, _P], _I)},
    "phased": {"kss_step_args_size": ([], _I),
               "kss_renormalize_rows": ([_P, _P, _I, _P, _P, _P, _I, _P], _I)},
    "oracle": {"kss_fuse_max": ([], _I), "kss_oracle_commit_size": ([], _I),
               "kss_spec_oracle": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I)},
}


# builds of a source with extra flags, compiled only when `load` asks for
# one (never by a plain `build()`): stem -> (source stem, flags).  The
# phase clocks of csrc/common.cuh.
VARIANTS = {"step_clock": ("step", ("-DKSS_PHASE_CLOCK",)),
            "spec_round_clock": ("spec_round", ("-DKSS_PHASE_CLOCK",))}
SIGNATURES.update({stem: SIGNATURES[source] for stem, (source, _) in VARIANTS.items()})

# host-only libraries: csrc/<stem>.cpp, built with g++ and HOST_FLAGS
HOST_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
HOST_SIGNATURES = {
    "relay": {"kss_relay_layout": ([_P, _P, _P], _I),
              "kss_relay_start": ([_P, _I, _I, _I, _I, _P, _P, _P], _P),
              "kss_relay_arm": ([_P, _I], None), "kss_relay_park": ([_P], None),
              "kss_relay_status": ([_P, _P], None), "kss_relay_stop": ([_P], _I)},
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


def _gxx() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if found:
        return found
    raise RuntimeError("g++ not found: the host relay (csrc/relay.cpp) builds with the host's "
                       "C++ compiler")


def library_path(stem: str = "step") -> Path:
    if stem in HOST_SIGNATURES:
        h = hashlib.sha256((CSRC / f"{stem}.cpp").read_bytes())
        h.update(" ".join(HOST_FLAGS).encode())
        return BUILD_DIR / f"libkss_{stem}_{h.hexdigest()[:16]}.so"
    return BUILD_DIR / f"libkss_{stem}_{_digest()}.so"


# one build at a time in a process: threads that first launch together
# (sessions, the fuse coordinator) would otherwise start the same nvcc
# twice into one temporary file
_BUILD_LOCK = threading.Lock()


def build(stems=None) -> dict[str, BuildResult]:
    """Compile the libraries of `stems` (by default every csrc/*.cu, each
    including the .cuh files it needs, and no VARIANTS) whose library for
    these sources does not exist: one compiler per library (nvcc, or g++
    for HOST_SIGNATURES' stems), started together.
    A thread that finds another thread building waits for it, then finds
    its libraries.  -> {stem: BuildResult}."""
    stems = [s for s in SIGNATURES if s not in VARIANTS] if stems is None else list(stems)
    with _BUILD_LOCK:
        results = {stem: BuildResult(library_path(stem), False, 0.0, "")
                   for stem in stems if library_path(stem).exists()}
        missing = [stem for stem in stems if stem not in results]
        if missing:
            # the wait is the point: a thread that finds another building
            # the same libraries waits for them instead of starting nvcc
            # again (one build a checkout; no lock is taken inside)
            results.update(_compile(missing))  # kss-analyze: allow(blocking-under-lock)
    return {stem: results[stem] for stem in stems}


def _compile(stems: list[str]) -> dict[str, BuildResult]:
    nvcc = _nvcc() if any(s not in HOST_SIGNATURES for s in stems) else None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for stem in stems:
        out = library_path(stem)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if stem in HOST_SIGNATURES:
            cmd = [_gxx(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cpp")]
        else:
            source, extra = VARIANTS.get(stem, (stem, ()))
            cmd = [nvcc, *NVCC_FLAGS, *extra, "-o", str(tmp), str(CSRC / f"{source}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running[stem] = (proc, cmd, tmp, out, time.perf_counter())
    results, failed = {}, []
    for stem, (proc, cmd, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{Path(cmd[0]).name} {Path(cmd[-1]).name} failed "
                          f"({proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        results[stem] = BuildResult(out, True, seconds, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


@functools.cache
def load(stem: str = "step") -> ctypes.CDLL:
    """The library built from csrc/<stem>.cu (a host library: .cpp) with
    its C functions' signatures declared.  Built (with every other CUDA library, or a
    variant or a host library alone), hashed and opened once per process:
    later launches reuse it."""
    alone = stem in VARIANTS or stem in HOST_SIGNATURES
    built = build((stem,)) if alone else build()
    lib = ctypes.CDLL(str(built[stem].path))
    for name, (argtypes, restype) in {**SIGNATURES, **HOST_SIGNATURES}[stem].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def cache_stats() -> dict:
    """The process's compiled kernel libraries, shared by every session:
    {entries, hits, misses, hit_rate} of `load`."""
    info = load.cache_info()
    total = info.hits + info.misses
    return {"entries": info.currsize, "hits": info.hits, "misses": info.misses,
            "hit_rate": round(info.hits / total, 4) if total else None}
