"""ctypes loader for the native annotation codec (annotation_codec.cpp).

Port of kube_scheduler_simulator_tpu/native/__init__.py.  The codec is
built with g++ at first use into build/kss_torch_native/ at the root of
the checkout (never next to the source), named by a hash of the source
and the flags, so a fresh checkout builds it once and later processes
reuse it.  A missing g++ or a failed build raises: the Python encoder is
chosen only explicitly (KSS_TPU_DISABLE_NATIVE=1, store/decode.py).
Nothing is compiled or loaded at import time.  See annotation_codec.cpp
for the encoding contract.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import threading
from pathlib import Path

SOURCE = Path(__file__).resolve().parent / "annotation_codec.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "kss_torch_native"
BUILD_CMD = ("g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(BUILD_CMD).encode())
    return BUILD_DIR / f"libkss_annotation_codec_{h.hexdigest()[:16]}.so"


def build_codec(so: Path | None = None) -> Path:
    """Compile annotation_codec.cpp into `so` (library_path() by default)
    unless it is there already; -> its path.  Raises when g++ is missing
    or the compile fails."""
    so = Path(so) if so is not None else library_path()
    if so.exists():
        return so
    if shutil.which(BUILD_CMD[0]) is None:
        raise RuntimeError(f"{BUILD_CMD[0]} not found: the native annotation codec "
                           "builds with it (KSS_TPU_DISABLE_NATIVE=1 selects the "
                           "Python encoder)")
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([*BUILD_CMD, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native annotation codec failed "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builds each land a whole file
    return so


def _load(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    P = ctypes.POINTER
    lib.encode_filter_result.restype = ctypes.c_void_p
    lib.encode_filter_result.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        P(ctypes.c_int32), P(ctypes.c_uint8),
        P(ctypes.c_char_p), P(ctypes.c_char_p),
        P(ctypes.c_int32), P(ctypes.c_int32),
        P(ctypes.c_char_p), P(ctypes.c_int32), P(ctypes.c_uint8),
    ]
    lib.encode_score_result.restype = ctypes.c_void_p
    lib.encode_score_result.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        P(ctypes.c_int64), P(ctypes.c_uint8), P(ctypes.c_uint8),
        P(ctypes.c_char_p), P(ctypes.c_char_p),
        P(ctypes.c_int32), P(ctypes.c_int32),
    ]
    lib.codec_free.restype = None
    lib.codec_free.argtypes = [ctypes.c_void_p]
    lib.encode_string_map.restype = ctypes.c_void_p
    lib.encode_string_map.argtypes = [
        P(ctypes.c_char_p), P(ctypes.c_char_p),
        P(ctypes.c_longlong), ctypes.c_longlong,
    ]
    lib.encode_string_map_sized.restype = ctypes.c_void_p
    lib.encode_string_map_sized.argtypes = [
        P(ctypes.c_char_p), P(ctypes.c_char_p),
        P(ctypes.c_longlong), ctypes.c_longlong,
        P(ctypes.c_longlong), P(ctypes.c_int32),
    ]
    lib.codec_ctx_new.restype = ctypes.c_void_p
    lib.codec_ctx_new.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        P(ctypes.c_char_p), P(ctypes.c_char_p), P(ctypes.c_char_p),
        P(ctypes.c_int32), P(ctypes.c_int32), P(ctypes.c_int32),
        P(ctypes.c_char_p), P(ctypes.c_int32), P(ctypes.c_uint8),
        P(ctypes.c_int32), P(ctypes.c_int64), ctypes.c_int64,
    ]
    lib.ctx_decode_pod.restype = ctypes.c_int32
    lib.ctx_decode_pod.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        P(ctypes.c_uint8), P(ctypes.c_uint8),
        P(ctypes.c_void_p), P(ctypes.c_int32),
        P(ctypes.c_uint8),
        ctypes.c_int32,
        P(ctypes.c_void_p), P(ctypes.c_int64),
    ]
    lib.ctx_decode_chunk.restype = ctypes.c_void_p
    lib.ctx_decode_chunk.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
        P(ctypes.c_uint8), P(ctypes.c_uint8),
        P(ctypes.c_void_p), P(ctypes.c_int64), P(ctypes.c_int32),
        P(ctypes.c_uint8), P(ctypes.c_uint8), P(ctypes.c_uint8),
        ctypes.c_int32,
        P(ctypes.c_int64), P(ctypes.c_int64),
        P(ctypes.c_double),
    ]
    lib.chunk_arena_free.restype = None
    lib.chunk_arena_free.argtypes = [ctypes.c_void_p]
    lib.codec_ctx_free.restype = None
    lib.codec_ctx_free.argtypes = [ctypes.c_void_p]
    lib.ctx_all_ascii.restype = ctypes.c_int32
    lib.ctx_all_ascii.argtypes = [ctypes.c_void_p]
    lib.ctx_encode_filter.restype = ctypes.c_void_p
    lib.ctx_encode_filter.argtypes = [
        ctypes.c_void_p, P(ctypes.c_int32), P(ctypes.c_uint8), P(ctypes.c_int64)]
    lib.ctx_encode_scores.restype = ctypes.c_void_p
    lib.ctx_encode_scores.argtypes = [
        ctypes.c_void_p, P(ctypes.c_int64), P(ctypes.c_uint8), P(ctypes.c_uint8),
        P(ctypes.c_int64)]
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded codec, built on first use.  Raises when it cannot be
    built; concurrent first users wait for the one build."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            # concurrent first users wait for the one g++ build: the
            # wait is the point (no lock is taken inside it)
            _lib = _load(build_codec())  # kss-analyze: allow(blocking-under-lock)
    return _lib


# str straight from the C buffer: PyUnicode_DecodeUTF8 builds the str in
# ONE copy, where string_at(...).decode() would materialize an
# intermediate bytes object first (~1.3 MB of JSON per full-width pod)
_PyUnicode_DecodeUTF8 = ctypes.pythonapi.PyUnicode_DecodeUTF8
_PyUnicode_DecodeUTF8.restype = ctypes.py_object
_PyUnicode_DecodeUTF8.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t, ctypes.c_char_p]


def take_sized_string(lib, ptr, length: int) -> str:
    """One-copy str from a codec-allocated buffer of known length; frees
    the buffer."""
    try:
        return _PyUnicode_DecodeUTF8(ptr, length, b"strict")
    finally:
        lib.codec_free(ptr)


# ASCII fast path: when the codec context proves every emitted byte is
# ASCII (ctx_all_ascii), the str is built by PyUnicode_New + memmove, a
# plain copy instead of DecodeUTF8's validating scan.  The data offset of
# a compact-ASCII str is derived at run time (sys.getsizeof("") counts
# PyASCIIObject and the NUL) and checked once on first use.
_PyUnicode_New = ctypes.pythonapi.PyUnicode_New
_PyUnicode_New.restype = ctypes.py_object
_PyUnicode_New.argtypes = [ctypes.c_ssize_t, ctypes.c_uint32]
_ASCII_DATA_OFF = sys.getsizeof("") - 1
_ascii_ok: bool | None = None


def _ascii_take(ptr, length: int) -> str:
    if length == 0:
        return ""  # PyUnicode_New(0, ...) returns the shared singleton
    s = _PyUnicode_New(length, 127)
    # exactly `length` bytes: PyUnicode_New already wrote the NUL at
    # data[length], so the source need not be NUL-terminated
    ctypes.memmove(id(s) + _ASCII_DATA_OFF, ptr, length)
    return s


def _ascii_take_ok() -> bool:
    """Whether _ascii_take builds correct strs on this interpreter: probed
    once with trailing garbage (not NUL) after the payload, which proves
    the copy and that PyUnicode_New supplied the terminator."""
    global _ascii_ok
    if _ascii_ok is None:
        probe = b"probe{\"x\":\"1\"}"
        buf = (ctypes.c_char * (len(probe) + 1)).from_buffer_copy(probe + b"X")
        out = _ascii_take(ctypes.addressof(buf), len(probe))
        _ascii_ok = (out == probe.decode() and ctypes.string_at(
            id(out) + _ASCII_DATA_OFF, len(probe) + 1) == probe + b"\x00")
    return _ascii_ok


def take_sized_string_ascii(lib, ptr, length: int) -> str:
    """take_sized_string for buffers PROVEN pure-ASCII by the codec ctx."""
    if not _ascii_take_ok():
        return take_sized_string(lib, ptr, length)
    try:
        return _ascii_take(ptr, length)
    finally:
        lib.codec_free(ptr)


# Arena string takers: str from an (address, length) pair WITHOUT freeing;
# ctx_decode_chunk's blobs live in a per-call arena that ONE
# chunk_arena_free releases after every pod's strs exist.

def peek_string(addr: int, length: int) -> str:
    return _PyUnicode_DecodeUTF8(addr, length, b"strict")


def peek_string_ascii(addr: int, length: int) -> str:
    if not _ascii_take_ok():
        return peek_string(addr, length)
    return _ascii_take(addr, length)
