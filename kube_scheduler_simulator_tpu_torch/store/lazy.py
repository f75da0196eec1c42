"""Lazy annotation materialization: decode on first read, not per wave.

A copy of kube_scheduler_simulator_tpu/store/lazy.py, host code with its
imports rewired to the port.

At fleet scale the wave's dominant span is `replay_and_decode_stream`
(BENCH_r05: 15.92s of a ~17s wave at 10k pods x 5k nodes) even though
every commit/bind/gang decision already comes straight from the replay
tensors — the decoded JSON blobs exist only for CONSUMERS (API reads,
the web UI, result-history), and real consumers read a handful of pods,
not all 10k.  This module makes the compact replay tensors the source
of truth and defers the three heavy per-pod blobs to first read:

  * `LazyWave` holds one committed wave's ReplayResult and materializes
    the 13-key annotation dicts per compact chunk — memoized,
    exactly-once under concurrent cold reads, one GIL-released
    `ctx_decode_chunk` call per chunk (store/decode.py ladder), so a
    single cold read pays for its whole chunk and every chunk-mate read
    after it is a dictionary lookup;
  * the result store holds `(wave, index)` handles instead of blobs
    (`ResultStore.put_lazy`) and materializes transparently inside
    `get_stored_result`;
  * the reflector defers its write-backs for lazy results
    (`StoreReflector.reflect_batch` -> `LazyReflections`), and the
    ObjectStore read hooks drain them so GET/list/watch/export of a pod
    observes exactly the eager path's bytes (docs/api.md).

Buffer lifetime (docs/wave-pipeline.md): a LazyWave pins its
ReplayResult — the per-chunk compact buffers (`rr._compact`: live
DEVICE arrays in the device-resident default, host numpy after the
first cold read or a budget spill — framework/replay.py), the
CompiledWorkload's host tables (skip masks, prefilter rejects, message
LUT context) and the node table — across the wave boundary until every
holder of a handle is read, overwritten or deleted.  All of that state
is written once by the wave and never mutated afterwards (later waves
build fresh CompiledWorkloads; `NodeTableReuse` shares only the
immutable node table), so deferred decode is bit-identical to eager
decode of the same wave; a cold read first performs the chunk's
memoized D2H (`d2h_fetch` span under `decode_lazy`), then the one
GIL-released chunk decode.  `KSS_TPU_EAGER_DECODE=1` disables deferral
engine-wide (the golden/parity baseline); `KSS_TPU_HOST_RESIDENT=1`
keeps the lazy decode but fetches the compact tensors to host in-wave
(the middle parity rung).
"""

from __future__ import annotations

import threading
import time

from ..utils.tracing import TRACER

# chunk granularity when the ReplayResult holds full arrays (the
# speculative path) instead of compact chunks
_FALLBACK_CHUNK = 512


class LazyWave:
    """One committed wave's deferred annotations.

    Thread-safe and exactly-once per chunk: the first reader of a chunk
    becomes the decode owner (the GIL-released native chunk call runs
    OUTSIDE the registry lock); concurrent cold readers of the same
    chunk wait on the owner's event instead of decoding again — the
    multi-thread first-read soak in tests/test_lazy_decode.py pins one
    `decode_chunk_calls_total` increment per chunk."""

    def __init__(self, rr, n_pods: int | None = None, sealed: bool = False):
        self.rr = rr
        self.n = rr.cw.n_pods if n_pods is None else n_pods
        cc = getattr(rr, "_compact", None)
        self.chunk = cc.chunk if cc is not None else _FALLBACK_CHUNK
        self._mu = threading.Lock()
        self._chunks: dict[int, list] = {}
        self._inflight: dict[int, threading.Event] = {}
        # streaming waves seal at replay drain: a reader arriving while
        # the device is still filling rr blocks here instead of decoding
        # a half-delivered chunk (width-tier reruns rewrite early data)
        self._ready = threading.Event()
        if sealed:
            self._ready.set()

    def seal(self) -> None:
        """The wave's replay has fully drained; reads may decode."""
        self._ready.set()

    @property
    def sealed(self) -> bool:
        return self._ready.is_set()

    @property
    def materialized_pods(self) -> int:
        with self._mu:
            return sum(len(c) for c in self._chunks.values())

    def get(self, i: int) -> dict[str, str]:
        """Pod i's 13 annotation blobs, decoding its chunk on first
        read.  Returned dicts are shared and must not be mutated."""
        ci = i // self.chunk
        return self._chunk(ci)[i - ci * self.chunk]

    def _chunk(self, ci: int) -> list:
        with self._mu:
            got = self._chunks.get(ci)
        if got is not None:
            TRACER.inc("decode_on_demand_total", result="hit")
            return got
        t0 = time.perf_counter()
        self._ready.wait()
        while True:
            with self._mu:
                got = self._chunks.get(ci)
                if got is not None:
                    break
                ev = self._inflight.get(ci)
                owner = ev is None
                if owner:
                    ev = self._inflight[ci] = threading.Event()
            if not owner:
                ev.wait()
                # a failed decode hands its error to the readers that
                # were already waiting on it (the attribute rides the
                # event); a FRESH read retries the decode instead — a
                # transient failure (allocation pressure, an injected
                # chaos fault, an interrupt mid-read) must heal on
                # re-read, never poison the chunk (docs/fault-injection.md;
                # decode_failures_total counts the failure)
                err = getattr(ev, "error", None)
                if err is not None:
                    raise err
                continue  # re-check: the owner memoized the chunk
            lo = ci * self.chunk
            hi = min(lo + self.chunk, self.n)
            sink: list = [None] * (hi - lo)
            try:
                from .decode import decode_chunk_into

                with TRACER.span("decode_lazy", lo=lo, hi=hi):
                    decode_chunk_into(self.rr, lo, hi, sink, base=lo)
            except BaseException as e:  # noqa: BLE001 — replayed to waiters
                ev.error = e
                with self._mu:
                    del self._inflight[ci]
                ev.set()
                raise
            with self._mu:
                self._chunks[ci] = sink
                del self._inflight[ci]
            ev.set()
            got = sink
            break
        # waiters on an in-flight decode are cold reads too: their
        # latency is the wait, not a second decode
        TRACER.inc("decode_on_demand_total", result="miss")
        TRACER.observe("lazy_decode_cold_read_seconds",
                       time.perf_counter() - t0)
        return got
