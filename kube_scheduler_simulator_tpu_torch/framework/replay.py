"""Chunked replay of a pod queue.

Port of kube_scheduler_simulator_tpu/framework/replay.py: `ReplayResult`
(:414-607), `_CompactChunks` with its residency (:106-228),
`_DeviceResultBudget` (:230-411), `_FailStreak` (:60-103),
`ChunkAttribution` and `plugin_attribution` (:609-890), `_slice_xs`
(:893), `_fetch_chunk` and `_fetch_decisions` (:1150-1185),
`_DeviceAttribution` (:1298-1343), `_resolve_device_resident`
(:1346-1363), `replay` (:1365-1429), `_compact_plan` (:1432) and the
in-flight dispatch loop of `_replay_run` (:1464-1642).  Each chunk goes
through `Step.scan` (framework/pipeline.py): one launch of the step
kernel on the card, a loop of the plain step on the CPU.

Result residency, as in the JAX package, has three rungs, bit-identical
to every reader:

  * device-resident, the default when no `on_chunk` consumer decodes
    in-wave: each chunk's CompactOut stays on the device; only the
    per-pod decision rows and B7's per-chunk attribution sums
    (kernels/attribution.py) cross to the host, into pinned buffers with
    non-blocking copies.  A cold read (`_CompactChunks.host`) fetches a
    chunk exactly once; `_DEVICE_BUDGET` spills the least recently
    retained chunks to the host past KSS_TPU_DEVICE_RESULT_BUDGET_MB;
  * KSS_TPU_HOST_RESIDENT=1 and KSS_TPU_EAGER_DECODE=1 (or an `on_chunk`
    consumer): every chunk's CompactOut is fetched in-wave, the same way.

The dispatch loop stays up to `_MAX_INFLIGHT` chunks ahead of the oldest
fetch, so the host queues launches while the card works.  The last chunk
is padded; padded steps carry `is_pad` and never bind.  With a one-card
mesh (`replay(cw, mesh=...)`, parallel/mesh.py) every chunk runs B12
`step_chunk_sharded` and writes the same full-width outputs, so the
rungs, B7 and the decode run unchanged.

Fault seams (utils/faults.py), at the JAX package's steps: each chunk's
dispatch (`replay.scan_dispatch`), each in-wave fetch
(`replay.decision_fetch`), a cold read (`replay.materialize`) and the
budget's spill (`replay.budget_spill`).  Multi-session serving
(server/sessions.py): the materialize failure streak and the device
budget's shares are per session, keyed on the tracer's session scope.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict, deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..control import CONTROLS
from ..kernels.attribution import chunk_attribution
from ..state.compile import CompiledWorkload
from ..utils.env import device_result_budget_bytes, host_resident_forced
from ..utils.faults import fault_point
from ..utils.tracing import TRACER
from .pipeline import PACK_MODES, build_step, choose_pack_mode


class _FailStreak:
    """Per-session consecutive failures of on-demand materialization; any
    success resets the failing session's streak.  The engine's wave
    failure protocol reads its session's streak at wave start: a streak
    past its limit is a structural device signal (repeated D2H failure),
    answered by stepping down to the host-resident rung.  Buckets key on
    the tracer's session scope at the failing read (None: direct engine
    use), so one tenant's failures never degrade a neighbour."""

    def __init__(self):
        self._mu = threading.Lock()
        self._n: dict = {}

    def fail(self) -> int:
        sid = TRACER.current_session()
        with self._mu:
            self._n[sid] = self._n.get(sid, 0) + 1
            return self._n[sid]

    def ok(self) -> None:
        sid = TRACER.current_session()
        with self._mu:
            self._n.pop(sid, None)

    def value(self, session=None) -> int:
        with self._mu:
            return self._n.get(session, 0)

    def reset(self, session=None) -> None:
        with self._mu:
            self._n.pop(session, None)


_MATERIALIZE_FAILS = _FailStreak()


def materialize_failure_streak(session: str | None = None) -> int:
    """The session's streak of on-demand materialization failures."""
    return _MATERIALIZE_FAILS.value(session)


def reset_materialize_failures(session: str | None = None) -> None:
    """Restart the session's streak: the engine steps down the residency
    ladder."""
    _MATERIALIZE_FAILS.reset(session)


def _to_host(t) -> np.ndarray:
    """A tensor (or array) as host numpy in C order: the native codec walks
    raw pointers."""
    if isinstance(t, torch.Tensor):
        t = t.cpu().numpy()
    return np.ascontiguousarray(t)


class _CompactChunks:
    """Per-chunk CompactOut arrays.

    Each chunk's four groups are either host numpy arrays (C order) or,
    on the device-resident rung, live tensors on the replay's device
    until a cold read or the budget's spill fetches them.  Readers go
    through host(), which performs that fetch exactly once."""

    GROUPS = ("packed", "raw8", "raw16", "raw32")

    def __init__(self, chunk, pack_mode, score_cols):
        self.packed: list = []    # [C, N]
        self.raw8: list = []      # [C, S8, N] int8
        self.raw16: list = []     # [C, S16, N] int16
        self.raw32: list = []     # [C, S32, N] int32 / int64
        self.chunk = chunk
        self.pack_mode = pack_mode
        self.score_cols = score_cols  # per scorer: ("raw8"|"raw16"|"raw32"|"host", row)
        # per chunk: host dict of B7's sums (device-resident), or None
        # (the host tally)
        self.att: list = []
        # per chunk: the CUDA event after the last launch writing its
        # tensors (a fetch on another thread waits on it), or None
        self.ready: list = []
        self.d2h_bytes: list = []  # per chunk: bytes fetched in-wave
        self.materialized = 0      # chunks fetched later, by a cold read or a spill
        self._mu = threading.Lock()
        self._inflight: dict[int, threading.Event] = {}

    # ------------------------------------------------------- residency

    def is_device(self, ci: int) -> bool:
        return isinstance(self.packed[ci], torch.Tensor)

    def device_nbytes(self, ci: int) -> int:
        """Device bytes pinned by chunk ci (0 once materialized)."""
        if not self.is_device(ci):
            return 0
        return sum(getattr(self, g)[ci].numel() * getattr(self, g)[ci].element_size()
                   for g in self.GROUPS)

    def host(self, group: str, ci: int) -> np.ndarray:
        """Chunk ci's `group` array as host numpy, materializing the whole
        chunk on first access."""
        a = getattr(self, group)[ci]
        if isinstance(a, np.ndarray):
            return a
        self.materialize(ci)
        return getattr(self, group)[ci]

    def materialize(self, ci: int, spill: bool = False) -> None:
        """Fetch chunk ci's four groups to the host, exactly once under
        concurrent readers: the fetch runs outside the lock, latecomers
        wait on the owner's event, and a failed fetch clears the slot so
        the next reader retries.  spill=True is the budget's background
        path, counted as a spill of the owning session."""
        while True:
            with self._mu:
                if not isinstance(self.packed[ci], torch.Tensor):
                    return
                ev = self._inflight.get(ci)
                owner = ev is None
                if owner:
                    ev = self._inflight[ci] = threading.Event()
            if owner:
                break
            ev.wait()
        try:
            t0 = time.perf_counter()
            fault_point("replay.materialize")
            if self.ready[ci] is not None:
                self.ready[ci].synchronize()  # written on another thread's stream
            # the span rides a conditional context manager: on-demand reads
            # only, not the budget's background spills (JAX replay.py:189)
            with (nullcontext() if spill
                  else TRACER.span("d2h_fetch", chunk=ci)):  # kss-analyze: allow(unbalanced-span)
                fetched = {g: _to_host(getattr(self, g)[ci]) for g in self.GROUPS}
            dt = time.perf_counter() - t0
        except BaseException:
            _MATERIALIZE_FAILS.fail()
            with self._mu:
                del self._inflight[ci]
            ev.set()
            raise
        _MATERIALIZE_FAILS.ok()
        with self._mu:
            for g in self.GROUPS:
                getattr(self, g)[ci] = fetched[g]
            self.ready[ci] = None
            self.materialized += 1
            del self._inflight[ci]
        ev.set()
        _DEVICE_BUDGET.release(self, ci)
        nbytes = sum(a.nbytes for a in fetched.values())
        if spill:
            sid = TRACER.current_session()
            if sid is not None:
                TRACER.inc("device_chunks_spilled_total", session=sid)
            else:
                TRACER.count("device_chunks_spilled_total")
            # black-box spill evidence: which chunk left the card, how big
            # (utils/blackbox.py)
            from ..utils.blackbox import BLACKBOX

            BLACKBOX.record("budget.spill", chunk=ci, bytes=int(nbytes))
        else:
            TRACER.count("d2h_on_demand_bytes_total", nbytes)
            TRACER.observe("d2h_on_demand_seconds", dt)


class _DeviceResultBudget:
    """Device retention budget for device-resident replay chunks, across
    replays: KSS_TPU_DEVICE_RESULT_BUDGET_MB caps the bytes pinned by
    retained chunks; past it the least recently retained chunks spill to
    the host on ONE background thread (reads remove entries, so insertion
    order is recency order).  Unset -> no cap (chunks stay until a cold
    read or their result is dropped); 0 -> retain nothing, spill as
    chunks land.  Entries hold the _CompactChunks weakly, so dropping a
    result's last handle releases its accounting.

    Multi-session serving (server/sessions.py): each retained chunk is
    attributed to the session whose wave produced it (the tracer's
    session scope at retain time; None for direct engine use).  The pool
    divides among the sessions holding entries, weighted by the
    autopilot's `CONTROLS.budget_milliweights()` (equal with no
    autopilot), and each session is enforced against its own share, in
    LRU order within it: a fat session spills its own chunks, never a
    neighbour's.  With one bucket the share is the whole pool."""

    _SPILL_RETRIES = 3

    def __init__(self):
        self._mu = threading.Lock()
        # (id(cc), ci) -> [weakref(cc), ci, nbytes, spilling, attempts,
        #                  session]
        self._entries: OrderedDict[tuple[int, int], list] = OrderedDict()
        self._total = 0
        self._pool: ThreadPoolExecutor | None = None
        self.spilled = 0  # chunks the spill thread fetched
        # keys whose _CompactChunks died: the weakref finalizer must NOT
        # take _mu (the collector can run it on a thread already inside a
        # locked section, a non-reentrant self-deadlock), so it only
        # appends here (deque.append is atomic) and locked entry points
        # prune
        self._dead: deque = deque()

    limit_bytes = staticmethod(device_result_budget_bytes)

    def _prune_locked(self) -> None:
        while self._dead:
            ent = self._entries.pop(self._dead.popleft(), None)
            if ent is not None:
                self._total -= ent[2]
        TRACER.gauge("device_chunks_retained", len(self._entries))

    def retain(self, cc: _CompactChunks, ci: int, nbytes: int) -> None:
        key = (id(cc), ci)
        session = TRACER.current_session()

        def _gone(_ref, key=key):
            self._dead.append(key)  # lock-free: pruned on the next locked call

        with self._mu:
            # prune BEFORE inserting: a dead chunk's queued key could
            # collide with this one (id() reuse) and drop the fresh entry
            self._prune_locked()
            self._entries[key] = [weakref.ref(cc, _gone), ci, nbytes, False, 0, session]
            self._total += nbytes
            TRACER.gauge("device_chunks_retained", len(self._entries))
        self._enforce()

    def release(self, cc: _CompactChunks, ci: int) -> None:
        with self._mu:
            ent = self._entries.pop((id(cc), ci), None)
            if ent is not None:
                self._total -= ent[2]
            self._prune_locked()

    def drop(self, cc: _CompactChunks) -> None:
        """Forget every chunk of cc: a width tier the replay abandoned."""
        with self._mu:
            for key in [k for k in self._entries if k[0] == id(cc)]:
                self._total -= self._entries.pop(key)[2]
            self._prune_locked()

    def retained_chunks(self) -> int:
        with self._mu:
            self._prune_locked()
            return len(self._entries)

    def retained_bytes(self) -> int:
        with self._mu:
            self._prune_locked()
            return self._total

    def retained_by_session(self) -> dict:
        """{session (None = sessionless): (chunks, bytes)} retained now."""
        out: dict = {}
        with self._mu:
            self._prune_locked()
            for ent in self._entries.values():
                c, b = out.get(ent[5], (0, 0))
                out[ent[5]] = (c + 1, b + ent[2])
        return out

    def _enforce(self) -> None:
        limit = self.limit_bytes()
        if limit is None:
            return
        to_spill: list[tuple[_CompactChunks, int, str | None]] = []
        # per-session share weights in integer milli-units: a session the
        # autopilot does not steer weighs 1000, so with no autopilot every
        # bucket's share is exactly limit // n
        mweights = CONTROLS.budget_milliweights()
        with self._mu:
            self._prune_locked()
            totals: dict = {}
            for ent in self._entries.values():
                totals[ent[5]] = totals.get(ent[5], 0) + ent[2]
            mw = {s: max(mweights.get(s, 1000), 1) for s in totals}
            mw_sum = max(sum(mw.values()), 1)
            over = {s: t - limit * mw[s] // mw_sum for s, t in totals.items()}
            for ent in self._entries.values():
                if over.get(ent[5], 0) <= 0:
                    continue
                if ent[3]:
                    over[ent[5]] -= ent[2]  # already queued
                    continue
                cc = ent[0]()
                if cc is None:
                    continue  # the finalizer prunes it
                ent[3] = True
                to_spill.append((cc, ent[1], ent[5]))
                over[ent[5]] -= ent[2]
        for cc, ci, session in to_spill:
            self._spill_pool().submit(self._spill_one, cc, ci, session)

    def _spill_one(self, cc: _CompactChunks, ci: int, session: str | None = None) -> None:
        try:
            # the spill thread adopts the owning session's scope, for the
            # session-scoped fault rules and the spill counter's label
            with TRACER.session_scope(session):
                fault_point("replay.budget_spill")
                cc.materialize(ci, spill=True)
        except Exception:
            # a failed fetch: clear the mark and enforce again, at most
            # _SPILL_RETRIES times; after that the chunk stays on the
            # device until a cold read fetches it
            retry = False
            with self._mu:
                ent = self._entries.get((id(cc), ci))
                if ent is not None:
                    ent[4] += 1
                    retry = ent[4] < self._SPILL_RETRIES
                    ent[3] = not retry
            if retry:
                time.sleep(0.05)
                self._enforce()
            return
        with self._mu:
            self.spilled += 1

    def _spill_pool(self) -> ThreadPoolExecutor:
        with self._mu:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="d2h-spill")
            return self._pool

    def drain(self) -> None:
        """Block until every queued spill has landed."""
        pool = self._pool
        if pool is not None:
            pool.submit(lambda: None).result()


_DEVICE_BUDGET = _DeviceResultBudget()


class ReplayResult:
    """Host-side replay results.

    Two storage layouts:
      * compact (the replay() path): first-fail-packed filters + narrow raw
        scores; full per-pod views are reconstructed chunk-at-a-time on
        demand (finalscore via framework/hostnorm.py);
      * full arrays, passed in directly.

    Use the per-pod accessors (codes_of/raw_of/final_of/feasible_of) —
    they avoid materializing [P, .., N] tensors.  The legacy whole-array
    properties exist for tests and small workloads.

    tiers: the raw-width tiers the replay ran, in order (None, "i32",
    "i64"; each tier runs every chunk once); the last one's outputs are
    the result.
    """

    def __init__(self, cw: CompiledWorkload, filter_codes=None, score_raw=None,
                 score_final=None, selected=None, feasible_count=None,
                 prefilter_reject=None, compact: _CompactChunks | None = None):
        self.cw = cw
        self._filter_codes = filter_codes
        self._score_raw = score_raw
        self._score_final = score_final
        self.selected = selected
        self.feasible_count = feasible_count
        self.prefilter_reject = prefilter_reject
        self._compact = compact
        self._recon_ci = -1
        self._recon: dict[str, np.ndarray] | None = None
        self._recon_lock = threading.Lock()
        self.tiers: tuple = ()

    # ------------------------------------------------------------ summary

    @property
    def scheduled(self) -> int:
        return int((self.selected >= 0).sum())

    def selected_node_name(self, i: int) -> str:
        s = int(self.selected[i])
        return self.cw.node_table.names[s] if s >= 0 else ""

    # ------------------------------------------------------------ access

    def codes_of(self, i: int) -> np.ndarray:
        """[F, N] int32 filter codes for pod i (0 == pass)."""
        if self._filter_codes is not None:
            return self._filter_codes[i]
        d = self._chunk_recon(i // self._compact.chunk)
        return d["codes"][i % self._compact.chunk]

    def raw_of(self, i: int) -> np.ndarray:
        """[S, N] raw scores for pod i."""
        if self._score_raw is not None:
            return self._score_raw[i]
        d = self._chunk_recon(i // self._compact.chunk, scores=True)
        return d["raw"][i % self._compact.chunk]

    def final_of(self, i: int) -> np.ndarray:
        """[S, N] finalscore (normalized x weight) for pod i."""
        if self._score_final is not None:
            return self._score_final[i]
        d = self._chunk_recon(i // self._compact.chunk, scores=True)
        return d["final"][i % self._compact.chunk]

    def feasible_of(self, i: int) -> np.ndarray | None:
        """[N] bool plugin-filter feasibility for pod i, or None when only
        full arrays are stored (the caller derives it from codes_of)."""
        if self._compact is None:
            return None
        d = self._chunk_recon(i // self._compact.chunk)
        return d["feasible"][i % self._compact.chunk]

    def _chunk_recon(self, ci: int, scores: bool = False) -> dict[str, np.ndarray]:
        """Reconstruct one chunk's full views; single-slot cache, safe for
        concurrent readers — a caller evicted mid-read keeps valid
        references to the old arrays.  scores=False skips the raw/final
        assembly."""
        with self._recon_lock:
            return self._chunk_recon_locked(ci, scores)

    def _chunk_recon_locked(self, ci: int, scores: bool) -> dict[str, np.ndarray]:
        d = self._recon if self._recon_ci == ci else None
        if d is not None and (not scores or "raw" in d):
            return d
        from . import hostnorm

        cc = self._compact
        if d is None:
            packed = cc.host("packed", ci)
            c, n = packed.shape
            f = len(self.cw.config.filters())
            _, code_bits, ff_bits = PACK_MODES[cc.pack_mode]
            p_int = packed.astype(np.int64)
            code = p_int & ((1 << code_bits) - 1)
            ffp = (p_int >> code_bits) & ((1 << ff_bits) - 1)  # 0 == all pass
            codes = np.zeros((c, f, n), np.int32)
            if f:
                idx = np.clip(ffp - 1, 0, f - 1)[:, None, :]
                np.put_along_axis(codes, idx, np.where(ffp > 0, code, 0)[:, None, :], axis=1)
            feasible = ffp == 0
            d = {"codes": codes, "feasible": feasible}
            self._recon_ci, self._recon = ci, d
        if scores:
            c, n = d["feasible"].shape
            if "ignored" not in d:  # scores-only cost; codes path skips it
                d["ignored"] = self._tsp_ignored_chunk(ci, c, n)
            raw = np.empty((c, len(cc.score_cols), n), np.int64)
            static_rows = self.cw.host.get("static_score_rows", {})
            sskip = self.cw.host.get("score_skip", {})
            lo = ci * cc.chunk
            for s, (group, row) in enumerate(cc.score_cols):
                if group == "host":
                    # precompiled row, never transferred; mask skipped pods
                    # to 0 exactly as the device output did
                    src = static_rows[row]
                    hi = min(lo + c, src.shape[0])
                    m = hi - lo
                    raw[:, s, :] = 0
                    if m > 0:
                        skip = np.asarray(sskip[row][lo:hi], bool)
                        raw[:m, s, :] = np.where(skip[:, None], 0, src[lo:hi])
                    continue
                raw[:, s, :] = cc.host(group, ci)[:, row, :]
            d["raw"] = raw
            d["final"] = hostnorm.finalize_chunk(
                self.cw, raw, d["feasible"], d["ignored"], ci * cc.chunk)
        return d

    def _tsp_ignored_chunk(self, ci: int, c: int, n: int) -> np.ndarray:
        """PodTopologySpread's score-ignore mask for chunk ci, recomputed
        from STATIC inputs (a node is ignored when it lacks the topology
        key of any of the pod's scored constraints) — dom_idx and the
        per-pod slots never change during a replay, so this never needs to
        travel from the device."""
        tsp = self.cw.host.get("tsp_ignore")
        if tsp is None:
            return np.zeros((c, n), bool)
        dom_neg, c_id, is_score = tsp  # [C, N] bool, [P, MC], [P, MC]
        lo = ci * self._compact.chunk
        hi = min(lo + c, c_id.shape[0])
        out = np.zeros((c, n), bool)
        for m in range(c_id.shape[1]):
            cid = c_id[lo:hi, m]
            scored = is_score[lo:hi, m] & (cid >= 0)
            if not scored.any():
                continue  # slot unused by this chunk: skip the gather
            rows = dom_neg[np.maximum(cid, 0)]       # [hi-lo, N]
            out[: hi - lo] |= scored[:, None] & rows
        return out

    def _materialize(self) -> None:
        """Fill the whole-array caches in ONE pass over the chunks (the
        reconstruction computes every field anyway)."""
        cc = self._compact
        p = self.cw.n_pods
        n = self.cw.n_nodes
        if cc is None or not cc.packed:
            self._filter_codes = np.zeros((0, len(self.cw.config.filters()), n), np.int32)
            self._score_raw = np.zeros((0, len(self.cw.config.scorers()), n), np.int64)
            self._score_final = np.zeros((0, len(self.cw.config.scorers()), n), np.int64)
            return
        pieces = {"codes": [], "raw": [], "final": []}
        for ci in range(len(cc.packed)):
            d = self._chunk_recon(ci, scores=True)
            for k in pieces:
                pieces[k].append(d[k])
        self._filter_codes = np.concatenate(pieces["codes"], axis=0)[:p]
        self._score_raw = np.concatenate(pieces["raw"], axis=0)[:p]
        self._score_final = np.concatenate(pieces["final"], axis=0)[:p]

    # whole-array views (tests / small workloads); raw/final are int64 on
    # the compact path
    @property
    def filter_codes(self) -> np.ndarray:  # [P, F, N]
        if self._filter_codes is None:
            self._materialize()
        return self._filter_codes

    @property
    def score_raw(self) -> np.ndarray:     # [P, S, N]
        if self._score_raw is None:
            self._materialize()
        return self._score_raw

    @property
    def score_final(self) -> np.ndarray:   # [P, S, N]
        if self._score_final is None:
            self._materialize()
        return self._score_final


class ChunkAttribution:
    """Incremental per-chunk work attribution over a compact replay.

    Computes `plugin_attribution`'s tallies one chunk at a time, so a
    streaming consumer can run them while the device scans later chunks
    and the tail pays only `finish()`.  Single-threaded by contract.
    Attribution is observability: any failure marks the accumulator
    broken and finish() returns None, never failing a replay."""

    def __init__(self, rr: ReplayResult):
        self.rr = rr
        cw = rr.cw
        self.filters = cw.config.filters()
        self.scorers = cw.config.scorers()
        self.p = cw.n_pods
        self.fskip = cw.host.get("filter_skip", {})
        self.sskip = cw.host.get("score_skip", {})
        self.fskip_mat = (
            np.stack([np.asarray(self.fskip.get(n, np.zeros(self.p)), bool)
                      for n in self.filters])
            if self.filters else None)  # [F, P]
        self.static_rows = cw.host.get("static_score_rows", {})
        self.out = {
            "filter": {n: {"evaluated": 0, "rejects": 0} for n in self.filters},
            "score": {n: {"evaluated": 0, "sum": 0} for n in self.scorers},
            "prefilter": {},
        }
        cc = rr._compact
        cols = cc.score_cols if cc is not None else ()
        # scorer indices by where their raw column lives: device columns
        # fold from B7's sums, host columns (precompiled static rows,
        # never transferred) tally here from B7's feasibility bitmap
        self._dev_cols = [s for s, (g, _r) in enumerate(cols) if g != "host"]
        self._host_cols = [s for s, (g, _r) in enumerate(cols) if g == "host"]
        self._done: set[int] = set()
        self.broken = False

    def add_chunk(self, ci: int) -> None:
        """Tally compact chunk ci (idempotent: width-tier re-deliveries are
        bit-identical, so the first tally wins).  A device-resident chunk
        folds B7's sums fetched with its decision rows and touches no
        compact tensor; any other chunk takes the host tally."""
        cc = self.rr._compact
        if self.broken or cc is None or ci in self._done or ci >= len(cc.packed):
            return
        self._done.add(ci)
        if not self.filters and not self.scorers:
            return  # nothing to tally; never touch the tensors
        try:
            att = cc.att[ci] if ci < len(cc.att) else None
            if att is not None:
                self._fold_device(ci, cc, att)
            else:
                self._tally_chunk(ci, cc)
        except Exception:  # noqa: BLE001 — observability must not fail a replay
            self.broken = True

    def _fold_device(self, ci: int, cc: _CompactChunks, dev: dict) -> None:
        """Fold one chunk's B7 outputs (kernels/attribution.py): filter
        counts are chunk totals, score sums per-pod int64 row sums."""
        lo = ci * cc.chunk
        hi = min(lo + cc.chunk, self.p)
        m = hi - lo
        out = self.out
        for f, name in enumerate(self.filters):
            out["filter"][name]["rejects"] += int(dev["f_rejects"][f])
            out["filter"][name]["evaluated"] += int(dev["f_evaluated"][f])
        if self._dev_cols:
            sums = dev["s_sums"][:m].sum(axis=0, dtype=np.int64)
            for q, s in enumerate(self._dev_cols):
                name = self.scorers[s]
                out["score"][name]["evaluated"] += int(dev["s_evaluated"][q])
                out["score"][name]["sum"] += int(sums[q])
        if self._host_cols:
            # host-resident static score rows never travel: their sums
            # need only the feasibility bitmap (N/8 bytes per pod)
            n = self.rr.cw.n_nodes
            feas = np.unpackbits(dev["feas_packed"][:m], axis=1,
                                 bitorder="little")[:, :n].astype(bool)
            feas_cnt = feas.sum(axis=1)
            scored = np.asarray(self.rr.feasible_count[lo:hi]) > 1
            for s in self._host_cols:
                name = self.scorers[s]
                sk = self.sskip.get(name)
                s_on = scored if sk is None else scored & ~np.asarray(sk[lo:hi], bool)
                rows = np.flatnonzero(s_on)
                if not rows.size:
                    continue
                arr = np.asarray(self.static_rows[cc.score_cols[s][1]][lo:hi])
                out["score"][name]["evaluated"] += int(feas_cnt[rows].sum())
                out["score"][name]["sum"] += int(np.sum(
                    arr[rows], dtype=np.int64, where=feas[rows]))

    def _tally_chunk(self, ci: int, cc: _CompactChunks) -> None:
        _, code_bits, _ = PACK_MODES[cc.pack_mode]
        lo = ci * cc.chunk
        hi = min(lo + cc.chunk, self.p)
        m = hi - lo
        ffp = cc.host("packed", ci)[:m].astype(np.int64) >> code_bits

        def arr_of(s: int) -> np.ndarray:
            group, row = cc.score_cols[s]
            if group == "host":
                return np.asarray(self.static_rows[row][lo:hi])
            # a view in the column's own dtype: the sum below accumulates
            # into int64 through dtype=
            return cc.host(group, ci)[:m, row, :]

        self._tally(lo, hi, ffp, arr_of)

    def _tally(self, lo: int, hi: int, ffp: np.ndarray, score_arr_of) -> None:
        """ffp: [m, N] first-fail words (0 == all active filters pass);
        score_arr_of(s) -> [m, N] raw column of scorer s (any integer
        dtype; sums accumulate in int64)."""
        out = self.out
        f_count = len(self.filters)
        m = hi - lo
        if f_count:
            # per-pod histogram of first-fail values 0..F, one bincount
            flat = (np.arange(m, dtype=np.int64)[:, None] * (f_count + 1) + ffp).ravel()
            counts = np.bincount(flat, minlength=m * (f_count + 1)).reshape(m, f_count + 1)
            rejects = counts[:, 1:]                        # [m, F]
            # filter f ran on a node iff ffp == 0 or ffp > f: all-pass
            # nodes plus nodes whose first fail is at a later index
            suff = np.cumsum(rejects[:, ::-1], axis=1)[:, ::-1]
            ran = counts[:, :1] + suff                     # [m, F]
            for f, name in enumerate(self.filters):
                out["filter"][name]["rejects"] += int(rejects[:, f].sum())
                col = ran[:, f]
                skips = self.fskip_mat[f, lo:hi]
                if skips.any():
                    col = np.where(skips, 0, col)
                out["filter"][name]["evaluated"] += int(col.sum())
        if self.scorers:
            feas = ffp == 0                                # [m, N]
            feas_cnt = feas.sum(axis=1)
            fc = self.rr.feasible_count
            scored = np.asarray(fc[lo:hi]) > 1 if fc is not None else np.zeros(m, bool)
            if not scored.any():
                return
            for s, name in enumerate(self.scorers):
                sk = self.sskip.get(name)
                s_on = scored if sk is None else scored & ~np.asarray(sk[lo:hi], bool)
                rows = np.flatnonzero(s_on)
                if not rows.size:
                    continue
                arr = score_arr_of(s)
                out["score"][name]["evaluated"] += int(feas_cnt[rows].sum())
                out["score"][name]["sum"] += int(np.sum(
                    arr[rows], dtype=np.int64, where=feas[rows]))

    def _prefilter(self) -> None:
        rr = self.rr
        cw = rr.cw
        static = cw.host.get("prefilter_reject", {})
        dyn = (np.asarray(rr.prefilter_reject) if rr.prefilter_reject is not None
               else np.zeros(self.p, np.int64))
        for name in cw.config.prefilters():
            skips = self.fskip.get(name)
            evaluated = self.p - (int(np.count_nonzero(np.asarray(skips, bool)))
                                  if skips is not None else 0)
            screened = 0
            msgs = static.get(name)
            if msgs is not None:
                screened += sum(1 for msg in msgs if msg is not None)
            if name == "VolumeRestrictions":
                screened += int(np.count_nonzero(np.asarray(dyn, np.int64) & 1))
            self.out["prefilter"][name] = {"evaluated": evaluated, "screened": screened}

    def finish(self) -> dict | None:
        """Tally whatever chunks were not added, then the prefilter
        section.  None when broken."""
        cc = self.rr._compact
        if cc is not None:
            for ci in range(len(cc.packed)):
                self.add_chunk(ci)
        if self.broken:
            return None
        self._prefilter()
        return self.out


def plugin_attribution(rr: ReplayResult) -> dict | None:
    """Per-plugin work attribution from the tensors a replay already holds.

    Returns
      {"filter":    {name: {"evaluated": pods x nodes the plugin ran on,
                            "rejects": nodes it first-failed}},
       "score":     {name: {"evaluated": pods x feasible nodes scored,
                            "sum": raw score sum over those}},
       "prefilter": {name: {"evaluated": pods screened (not skipped),
                            "screened": pods it rejected pre-wave}}}
    or None when the result is empty or holds neither layout.

    A filter plugin "ran" on (pod, node) when no earlier active plugin
    failed there (stop at first fail); scoring happens only for pods with
    more than one feasible node; a PreFilter-skipped plugin attributes
    nothing.  The compact layout goes through ChunkAttribution."""
    cw = rr.cw
    p = cw.n_pods
    if p == 0:
        return None
    cc = rr._compact
    if cc is not None and cc.packed:
        return ChunkAttribution(rr).finish()
    acc = ChunkAttribution(rr)
    if rr._filter_codes is None and rr._score_raw is None:
        if not cw.config.prefilters():
            return None
        acc._prefilter()
        return acc.out
    # full-array layout: the first-fail index from the per-plugin codes,
    # the same stop-at-first-fail rule
    codes = (np.asarray(rr._filter_codes) if rr._filter_codes is not None
             else np.zeros((p, 0, cw.n_nodes), np.int32))
    raw = (np.asarray(rr._score_raw) if rr._score_raw is not None
           else np.zeros((p, 0, cw.n_nodes), np.int64))
    if codes.shape[1]:
        fail = codes != 0                                   # [P, F, N]
        first = np.argmax(fail, axis=1)                     # [P, N]
        ffp_full = np.where(fail.any(axis=1), first + 1, 0).astype(np.int64)
    else:
        ffp_full = np.zeros((p, codes.shape[2]), np.int64)
    acc._tally(0, p, ffp_full, lambda s: np.asarray(raw[:, s, :], np.int64))
    if acc.broken:
        return None
    acc._prefilter()
    return acc.out


def _slice_xs(xs: dict[str, Any], lo: int, hi: int, pad_to: int) -> dict[str, Any]:
    """Pods lo..hi of every per-pod tensor, zero-padded to pad_to rows (on
    each card of a card mesh, kernels/mesh.py Cards)."""
    if isinstance(xs, tuple):
        return xs.map(lambda part: _slice_xs(part, lo, hi, pad_to))

    def cut(a):
        piece = a[lo:hi]
        if pad_to > piece.shape[0]:
            pad = torch.zeros((pad_to - piece.shape[0],) + tuple(piece.shape[1:]),
                              dtype=piece.dtype, device=piece.device)
            piece = torch.cat([piece, pad])
        return piece.contiguous()

    return {k: cut(v) if isinstance(v, torch.Tensor) else type(v)(*[cut(a) for a in v])
            for k, v in xs.items()}


def _clone_carry(carry: dict[str, Any]) -> dict[str, Any]:
    """A private copy of the initial carry: the kernel updates the carry in
    place, and cw.init_carry must survive for later replays of the same
    compiled workload (replay.py:1488-1490, where the scan donates it);
    a card mesh's carry card by card."""
    if isinstance(carry, tuple):  # kernels/mesh.py Cards
        return carry.map(_clone_carry)
    return {k: v.clone() if isinstance(v, torch.Tensor)
            else type(v)(*[a.clone() for a in v]) for k, v in carry.items()}


class _Landing:
    """An in-flight D2H of named tensors.  On the card each tensor is
    copied, non-blocking, into a pinned host buffer and an event is
    recorded behind the copies; result() waits on that event only.  CPU
    tensors are already on the host.  `event` also marks the point after
    which every launch writing the chunk has run (the chunk's `ready`).
    `error`: a fetch that failed to start; result() raises it, where the
    JAX package's fetch future would (replay.py:1616-1634)."""

    def __init__(self, tensors: dict, error: BaseException | None = None):
        self.event = None
        self.error = error
        self._host = {}
        for name, t in tensors.items():
            if t.device.type == "cuda":
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host[name] = h
            else:
                self._host[name] = t
        if any(t.device.type == "cuda" for t in tensors.values()):
            self.event = torch.cuda.Event()
            self.event.record()

    def result(self) -> dict[str, np.ndarray]:
        """name -> host numpy (C order), plus "_d2h_bytes"."""
        if self.error is not None:
            raise self.error
        if self.event is not None:
            self.event.synchronize()
        c = {name: _to_host(h) for name, h in self._host.items()}
        c["_d2h_bytes"] = sum(a.nbytes for a in c.values())
        return c


def _ready_event(device: torch.device):
    """A CUDA event recorded on the current stream behind the launches so
    far, for a device-resident chunk's `ready`; None on the CPU."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


def _fetch_started() -> BaseException | None:
    """The `replay.decision_fetch` seam of one in-wave fetch.  The JAX
    package fires it on the fetch thread and its error surfaces when the
    chunk is ingested, after later chunks were dispatched; the port
    fires it as the fetch starts and the landing raises it at the same
    ingest."""
    try:
        fault_point("replay.decision_fetch")
    except Exception as e:  # noqa: BLE001 — re-raised by _Landing.result
        return e
    return None


def _fetch_chunk(out) -> _Landing:
    """The host-resident rung: one chunk's whole CompactOut."""
    err = _fetch_started()
    if err is not None:
        return _Landing({}, error=err)
    return _Landing({f: getattr(out, f) for f in out._fields})


_DECISION_FIELDS = ("selected", "feasible_count", "prefilter_reject", "raw_overflow")


def _fetch_decisions(out, att: dict | None) -> _Landing:
    """The device-resident rung: only the per-pod rows commit and bind
    consume, O(chunk) bytes, and B7's sums (keys "att:<name>"); the heavy
    tensors stay on the device."""
    err = _fetch_started()
    if err is not None:
        return _Landing({}, error=err)
    tensors = {f: getattr(out, f) for f in _DECISION_FIELDS}
    for k, v in (att or {}).items():
        tensors[f"att:{k}"] = v
    return _Landing(tensors)


def _split_att(c: dict) -> dict | None:
    """Move a landed fetch's "att:<name>" entries into c["att"]."""
    att = {k[4:]: c.pop(k) for k in [k for k in c if k.startswith("att:")]}
    return att or None


class _DeviceAttribution:
    """Per-replay context of B7 (kernels/attribution.py): pads the per-pod
    PreFilter and score skip masks to the chunk grid with "skipped", puts
    them on the device once, chunk-major so each chunk's [F, C] and [S, C]
    slices are contiguous, and runs B7 on each chunk's outputs."""

    __slots__ = ("enabled", "chunk", "p", "code_bits", "dev_cols", "want_pack",
                 "fskip_dev", "sskip_dev")

    def __init__(self, cw: CompiledWorkload, chunk: int, pack_mode: str, score_cols: tuple):
        f_names = cw.config.filters()
        s_names = cw.config.scorers()
        self.enabled = bool(f_names or s_names)
        if not self.enabled:
            return
        self.dev_cols = tuple((s, g, r) for s, (g, r) in enumerate(score_cols) if g != "host")
        self.want_pack = any(g == "host" for g, _r in score_cols)
        self.code_bits = PACK_MODES[pack_mode][1]
        p = cw.n_pods
        self.p, self.chunk = p, chunk
        n_chunks = max(1, -(-p // chunk))
        ppad = n_chunks * chunk
        # pad rows read as "skipped": they contribute nothing even before
        # the valid mask cuts them
        fmat = np.ones((len(f_names), ppad), np.bool_)
        fskip = cw.host.get("filter_skip", {})
        for f, nm in enumerate(f_names):
            fmat[f, :p] = np.asarray(fskip.get(nm, np.zeros(p)), bool)
        smat = np.ones((max(len(s_names), 1), ppad), np.bool_)
        sskip = cw.host.get("score_skip", {})
        for s, nm in enumerate(s_names):
            smat[s, :p] = np.asarray(sskip.get(nm, np.zeros(p)), bool)

        def chunk_major(a: np.ndarray) -> torch.Tensor:
            a = a.reshape(a.shape[0], n_chunks, chunk).transpose(1, 0, 2)
            return torch.from_numpy(np.ascontiguousarray(a)).to(cw.device)

        self.fskip_dev = chunk_major(fmat)
        self.sskip_dev = chunk_major(smat)

    def run(self, out, lo: int) -> dict:
        k = lo // self.chunk
        m = min(lo + self.chunk, self.p) - lo
        return chunk_attribution(out.packed_filter, out.raw8, out.raw16, out.raw32,
                                 out.feasible_count, self.fskip_dev[k], self.sskip_dev[k],
                                 m, self.code_bits, self.dev_cols, self.want_pack)


def _resolve_device_resident(device_resident: bool | None, collect: bool, on_chunk) -> bool:
    """Result residency of one replay: device-resident is the default
    whenever no streaming consumer decodes in-wave (on_chunk is None, or
    the caller asked for it explicitly).  KSS_TPU_EAGER_DECODE=1 and
    KSS_TPU_HOST_RESIDENT=1 force the host-resident fetch."""
    if not collect:
        return False
    if host_resident_forced():
        return False
    if device_resident is None:
        return on_chunk is None
    return bool(device_resident)



def check_unroll(unroll: int) -> None:
    """The JAX package's `unroll=` as lax.scan takes it: an int of at least
    1 (lax.scan raises below that).  The step kernel walks a chunk's pods
    in one launch, so the value selects nothing here."""
    if int(unroll) < 1:
        raise ValueError(f"unroll must be a positive integer, got {unroll}")

def replay(cw: CompiledWorkload, chunk: int = 512, collect: bool = True, on_chunk=None,
           device_resident: bool | None = None, device="cuda", mesh=None,
           unroll: int = 1, filter_only: bool = False) -> ReplayResult:
    """Run the full queue; returns host-side result arrays.

    collect=False fetches only the per-pod selections, feasible counts and
    PreFilter rejects (the pure-throughput mode).
    on_chunk: optional callback (rr, lo, hi) fired as each chunk lands,
    while the device runs later chunks.  Chunks arrive in ascending,
    contiguous [lo, hi) order.  It may fire again from the first chunk
    when a score width tier overflows, so per-pod writes must be
    idempotent; a chunk delivered before the overflow carries bit-identical
    values on the wider rerun.
    device_resident: keep each chunk's CompactOut on the device and fetch
    only the decision rows and B7's sums in-wave (the default when
    on_chunk is None); a cold read fetches a chunk once.  None = auto;
    KSS_TPU_EAGER_DECODE=1 / KSS_TPU_HOST_RESIDENT=1 force the host fetch.
    device: where the replay runs ("cuda" by default, which needs a card;
    "cpu" runs the plain PyTorch versions).  It must be the device `cw`
    was compiled for.
    mesh: a one-card parallel.mesh.Mesh — the workload's node axis is
    sharded over its "nodes" extent (parallel/mesh.py shard_workload) and
    every chunk runs B12 `step_chunk_sharded`, each shard a group of the
    step kernel's CTAs; results are byte-identical to the unsharded
    replay.  The node count must divide by the "nodes" extent.
    unroll: the JAX package's lax.scan unroll factor, taken as it takes
    it: a value below 1 raises, as lax.scan refuses it, and any other
    changes nothing, since the step kernel loops over the chunk's pods
    itself (one launch a chunk) and a hint to unroll a scan cannot change
    a result.
    filter_only: the caller only consumes filter codes / prefilter
    rejects (preemption's fit checks), so a custom NormalizeScore, which
    the chunked step cannot run, is allowed."""
    check_unroll(unroll)
    device = resolve_device(device)
    if cw.device != device:
        raise ValueError(f"workload compiled for {cw.device}, replay asked for {device}")
    if mesh is not None:
        from ..parallel.mesh import shard_workload

        cw = shard_workload(cw, mesh)
    if not filter_only:
        for name in cw.config.enabled:
            if cw.config.is_custom(name) and getattr(
                    cw.config.custom[name], "has_normalize", False):
                raise ValueError(
                    f"custom plugin {name} has NormalizeScore: the batched "
                    "scan cannot run it — schedule through the engine (it "
                    "routes to the host-interleaved path) or use "
                    "build_phased directly")
    device_resident = _resolve_device_resident(device_resident, collect, on_chunk)
    # widening ladder: narrow groups -> int32 -> int64 (a raw overflowing
    # its group dtype triggers the next tier; int64 is the upstream score
    # type and cannot overflow).  A compile-time-proven beyond-int32 bound
    # skips straight to i64.
    tiers = (("i64",) if "i64" in cw.host.get("score_dtypes", ())
             else (None, "i32", "i64"))
    for k, wide in enumerate(tiers):
        result = _replay_run(cw, chunk, wide, collect, on_chunk, device_resident)
        if result is not None:
            result.tiers = tiers[:k + 1]
            return result
        TRACER.count("replay_width_retries_total")
    raise AssertionError("unreachable: i64 replay cannot overflow")


def _compact_plan(cw: CompiledWorkload, wide: str | None):
    """(pack_mode, score_dtypes, score_cols) for this workload."""
    pack_mode = choose_pack_mode(
        cw.host.get("max_filter_code", 1 << 62),
        len(cw.config.filters()),
    )
    score_dtypes = cw.host.get(
        "score_dtypes", tuple("i16" for _ in cw.config.scorers()))
    counts = {"i8": 0, "i16": 0, "i32": 0}
    cols = []
    for name, g in zip(cw.config.scorers(), score_dtypes):
        if g == "host":
            # precompiled host-resident raw (cw.host["static_score_rows"]):
            # reconstructed from the host copy, never fetched
            cols.append(("host", name))
            continue
        g = "i32" if wide else g  # widened runs pool every scorer in raw32
        cols.append(({"i8": "raw8", "i16": "raw16", "i32": "raw32"}[g], counts[g]))
        counts[g] += 1
    return pack_mode, score_dtypes, tuple(cols)


def _leaves(tree, path: str = ""):
    """(path, leaf) of every leaf of a workload tree: dicts of tensors or
    NamedTuples of tensors, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), f"{path}.{f}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _statics_fingerprint(cw: CompiledWorkload) -> str:
    """replay.py:1069: a hash of the statics' CONTENT (shape, dtype and
    bytes of every leaf), computed once per workload."""
    fp = cw.host.get("_statics_fp")
    if fp is not None:
        return fp
    import hashlib

    h = hashlib.sha1()
    # a card mesh's statics card by card (kernels/mesh.py Cards)
    for statics in cw.statics if isinstance(cw.statics, tuple) else (cw.statics,):
        _hash_statics(h, statics)
    fp = h.hexdigest()
    cw.host["_statics_fp"] = fp
    return fp


def _hash_statics(h, statics: dict) -> None:
    for name in sorted(statics):
        h.update(name.encode())
        for _path, leaf in _leaves(statics[name]):
            a = _to_host(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
            h.update(str(a.shape).encode())
            h.update(str(a.dtype).encode())
            h.update(a.tobytes())


def _workload_scan_key(cw: CompiledWorkload, chunk: int):
    """replay.py:1092: what picks a workload's compiled programs in the
    JAX package: the statics' content, the signature of the mesh `cw` is
    sharded over (None without one), the xs and carry SHAPES (not their
    values), the plugin configuration and the chunk.  Two workloads with
    equal keys run the same step over different pods; the fuse family
    (parallel/speculative.py `_fuse_family`) is built on it, so only
    sessions on the same mesh stack."""
    import json

    mesh_sig = cw.mesh.signature() if cw.mesh is not None else None
    shapes = tuple((path, tuple(np.shape(leaf)), str(leaf.dtype if isinstance(leaf, torch.Tensor)
                                                      else np.asarray(leaf).dtype))
                   for tree in (cw.xs, cw.init_carry) for path, leaf in _leaves(tree))
    cfg = cw.config
    cfg_sig = (
        tuple(cfg.enabled),
        tuple(sorted((n, cfg.weight(n)) for n in cfg.scorers())),
        tuple((n, id(p)) for n, p in sorted(cfg.custom.items())),
        json.dumps(cfg.args, sort_keys=True, default=str),
        tuple(cw.schema.columns),
        tuple(sorted((k, tuple(v)) for k, v in cfg.point_enabled.items())),
        tuple(sorted((k, tuple(sorted(v))) for k, v in cfg.point_disabled.items())),
    )
    return (_statics_fingerprint(cw), mesh_sig, shapes, cfg_sig, chunk)


# chunks in flight before the dispatch loop waits on the oldest fetch.
# Host-resident: bounds the fetch buffers at O(inflight x chunk x N).
# Device-resident: landed chunks stay on the device by design, so this
# only throttles the decision-row fetches; _DEVICE_BUDGET bounds the
# device memory retained chunks pin.
_MAX_INFLIGHT = 4


class _TinyOut:
    """collect=False holder: keeps ONLY the per-pod scalars referenced, so
    the chunk's big result buffers free as soon as the device is done."""

    _fields = ("selected", "feasible_count", "prefilter_reject")

    def __init__(self, out):
        self.selected = out.selected
        self.feasible_count = out.feasible_count
        self.prefilter_reject = out.prefilter_reject


def _replay_run(cw: CompiledWorkload, chunk: int, wide: str | None, collect: bool,
                on_chunk, device_resident: bool) -> ReplayResult | None:
    """One tier of the ladder: every chunk runs; None when a raw overflowed
    its group dtype (the caller reruns at the next tier)."""
    p = cw.n_pods
    chunk = min(chunk, max(p, 1))
    pack_mode, score_dtypes, score_cols = _compact_plan(cw, wide)
    step = build_step(cw, out_mode="compact", pack_mode=pack_mode,
                      score_dtypes=score_dtypes, wide_raw=wide)
    carry = _clone_carry(cw.init_carry)

    def chunk_xs(lo: int) -> dict:
        hi = min(lo + chunk, p)
        xs_chunk = _slice_xs(cw.xs, lo, hi, chunk)
        xs_chunk["is_pad"] = torch.arange(chunk, device=cw.device) >= (hi - lo)
        return xs_chunk

    if not collect:
        outs = []
        for lo in range(0, p, chunk):
            fault_point("replay.scan_dispatch")
            carry, out = step.scan(carry, chunk_xs(lo))
            outs.append(_TinyOut(out))

        def cat(field: str) -> np.ndarray:
            if not outs:
                return np.zeros((0,), dtype=np.int32)
            return np.concatenate([_to_host(getattr(o, field)) for o in outs])[:p]

        return ReplayResult(cw=cw, selected=cat("selected"),
                            feasible_count=cat("feasible_count"),
                            prefilter_reject=cat("prefilter_reject"))

    compact = _CompactChunks(chunk=chunk, pack_mode=pack_mode, score_cols=score_cols)
    selected = np.full(p, -1, dtype=np.int32)
    feasible_count = np.zeros(p, dtype=np.int32)
    prefilter_reject = np.zeros(p, dtype=np.int32)
    rr = ReplayResult(cw=cw, selected=selected, feasible_count=feasible_count,
                      prefilter_reject=prefilter_reject, compact=compact)
    check_overflow = wide != "i64"
    att_ctx = _DeviceAttribution(cw, chunk, pack_mode, score_cols) if device_resident else None
    if att_ctx is not None and not att_ctx.enabled:
        att_ctx = None

    def ingest(lo: int, landing: _Landing, dev_out) -> bool:
        c = landing.result()
        if check_overflow and c["raw_overflow"].any():
            return False  # the caller reruns at the next width tier
        hi = min(lo + chunk, p)
        m = hi - lo
        att = _split_att(c)
        if dev_out is not None:
            # device-resident: the heavy tensors stay where they are;
            # only the decision rows and B7's sums crossed
            for g, f in zip(_CompactChunks.GROUPS, ("packed_filter", "raw8", "raw16", "raw32")):
                getattr(compact, g).append(getattr(dev_out, f))
        else:
            for g, f in zip(_CompactChunks.GROUPS, ("packed_filter", "raw8", "raw16", "raw32")):
                getattr(compact, g).append(c[f])
        compact.ready.append(landing.event if dev_out is not None else None)
        compact.att.append(att)
        compact.d2h_bytes.append(c["_d2h_bytes"])
        TRACER.count("wave_d2h_bytes_total", c["_d2h_bytes"])
        if dev_out is not None:
            ci = len(compact.packed) - 1
            _DEVICE_BUDGET.retain(compact, ci, compact.device_nbytes(ci))
        selected[lo:hi] = c["selected"][:m]
        feasible_count[lo:hi] = c["feasible_count"][:m]
        prefilter_reject[lo:hi] = c["prefilter_reject"][:m]
        if on_chunk is not None:
            on_chunk(rr, lo, hi)
        return True

    pending: deque = deque()   # (lo, landing, the chunk's CompactOut if device-resident)
    for lo in range(0, p, chunk):
        fault_point("replay.scan_dispatch")
        carry, out = step.scan(carry, chunk_xs(lo))
        # launches return at once; the fetch lands while the device runs
        # later chunks
        if device_resident:
            att = att_ctx.run(out, lo) if att_ctx is not None else None
            pending.append((lo, _fetch_decisions(out, att), out))
        else:
            pending.append((lo, _fetch_chunk(out), None))
        del out
        while len(pending) > _MAX_INFLIGHT:
            if not ingest(*pending.popleft()):
                _DEVICE_BUDGET.drop(compact)
                return None
    while pending:
        if not ingest(*pending.popleft()):
            _DEVICE_BUDGET.drop(compact)
            return None
    return rr
