"""Scheduling engine: drives the tensor pipeline against the cluster store.

This is the in-process equivalent of the reference's debuggable-scheduler
process (SURVEY.md §3.2): it takes pending pods from the cluster, runs the
batched Filter/Score program, binds the chosen nodes, deposits the decoded
result annotations in the result store, and triggers the reflector —
replacing the informer round-trip of the reference (storereflector
registers a Pod-update handler; binding IS the update that triggers it).

Queue order follows the PrioritySort queue-sort plugin: descending
.spec.priority, FIFO within equal priority (upstream
pkg/scheduler/framework/plugins/queuesort).  Unschedulable pods get the
PodScheduled=False/Unschedulable condition, like the scheduler's status
update, which also carries their result annotations out.

Port of kube_scheduler_simulator_tpu/framework/engine.py, rewired to the
port: every wave compiles, replays and streams on the engine's `device`
("cuda" by default, which raises without a card; "cpu" runs the plain
PyTorch versions) and never falls back to the CPU.  The kernels it
reaches beyond the replay's and the stream's: B8 `quorum_slice` in every
gang wave (`_gang_decide`) and B10 `phased_eval` / `renormalize_rows`
with B5's `spec_commit_bind` on the host-interleaved path
(`_schedule_host_path`).  `mesh=` (a parallel.mesh.Mesh on one card, or
over cards) runs every wave whose node count divides the mesh's "nodes"
extent through the node-sharded replay and stream (B12 on one card, B12b
over cards: each wave's workload placed over the mesh's cards), and the
rest unsharded, counted by `mesh_fallback_indivisible_nodes_total` (JAX
engine.py:1186-1192); `unroll` is kept in the
signature and not passed on (the step kernel has none, and it never
changes a result).  Each wave compiles with the previous wave's node
table (`reuse=`, a NodeTableReuse: kept as it is, patched at the changed
rows or rebuilt, engine.py:1153-1166) and, where the store lists from
its columnar plane (cluster/columnar.py), the pods' request rows
gathered from the pod bank (`pod_columns=`).
"""

from __future__ import annotations

import copy
import functools
import os
import time

import numpy as np

from .. import resolve_device
from .replay import _clone_carry, _slice_xs, replay
from ..cluster.store import Conflict, NotFound, ObjectStore
from ..utils.tracing import TRACER
from ..plugins.registry import PluginSetConfig
from ..state.compile import NodeTableReuse, compile_workload
from ..store import annotations as ann
from ..store.decode import decode_pod_result
from ..store.reflector import StoreReflector
from ..store.resultstore import ResultStore

RESULT_STORE_KEY = "PluginResultStoreKey"      # reference: plugins.go:23
EXTENDER_STORE_KEY = "ExtenderResultStoreKey"  # reference: extender/service.go:24
DEFAULT_SCHEDULER_NAME = "default-scheduler"


class _LazyDecode:
    """list-like view decoding each pod's annotations on first access."""

    def __init__(self, rr):
        self.rr = rr

    def __getitem__(self, i):
        return decode_pod_result(self.rr, i)


class _ReflectBatcher:
    """Chunked async reflect write-backs, shared by the sequential
    post-pass and the pipelined committer so their batching and error
    semantics cannot diverge: ~batch_n pods per pool future; every pod
    in a batch is attempted even if an earlier one fails, and the first
    error surfaces from drain().

    use_batch routes through StoreReflector.reflect_batch (the
    apply_batch surface) — the committer's mode; the sequential
    post-pass keeps per-pod reflect() (its pre-change mechanism, and
    the parity baseline)."""

    def __init__(self, engine: "SchedulerEngine", n_pending: int,
                 use_batch: bool):
        self._pool = engine._reflector_pool()
        # small waves still fan across the pool; 10k-pod waves cost ~150
        # futures instead of 10k
        self._batch_n = max(1, min(64, n_pending // 8))
        self._batch: list[tuple[str, str, str | None]] = []
        self._futs: list = []
        fn = getattr(engine.reflector, "reflect_batch", None) if use_batch \
            else None
        if fn is None:
            from ..store.reflector import reflect_each

            reflect_one = engine.reflector.reflect

            def fn(batch):
                reflect_each(reflect_one, batch)
        self._fn = fn

    def submit(self, ns: str, name: str, uid: str | None) -> None:
        self._batch.append((ns, name, uid))
        if len(self._batch) >= self._batch_n:
            self._futs.append(self._pool.submit(self._fn, self._batch[:]))
            self._batch.clear()

    def drain(self) -> None:
        if self._batch:
            self._futs.append(self._pool.submit(self._fn, self._batch[:]))
            self._batch.clear()
        for f in self._futs:
            f.result()


def _fetch_step_out(out):
    """One pod's StepOut on the host: its six int32 fields in ONE
    device-to-host copy (the host loop reads every field), as numpy."""
    import torch

    from .pipeline import StepOut

    flat = torch.cat([t.reshape(-1) for t in out]).cpu().numpy()
    fields, at = [], 0
    for t in out:
        k = t.numel()
        fields.append(flat[at:at + k].reshape(tuple(t.shape)))
        at += k
    return StepOut(*fields)


class _GangParked:
    """A gang member parked by the vectorized quorum pass: its assumed
    node (the speculative assignment rolled back to waiting), the
    group it waits for, and the timeout that rejects the whole gang."""

    __slots__ = ("ns", "name", "uid", "node", "group", "deadline",
                 "timeout_str", "seq")

    def __init__(self, ns, name, uid, node, group, deadline, timeout_str, seq):
        self.ns = ns
        self.name = name
        self.uid = uid
        self.node = node
        self.group = group
        self.deadline = deadline
        self.timeout_str = timeout_str
        self.seq = seq


class _GangCtx:
    """Per-wave gang state for the vectorized admission pass
    (docs/gang-scheduling.md): the pod→group id vector the quorum
    segment-reduction runs over, per-group specs, and the
    waiting+bound counts frozen at wave start."""

    __slots__ = ("gp_name", "keys", "gid", "min_member", "already",
                 "timeout_s", "timeout_str", "start", "last",
                 "admitted_before", "counted", "pending")

    def __init__(self, gp_name: str, pending: list[dict], directory,
                 parked_counts: dict):
        import numpy as np

        from .gang import group_key_of

        self.gp_name = gp_name
        self.pending = pending
        self.keys: list[tuple[str, str]] = []
        self.timeout_s: list[float] = []
        self.timeout_str: list[str] = []
        n = len(pending)
        self.gid = np.full(n, -1, dtype=np.int32)
        ids: dict[tuple[str, str], int] = {}
        start: list[int] = []
        last: list[int] = []
        mins: list[int] = []
        already: list[int] = []
        for i, p in enumerate(pending):
            key = group_key_of(p)
            if key is None:
                continue
            spec = directory.specs.get(key)
            if spec is None:
                continue  # label without a PodGroup: ordinary pod
            g = ids.get(key)
            if g is None:
                g = ids[key] = len(self.keys)
                self.keys.append(key)
                self.timeout_s.append(spec.timeout_seconds)
                self.timeout_str.append(spec.timeout_str)
                mins.append(spec.min_member)
                already.append(parked_counts.get(key, 0)
                               + directory.bound.get(key, 0))
                start.append(i)
                last.append(i)
            self.gid[i] = g
            last[g] = i
        self.min_member = np.asarray(mins, dtype=np.int32)
        self.already = np.asarray(already, dtype=np.int32)
        self.start = np.asarray(start, dtype=np.int32)
        self.last = np.asarray(last, dtype=np.int32)
        self.admitted_before = [directory.bound.get(k, 0) > 0
                                for k in self.keys]
        self.counted: set[int] = set()

    def __bool__(self) -> bool:
        return bool(self.keys)


class _NoGang:
    """Falsy wave sentinel: the gang plugin is enabled and handled by
    the engine this wave (so the custom-lifecycle set excludes it), but
    no group has members in the wave — every commit path runs its
    plain, gang-free code."""

    def __bool__(self) -> bool:
        return False


_GANG_NONE = _NoGang()

# the degradation ladder's rungs (docs/fault-injection.md): all three
# are bit-identical parity gates (tests/test_device_resident.py), so
# stepping down after a structural device fault is provably lossless —
# it trades wall time (host fetch, eager decode) for survival
_RESIDENCY_MODES = ("device_resident", "host_resident", "eager_decode")


class _WaveAbort(Exception):
    """Internal: a wave attempt failed mid-flight.  Carries the
    UNCOMMITTED SUFFIX of the attempt's (filtered: exclude/gates/gang
    prescreen already applied) pending list — everything before it
    landed: binds stand, gang state is consistent at the commit
    boundary — and the binds already counted, so the wave failure
    protocol retries exactly the suffix and returns an accurate bound
    total (docs/fault-injection.md).  The suffix is the filtered list
    itself, not an index into the caller's pending: the attempt
    filters before committing, so outer indices would misalign."""

    def __init__(self, cause: BaseException, remaining: list,
                 n_bound: int, stage: str):
        super().__init__(f"wave aborted at {stage}: "
                         f"{type(cause).__name__}: {cause}")
        self.cause = cause
        self.remaining = remaining
        self.n_bound = n_bound
        self.stage = stage


class _WaveCommitter:
    """Chunk-pipelined commit consumer for a streaming wave.

    replay(on_chunk=...) delivers decoded chunks in ascending pod order
    while the device scans later chunks; on_chunk (replay thread) decodes
    the chunk and hands it to a single worker thread that runs the commit
    phase — result-store puts, batched binds / unschedulable marks
    (ObjectStore.apply_batch), reflect submissions — in pod order.  The
    single worker preserves the sequential path's per-pod ordering, so
    annotations, bind order and result-history are bit-identical to the
    post-pass (tests/test_golden_annotations.py parity gate).

    Width-tier reruns: a score overflow makes replay() re-deliver chunks
    from index 0 at a wider dtype.  Chunks that were ingested WITHOUT the
    overflow flag are bit-identical across tiers (pipeline.py compares
    the full-precision scores against the narrowed transfer before
    setting the flag), so the worker keeps a committed-up-to watermark
    and skips re-delivered pods instead of double-committing them.

    The commit time spent while the device was still scanning is
    reported as the commit_stream_overlap_seconds counter; the
    commit_and_reflect span covers only the post-replay tail (what the
    wave still serializes on)."""

    def __init__(self, engine: "SchedulerEngine", node_names, pending,
                 gang: "_GangCtx | None" = None, lazy: bool = False):
        import queue
        import threading

        self.engine = engine
        self.node_names = node_names
        self.pending = pending
        self.annotations: list = [None] * len(pending)
        # lazy mode (store/lazy.py): on_chunk skips the decode entirely —
        # the commit consumes TENSOR-LEVEL decisions (selected/gang
        # quorum) and deposits LazyWave handles; annotations materialize
        # on first read, off the wave's critical path
        self.lazy = lazy
        self._waves: list = []     # one LazyWave per width-tier replay run
        self._cur_rr = None
        # gang ranges can span chunks from two width tiers: remember the
        # wave each pod's chunk was delivered by (byte-identical across
        # tiers for delivered chunks, but exactness is free)
        self._pod_wave: list | None = (
            [None] * len(pending) if (lazy and gang) else None)
        self.n_bound = 0
        # gang-atomic streaming (docs/gang-scheduling.md): commit ranges
        # are cut on gang boundaries — a gang straddling the chunk edge
        # defers to the next chunk's commit (or the wave's tail), so the
        # quorum decision always sees the whole gang
        self.gang = gang if gang else None
        self._selected = (np.full(len(pending), -2, dtype=np.int32)
                          if self.gang is not None else None)
        # wave span id set by the engine once the replay span opens, so
        # the worker's commit_stream spans parent under it across the
        # thread boundary (utils/tracing.py span tree)
        self.parent_span: int | None = None
        self._upto = 0          # pods [0, _upto) already committed
        self._busy: list[tuple[float, float]] = []
        self._exc: BaseException | None = None
        self._stop = False      # abort(): drop queued chunks uncommitted
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._reflects = _ReflectBatcher(engine, len(pending), use_batch=True)
        # the worker inherits the engine's session scope (its own thread:
        # thread-local scopes don't cross the boundary by themselves)
        self._session = getattr(engine, "session", None)
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="commit-stream")
        self._thread.start()

    # ---------------------------------------------- replay-thread side

    def on_chunk(self, rr, lo: int, hi: int) -> None:
        import numpy as np

        wave = None
        if self.lazy:
            # chunk HANDOFF only: no decode on the replay thread — a
            # width-tier rerun delivers a fresh ReplayResult, which gets
            # its own LazyWave (already-committed pods keep handles into
            # the old one; delivered chunks are bit-identical across
            # tiers, replay() contract)
            if self._cur_rr is not rr:
                from ..store.lazy import LazyWave
                from .replay import ChunkAttribution

                self._cur_rr = rr
                w = LazyWave(rr, len(self.pending))
                # per-plugin attribution tallies on the commit worker,
                # chunk by chunk, overlapped with the device scan — off
                # the wave tail (framework/replay.py ChunkAttribution)
                w._attr_acc = ChunkAttribution(rr)
                self._waves.append(w)
            wave = self._waves[-1]
        else:
            # the WHOLE chunk goes down in one call: decode_chunk_into
            # routes it through the chunk-granular native decode (one
            # GIL-released C call per chunk, C-side worker pool)
            from ..store.decode import decode_chunk_into

            decode_chunk_into(rr, lo, hi, self.annotations)
        self._q.put((wave, lo, hi, np.asarray(rr.selected[lo:hi]).copy()))

    def finish(self) -> tuple[int, None]:
        """Replay drained: commit the remaining chunks, settle reflects,
        surface worker errors.  -> (#bound, None)."""
        replay_end = time.perf_counter()
        self._q.put(None)
        with TRACER.span("commit_and_reflect", pods=len(self.pending)) as sp:
            self._thread.join()
            for w in self._waves:
                w.seal()  # replay drained: deferred reads may decode
            if self._exc is None:
                self._reflects.drain()
        TRACER.observe("framework_extension_point_duration_seconds",
                       sp.seconds, extension_point="bind")
        overlap = sum(max(0.0, min(t1, replay_end) - t0)
                      for t0, t1 in self._busy if t0 < replay_end)
        TRACER.count("commit_stream_overlap_seconds", round(overlap, 6))
        TRACER.count("commit_stream_waves_total")
        if self._exc is not None:
            raise self._exc
        return self.n_bound, None

    def abort(self) -> None:
        """Replay failed: stop the worker without raising again.  Commits
        that already landed stand (like a mid-pass sequential failure);
        chunks still queued are DROPPED — _stop makes the worker's drain
        branch skip them, so an interrupt isn't serviced through the
        whole backlog and no binds land after the wave has failed."""
        self._stop = True
        self._q.put(None)
        self._thread.join()
        for w in self._waves:
            # landed commits stand; their handles point at chunks that
            # were fully delivered before the failure
            w.seal()
        try:
            self._reflects.drain()
        # abort() runs on a wave that ALREADY failed; the replay error
        # is what surfaces — a secondary reflect error must not mask it
        # kss-analyze: allow(swallowed-exception)
        except Exception:
            pass

    # ---------------------------------------------- worker-thread side

    def _run(self) -> None:
        with TRACER.session_scope(self._session):
            while True:
                item = self._q.get()
                if item is None:
                    return
                if self._exc is not None or self._stop:
                    continue  # keep draining so finish() never blocks
                try:
                    t0 = time.perf_counter()
                    wave, lo, hi, selected = item
                    with TRACER.span("commit_stream", parent=self.parent_span,
                                     lo=lo, hi=hi):
                        self._commit(wave, lo, hi, selected)
                    self._busy.append((t0, time.perf_counter()))
                except BaseException as e:  # noqa: BLE001 — finish() re-raises
                    self._exc = e

    def _put_result(self, wave, i: int, ns: str, name: str) -> None:
        """Deposit pod i's wave result: a lazy handle (tensor-backed,
        decoded on first read) or the pre-decoded blobs."""
        if wave is not None:
            self.engine.result_store.put_lazy(ns, name, wave, i)
        else:
            self.engine.result_store.put_decoded(ns, name,
                                                 self.annotations[i])

    def attribution(self) -> dict | None:
        """Finished per-plugin attribution for the final replay run, or
        None (eager mode / broken accumulator).  Call after finish()."""
        acc = getattr(self._waves[-1], "_attr_acc", None) if self._waves \
            else None
        return acc.finish() if acc is not None else None

    def _commit(self, wave, lo: int, hi: int, selected) -> None:
        if wave is not None:
            acc = getattr(wave, "_attr_acc", None)
            if acc is not None:
                # before the watermark check: re-delivered chunks still
                # count under the NEW run's accumulator (add_chunk never
                # raises — broken accumulators just stop tallying)
                acc.add_chunk(lo // wave.chunk)
        if hi <= self._upto:
            return  # width-tier re-delivery of an already-committed chunk
        if self.gang is not None:
            self._selected[lo:hi] = selected
            if self._pod_wave is not None:
                self._pod_wave[lo:hi] = [wave] * (hi - lo)
            cut = self._gang_cut(hi)
            if cut > self._upto:
                self._commit_gang_range(self._upto, cut)
                self._upto = cut
            return
        eng = self.engine
        names = self.node_names
        items: list[tuple[str, str, str | None]] = []
        uids: list[str | None] = []
        for i in range(max(lo, self._upto), hi):
            meta = self.pending[i].get("metadata") or {}
            ns, name = meta.get("namespace") or "default", meta.get("name", "")
            self._put_result(wave, i, ns, name)
            sel = int(selected[i - lo])
            items.append((ns, name, names[sel] if sel >= 0 else None))
            uids.append(meta.get("uid"))
        self.n_bound += eng._commit_pod_batch(items)
        for (ns, name, _node), uid in zip(items, uids):
            self._reflects.submit(ns, name, uid)
        self._upto = hi

    def _gang_cut(self, hi: int) -> int:
        """Largest commit boundary <= hi that splits no gang: when the
        pods on either side of hi share a group (gangs are contiguous
        in pending order), pull the cut back to the group's first
        index so the straddling gang commits whole with the next
        chunk."""
        gid = self.gang.gid
        if hi >= len(self.pending):
            return len(self.pending)
        g = int(gid[hi])
        if g >= 0 and gid[hi - 1] == g:
            return int(self.gang.start[g])
        return hi

    def _commit_gang_range(self, lo: int, hi: int) -> None:
        """Gang-atomic commit of pending[lo:hi) (every gang inside is
        whole): the vectorized quorum pass decides allow/park per
        group; admitted members bind in pod order (parked siblings
        released right after the group's last wave member), below-
        quorum members park instead of binding — the same ordering
        rules as the sequential post-pass, so the parity gate holds."""
        eng = self.engine
        gang = self.gang
        names = self.node_names
        admit, wait_mask = eng._gang_decide(gang, self._selected, lo, hi)
        items: list[tuple[str, str, str | None]] = []
        uids: list[str | None] = []
        for i in range(lo, hi):
            meta = self.pending[i].get("metadata") or {}
            ns, name = meta.get("namespace") or "default", meta.get("name", "")
            self._put_result(
                self._pod_wave[i] if self._pod_wave is not None else None,
                i, ns, name)
            sel = int(self._selected[i])
            g = int(gang.gid[i])
            parked = False
            if g >= 0 and sel >= 0:
                if admit[g]:
                    eng._gang_record_permit(gang, ns, name, g,
                                            waited=bool(wait_mask[i - lo]))
                else:
                    eng._gang_park(gang, self.pending[i], g, names[sel])
                    parked = True
            if not parked:
                items.append((ns, name, names[sel] if sel >= 0 else None))
                uids.append(meta.get("uid"))
            if g >= 0 and i == int(gang.last[g]) and admit[g]:
                for rec in eng._gang_take_parked(gang.keys[g]):
                    items.append((rec.ns, rec.name, rec.node))
                    uids.append(rec.uid)
        self.n_bound += eng._commit_pod_batch(items)
        for (ns, name, _node), uid in zip(items, uids):
            self._reflects.submit(ns, name, uid)


class SchedulerEngine:
    def __init__(self, store: ObjectStore, reflector: StoreReflector | None = None,
                 result_store: ResultStore | None = None,
                 plugin_config: PluginSetConfig | None = None,
                 chunk: int = 512, mesh=None, unroll: int = 2,
                 pipeline_commit: bool = True, device="cuda"):
        # every wave's compile, replay, stream and kernel runs here
        self.device = resolve_device(device)
        # optional parallel.mesh.Mesh with a "nodes" axis, on one card or
        # over cards (its first card the engine's device; over processes,
        # this process's card, every process running the engine alike over
        # a store of the same objects): every batched replay and stream
        # shards the node axis across it
        if mesh is not None:
            from ..parallel.mesh import Mesh

            if not isinstance(mesh, Mesh):
                raise TypeError(f"mesh: expected a parallel.mesh.Mesh, got "
                                f"{type(mesh).__name__}")
            if mesh.device != self.device:
                raise ValueError(f"mesh on {mesh.device}, engine on {self.device}")
        self.mesh = mesh
        self.store = store
        # chunk-pipelined commit (docs/wave-pipeline.md): commit each
        # decoded chunk on a worker thread while the device scans later
        # chunks.  False forces the sequential post-pass on every wave
        # (the parity baseline, and the path the conflict-retry tests pin)
        self.pipeline_commit = pipeline_commit
        # per-wave node count for the unschedulable condition message
        # (was a full deepcopy store.list per unschedulable pod)
        self._wave_node_count: int | None = None
        self._pending_idx = None
        self.result_store = result_store or ResultStore()
        self.reflector = reflector or StoreReflector(store)
        if RESULT_STORE_KEY not in self.reflector.result_stores:
            self.reflector.add_result_store(self.result_store, RESULT_STORE_KEY)
        self.plugin_config = plugin_config or PluginSetConfig()
        self.chunk = chunk
        del unroll  # the JAX package's scan unroll: the step kernel has none
        self.extender_service = None
        # plugin name -> PluginExtender (the reference's WithPluginExtenders
        # registry); a bare list is accepted as anonymous after_cycle
        # observers for backward compatibility
        self.plugin_extenders: dict | list = {}
        # the host path's renormalization flushes: one launch of B10
        # renormalize_rows each on the card (_hooked_score_phase)
        self.renormalize_flushes = 0
        self.profiles: dict[str, PluginSetConfig] | None = None
        # pods parked by Permit "wait" (upstream waitingPods map analogue),
        # keyed (namespace, name); external threads may allow()/reject()
        self.waiting_pods: dict[tuple[str, str], "WaitingPod"] = {}
        # gang scheduling (docs/gang-scheduling.md): members parked by
        # the vectorized quorum pass, keyed (ns, name); each also holds
        # a WaitingPod handle in waiting_pods so pending_pods skips it.
        # Resolution is quorum completion (a later wave binds the gang
        # at the assumed nodes), scheduleTimeoutSeconds expiry (the
        # whole gang rejects), or a PodGroup update (reconciled at the
        # next schedule_pending)
        self.gang_parked: dict[tuple[str, str], _GangParked] = {}
        self._gang_wave: _GangCtx | None = None  # vectorized-mode wave ctx
        self._gang_dir = None                    # per-wave GangDirectory
        self._gang_seq = 0                       # park FIFO order
        # async waiter bookkeeping: one daemon thread per parked pod
        # finishes its binding cycle on resolution (upstream's binding
        # cycle goroutine blocking in WaitOnPermit)
        import threading

        self._wait_threads: list = []
        self._waiter_lock = threading.Lock()
        self._waiter_results: list[tuple[str, str, str]] = []
        # injectable for tests (forced-conflict soak asserts the backoff
        # schedule without waiting out real 100ms x 3^n sleeps)
        self._retry_sleep = time.sleep
        # wave failure protocol (docs/fault-injection.md): the engine's
        # own degradation-ladder level ON TOP of the env floor
        # (KSS_TPU_HOST_RESIDENT/KSS_TPU_EAGER_DECODE) — 0 device,
        # 1 host, 2 eager — and the consecutive-good-waves counter
        # driving probe-based recovery back up the ladder
        self._residency = 0
        self._resid_ok_waves = 0
        # multi-session serving (server/sessions.py): the owning
        # session's id, or None for direct engine use.  schedule_pending
        # and the engine's worker threads enter this session's tracer
        # scope, so every span/counter the wave records carries the
        # session label and the device-result budget attributes retained
        # chunks to the right per-session share
        self.session: str | None = None

    def set_plugin_config(self, cfg: PluginSetConfig) -> None:
        """Legacy single-profile API: one plugin set for every pod.
        Clears any profile routing so the new config actually takes
        effect (set_profiles is the multi-profile entry)."""
        self.plugin_config = PluginSetConfig(
            enabled=list(cfg.enabled), weights=dict(cfg.weights),
            custom=dict(cfg.custom), args=copy.deepcopy(cfg.args),
            point_enabled={k: list(v) for k, v in cfg.point_enabled.items()},
            point_disabled={k: set(v) for k, v in cfg.point_disabled.items()},
        )
        self.profiles = None

    def set_profiles(self, profiles: dict[str, PluginSetConfig] | None) -> None:
        """Multi-profile routing: one PluginSetConfig per schedulerName,
        config order preserved (upstream builds one framework per profile,
        scheduler.go:141-173).  None disables routing — every pending pod
        is scheduled with plugin_config (direct-engine / test use)."""
        if profiles:
            self.profiles = {
                n: PluginSetConfig(
                    enabled=list(c.enabled), weights=dict(c.weights),
                    custom=dict(c.custom), args=copy.deepcopy(c.args),
                    point_enabled={k: list(v)
                                   for k, v in c.point_enabled.items()},
                    point_disabled={k: set(v)
                                    for k, v in c.point_disabled.items()})
                for n, c in profiles.items()
            }
            # keep the legacy single-profile accessor pointing at the first
            self.plugin_config = next(iter(self.profiles.values()))
        else:
            self.profiles = None

    def set_extenders(self, extender_service) -> None:
        """Configure webhook extenders; scheduling switches to the phased
        (host-interleaved) path while any are present."""
        self.extender_service = extender_service
        if extender_service is not None:
            self.reflector.add_result_store(extender_service.result_store, EXTENDER_STORE_KEY)
        else:
            self.reflector.result_stores.pop(EXTENDER_STORE_KEY, None)

    # ------------------------------------------------------------ hooks

    def _extenders_map(self) -> dict:
        pe = self.plugin_extenders
        if isinstance(pe, dict):
            return pe
        return {f"_observer{i}": e for i, e in enumerate(pe or [])}

    def _cycle_hooks(self) -> dict:
        """Extenders whose plugin is enabled and that intercept the
        filter/score/normalize points — these force the host path."""
        from ..scheduler.debuggable import intercepts_cycle

        enabled = set(self.plugin_config.enabled)
        return {
            name: ext for name, ext in self._extenders_map().items()
            if name in enabled and intercepts_cycle(ext)
        }

    def _needs_host_path(self) -> bool:
        if self.extender_service is not None and self.extender_service.extenders:
            return True
        cfg = self.plugin_config
        for name in cfg.enabled:
            if cfg.is_custom(name) and getattr(cfg.custom[name], "has_normalize", False):
                return True
        return bool(self._cycle_hooks())

    # ------------------------------------------------------------ run

    def _drain_waiters(self) -> tuple[int, set[tuple[str, str]]]:
        """Join all Permit waiter threads; -> (#bound, rejected keys)."""
        while True:
            with self._waiter_lock:
                threads, self._wait_threads = self._wait_threads, []
            if not threads:
                break
            for t in threads:
                t.join()
        with self._waiter_lock:
            results, self._waiter_results = self._waiter_results, []
        bound = sum(1 for kind, _, _ in results if kind == "bound")
        rejected = {(ns, name) for kind, ns, name in results if kind == "rejected"}
        return bound, rejected

    def _list_shared(self, resource: str) -> list[dict]:
        """Read-only listing without per-object deep copies (the store's
        informer-cache contract); falls back for stores without the fast
        path (e.g. the remote HTTP cluster client)."""
        from ..cluster.store import list_shared

        return list_shared(self.store, resource)

    def pending_pods(self) -> list[dict]:
        """Unscheduled pods in queue order: a custom QueueSort plugin's
        less() when one is enabled (upstream allows exactly one,
        wrappedplugin.go:754-771), else PrioritySort.

        PrioritySort order comes from the incremental pending index when
        the store supports it (framework/pending.py: O(events) per wave
        instead of re-listing and re-sorting every pod); a custom
        QueueSort or an index-less store (the remote HTTP client) takes
        the legacy list+sort path.

        Returns SHARED store manifests (the informer-cache contract) —
        callers must not mutate them; take a deepcopy before handing one
        to anything that might."""
        qs = self._queue_sort_plugin()
        if qs is None:
            idx = self._pending_index()
            if idx is not None:
                if not self.waiting_pods:
                    return idx.pending()
                waiting = self.waiting_pods
                from .pending import _key

                return [p for p in idx.pending() if _key(p) not in waiting]
        elif self._pending_idx is not None:
            # a custom QueueSort bypasses the index permanently: drop the
            # subscription so every store write stops paying the fan-out
            # tax into a queue nothing will ever drain
            self._pending_idx.close()
            self._pending_idx = None
        pods = self._list_shared("pods")
        unbound = [
            p for p in pods if not ((p.get("spec") or {}).get("nodeName"))
        ]
        if qs is not None:
            pending = [
                p for p in unbound
                if ((p.get("metadata") or {}).get("namespace") or "default",
                    (p.get("metadata") or {}).get("name", ""))
                not in self.waiting_pods
            ]
            pending.sort(key=functools.cmp_to_key(
                lambda a, b: -1 if qs.less(a, b) else (1 if qs.less(b, a) else 0)))
            return pending
        # PrioritySort with gang-contiguous grouping: the SAME composite
        # key the incremental index orders by, so the two paths cannot
        # drift (group min keys count parked members, hence the
        # unfiltered unbound list)
        from .pending import gang_sorted

        return gang_sorted(unbound, skip=self.waiting_pods)

    def close(self) -> None:
        """Release engine-held resources: the pending index's watch
        subscription and the reflect pool.  Engines are long-lived in
        the simulator (the service reconfigures in place), but an
        application that discards an engine while its store lives on
        must call this — otherwise every subsequent store write keeps
        feeding the orphaned index queue.  The engine lazily re-creates
        both if used again."""
        if self._pending_idx is not None:
            self._pending_idx.close()
            self._pending_idx = None
        pool = getattr(self, "_reflect_pool", None)
        if pool is not None:
            pool.shutdown(wait=True)
            self._reflect_pool = None

    def _pending_index(self):
        """Lazily built PendingPodIndex, or None when the store has no
        atomic list_and_watch surface (remote HTTP client)."""
        idx = self._pending_idx
        if idx is None:
            if not hasattr(self.store, "list_and_watch"):
                return None
            from .pending import PendingPodIndex

            idx = PendingPodIndex(self.store)
            self._pending_idx = idx
        return idx

    def _queue_sort_plugin(self):
        """The enabled custom QueueSort plugin, if any.  Upstream allows
        exactly one QueueSort across ALL profiles (the scheduler refuses
        to start otherwise) — a config with two distinct queue-sort
        plugins is rejected here the same way."""
        cfgs = ([self.plugin_config] if not self.profiles
                else list(self.profiles.values()))
        found: dict[str, object] = {}
        for cfg in cfgs:
            for name in cfg.enabled:
                if cfg.is_custom(name):
                    p = cfg.custom[name]
                    if getattr(p, "has_queue_sort", False):
                        found[name] = p
        if len(found) > 1:
            raise ValueError(
                "only one QueueSort plugin can be enabled across profiles, "
                f"got {sorted(found)}")
        return next(iter(found.values()), None)

    def schedule_pending(self) -> int:
        """One scheduling wave over all pending pods (plus retry waves for
        pods unblocked by preemption, and re-runs after a custom
        Reserve/Permit/PreBind rejected a speculative placement). Returns
        #bound.  Runs under the owning session's tracer scope (self.session;
        a no-op for direct engine use).

        Pods parked by Permit "wait" do NOT stall the wave: their binding
        cycle finishes on a waiter thread when allowed/rejected/timed out
        (upstream runs binding cycles as goroutines), and this call drains
        all waiters before returning so the result is settled.

        Gang members parked by the vectorized quorum pass are the
        exception: they hold NO thread and survive across calls (their
        gang may complete in a later call's wave); expired ones are
        timeout-rejected — whole gangs at a time — at the top of every
        call (docs/gang-scheduling.md)."""
        # trace correlation (docs/metrics.md): the wave that drains the
        # submitted work claims the session's pending trace id (noted by
        # the server per workload-submitting request, consume-once) so
        # every span/event below — wave, speculative rounds, fused
        # dispatch — carries the id of the HTTP request that caused it.
        # trace_scope(None) is a no-op, so direct engine use under an
        # explicit caller-provided trace scope is left untouched.
        with TRACER.session_scope(self.session), \
                TRACER.trace_scope(TRACER.claim_session_trace(self.session)):
            return self._schedule_pending_scoped()

    def _schedule_pending_scoped(self) -> int:
        n_bound = self._gang_maintain()
        if n_bound:
            TRACER.count("pods_scheduled_total", n_bound)
        rejected: set[tuple[str, str]] = set()
        max_waves = 8 + len(self.pending_pods())
        for _ in range(max_waves):
            bound, retry = self._schedule_wave(exclude=rejected)
            n_bound += bound
            TRACER.count("pods_scheduled_total", bound)
            TRACER.count("scheduling_waves_total")
            if retry == "preempted":
                TRACER.count("preemption_waves_total")
            # drain Permit waiters after EVERY wave (not just the last):
            # a retry wave must never observe a half-resolved waiter —
            # pending_pods would re-schedule a pod whose waiter thread is
            # mid-bind
            waiter_bound, waiter_rejected = self._drain_waiters()
            n_bound += waiter_bound
            TRACER.count("pods_scheduled_total", waiter_bound)
            if waiter_rejected:
                # like a sync lifecycle rejection: re-run without them
                # (they keep their recorded rejection; upstream would
                # re-queue, which the next schedule_pending call does)
                rejected |= waiter_rejected
                continue
            if not retry:
                break
        # count unschedulable once per pass, not per retry wave (pods
        # routed to no profile are not ours to count)
        TRACER.count("pods_unschedulable_total", len([
            p for p in self.pending_pods() if self._profile_of(p) is not None
        ]))
        return n_bound

    def _profile_of(self, pod: dict) -> str | None:
        """Route a pod to a profile by spec.schedulerName (upstream
        frameworkForPod).  An unset name maps to "default-scheduler", or
        to the first profile when no profile carries that name; an
        explicit name matching no profile returns None — the pod is left
        alone, exactly as a cluster whose schedulers don't include that
        name would."""
        name = (pod.get("spec") or {}).get("schedulerName")
        if self.profiles is None:
            return "*"
        if name is None:
            if DEFAULT_SCHEDULER_NAME in self.profiles:
                return DEFAULT_SCHEDULER_NAME
            return next(iter(self.profiles))
        return name if name in self.profiles else None

    def _schedule_wave(self, exclude: set[tuple[str, str]] | None = None
                       ) -> tuple[int, str | None]:
        """One scheduling wave: each profile schedules its own pods in
        config order (binds from earlier profiles are visible to later
        ones through the store). Returns (#bound, retry reason or None)."""
        if self.profiles is None:
            return self._profile_wave(self.pending_pods(), exclude)
        # preserve GLOBAL queue order across profiles (upstream pops one
        # shared activeQ): batch maximal runs of consecutive same-profile
        # pods so a high-priority pod of profile B is never beaten to
        # capacity by a lower-priority pod of profile A
        runs: list[tuple[str, list[dict]]] = []
        for p in self.pending_pods():
            pname = self._profile_of(p)
            if pname is None:
                continue
            if runs and runs[-1][0] == pname:
                runs[-1][1].append(p)
            else:
                runs.append((pname, [p]))
        total, retry = 0, None
        for pname, mine in runs:
            saved = self.plugin_config
            self.plugin_config = self.profiles[pname]
            try:
                bound, r = self._profile_wave(mine, exclude)
            finally:
                self.plugin_config = saved
            total += bound
            retry = retry or r
        return total, retry

    def _profile_wave(self, pending: list[dict],
                      exclude: set[tuple[str, str]] | None = None
                      ) -> tuple[int, str | None]:
        """Timed shell around _profile_wave_run: feeds the upstream-named
        scheduling_attempt_duration_seconds histogram — wave wall
        amortized per pod (the batched paths have no per-pod attempt
        clock), result=scheduled for bound pods, unschedulable for the
        rest of the wave (an approximation: parked gang members and
        gated pods count as unschedulable until they resolve)."""
        t0 = time.perf_counter()
        bound, retry = self._profile_wave_run(pending, exclude)
        n = len(pending)
        if n:
            # per-session SLO window (rolling p50/p99 wave latency +
            # cycles/s): one deque append, read by /api/v1/sessions and
            # /readyz (utils/blackbox.py, docs/metrics.md)
            from ..utils.blackbox import SLO

            SLO.observe_wave(self.session, time.perf_counter() - t0, n)
            per = (time.perf_counter() - t0) / n
            if bound:
                TRACER.observe("scheduling_attempt_duration_seconds", per,
                               n=bound, result="scheduled")
            if n > bound:
                TRACER.observe("scheduling_attempt_duration_seconds", per,
                               n=n - bound, result="unschedulable")
        return bound, retry

    # ------------------------------------------------ failure protocol

    @staticmethod
    def _env_int(name: str, default: int) -> int:
        from ..utils.env import env_int

        return env_int(name, default)

    @staticmethod
    def _env_residency_floor() -> int:
        """The ladder level the environment pins as a floor: the engine
        may degrade BELOW it but never recovers above it."""
        if os.environ.get("KSS_TPU_EAGER_DECODE") == "1":
            return 2
        if os.environ.get("KSS_TPU_HOST_RESIDENT") == "1":
            return 1
        return 0

    def _effective_residency(self) -> int:
        return max(self._env_residency_floor(), self._residency)

    def result_mode(self) -> str:
        """The wave's current result-residency rung (device_resident /
        host_resident / eager_decode) — surfaced per session on
        /api/v1/sessions and /readyz (docs/fault-injection.md)."""
        return _RESIDENCY_MODES[self._effective_residency()]

    def _degrade(self, seam: str) -> bool:
        """Step one rung down the ladder after a structural device
        fault.  False when already at the bottom (eager decode has no
        device dependency left to shed)."""
        cur = self._effective_residency()
        if cur >= len(_RESIDENCY_MODES) - 1:
            return False
        self._residency = cur + 1
        self._resid_ok_waves = 0
        TRACER.inc("wave_faults_total", seam=seam, action="degraded")
        TRACER.inc("wave_degradations_total",
                   **{"from": _RESIDENCY_MODES[cur],
                      "to": _RESIDENCY_MODES[cur + 1]})
        from ..utils.blackbox import BLACKBOX

        BLACKBOX.record("degrade", seam=seam,
                        from_mode=_RESIDENCY_MODES[cur],
                        to_mode=_RESIDENCY_MODES[cur + 1])
        # a degradation is a structural event worth a post-mortem even
        # though the wave survives: snapshot the ring (in memory; wave
        # ABORTS additionally write to KSS_TPU_BLACKBOX_DIR)
        BLACKBOX.dump("degradation", session=self.session)
        return True

    def _wave_recovered_ok(self) -> None:
        """Probe-based recovery: after KSS_TPU_DEGRADE_PROBE_WAVES
        consecutive clean waves at a degraded rung, step back UP one
        level (never above the env floor).  The next wave is the probe:
        if it faults structurally again, _degrade steps straight back
        down and the counter restarts."""
        if self._residency <= 0:
            return
        floor = self._env_residency_floor()
        cur = self._effective_residency()
        if cur <= floor:
            self._residency = 0  # env already enforces this rung
            return
        self._resid_ok_waves += 1
        if self._resid_ok_waves < self._env_int(
                "KSS_TPU_DEGRADE_PROBE_WAVES", 8):
            return
        self._resid_ok_waves = 0
        new = max(cur - 1, floor)
        self._residency = 0 if new <= floor else new
        TRACER.inc("wave_degradations_total",
                   **{"from": _RESIDENCY_MODES[cur],
                      "to": _RESIDENCY_MODES[new]})
        from ..utils.blackbox import BLACKBOX

        BLACKBOX.record("recover", from_mode=_RESIDENCY_MODES[cur],
                        to_mode=_RESIDENCY_MODES[new])

    def _profile_wave_run(self, pending: list[dict],
                          exclude: set[tuple[str, str]] | None = None
                          ) -> tuple[int, str | None]:
        """The wave failure protocol (docs/fault-injection.md) around
        _profile_wave_attempt: classify a mid-wave fault and

          * transient  — retry the UNCOMMITTED SUFFIX with bounded
            backoff (KSS_TPU_WAVE_MAX_RETRIES, default 3): committed
            chunks stand (their binds/parks landed through the gang-cut
            watermark, so gang atomicity holds at the boundary), the
            suffix recompiles against current store state — the same
            recompile-with-upstream-state mechanism the "rejected"
            retry path already parity-proves — and bind order stays
            deterministic;
          * structural — step the residency ladder down one rung
            (device -> host -> eager; all bit-identical parity gates)
            and re-run, with probe-based recovery stepping back up
            after consecutive clean waves;
          * fatal      — surface immediately (interrupts, exhausted
            bounded retries, quarantined compiles).

        With no fault the attempt's result passes straight through —
        the try block is the only overhead on the happy path."""
        from ..utils.blackbox import BLACKBOX
        from ..utils.faults import classify_fault
        from .replay import materialize_failure_streak, reset_materialize_failures

        # black-box wave marker: records the event AND pins the counter
        # baseline this wave's post-mortem computes deltas against
        BLACKBOX.wave_start(self.session, pods=len(pending),
                            mode=self.result_mode())
        if (self._effective_residency() == 0
                and materialize_failure_streak(self.session)
                >= self._env_int("KSS_TPU_MATERIALIZE_FAIL_LIMIT", 3)):
            # repeated on-demand D2H failures are a structural device
            # signal even though they surface on the READ path: step to
            # host-resident fetch so new waves stop pinning chunks that
            # cannot come back across.  The streak is per-session: a
            # neighbor's flaky reads never degrade THIS engine
            if self._degrade("replay.materialize"):
                reset_materialize_failures(self.session)
        bound = 0
        retries_left = self._env_int("KSS_TPU_WAVE_MAX_RETRIES", 3)
        delay = 0.02
        while True:
            try:
                b, retry = self._profile_wave_attempt(pending, exclude)
            except _WaveAbort as ab:
                bound += ab.n_bound
                pending = ab.remaining
                cause = ab.cause
                seam = getattr(cause, "seam", None) or ab.stage
                kind = classify_fault(cause)
                BLACKBOX.record("wave.fault", stage=ab.stage, seam=seam,
                                error=type(cause).__name__,
                                classification=kind, bound=ab.n_bound,
                                remaining=len(pending))
                if kind == "structural":
                    if self._degrade(seam):
                        continue
                    TRACER.inc("wave_faults_total", seam=seam,
                               action="aborted")
                    BLACKBOX.record("wave.abort", seam=seam,
                                    action="aborted")
                    BLACKBOX.dump("wave_abort", cause=cause,
                                  session=self.session, write=True)
                    raise cause
                if kind == "transient" and retries_left > 0:
                    # retry even with an EMPTY suffix: every pod already
                    # committed, so the fault hit post-commit work (e.g.
                    # a reflect drain — its records stay queued and land
                    # on the next read/reflect); the empty re-attempt
                    # settles immediately and the wave returns its bind
                    # count instead of crashing a fully-committed wave
                    retries_left -= 1
                    TRACER.count("wave_retries_total")
                    TRACER.inc("wave_faults_total", seam=seam,
                               action="retried")
                    BLACKBOX.record("wave.retry", seam=seam,
                                    remaining=len(pending),
                                    retries_left=retries_left)
                    self._retry_sleep(delay)
                    delay = min(delay * 5, 1.0)
                    continue
                TRACER.inc("wave_faults_total", seam=seam, action="aborted")
                BLACKBOX.record("wave.abort", seam=seam, action="aborted")
                # a failed wave ships its own evidence: the bundle is
                # auto-written to KSS_TPU_BLACKBOX_DIR when set
                # (docs/fault-injection.md)
                BLACKBOX.dump("wave_abort", cause=cause,
                              session=self.session, write=True)
                raise cause
            self._wave_recovered_ok()
            BLACKBOX.record("wave.end", bound=bound + b,
                            retry=retry or None)
            return bound + b, retry

    def _guarded_replay(self, stage: str, pending: list, fn):
        """Run one replay under the failure protocol's classification:
        nothing was committed yet on these paths (the sequential/
        speculative commits happen in _finish_wave AFTER the replay
        drains), so a fault retries the whole FILTERED pending list —
        retrying the filtered list (not the caller's raw one) keeps
        gate marks and gang-prescreen rejections single-shot."""
        try:
            return fn()
        except BaseException as e:
            raise _WaveAbort(e, pending, 0, stage) from e

    def _profile_wave_attempt(self, pending: list[dict],
                              exclude: set[tuple[str, str]] | None = None
                              ) -> tuple[int, str | None]:
        """One wave over the given pending pods with the current
        plugin_config. Returns (#bound, retry reason or None).

        retry == "preempted": preemption nominated a node, run a retry wave.
        retry == "rejected": a custom Reserve/Permit/PreBind rejected a pod
        AFTER the device replay speculatively folded it into the carry —
        the rest of the wave is re-run with upstream-sequential state (the
        rejected pod excluded), so later pods never observe the phantom
        bind (upstream scheduleOne semantics)."""
        if exclude:
            pending = [
                p for p in pending
                if ((p.get("metadata") or {}).get("namespace") or "default",
                    (p.get("metadata") or {}).get("name", "")) not in exclude
            ]
        if self.plugin_config.preenqueues():
            # SchedulingGates PreEnqueue: gated pods never enter the queue
            gated = [
                p for p in pending if (p.get("spec") or {}).get("schedulingGates")
            ]
            for p in gated:
                meta = p.get("metadata") or {}
                self._mark_gated(meta.get("namespace") or "default", meta.get("name", ""))
            if gated:
                pending = [
                    p for p in pending
                    if not (p.get("spec") or {}).get("schedulingGates")
                ]
        if not pending:
            return 0, None
        nodes = self._list_shared("nodes")
        self._wave_node_count = len(nodes)
        pods_all = self._list_shared("pods")
        self._gang_wave = None
        gp = self._gang_plugin()
        gang_dir = None
        if gp is not None:
            pending, gang_dir = self._gang_prescreen(pending, gp, pods_all,
                                                     nodes)
            if not pending:
                return 0, None
        bound = [
            (p, p["spec"]["nodeName"]) for p in pods_all
            if (p.get("spec") or {}).get("nodeName")
        ]
        if self.gang_parked:
            # parked gang members keep their speculative assignments as
            # assumed binds: their resources stay reserved while the
            # gang waits for quorum (docs/gang-scheduling.md)
            bound += self._gang_assumed_bound()
        # volume manifests for the VolumeBinding/Zone/Restrictions/Limits
        # family; CSINode is not one of the simulator's 7 synced GVRs
        # (reference: recorder/recorder.go:45-53), so limits come only from
        # callers using compile_workload directly
        volumes = {
            "pvcs": self._list_shared("persistentvolumeclaims"),
            "pvs": self._list_shared("persistentvolumes"),
            "storageclasses": self._list_shared("storageclasses"),
        }
        with TRACER.span("compile_workload", pods=len(pending), nodes=len(nodes)):
            cw = compile_workload(
                nodes, pending, self.plugin_config, bound_pods=bound,
                volumes=volumes, reuse=getattr(self, "_last_cw", None),
                namespaces=self._list_shared("namespaces"),
                # columnar pod view (when the store lists columnar):
                # request rows gather from pre-parsed bank columns
                pod_columns=getattr(pods_all, "columns", None),
                device=self.device,
            )
            self._last_cw = NodeTableReuse(cw)
        if self._needs_host_path():
            # gangs route through the per-pod Permit machinery here
            # (the Coscheduling plugin stays in the lifecycle set)
            return self._schedule_host_path(cw, pending)

        if gp is not None and self._gang_vectorized():
            # setting the wave ctx removes the gang plugin from the
            # custom-lifecycle set: the quorum pass below replaces its
            # per-pod Permit calls on both batched commit paths (the
            # falsy sentinel keeps gang-free waves on the plain code)
            ctx = (_GangCtx(gp.name, pending, gang_dir,
                            self._gang_parked_counts())
                   if gang_dir is not None else None)
            self._gang_wave = ctx if ctx else _GANG_NONE

        # a live cluster's node count need not divide the mesh's "nodes"
        # extent; shard only waves where it does and run the rest
        # unsharded (shard_workload would reject the shape) — the
        # speculative stream's dp batching tolerates mesh=None
        mesh = self.mesh
        if mesh is not None:
            from ..parallel.mesh import can_shard

            if not can_shard(cw.n_nodes, mesh):
                TRACER.count("mesh_fallback_indivisible_nodes_total")
                mesh = None

        from ..store.decode import decode_chunk_into

        if (os.environ.get("KSS_TPU_SPECULATIVE", "1") != "0"
                and self.extender_service is None
                and not self._custom_lifecycle_plugins()):
            # speculative multi-pod rounds are the DEFAULT wave whenever
            # the active plugin set admits exact batching — a single
            # device suffices.
            # KSS_TPU_SPECULATIVE=0 pins the sequential scan: the parity
            # baseline the golden suite diffs against.  The engine's
            # vectorized gang plugin is ignored by the eligibility check
            # (its PreFilter ran in the prescreen, admission happens in
            # the quorum pass at commit — it neither filters nor scores
            # on device)
            from ..parallel.speculative import speculation_ok

            ignore = (frozenset({gp.name})
                      if gp is not None and self._gang_wave is not None
                      else frozenset())
            if speculation_ok(self.plugin_config, have_manifests=True,
                              ignore=ignore):
                return self._speculative_wave(cw, mesh, pending, exclude,
                                              len(nodes), ignore)

        if self._custom_lifecycle_plugins():
            # a custom Reserve/Permit/PreBind can reject mid-wave and abort
            # the rest — decode per pod so an aborted wave wastes nothing.
            # host-resident: the lifecycle loop consumes every pod's
            # annotations in order, so deferring the D2H would just move
            # the whole transfer out of the scan-overlap window
            def _lc_replay():
                with TRACER.span("device_replay", pods=len(pending),
                                 nodes=len(nodes)) as sp:
                    rr = replay(
                        cw, chunk=min(self.chunk, max(len(pending), 1)),
                        device=self.device, mesh=mesh,
                        device_resident=False)
                return rr, sp.seconds

            rr, replay_seconds = self._guarded_replay(
                "device_replay", pending, _lc_replay)
            all_annotations = _LazyDecode(rr)
            self._record_attribution(rr, replay_seconds)
            return self._finish_wave(cw, rr, all_annotations, pending, exclude)

        if self._can_stream_commit():
            # chunk-pipelined commit (docs/wave-pipeline.md): a worker
            # thread runs the commit phase for each decoded chunk (result
            # -store puts, batched binds/unschedulable marks, reflect
            # submissions, pod order preserved) while the device scans
            # later chunks — instead of the whole wave idling through a
            # sequential post-pass after the replay drains.  In lazy
            # mode the worker consumes tensor-level decisions only and
            # the decode leaves the critical path entirely.
            committer = _WaveCommitter(self, cw.node_table.names, pending,
                                       gang=self._gang_wave,
                                       lazy=self._wave_lazy_ok())
            try:
                with TRACER.span("replay_and_decode_stream",
                                 pods=len(pending), nodes=len(nodes)) as sp:
                    # the worker's commit_stream spans parent under the
                    # wave's replay span across the thread boundary.
                    # Lazy waves keep results DEVICE-resident: on_chunk
                    # is a handoff, the commit consumes decision rows
                    # only, and the heavy tensors never cross in-wave
                    # (unless the degradation ladder stepped to host)
                    committer.parent_span = sp.id
                    rr = replay(cw, chunk=min(self.chunk, max(len(pending), 1)),
                                device=self.device, mesh=mesh,
                                on_chunk=committer.on_chunk,
                                device_resident=(
                                    committer.lazy
                                    and self._effective_residency() == 0))
            except BaseException as e:
                # abort BEFORE reading the watermark: committed chunks
                # stand (binds/parks through the last gang-cut), queued
                # chunks drop — then hand the failure protocol the
                # settled commit boundary so only the suffix retries
                committer.abort()
                raise _WaveAbort(e, pending[committer._upto:],
                                 committer.n_bound, "replay_stream") from e
            try:
                result = committer.finish()
            except BaseException as e:
                raise _WaveAbort(e, pending[committer._upto:],
                                 committer.n_bound, "commit_stream") from e
            self._record_attribution(rr, sp.seconds,
                                     att=committer.attribution())
            return result

        if self._wave_lazy_ok():
            # sequential post-pass, lazy: the replay streams only the
            # per-pod decision rows (device-resident results — no heavy
            # tensor D2H, no on_chunk decode); the commit below deposits
            # LazyWave handles and defers the reflect — first read
            # materializes D2H + decode (store/lazy.py)
            from ..store.lazy import LazyWave

            def _lazy_replay():
                with TRACER.span("replay_and_decode_stream",
                                 pods=len(pending), nodes=len(nodes)) as sp:
                    rr = replay(
                        cw, chunk=min(self.chunk, max(len(pending), 1)),
                        device=self.device, mesh=mesh,
                        device_resident=self._effective_residency() == 0)
                return rr, sp.seconds

            rr, replay_seconds = self._guarded_replay(
                "replay_stream", pending, _lazy_replay)
            self._record_attribution(rr, replay_seconds)
            return self._finish_wave(
                cw, rr, None, pending, exclude,
                lazy_wave=LazyWave(rr, len(pending), sealed=True))

        # stream: each chunk decodes (chunk-granular native call, or the
        # host thread pool on the fallback ladder) as soon as its
        # transfer lands, overlapping the device's later chunks
        all_annotations = [None] * len(pending)

        def _eager_replay():
            with TRACER.span("replay_and_decode_stream", pods=len(pending),
                             nodes=len(nodes)) as sp:
                rr = replay(
                    cw, chunk=min(self.chunk, max(len(pending), 1)),
                    device=self.device, mesh=mesh,
                    on_chunk=lambda rr_, lo, hi: decode_chunk_into(
                        rr_, lo, hi, all_annotations))
            return rr, sp.seconds

        rr, replay_seconds = self._guarded_replay(
            "replay_stream", pending, _eager_replay)
        self._record_attribution(rr, replay_seconds)
        return self._finish_wave(cw, rr, all_annotations, pending, exclude)

    def _speculative_wave(self, cw, mesh, pending,
                          exclude: set[tuple[str, str]] | None,
                          n_nodes: int, ignore: frozenset = frozenset()
                          ) -> tuple[int, str | None]:
        """The engine's default wave (docs/wave-pipeline.md
        speculative-wave stage): vmapped rounds of B queued pods against
        the frozen carry, a conflict oracle accepting the provably
        non-interfering prefix, accepted results streamed to the commit
        worker on the standard chunk grid — so lazy decode, device
        residency, the gang-cut watermark and the wave failure
        protocol's uncommitted-suffix retry all compose unchanged.  A
        contention collapse hands the wave's remainder to the
        sequential chunked scan in-stream (parallel/speculative.py)."""
        from ..parallel.speculative import replay_speculative_stream
        from ..store.decode import decode_chunk_into

        namespaces = self._list_shared("namespaces")
        gang = self._gang_wave if self._gang_wave else None
        chunk = min(self.chunk, max(len(pending), 1))
        if self._can_stream_commit():
            committer = _WaveCommitter(self, cw.node_table.names, pending,
                                       gang=gang, lazy=self._wave_lazy_ok())
            try:
                with TRACER.span("replay_and_decode_stream",
                                 pods=len(pending), nodes=n_nodes,
                                 mode="speculative") as sp:
                    committer.parent_span = sp.id
                    rr, _stats = replay_speculative_stream(
                        cw, mesh, chunk=chunk, device=self.device,
                        pods=pending, namespaces=namespaces,
                        on_chunk=committer.on_chunk,
                        device_resident=(
                            committer.lazy
                            and self._effective_residency() == 0),
                        gang=gang, ignore=ignore)
            except BaseException as e:
                # abort BEFORE reading the watermark: committed chunks
                # stand, queued chunks drop — then hand the failure
                # protocol the settled commit boundary so only the
                # suffix retries (same shape as the scan stream)
                committer.abort()
                raise _WaveAbort(e, pending[committer._upto:],
                                 committer.n_bound,
                                 "speculative_replay") from e
            try:
                result = committer.finish()
            except BaseException as e:
                raise _WaveAbort(e, pending[committer._upto:],
                                 committer.n_bound, "commit_stream") from e
            self._record_attribution(rr, sp.seconds,
                                     att=committer.attribution())
            return result
        # sequential-commit shell (pipeline_commit=False, postfilter
        # preemption, plugin-extender observers): run the stream without
        # the worker, commit through the shared post-pass.  Eager waves
        # decode chunk-by-chunk DURING the stream — the pooled chunk
        # decoder overlapped with later rounds — never one whole-wave
        # decode_chunk_into(0, P) call on the commit thread
        lazy = self._wave_lazy_ok()
        all_annotations = None
        on_chunk = None
        if not lazy:
            all_annotations = [None] * len(pending)

            def on_chunk(rr_, lo, hi):
                decode_chunk_into(rr_, lo, hi, all_annotations)

        def _spec_replay():
            with TRACER.span("replay_and_decode_stream", pods=len(pending),
                             nodes=n_nodes, mode="speculative") as sp:
                rr, _stats = replay_speculative_stream(
                    cw, mesh, chunk=chunk, device=self.device,
                    pods=pending, namespaces=namespaces, on_chunk=on_chunk,
                    device_resident=(lazy
                                     and self._effective_residency() == 0),
                    gang=gang, ignore=ignore)
            return rr, sp.seconds

        rr, spec_seconds = self._guarded_replay(
            "speculative_replay", pending, _spec_replay)
        self._record_attribution(rr, spec_seconds)
        if lazy:
            from ..store.lazy import LazyWave

            return self._finish_wave(
                cw, rr, None, pending, exclude,
                lazy_wave=LazyWave(rr, len(pending), sealed=True))
        return self._finish_wave(cw, rr, all_annotations, pending, exclude)

    def _wave_lazy_ok(self) -> bool:
        """True when this wave may defer annotation decode to first read
        (store/lazy.py): lazy is the default on the batched tensor paths
        — the commit consumes tensor-level decisions only, so decoding
        on the critical path buys nothing, and the heavy replay tensors
        stay DEVICE-resident until a cold read (framework/replay.py
        device-residency; KSS_TPU_HOST_RESIDENT=1 keeps lazy decode but
        fetches to host in-wave) — and turns off when

          * KSS_TPU_EAGER_DECODE=1 (the golden/parity baseline mode);
          * plugin-extender observers are registered (after_cycle sees
            each pod's decoded annotations during the wave);
          * the store/reflector pair cannot make deferred results
            transparent to readers (no read hooks / no batch surface —
            e.g. the remote HTTP cluster client).

        The host-interleaved and custom-lifecycle paths decode per pod
        regardless (their cycles consume annotations inline).  The
        degradation ladder's bottom rung (docs/fault-injection.md)
        forces eager decode the same way the env baseline does."""
        if os.environ.get("KSS_TPU_EAGER_DECODE") == "1":
            return False
        if self._effective_residency() >= 2:
            return False
        if self._extenders_map():
            return False
        return self.reflector.defer_supported() \
            if hasattr(self.reflector, "defer_supported") else False

    def _can_stream_commit(self) -> bool:
        """True when nothing in the configuration forces the sequential
        post-pass: no plugin-extender observers (after_cycle sees each
        pod's annotations in order), no custom lifecycle (Reserve/Permit/
        PreBind can reject and abort the wave), and no PostFilter
        (preemption mutates the store mid-commit and requests retry
        waves).  Extender webhooks already forced the host path before
        this point."""
        return (self.pipeline_commit
                and not self._extenders_map()
                and not self._custom_lifecycle_plugins()
                and not self.plugin_config.postfilters())

    def _record_attribution(self, rr, replay_seconds: float,
                            att: dict | None = None) -> None:
        """Per-plugin attribution from the replay tensors the wave
        already decoded (docs/metrics.md): labeled WORK counters (pods x
        nodes evaluated, first-fail filter rejects, raw score column
        sums over feasible nodes, prefilter screens) — fused device
        execution has no per-plugin wall clock — plus the upstream-named
        framework_extension_point / plugin_execution histograms with
        the replay span APPORTIONED across points and plugins by
        evaluated work (documented estimate; host-path plugins record
        real wall time instead).  Never fails a wave."""
        try:
            from .replay import plugin_attribution

            t0 = time.perf_counter()
            if att is None:
                # streaming lazy waves pass the worker-accumulated
                # tallies instead (ChunkAttribution); everything else
                # pays the whole-result pass here
                att = plugin_attribution(rr)
            if att is None:
                return
            work: dict[tuple[str, str], int] = {}
            for name, d in att["filter"].items():
                TRACER.inc("plugin_pods_nodes_evaluated_total", d["evaluated"],
                           plugin=name, extension_point="filter")
                TRACER.inc("plugin_filter_rejects_total", d["rejects"],
                           plugin=name)
                work[("filter", name)] = d["evaluated"]
            for name, d in att["score"].items():
                TRACER.inc("plugin_pods_nodes_evaluated_total", d["evaluated"],
                           plugin=name, extension_point="score")
                TRACER.inc("plugin_score_sum_total", d["sum"], plugin=name)
                work[("score", name)] = d["evaluated"]
            for name, d in att["prefilter"].items():
                TRACER.inc("plugin_pods_nodes_evaluated_total", d["evaluated"],
                           plugin=name, extension_point="prefilter")
                TRACER.inc("plugin_prefilter_screens_total", d["screened"],
                           plugin=name)
                work[("prefilter", name)] = d["evaluated"]
            total = sum(work.values())
            if replay_seconds > 0 and total > 0:
                points: dict[str, float] = {}
                for (point, name), w in work.items():
                    if w <= 0:
                        continue
                    share = replay_seconds * w / total
                    points[point] = points.get(point, 0.0) + share
                    TRACER.observe("plugin_execution_duration_seconds", share,
                                   plugin=name, extension_point=point,
                                   status="Success")
                for point, secs in points.items():
                    TRACER.observe(
                        "framework_extension_point_duration_seconds", secs,
                        extension_point=point)
            TRACER.count("wave_attribution_seconds",
                         round(time.perf_counter() - t0, 6))
        # kss-analyze: allow(swallowed-exception)
        except Exception:
            pass  # attribution is observability; waves never fail on it

    def _finish_wave(self, cw, rr, all_annotations, pending,
                     exclude: set[tuple[str, str]] | None,
                     lazy_wave=None) -> tuple[int, str | None]:
        """Commit + reflect phase of a wave, shared by the scan and
        speculative replay paths: result-store puts, extender hooks,
        custom lifecycle, binds, postfilter/preemption, write-backs.

        lazy_wave: a sealed LazyWave standing in for all_annotations —
        the commit deposits handles and routes write-backs through
        reflect_batch so they defer with the decode (store/lazy.py);
        callers pass it only when no hook/lifecycle consumer needs the
        decoded bytes during the wave."""
        postfilter_on = bool(self.plugin_config.postfilters())
        n_bound = 0
        retry: str | None = None
        # write-backs are independent per pod (upstream's reflector runs
        # on informer callbacks, async from scheduleOne): fan them over a
        # small pool — the native escape pass releases the GIL — and
        # settle before the wave returns.  Per-pod reflect (use_batch=
        # False) keeps this post-pass on its pre-change write mechanism;
        # lazy waves use the batch surface, whose deferral IS the point.
        reflects = _ReflectBatcher(self, len(pending),
                                   use_batch=lazy_wave is not None)

        emap = self._extenders_map()
        has_lc = bool(self._custom_lifecycle_plugins())
        gang = self._gang_wave if self._gang_wave else None
        gang_admit = gang_wait = None
        if gang is not None:
            # gang-atomic commit: one vectorized quorum pass over the
            # whole wave decides allow/park per group before any write
            gang_admit, gang_wait = self._gang_decide(
                gang, np.asarray(rr.selected, dtype=np.int32), 0,
                len(pending))
        with TRACER.span("commit_and_reflect", pods=len(pending)) as commit_sp:
            for i, pod in enumerate(pending):
                meta = pod.get("metadata") or {}
                ns, name = meta.get("namespace") or "default", meta.get("name", "")
                if lazy_wave is not None:
                    self.result_store.put_lazy(ns, name, lazy_wave, i)
                else:
                    annotations = all_annotations[i]
                    self.result_store.put_decoded(ns, name, annotations)
                # one private copy serves every third-party surface this
                # cycle (hooks and plugins must not reach shared manifests)
                priv = copy.deepcopy(pod) if emap or has_lc else pod
                if emap:
                    # extender observers force eager waves (_wave_lazy_ok)
                    for hook in emap.values():
                        hook.after_cycle(priv, annotations, self.result_store)
                sel = int(rr.selected[i])
                g = int(gang.gid[i]) if gang is not None else -1
                if g >= 0 and sel >= 0:
                    if gang_admit[g]:
                        self._gang_record_permit(gang, ns, name, g,
                                                 waited=bool(gang_wait[i]))
                    else:
                        # below quorum: the speculative assignment rolls
                        # back to waiting — no bind, no status write, no
                        # reflect until the gang resolves
                        self._gang_park(gang, pod, g,
                                        cw.node_table.names[sel])
                        continue
                if sel >= 0:
                    lc = self._run_custom_lifecycle(
                        priv, ns, name, cw.node_table.names[sel],
                        allow_async=True, private=True)
                    if lc == "deferred":
                        # Permit "wait" parked the pod; its waiter thread
                        # finishes the binding cycle + reflect.  The carry
                        # already holds the speculative bind — exactly the
                        # assumed-pod state upstream exposes while a pod
                        # waits in WaitOnPermit — so the wave continues
                        continue
                    if not lc:
                        # a custom Reserve/Permit/PreBind rejected, but the
                        # device replay already folded this pod into the
                        # carry; abandon the rest of the wave and re-run it
                        # without this pod so later pods see true (unbound)
                        # state
                        self._mark_unschedulable(ns, name)
                        reflects.drain()
                        self.reflector.reflect(ns, name, uid=meta.get("uid"))
                        if exclude is not None:
                            exclude.add((ns, name))
                        return n_bound, "rejected"
                    self._bind(ns, name, cw.node_table.names[sel])
                    self._run_custom_postbind(priv, cw.node_table.names[sel],
                                              private=True)
                    n_bound += 1
                else:
                    # PreFilter-rejected pods skip preemption: the static
                    # rejects are UnschedulableAndUnresolvable upstream, and
                    # ReadWriteOncePod preemption (preempting the PVC holder)
                    # is not modeled — documented divergence
                    if postfilter_on and int(rr.prefilter_reject[i]) == 0:
                        if self._run_postfilter(
                                cw, rr.codes_of(i), i, pod, ns, name):
                            retry = "preempted"
                    self._mark_unschedulable(ns, name)
                reflects.submit(ns, name, meta.get("uid"))
                if g >= 0 and i == int(gang.last[g]) and gang_admit[g]:
                    # the group's last wave member landed: release its
                    # parked members (earlier waves) at their assumed
                    # nodes, in park order — the same position the
                    # streaming committer releases them at
                    for rec in self._gang_take_parked(gang.keys[g]):
                        self._bind(rec.ns, rec.name, rec.node)
                        n_bound += 1
                        reflects.submit(rec.ns, rec.name, rec.uid)
            reflects.drain()
        TRACER.observe("framework_extension_point_duration_seconds",
                       commit_sp.seconds, extension_point="bind")
        return n_bound, retry

    def _reflector_pool(self):
        """Lazily created pool for the per-pod write-backs."""
        pool = getattr(self, "_reflect_pool", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            pool = ThreadPoolExecutor(max_workers=4,
                                      thread_name_prefix="reflect")
            self._reflect_pool = pool
        return pool

    def _custom_lifecycle_plugins(self) -> list:
        plugins = [
            p for n, p in self.plugin_config.custom.items()
            if n in self.plugin_config.enabled and getattr(p, "has_lifecycle", False)
        ]
        if self._gang_wave is not None:
            # the vectorized quorum pass replaces the gang plugin's
            # per-pod Permit calls for this wave (docs/gang-scheduling.md)
            plugins = [p for p in plugins
                       if not getattr(p, "is_gang_plugin", False)]
        return plugins

    # ------------------------------------------------------------ gangs

    def _gang_plugin(self):
        """The enabled gang-admission (Coscheduling) plugin, attached to
        this engine, or None."""
        cfg = self.plugin_config
        for n in cfg.enabled:
            if n in cfg.custom:
                p = cfg.custom[n]
                if getattr(p, "is_gang_plugin", False):
                    attach = getattr(p, "attach", None)
                    if attach is not None and getattr(p, "_engine", None) is not self:
                        attach(self)
                    return p
        return None

    def _gang_vectorized(self) -> bool:
        """True when gang admission can use the vectorized quorum pass:
        the gang plugin is the ONLY enabled custom lifecycle plugin and
        the queue keeps the default PrioritySort order.  Any other
        lifecycle plugin — or a custom QueueSort, whose arbitrary
        less() defeats the gang-contiguity invariant the pass and the
        streaming cuts rely on — routes gangs through the per-pod
        Permit machinery instead (fallback matrix in
        docs/gang-scheduling.md)."""
        cfg = self.plugin_config
        for n, p in cfg.custom.items():
            if (n in cfg.enabled and getattr(p, "has_lifecycle", False)
                    and not getattr(p, "is_gang_plugin", False)):
                return False
        try:
            return self._queue_sort_plugin() is None
        except ValueError:
            return False  # invalid multi-QueueSort config: stay safe

    def _gang_parked_counts(self) -> dict[tuple[str, str], int]:
        counts: dict[tuple[str, str], int] = {}
        for rec in self.gang_parked.values():
            counts[rec.group] = counts.get(rec.group, 0) + 1
        return counts

    def _gang_assumed_bound(self) -> list[tuple[dict, str]]:
        """Parked members' speculative assignments as assumed binds for
        compile_workload's bound_pods: their resources stay reserved
        while the gang waits for quorum — the upstream assumed-pod
        state a WaitOnPermit parker holds in the scheduler cache."""
        out: list[tuple[dict, str]] = []
        for (ns, name), rec in list(self.gang_parked.items()):
            try:
                pod = self.store.get("pods", name, ns, copy_object=False)
            # a parked pod deleted from the store stops reserving capacity
            # kss-analyze: allow(swallowed-exception)
            except NotFound:
                continue
            except TypeError:  # store without the no-copy fast path
                try:
                    pod = self.store.get("pods", name, ns)
                # kss-analyze: allow(swallowed-exception) — as above
                except NotFound:
                    continue
            out.append((pod, rec.node))
        return out

    def _gang_take_parked(self, group_key: tuple[str, str]) -> list[_GangParked]:
        """Pop every parked member of group_key in park (FIFO) order."""
        recs = [r for r in self.gang_parked.values() if r.group == group_key]
        recs.sort(key=lambda r: r.seq)
        for r in recs:
            self.gang_parked.pop((r.ns, r.name), None)
            self.waiting_pods.pop((r.ns, r.name), None)
        return recs

    def _gang_park(self, ctx: _GangCtx, pod: dict, g: int, node: str) -> None:
        """Roll a below-quorum member's speculative assignment back to
        waiting: permit-result "wait" is recorded (reflected at
        resolution), the pod parks in waiting_pods (so pending_pods
        skips it) and gang_parked keeps the assumed node + deadline.
        No store write happens until the gang resolves."""
        from .waiting import WaitingPod

        meta = pod.get("metadata") or {}
        ns, name = meta.get("namespace") or "default", meta.get("name", "")
        self.result_store.add_permit_result(
            ns, name, ctx.gp_name, ann.WAIT_MESSAGE, ctx.timeout_str[g])
        key = (ns, name)
        self.waiting_pods[key] = WaitingPod(pod, {ctx.gp_name: ctx.timeout_s[g]})
        self._gang_seq += 1
        self.gang_parked[key] = _GangParked(
            ns, name, meta.get("uid"), node, ctx.keys[g],
            deadline=time.monotonic() + ctx.timeout_s[g],
            timeout_str=ctx.timeout_str[g], seq=self._gang_seq)

    def _gang_record_permit(self, ctx: _GangCtx, ns: str, name: str, g: int,
                            waited: bool) -> None:
        """Permit record for an admitted member: "wait" (+ the group
        timeout) for members whose rank was below quorum when they
        reached Permit — the ones a group-wide allow() released —
        "success" for the quorum-completing member and every later one."""
        if waited:
            self.result_store.add_permit_result(
                ns, name, ctx.gp_name, ann.WAIT_MESSAGE, ctx.timeout_str[g])
        else:
            self.result_store.add_permit_result(
                ns, name, ctx.gp_name, ann.SUCCESS_MESSAGE, "0s")

    def _gang_decide(self, ctx: _GangCtx, selected, lo: int, hi: int):
        """The vectorized gang-quorum pass over pending[lo:hi) (gangs
        inside are whole): ONE launch of B8 (quorum_slice on the engine's
        device) computes per-group placed-member counts and the
        allow/park decision — no per-pod Python loop.  Returns (admit [G] bool, wait_mask [hi-lo] bool)
        and maintains the gang tracer counters."""
        from .gang import quorum_slice

        t0 = time.perf_counter()
        # child span: under commit_stream on the worker thread, under
        # commit_and_reflect on the sequential post-pass
        with TRACER.span("gang_quorum", pods=hi - lo, groups=len(ctx.keys)):
            admit, wave_counts, wait_mask = quorum_slice(
                ctx.gid[lo:hi], np.asarray(selected[lo:hi], dtype=np.int32),
                ctx.already, ctx.min_member, device=self.device)
        TRACER.count("gang_quorum_pass_seconds",
                     round(time.perf_counter() - t0, 6))
        for g in np.unique(ctx.gid[lo:hi]):
            g = int(g)
            if g < 0:
                continue
            if admit[g]:
                if not ctx.admitted_before[g] and g not in ctx.counted:
                    ctx.counted.add(g)
                    TRACER.count("gang_groups_admitted_total")
            elif int(wave_counts[g]) > 0:
                TRACER.count("gang_quorum_rollbacks_total")
        return admit, wait_mask

    def _gang_prescreen(self, pending: list[dict], gp, pods_all: list[dict],
                        nodes: list[dict]):
        """The Coscheduling PreFilter: reject members whose group can
        never reach quorum from current cluster state (fewer than
        minMember member pods exist, or minResources exceeds free
        cluster capacity) — recorded under prefilter-result-status like
        an in-tree PreFilter rejection, before the wave compiles.
        Returns (surviving pending, GangDirectory or None)."""
        from .gang import GangDirectory, group_key_of

        directory = GangDirectory(self.store)
        if not directory:
            return pending, None
        directory.scan_members(pods_all)
        free_cache: dict = {}

        def free_fn():
            if "v" not in free_cache:
                free_cache["v"] = self._cluster_free(nodes, pods_all)
            return free_cache["v"]

        keep: list[dict] = []
        for p in pending:
            key = group_key_of(p)
            msg = directory.prefilter_reason(key, free_fn) if key else None
            if msg is None:
                keep.append(p)
                continue
            meta = p.get("metadata") or {}
            ns, name = meta.get("namespace") or "default", meta.get("name", "")
            self.result_store.add_pre_filter_result(ns, name, gp.name, msg)
            self._mark_unschedulable(ns, name)
            self.reflector.reflect(ns, name, uid=meta.get("uid"))
        return keep, directory

    @staticmethod
    def _cluster_free(nodes: list[dict], pods_all: list[dict]) -> dict:
        """Cluster-wide free capacity (allocatable minus bound
        requests) for the minResources PreFilter check — a documented
        simplification of the upstream coscheduling quota check."""
        from ..utils.quantity import parse_cpu_milli, parse_memory_bytes

        cpu = mem = 0
        for n in nodes:
            alloc = (n.get("status") or {}).get("allocatable") or {}
            cpu += parse_cpu_milli(alloc.get("cpu") or 0)
            mem += parse_memory_bytes(alloc.get("memory") or 0)
        for p in pods_all:
            if not ((p.get("spec") or {}).get("nodeName")):
                continue
            for c in (p.get("spec") or {}).get("containers") or []:
                req = ((c.get("resources") or {}).get("requests")) or {}
                cpu -= parse_cpu_milli(req.get("cpu") or 0)
                mem -= parse_memory_bytes(req.get("memory") or 0)
        return {"cpu": cpu, "memory": mem}

    def _gang_maintain(self) -> int:
        """Cross-call gang housekeeping, run at the top of every
        schedule_pending: timeout expiry rejects whole gangs (the
        deterministic trigger member — earliest deadline, then
        (ns, name) — records "timeout", siblings record the gang
        rejection), then parked groups whose quorum is already
        satisfied by waiting+bound members alone (e.g. a PodGroup
        minMember update) bind at their assumed nodes, and parked
        members whose PodGroup vanished are released back to the
        queue as ordinary pods.  Returns #bound."""
        if not self.gang_parked:
            return 0
        gp = self._gang_plugin()
        pname = gp.name if gp is not None else "Coscheduling"
        now = time.monotonic()
        triggers: dict[tuple[str, str], _GangParked] = {}
        for rec in self.gang_parked.values():
            if rec.deadline <= now:
                cur = triggers.get(rec.group)
                if cur is None or ((rec.deadline, rec.ns, rec.name)
                                   < (cur.deadline, cur.ns, cur.name)):
                    triggers[rec.group] = rec
        for gkey in sorted(triggers):
            t = triggers[gkey]
            for rec in self._gang_take_parked(gkey):
                msg = ("timeout" if rec is t else
                       f'rejected: gang "{gkey[0]}/{gkey[1]}" timed out '
                       "before reaching quorum")
                self.result_store.add_permit_result(
                    rec.ns, rec.name, pname, msg, rec.timeout_str)
                self._mark_unschedulable(rec.ns, rec.name,
                                         fresh_node_count=True)
                self.reflector.reflect(rec.ns, rec.name, uid=rec.uid)
            TRACER.count("gang_timeout_rejects_total")
        bound = 0
        if self.gang_parked:
            from .gang import GangDirectory

            directory = GangDirectory(self.store)
            directory.scan_members(self._list_shared("pods"))
            parked_counts = self._gang_parked_counts()
            for gkey in sorted({r.group for r in self.gang_parked.values()}):
                spec = directory.specs.get(gkey)
                if spec is None:
                    # PodGroup deleted while members waited: release the
                    # park — the members reschedule as ordinary pods
                    for rec in self._gang_take_parked(gkey):
                        self.result_store.delete_data(
                            {"metadata": {"namespace": rec.ns,
                                          "name": rec.name}})
                    continue
                if (parked_counts.get(gkey, 0)
                        + directory.bound.get(gkey, 0)) >= spec.min_member:
                    for rec in self._gang_take_parked(gkey):
                        self._bind(rec.ns, rec.name, rec.node)
                        self.reflector.reflect(rec.ns, rec.name, uid=rec.uid)
                        bound += 1
        return bound

    @staticmethod
    def _observe_plugin(plugin: str, point: str, t0: float,
                        status: str) -> None:
        """Real per-plugin wall clock for host-path lifecycle calls —
        the time half of the attribution story (docs/metrics.md:
        device-fused plugins get work attribution instead)."""
        TRACER.observe("plugin_execution_duration_seconds",
                       time.perf_counter() - t0, plugin=plugin,
                       extension_point=point, status=status)

    def _run_custom_lifecycle(self, pod, ns: str, name: str, node_name: str,
                              allow_async: bool = False,
                              private: bool = False):
        """Reserve -> Permit -> PreBind -> (caller binds) -> PostBind for
        custom plugins, upstream phase ordering (all Reserves, then all
        Permits, then all PreBinds; Unreserve runs for ALL reserve plugins
        in reverse order on any failure — scheduleOne calls
        RunReservePluginsUnreserve unconditionally over the full list).
        Returns False when the pod must not bind.

        A Permit "wait" parks the pod in self.waiting_pods with the
        plugin's timeout (upstream waitingPods map); the plugin's optional
        on_waiting(handle) is invoked.  With allow_async (the batched wave
        path) the method returns "deferred" and a waiter thread finishes
        the binding cycle — PreBind, bind, PostBind, reflect — once every
        waiting plugin allowed, one rejected, or the timeout expired; the
        wave continues scheduling other pods meanwhile, like upstream's
        per-pod binding-cycle goroutines blocking in WaitOnPermit
        (reference: wrappedplugin.go:588-620 + upstream
        runtime/waiting_pods_map.go).  Without allow_async the call blocks
        until resolution (host-interleaved path)."""
        plugins = self._custom_lifecycle_plugins()
        if not plugins:
            return True
        if not private:
            # third-party plugin code must never see the store's shared
            # manifests — a mutating plugin would corrupt live cluster
            # state with no resourceVersion bump and no watch event
            pod = copy.deepcopy(pod)
        from .waiting import WaitingPod
        from ..scheduler.debuggable import has_hook
        from ..utils.duration import parse_duration_seconds

        emap = self._extenders_map()
        node = self._get_node(node_name)
        rs = self.result_store

        def unreserve_all() -> None:
            for q in reversed(plugins):
                if q.has_unreserve:
                    q.unreserve(pod, node)

        for p in plugins:
            if not p.has_reserve:
                continue
            ext = emap.get(p.name)
            if ext is not None and has_hook(ext, "before_reserve"):
                if ext.before_reserve(pod, node) is not None:
                    unreserve_all()  # plugin skipped, nothing recorded
                    return False
            t0 = time.perf_counter()
            msg = p.reserve(pod, node)
            self._observe_plugin(p.name, "reserve", t0,
                                 "Success" if not msg else "Unschedulable")
            rs.add_reserve_result(ns, name, p.name,
                                  msg if msg else ann.SUCCESS_MESSAGE)
            if ext is not None and has_hook(ext, "after_reserve"):
                msg = ext.after_reserve(pod, node, msg)  # framework outcome
            if msg:
                unreserve_all()
                return False
        waits: list[tuple] = []  # (plugin, timeout_str)
        for p in plugins:
            if not p.has_permit:
                continue
            ext = emap.get(p.name)
            if ext is not None and has_hook(ext, "before_permit"):
                if ext.before_permit(pod, node) is not None:
                    unreserve_all()
                    return False
            t0 = time.perf_counter()
            out = p.permit(pod, node)
            self._observe_plugin(
                p.name, "permit", t0,
                "Success" if out is None
                else ("Wait" if isinstance(out, tuple) else "Unschedulable"))
            if out is None:
                rs.add_permit_result(ns, name, p.name, ann.SUCCESS_MESSAGE, "0s")
            elif isinstance(out, tuple):
                rs.add_permit_result(ns, name, p.name, ann.WAIT_MESSAGE,
                                     str(out[1]))
            else:
                rs.add_permit_result(ns, name, p.name, str(out), "0s")
            if ext is not None and has_hook(ext, "after_permit"):
                out = ext.after_permit(pod, node, out)  # framework outcome
            if out is None:
                pass
            elif isinstance(out, tuple):
                waits.append((p, str(out[1])))
            else:
                unreserve_all()
                return False
        if waits:
            timeouts = {}
            for p, t in waits:
                try:
                    timeouts[p.name] = parse_duration_seconds(t)
                except ValueError:
                    timeouts[p.name] = 0.0
            wp = WaitingPod(pod, timeouts)
            self.waiting_pods[(ns, name)] = wp
            for p, _ in waits:
                on_waiting = getattr(p, "on_waiting", None)
                if callable(on_waiting):
                    on_waiting(wp)
            if allow_async:
                import threading

                t = threading.Thread(
                    target=self._waiter_finish,
                    args=(wp, waits, pod, ns, name, node_name, node, plugins,
                          emap, unreserve_all),
                    daemon=True,
                )
                with self._waiter_lock:
                    self._wait_threads.append(t)
                t.start()
                return "deferred"
            try:
                rejection = wp.wait()
            finally:
                self.waiting_pods.pop((ns, name), None)
            if rejection is not None:
                plugin_name, msg = rejection
                timeout_str = next(
                    (t for p, t in waits if p.name == plugin_name), "0s")
                rs.add_permit_result(ns, name, plugin_name, msg, timeout_str)
                unreserve_all()
                return False
        return self._lifecycle_prebind(pod, ns, name, node, plugins, emap,
                                       unreserve_all)

    def _lifecycle_prebind(self, pod, ns, name, node, plugins, emap,
                           unreserve_all) -> bool:
        from ..scheduler.debuggable import has_hook

        rs = self.result_store
        for p in plugins:
            if not p.has_pre_bind:
                continue
            ext = emap.get(p.name)
            if ext is not None and has_hook(ext, "before_pre_bind"):
                if ext.before_pre_bind(pod, node) is not None:
                    unreserve_all()
                    return False
            t0 = time.perf_counter()
            msg = p.pre_bind(pod, node)
            self._observe_plugin(p.name, "prebind", t0,
                                 "Success" if not msg else "Unschedulable")
            rs.add_pre_bind_result(ns, name, p.name,
                                   msg if msg else ann.SUCCESS_MESSAGE)
            if ext is not None and has_hook(ext, "after_pre_bind"):
                msg = ext.after_pre_bind(pod, node, msg)  # framework outcome
            if msg:
                unreserve_all()
                return False
        return True

    def _waiter_finish(self, wp, waits, pod, ns, name, node_name, node,
                       plugins, emap, unreserve_all) -> None:
        """Binding-cycle tail for a parked pod (runs on a waiter thread).

        The pod stays in self.waiting_pods until the bind (or rejection)
        has fully landed — popping earlier would let a concurrent retry
        wave re-schedule it.  Any exception resolves to "rejected" (with
        unreserve) rather than silently killing the thread."""
        with TRACER.session_scope(self.session):
            self._waiter_finish_scoped(wp, waits, pod, ns, name, node_name,
                                       node, plugins, emap, unreserve_all)

    def _waiter_finish_scoped(self, wp, waits, pod, ns, name, node_name,
                              node, plugins, emap, unreserve_all) -> None:
        outcome = "rejected"
        try:
            rejection = wp.wait()
            if rejection is not None:
                plugin_name, msg = rejection
                timeout_str = next(
                    (t for p, t in waits if p.name == plugin_name), "0s")
                self.result_store.add_permit_result(ns, name, plugin_name,
                                                    msg, timeout_str)
                unreserve_all()
            elif self._lifecycle_prebind(pod, ns, name, node, plugins, emap,
                                         unreserve_all):
                self._bind(ns, name, node_name)
                # pod here is the lifecycle's private copy
                self._run_custom_postbind(pod, node_name, private=True)
                outcome = "bound"
        except Exception:
            try:
                unreserve_all()
            # best-effort cleanup on an already-failed waiter
            # kss-analyze: allow(swallowed-exception)
            except Exception:
                pass
        finally:
            try:
                if outcome == "rejected":
                    # waiter threads resolve after the wave: the cached
                    # per-wave node count may be stale, re-count fresh
                    self._mark_unschedulable(ns, name, fresh_node_count=True)
                self.reflector.reflect(
                    ns, name, uid=(pod.get("metadata") or {}).get("uid"))
            # the waiter thread must reach its result handoff; a reflect
            # failure leaves the store record for the next reflect
            # kss-analyze: allow(swallowed-exception)
            except Exception:
                pass
            self.waiting_pods.pop((ns, name), None)
            with self._waiter_lock:
                self._waiter_results.append((outcome, ns, name))

    def _get_node(self, node_name: str) -> dict | None:
        """Private node manifest for third-party plugin calls, None when
        it vanished mid-cycle."""
        try:
            return self.store.get("nodes", node_name)
        except NotFound:
            return None

    def _unreserve_custom(self, pod, node_name: str,
                          private: bool = False) -> None:
        """Unreserve ALL custom reserve plugins in reverse order — upstream
        runs RunReservePluginsUnreserve on ANY failure after Reserve
        succeeded, including a bind failure (scheduleOne's binding-cycle
        error path)."""
        plugins = [p for p in self._custom_lifecycle_plugins() if p.has_unreserve]
        if not plugins:
            return
        if not private:
            pod = copy.deepcopy(pod)
        node = self._get_node(node_name)
        for p in reversed(plugins):
            p.unreserve(pod, node)

    def _run_custom_postbind(self, pod, node_name: str,
                             private: bool = False) -> None:
        """PostBind (observation only, after the successful bind)."""
        plugins = [p for p in self._custom_lifecycle_plugins() if p.has_post_bind]
        if not plugins:
            return
        if not private:
            pod = copy.deepcopy(pod)  # plugins must not reach shared manifests
        emap = self._extenders_map()
        node = self._get_node(node_name)
        for p in plugins:
            ext = emap.get(p.name)
            if ext is not None:
                getattr(ext, "before_post_bind", lambda *a: None)(pod, node)
            t0 = time.perf_counter()
            p.post_bind(pod, node)
            self._observe_plugin(p.name, "postbind", t0, "Success")
            if ext is not None:
                getattr(ext, "after_post_bind", lambda *a: None)(pod, node)

    def _run_postfilter(self, cw, filter_codes, pod_idx, pod, ns: str, name: str) -> bool:
        """Run DefaultPreemption for an unschedulable pod; record the
        postfilter-result; execute victims + nomination. True if a node
        was nominated (the caller then runs a retry wave).

        filter_codes: [F, N] this pod's codes over cw.config.filters()."""
        from .preemption import PLUGIN_NAME, Preemptor, first_fail_plugins

        fskip = cw.host["filter_skip"]
        filters = cw.config.filters()
        active_idx = [f for f, n in enumerate(filters) if not fskip[n][pod_idx]]
        active_names = [filters[f] for f in active_idx]
        firsts = first_fail_plugins(filter_codes[active_idx], active_names)
        failed = [
            (node, firsts[j]) for j, node in enumerate(cw.node_table.names)
            if firsts[j] is not None
        ]
        outcome = Preemptor(
            self.store, self.plugin_config,
            extender_service=self.extender_service, device=self.device,
        ).preempt(pod, failed)
        self.result_store.add_post_filter_result(
            ns, name, outcome.nominated_node, PLUGIN_NAME, outcome.evaluated_nodes
        )
        if not outcome.nominated_node:
            return False
        for v in outcome.victims:
            vm = v.get("metadata") or {}
            try:
                self.store.delete("pods", vm.get("name", ""), vm.get("namespace") or "default")
            # victim already gone: the preemption's goal state
            # kss-analyze: allow(swallowed-exception)
            except NotFound:
                pass

        def nominate(cur: dict) -> None:
            cur.setdefault("status", {})["nominatedNodeName"] = outcome.nominated_node

        self._update_pod(ns, name, nominate)
        return True

    def _schedule_host_path(self, cw, pending) -> tuple[int, str | None]:
        """Host-interleaved path: device eval -> plugin-extender hooks +
        extender Filter/Prioritize over HTTP -> host selection -> device
        bind.  Taken when webhook extenders are configured (the
        reference's round-trip, SURVEY.md §3.3), when a plugin extender
        intercepts an extension point (wrappedplugin.go:159-171 Before/
        After hooks), or when a custom plugin has NormalizeScore
        (arbitrary Python can't run inside the device scan).

        On the card the eval is B10 `phased_eval` and the bind B5's
        `spec_commit_bind`, which updates the carry in place: the loop
        starts from a private copy of cw.init_carry (the preemption dry
        runs and a retry wave reuse cw)."""
        from .pipeline import build_phased

        phased = build_phased(cw)
        carry = _clone_carry(cw.init_carry)
        names = cw.node_table.names
        name_to_idx = {nm: j for j, nm in enumerate(names)}
        postfilter_on = bool(cw.config.postfilters())
        with TRACER.span("host_path_wave", pods=len(pending)):
            return self._host_pod_loop(
                cw, pending, phased, carry, names, name_to_idx,
                postfilter_on)

    def _webhook_filter(self, pod, names, name_to_idx, feasible) -> bool:
        """Extender filter verbs narrow `feasible` in place; returns True
        on an unignorable extender error."""
        import numpy as np

        extenders = self.extender_service.extenders if self.extender_service else []
        for idx, ext in enumerate(extenders):
            if not ext.filter_verb or not feasible.any():
                continue
            if not ext.is_interested(pod):
                continue
            node_names = [names[j] for j in np.flatnonzero(feasible)]
            args = {"Pod": pod, "NodeNames": node_names}
            try:
                result = self.extender_service.handle("filter", idx, args)
            except Exception:
                if ext.ignorable:
                    continue
                return True
            # an Error string in the response body is a failed extender
            # call even over HTTP 200 (upstream HTTPExtender.Filter)
            if result.get("Error") or result.get("error"):
                if ext.ignorable:
                    continue
                return True
            # nodeCacheCapable extenders answer with NodeNames; the
            # default contract answers with a full Nodes list.  Per-node
            # FailedNodes reasons travel in the recorded
            # extender-filter-result annotation (handle() stored the
            # whole response).
            # canonical extender/v1 JSON tags are all-lowercase
            # ("nodenames"/"nodes"); Go-struct casing accepted for
            # hand-rolled extenders
            from ..scheduler.extender import pick_field

            kept = pick_field(result, "nodenames", "NodeNames", "nodeNames")
            if kept is None:
                nodes_obj = pick_field(result, "nodes", "Nodes")
                if nodes_obj is not None:
                    kept = [
                        ((item.get("metadata") or {}).get("name", ""))
                        for item in (nodes_obj.get("Items") or nodes_obj.get("items") or [])
                    ]
            if kept is None:
                continue  # extender restricted nothing
            keep_mask = np.zeros(len(names), bool)
            for nm in kept:
                j = name_to_idx.get(nm)
                if j is not None:
                    keep_mask[j] = True
            feasible &= keep_mask
        return False

    def _webhook_prioritize(self, pod, names, name_to_idx, feasible, total) -> None:
        import numpy as np

        extenders = self.extender_service.extenders if self.extender_service else []
        for idx, ext in enumerate(extenders):
            if not ext.prioritize_verb or feasible.sum() <= 1:
                continue
            if not ext.is_interested(pod):
                continue
            node_names = [names[j] for j in np.flatnonzero(feasible)]
            try:
                plist = self.extender_service.handle(
                    "prioritize", idx, {"Pod": pod, "NodeNames": node_names}
                )
            # upstream ignores prioritize-extender errors (the scores
            # just don't contribute)
            # kss-analyze: allow(swallowed-exception)
            except Exception:
                continue
            for entry in plist or []:
                j = name_to_idx.get(entry.get("Host") or entry.get("host", ""))
                if j is not None:
                    # reference extender.go:145: score x weight x
                    # (MaxNodeScore/MaxExtenderPriority) rescales the
                    # extender's 0-10 priority onto the 0-100 node-score
                    # range before weighting
                    total[j] += (int(entry.get("Score") or entry.get("score") or 0)
                                 * ext.weight * 10)

    def _hooked_filter_phase(self, cw, pod, pod_idx, codes, names, hooks):
        """Run Before/After filter hooks per node with the reference's
        recording contract: Before-failure skips the plugin (no record for
        it or anything after it on that node) and fails the node;
        After-rewrites change the framework outcome only (an own-failure
        rewritten to success lets LATER plugins run and record).
        Returns (eff_feasible [N] bool, filter_map for the record)."""
        import numpy as np

        from ..scheduler.debuggable import has_hook
        from ..store.decode import decode_filter_message

        pod = copy.deepcopy(pod)  # hooks must not reach shared manifests

        fskip = cw.host["filter_skip"]
        active = []  # (filter idx, name, before hook or None, after hook or None)
        for f, nm in enumerate(cw.config.filters()):
            if fskip[nm][pod_idx]:
                continue
            ext = hooks.get(nm)
            active.append((
                f, nm,
                ext.before_filter if ext is not None and has_hook(ext, "before_filter") else None,
                ext.after_filter if ext is not None and has_hook(ext, "after_filter") else None,
            ))
        n = len(names)
        eff_feasible = np.ones(n, bool)
        filter_map: dict[str, dict[str, str]] = {}
        for j in range(n):
            entry: dict[str, str] = {}
            for f, nm, before, after in active:
                if before is not None and before(pod, names[j]) is not None:
                    eff_feasible[j] = False
                    break  # plugin skipped: no record from here on
                own = int(codes[f, j])
                own_msg = None if own == 0 else decode_filter_message(
                    nm, own, j, cw.host)
                entry[nm] = (ann.PASSED_FILTER_MESSAGE if own_msg is None
                             else own_msg)
                fw_msg = after(pod, names[j], own_msg) if after is not None else own_msg
                if fw_msg is not None:
                    eff_feasible[j] = False
                    break
            if entry:
                filter_map[names[j]] = entry
        return eff_feasible, filter_map

    def _hooked_score_phase(self, cw, phased, carry, xs1, pod, pod_idx, raw,
                            names, feasible, hooks, name_to_idx):
        """AfterScore rewrites + host renormalization + AfterNormalize.
        Returns (record_final [S,N], total [N], cycle_error: bool).

        Records per the reference: score-result keeps the device originals;
        finalscore-result = normalize(AfterScore-modified raws) x weight
        (the store's AddNormalizedScoreResult runs before AfterNormalize);
        the framework total additionally reflects AfterNormalize.

        Every hook runs where the reference runs it, scorer by scorer.  An
        in-tree scorer's normalization is a pure function of its final
        raws (after its AfterScore hooks), the carry and the feasibility,
        so its row waits in `pending` and a pod's pending rows are
        normalized together, in one launch of B10 `renormalize_rows` on
        the card (one H2D of the stacked raws, one D2H): just before the
        AfterNormalize hook of a pending scorer, which needs its row, and
        at the end of the loop.  A BeforeScore cycle error drops them
        unlaunched.  A custom plugin's NormalizeScore runs on the host in
        its place in the loop (pipeline.renormalize)."""
        import numpy as np
        import torch

        from ..kernels.phased import renormalize_rows
        from ..scheduler.debuggable import has_hook
        from .pipeline import NORMALIZING, renormalize

        if hooks:
            pod = copy.deepcopy(pod)  # hooks must not reach shared manifests
        sskip = cw.host["score_skip"]
        score_names = cw.config.scorers()
        n = len(names)
        feas_idx = np.flatnonzero(feasible)
        eff_raw = np.array(raw, dtype=np.int64, copy=True)
        record_final = np.zeros_like(eff_raw)
        total = np.zeros(n, dtype=np.int64)
        dev = self.device
        feas_t = torch.from_numpy(np.ascontiguousarray(feasible)).to(dev)
        pending = []  # (score row, name, hooks) of rows awaiting the flush

        def finish(s, nm, ext, normed):
            w = cw.config.weight(nm)
            record_final[s] = normed * w
            fw_norm = np.array(normed, copy=True)
            if ext is not None and has_hook(ext, "after_normalize"):
                ret = ext.after_normalize(
                    pod, {names[j]: int(fw_norm[j]) for j in feas_idx})
                if ret is not None:
                    for node_name, v in ret.items():
                        j = name_to_idx.get(node_name)
                        if j is not None:
                            fw_norm[j] = int(v)
            total[:] += np.where(feasible, fw_norm * w, 0)

        def flush():
            rows = [s for s, _, _ in pending]
            normed = renormalize_rows(
                phased.step, [nm for _, nm, _ in pending], carry, xs1,
                torch.from_numpy(eff_raw[rows]).to(dev), feas_t).cpu().numpy()
            self.renormalize_flushes += 1
            # kss-analyze: allow(pod-loop) one pod's deferred score rows, not pods
            for (s, nm, ext), row in zip(pending, normed.astype(np.int64)):
                finish(s, nm, ext, row)
            pending.clear()

        for s, nm in enumerate(score_names):
            if sskip[nm][pod_idx]:
                continue
            ext = hooks.get(nm)
            if ext is not None and has_hook(ext, "before_score"):
                for j in feas_idx:
                    if ext.before_score(pod, names[j]) is not None:
                        return record_final, total, True  # cycle errors
            if ext is not None and has_hook(ext, "after_score"):
                for j in feas_idx:
                    eff_raw[s, j] = int(ext.after_score(
                        pod, names[j], int(eff_raw[s, j])))
            if cw.config.is_custom(nm):
                finish(s, nm, ext, renormalize(
                    nm, phased, carry, xs1, torch.from_numpy(eff_raw[s].copy()),
                    feas_t).cpu().numpy().astype(np.int64))
            elif nm in NORMALIZING:
                pending.append((s, nm, ext))
                if ext is not None and has_hook(ext, "after_normalize"):
                    flush()
            else:
                finish(s, nm, ext, eff_raw[s].copy())  # no ScoreExtensions
        if pending:
            flush()
        return record_final, total, False

    def _host_pod_loop(self, cw, pending, phased, carry, names,
                       name_to_idx, postfilter_on) -> tuple[int, str | None]:
        import numpy as np
        import torch

        from .replay import ReplayResult

        from ..scheduler.debuggable import has_hook

        hooks = self._cycle_hooks()
        custom_norm = any(
            cw.config.is_custom(nm) and getattr(cw.config.custom[nm], "has_normalize", False)
            for nm in cw.config.enabled
        )
        rescore = bool(hooks) or custom_norm
        has_filter_hooks = any(
            has_hook(ext, "before_filter") or has_hook(ext, "after_filter")
            for ext in hooks.values()
        )

        n_bound = 0
        retry: str | None = None
        for i, pod in enumerate(pending):
            xs1 = _slice_xs(cw.xs, i, i + 1, 1)
            xs1["is_pad"] = torch.zeros(1, dtype=torch.bool, device=self.device)
            out = _fetch_step_out(phased.eval(carry, xs1))
            codes = out.filter_codes
            fskip = cw.host["filter_skip"]
            active = [f for f, nm in enumerate(cw.config.filters()) if not fskip[nm][i]]

            pf_reject = int(out.prefilter_reject)
            hook_filter_map = None
            if pf_reject:
                # PreFilter aborted the cycle: Filter never runs upstream,
                # so neither do Before/After filter hooks, nor extenders
                feasible = np.zeros(len(names), bool)
            elif has_filter_hooks:
                feasible, hook_filter_map = self._hooked_filter_phase(
                    cw, pod, i, codes, names, hooks)
            else:
                feasible = codes[active].max(axis=0) == 0 if active else np.ones(len(names), bool)

            meta = pod.get("metadata") or {}
            ns, name = meta.get("namespace") or "default", meta.get("name", "")
            ext_error = self._webhook_filter(pod, names, name_to_idx, feasible)

            cycle_error = False
            record_final = np.asarray(out.score_final)
            if rescore and not ext_error and int(feasible.sum()) > 1:
                record_final, total, cycle_error = self._hooked_score_phase(
                    cw, phased, carry, xs1, pod, i, out.score_raw, names,
                    feasible, hooks, name_to_idx)
            else:
                total = np.asarray(out.score_final).sum(axis=0).astype(np.int64)
            if not cycle_error:
                self._webhook_prioritize(pod, names, name_to_idx, feasible, total)

            count = int(feasible.sum())
            sel = -1
            if cycle_error:
                pass  # RunScorePlugins error: the cycle fails outright
            elif count == 1:
                sel = int(np.flatnonzero(feasible)[0])
            elif count > 1:
                masked = np.where(feasible, total, -1)
                sel = int(masked.argmax())

            rr1 = ReplayResult(
                cw=cw,
                filter_codes=codes[None],
                score_raw=np.asarray(out.score_raw)[None],
                score_final=np.asarray(record_final)[None],
                selected=np.asarray([sel], dtype=np.int32),
                feasible_count=np.asarray([count], dtype=np.int32),
                prefilter_reject=np.asarray([pf_reject], dtype=np.int32),
            )
            annotations = decode_pod_result(
                rr1, 0,
                feasible_override=(np.zeros_like(feasible) if cycle_error else feasible),
                host_index=i)
            if hook_filter_map is not None and not pf_reject:
                annotations[ann.FILTER_RESULT] = ann.marshal(hook_filter_map)
            self.result_store.put_decoded(ns, name, annotations)
            emap = self._extenders_map()
            if emap:
                hook_pod = copy.deepcopy(pod)  # hooks must not reach shared manifests
                for hook in emap.values():
                    hook.after_cycle(hook_pod, annotations, self.result_store)

            bind_ok = sel >= 0 and not ext_error
            lifecycle_rejected = False
            lifecycle_ok = False
            # one private copy serves every third-party surface this cycle
            priv = (copy.deepcopy(pod)
                    if bind_ok and self._custom_lifecycle_plugins() else pod)
            if bind_ok:
                if self._run_custom_lifecycle(priv, ns, name, names[sel],
                                              private=True):
                    lifecycle_ok = True
                else:
                    # here the carry only folds on a successful bind, so a
                    # rejection needs no wave re-run (sequential path)
                    bind_ok = False
                    lifecycle_rejected = True
                    sel = -1
            if bind_ok:
                bound_node = names[sel]
                extenders = self.extender_service.extenders if self.extender_service else []
                # upstream extendersBinding: the binder must also be
                # interested in the pod (IsBinder AND IsInterested)
                bind_ext = next(
                    (k for k, e in enumerate(extenders)
                     if e.bind_verb and e.is_interested(pod)),
                    None,
                )
                if bind_ext is not None:
                    # upstream: a bind-verb extender REPLACES the default
                    # binder (the wrapped DefaultBinder never runs, so its
                    # bind-result stays empty; the extender round-trip is
                    # recorded under extender-bind-result instead); its
                    # failure fails the cycle (pod retries)
                    self.result_store.put_decoded(
                        ns, name, {ann.BIND_RESULT: "{}"})
                    try:
                        result = self.extender_service.handle("bind", bind_ext, {
                            "PodName": name, "PodNamespace": ns,
                            "PodUID": meta.get("uid", ""), "Node": bound_node,
                        })
                        if (result or {}).get("Error") or (result or {}).get("error"):
                            bind_ok = False
                    except Exception:
                        bind_ok = False
                    if not bind_ok and lifecycle_ok:
                        # upstream RunReservePluginsUnreserve on bind failure
                        self._unreserve_custom(priv, bound_node, private=True)
            if bind_ok:
                carry = phased.bind(carry, xs1, sel)
                self._bind(ns, name, names[sel])
                self._run_custom_postbind(priv, names[sel], private=True)
                n_bound += 1
            else:
                # FitError (no feasible node) runs PostFilter, like the
                # plain path; an extender/bind failure, a scoring-cycle
                # error, or a lifecycle rejection does not (upstream only
                # preempts on FitError).  Candidate nodes are those that
                # failed the PLUGIN filters — extender-rejected nodes are
                # not preemption candidates (docs/SEMANTICS.md).
                if (postfilter_on and sel < 0 and not ext_error
                        and not pf_reject and not lifecycle_rejected
                        and not cycle_error):
                    if self._run_postfilter(cw, codes, i, pod, ns, name):
                        retry = "preempted"
                self._mark_unschedulable(ns, name)
            self.reflector.reflect(ns, name, uid=meta.get("uid"))
        return n_bound, retry

    # ------------------------------------------------------------ writes

    def _update_pod(self, ns: str, name: str, mutate) -> None:
        """Re-fetch + mutate + update under the shared exponential-backoff
        retry (100ms x3^n, 6 steps — utils/retry.py, the reference's
        util.RetryWithExponentialBackOff schedule that the reflector's
        write path already uses).  Exhaustion raises RetryTimeout: a bind
        or status write that cannot land after 6 conflict rounds is a real
        failure and must surface, not silently drop.

        Copy-on-write: the callback receives a pod whose top level and
        metadata/spec/status dicts are fresh; anything deeper is SHARED
        with the stored object and must be replaced, not mutated in place
        (all current callbacks rebuild the lists they change)."""
        from ..utils.retry import retry_with_exponential_backoff

        def attempt() -> tuple[bool, Exception | None]:
            try:
                cur = self.store.get("pods", name, ns, copy_object=False)
            except NotFound:
                return True, None
            pod = dict(cur)
            pod["metadata"] = dict(cur.get("metadata") or {})
            pod["spec"] = dict(cur.get("spec") or {})
            pod["status"] = dict(cur.get("status") or {})
            mutate(pod)
            try:
                self.store.update("pods", pod, owned=True)
                return True, None
            except Conflict:
                return False, None  # re-fetch and retry under backoff

        # the reflector's stop event doubles as the engine's teardown
        # interrupt: session eviction must not ride out a bind-conflict
        # backoff (~36s) any more than a write-back one (utils/retry.py)
        retry_with_exponential_backoff(
            attempt, sleep=self._retry_sleep,
            stop=getattr(self.reflector, "stop_event", None))

    @staticmethod
    def _bind_mutation(node_name: str):
        def mutate(pod: dict) -> None:
            pod.setdefault("spec", {})["nodeName"] = node_name
            status = pod.setdefault("status", {})
            status["phase"] = "Running"  # KWOK-style: no kubelet, fake-run
            conds = [c for c in status.get("conditions") or [] if c.get("type") != "PodScheduled"]
            conds.append({"type": "PodScheduled", "status": "True"})
            status["conditions"] = conds

        return mutate

    def _bind(self, ns: str, name: str, node_name: str) -> None:
        self._update_pod(ns, name, self._bind_mutation(node_name))

    def _node_count(self, fresh: bool = False) -> int:
        """#nodes for the unschedulable condition message, cached per
        wave — _mark_unschedulable used to pay a full deepcopy
        store.list("nodes") per unschedulable pod just to render it.
        fresh=True re-counts (copy-free) for writes that land OUTSIDE
        the wave that cached it (Permit-waiter threads)."""
        n = None if fresh else self._wave_node_count
        if n is None:
            n = len(self._list_shared("nodes"))
        return n

    def _unschedulable_mutation(self, fresh_node_count: bool = False):
        n_nodes = self._node_count(fresh=fresh_node_count)

        def mutate(pod: dict) -> None:
            status = pod.setdefault("status", {})
            status["phase"] = "Pending"
            conds = [c for c in status.get("conditions") or [] if c.get("type") != "PodScheduled"]
            conds.append({
                "type": "PodScheduled", "status": "False",
                "reason": "Unschedulable",
                "message": "0/%d nodes are available" % n_nodes,
            })
            status["conditions"] = conds

        return mutate

    def _commit_pod_batch(self, items) -> int:
        """Commit a run of scheduled/unschedulable outcomes: one
        ObjectStore.apply_batch call (single lock hold, contiguous rv
        range, pod order preserved — so watch subscribers see the same
        bind order as the sequential path); per-pod _update_pod fallback
        for stores without the batch surface (the remote HTTP client).

        items: [(ns, name, node_name or None)] in pod order.  Returns
        #bound."""
        if not items:
            return 0
        bound = sum(1 for _, _, node in items if node)
        if getattr(self.store, "apply_batch", None) is None:
            for ns, name, node in items:
                if node:
                    self._bind(ns, name, node)
                else:
                    self._mark_unschedulable(ns, name)
            return bound
        unsched = None if bound == len(items) else self._unschedulable_mutation()
        self.store.apply_batch("pods", [
            (name, ns, self._bind_mutation(node) if node else unsched)
            for ns, name, node in items
        ])
        return bound

    def _mark_gated(self, ns: str, name: str) -> None:
        """upstream SchedulingGates PreEnqueue rejection condition."""
        try:
            cur = self.store.get("pods", name, ns)
        except NotFound:
            return
        conds = (cur.get("status") or {}).get("conditions") or []
        if any(c.get("reason") == "SchedulingGated" for c in conds):
            return  # already marked; don't churn resourceVersion each wave

        def mutate(pod: dict) -> None:
            status = pod.setdefault("status", {})
            status["phase"] = "Pending"
            cs = [c for c in status.get("conditions") or [] if c.get("type") != "PodScheduled"]
            cs.append({
                "type": "PodScheduled", "status": "False",
                "reason": "SchedulingGated",
                "message": "Scheduling is blocked due to non-empty scheduling gates",
            })
            status["conditions"] = cs

        self._update_pod(ns, name, mutate)

    def _mark_unschedulable(self, ns: str, name: str,
                            fresh_node_count: bool = False) -> None:
        self._update_pod(
            ns, name, self._unschedulable_mutation(fresh_node_count))
