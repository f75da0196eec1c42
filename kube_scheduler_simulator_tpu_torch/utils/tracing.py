"""Wave flight recorder: tracing and metrics for the scheduling engine.

A copy of kube_scheduler_simulator_tpu/utils/tracing.py, host code with its
imports rewired to the port. Its device profile capture runs torch.profiler
(CPU activity, and CUDA's where a card is present) and writes a Chrome trace.

Additive over the reference (SURVEY.md §5: the reference has no tracing
beyond the per-Pod annotation record; the upstream scheduler only
blank-imports Prometheus registration, cmd/scheduler/scheduler.go:9-11).
Here the TPU path gets real observability:

- HIERARCHICAL spans (span/parent ids, thread ids, labels) in a bounded
  ring buffer with per-name aggregates — the span tree covers
  compile_workload -> replay_and_decode_stream -> decode_chunk /
  commit_stream -> gang_quorum -> commit_and_reflect, including spans
  recorded on the pipelined-commit worker thread (parented explicitly
  across threads);
- fixed-bucket HISTOGRAMS and LABELED counters under the upstream
  kube-scheduler metric names (scheduling_attempt_duration_seconds,
  framework_extension_point_duration_seconds,
  plugin_execution_duration_seconds — bucket layouts match upstream
  pkg/scheduler/metrics/metrics.go);
- plain counters (pods scheduled/unschedulable, preemptions, waves) —
  the pre-flight-recorder API, unchanged;
- valid Prometheus text exposition (# HELP/# TYPE, metric-name
  sanitization, label escaping; validate_exposition() is the strict
  checker the tests run against every scrape), served at /metrics;
- Perfetto / chrome://tracing JSON export of the span tree
  (GET /api/v1/trace), showing the commit pipeline's overlap in one
  browser load (docs/metrics.md has the walkthrough);
- device profile capture: start_xla_profile/stop_xla_profile run
  `torch.profiler` on a thread of its own (_ProfileSession; the
  profiler must start and stop on one thread) and write a Chrome trace
  into the log dir (POST /api/v1/profile).
"""

from __future__ import annotations

import itertools
import os
import re
import threading
import time
from collections import deque
from contextlib import contextmanager

from .env import env_int

_PREFIX = "kss_tpu"

# open-span bookkeeping rides the wave black box's enable flag
# (utils/blackbox.py owns the user-facing toggle and mirrors it here —
# tracing cannot import blackbox without a cycle): with the black box
# off, span entry pays no extra lock and the post-mortem surface
# reports no open spans, keeping the KSS_TPU_BLACKBOX=0 A/B honest
BLACKBOX_OPEN_SPANS = os.environ.get("KSS_TPU_BLACKBOX", "1") != "0"


class ProfileStateError(RuntimeError):
    """Invalid XLA-profile state transition (double start, stop without
    start) — the server maps it to HTTP 409."""


class _ProfileSession:
    """One torch.profiler session on a thread of its own: the profiler
    must start and stop on one thread, and the server answers each
    request on another.  The thread starts the profile, waits for stop(),
    stops it and exports the Chrome trace."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self._started = threading.Event()
        self._stop = threading.Event()
        self._done = threading.Event()
        self._error: BaseException | None = None
        self.path = os.path.join(log_dir, f"kss-profile-{os.getpid()}-{time.time_ns()}.json")
        os.makedirs(log_dir, exist_ok=True)
        self._thread = threading.Thread(target=self._run, name="kss-profile", daemon=True)
        self._thread.start()
        self._started.wait()
        if self._error is not None:
            self._thread.join()
            raise ProfileStateError(str(self._error)) from self._error

    def _run(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        try:
            prof = profile(activities=activities)
            prof.start()
        except RuntimeError as e:  # a profiler session started outside this tracer
            self._error = e
            self._started.set()
            return
        self._started.set()
        self._stop.wait()
        try:
            prof.stop()
            prof.export_chrome_trace(self.path)
        except (RuntimeError, OSError) as e:
            self._error = e
        self._done.set()

    def stop(self) -> str:
        self._stop.set()
        self._done.wait()
        self._thread.join()
        if self._error is not None:
            raise ProfileStateError(str(self._error)) from self._error
        return self.path


def _exp_buckets(start: float, factor: float, count: int) -> tuple[float, ...]:
    out, v = [], start
    for _ in range(count):
        out.append(v)
        v *= factor
    return tuple(out)


# upstream kube-scheduler histogram layouts (pkg/scheduler/metrics):
#   scheduling_attempt_duration_seconds   ExponentialBuckets(0.001, 2, 15)
#   framework_extension_point_duration_seconds
#                                         ExponentialBuckets(0.0001, 2, 12)
#   plugin_execution_duration_seconds     ExponentialBuckets(1e-5, 1.5, 20)
BUCKETS: dict[str, tuple[float, ...]] = {
    "scheduling_attempt_duration_seconds": _exp_buckets(0.001, 2, 15),
    "framework_extension_point_duration_seconds": _exp_buckets(0.0001, 2, 12),
    "plugin_execution_duration_seconds": _exp_buckets(1e-5, 1.5, 20),
    # accept FRACTION per speculative round — a ratio in (0, 1], not a
    # duration: linear decile buckets (docs/metrics.md)
    "speculative_accept_fraction": tuple(i / 10 for i in range(1, 11)),
    # XLA scan builds run ~0.1s (warm shapes) to tens of seconds (cold
    # giant meshes): a wider exponential ladder than the attempt buckets
    "scan_compile_build_seconds": _exp_buckets(0.01, 2, 14),
    # sessions sharing one fused device dispatch — a small integer
    # (1 = ran solo), not a duration (parallel/fuse.py, docs/metrics.md)
    "fused_sessions_per_dispatch": (1.0, 2.0, 3.0, 4.0, 6.0, 8.0, 12.0,
                                    16.0),
}
_DEFAULT_BUCKETS = _exp_buckets(0.001, 2, 15)

_HELP: dict[str, str] = {
    "scheduling_attempt_duration_seconds":
        "Per-pod scheduling attempt duration (wave wall amortized over the "
        "wave's pods on the batched paths), by result.",
    "framework_extension_point_duration_seconds":
        "Per-wave extension point duration; prefilter/filter/score are "
        "apportioned from the fused replay span by evaluated work, bind is "
        "the commit tail wall time.",
    "plugin_execution_duration_seconds":
        "Per-plugin execution duration: real wall time on the host path "
        "(reserve/permit/prebind/postbind), work-apportioned replay time "
        "for device-fused filter/score/prefilter (docs/metrics.md).",
    "pods_scheduled_total": "Pods bound by scheduling waves.",
    "pods_unschedulable_total": "Pods left pending after a full pass.",
    "scheduling_waves_total": "Batched scheduling waves run.",
    "plugin_pods_nodes_evaluated_total":
        "Pod x node evaluations attributed to a plugin from the replay "
        "tensors (prefilter: pods screened-in).",
    "plugin_filter_rejects_total":
        "Nodes rejected with this plugin as the first failing filter.",
    "plugin_score_sum_total":
        "Sum of this plugin's raw scores over feasible nodes of scored pods.",
    "plugin_prefilter_screens_total":
        "Pods this PreFilter plugin screened out before the wave compiled.",
    "gang_quorum_groups_total":
        "Gang groups per vectorized quorum pass, by decision.",
    "decode_path_total":
        "Pods decoded per decoder-ladder path (docs/wave-pipeline.md).",
    "decode_on_demand_total":
        "Lazy annotation reads by outcome: miss = the read decoded (or "
        "waited on) its chunk, hit = the chunk was already materialized "
        "(docs/wave-pipeline.md lazy-decode stage).",
    "lazy_decode_cold_read_seconds":
        "Cold first-read latency of a lazily materialized pod: time from "
        "the read to its chunk's annotations being available (one "
        "GIL-released native chunk decode).",
    "d2h_on_demand_bytes_total":
        "Bytes copied device->host by on-demand materialization of "
        "device-resident replay chunks (cold reads; docs/wave-pipeline.md "
        "device-residency stage).",
    "d2h_on_demand_seconds":
        "On-demand device->host materialization latency of one "
        "device-resident replay chunk (gather included on meshes).",
    "wave_d2h_bytes_total":
        "Bytes the wave itself copied device->host while streaming: "
        "decision rows + attribution sums only in device-resident mode, "
        "the full compact tensors in host-resident/eager modes.",
    "device_chunks_retained":
        "Replay chunks currently retained as live device arrays "
        "(KSS_TPU_DEVICE_RESULT_BUDGET_MB bounds the bytes behind them).",
    "device_chunks_spilled_total":
        "Device-resident replay chunks spilled to host by the retention "
        "budget's background LRU writer (session label: the session whose "
        "per-session share of KSS_TPU_DEVICE_RESULT_BUDGET_MB was "
        "exceeded).",
    "scan_compile_cache_total":
        "Scan compile cache lookups by result: miss = a fresh "
        "build (first wave at a new workload shape), hit = a "
        "process-level cached executable reused — across sessions, the "
        "multi-session serving win (docs/metrics.md).",
    "sessions_active":
        "Simulation sessions currently live in the SessionManager "
        "(including the default session).",
    "sessions_created_total": "Simulation sessions created.",
    "sessions_evicted_total":
        "Simulation sessions torn down, by reason (explicit DELETE, "
        "idle TTL, LRU capacity eviction, server shutdown).",
    "scheduling_loop_crashes_total":
        "Scheduling-loop waves that raised (the loop stays alive; the "
        "last crash is surfaced on /readyz).",
    "speculative_accepted_total":
        "Pods accepted by the speculative conflict oracle (committed as "
        "part of a round's non-interfering prefix).",
    "speculative_rolled_back_total":
        "Pod evaluations rolled into the next round (rejected by the "
        "dirty-node / interaction / gang-boundary cut; a pod may roll "
        "more than once before it commits).",
    "speculative_accept_fraction":
        "Accepted fraction of each speculative round's batch "
        "(accepted / round size; 1.0 = the whole batch committed).",
    "speculative_fallbacks_total":
        "Speculative waves that handed their remainder to the "
        "sequential chunked scan after a sustained accept-rate collapse "
        "at the bottom batch rung (docs/wave-pipeline.md).",
    "mesh_fallback_indivisible_nodes_total":
        "Waves of an engine with a mesh that ran unsharded because the "
        "cluster's node count does not divide the mesh's 'nodes' extent "
        "(parallel/mesh.py can_shard).",
    "tracer_events_dropped_total":
        "Span events evicted from the tracer's fixed-size ring because "
        "it was full — a long soak whose trace tail silently scrolled "
        "away shows up here (utils/tracing.py).",
    "blackbox_dumps_total":
        "Post-mortem bundles snapshotted by the wave black box, by "
        "reason (wave_abort, degradation, chaos_failure, request; "
        "docs/metrics.md post-mortem dumps).",
    "hbm_bytes_in_use":
        "Device memory currently in use per local device (device "
        "label) and summed across devices (unlabeled), sampled from "
        "torch.cuda.memory_stats(); only exported where a card reports "
        "memory stats — see hbm_stats_available.",
    "hbm_peak_bytes":
        "Peak device memory in use per local device (device label) "
        "and summed (unlabeled), from torch.cuda.memory_stats().",
    "hbm_stats_available":
        "1 when the backend exposes device memory_stats (HBM gauges "
        "are live), 0 as the explicit no-op marker where it does not "
        "(no card).",
    "scan_compile_build_seconds":
        "Wall seconds of one scan build, labeled by the workload "
        "shape's cache key (key=<crc32 of the shape key>) and result.",
    "scan_compile_cache_entries":
        "Compiled scan executables currently held by the process-level "
        "LRU cache (framework/replay._ScanCacheRegistry).",
}

_NAME_SANITIZE_RE = re.compile(r"[^a-zA-Z0-9_:]")
_METRIC_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_NAME_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def sanitize_metric_name(name: str) -> str:
    """A valid Prometheus metric name from an arbitrary span/counter name
    (dashes, dots, spaces -> '_'; leading digit prefixed)."""
    s = _NAME_SANITIZE_RE.sub("_", name)
    if not s or s[0].isdigit():
        s = "_" + s
    return s


def escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(v: str) -> str:
    return v.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_float(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _fmt_le(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    return f"{v:g}"


class Span:
    """Handle yielded by Tracer.span(): carries the span id (for explicit
    cross-thread parenting) and, after exit, the measured seconds."""

    __slots__ = ("id", "parent_id", "name", "seconds")

    def __init__(self, span_id: int, parent_id: int | None, name: str):
        self.id = span_id
        self.parent_id = parent_id
        self.name = name
        self.seconds = 0.0


class _Hist:
    """One histogram series (a label set): fixed bounds, per-bucket
    counts (non-cumulative internally), sum and count."""

    __slots__ = ("counts", "sum", "count")

    def __init__(self, n_buckets: int):
        self.counts = [0] * (n_buckets + 1)  # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Tracer:
    def __init__(self, capacity: int | None = None):
        if capacity is None:
            # KSS_TPU_TRACER_CAPACITY sizes the span ring: a soak whose
            # trace tail matters can grow it instead of silently losing
            # events (tracer_events_dropped_total counts evictions and
            # /readyz surfaces them as tracerDroppedEvents)
            capacity = max(64, env_int("KSS_TPU_TRACER_CAPACITY", 4096))
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._agg: dict[str, dict] = {}
        self._counters: dict[str, float] = {}
        # gauges: absolute values set by gauge() (current device-retained
        # chunk count etc.), exported with TYPE gauge; labeled series
        # (HBM per-device samples) live separately and merge into one
        # family at exposition, like counters do
        self._gauges: dict[str, float] = {}
        self._lgauges: dict[str, dict[tuple, float]] = {}
        # spans currently OPEN (entered, not yet exited): the wave black
        # box snapshots these into a post-mortem bundle so a dump shows
        # WHERE the wave was when the fault fired (utils/blackbox.py)
        self._open: dict[int, dict] = {}
        # labeled counters: name -> {((k, v), ...) sorted: value}
        self._lcounters: dict[str, dict[tuple, float]] = {}
        # histograms: name -> {((k, v), ...) sorted: _Hist}
        self._hists: dict[str, dict[tuple, _Hist]] = {}
        self._hist_bounds: dict[str, tuple[float, ...]] = {}
        self._profile_dir: str | None = None
        self._profile: _ProfileSession | None = None
        self._profile_lock = threading.Lock()
        self._epoch = time.time()
        self._perf_epoch = time.perf_counter()
        self._ids = itertools.count(1)
        self._tls = threading.local()
        self._tids: dict[int, tuple[int, str]] = {}  # ident -> (tid, name)
        # per-session views (multi-session serving, server/sessions.py):
        # while a session scope is active on the recording thread, spans
        # gain a session attr, labeled counters/histograms gain a
        # session label, and plain counters/span aggregates are ALSO
        # tallied here so /api/v1/metrics?session= can answer without
        # touching the aggregate families
        self._scounters: dict[str, dict[str, float]] = {}
        self._sagg: dict[str, dict[str, dict]] = {}
        # per-session gauge view: gauge() under a session scope mirrors
        # the last-set value here so snapshot(session=) can answer
        # (counters/histograms fold a session label; gauges are
        # absolute values, so the aggregate sample stays unlabeled and
        # the session view is a mirror, not a label)
        self._sgauges: dict[str, dict[str, float]] = {}
        # pending trace-id handoff, session -> trace id: the server
        # notes the request's trace id when a workload-submitting call
        # lands, and the scheduling wave that consumes the work CLAIMS
        # it (consume-once) so the wave's spans correlate back to the
        # HTTP request that caused them (docs/metrics.md)
        self._session_traces: dict[str, str] = {}

    # ---------------------------------------------------------- sessions

    def current_session(self) -> str | None:
        """The session id attached to metrics recorded on this thread
        (None outside any session scope — direct engine use, tests)."""
        st = getattr(self._tls, "sessions", None)
        return st[-1] if st else None

    @contextmanager
    def session_scope(self, session: str | None):
        """Attribute everything recorded on this thread to `session`:
        spans carry a session attr, inc()/observe() fold a session
        label in, count()/span aggregates are mirrored into the
        per-session view.  None is a no-op scope (the sessionless
        paths stay byte-identical)."""
        if session is None:
            yield
            return
        st = getattr(self._tls, "sessions", None)
        if st is None:
            st = self._tls.sessions = []
        st.append(str(session))
        try:
            yield
        finally:
            st.pop()

    # ------------------------------------------------------------ traces

    def current_trace(self) -> str | None:
        """The trace id attached to spans/events recorded on this
        thread (None outside any trace scope)."""
        st = getattr(self._tls, "traces", None)
        return st[-1] if st else None

    @contextmanager
    def trace_scope(self, trace_id: str | None):
        """Correlate everything recorded on this thread under one trace
        id: spans and black-box events gain a trace_id attr, so one id
        ties an HTTP request to the wave, speculative rounds, and fused
        dispatches it caused.  Propagates exactly like session_scope;
        None is a no-op scope (an enclosing scope, if any, stays
        active)."""
        if trace_id is None:
            yield
            return
        st = getattr(self._tls, "traces", None)
        if st is None:
            st = self._tls.traces = []
        st.append(str(trace_id))
        try:
            yield
        finally:
            st.pop()

    def note_session_trace(self, session: str, trace_id: str) -> None:
        """Stash `trace_id` as the pending trace for `session`'s next
        scheduling wave (the server calls this for workload-submitting
        requests; engine.schedule_pending claims it)."""
        with self._lock:
            self._session_traces[str(session)] = str(trace_id)

    def claim_session_trace(self, session: str | None) -> str | None:
        """Pop (consume-once) the pending trace id for `session` — the
        wave that drains the submitted work owns the correlation."""
        if session is None:
            return None
        with self._lock:
            return self._session_traces.pop(str(session), None)

    # ------------------------------------------------------------- spans

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current_span_id(self) -> int | None:
        st = self._stack()
        return st[-1] if st else None

    def _tid(self) -> int:
        ident = threading.get_ident()
        ent = self._tids.get(ident)
        if ent is None:
            ent = (len(self._tids) + 1, threading.current_thread().name)
            self._tids[ident] = ent
        return ent[0]

    @contextmanager
    def span(self, name: str, parent: int | None = None, **attrs):
        """Record a span; nested spans on the same thread parent
        implicitly, `parent=` parents explicitly across threads (the
        commit worker parents its chunk spans under the wave's replay
        span).  Yields a Span whose .id other threads may use and whose
        .seconds is set on exit."""
        st = self._stack()
        sp = Span(next(self._ids),
                  parent if parent is not None else (st[-1] if st else None),
                  name)
        st.append(sp.id)
        session = self.current_session()
        if session is not None and "session" not in attrs:
            attrs["session"] = session
        trace_id = self.current_trace()
        if trace_id is not None and "trace_id" not in attrs:
            attrs["trace_id"] = trace_id
        t0 = time.perf_counter()
        if BLACKBOX_OPEN_SPANS:
            with self._lock:
                self._open[sp.id] = {
                    "name": name, "span_id": sp.id,
                    "parent_id": sp.parent_id,
                    "tid": self._tid(), "t0": time.time(),
                    **({"session": session} if session is not None else {}),
                    **({"trace_id": trace_id} if trace_id is not None
                       else {}),
                }
        try:
            yield sp
        except BaseException as exc:
            # first (innermost) span this exception unwinds through:
            # stash the open-span tree AS OF THE FAULT so the black
            # box's post-mortem can report where the wave was, even
            # though every span has closed by the time the wave failure
            # protocol builds the bundle (utils/blackbox.py).  An
            # explicit except (not sys.exc_info() in the finally) so a
            # span exiting NORMALLY inside an outer except handler
            # never tags the handled exception with stale spans.
            if not hasattr(exc, "_kss_open_spans"):
                try:
                    exc._kss_open_spans = self.open_spans()
                # builtins with __slots__ reject attributes — best-effort
                # kss-analyze: allow(swallowed-exception)
                except Exception:
                    pass
            raise
        finally:
            dt = time.perf_counter() - t0
            sp.seconds = dt
            st.pop()
            with self._lock:
                self._open.pop(sp.id, None)
                if (self._events.maxlen is not None
                        and len(self._events) == self._events.maxlen):
                    # the ring is full: this append evicts the oldest
                    # span silently — count it so long soaks can see
                    # their trace tail scrolled away (summary(),
                    # /metrics tracer_events_dropped_total)
                    self._counters["tracer_events_dropped_total"] = \
                        self._counters.get(
                            "tracer_events_dropped_total", 0) + 1
                tid = self._tid()
                self._events.append({
                    "name": name, "t": time.time(), "seconds": dt,
                    "ts": round(t0 - self._perf_epoch, 6),
                    "span_id": sp.id, "parent_id": sp.parent_id, "tid": tid,
                    **attrs,
                })
                a = self._agg.setdefault(
                    name, {"count": 0, "total_seconds": 0.0, "max_seconds": 0.0}
                )
                a["count"] += 1
                a["total_seconds"] += dt
                a["max_seconds"] = max(a["max_seconds"], dt)
                if session is not None:
                    a = self._sagg.setdefault(session, {}).setdefault(
                        name,
                        {"count": 0, "total_seconds": 0.0, "max_seconds": 0.0})
                    a["count"] += 1
                    a["total_seconds"] += dt
                    a["max_seconds"] = max(a["max_seconds"], dt)

    # ---------------------------------------------------------- counters

    def count(self, name: str, n: float = 1) -> None:
        session = self.current_session()
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n
            if session is not None:
                sc = self._scounters.setdefault(session, {})
                sc[name] = sc.get(name, 0) + n

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set a gauge to an absolute value (unlike count(), which
        accumulates): the exporter emits it with TYPE gauge.  With
        labels (e.g. the HBM sampler's device=<id>) the series lands in
        a labeled family that merges with the unlabeled sample at
        exposition, like counters.  Under an active session scope the
        last-set value is ALSO mirrored into the per-session view that
        snapshot(session=) reports — gauges are absolute, so the
        aggregate sample stays unlabeled rather than splitting into
        per-session series that would each claim the global value."""
        session = self.current_session()
        if labels and session is not None and "session" not in labels:
            labels["session"] = session
        key = (tuple(sorted((k, str(v)) for k, v in labels.items()))
               if labels else None)
        with self._lock:
            if key:
                self._lgauges.setdefault(name, {})[key] = value
            else:
                self._gauges[name] = value
            if session is not None:
                self._sgauges.setdefault(session, {})[name] = value

    def open_spans(self) -> list[dict]:
        """Spans entered but not yet exited, oldest first, with
        seconds_so_far — the black box snapshots these at fault time
        (utils/blackbox.py post-mortem bundles)."""
        now = time.time()
        with self._lock:
            spans = [dict(v) for v in self._open.values()]
        spans.sort(key=lambda s: s["t0"])
        for s in spans:
            s["seconds_so_far"] = round(max(now - s.pop("t0"), 0.0), 6)
        return spans

    def dropped_events(self) -> float:
        """Spans evicted from the full ring so far
        (tracer_events_dropped_total) — /readyz surfaces this as
        tracerDroppedEvents when nonzero."""
        with self._lock:
            return float(self._counters.get(
                "tracer_events_dropped_total", 0))

    def counter_totals(self) -> dict[str, float]:
        """Every counter flattened to one {key: value} dict: plain
        counters under their name, labeled series under
        name{k=v,...}.  The black box captures this at wave start and
        diffs at dump time — the per-wave counter deltas a post-mortem
        carries."""
        with self._lock:
            out = dict(self._counters)
            for name, series in self._lcounters.items():
                for key, v in series.items():
                    if not key:
                        out[name] = out.get(name, 0) + v
                        continue
                    flat = ",".join(f"{k}={lv}" for k, lv in key)
                    out[f"{name}{{{flat}}}"] = v
        return out

    def inc(self, name: str, n: float = 1, **labels) -> None:
        """Labeled counter increment; identical label sets merge
        regardless of keyword order.  Under an active session scope a
        session label is folded in (unless the caller set one)."""
        session = self.current_session()
        if session is not None and "session" not in labels:
            labels["session"] = session
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            series = self._lcounters.setdefault(name, {})
            series[key] = series.get(key, 0) + n

    def labeled_totals(self, name: str, label: str) -> dict[str, float]:
        """Sum one labeled counter's series grouped by `label`'s value
        (series without the label fold under "").  Powers the
        per-session speculative accept-rate surface on /api/v1/sessions
        and `bench --serve` without a full snapshot()."""
        out: dict[str, float] = {}
        with self._lock:
            series = self._lcounters.get(name, {})
            for key, v in series.items():
                val = dict(key).get(label, "")
                out[val] = out.get(val, 0) + v
        return out

    # --------------------------------------------------------- histograms

    def observe(self, name: str, value: float, n: int = 1, **labels) -> None:
        """Histogram observation (n identical observations at once — the
        batched waves amortize one wall time over many pods).  Buckets
        come from BUCKETS[name] (upstream layouts) or the default
        exponential ladder."""
        if n <= 0:
            return
        session = self.current_session()
        if session is not None and "session" not in labels:
            labels["session"] = session
        key = tuple(sorted((k, str(v)) for k, v in labels.items()))
        with self._lock:
            bounds = self._hist_bounds.get(name)
            if bounds is None:
                bounds = self._hist_bounds[name] = BUCKETS.get(
                    name, _DEFAULT_BUCKETS)
            series = self._hists.setdefault(name, {})
            h = series.get(key)
            if h is None:
                h = series[key] = _Hist(len(bounds))
            i = 0
            while i < len(bounds) and value > bounds[i]:
                i += 1
            h.counts[i] += n
            h.sum += value * n
            h.count += n

    # ------------------------------------------------------------ export

    def events(self, limit: int = 200) -> list[dict]:
        with self._lock:
            evs = list(self._events)
        return evs[-limit:]

    # the span names that bound the wave's device window (the replay /
    # speculative stream holds the device scan) vs its host-side work
    # (commit, decode, fetch, compile).  commit_stream runs on the
    # worker DURING the device window — the overlap counter quantifies
    # how much of the host total was hidden inside it.
    _DEVICE_WINDOW_SPANS = ("replay_and_decode_stream", "device_replay")
    _HOST_SPANS = ("compile_workload", "commit_and_reflect",
                   "commit_stream", "decode_chunk", "decode_lazy",
                   "d2h_fetch")

    def time_split(self, session: str | None = None) -> dict:
        """Per-wave device-window vs host-time split, derived from the
        span aggregates (docs/metrics.md device telemetry): total
        seconds inside the device-replay window, total host-side
        commit/decode/compile seconds, the overlapped share (commit
        work hidden inside the replay window), and the wave count to
        amortize by.  Cumulative since the last reset; session=<id>
        reads the per-session aggregates."""
        with self._lock:
            agg = self._sagg.get(session, {}) if session is not None \
                else self._agg
            device = sum(agg[n]["total_seconds"]
                         for n in self._DEVICE_WINDOW_SPANS if n in agg)
            host = sum(agg[n]["total_seconds"]
                       for n in self._HOST_SPANS if n in agg)
            waves = sum(agg[n]["count"]
                        for n in self._DEVICE_WINDOW_SPANS if n in agg)
            cnt = (self._scounters.get(session, {}) if session is not None
                   else self._counters)
            overlap = cnt.get("commit_stream_overlap_seconds", 0.0)
        return {
            "device_window_seconds": round(device, 6),
            "host_seconds": round(host, 6),
            "overlapped_seconds": round(float(overlap), 6),
            "waves": waves,
        }

    def summary(self) -> dict:
        """Back-compat aggregate view: span aggregates + plain counters
        (the pre-flight-recorder shape; snapshot() adds the labeled
        families)."""
        with self._lock:
            spans = {
                k: {**v, "avg_seconds": v["total_seconds"] / max(v["count"], 1)}
                for k, v in self._agg.items()
            }
            return {"spans": spans, "counters": dict(self._counters)}

    def snapshot(self, session: str | None = None) -> dict:
        """Full metrics snapshot: summary() plus labeled counters and
        histogram series — what /api/v1/metrics, the SSE stream and the
        bench artifact emit.  With session=<id>, every family is
        filtered to that session's view: spans/counters come from the
        per-session tallies, labeled counters and histograms keep only
        series whose session label matches (docs/metrics.md)."""
        if session is not None:
            skey = ("session", str(session))
            with self._lock:
                sagg = {
                    k: {**v,
                        "avg_seconds": v["total_seconds"] / max(v["count"], 1)}
                    for k, v in self._sagg.get(session, {}).items()
                }
                out = {
                    "session": str(session),
                    "spans": sagg,
                    "counters": dict(self._scounters.get(session, {})),
                    "time": time.time(),
                    # the session's gauge view: last values set under
                    # its scope, plus labeled series carrying its label
                    "gauges": dict(self._sgauges.get(session, {})),
                    "labeled_gauges": {
                        name: [{"labels": dict(key), "value": v}
                               for key, v in sorted(series.items())
                               if skey in key]
                        for name, series in sorted(self._lgauges.items())
                        if any(skey in key for key in series)
                    },
                    "labeled_counters": {
                        name: [{"labels": dict(key), "value": v}
                               for key, v in sorted(series.items())
                               if skey in key]
                        for name, series in sorted(self._lcounters.items())
                        if any(skey in key for key in series)
                    },
                    "histograms": {
                        name: {
                            "buckets": list(self._hist_bounds[name]),
                            "series": [
                                {"labels": dict(key), "counts": list(h.counts),
                                 "sum": round(h.sum, 9), "count": h.count}
                                for key, h in sorted(series.items())
                                if skey in key
                            ],
                        }
                        for name, series in sorted(self._hists.items())
                        if any(skey in key for key in series)
                    },
                }
            out["time_split"] = self.time_split(session)
            return out
        out = self.summary()
        with self._lock:
            out["time"] = time.time()
            out["gauges"] = dict(self._gauges)
            out["labeled_gauges"] = {
                name: [{"labels": dict(key), "value": v}
                       for key, v in sorted(series.items())]
                for name, series in sorted(self._lgauges.items())
            }
            out["labeled_counters"] = {
                name: [{"labels": dict(key), "value": v}
                       for key, v in sorted(series.items())]
                for name, series in sorted(self._lcounters.items())
            }
            out["histograms"] = {
                name: {
                    "buckets": list(self._hist_bounds[name]),
                    "series": [
                        {"labels": dict(key), "counts": list(h.counts),
                         "sum": round(h.sum, 9), "count": h.count}
                        for key, h in sorted(series.items())
                    ],
                }
                for name, series in sorted(self._hists.items())
            }
        out["time_split"] = self.time_split()
        return out

    # ------------------------------------------------------- prometheus

    @staticmethod
    def _render_labels(pairs: tuple, extra: str = "") -> str:
        parts = [f'{k}="{escape_label_value(v)}"' for k, v in pairs]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""

    def prometheus_text(self) -> str:
        """Prometheus text exposition (the observable analogue of the
        upstream scheduler's /metrics).  Always passes
        validate_exposition(): # HELP/# TYPE per family, sanitized
        metric names, escaped label values, cumulative histogram
        buckets ending at +Inf."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            lgauges = {n: dict(s) for n, s in self._lgauges.items()}
            lcounters = {n: dict(s) for n, s in self._lcounters.items()}
            hists = {
                n: (self._hist_bounds[n],
                    {k: (list(h.counts), h.sum, h.count)
                     for k, h in s.items()})
                for n, s in self._hists.items()
            }
            aggs = {k: dict(v) for k, v in self._agg.items()}
        out: list[str] = []

        def family(name: str, mtype: str, help_key: str | None = None) -> str:
            m = sanitize_metric_name(f"{_PREFIX}_{name}")
            h = _HELP.get(help_key or name, f"{name} ({mtype}).")
            out.append(f"# HELP {m} {_escape_help(h)}")
            out.append(f"# TYPE {m} {mtype}")
            return m

        # one family per counter NAME: a name incremented both plain
        # (sessionless paths) and labeled (session scopes fold a session
        # label in) must emit ONE # HELP/# TYPE block — the unlabeled
        # sample first, then the labeled series (duplicate TYPE lines
        # would fail validate_exposition)
        for name in sorted(set(counters) | set(lcounters)):
            m = family(name, "counter")
            if name in counters:
                out.append(f"{m} {_fmt_float(counters[name])}")
            for key, v in sorted(lcounters.get(name, {}).items()):
                out.append(f"{m}{self._render_labels(key)} {_fmt_float(v)}")
        # gauges merge plain + labeled series (the HBM sampler sets the
        # per-device labeled samples AND the unlabeled aggregate) into
        # one family, exactly like counters above
        for name in sorted(set(gauges) | set(lgauges)):
            m = family(name, "gauge")
            if name in gauges:
                out.append(f"{m} {_fmt_float(gauges[name])}")
            for key, v in sorted(lgauges.get(name, {}).items()):
                out.append(f"{m}{self._render_labels(key)} {_fmt_float(v)}")
        for name, (bounds, series) in sorted(hists.items()):
            m = family(name, "histogram")
            for key, (bcounts, hsum, hcount) in sorted(series.items()):
                cum = 0
                for bound, c in zip((*bounds, float("inf")), bcounts):
                    cum += c
                    le = f'le="{_fmt_le(bound)}"'
                    out.append(
                        f"{m}_bucket{self._render_labels(key, le)} {cum}")
                out.append(f"{m}_sum{self._render_labels(key)} "
                           f"{_fmt_float(hsum)}")
                out.append(f"{m}_count{self._render_labels(key)} {hcount}")
        for name, a in sorted(aggs.items()):
            base = f"span_{name}"
            m = family(f"{base}_seconds_total", "counter", help_key=base)
            out.append(f"{m} {_fmt_float(a['total_seconds'])}")
            m = family(f"{base}_count", "counter", help_key=base)
            out.append(f"{m} {_fmt_float(a['count'])}")
            m = family(f"{base}_seconds_max", "gauge", help_key=base)
            out.append(f"{m} {_fmt_float(a['max_seconds'])}")
        return "\n".join(out) + "\n"

    # --------------------------------------------------------- perfetto

    def perfetto(self, limit: int | None = None,
                 session: str | None = None,
                 trace_id: str | None = None) -> dict:
        """chrome://tracing / Perfetto JSON of the recorded span tree.

        Complete events ("ph": "X") on per-thread tracks; ts/dur in
        microseconds since the tracer epoch.  Span/parent ids ride in
        args so the tree survives even across thread tracks (the
        commit worker's commit_stream spans visibly overlap the
        replay_and_decode_stream parent on another track —
        docs/metrics.md walkthrough).  Black-box events (wave faults,
        autopilot decisions, speculative rounds) ride along as instant
        ("ph": "i") events on the same timeline, so a chrome://tracing
        load shows WHAT happened inline with WHERE the wave was."""
        with self._lock:
            evs = list(self._events)
            tids = dict(self._tids)
        # black-box events become instants on the correlated timeline;
        # a function-level import — blackbox imports tracing at module
        # level, so the reverse edge must stay lazy
        from .blackbox import BLACKBOX
        instants = BLACKBOX.events()
        if session is not None:
            # ?session= filtering (docs/metrics.md): only spans recorded
            # under that session's scope — filtered BEFORE the limit cut
            # so a busy neighbor can't push this session's spans out of
            # the window
            evs = [ev for ev in evs if ev.get("session") == str(session)]
            instants = [ev for ev in instants
                        if ev.get("session") == str(session)]
        if trace_id is not None:
            # ?trace_id= filtering: the causal slice of ONE request —
            # spans and instants stamped with that id, across sessions
            # (a fused dispatch lists every participant's trace id)
            tid_s = str(trace_id)

            def _matches(ev: dict) -> bool:
                if ev.get("trace_id") == tid_s:
                    return True
                traces = ev.get("traces")
                return isinstance(traces, (list, tuple)) and tid_s in traces

            evs = [ev for ev in evs if _matches(ev)]
            instants = [ev for ev in instants if _matches(ev)]
        if limit is not None:
            evs = evs[-limit:] if limit > 0 else []  # evs[-0:] is ALL
            instants = instants[-limit:] if limit > 0 else []
        pid = os.getpid()
        trace: list[dict] = [{
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": "kss-tpu-simulator"},
        }]
        for tid, tname in sorted(tids.values()):
            trace.append({"name": "thread_name", "ph": "M", "pid": pid,
                          "tid": tid, "args": {"name": tname}})
        for ev in evs:
            if "span_id" not in ev:
                continue
            args = {k: v for k, v in ev.items()
                    if k not in ("name", "t", "ts", "seconds", "tid")}
            trace.append({
                "name": ev["name"], "cat": "wave", "ph": "X",
                "ts": int(ev["ts"] * 1e6),
                "dur": max(1, int(ev["seconds"] * 1e6)),
                "pid": pid, "tid": ev["tid"], "args": args,
            })
        for ev in instants:
            # black-box events carry wall time; place them on the span
            # timeline via the tracer's own wall/perf epoch pair
            args = {k: v for k, v in ev.items() if k not in ("kind", "t")}
            trace.append({
                "name": ev.get("kind", "event"), "cat": "blackbox",
                "ph": "i", "s": "p",
                "ts": max(0, int((ev.get("t", self._epoch)
                                  - self._epoch) * 1e6)),
                "pid": pid, "tid": 0, "args": args,
            })
        return {"traceEvents": trace, "displayTimeUnit": "ms"}

    def reset(self) -> None:
        with self._lock:
            self._events.clear()
            self._agg.clear()
            self._counters.clear()
            self._gauges.clear()
            self._lgauges.clear()
            self._lcounters.clear()
            self._hists.clear()
            self._hist_bounds.clear()
            self._scounters.clear()
            self._sagg.clear()
            self._sgauges.clear()
            self._open.clear()
            self._session_traces.clear()

    # -------------------------------------------------------- XLA profile

    def start_xla_profile(self, log_dir: str) -> None:
        """Start a PyTorch profile (torch.profiler: CPU activity, and CUDA's,
        every kernel on the card, where one is present) that
        stop_xla_profile writes into log_dir.  The name is the JAX
        tracer's (an XLA profile there), which the server calls.  A second
        start raises ProfileStateError."""
        with self._profile_lock:
            if self._profile_dir is not None:
                raise ProfileStateError(
                    f"profile already running into {self._profile_dir}")
            # the profiler starts under _profile_lock BY DESIGN: the lock
            # exists solely to make the is-running check and the start one
            # transition (409 on double start); nothing on the scheduling
            # path ever takes it
            session = _ProfileSession(log_dir)  # kss-analyze: allow(device-under-lock)
            self._profile, self._profile_dir = session, log_dir

    def stop_xla_profile(self) -> str:
        """Stop the running profile -> the path of its Chrome trace, written
        into the start's log_dir.  Without a running profile raises
        ProfileStateError."""
        with self._profile_lock:
            if self._profile_dir is None:
                raise ProfileStateError("no profile running")
            session, self._profile, self._profile_dir = self._profile, None, None
        return session.stop()

    @property
    def profiling(self) -> bool:
        return self._profile_dir is not None


# ------------------------------------------------- exposition validator


def _parse_label_body(body: str) -> list[tuple[str, str]]:
    """Parse the inside of {...}, honoring \\", \\\\ and \\n escapes.
    Raises ValueError on malformed input."""
    pairs: list[tuple[str, str]] = []
    i, n = 0, len(body)
    while i < n:
        j = body.find("=", i)
        if j < 0:
            raise ValueError(f"label without '=': {body[i:]!r}")
        name = body[i:j]
        if not _LABEL_NAME_RE.match(name):
            raise ValueError(f"invalid label name {name!r}")
        if j + 1 >= n or body[j + 1] != '"':
            raise ValueError(f"unquoted label value after {name!r}")
        i = j + 2
        val: list[str] = []
        while True:
            if i >= n:
                raise ValueError(f"unterminated label value for {name!r}")
            c = body[i]
            if c == "\\":
                if i + 1 >= n or body[i + 1] not in ('"', "\\", "n"):
                    raise ValueError(f"bad escape in label value for {name!r}")
                val.append({"\\": "\\", '"': '"', "n": "\n"}[body[i + 1]])
                i += 2
            elif c == '"':
                i += 1
                break
            elif c == "\n":
                raise ValueError("raw newline in label value")
            else:
                val.append(c)
                i += 1
        pairs.append((name, "".join(val)))
        if i < n:
            if body[i] != ",":
                raise ValueError(f"expected ',' between labels at {body[i:]!r}")
            i += 1
    return pairs


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"          # metric name
    r"(?:\{(.*)\})?"                         # optional label body
    r" (NaN|[+-]?Inf|[+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)"  # value
    r"(?: (-?[0-9]+))?$"                     # optional timestamp
)


def validate_exposition(text: str) -> dict:
    """Strict Prometheus text-format (0.0.4) validator.

    Checks: final newline; # HELP/# TYPE syntax, at most one each per
    family and both before the family's samples; valid metric/label
    names; quoted + escaped label values; parseable sample values; no
    duplicate label names per sample; family samples not interleaved;
    histogram families carry cumulative _bucket series per label set
    ending at le="+Inf", with matching _count and a _sum.

    Returns {family: {"type", "help", "samples": [(name, labels, value)]}}.
    Raises ValueError with the offending line on any violation.
    """
    if not text.endswith("\n"):
        raise ValueError("exposition must end with a newline")
    families: dict[str, dict] = {}
    current: str | None = None
    closed: set[str] = set()

    def fam(name: str) -> dict:
        return families.setdefault(
            name, {"type": None, "help": None, "samples": []})

    for lineno, line in enumerate(text.split("\n")[:-1], 1):
        if line == "":
            continue
        try:
            if line.startswith("# HELP ") or line.startswith("# TYPE "):
                kind = line[2:6]
                rest = line[7:]
                name, _, payload = rest.partition(" ")
                if not _METRIC_NAME_RE.match(name):
                    raise ValueError(f"invalid metric name {name!r}")
                f = fam(name)
                if f["samples"]:
                    raise ValueError(f"# {kind} after samples of {name}")
                if kind == "HELP":
                    if f["help"] is not None:
                        raise ValueError(f"duplicate # HELP for {name}")
                    f["help"] = payload
                else:
                    if f["type"] is not None:
                        raise ValueError(f"duplicate # TYPE for {name}")
                    if payload not in ("counter", "gauge", "histogram",
                                       "summary", "untyped"):
                        raise ValueError(f"invalid type {payload!r}")
                    f["type"] = payload
                continue
            if line.startswith("#"):
                continue  # plain comment
            m = _SAMPLE_RE.match(line)
            if m is None:
                raise ValueError("unparseable sample line")
            name, body, value = m.group(1), m.group(2), m.group(3)
            base = name
            for suffix in ("_bucket", "_sum", "_count"):
                cand = name[: -len(suffix)] if name.endswith(suffix) else None
                if cand and families.get(cand, {}).get("type") == "histogram":
                    base = cand
                    break
            labels = _parse_label_body(body) if body else []
            seen = set()
            for k, _v in labels:
                if k in seen:
                    raise ValueError(f"duplicate label {k!r}")
                seen.add(k)
            float(value.replace("Inf", "inf"))  # parse check
            if base != current:
                if base in closed:
                    raise ValueError(f"samples of {base} interleaved")
                if current is not None:
                    closed.add(current)
                current = base
            fam(base)["samples"].append((name, dict(labels), value))
        except ValueError as e:
            raise ValueError(f"line {lineno}: {e} — {line!r}") from None

    for name, f in families.items():
        if f["type"] != "histogram":
            continue
        series: dict[tuple, dict] = {}
        for sname, labels, value in f["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            s = series.setdefault(key, {"buckets": [], "sum": None,
                                        "count": None})
            if sname == name + "_bucket":
                if "le" not in labels:
                    raise ValueError(f"{name}_bucket without le label")
                s["buckets"].append(
                    (float(labels["le"].replace("Inf", "inf")), float(value)))
            elif sname == name + "_sum":
                s["sum"] = float(value)
            elif sname == name + "_count":
                s["count"] = float(value)
            else:
                raise ValueError(f"stray sample {sname!r} in histogram {name}")
        for key, s in series.items():
            if not s["buckets"] or s["buckets"][-1][0] != float("inf"):
                raise ValueError(f"histogram {name}{dict(key)} lacks a "
                                 "+Inf bucket")
            les = [le for le, _ in s["buckets"]]
            if les != sorted(les):
                raise ValueError(f"histogram {name} buckets out of order")
            counts = [c for _, c in s["buckets"]]
            if counts != sorted(counts):
                raise ValueError(f"histogram {name} buckets not cumulative")
            if s["sum"] is None or s["count"] is None:
                raise ValueError(f"histogram {name} missing _sum or _count")
            if s["count"] != counts[-1]:
                raise ValueError(f"histogram {name} _count != +Inf bucket")
    return families


TRACER = Tracer()
