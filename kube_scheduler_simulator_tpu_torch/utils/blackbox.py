"""Wave black box: crash-consistent post-mortem capture + device telemetry.

A copy of kube_scheduler_simulator_tpu/utils/blackbox.py, host code with its
imports rewired to the port. Its device probe reads `torch.cuda.memory_stats()`.

The engine's own behavior is its least observable part exactly when it
matters most: the degradation ladder and the speculative round
loop make load-bearing decisions — retry, degrade, fall back to
the sequential scan — whose evidence evaporates the moment they fire,
and nothing ever read device memory even though the HBM budget actively
spills chunks.  This module is the always-on flight-data recorder:

  * `BlackBox` — a fixed-size, lock-light ring of structured engine
    events (wave start/end, speculative rounds with batch size / accept
    fraction / ladder rung, fault trips with seam + classification,
    degradation transitions, retry suffixes, budget spills, compile
    builds/quarantines, session admission/eviction).  Recording is one
    short lock hold and a dict append; `KSS_TPU_BLACKBOX=0` turns it
    into a single global load + compare (the bench A/B asserts the
    enabled overhead stays within noise).
  * post-mortem **bundles**: on `_WaveAbort`, a degradation step, a
    chaos-gate failure or an explicit `GET /api/v1/debug/dump`, the
    ring is snapshotted together with the tracer's OPEN spans at the
    time of fault, the labeled-counter deltas since the wave started,
    the armed fault plan, every `KSS_TPU_*` env knob and a device-state
    fingerprint (per-device `memory_stats()`), JSON-immutable.  Wave
    aborts auto-write the bundle to `KSS_TPU_BLACKBOX_DIR` so a crashed
    wave ships its own evidence (docs/fault-injection.md).
  * `validate_dump()` — the schema check `make blackbox-smoke`, the
    chaos harness and the tests share.
  * `SLOTracker` — rolling per-session p50/p99 wave latency and
    cycles/s over a `KSS_TPU_SLO_WINDOW` window, surfaced on
    `/api/v1/sessions` and `/readyz` (docs/metrics.md).
  * `DeviceTelemetry` — a background sampler reading
    `torch.cuda.memory_stats()` of every visible card into `hbm_bytes_in_use` /
    `hbm_peak_bytes` gauges (per-device labels + an aggregate), with an
    EXPLICIT `hbm_stats_available 0` no-op where the backend has no
    memory stats (no card) instead of silently absent gauges.

Import discipline: this module depends only on utils.tracing,
utils.history and utils.env — everything above it (engine, replay,
speculative, faults, sessions) records INTO it, never the other way
around.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import history as _history
from .env import env_float, env_int
from .history import HISTORY
from .tracing import TRACER

DUMP_VERSION = 1

# KSS_TPU_BLACKBOX=0 turns record() into one global load + compare —
# the same zero-overhead shape as the unarmed fault_point.  Module
# global (not an instance attr) so the hot-path check never chases a
# pointer; set_enabled() is the bench A/B's lever.
_ENABLED = os.environ.get("KSS_TPU_BLACKBOX", "1") != "0"


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Toggle recording (the bench overhead A/B's same-process lever;
    operators use KSS_TPU_BLACKBOX=0).  Returns the previous value.
    The tracer's open-span bookkeeping follows the same flag."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    from . import tracing as _tracing

    _tracing.BLACKBOX_OPEN_SPANS = bool(on)
    return prev


def _env_knobs() -> dict[str, str]:
    """Every KSS_TPU_* knob in force — part of every bundle, so a dump
    is reproducible without asking the operator what they had set."""
    return {k: v for k, v in sorted(os.environ.items())
            if k.startswith("KSS_TPU")}


def describe_exception(exc: BaseException | None) -> dict | None:
    """{type, message, seam, classification} for a bundle's cause."""
    if exc is None:
        return None
    from .faults import classify_fault

    out = {"type": type(exc).__name__,
           "message": str(exc)[:500],
           "classification": classify_fault(exc)}
    seam = getattr(exc, "seam", None)
    if seam:
        out["seam"] = seam
    return out


def device_fingerprint() -> dict:
    """Per-device state at dump/sample time: platform, kind, and
    `torch.cuda.memory_stats()` (bytes in use / peak / reserved) for
    every visible card.  `hbm_available` is an EXPLICIT flag: without a
    card there are no memory stats and the fingerprint says so instead
    of silently omitting the numbers."""
    try:
        import torch

        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    except Exception as e:  # no CUDA runtime
        return {"available": False, "hbm_available": False,
                "error": f"{type(e).__name__}: {e}"[:200]}
    out = {"available": True, "backend": "cuda" if n else "cpu",
           "hbm_available": False, "devices": []}
    if not n:
        out["devices"].append({"id": 0, "platform": "cpu", "kind": "cpu",
                               "memory": None})
        return out
    for i in range(n):
        ent = {"id": i, "platform": "gpu",
               "kind": str(torch.cuda.get_device_name(i))}
        try:
            stats = torch.cuda.memory_stats(i)
        except Exception:
            stats = None
        if stats:
            ent["memory"] = {
                "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
                "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
                "bytes_reserved": int(stats.get("reserved_bytes.all.current", 0)),
            }
            out["hbm_available"] = True
        else:
            ent["memory"] = None
        out["devices"].append(ent)
    return out


class BlackBox:
    """The event ring + bundle assembler.  One instance per process
    (`BLACKBOX`); events carry the recording thread's tracer session
    scope so multi-session dumps stay attributable."""

    def __init__(self, capacity: int | None = None):
        self._cap = (capacity if capacity is not None
                     else max(env_int("KSS_TPU_BLACKBOX_CAPACITY", 4096), 64))
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=self._cap)
        self._dropped = 0
        self._seq = 0
        # per-session counter baselines captured at wave start, so a
        # dump reports the DELTAS over the failing wave, not process
        # lifetime totals (None = sessionless direct engine use)
        self._baselines: dict[str | None, dict[str, float]] = {}
        # the most recent stored bundles (dump()); immutable via a JSON
        # round trip so a dump never aliases live engine state
        self._dumps: deque = deque(maxlen=8)
        self._dump_n = 0  # filename uniquifier, allocated under _mu

    # ---------------------------------------------------------- record

    def record(self, kind: str, **fields) -> None:
        """Append one structured event.  Disabled: one global load."""
        if not _ENABLED:
            return
        ev = {"kind": kind, "t": round(time.time(), 6)}
        sid = TRACER.current_session()
        if sid is not None:
            ev["session"] = sid
        tid = TRACER.current_trace()
        if tid is not None:
            ev["trace_id"] = tid
        ev.update(fields)
        with self._mu:
            self._seq += 1
            ev["seq"] = self._seq
            if len(self._ring) == self._cap:
                self._dropped += 1
            self._ring.append(ev)

    def wave_start(self, session: str | None, **fields) -> None:
        """Mark a wave's start: records the event AND captures the
        counter baseline the wave's dump computes deltas against."""
        if not _ENABLED:
            return
        base = TRACER.counter_totals()
        with self._mu:
            self._baselines[session] = base
        self.record("wave.start", **fields)

    # ------------------------------------------------------------ read

    def events(self, session: str | None = None,
               limit: int | None = None) -> list[dict]:
        with self._mu:
            evs = list(self._ring)
        if session is not None:
            evs = [e for e in evs if e.get("session") == session]
        return evs[-limit:] if limit else evs

    def dropped(self) -> int:
        with self._mu:
            return self._dropped

    def counter_deltas(self, session: str | None = None) -> dict[str, float]:
        """Flight-recorder counter movement since the session's last
        wave_start (plain + flattened labeled counters; zero-delta
        entries omitted)."""
        with self._mu:
            base = dict(self._baselines.get(session) or {})
        cur = TRACER.counter_totals()
        return {k: round(v - base.get(k, 0), 6)
                for k, v in cur.items() if v != base.get(k, 0)}

    # ------------------------------------------------------------ dump

    def bundle(self, reason: str, cause: BaseException | None = None,
               session: str | None = None) -> dict:
        """Build (but do not store) a post-mortem bundle."""
        from .faults import current_plan

        plan = current_plan()
        # open spans AT THE TIME OF FAULT: the tracer stashes the
        # open-span tree on the exception at the innermost span it
        # unwinds through — by the time the wave protocol builds this
        # bundle every span has closed, so the live view would be empty
        open_spans = getattr(cause, "_kss_open_spans", None)
        if open_spans is None:
            open_spans = TRACER.open_spans()
        if session is not None:
            # same isolation rule as the event ring: a session-scoped
            # bundle must not show a neighbor's in-flight spans
            open_spans = [s for s in open_spans
                          if s.get("session") == session]
        doc = {
            "version": DUMP_VERSION,
            "reason": reason,
            "time": round(time.time(), 6),
            "session": session,
            "cause": describe_exception(cause),
            # session-scoped bundles carry ONLY that session's events —
            # in multi-tenant serving one tenant's dump must not leak a
            # neighbor's activity (the per-session /debug/dump alias)
            "events": self.events(session=session),
            "events_dropped": self.dropped(),
            "open_spans": open_spans,
            "counter_deltas": self.counter_deltas(session),
            "fault_plan": plan.stats() if plan is not None else None,
            "env": _env_knobs(),
            "device": device_fingerprint(),
            # the trailing telemetry-history window (utils/history.py):
            # a wave-abort dump answers "what was trending before this"
            # by itself — p99 creep, spill bursts, autopilot moves.
            # Session-scoped bundles keep only that session's series
            # (the same isolation rule as events/open_spans above).
            "history": HISTORY.tail(64, session=session),
        }
        # JSON round trip: the bundle must be immutable evidence, never
        # an aliased view of live dicts a later wave keeps mutating
        return json.loads(json.dumps(doc, default=str))

    def dump(self, reason: str, cause: BaseException | None = None,
             session: str | None = None, write: bool = False,
             directory: str | None = None) -> tuple[dict, str | None]:
        """Snapshot a bundle, store it in the recent-dumps ring, and —
        when `write` and a directory is available (`directory` arg or
        KSS_TPU_BLACKBOX_DIR) — persist it to disk.  Returns
        (bundle, path-or-None).  Never raises: a failing dump must not
        mask the fault it describes."""
        try:
            doc = self.bundle(reason, cause=cause, session=session)
        except Exception as e:  # pragma: no cover - defensive
            doc = {"version": DUMP_VERSION, "reason": reason,
                   "time": time.time(), "session": session,
                   "error": f"bundle failed: {type(e).__name__}: {e}"[:300]}
        path = None
        if write:
            d = directory or os.environ.get("KSS_TPU_BLACKBOX_DIR")
            if d:
                try:
                    os.makedirs(d, exist_ok=True)
                    stamp = time.strftime("%Y%m%d-%H%M%S")
                    # pid + a locked counter: two aborts in the same
                    # second (or two processes sharing the dir) must
                    # never overwrite each other's evidence
                    with self._mu:
                        self._dump_n += 1
                        n = self._dump_n
                    fname = (f"blackbox-{stamp}-{os.getpid()}-{n}"
                             f"-{reason}.json")
                    path = os.path.join(d, fname)
                    with open(path, "w", encoding="utf-8") as fh:
                        json.dump(doc, fh, indent=1)
                # a full disk / bad dir must not mask the wave fault
                # kss-analyze: allow(swallowed-exception)
                except OSError:
                    path = None
        doc["path"] = path
        with self._mu:
            self._dumps.append(doc)
        TRACER.inc("blackbox_dumps_total", reason=reason)
        return doc, path

    def recent_dumps(self) -> list[dict]:
        """Metadata of stored bundles, newest last (the full bundle is
        on disk at `path`, or retrievable live via bundle())."""
        with self._mu:
            dumps = list(self._dumps)
        return [{k: d.get(k) for k in
                 ("reason", "time", "session", "cause", "path")}
                for d in dumps]

    def last_dump(self) -> dict | None:
        with self._mu:
            return self._dumps[-1] if self._dumps else None

    def drop_session(self, session: str | None) -> None:
        """Release a torn-down session's counter baseline (session
        eviction calls this — per-session state must not outlive the
        session on a churning server)."""
        with self._mu:
            self._baselines.pop(session, None)

    def reset(self) -> None:
        """Tests only: clear the ring, baselines and stored dumps."""
        with self._mu:
            self._ring.clear()
            self._dumps.clear()
            self._baselines.clear()
            self._dropped = 0


BLACKBOX = BlackBox()


# ------------------------------------------------------- dump validation


_REQUIRED_KEYS = ("version", "reason", "time", "events", "open_spans",
                  "counter_deltas", "env", "device")


def validate_dump(doc: dict, require_fault: bool = False,
                  require_rounds: bool = False) -> dict:
    """Schema check for a post-mortem bundle — shared by the tests,
    `make blackbox-smoke` and the chaos harness.  Raises ValueError
    with the first violation; returns {kinds: {kind: count}} on
    success.  `require_fault` additionally asserts a fault trip with
    seam + classification and a cause; `require_rounds` asserts the
    speculative round history survived into the dump."""
    for k in _REQUIRED_KEYS:
        if k not in doc:
            raise ValueError(f"dump missing key {k!r}")
    if doc["version"] != DUMP_VERSION:
        raise ValueError(f"dump version {doc['version']!r} != {DUMP_VERSION}")
    if not isinstance(doc["events"], list):
        raise ValueError("dump events is not a list")
    kinds: dict[str, int] = {}
    for ev in doc["events"]:
        if "kind" not in ev or "t" not in ev or "seq" not in ev:
            raise ValueError(f"malformed event {ev!r}")
        kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
        if ev["kind"] == "fault.trip":
            for field in ("seam", "classification", "error"):
                if field not in ev:
                    raise ValueError(f"fault.trip missing {field!r}: {ev!r}")
        if ev["kind"] == "speculative.round":
            for field in ("batch", "accepted", "rung", "accept_fraction"):
                if field not in ev:
                    raise ValueError(
                        f"speculative.round missing {field!r}: {ev!r}")
        if ev["kind"] == "autopilot.decide":
            # every autopilot decision is structured evidence
            # (control/autopilot.py): which effector moved which
            # session from what to what, and why
            for field in ("effector", "session", "from", "to", "reason"):
                if field not in ev:
                    raise ValueError(
                        f"autopilot.decide missing {field!r}: {ev!r}")
            # provenance: when the decision carries an evidence block
            # it must be structured (the planes the effector read) and
            # any cited history index must be an integer
            evd = ev.get("evidence")
            if evd is not None:
                if not isinstance(evd, dict):
                    raise ValueError(
                        f"autopilot.decide evidence not a dict: {ev!r}")
                hidx = evd.get("historyIndex")
                if hidx is not None and not isinstance(hidx, int):
                    raise ValueError(
                        f"evidence historyIndex not an int: {ev!r}")
    if not isinstance(doc["counter_deltas"], dict):
        raise ValueError("counter_deltas is not a dict")
    hist = doc.get("history")
    if hist is not None:
        # the embedded trailing window must be the columnar shape
        # (utils/history.py): index/t arrays plus equal-length series
        # columns — never one dict per sample
        if (not isinstance(hist, dict) or "index" not in hist
                or "series" not in hist):
            raise ValueError("history window missing index/series")
        n_rows = len(hist["index"])
        if len(hist.get("t") or []) != n_rows:
            raise ValueError("history t column length != index length")
        if not isinstance(hist["series"], dict):
            raise ValueError("history series is not a dict of columns")
        for nm, col in hist["series"].items():
            if len(col) != n_rows:
                raise ValueError(
                    f"history column {nm!r} length {len(col)} != {n_rows}")
    dev = doc["device"]
    if not isinstance(dev, dict) or "hbm_available" not in dev:
        raise ValueError("device fingerprint missing hbm_available")
    if require_fault:
        if not kinds.get("fault.trip"):
            raise ValueError("dump has no fault.trip event")
        cause = doc.get("cause")
        if not cause or "classification" not in cause:
            raise ValueError("dump has no classified cause")
        # the action the protocol took must be on the record too
        if not (kinds.get("wave.retry") or kinds.get("wave.abort")
                or kinds.get("degrade")):
            raise ValueError("dump records no protocol action "
                             "(wave.retry / wave.abort / degrade)")
        if not doc["counter_deltas"]:
            raise ValueError("dump has empty counter deltas for the wave")
    if require_rounds and not kinds.get("speculative.round"):
        raise ValueError("dump has no speculative.round history")
    return {"kinds": kinds}


# ------------------------------------------------------------ SLO plane


class SLOTracker:
    """Rolling per-session wave SLOs: p50/p99 wave latency and
    cycles/s over the last KSS_TPU_SLO_WINDOW waves (default 64).
    observe_wave() is one deque append under a short lock — cheap
    enough to stay on for every wave; percentiles sort the (small)
    window only when read (/api/v1/sessions, /readyz)."""

    def __init__(self, window: int | None = None):
        self._window = (window if window is not None
                        else max(env_int("KSS_TPU_SLO_WINDOW", 64), 4))
        self._mu = threading.Lock()
        self._waves: dict[str | None, deque] = {}
        # monotonic per-session wave count: the window above freezes
        # when inflow stops, so consumers judging liveness (the
        # autopilot's shed recovery) need a counter that only moves
        # when waves actually run
        self._totals: dict[str | None, int] = {}

    def observe_wave(self, session: str | None, seconds: float,
                     pods: int) -> None:
        if pods <= 0:
            return
        with self._mu:
            dq = self._waves.get(session)
            if dq is None:
                dq = self._waves[session] = deque(maxlen=self._window)
            dq.append((seconds, pods))
            self._totals[session] = self._totals.get(session, 0) + 1

    @staticmethod
    def _pct(sorted_vals: list[float], q: float) -> float:
        i = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
        return sorted_vals[i]

    def stats(self, session: str | None) -> dict | None:
        """{waves, totalWaves, p50WaveSeconds, p99WaveSeconds,
        cyclesPerSec} over the window, or None when the session never
        ran a wave.  `totalWaves` is the lifetime count — unlike
        `waves` (window occupancy, saturates at `window`) it keeps
        moving while traffic flows, so a frozen window is detectable."""
        with self._mu:
            dq = self._waves.get(session)
            entries = list(dq) if dq else None
            total = self._totals.get(session, 0)
        if not entries:
            return None
        secs = sorted(s for s, _ in entries)
        total_s = sum(s for s, _ in entries)
        total_p = sum(p for _, p in entries)
        return {
            "waves": len(entries),
            "totalWaves": total,
            "window": self._window,
            "p50WaveSeconds": round(self._pct(secs, 0.50), 6),
            "p99WaveSeconds": round(self._pct(secs, 0.99), 6),
            "cyclesPerSec": round(total_p / total_s, 1) if total_s else None,
        }

    def set_window(self, window: int) -> int:
        """The window for sessions whose first wave comes after this call
        (KSS_TPU_SLO_WINDOW is read at import; a run that needs another,
        as the soak does, sets it in-process).  Returns the previous."""
        with self._mu:
            prev, self._window = self._window, max(int(window), 4)
        return prev

    def drop_session(self, session: str | None) -> None:
        """Release a torn-down session's window (session eviction)."""
        with self._mu:
            self._waves.pop(session, None)
            self._totals.pop(session, None)

    def snapshot(self) -> dict[str, dict]:
        """{session ("" = sessionless): stats} for every session with
        waves in the window — the /readyz surface."""
        with self._mu:
            keys = list(self._waves.keys())
        out = {}
        for k in keys:
            s = self.stats(k)
            if s is not None:
                out[k if k is not None else ""] = s
        return out

    def reset(self) -> None:
        with self._mu:
            self._waves.clear()
            self._totals.clear()


SLO = SLOTracker()


# ------------------------------------------------------- history feeder


class HistoryFeeder:
    """One tick of the observability planes -> one columnar history
    sample (utils/history.py).

    gather() reads every plane ONCE into plain dicts — SLO windows,
    per-session speculative/spill counter totals, the control-plane
    override state — and sample() derives the ring columns from them.
    The autopilot plans FROM the same returned dicts, so a decision's
    evidence cites a ring index whose values match what the effector
    read bit-for-bit (control/autopilot.py decision provenance), and
    with KSS_TPU_HISTORY=0 the planes are still returned (index -1):
    one code path, parity preserved.

    Global series are per-sample counter DELTAS (the feeder keeps its
    own baselines); per-session series are window stats / fractions at
    sample time.
    """

    # plain (unlabeled) counters whose per-sample deltas become global
    # columns; the labeled speculative/spill families are summed from
    # the per-session planes instead
    _PLAIN = ("pods_scheduled_total", "pods_unschedulable_total",
              "scheduling_waves_total")

    def __init__(self):
        self._mu = threading.Lock()
        self._base: dict[str, float] = {}

    def gather(self) -> dict:
        from ..control import CONTROLS

        return {
            "slo": SLO.snapshot(),
            "accepted": TRACER.labeled_totals(
                "speculative_accepted_total", "session"),
            "rolled": TRACER.labeled_totals(
                "speculative_rolled_back_total", "session"),
            "spilled": TRACER.labeled_totals(
                "device_chunks_spilled_total", "session"),
            "controls": CONTROLS.stats(),
        }

    def sample(self) -> tuple[int, dict]:
        """Gather the planes and append one ring sample.  Returns
        (absolute ring index or -1 when history is off, planes)."""
        planes = self.gather()
        if not _history.enabled():
            return -1, planes
        totals = TRACER.counter_totals()
        values: dict[str, float] = {}
        sums = {
            "speculative_accepted_total":
                sum(planes["accepted"].values()),
            "speculative_rolled_back_total":
                sum(planes["rolled"].values()),
            "device_chunks_spilled_total":
                sum(planes["spilled"].values()),
        }
        with self._mu:
            for name in self._PLAIN:
                cur = float(totals.get(name, 0.0))
                values[name] = cur - self._base.get(name, 0.0)
                self._base[name] = cur
            for name, cur in sums.items():
                values[name] = cur - self._base.get(name, 0.0)
                self._base[name] = cur
            # per-session accept fraction / spill delta this sample
            # (baselines keyed per session; a torn-down session's keys
            # are pruned when its counters vanish from the planes)
            for sid in set(planes["accepted"]) | set(planes["rolled"]):
                a = planes["accepted"].get(sid, 0.0)
                r = planes["rolled"].get(sid, 0.0)
                a_d = a - self._base.get(f"a\x00{sid}", 0.0)
                r_d = r - self._base.get(f"r\x00{sid}", 0.0)
                self._base[f"a\x00{sid}"] = a
                self._base[f"r\x00{sid}"] = r
                if a_d + r_d > 0:
                    values[f"spec.accept{{session={sid}}}"] = round(
                        a_d / (a_d + r_d), 6)
            for sid, sp in planes["spilled"].items():
                sp_d = sp - self._base.get(f"s\x00{sid}", 0.0)
                self._base[f"s\x00{sid}"] = sp
                values[f"spill.delta{{session={sid}}}"] = sp_d
        for sid, stats in planes["slo"].items():
            tag = f"{{session={sid}}}"
            values[f"slo.p50{tag}"] = float(stats["p50WaveSeconds"])
            values[f"slo.p99{tag}"] = float(stats["p99WaveSeconds"])
            cps = stats.get("cyclesPerSec")
            if cps is not None:
                values[f"slo.cps{tag}"] = float(cps)
        # autopilot effector state, explicit for every ACTIVE session
        # (any the SLO plane has seen plus any the control plane is
        # steering): CONTROLS.stats() omits default-state sessions, but
        # the ring must record 0.0 / 1.0 there rather than a gap — a
        # shed on/off transition reconstructs from the columns without
        # guessing what a missing row meant
        ctls = planes["controls"]
        for sid in {s for s in planes["slo"] if s} | set(ctls):
            ctl = ctls.get(sid) or {}
            tag = f"{{session={sid}}}"
            values[f"autopilot.shed{tag}"] = 1.0 if ctl.get("shed") else 0.0
            values[f"autopilot.budget_weight{tag}"] = float(
                ctl.get("budgetWeight") or 1.0)
        idx = HISTORY.append(values, t_us=int(time.time() * 1e6))
        return idx, planes

    def reset(self) -> None:
        """Tests only: forget the delta baselines."""
        with self._mu:
            self._base.clear()


FEEDER = HistoryFeeder()


# ----------------------------------------------------- device telemetry


class DeviceTelemetry:
    """Background HBM sampler: every KSS_TPU_HBM_SAMPLE_S seconds
    (default 5) read each local device's memory_stats() into

      * hbm_bytes_in_use{device=<id>} / hbm_peak_bytes{device=<id>}
        labeled gauges, plus unlabeled aggregates (sums across devices);
      * hbm_stats_available — 1 where the backend reports memory stats,
        0 as the EXPLICIT no-op marker on backends that don't (CPU).

    start() is idempotent; the thread is a daemon and samples once
    immediately, so /api/v1/metrics shows the gauges right after server
    boot.  sample_once() is the direct surface bench and tests use."""

    def __init__(self):
        self._mu = threading.Lock()
        self._thread: threading.Thread | None = None
        # each start() mints a fresh stop event captured by its loop, so
        # a stale stop() can never kill a newer sampler thread
        self._stop: threading.Event | None = None
        # start()/stop() refcount: the sampler is process-global but
        # started per server — the last stopping server ends it, an
        # earlier one must not kill a still-running neighbor's sampling
        self._refs = 0
        self._last: dict | None = None

    def sample_once(self) -> dict:
        fp = device_fingerprint()
        available = bool(fp.get("hbm_available"))
        TRACER.gauge("hbm_stats_available", 1 if available else 0)
        total_use = 0
        total_peak = 0
        if available:
            for ent in fp.get("devices", ()):
                mem = ent.get("memory") or {}
                use = mem.get("bytes_in_use")
                if use is None:
                    continue
                peak = mem.get("peak_bytes_in_use", use)
                TRACER.gauge("hbm_bytes_in_use", use,
                             device=str(ent["id"]))
                TRACER.gauge("hbm_peak_bytes", peak,
                             device=str(ent["id"]))
                total_use += use
                total_peak += peak
            TRACER.gauge("hbm_bytes_in_use", total_use)
            TRACER.gauge("hbm_peak_bytes", total_peak)
        out = {"available": available,
               "backend": fp.get("backend"),
               "bytes_in_use": total_use if available else None,
               "peak_bytes": total_peak if available else None,
               "devices": len(fp.get("devices", ()))}
        with self._mu:
            self._last = out
        return out

    def last(self) -> dict | None:
        with self._mu:
            return self._last

    def start(self, interval: float | None = None) -> None:
        """Start the sampler (idempotent).  interval <= 0 (or
        KSS_TPU_HBM_SAMPLE_S=0) disables the HBM leg; the same thread
        also feeds the telemetry history ring every
        KSS_TPU_HISTORY_SAMPLE_S seconds (utils/history.py) — two
        cadences, one thread, each with its own next-due clock.  No
        thread starts when both legs are off.  The whole start decision
        runs under the lock so two concurrent start() calls can never
        spawn two samplers, and a fresh stop event per thread means a
        racing stop() never leaves a newly started sampler dead."""
        if interval is None:
            interval = env_float("KSS_TPU_HBM_SAMPLE_S", 5.0)
        hist_iv = _history.sample_interval() if _history.enabled() else 0.0
        t = None
        with self._mu:
            self._refs += 1
            # _thread is the INTENT marker (set before start(), cleared
            # only by the last stop()): an is_alive() check would let a
            # second caller slip in between thread creation and start()
            if self._thread is None:
                if interval > 0 or hist_iv > 0:
                    stop = self._stop = threading.Event()

                    def loop():
                        inf = float("inf")
                        hbm_iv = interval if interval > 0 else inf
                        h_iv = hist_iv if hist_iv > 0 else inf
                        now = time.monotonic()
                        next_hbm = now + hbm_iv
                        next_hist = now + h_iv
                        while True:
                            wake = min(next_hbm, next_hist)
                            if stop.wait(max(wake - time.monotonic(),
                                             0.01)):
                                return
                            now = time.monotonic()
                            if now >= next_hbm:
                                try:
                                    self.sample_once()
                                # survive a backend teardown race
                                # kss-analyze: allow(swallowed-exception)
                                except Exception:
                                    pass
                                next_hbm = now + hbm_iv
                            if now >= next_hist:
                                try:
                                    FEEDER.sample()
                                # same contract as the HBM leg
                                # kss-analyze: allow(swallowed-exception)
                                except Exception:
                                    pass
                                next_hist = now + h_iv

                    t = self._thread = threading.Thread(
                        target=loop, daemon=True, name="hbm-sampler")
        self.sample_once()
        if t is not None:
            t.start()

    def stop(self) -> None:
        """Release one start() hold; the sampler thread ends when the
        last holder stops (server shutdown calls this)."""
        with self._mu:
            self._refs = max(self._refs - 1, 0)
            if self._refs:
                return
            if self._stop is not None:
                self._stop.set()
            self._thread = None


TELEMETRY = DeviceTelemetry()
