"""Columnar telemetry history ring (docs/metrics.md "History &

A copy of kube_scheduler_simulator_tpu/utils/history.py, host code with its
imports rewired to the port.
correlation").

Every observability surface before this was a point-in-time snapshot:
`/api/v1/metrics` shows totals NOW, `/api/v1/sessions` shows the SLO
window NOW, and the minute of telemetry that led up to a shed or a wave
abort evaporates between scrapes.  `TelemetryHistory` is the repo's
time axis: a fixed-capacity ring of samples where each tracked series
is ONE float64 numpy column and timestamps are ONE int64 column (the
columnar idiom — appending a sample writes one slot per column,
reading a window slices arrays; no per-sample dicts anywhere).

Samples come from two producers sharing one ring (utils/blackbox.py):

  * the `DeviceTelemetry` sampler thread appends every
    KSS_TPU_HISTORY_SAMPLE_S seconds (default 2);
  * every autopilot tick appends one sample built from the exact
    planes the controller planned from, so a decision's `evidence`
    block cites a ring index whose values match bit-for-bit
    (control/autopilot.py decision provenance).

Series naming follows the flattened-counter convention
(`utils/tracing.py counter_totals`): global series are bare names
(counter deltas per sample), per-session series carry a
`{session=<id>}` suffix (`slo.p99{session=tenant-a}`).  A series
absent at a tick stores NaN, which the JSON surfaces emit as null.

Knobs: KSS_TPU_HISTORY=0 turns sampling into a no-op (the bench A/B
baseline), KSS_TPU_HISTORY_CAPACITY sizes the ring (default 1024
samples), KSS_TPU_HISTORY_SAMPLE_S the sampler cadence.  Import
discipline: stdlib + numpy + utils.env only — everything records INTO
this module, never the other way around.
"""

from __future__ import annotations

import os
import threading

import numpy as np

from .env import env_float, env_int

# KSS_TPU_HISTORY=0 reduces sampling to one global load + compare, the
# same zero-overhead shape as KSS_TPU_BLACKBOX=0.  Module global so the
# check never chases a pointer; set_enabled() is the bench A/B's lever.
_ENABLED = os.environ.get("KSS_TPU_HISTORY", "1") != "0"


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> bool:
    """Toggle sampling (the bench overhead A/B's same-process lever;
    operators use KSS_TPU_HISTORY=0).  Returns the previous value."""
    global _ENABLED
    prev = _ENABLED
    _ENABLED = bool(on)
    return prev


def sample_interval() -> float:
    """KSS_TPU_HISTORY_SAMPLE_S: background sampler cadence in seconds
    (default 2; <=0 disables the background producer — autopilot ticks
    still append)."""
    return env_float("KSS_TPU_HISTORY_SAMPLE_S", 2.0)


def _capacity() -> int:
    return max(env_int("KSS_TPU_HISTORY_CAPACITY", 1024), 16)


class TelemetryHistory:
    """The ring itself: int64 timestamp column + one float64 column per
    series, addressed by ABSOLUTE sample index (monotonic since reset)
    so `since=` cursors survive wraparound — a reader who falls behind
    sees the window's floor move, never silently-recycled rows."""

    def __init__(self, capacity: int | None = None):
        self._cap = capacity if capacity is not None else _capacity()
        self._mu = threading.Lock()
        # microseconds since the epoch: int64 per the columnar idiom
        # (float64 seconds would quantize at ~0.1us near 2e9 anyway,
        # but the integer column keeps timestamps exact and compact)
        self._ts = np.zeros(self._cap, dtype=np.int64)
        self._cols: dict[str, np.ndarray] = {}
        self._n = 0  # absolute samples written (next write index)

    # --------------------------------------------------------- write

    def append(self, values: dict[str, float], t_us: int) -> int:
        """Write one sample (series -> value); returns its absolute
        index, or -1 when sampling is disabled.  Series not in
        `values` store NaN for this slot; a never-seen series gets a
        fresh NaN-filled column (its pre-history reads as null)."""
        if not _ENABLED:
            return -1
        with self._mu:
            slot = self._n % self._cap
            self._ts[slot] = int(t_us)
            for name, col in self._cols.items():
                col[slot] = values.get(name, np.nan)
            for name in values.keys() - self._cols.keys():
                col = np.full(self._cap, np.nan)
                col[slot] = values[name]
                self._cols[name] = col
            idx = self._n
            self._n += 1
        return idx

    # ---------------------------------------------------------- read

    @staticmethod
    def _match(name: str, session: str | None, wanted: set | None) -> bool:
        if session is not None:
            # a session filter keeps that session's labeled series plus
            # the global (unlabeled) ones — the same scoping rule as
            # /api/v1/metrics?session=
            if "{" in name and not name.endswith(f"{{session={session}}}"):
                return False
        if wanted is not None:
            return name in wanted or name.split("{", 1)[0] in wanted
        return True

    def window(self, series: list[str] | None = None, since: int = 0,
               stride: int = 1, session: str | None = None,
               limit: int | None = None) -> dict:
        """Columnar window read: samples with absolute index >= `since`
        (clamped to what the ring still holds), every `stride`-th one,
        newest-last.  Returns {index: [...], t: [...seconds...],
        series: {name: [...]}, nextIndex, capacity, enabled} — arrays,
        never one dict per sample.  `series` filters by full name or
        bare (label-less) prefix; `session` keeps one session's labeled
        series plus the globals."""
        wanted = set(series) if series else None
        with self._mu:
            n, cap = self._n, self._cap
            lo = max(int(since), n - cap, 0)
            idxs = list(range(lo, n, max(int(stride), 1)))
            if limit is not None and len(idxs) > int(limit):
                idxs = idxs[-int(limit):]
            slots = [i % cap for i in idxs]
            names = [nm for nm in sorted(self._cols)
                     if self._match(nm, session, wanted)]
            cols = {nm: self._cols[nm][slots] for nm in names}
            ts = self._ts[slots]
        return {
            "index": idxs,
            "t": [round(int(v) / 1e6, 6) for v in ts],
            "series": {
                nm: [None if np.isnan(v) else float(v) for v in col]
                for nm, col in cols.items()
            },
            "nextIndex": n,
            "capacity": cap,
            "enabled": _ENABLED,
        }

    def tail(self, k: int = 64, session: str | None = None) -> dict:
        """The trailing k samples — what wave-abort bundles embed so a
        dump answers "what was trending before this" by itself."""
        with self._mu:
            n = self._n
        return self.window(since=max(n - int(k), 0), session=session)

    def value(self, name: str, index: int) -> float | None:
        """One series' value at one absolute index (None when the index
        scrolled out of the ring, the series doesn't exist, or the slot
        holds NaN) — the evidence-matches-ring check in the tests."""
        with self._mu:
            if index < 0 or index >= self._n or index < self._n - self._cap:
                return None
            col = self._cols.get(name)
            if col is None:
                return None
            v = col[index % self._cap]
        return None if np.isnan(v) else float(v)

    def last_index(self) -> int:
        """Absolute index of the newest sample (-1 when empty)."""
        with self._mu:
            return self._n - 1

    # ----------------------------------------------------- lifecycle

    def drop_session(self, session: str | None) -> None:
        """Release a torn-down session's columns (server/sessions.py
        _teardown — per-session series must not outlive the session on
        a churning server; the global columns stay)."""
        if session is None:
            return
        tag = f"{{session={session}}}"
        with self._mu:
            for nm in [nm for nm in self._cols if nm.endswith(tag)]:
                del self._cols[nm]

    def reset(self) -> None:
        """Tests only: clear every column and the index counter."""
        with self._mu:
            self._cols.clear()
            self._ts[:] = 0
            self._n = 0

    def ensure_capacity(self, capacity: int) -> int:
        """Grow the ring to at least `capacity` rows, keeping every row it
        holds at its absolute index (a run that must read a long window
        back, as the soak does, sizes it in-process; KSS_TPU_HISTORY_
        CAPACITY is read at import).  Returns the previous capacity."""
        with self._mu:
            prev = self._cap
            if capacity <= prev:
                return prev
            lo = max(self._n - prev, 0)
            ts = np.zeros(capacity, dtype=np.int64)
            cols = {name: np.full(capacity, np.nan) for name in self._cols}
            for i in range(lo, self._n):
                ts[i % capacity] = self._ts[i % prev]
                for name, col in self._cols.items():
                    cols[name][i % capacity] = col[i % prev]
            self._ts, self._cols, self._cap = ts, cols, capacity
        return prev


HISTORY = TelemetryHistory()
