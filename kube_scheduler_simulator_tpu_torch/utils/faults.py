"""Deterministic fault injection: named, seeded chaos seams.

A copy of kube_scheduler_simulator_tpu/utils/faults.py, host code with its
imports rewired to the port.

The simulator's failure story used to be "abort and hope": a replay
fault mid-wave stopped the streaming committer and left the backlog to
an undefined next wave.  Before the engine can *survive* injected
failures with provable invariants (the wave failure protocol in
framework/engine.py, docs/fault-injection.md), it needs a way to
*produce* those failures deterministically.  This module is that seam
layer:

  * `fault_point(seam)` — a named injection point threaded through the
    real failure seams (scan dispatch, decision fetch, D2H
    materialization, budget spill, chunk decode, reflector write-back,
    compile-cache build, session create/evict).  With no plan armed it
    is ONE module-global load and compare — zero overhead on the hot
    path, measured by the bench A/B the chaos gate requires.
  * `FaultPlan` — a set of rules (seam x trigger x error type), armed
    programmatically (`arm`/`armed`) or from the environment
    (`KSS_TPU_FAULT_PLAN`: inline JSON, or `@/path/to/plan.json`).
    Triggers are deterministic: `nth` trips on exactly the nth hit of
    the seam; `p` trips a Bernoulli draw from a per-rule RNG seeded by
    (plan seed, rule index, seam) — the same plan replays the same
    trips for the same sequence of seam hits.  Under CONCURRENT hits
    (the chaos harness's parallel sessions and fetch threads) the hit
    sequence itself depends on thread interleaving, so exact trip
    *placement* is best-effort reproducible — the seed pins the plan,
    RNG streams and workload, and the chaos invariants are
    interleaving-independent (byte parity vs the fault-free run holds
    wherever the fault lands).
  * error types (`_ERROR_TYPES`) modeling the real failure classes:
    transient runtime/io/timeout faults, store write `conflict`s (the
    reflector's backoff machinery retries those like real conflicts),
    and structural `memory` faults (the HBM-exhaustion class the
    engine's degradation ladder answers — docs/fault-injection.md).
  * `classify_fault(exc)` — the wave failure protocol's triage:
    "transient" (retry the uncommitted suffix), "structural" (step down
    the residency ladder), or "fatal" (surface immediately: interrupts,
    retry exhaustion — re-retrying a bounded-retry failure multiplies
    the bound).

Every trip counts `fault_injected_total{seam=...}` so chaos runs can
assert the plan actually fired.
"""

from __future__ import annotations

import json
import os
import random
import threading
import zlib
from contextlib import contextmanager

from .retry import RetryTimeout
from .tracing import TRACER

# the documented seam names (docs/fault-injection.md); fault_point
# accepts any string, but plans referencing unknown seams never fire —
# FaultPlan validates against this list so a typo'd plan fails loudly
SEAMS = (
    "replay.scan_dispatch",    # per-chunk device dispatch (framework/replay.py)
    "replay.decision_fetch",   # per-chunk D2H fetch (decisions or full outputs)
    "speculative.round",       # per-round top of the speculative stream
                               # (parallel/speculative.py)
    "fuse.dispatch",           # cross-session fused dispatch, fired on the
                               # REQUESTING thread before it joins a batch
                               # so a trip faults one session only
                               # (parallel/fuse.py)
    "replay.materialize",      # on-demand D2H of a device-resident chunk
    "replay.budget_spill",     # background HBM-budget spill of a chunk
    "decode.chunk",            # native/python chunk decode (store/decode.py)
    "reflector.write_back",    # annotation write-back (store/reflector.py)
    "compile.build",           # XLA scan build (_ScanCacheRegistry)
    "session.create",          # session admission (server/sessions.py)
    "session.evict",           # session teardown/eviction
    "autopilot.decide",        # autopilot decision application — a trip
                               # reverts every effector to the static
                               # defaults (control/autopilot.py fail-safe)
)


class InjectedFault(Exception):
    """Base for injected errors: carries the seam it fired at and the
    structural flag the wave failure protocol classifies on."""

    structural = False

    def __init__(self, message: str = "injected fault", seam: str = ""):
        super().__init__(message)
        self.seam = seam


class InjectedRuntimeFault(InjectedFault, RuntimeError):
    """Transient runtime failure (a flaky device call)."""


class InjectedIOFault(InjectedFault, OSError):
    """Transient I/O failure (a dropped transfer)."""


class InjectedTimeout(InjectedFault, TimeoutError):
    """Transient timeout (a stalled link)."""


class InjectedOOM(InjectedFault, MemoryError):
    """Structural device-memory exhaustion (the HBM RESOURCE_EXHAUSTED
    class): the degradation ladder's trigger, not a retry candidate."""

    structural = True


_CONFLICT_CLS: type | None = None


def _conflict_cls() -> type:
    """Injected store-write conflict, built lazily so utils never
    imports cluster at module load (cluster.store imports utils)."""
    global _CONFLICT_CLS
    if _CONFLICT_CLS is None:
        from ..cluster.store import Conflict

        class InjectedConflict(InjectedFault, Conflict):
            """Transient write conflict: heals under the same
            exponential backoff real conflicts do."""

        _CONFLICT_CLS = InjectedConflict
    return _CONFLICT_CLS


def _make_error(kind: str, seam: str, message: str | None):
    msg = message or f"injected {kind} fault at {seam}"
    if kind == "conflict":
        return _conflict_cls()(msg, seam=seam)
    cls = {
        "runtime": InjectedRuntimeFault,
        "io": InjectedIOFault,
        "timeout": InjectedTimeout,
        "memory": InjectedOOM,
    }.get(kind)
    if cls is None:
        raise ValueError(f"unknown fault error type {kind!r}")
    return cls(msg, seam=seam)


_ERROR_TYPES = ("runtime", "io", "timeout", "memory", "conflict")


class FaultRule:
    """One seam's trigger: `nth` (trip on exactly the nth hit) or `p`
    (per-hit Bernoulli from the rule's own seeded RNG).  `times` bounds
    total trips (default 1 for nth rules, unbounded for p rules);
    `sessions` restricts the rule to hits made under those sessions'
    tracer scopes (the chaos isolation invariant: fault one tenant,
    prove the neighbor undisturbed)."""

    __slots__ = ("seam", "error", "nth", "p", "times", "sessions",
                 "message", "hits", "trips", "rng")

    def __init__(self, seam: str, error: str = "runtime",
                 nth: int | None = None, p: float | None = None,
                 times: int | None = None, sessions=None,
                 message: str | None = None):
        if seam not in SEAMS:
            raise ValueError(f"unknown fault seam {seam!r} (want one of "
                             f"{', '.join(SEAMS)})")
        if error not in _ERROR_TYPES:
            raise ValueError(f"unknown fault error type {error!r} (want one "
                             f"of {', '.join(_ERROR_TYPES)})")
        if (nth is None) == (p is None):
            raise ValueError(
                f"rule for {seam!r} needs exactly one of nth= or p=")
        if nth is not None and nth < 1:
            raise ValueError(f"nth must be >= 1, got {nth}")
        if p is not None and not (0.0 <= p <= 1.0):
            raise ValueError(f"p must be in [0, 1], got {p}")
        self.seam = seam
        self.error = error
        self.nth = nth
        self.p = p
        self.times = times if times is not None else (1 if nth else None)
        self.sessions = frozenset(sessions) if sessions else None
        self.message = message
        self.hits = 0
        self.trips = 0
        self.rng: random.Random | None = None  # seeded by the plan


class FaultPlan:
    """A seeded set of FaultRules.  `check(seam)` is called under the
    plan's lock by `fault_point`; rule state (hit counters, RNG draws)
    advances deterministically, so the same plan + the same sequence of
    seam hits trips the same faults."""

    def __init__(self, rules: list[FaultRule], seed: int = 0):
        self.seed = int(seed)
        self.rules = list(rules)
        self._mu = threading.Lock()
        for i, r in enumerate(self.rules):
            r.rng = random.Random(
                (self.seed << 20) ^ (i << 8) ^ zlib.crc32(r.seam.encode()))

    # ------------------------------------------------------------- load

    @classmethod
    def from_dict(cls, doc: dict) -> "FaultPlan":
        rules = [
            FaultRule(
                seam=r["seam"], error=r.get("error", "runtime"),
                nth=r.get("nth"), p=r.get("p"), times=r.get("times"),
                sessions=r.get("sessions"), message=r.get("message"))
            for r in doc.get("rules", ())
        ]
        return cls(rules, seed=doc.get("seed", 0))

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        """KSS_TPU_FAULT_PLAN: inline JSON, or `@/path` to a JSON file.
        Unset/empty -> None.  A malformed plan raises — arming chaos is
        an explicit operator action and a typo must fail loudly, not
        silently run fault-free."""
        raw = os.environ.get("KSS_TPU_FAULT_PLAN")
        if not raw:
            return None
        if raw.startswith("@"):
            with open(raw[1:], encoding="utf-8") as fh:
                raw = fh.read()
        return cls.from_dict(json.loads(raw))

    # ------------------------------------------------------------ check

    def check(self, seam: str) -> Exception | None:
        """Advance every matching rule's state; return the first
        tripped rule's exception (or None).  Session filters read the
        caller's tracer scope BEFORE taking the plan lock."""
        session = TRACER.current_session()
        with self._mu:
            for r in self.rules:
                if r.seam != seam:
                    continue
                if r.sessions is not None and session not in r.sessions:
                    continue
                r.hits += 1
                if r.times is not None and r.trips >= r.times:
                    continue
                trip = (r.hits == r.nth) if r.nth is not None \
                    else (r.rng.random() < r.p)
                if trip:
                    r.trips += 1
                    return _make_error(r.error, seam, r.message)
        return None

    def stats(self) -> dict:
        with self._mu:
            return {
                "seed": self.seed,
                "rules": [
                    {"seam": r.seam, "error": r.error, "hits": r.hits,
                     "trips": r.trips}
                    for r in self.rules
                ],
            }


# the armed plan: a single module global so the unarmed fast path is one
# load + is-None compare (the chaos gate's zero-overhead requirement)
_PLAN: FaultPlan | None = FaultPlan.from_env()


def fault_point(seam: str) -> None:
    """Named injection point.  No plan armed: near-zero cost.  Armed:
    advances the plan deterministically and raises the rule's error on
    a trip (counted as fault_injected_total{seam=...})."""
    plan = _PLAN
    if plan is None:
        return
    exc = plan.check(seam)
    if exc is not None:
        TRACER.inc("fault_injected_total", seam=seam)
        # black-box evidence: the trip, where it fired, and how the
        # wave failure protocol will triage it (utils/blackbox.py) —
        # imported lazily so the unarmed fast path pays nothing
        from .blackbox import BLACKBOX

        BLACKBOX.record("fault.trip", seam=seam,
                        error=type(exc).__name__,
                        classification=classify_fault(exc))
        raise exc


def arm(plan: FaultPlan) -> FaultPlan:
    global _PLAN
    _PLAN = plan
    return plan


def disarm() -> None:
    global _PLAN
    _PLAN = None


def current_plan() -> FaultPlan | None:
    return _PLAN


@contextmanager
def armed(plan: FaultPlan):
    """Arm `plan` for the duration of a with block (tests, chaos runs).
    Not reentrant: the previous plan (normally None) is restored."""
    global _PLAN
    prev = _PLAN
    _PLAN = plan
    try:
        yield plan
    finally:
        _PLAN = prev


def classify_fault(exc: BaseException) -> str:
    """The wave failure protocol's triage (docs/fault-injection.md):

      * "fatal"      — never retried: non-Exception BaseExceptions
        (interrupts), and RetryTimeout/RetryAborted — an exhausted
        bounded retry must surface, re-retrying multiplies the bound;
      * "structural" — device-memory exhaustion (MemoryError, XLA
        RESOURCE_EXHAUSTED, injected OOM): answered by the degradation
        ladder, not a retry (the wave would just OOM again);
      * "transient"  — everything else: retry the uncommitted suffix
        with bounded backoff.
    """
    if not isinstance(exc, Exception):
        return "fatal"
    if isinstance(exc, RetryTimeout):
        return "fatal"
    if isinstance(exc, InjectedFault):
        return "structural" if exc.structural else "transient"
    if isinstance(exc, MemoryError):
        return "structural"
    if (type(exc).__name__ == "XlaRuntimeError"
            and "RESOURCE_EXHAUSTED" in str(exc)):
        return "structural"
    return "transient"
