"""Cross-session fused wave dispatch: one device call, many tenants.

Port of kube_scheduler_simulator_tpu/parallel/fuse.py.  The protocol, the
window, the mutual-leader break, the error fan-out, admission, the taps
and `stats()` are the JAX module's, unchanged.  Two things differ:

  * the fused call (`_run_fused`) stacks nothing.  The JAX package runs
    `jax.jit(jax.vmap(solo_fn))` over carries and batches stacked on a new
    session axis; here `solo_fn.fused` takes the K members' own argument
    tuples and runs them in one launch of the hand-written kernel B11
    (kernels/fuse.py: `spec_eval_fused` or `spec_round_fused`, then
    `spec_oracle_fused`), whose blocks each read one session's own
    tensors through a per-session table of kernel arguments.  On the CPU
    it runs each member's plain round in turn;
  * `_place_sessions` places nothing: on one card a mesh's members keep
    their own tensors, and a fused dense round of members sharded over a
    mesh is one table launch too (kernels/fuse.py `spec_eval_fused`, each
    member's "nodes" shards groups of CTAs as in B12 `spec_eval_sharded`),
    so the tallies stay the JAX ones.

The rest is the JAX module's description, which holds for the port.

K sessions serving speculative waves (parallel/speculative.py) used to
time-share the device — each session's rounds dispatched alone, so
multi-tenant utilization was a slicing story.  This module makes it a
BATCHING story (Gavel's packed-tenant throughput argument, Tesserae's
batched-placement framing): when >= 2 sessions with SHAPE-COMPATIBLE
workloads have rounds pending, the whole round of every one of them —
dense filters, sparse score/select tail, per-row conflict oracle — runs
in ONE device call.  Only each session's own
decision rows cross back to host, and each session's accepted prefix
streams to its own commit worker unchanged.

Why this is sound: two streams of the same fuse family
(parallel/speculative.py `_fuse_family`: equal statics content, equal
xs/carry shapes, equal plugin configuration, chunk, width tier and
candidate cap) run the same round program; the only per-session state
entering the call is (carry, xs).  B11 runs each session's blocks on
that session's own arguments with the solo kernels' device bodies
(csrc/spec.cuh), so every session's outputs, and therefore its
annotations, bind order and result history, are byte-identical to its
solo (`KSS_TPU_FUSE=0`) run.  tests/test_torch_fuse.py gates that bar;
acceptance, gang cuts, interaction walks and commits stay per-session.

Protocol (FuseCoordinator): each speculative stream announces itself
with `stream_open(family)` and routes every round's device call through
`dispatch(key, solo_fn, args)`.  The first arrival at a key becomes the
batch LEADER and waits up to KSS_TPU_FUSE_WINDOW_MS for batch-mates
(followers append their args and wait on the batch's done event); the
leader then closes the batch, stacks, runs the fused call and fans the
per-session rows back out.  A leader whose window expires runs solo
(result=window_timeout); a stream with no live partner in its family —
or one the admission policy benched — skips the wait entirely and runs
solo (result=timeshared).  Admission is policy-driven from the
session telemetry already serves: sessions whose observed speculative
accept rate sits below KSS_TPU_FUSE_MIN_ACCEPT time-share (their waves
are about to hand rounds to the scan fallback — stacking them would
stall high-accept batch-mates), sessions with no history fuse
optimistically.  Streams close (idempotently) when the wave ends OR
when the stream falls back to the sequential scan, waking any leader
still waiting on them.

Failure semantics: the `fuse.dispatch` chaos seam fires on the
REQUESTING thread before it joins a batch, so an injected fault aborts
only that session's wave — its engine retries the uncommitted suffix
through the standard wave failure protocol while batch-mates proceed
(neighbor isolation, asserted by `make chaos`).  A real device failure
inside a fused call surfaces to every batch member; each session's own
wave protocol then retries its own suffix.

Env knobs (docs/environment-variables.md): KSS_TPU_FUSE=0 disables
fusion (the parity baseline), KSS_TPU_FUSE_WINDOW_MS bounds the
straggler wait, KSS_TPU_FUSE_MIN_ACCEPT tunes admission.
"""

from __future__ import annotations

import os
import threading
import time

from ..utils.blackbox import BLACKBOX
from ..utils.env import env_float
from ..utils.faults import fault_point
from ..utils.tracing import TRACER

# batch-width ceiling: K x the solo round's carry/xs footprint lives on
# device for the call; past this the fused win is memory-bound anyway
MAX_FUSE_SESSIONS = 16

# a follower's bound wait for its leader's fused call — far past any
# real round (the 120s chaos wedge bound), so a hit means the leader
# thread died without setting the done event, which is a bug, not load
_JOIN_TIMEOUT_S = 180.0


def fuse_enabled() -> bool:
    return os.environ.get("KSS_TPU_FUSE", "1") != "0"


def fuse_window_s() -> float:
    """Straggler timeout: how long a ready leader waits for batch-mates
    before dispatching without them."""
    return max(env_float("KSS_TPU_FUSE_WINDOW_MS", 25.0), 0.0) / 1000.0


def fuse_min_accept() -> float:
    return env_float("KSS_TPU_FUSE_MIN_ACCEPT", 0.25)


def session_admitted(session: str | None) -> bool:
    """The admission policy, read from the flight recorder's
    session-labeled speculative counters (the telemetry
    /api/v1/sessions already serves): a session whose lifetime accept
    rate sits below the min-accept knob time-shares — its rounds are
    the scan-fallback-bound kind, and stacking them would stall
    high-accept batch-mates for no aggregate win.  No history fuses
    optimistically (a new tenant should not need a solo warm-up wave to
    earn batching)."""
    sid = session if session is not None else ""
    a = TRACER.labeled_totals(
        "speculative_accepted_total", "session").get(sid, 0)
    r = TRACER.labeled_totals(
        "speculative_rolled_back_total", "session").get(sid, 0)
    if a + r == 0:
        return True
    return a / (a + r) >= fuse_min_accept()


class _Stream:
    """One speculative stream's registration: the shape family it can
    fuse within, whether admission let it, and the mesh (if any) the
    fused stack should place its session axis over."""

    __slots__ = ("family", "admitted", "closed", "mesh")

    def __init__(self, family, admitted: bool, mesh=None):
        self.family = family
        self.admitted = admitted
        self.closed = False
        self.mesh = mesh


class _Batch:
    """One in-formation fused dispatch: member args in join order, each
    member's trace id (captured on its own thread at join — the fused
    event lists EVERY participant's trace so one id finds the shared
    dispatch from any side), the per-member output rows, and the done
    event followers wait on."""

    __slots__ = ("args", "traces", "outs", "error", "done", "closed")

    def __init__(self):
        self.args: list = []
        self.traces: list = []
        self.outs: list = []
        self.error: BaseException | None = None
        self.done = threading.Event()
        self.closed = False


def _place_sessions(args_list: list, mesh, k: int) -> list:
    """The JAX package lays the stacked session axis over a mesh's "dp"
    extent (JAX fuse.py:149-166).  Nothing is stacked here: every member
    of a fused call keeps its own tensors, on the mesh its stream opened
    with (the fuse family holds the mesh's signature, so members share
    it).  On a card mesh (B12b) each member's workload is placed over the
    mesh's cards already, and each of its rounds spreads its batch over
    the "dp" rows of cards (kernels/mesh.py spec_eval_cards), so the
    members' rounds run in turn (kernels/fuse.py dense_round_fused) and
    placement, as in JAX, changes no result."""
    if mesh is not None:
        for args in args_list:
            member_mesh = args[0].step.cw.mesh
            if member_mesh != mesh:
                raise ValueError(f"a member on {member_mesh} in a fused call on {mesh}")
    return args_list


class FuseCoordinator:
    """Process-level rendezvous for fused dispatches.  The lock guards
    only registration and batch formation; stacking, the device call
    and all metric recording run OUTSIDE it (kss-analyze's
    device/blocking-under-lock rules watch this module)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._cv = threading.Condition(self._mu)
        self._open: dict = {}      # family -> # admitted open streams
        self._batches: dict = {}   # dispatch key -> forming _Batch
        self._leading: dict = {}   # family -> {key: True} live leaders
        self._tally = {"fused": 0, "timeshared": 0, "window_timeout": 0}
        self._fused_dispatches = 0
        self._fused_sessions = 0

    # ------------------------------------------------------- lifecycle

    def stream_open(self, family, admitted: bool = True,
                    mesh=None) -> _Stream:
        stream = _Stream(family, admitted, mesh)
        if admitted:
            with self._cv:
                self._open[family] = self._open.get(family, 0) + 1
        return stream

    def stream_close(self, stream: _Stream) -> None:
        """Idempotent: called when the wave ends AND when a stream falls
        back to the sequential scan mid-wave — either way, leaders still
        waiting on this family must wake and recount their partners."""
        if stream.closed:
            return
        stream.closed = True
        if not stream.admitted:
            return
        with self._cv:
            n = self._open.get(stream.family, 0) - 1
            if n > 0:
                self._open[stream.family] = n
            else:
                self._open.pop(stream.family, None)
            self._cv.notify_all()

    # -------------------------------------------------------- dispatch

    def dispatch(self, stream: _Stream, key, solo_fn, args):
        """Run one round's device call, fused with whatever
        shape-compatible batch-mates arrive inside the window.  `args`
        is the solo call's argument tuple ((carry, xs)); the return
        value is exactly `solo_fn(*args)` — same pytree, same bytes.
        `key` extends the stream's family with everything else the solo
        executable was cached under (round kind + rung), so only calls
        to the SAME compiled program ever stack."""
        # the chaos seam fires on the requesting thread BEFORE it joins
        # a batch: an injected fault aborts only this session's wave
        # (suffix retry), batch-mates never see it
        fault_point("fuse.dispatch")
        if not stream.admitted or stream.closed:
            return self._solo(solo_fn, args, "timeshared")
        deadline = time.monotonic() + fuse_window_s()
        batch: _Batch | None = None
        idx = 0
        with self._cv:
            if self._open.get(stream.family, 0) >= 2:
                batch = self._batches.get(key)
                if batch is not None and not batch.closed \
                        and len(batch.args) < MAX_FUSE_SESSIONS:
                    idx = len(batch.args)
                    batch.args.append(args)
                    batch.traces.append(TRACER.current_trace())
                    self._cv.notify_all()
                else:
                    batch = self._batches[key] = _Batch()
                    batch.args.append(args)
                    batch.traces.append(TRACER.current_trace())
                    # wake leaders waiting at OTHER keys: a new leader
                    # here may complete a mutual-leader deadlock they
                    # must detect (see _lead) instead of sleeping out
                    # the window
                    self._cv.notify_all()
        if batch is None:
            return self._solo(solo_fn, args, "timeshared")
        if idx > 0:
            return self._follow(batch, idx)
        return self._lead(stream, key, batch, solo_fn, args, deadline)

    def _lead(self, stream: _Stream, key, batch: _Batch, solo_fn, args,
              deadline: float):
        with self._cv:
            led = self._leading.setdefault(stream.family, {})
            led[key] = True
            try:
                while True:
                    k = len(batch.args)
                    live = self._open.get(stream.family, 0)
                    if k >= min(max(live, 1), MAX_FUSE_SESSIONS) or live < 2:
                        break
                    if len(led) + (k - 1) >= live:
                        # mutual-leader deadlock: every live partner is
                        # either in this batch or leading its own batch
                        # at a DIFFERENT key (streams whose round ladders
                        # slipped out of phase).  Nobody can join within
                        # this round — run solo NOW instead of sleeping
                        # out the window; the ladders realign on their
                        # own at the repeated steady-state rung.
                        break
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cv.wait(timeout=remaining)
            finally:
                led.pop(key, None)
                if not led:
                    self._leading.pop(stream.family, None)
            batch.closed = True
            if self._batches.get(key) is batch:
                del self._batches[key]
            k = len(batch.args)
        if k < 2:
            # the window expired (or every partner left) without a
            # batch-mate; nobody waits on the event, set it for hygiene
            out = self._solo(solo_fn, args, "window_timeout")
            batch.done.set()
            return out
        try:
            with TRACER.span("fused_dispatch", role="leader", k=k):
                batch.outs = self._run_fused(
                    key, solo_fn, batch.args, k, stream.mesh)
        except BaseException as e:
            batch.error = e
            BLACKBOX.record("fuse.dispatch", result="error", k=k,
                            error=type(e).__name__,
                            traces=[t for t in batch.traces if t])
            raise
        finally:
            batch.done.set()
        with self._mu:
            self._fused_dispatches += 1
            self._fused_sessions += k
        self._record("fused", k, traces=batch.traces)
        return batch.outs[0]

    def _follow(self, batch: _Batch, idx: int):
        with TRACER.span("fused_dispatch", role="follower"):
            if not batch.done.wait(timeout=_JOIN_TIMEOUT_S):
                raise RuntimeError(
                    "fused dispatch wedged: batch leader never completed")
        if batch.error is not None:
            # the shared device call failed for every member; each
            # session's own wave protocol retries its own suffix
            BLACKBOX.record("fuse.dispatch", result="error",
                            k=len(batch.args),
                            error=type(batch.error).__name__,
                            traces=[t for t in batch.traces if t])
            raise batch.error
        self._record("fused", len(batch.args), traces=batch.traces)
        return batch.outs[idx]

    def _solo(self, solo_fn, args, result: str):
        with TRACER.span("fused_dispatch", role="solo", result=result):
            out = solo_fn(*args)
        self._record(result, 1)
        return out

    def _record(self, result: str, k: int, traces=None) -> None:
        """Per-member taps, recorded on the REQUESTING thread so the
        tracer's session scope folds the right session label in —
        device time in a fused call attributes to every session that
        shared it, through each member's own fused_dispatch span.
        `traces` lists EVERY batch member's trace id (fused results),
        so one request's trace id finds the cross-session dispatch it
        shared regardless of which member recorded the event."""
        TRACER.inc("fused_dispatch_total", result=result)
        TRACER.observe("fused_sessions_per_dispatch", k)
        if result != "timeshared":
            # timeshared rounds are the steady solo state — recording
            # each would drown the black-box ring in non-events
            extra = {}
            ids = [t for t in (traces or ()) if t]
            if ids:
                extra["traces"] = ids
            BLACKBOX.record("fuse.dispatch", result=result, k=k, **extra)
        with self._mu:
            self._tally[result] = self._tally.get(result, 0) + 1

    # ----------------------------------------------------------- fused

    def _run_fused(self, key, solo_fn, args_list: list, k: int, mesh=None):
        """Run the K members' rounds in one fused call: `solo_fn.fused`
        takes the members' argument tuples in join order and returns
        their outputs in the same order, each exactly what
        `solo_fn(*args)` returns (kernels/fuse.py: B11).  Nothing is
        stacked or copied: each member's tensors stay its own."""
        fused = getattr(solo_fn, "fused", None)
        if fused is None:
            raise TypeError(f"{getattr(solo_fn, '__name__', solo_fn)!r} has no fused form")
        outs = fused(_place_sessions(args_list, mesh, k))
        if len(outs) != k:
            raise RuntimeError(f"fused call returned {len(outs)} results for {k} members")
        return outs

    # ----------------------------------------------------------- stats

    def stats(self) -> dict:
        """The /api/v1/sessions shell surface (SessionManager.stats):
        knob state plus lifetime dispatch outcomes.  `dispatches`
        counts per-session outcomes (a K-way fused call counts K times
        under "fused"); fusedDeviceCalls counts actual device
        dispatches that carried >= 2 sessions, meanSessionsPerFusedCall
        their mean width."""
        with self._mu:
            tally = dict(self._tally)
            fused_calls = self._fused_dispatches
            fused_sessions = self._fused_sessions
            open_families = len(self._open)
        total = sum(tally.values())
        return {
            "enabled": fuse_enabled(),
            "windowMs": round(fuse_window_s() * 1000.0, 3),
            "minAccept": fuse_min_accept(),
            "dispatches": tally,
            "fusedDeviceCalls": fused_calls,
            "meanSessionsPerFusedCall": (round(fused_sessions / fused_calls,
                                               2) if fused_calls else None),
            "fusedFraction": (round(tally.get("fused", 0) / total, 4)
                              if total else None),
            "openFamilies": open_families,
        }


# the process singleton every speculative stream rendezvouses through —
# module-level like _DEVICE_BUDGET, the other shared
# pieces multi-session serving deliberately does not duplicate
FUSE = FuseCoordinator()
