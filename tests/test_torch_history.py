"""Mirror of tests/test_history.py against the port
(kube_scheduler_simulator_tpu_torch), every case on `device="cpu"`: the
same cases under the same names.  No case reads a TPU-only field.

Causal telemetry plane (docs/metrics.md "History & correlation").

Covers the columnar history ring's unit contract (append/window
round-trip, absolute-index cursors across wraparound, stride, series
and session filters, NaN -> null, value(), drop_session), the feeder
(counter deltas, per-session SLO/effector columns, the disabled no-op
parity shape), trace correlation (trace_scope nesting, span stamping,
the consume-once session -> trace handoff, Perfetto's trace_id filter
with black-box instants), the X-KSS-Trace-Id HTTP contract end to end
against a live server, the `/api/v1/history` surface + sessions alias,
the KSS_TPU_TRACER_CAPACITY knob with its /readyz drop counter, and
the history window embedded in post-mortem bundles.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.request

import pytest

from kube_scheduler_simulator_tpu_torch.config.config import SimulatorConfiguration
from kube_scheduler_simulator_tpu_torch.server.server import SimulatorServer
from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager
from kube_scheduler_simulator_tpu_torch.utils import history
from kube_scheduler_simulator_tpu_torch.utils.blackbox import (
    BLACKBOX, FEEDER, SLO, validate_dump)
from kube_scheduler_simulator_tpu_torch.utils.history import (
    HISTORY, TelemetryHistory)
from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER, Tracer


@pytest.fixture(autouse=True)
def _enabled_clean_ring():
    """Every test sees an enabled, empty singleton ring and fresh
    feeder baselines; leaked rows would shift other tests' indices."""
    prev = history.set_enabled(True)
    HISTORY.reset()
    FEEDER.reset()
    yield
    HISTORY.reset()
    FEEDER.reset()
    history.set_enabled(prev)


# ------------------------------------------------------- ring contract


def test_append_window_roundtrip_and_nan_null():
    h = TelemetryHistory(capacity=16)
    assert h.append({"a": 1.0, "b": 2.0}, t_us=1_000_000) == 0
    assert h.append({"a": 3.0}, t_us=2_000_000) == 1
    win = h.window()
    assert win["index"] == [0, 1]
    assert win["t"] == [1.0, 2.0]
    # series b was absent at sample 1: NaN stored, null served
    assert win["series"]["a"] == [1.0, 3.0]
    assert win["series"]["b"] == [2.0, None]
    assert win["nextIndex"] == 2 and win["capacity"] == 16
    # a series born late reads null for its pre-history
    h.append({"c": 9.0}, t_us=3_000_000)
    assert h.window()["series"]["c"] == [None, None, 9.0]


def test_absolute_indices_survive_wraparound():
    h = TelemetryHistory(capacity=16)
    for i in range(40):
        h.append({"x": float(i)}, t_us=i)
    win = h.window(since=0)
    # the ring holds the newest 16; indices stay absolute — a cursor
    # that fell behind sees the floor move, never recycled rows
    assert win["index"] == list(range(24, 40))
    assert win["series"]["x"] == [float(i) for i in range(24, 40)]
    assert win["nextIndex"] == 40
    # cursors: since= inside the ring honors it exactly
    assert h.window(since=30)["index"] == list(range(30, 40))
    # value() refuses scrolled-out indices instead of aliasing slots
    assert h.value("x", 23) is None
    assert h.value("x", 24) == 24.0
    assert h.value("x", 39) == 39.0
    assert h.value("x", 40) is None
    assert h.value("nope", 39) is None


def test_window_stride_limit_series_and_session_filters():
    h = TelemetryHistory(capacity=64)
    for i in range(10):
        h.append({"g": float(i),
                  "slo.p99{session=a}": float(i) / 10,
                  "slo.p99{session=b}": float(i) / 100}, t_us=i)
    assert h.window(stride=3)["index"] == [0, 3, 6, 9]
    assert h.window(limit=2)["index"] == [8, 9]
    # bare prefix matches every session's labeled column
    assert set(h.window(series=["slo.p99"])["series"]) == {
        "slo.p99{session=a}", "slo.p99{session=b}"}
    # full name matches exactly one
    assert set(h.window(series=["slo.p99{session=b}"])["series"]) == {
        "slo.p99{session=b}"}
    # session filter keeps that session's columns plus the globals
    assert set(h.window(session="a")["series"]) == {
        "g", "slo.p99{session=a}"}
    h.drop_session("a")
    assert set(h.window()["series"]) == {"g", "slo.p99{session=b}"}


def test_disabled_ring_appends_nothing_and_reports_it():
    h = TelemetryHistory(capacity=16)
    h.append({"x": 1.0}, t_us=1)
    prev = history.set_enabled(False)
    try:
        assert h.append({"x": 2.0}, t_us=2) == -1
        win = h.window()
        assert win["enabled"] is False
        assert win["index"] == [0]   # the pre-disable row survives
    finally:
        history.set_enabled(prev)


# ------------------------------------------------------------- feeder


def test_feeder_counter_deltas_and_session_columns():
    sid = "hist-feed"
    TRACER.inc("speculative_accepted_total", 90, session=sid)
    TRACER.inc("speculative_rolled_back_total", 10, session=sid)
    SLO.observe_wave(sid, 0.5, pods=10)
    idx, planes = FEEDER.sample()
    assert idx >= 0
    assert planes["slo"][sid]["p99WaveSeconds"] == 0.5
    assert HISTORY.value(f"spec.accept{{session={sid}}}", idx) == 0.9
    assert HISTORY.value(f"slo.p99{{session={sid}}}", idx) == 0.5
    # no controls overrides: the effector columns record the explicit
    # default state, not a gap
    assert HISTORY.value(f"autopilot.shed{{session={sid}}}", idx) == 0.0
    assert HISTORY.value(
        f"autopilot.budget_weight{{session={sid}}}", idx) == 1.0
    # deltas, not totals: a sample with no new rounds has no accept
    # fraction (None), and the spill delta resets to 0
    idx2, _planes = FEEDER.sample()
    assert HISTORY.value(f"spec.accept{{session={sid}}}", idx2) is None


def test_feeder_disabled_returns_planes_without_sampling():
    """The KSS_TPU_HISTORY=0 shape: one code path — the autopilot still
    plans from the same gathered planes, only the ring write drops."""
    sid = "hist-off"
    SLO.observe_wave(sid, 0.25, pods=5)
    prev = history.set_enabled(False)
    try:
        before = HISTORY.last_index()
        idx, planes = FEEDER.sample()
        assert idx == -1
        assert planes["slo"][sid]["p99WaveSeconds"] == 0.25
        assert HISTORY.last_index() == before
    finally:
        history.set_enabled(prev)


# -------------------------------------------------- trace correlation


def test_trace_scope_nesting_and_span_stamping():
    assert TRACER.current_trace() is None
    with TRACER.trace_scope("t-outer"):
        assert TRACER.current_trace() == "t-outer"
        with TRACER.trace_scope(None):   # None is a no-op, not a mask
            assert TRACER.current_trace() == "t-outer"
        with TRACER.trace_scope("t-inner"):
            assert TRACER.current_trace() == "t-inner"
            with TRACER.span("hist-span"):
                pass
        assert TRACER.current_trace() == "t-outer"
    assert TRACER.current_trace() is None
    ev = [e for e in TRACER.events(limit=50) if e["name"] == "hist-span"][-1]
    assert ev["trace_id"] == "t-inner"


def test_session_trace_handoff_is_consume_once():
    TRACER.note_session_trace("ho-sess", "t-once")
    assert TRACER.claim_session_trace("ho-sess") == "t-once"
    assert TRACER.claim_session_trace("ho-sess") is None
    assert TRACER.claim_session_trace(None) is None
    # latest note wins — a second request before the wave re-stamps
    TRACER.note_session_trace("ho-sess", "t-a")
    TRACER.note_session_trace("ho-sess", "t-b")
    assert TRACER.claim_session_trace("ho-sess") == "t-b"


def test_perfetto_filters_by_trace_id_with_blackbox_instants():
    with TRACER.trace_scope("t-pf"):
        with TRACER.span("pf-span"):
            BLACKBOX.record("pf.event", detail=1)
    with TRACER.trace_scope("t-other"):
        with TRACER.span("pf-other"):
            BLACKBOX.record("pf.other")
    # a fused dispatch carries EVERY participant's id in `traces`
    BLACKBOX.record("fuse.dispatch", result="fused", k=2,
                    traces=["t-pf", "t-third"])

    pf = TRACER.perfetto(trace_id="t-pf")
    spans = [e for e in pf["traceEvents"] if e.get("ph") == "X"]
    instants = [e for e in pf["traceEvents"] if e.get("ph") == "i"]
    assert [e["name"] for e in spans] == ["pf-span"]
    names = [e["name"] for e in instants]
    assert "pf.event" in names
    assert "fuse.dispatch" in names     # matched via the traces list
    assert "pf.other" not in names
    assert all(e["cat"] == "blackbox" and e["s"] == "p" for e in instants)
    # instants sit on the span timeline (non-negative µs since epoch)
    assert all(isinstance(e["ts"], int) and e["ts"] >= 0
               for e in instants)


# --------------------------------------------------- tracer capacity


def test_tracer_capacity_knob_and_drop_counter(monkeypatch):
    monkeypatch.setenv("KSS_TPU_TRACER_CAPACITY", "64")
    t = Tracer()
    assert t._events.maxlen == 64
    assert t.dropped_events() == 0
    for _ in range(70):
        with t.span("cap-span"):
            pass
    assert t.dropped_events() == 6
    assert t.counter_totals()["tracer_events_dropped_total"] == 6
    # the floor: a hostile tiny value can't wedge the flight recorder
    monkeypatch.setenv("KSS_TPU_TRACER_CAPACITY", "1")
    assert Tracer()._events.maxlen == 64


# --------------------------------------------------- HTTP end to end


@pytest.fixture()
def server(monkeypatch):
    # no background scheduler / slow autopilot: the test drives waves
    # itself so the trace handoff is deterministic
    monkeypatch.setenv("KSS_TPU_AUTOPILOT_INTERVAL_S", "60")
    mgr = SessionManager(device="cpu", cfg=SimulatorConfiguration(port=0),
                         max_sessions=4, start_scheduler=False,
                         idle_ttl=0)
    srv = SimulatorServer(mgr, port=0)
    srv.start(block=False)
    yield srv, mgr
    srv.shutdown()


def hreq(srv, method, path, body=None, headers=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    hdrs = {"Content-Type": "application/json"}
    hdrs.update(headers or {})
    r = urllib.request.Request(url, data=data, method=method, headers=hdrs)
    try:
        with urllib.request.urlopen(r, timeout=10) as resp:
            raw = resp.read()
            return (resp.status, dict(resp.headers),
                    json.loads(raw) if raw else None)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, dict(e.headers), json.loads(raw) if raw else None


def _pod(name: str) -> dict:
    return {"apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"containers": [{
                "name": "main", "image": "registry.k8s.io/pause:3.9",
                "resources": {"requests": {"cpu": "100m",
                                           "memory": str(128 << 20)}}}]}}


def test_http_trace_id_stamped_carried_and_retrievable(server):
    srv, mgr = server
    code, _h, _b = hreq(srv, "POST", "/api/v1/sessions", {"id": "tr-s"})
    assert code == 201
    sess = mgr.get("tr-s")
    for n in range(2):
        sess.di.store.create("nodes", {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": f"tr-n{n}"},
            "status": {"allocatable": {"cpu": "4",
                                       "memory": str(8 << 30),
                                       "pods": "110"}}})

    # inbound X-KSS-Trace-Id honored and echoed
    code, hdrs, _b = hreq(srv, "POST", "/api/v1/sessions/tr-s/pods",
                          _pod("tr-p0"),
                          headers={"X-KSS-Trace-Id": "t-http-42"})
    assert code == 201
    assert hdrs.get("X-KSS-Trace-Id") == "t-http-42"
    # the wave that schedules the submission claims the id
    sess.di.engine.schedule_pending()
    traced = [e for e in TRACER.events(limit=200)
              if e.get("trace_id") == "t-http-42"]
    assert traced and all(e.get("session") == "tr-s" for e in traced)
    code, _h, pf = hreq(srv, "GET", "/api/v1/trace?trace_id=t-http-42")
    assert code == 200
    evs = [e for e in pf["traceEvents"] if e.get("ph") in ("X", "i")]
    assert evs and all(
        e["args"].get("trace_id") == "t-http-42"
        or "t-http-42" in (e["args"].get("traces") or ())
        for e in evs)

    # no inbound header: the server mints one and echoes it
    code, hdrs, _b = hreq(srv, "POST", "/api/v1/sessions/tr-s/pods",
                          _pod("tr-p1"))
    assert code == 201
    minted = hdrs.get("X-KSS-Trace-Id")
    assert minted and minted.startswith("t-")
    # GETs are not stamped
    code, hdrs, _b = hreq(srv, "GET", "/api/v1/sessions/tr-s/pods")
    assert code == 200
    assert "X-KSS-Trace-Id" not in hdrs


def test_http_history_endpoint_and_sessions_alias(server):
    srv, _mgr = server
    code, _h, _b = hreq(srv, "POST", "/api/v1/sessions", {"id": "hi-s"})
    assert code == 201
    SLO.observe_wave("hi-s", 0.125, pods=4)
    idx, _planes = FEEDER.sample()
    FEEDER.sample()

    code, _h, win = hreq(srv, "GET", "/api/v1/history")
    assert code == 200
    assert win["enabled"] is True and idx in win["index"]
    assert win["series"][f"slo.p99{{session=hi-s}}"][
        win["index"].index(idx)] == 0.125

    # cursor + stride + series filtering through the query surface
    code, _h, win2 = hreq(
        srv, "GET", f"/api/v1/history?since={idx + 1}&series=slo.p99")
    assert code == 200
    assert win2["index"] == [idx + 1]
    # the bare prefix matches every session's labeled column (other
    # suites' sessions may still sit in the process-global SLO window)
    assert "slo.p99{session=hi-s}" in win2["series"]
    assert all(nm.startswith("slo.p99") for nm in win2["series"])

    # the sessions alias scopes like ?session=
    code, _h, win3 = hreq(srv, "GET", "/api/v1/sessions/hi-s/history")
    assert code == 200
    assert all("{" not in nm or nm.endswith("{session=hi-s}")
               for nm in win3["series"])

    code, _h, body = hreq(srv, "GET", "/api/v1/history?since=x")
    assert code == 400 and "integers" in body["message"]


def test_readyz_surfaces_tracer_dropped_events(server):
    # no scheduler loop in this fixture, so readiness is 503 — the
    # body (and the drop counter on it) is served either way
    srv, _mgr = server
    code, _h, ready = hreq(srv, "GET", "/readyz")
    assert code in (200, 503)
    base = ready.get("tracerDroppedEvents", 0)
    cap = TRACER._events.maxlen
    # fill the remainder of the ring, then overflow it by ten
    for _ in range(cap - len(TRACER.events(limit=cap)) + 10):
        with TRACER.span("drop-span"):
            pass
    _code, _h, ready = hreq(srv, "GET", "/readyz")
    assert ready["tracerDroppedEvents"] > base


# ------------------------------------------------- post-mortem window


def test_bundle_embeds_validating_history_window():
    SLO.observe_wave("pm-s", 0.2, pods=4)
    FEEDER.sample()
    doc, path = BLACKBOX.dump("test-history", write=False)
    assert path is None
    validate_dump(doc)
    hist = doc["history"]
    assert hist["index"] and isinstance(hist["series"], dict)
    assert len(hist["t"]) == len(hist["index"])
    # a ragged column must fail the schema check
    bad = json.loads(json.dumps(doc))
    first = next(iter(bad["history"]["series"]))
    bad["history"]["series"][first] = \
        bad["history"]["series"][first] + [0.0]
    with pytest.raises(ValueError, match="history"):
        validate_dump(bad)
