"""Mirror of tests/test_blackbox.py against the port
(kube_scheduler_simulator_tpu_torch), every case on `device="cpu"`: the
same cases under the same names.  One reads a TPU-only field: the JAX
package's compiled-scan cache gauge (`scan_compile_cache_entries`), which
the port has no counterpart of; in its place the port's build telemetry
at its `compile.build` seam (framework/pipeline.py build_step) is held,
and the gauge must be absent.  The device fingerprint's CPU form is the
same in both packages.

Wave black box: crash-consistent post-mortem capture + device
telemetry (utils/blackbox.py, docs/metrics.md).

Covers the acceptance criteria end to end:

  * a fault-injected wave (KSS_TPU_FAULT_PLAN semantics via an armed
    plan) produces a schema-valid dump carrying the speculative round
    history, the fault trip (seam + classification + protocol action)
    and the wave's counter deltas;
  * black-box-on vs off produces byte-identical annotations (the
    recorder never touches the product) and records nothing when off;
  * HBM gauges appear in /api/v1/metrics with an EXPLICIT
    hbm_stats_available=0 no-op on the CPU backend;
  * per-session SLO (p50/p99 wave latency, cycles/s) appears on
    /api/v1/sessions and /readyz;
  * the live /metrics exposition stays validator-clean after a full
    engine wave AND after a fault-injected wave (the satellite: the
    validator must run against the real route, not synthetic tracers);
  * GET /api/v1/debug/dump (+ the per-session alias) serves a live
    bundle.
"""

import glob
import json
import urllib.request

import pytest

from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
from kube_scheduler_simulator_tpu_torch.models.workloads import make_nodes, make_pods
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.utils import blackbox, faults
from kube_scheduler_simulator_tpu_torch.utils.blackbox import (
    BLACKBOX, SLO, SLOTracker, TELEMETRY, validate_dump)
from kube_scheduler_simulator_tpu_torch.utils.tracing import (
    TRACER, validate_exposition)


@pytest.fixture(autouse=True)
def _clean_blackbox():
    BLACKBOX.reset()
    yield
    BLACKBOX.reset()
    blackbox.set_enabled(True)


def _cluster(n_nodes=6, n_pods=24, seed=1):
    store = ObjectStore()
    for n in make_nodes(n_nodes, seed=seed):
        store.create("nodes", n)
    for p in make_pods(n_pods, seed=seed + 1):
        store.create("pods", p)
    return store


def _engine(store, chunk=8):
    return SchedulerEngine(
        store, device="cpu", plugin_config=PluginSetConfig(enabled=["NodeResourcesFit"]),
        chunk=chunk)


def _state(store):
    out = {}
    for p in store.list("pods")[0]:
        meta = p.get("metadata") or {}
        out[meta.get("name", "")] = (
            (p.get("spec") or {}).get("nodeName"),
            dict(meta.get("annotations") or {}))
    return out


# ---------------------------------------------------------------- dumps


def test_fault_injected_wave_writes_schema_valid_dump(monkeypatch, tmp_path):
    """The headline acceptance: a transient fault with the retry budget
    exhausted aborts the wave and auto-writes a post-mortem dump with
    the round history, the classified trip, the protocol action, and
    the wave's counter deltas."""
    monkeypatch.setenv("KSS_TPU_WAVE_MAX_RETRIES", "0")
    monkeypatch.setenv("KSS_TPU_BLACKBOX_DIR", str(tmp_path))
    engine = _engine(_cluster())
    plan = faults.FaultPlan(
        [faults.FaultRule("replay.decision_fetch", nth=2, error="runtime")],
        seed=3)
    with faults.armed(plan):
        with pytest.raises(faults.InjectedFault):
            engine.schedule_pending()
    engine.close()
    files = sorted(glob.glob(str(tmp_path / "blackbox-*.json")))
    assert files, "no dump auto-written on wave abort"
    doc = json.loads(open(files[-1]).read())
    res = validate_dump(doc, require_fault=True, require_rounds=True)
    assert doc["reason"] == "wave_abort"
    assert doc["cause"]["seam"] == "replay.decision_fetch"
    assert doc["cause"]["classification"] == "transient"
    assert res["kinds"]["speculative.round"] >= 1
    assert res["kinds"]["wave.abort"] == 1
    # counter deltas are for THIS wave (baseline pinned at wave.start)
    assert any(k.startswith("fault_injected_total")
               for k in doc["counter_deltas"])
    # the armed plan ships in the bundle
    assert doc["fault_plan"]["rules"][0]["seam"] == "replay.decision_fetch"
    assert doc["fault_plan"]["rules"][0]["trips"] == 1
    # open spans AT fault time survived the unwind
    assert "replay_and_decode_stream" in [
        s["name"] for s in doc["open_spans"]]
    # the in-memory ring kept the dump too
    assert BLACKBOX.last_dump()["reason"] == "wave_abort"
    assert BLACKBOX.recent_dumps()[-1]["path"] == files[-1]


def test_transient_retry_records_action_and_heals(monkeypatch):
    """With budget left the same fault heals via suffix retry — the ring
    must show trip -> wave.retry -> wave.end, and no abort dump."""
    monkeypatch.setenv("KSS_TPU_WAVE_MAX_RETRIES", "3")
    store = _cluster()
    engine = _engine(store)
    plan = faults.FaultPlan(
        [faults.FaultRule("replay.decision_fetch", nth=2, error="runtime")],
        seed=3)
    with faults.armed(plan):
        bound = engine.schedule_pending()
    engine.close()
    assert bound > 0
    kinds = {}
    for ev in BLACKBOX.events():
        kinds[ev["kind"]] = kinds.get(ev["kind"], 0) + 1
    assert kinds.get("fault.trip") == 1
    assert kinds.get("wave.retry") == 1
    assert kinds.get("wave.end", 0) >= 1
    assert not kinds.get("wave.abort")
    assert BLACKBOX.last_dump() is None


def test_structural_fault_degradation_dumps_in_memory(monkeypatch):
    """A structural (memory) fault steps the ladder down; the black box
    records the degrade transition and snapshots a degradation bundle
    without needing a dump dir."""
    monkeypatch.delenv("KSS_TPU_BLACKBOX_DIR", raising=False)
    store = _cluster()
    engine = _engine(store)
    plan = faults.FaultPlan(
        [faults.FaultRule("replay.scan_dispatch", nth=1, error="memory")],
        seed=5)
    with faults.armed(plan):
        bound = engine.schedule_pending()
    assert bound > 0
    assert engine.result_mode() == "host_resident"
    engine.close()
    evs = [e for e in BLACKBOX.events() if e["kind"] == "degrade"]
    assert evs and evs[0]["from_mode"] == "device_resident"
    assert evs[0]["to_mode"] == "host_resident"
    dump = BLACKBOX.last_dump()
    assert dump is not None and dump["reason"] == "degradation"
    assert dump["path"] is None  # in-memory only, no dir set
    validate_dump(dump)


def test_disabled_blackbox_records_nothing_and_bytes_match(monkeypatch):
    """KSS_TPU_BLACKBOX=0 A/B: identical annotations, zero events."""
    results = {}
    for arm in (True, False):
        blackbox.set_enabled(arm)
        BLACKBOX.reset()
        store = _cluster(seed=11)
        engine = _engine(store)
        engine.schedule_pending()
        results[arm] = _state(store)
        if arm is False:
            assert BLACKBOX.events() == []
        else:
            assert any(e["kind"] == "wave.start" for e in BLACKBOX.events())
        engine.close()
    assert results[True] == results[False]


def test_session_scoped_bundle_excludes_neighbor_events():
    """A session-scoped dump must not leak a neighbor's activity; the
    sessionless bundle keeps the whole ring."""
    with TRACER.session_scope("tenant-a"):
        BLACKBOX.record("wave.start", pods=1)
    with TRACER.session_scope("tenant-b"):
        BLACKBOX.record("wave.start", pods=2)
    a = BLACKBOX.bundle("request", session="tenant-a")
    assert {e.get("session") for e in a["events"]} == {"tenant-a"}
    full = BLACKBOX.bundle("request", session=None)
    assert {e.get("session") for e in full["events"]} == {
        "tenant-a", "tenant-b"}
    # eviction releases the per-session baseline
    BLACKBOX.wave_start("tenant-a", pods=1)
    assert "tenant-a" in BLACKBOX._baselines
    BLACKBOX.drop_session("tenant-a")
    assert "tenant-a" not in BLACKBOX._baselines


def test_disabled_blackbox_skips_open_span_registry():
    from kube_scheduler_simulator_tpu_torch.utils import tracing

    blackbox.set_enabled(False)
    try:
        assert tracing.BLACKBOX_OPEN_SPANS is False
        with TRACER.span("gated"):
            assert TRACER.open_spans() == []
    finally:
        blackbox.set_enabled(True)
    assert tracing.BLACKBOX_OPEN_SPANS is True


def test_counter_deltas_reset_per_wave():
    store = _cluster(n_pods=8, seed=21)
    engine = _engine(store)
    engine.schedule_pending()
    first = BLACKBOX.counter_deltas(None)
    assert first  # the wave moved counters
    # a fresh wave_start re-pins the baseline: deltas go back to ~zero
    BLACKBOX.wave_start(None, pods=0, mode="device_resident")
    assert BLACKBOX.counter_deltas(None) == {}
    engine.close()


# ------------------------------------------------------------- SLO plane


def test_slo_tracker_percentiles_and_window():
    t = SLOTracker(window=8)
    for i in range(20):  # only the last 8 stay in the window
        t.observe_wave("s1", seconds=0.1 * (i + 1), pods=10)
    s = t.stats("s1")
    assert s["waves"] == 8
    assert s["p50WaveSeconds"] == pytest.approx(1.7)
    assert s["p99WaveSeconds"] == pytest.approx(2.0)
    assert s["cyclesPerSec"] == pytest.approx(80 / sum(
        0.1 * (i + 1) for i in range(12, 20)), abs=0.06)
    assert t.stats("nobody") is None
    assert "s1" in t.snapshot()


def test_engine_wave_feeds_slo():
    SLO.reset()
    store = _cluster(n_pods=8, seed=31)
    engine = _engine(store)
    engine.schedule_pending()
    engine.close()
    s = SLO.stats(None)
    assert s is not None and s["waves"] >= 1
    assert s["p99WaveSeconds"] > 0 and s["cyclesPerSec"] > 0


# -------------------------------------------------------- HTTP surfaces


@pytest.fixture()
def server():
    from kube_scheduler_simulator_tpu_torch.config.config import (
        SimulatorConfiguration)
    from kube_scheduler_simulator_tpu_torch.server.di import DIContainer
    from kube_scheduler_simulator_tpu_torch.server.server import SimulatorServer

    di = DIContainer(SimulatorConfiguration(port=0), device="cpu")
    srv = SimulatorServer(di, port=0)
    srv.start(block=False)
    yield srv
    srv.shutdown()


def _get(srv, path):
    url = f"http://127.0.0.1:{srv.port}{path}"
    with urllib.request.urlopen(url, timeout=10) as r:
        raw = r.read()
        ctype = r.headers.get("Content-Type", "")
        return (json.loads(raw) if ctype.startswith("application/json")
                else raw.decode())


def _post(srv, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}",
        data=json.dumps(body).encode(), method="POST",
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.loads(r.read() or b"null")


def _schedule_via_server(srv, n_nodes=3, n_pods=5, seed=41):
    import time

    for n in make_nodes(n_nodes, seed=seed):
        _post(srv, "/api/v1/nodes", n)
    for p in make_pods(n_pods, seed=seed + 1):
        _post(srv, "/api/v1/pods", p)
    deadline = time.time() + 30
    while time.time() < deadline:
        pods = _get(srv, "/api/v1/pods")["items"]
        if all((p.get("spec") or {}).get("nodeName") for p in pods):
            return
        time.sleep(0.1)
    raise AssertionError("pods never scheduled")


def test_live_metrics_route_validates_after_full_and_faulted_waves(server):
    """Satellite: validate_exposition against the REAL /metrics route —
    after a full engine wave, and again after a fault-injected wave
    exercised the wave_faults/retry families."""
    _schedule_via_server(server)
    fams = validate_exposition(_get(server, "/metrics"))
    assert "kss_tpu_pods_scheduled_total" in fams
    # HBM gauges: the sampler ran at server start; on the CPU backend
    # the EXPLICIT no-op marker is exported instead of silent absence
    assert fams["kss_tpu_hbm_stats_available"]["type"] == "gauge"
    assert fams["kss_tpu_hbm_stats_available"]["samples"][0][2] == "0"
    snap = _get(server, "/api/v1/metrics")
    assert snap["gauges"].get("hbm_stats_available") == 0
    assert "time_split" in snap

    # fault-injected wave through the same live engine
    plan = faults.FaultPlan(
        [faults.FaultRule("replay.decision_fetch", nth=1, error="runtime",
                          sessions=["default"])], seed=9)
    with faults.armed(plan):
        for p in make_pods(4, seed=77):
            p["metadata"]["name"] = "faulted-" + p["metadata"]["name"]
            _post(server, "/api/v1/pods", p)
        import time

        deadline = time.time() + 30
        while time.time() < deadline:
            snap = _get(server, "/api/v1/metrics")
            lc = snap["labeled_counters"].get("fault_injected_total") or []
            if lc:
                break
            time.sleep(0.1)
        assert lc, "the armed fault never fired through the live loop"
    fams = validate_exposition(_get(server, "/metrics"))
    assert "kss_tpu_fault_injected_total" in fams
    assert "kss_tpu_wave_faults_total" in fams


def test_debug_dump_route_and_session_alias(server):
    _schedule_via_server(server, seed=51)
    body = _get(server, "/api/v1/debug/dump")
    dump = body["dump"]
    validate_dump(dump)
    assert dump["reason"] == "request"
    kinds = {e["kind"] for e in dump["events"]}
    assert "wave.start" in kinds and "wave.end" in kinds
    assert dump["device"]["hbm_available"] is False  # CPU backend
    assert "KSS_TPU" not in dump["env"] or isinstance(dump["env"], dict)
    # per-session alias pins the session filter: only that session's
    # events (and open spans / recent dumps) appear in the bundle
    body2 = _get(server, "/api/v1/sessions/default/debug/dump")
    assert body2["dump"]["session"] == "default"
    assert body2["dump"]["events"], "default session's own events missing"
    assert {e.get("session") for e in body2["dump"]["events"]} == {"default"}
    assert all(s.get("session") == "default"
               for s in body2["dump"]["open_spans"])
    assert all(d.get("session") == "default" for d in body2["recent"])
    assert isinstance(body["recent"], list)


def test_slo_on_sessions_and_readyz(server):
    SLO.reset()
    _schedule_via_server(server, seed=61)
    sessions = _get(server, "/api/v1/sessions")["items"]
    default = [s for s in sessions if s["id"] == "default"][0]
    assert default["slo"] is not None
    assert default["slo"]["waves"] >= 1
    assert default["slo"]["p99WaveSeconds"] > 0
    ready = _get(server, "/readyz")
    assert ready["slo"]["default"]["p99WaveSeconds"] > 0
    assert ready["slo"]["default"]["cyclesPerSec"] > 0


# ------------------------------------------------- compile observability


def test_compile_build_histogram_and_cache_gauge():
    """The port keeps the JAX seam's build telemetry where it builds a
    wave's step (framework/pipeline.py build_step, the `compile.build`
    seam's site): the histogram and the black-box event.  The JAX
    package's `scan_compile_cache_entries` gauge counts its compiled-scan
    cache, which the port does not have (its kernels are built once, as
    libraries): here the gauge must be absent, not zero."""
    TRACER.reset()
    # an odd shape this process has not compiled: forces a cache miss
    store = ObjectStore()
    for n in make_nodes(7, seed=71):
        store.create("nodes", n)
    for p in make_pods(9, seed=72):
        store.create("pods", p)
    engine = _engine(store, chunk=4)
    engine.schedule_pending()
    engine.close()
    snap = TRACER.snapshot()
    hist = snap["histograms"].get("scan_compile_build_seconds")
    assert hist is not None and hist["series"], "no build histogram"
    assert all("key" in s["labels"] and s["labels"]["result"] == "ok"
               for s in hist["series"])
    assert "scan_compile_cache_entries" not in snap["gauges"]
    builds = [e for e in BLACKBOX.events() if e["kind"] == "compile.build"]
    assert builds and builds[0]["seconds"] >= 0


def test_device_telemetry_explicit_noop_on_cpu():
    out = TELEMETRY.sample_once()
    assert out["available"] is False  # CPU backend has no memory_stats
    assert out["bytes_in_use"] is None
    snap = TRACER.snapshot()
    assert snap["gauges"]["hbm_stats_available"] == 0
    assert "hbm_bytes_in_use" not in snap["gauges"]
