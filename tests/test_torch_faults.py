"""Fault seams and the wave failure protocol in the port (utils/faults.py,
framework/engine.py `_WaveAbort` / `_degrade`).

Each engine case of tests/test_faults.py runs twice under the same plan:
once on the JAX engine, once on the port's (`device="cpu"`), and the two
must agree on the plan's trips, the retries and degradations counted, the
degradation rung reached, and every pod's nodeName and annotations, byte
for byte.  Then every seam of the port's `SEAMS` is tripped at its call
site (the port threads each at the JAX package's step), and the session
seams and the decode heal are held as in the JAX tests."""

from __future__ import annotations

import pytest

from kube_scheduler_simulator_tpu.cluster.store import ObjectStore as JaxStore
from kube_scheduler_simulator_tpu.framework.engine import SchedulerEngine as JaxEngine
from kube_scheduler_simulator_tpu.utils import faults as jfaults
from kube_scheduler_simulator_tpu.utils.tracing import TRACER as JTRACER
from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
from kube_scheduler_simulator_tpu_torch.utils import faults
from kube_scheduler_simulator_tpu_torch.utils.faults import InjectedFault
from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER


def _counter(tracer, name: str, **labels) -> float:
    snap = tracer.snapshot()
    if not labels:
        return (snap.get("counters") or {}).get(name, 0)
    for e in (snap.get("labeled_counters") or {}).get(name, []):
        if all(e["labels"].get(k) == v for k, v in labels.items()):
            return e["value"]
    return 0


def _cluster(store_cls, n_nodes=3, n_pods=20, gated=()):
    s = store_cls()
    for i in range(n_nodes):
        s.create("nodes", {
            "metadata": {"name": f"n{i}"},
            "status": {"allocatable": {"cpu": "8", "memory": "16Gi", "pods": "110"}}})
    for i in range(n_pods):
        pod = {"metadata": {"name": f"p{i:03d}", "namespace": "default"},
               "spec": {"containers": [{"name": "c", "resources": {
                   "requests": {"cpu": "100m", "memory": "64Mi"}}}]}}
        if i in gated:
            pod["spec"]["schedulingGates"] = [{"name": "hold"}]
        s.create("pods", pod)
    return s


def _state(store):
    out = {}
    for p in store.list("pods")[0]:
        meta = p["metadata"]
        out[meta["name"]] = ((p.get("spec") or {}).get("nodeName"),
                             dict(meta.get("annotations") or {}))
    return out


class _Side:
    """One package's engine, store, fault module and tracer."""

    def __init__(self, port: bool, chunk=8, **cluster):
        self.port = port
        self.faults = faults if port else jfaults
        self.tracer = TRACER if port else JTRACER
        self.store = _cluster(ObjectStore if port else JaxStore, **cluster)
        self.engine = (SchedulerEngine(self.store, chunk=chunk, device="cpu") if port
                       else JaxEngine(self.store, chunk=chunk))
        self.engine._retry_sleep = lambda _d: None

    def plan(self, rules: list[dict], seed=1):
        return self.faults.FaultPlan.from_dict({"seed": seed, "rules": rules})

    def count(self, name, **labels):
        return _counter(self.tracer, name, **labels)


COUNTED = (
    ("wave_retries_total", {}),
    ("wave_faults_total", {"seam": "replay.scan_dispatch", "action": "retried"}),
    ("wave_faults_total", {"seam": "replay.decision_fetch", "action": "retried"}),
    ("wave_faults_total", {"seam": "replay.decision_fetch", "action": "aborted"}),
    ("wave_faults_total", {"seam": "replay.scan_dispatch", "action": "degraded"}),
    ("wave_faults_total", {"seam": "compile.build", "action": "retried"}),
    ("wave_degradations_total", {"from": "device_resident", "to": "host_resident"}),
    ("wave_degradations_total", {"from": "host_resident", "to": "eager_decode"}),
)


def _run(port: bool, rules: list[dict], body=None, **cluster):
    """Run `body(side)` (default: one schedule_pending) under the plan ->
    (trips per rule, counter deltas, result mode, state, body's value,
    the side)."""
    side = _Side(port, **cluster)
    plan = side.plan(rules)
    before = [side.count(n, **lb) for n, lb in COUNTED]
    with side.faults.armed(plan):
        value = body(side) if body else side.engine.schedule_pending()
    deltas = [side.count(n, **lb) - b for (n, lb), b in zip(COUNTED, before)]
    trips = [r["trips"] for r in plan.stats()["rules"]]
    return trips, deltas, side.engine.result_mode(), _state(side.store), value, side


def _both(rules, body=None, **cluster):
    """The case on both engines; they must agree.  -> the port's _run
    result, then the JAX side."""
    jax = _run(False, rules, body, **cluster)
    port = _run(True, rules, body, **cluster)
    assert port[0] == jax[0], f"trips: port {port[0]} jax {jax[0]}"
    assert port[1] == jax[1], f"counters {[n for n, _ in COUNTED]}: port {port[1]} jax {jax[1]}"
    assert port[2] == jax[2], f"rung: port {port[2]} jax {jax[2]}"
    assert port[3] == jax[3], "pods differ between the port and the JAX engine"
    assert port[4] == jax[4]
    return (*port[:5], port[5], jax[5])


def _reference(**cluster):
    side = _Side(True, **cluster)
    side.engine.schedule_pending()
    return _state(side.store)


# ------------------------------------------------- wave failure protocol


def test_transient_scan_fault_retries_suffix_bit_identical():
    trips, deltas, _, state, bound, *_ = _both(
        [{"seam": "replay.scan_dispatch", "nth": 2, "error": "runtime"}])
    assert trips == [1] and bound == 20 and deltas[0] >= 1 and deltas[1] >= 1
    assert state == _reference()


def test_transient_fetch_fault_retries_bit_identical():
    trips, _, _, state, bound, *_ = _both(
        [{"seam": "replay.decision_fetch", "nth": 2, "error": "io"}])
    assert trips == [1] and bound == 20
    assert state == _reference()


def test_retry_suffix_aligns_with_filtered_pending():
    """Gated pods drop out of the pending list before the commit
    watermark is cut: a fault must not shift the retried suffix."""
    trips, _, _, state, bound, *_ = _both(
        [{"seam": "replay.scan_dispatch", "nth": 2, "error": "runtime"}], gated=(2, 9))
    assert trips == [1] and bound == 18
    assert state == _reference(gated=(2, 9))


def test_structural_fault_steps_down_ladder_losslessly():
    trips, deltas, rung, state, *_ = _both(
        [{"seam": "replay.scan_dispatch", "nth": 1, "error": "memory"}])
    assert rung == "host_resident" and deltas[6] >= 1
    assert state == _reference()


def test_double_structural_fault_reaches_eager():
    _, deltas, rung, state, *_ = _both(
        [{"seam": "replay.scan_dispatch", "nth": 1, "error": "memory"},
         {"seam": "replay.scan_dispatch", "nth": 2, "error": "memory"}])
    assert rung == "eager_decode" and deltas[7] >= 1
    assert state == _reference()


def test_probe_recovery_steps_back_up(monkeypatch):
    monkeypatch.setenv("KSS_TPU_DEGRADE_PROBE_WAVES", "2")

    def body(side):
        first = side.engine.schedule_pending()
        mid = side.engine.result_mode()
        side.store.create("pods", {
            "metadata": {"name": "late", "namespace": "default"},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": "100m", "memory": "64Mi"}}}]}})
        return first, mid, side.engine.schedule_pending()

    _, _, rung, _, (first, mid, second), *_ = _both(
        [{"seam": "replay.scan_dispatch", "nth": 1, "error": "memory"}], body, n_pods=6)
    assert (first, mid, second, rung) == (6, "host_resident", 1, "device_resident")


def test_retries_exhausted_aborts_with_committed_prefix_standing(monkeypatch):
    """With retries off, a mid-stream fetch failure aborts the wave with a
    committed prefix standing, in both engines alike, and the next wave
    finishes the queue."""
    monkeypatch.setenv("KSS_TPU_WAVE_MAX_RETRIES", "0")

    def body(side):
        with pytest.raises(InjectedFault if side.port else jfaults.InjectedFault):
            side.engine.schedule_pending()
        state = _state(side.store)
        bound = sorted(n for n, (node, _a) in state.items() if node)
        assert bound == sorted(state)[:len(bound)]
        return len(bound)

    _, deltas, _, _, n_bound, port, jax = _both(
        [{"seam": "replay.decision_fetch", "p": 1.0}], body)
    assert deltas[3] >= 1
    # the leftover pods reschedule cleanly on the next, fault-free wave
    monkeypatch.setenv("KSS_TPU_WAVE_MAX_RETRIES", "3")
    assert port.engine.schedule_pending() == jax.engine.schedule_pending() == 20 - n_bound
    assert _state(port.store) == _state(jax.store) == _reference()


def test_compile_build_fault_retries_bit_identical():
    """The first build of the wave's step faults; the retry builds it
    again.  The JAX package fires the seam where its compile cache builds
    a program, the port where it builds a workload's Step: with the JAX
    cache cold, the first build is the wave's first in both."""
    from kube_scheduler_simulator_tpu.framework.replay import _SCAN_CACHE

    with _SCAN_CACHE._mu:
        _SCAN_CACHE._entries.clear()
    trips, deltas, _, state, bound, *_ = _both(
        [{"seam": "compile.build", "nth": 1, "error": "runtime"}])
    assert trips == [1] and bound == 20 and deltas[5] >= 1
    assert state == _reference()


# ------------------------------------------------- every seam trips


def _trip_decode(side):
    side.engine.schedule_pending()  # lazy: decode deferred to the read
    return None


SEAM_CASES = {
    "replay.scan_dispatch": "engine",
    "replay.decision_fetch": "engine",
    "compile.build": "engine",
    "speculative.round": "stream",
    "fuse.dispatch": "fuse",
    "replay.materialize": "cold_read",
    "replay.budget_spill": "spill",
    "decode.chunk": "decode",
    "reflector.write_back": "reflect",
    "session.create": "session_create",
    "session.evict": "session_evict",
    "autopilot.decide": "autopilot",
    "store.columnar_sync": "columnar_sync",
}


def test_every_seam_has_a_case():
    assert set(SEAM_CASES) == set(faults.SEAMS)


def _drive(kind: str, monkeypatch):
    from kube_scheduler_simulator_tpu_torch.models.workloads import make_slot_pinned_workload
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.state.compile import compile_workload

    if kind == "engine":
        side = _Side(True)
        side.engine._retry_sleep = lambda _d: None
        side.engine.schedule_pending()
        return
    if kind in ("stream", "fuse"):
        from kube_scheduler_simulator_tpu_torch.parallel.speculative import (
            replay_speculative_stream)

        monkeypatch.setenv("KSS_TPU_FUSE", "1")  # every round goes through FUSE.dispatch
        nodes, pods = make_slot_pinned_workload(16, 8, seed=3)
        cw = compile_workload(nodes, pods, PluginSetConfig(enabled=["NodeResourcesFit"]),
                              device="cpu")
        replay_speculative_stream(cw, chunk=8, device="cpu")
        return
    if kind in ("cold_read", "spill"):
        from kube_scheduler_simulator_tpu_torch.framework.replay import _DEVICE_BUDGET, replay
        from kube_scheduler_simulator_tpu_torch.models import baseline_config

        nodes, pods, cfg = baseline_config(5, scale=0.002, seed=0)
        cw = compile_workload(nodes, pods, cfg, device="cpu")
        if kind == "spill":
            monkeypatch.setenv("KSS_TPU_DEVICE_RESULT_BUDGET_MB", "0")
        rr = replay(cw, chunk=4, device="cpu", device_resident=True)
        if kind == "spill":
            _DEVICE_BUDGET.drain()
            return
        rr._compact.host("packed", 0)
        return
    if kind == "decode":
        side = _Side(True)
        side.engine.schedule_pending()
        _state(side.store)
        return
    if kind == "reflect":
        from kube_scheduler_simulator_tpu_torch.store import annotations as ann
        from kube_scheduler_simulator_tpu_torch.store.reflector import StoreReflector
        from kube_scheduler_simulator_tpu_torch.store.resultstore import ResultStore

        s = ObjectStore()
        s.create("pods", {"metadata": {"name": "p", "namespace": "default"}, "spec": {}})
        rs = ResultStore()
        rs.add_selected_node("default", "p", "n1")
        refl = StoreReflector(s, sleep=lambda _t: None)
        refl.add_result_store(rs, "k")
        refl.reflect("default", "p")
        assert s.get("pods", "p", "default")["metadata"]["annotations"][ann.SELECTED_NODE] == "n1"
        return
    if kind in ("session_create", "session_evict"):
        from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager

        mgr = SessionManager(max_sessions=4, idle_ttl=0, start_scheduler=False, device="cpu")
        try:
            if kind == "session_create":
                with pytest.raises(InjectedFault):
                    mgr.create("s1")
            mgr.create("s1")
            mgr.delete("s1")
        finally:
            mgr.shutdown()
        return
    if kind == "autopilot":
        from kube_scheduler_simulator_tpu_torch.control import CONTROLS
        from kube_scheduler_simulator_tpu_torch.control.autopilot import Autopilot
        from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager

        mgr = SessionManager(max_sessions=2, idle_ttl=0, start_scheduler=False, device="cpu")
        try:
            CONTROLS.set_budget_weight("default", 2.0)
            pilot = Autopilot(mgr)
            before = _counter(TRACER, "autopilot_failsafe_total")
            # two ticks of all-accepted rounds: the speculative effector
            # plans a profile change, whose application is the seam
            for _ in range(2):
                with TRACER.session_scope("default"):
                    TRACER.inc("speculative_accepted_total", 100)
                pilot.tick()
            assert _counter(TRACER, "autopilot_failsafe_total") > before
            assert CONTROLS.stats() == {}  # the fail-safe reverted every effector
        finally:
            CONTROLS.reset()
            mgr.shutdown()
        return
    if kind == "columnar_sync":
        # the store's write mirror absorbs the fault: the row goes opaque
        # and the manifest stays authoritative
        s = ObjectStore()
        s.create("nodes", {"metadata": {"name": "n1"},
                           "status": {"allocatable": {"cpu": "1", "pods": "10"}}})
        bank = s._banks["nodes"]
        assert bank.opaque[bank.row_of["n1"]]
        assert s.get("nodes", "n1")["status"]["allocatable"]["cpu"] == "1"
        return
    raise AssertionError(kind)


@pytest.mark.parametrize("seam", sorted(SEAM_CASES))
def test_every_seam_trips_at_its_site(seam, monkeypatch):
    """nth=1 of each seam trips exactly once on the path that threads it.
    The engine paths absorb the fault (retry, re-read, failsafe); the
    direct paths that surface it accept InjectedFault."""
    monkeypatch.setenv("KSS_TPU_FUSE_WINDOW_MS", "1")
    plan = faults.FaultPlan([faults.FaultRule(seam, nth=1, error="runtime")], seed=1)
    with faults.armed(plan):
        try:
            _drive(SEAM_CASES[seam], monkeypatch)
        except InjectedFault as e:
            assert e.seam == seam
    rule = plan.stats()["rules"][0]
    assert rule["trips"] == 1, f"{seam} never fired: {rule}"


# --------------------------------------------------- decode heal


def test_decode_fault_is_visible_and_heals_on_reread(monkeypatch):
    monkeypatch.setenv("KSS_TPU_EAGER_DECODE", "1")
    ref = _reference()
    monkeypatch.delenv("KSS_TPU_EAGER_DECODE")
    side = _Side(True)
    assert side.engine.schedule_pending() == 20  # lazy: decode deferred
    before = sum(side.count("decode_failures_total", path=p)
                 for p in ("native_chunk", "python"))
    with faults.armed(side.plan([{"seam": "decode.chunk", "nth": 1}])):
        with pytest.raises(InjectedFault):
            _state(side.store)  # the first read surfaces the fault
        healed = _state(side.store)  # the re-read heals it
    after = sum(side.count("decode_failures_total", path=p)
                for p in ("native_chunk", "python"))
    assert after > before
    assert healed == ref


# ------------------------------------------------------- session seams


def test_session_create_fault_releases_reservation():
    from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager

    mgr = SessionManager(max_sessions=4, idle_ttl=0, start_scheduler=False, device="cpu")
    try:
        plan = faults.FaultPlan([faults.FaultRule("session.create", nth=1)], seed=1)
        with faults.armed(plan):
            with pytest.raises(InjectedFault):
                mgr.create("s1")
            sess = mgr.create("s1")  # the reservation was released
        assert sess.id == "s1"
        assert {s["id"] for s in mgr.list_sessions()} == {"default", "s1"}
    finally:
        mgr.shutdown()


def test_session_evict_fault_counted_not_wedging():
    from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager

    mgr = SessionManager(max_sessions=4, idle_ttl=0, start_scheduler=False, device="cpu")
    try:
        mgr.create("s1")
        before = _counter(TRACER, "session_teardown_failures_total", reason="explicit")
        plan = faults.FaultPlan([faults.FaultRule("session.evict", nth=1)], seed=1)
        with faults.armed(plan):
            mgr.delete("s1")  # teardown fault: counted, not raised
        assert _counter(TRACER, "session_teardown_failures_total", reason="explicit") > before
        assert {s["id"] for s in mgr.list_sessions()} == {"default"}
        mgr.create("s1")  # admission still works
    finally:
        mgr.shutdown()


def test_sessions_surface_degraded_mode():
    from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager

    mgr = SessionManager(max_sessions=4, idle_ttl=0, start_scheduler=False, device="cpu")
    try:
        info = mgr.default.info()
        assert info["resultMode"] == "device_resident" and info["degraded"] is False
        mgr.default.di.engine._degrade("test")
        info = mgr.default.info()
        assert info["resultMode"] == "host_resident" and info["degraded"] is True
    finally:
        mgr.shutdown()


def test_materialize_streak_and_budget_shares_are_per_session(monkeypatch):
    """A session's failed cold reads count against its own streak only,
    and the device budget attributes retained chunks to their session."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import (
        _DEVICE_BUDGET, materialize_failure_streak, replay, reset_materialize_failures)
    from kube_scheduler_simulator_tpu_torch.models import baseline_config
    from kube_scheduler_simulator_tpu_torch.state.compile import compile_workload

    nodes, pods, cfg = baseline_config(5, scale=0.002, seed=0)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    with TRACER.session_scope("streak-a"):
        rr = replay(cw, chunk=4, device="cpu", device_resident=True)
        with faults.armed(faults.FaultPlan([faults.FaultRule("replay.materialize", nth=1)])):
            with pytest.raises(InjectedFault):
                rr._compact.host("packed", 0)
    assert materialize_failure_streak("streak-a") == 1
    assert materialize_failure_streak("streak-b") == 0
    reset_materialize_failures("streak-a")
    assert materialize_failure_streak("streak-a") == 0
    # the failed read left chunk 0 on the device: every chunk is still
    # retained, attributed to the session that produced it
    assert _DEVICE_BUDGET.retained_by_session()["streak-a"][0] == len(rr._compact.packed)
