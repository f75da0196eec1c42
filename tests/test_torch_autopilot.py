"""Mirror of tests/test_autopilot.py against the port
(kube_scheduler_simulator_tpu_torch), every case on `device="cpu"`: the
same cases under the same names, with every SessionManager, DIContainer
and SchedulerEngine built on the CPU.  No case reads a TPU-only field.

SLO-driven autopilot (control/, docs/autopilot.md).

Covers the closed loop end to end: the fail-safe env switch, qos
admission, each effector driven with synthetic telemetry through
direct tick() calls (speculative hysteresis without thrash, HBM weight
raise/decay/donate, shed with the 0.8x recovery band), the weighted
budget-share enforcement spilling only the fat session's own chunks,
the HTTP 429 + Retry-After contract through a real server, byte-parity
of a scheduling run with the controls registry empty vs populated for
an unrelated session, the fail-safe full revert on a faulted tick, the
autopilot.decide black-box schema, idle eviction under pressure
(tier order, critical never), and churn-workload determinism.
"""

from __future__ import annotations

import copy
import json
import time
import urllib.error
import urllib.request

import pytest

from kube_scheduler_simulator_tpu_torch.config.config import SimulatorConfiguration
from kube_scheduler_simulator_tpu_torch.control import CONTROLS, QOS_TIERS
from kube_scheduler_simulator_tpu_torch.control.autopilot import (
    HYSTERESIS_TICKS, _SPEC_MID_TICKS, Autopilot, autopilot_enabled,
    shed_qos_tiers)
from kube_scheduler_simulator_tpu_torch.framework.replay import _DeviceResultBudget
from kube_scheduler_simulator_tpu_torch.models.workloads import (
    make_churn_workload, make_nodes, make_pods)
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.server.di import DIContainer
from kube_scheduler_simulator_tpu_torch.server.server import SimulatorServer
from kube_scheduler_simulator_tpu_torch.server.sessions import (
    SessionError, SessionManager)
from kube_scheduler_simulator_tpu_torch.utils.blackbox import (
    BLACKBOX, SLO, validate_dump)
from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

ENABLED = ["NodeResourcesFit", "NodeResourcesBalancedAllocation",
           "NodeAffinity", "TaintToleration", "PodTopologySpread"]


@pytest.fixture(autouse=True)
def _clean_controls():
    """Every test starts and ends at the parity baseline — leaked
    overrides would silently reshape unrelated suites' budgets."""
    CONTROLS.reset()
    yield
    CONTROLS.reset()


def _mgr(**kw) -> SessionManager:
    kw.setdefault("cfg", SimulatorConfiguration(port=0))
    kw.setdefault("start_scheduler", False)
    kw.setdefault("idle_ttl", 0)
    kw.setdefault("device", "cpu")
    return SessionManager(**kw)


def _fill_slo(session: str, seconds: float, n: int = 70) -> None:
    """Saturate the session's rolling window so p99 IS `seconds`."""
    for _ in range(n):
        SLO.observe_wave(session, seconds, pods=10)


# ------------------------------------------------- env knob fail-safety


def test_autopilot_env_switch_fails_off_on_garbage(monkeypatch):
    monkeypatch.delenv("KSS_TPU_AUTOPILOT", raising=False)
    assert autopilot_enabled() is True
    for raw, want in (("1", True), ("true", True), ("on", True),
                      ("0", False), ("false", False), ("off", False),
                      ("maybe", False), ("2", False)):
        monkeypatch.setenv("KSS_TPU_AUTOPILOT", raw)
        assert autopilot_enabled() is want, raw


def test_shed_qos_tiers_parse_fail_safe(monkeypatch):
    monkeypatch.delenv("KSS_TPU_AUTOPILOT_SHED_QOS", raising=False)
    assert shed_qos_tiers() == ("best-effort", "standard")
    monkeypatch.setenv("KSS_TPU_AUTOPILOT_SHED_QOS", "best-effort")
    assert shed_qos_tiers() == ("best-effort",)
    # unknown tokens drop; critical is never sheddable
    monkeypatch.setenv("KSS_TPU_AUTOPILOT_SHED_QOS", "bogus, standard")
    assert shed_qos_tiers() == ("standard",)
    monkeypatch.setenv("KSS_TPU_AUTOPILOT_SHED_QOS", "critical,bogus")
    assert shed_qos_tiers() == ("best-effort", "standard")


def test_session_qos_validated_on_create():
    mgr = _mgr(max_sessions=4)
    try:
        sess = mgr.create("q-crit", qos="critical")
        assert sess.info()["qos"] == "critical"
        assert mgr.create("q-def").info()["qos"] == "standard"
        with pytest.raises(SessionError):
            mgr.create("q-bad", qos="turbo")
        briefs = {sid: qos for sid, qos, _t, _b in mgr.sessions_brief()}
        assert briefs["q-crit"] == "critical"
        assert all(q in QOS_TIERS for q in briefs.values())
    finally:
        mgr.shutdown()


# ------------------------------------------- effector: speculative tuning


def test_speculative_effector_hysteresis_no_thrash():
    mgr = _mgr(max_sessions=4)
    ap = Autopilot(mgr, interval=3600, slo_target=0)  # shed effector off
    try:
        mgr.create("ap-spec")

        def rounds(accepted: int, rolled: int) -> None:
            if accepted:
                TRACER.inc("speculative_accepted_total", accepted,
                           session="ap-spec")
            if rolled:
                TRACER.inc("speculative_rolled_back_total", rolled,
                           session="ap-spec")

        ap.tick()   # baseline tick: no evidence, no decision
        assert CONTROLS.spec_overrides("ap-spec") == (None, None)
        rounds(90, 10)
        ap.tick()   # streak 1 of HYSTERESIS_TICKS: still default
        assert CONTROLS.spec_overrides("ap-spec") == (None, None)
        rounds(95, 5)
        ap.tick()
        # sustained high accept fraction: top rung, doubled candidates
        assert CONTROLS.spec_overrides("ap-spec") == (-1, 256)

        # alternating good/bad waves never build a streak: no thrash
        for _ in range(HYSTERESIS_TICKS * 2):
            rounds(10, 90)
            ap.tick()
            rounds(90, 10)
            ap.tick()
        assert CONTROLS.spec_overrides("ap-spec") == (-1, 256)

        rounds(10, 90)
        ap.tick()
        rounds(5, 95)
        ap.tick()
        # sustained collapse: bottom rung, halved candidates
        assert CONTROLS.spec_overrides("ap-spec") == (0, 64)
        assert ap.stats()["decisions"] == 2
    finally:
        mgr.shutdown()


def test_speculative_profile_decays_to_default_on_mid_band():
    """A profile is not forever: a sustained mid-band accept fraction
    (no hi/lo evidence either way) decays the session back to the
    static default, mirroring the budget effector's calm-tick decay."""
    mgr = _mgr(max_sessions=4)
    ap = Autopilot(mgr, interval=3600, slo_target=0)
    try:
        mgr.create("ap-mid")

        def rounds(accepted: int, rolled: int) -> None:
            TRACER.inc("speculative_accepted_total", accepted,
                       session="ap-mid")
            TRACER.inc("speculative_rolled_back_total", rolled,
                       session="ap-mid")

        ap.tick()   # baseline
        for _ in range(HYSTERESIS_TICKS):
            rounds(95, 5)
            ap.tick()
        assert CONTROLS.spec_overrides("ap-mid") == (-1, 256)
        # mid-band rounds: no transition until the decay streak fills
        for _ in range(_SPEC_MID_TICKS - 1):
            rounds(70, 30)
            ap.tick()
            assert CONTROLS.spec_overrides("ap-mid") == (-1, 256)
        rounds(70, 30)
        ap.tick()
        assert CONTROLS.spec_overrides("ap-mid") == (None, None)
    finally:
        mgr.shutdown()


def test_speculative_candidates_scale_operator_baseline(monkeypatch):
    """The profile multipliers scale KSS_TPU_SPECULATIVE_CANDIDATES as
    the operator set it — aggressive on a 512 baseline means 1024,
    never a silent cut back to 2x the built-in 128."""
    monkeypatch.setenv("KSS_TPU_SPECULATIVE_CANDIDATES", "512")
    mgr = _mgr(max_sessions=4)
    ap = Autopilot(mgr, interval=3600, slo_target=0)
    try:
        mgr.create("ap-env")

        def rounds(accepted: int, rolled: int) -> None:
            TRACER.inc("speculative_accepted_total", accepted,
                       session="ap-env")
            TRACER.inc("speculative_rolled_back_total", rolled,
                       session="ap-env")

        ap.tick()   # baseline
        for _ in range(HYSTERESIS_TICKS):
            rounds(95, 5)
            ap.tick()
        assert CONTROLS.spec_overrides("ap-env") == (-1, 1024)
        for _ in range(HYSTERESIS_TICKS):
            rounds(5, 95)
            ap.tick()
        assert CONTROLS.spec_overrides("ap-env") == (0, 256)
    finally:
        mgr.shutdown()


# ----------------------------------------------- effector: HBM rebalance


def test_budget_effector_raises_decays_and_donates(monkeypatch):
    monkeypatch.setenv("KSS_TPU_DEVICE_RESULT_BUDGET_MB", "8")
    mgr = _mgr(max_sessions=4)
    ap = Autopilot(mgr, interval=3600, slo_target=0)
    try:
        mgr.create("ap-fat")
        mgr.create("ap-lean")
        for _ in range(2):
            TRACER.inc("device_chunks_spilled_total", 3, session="ap-fat")
            ap.tick()
        # two spilling ticks: +0.5 weight each
        assert CONTROLS.budget_milliweights()["ap-fat"] == 2000
        for _ in range(2):
            ap.tick()
        mw = CONTROLS.budget_milliweights()
        assert mw["ap-fat"] == 2000   # calm but not yet CALM_TICKS
        # lean session retained nothing for CALM_TICKS: donates headroom
        assert mw["ap-lean"] == 500
        for _ in range(3):
            ap.tick()
        # fat session decays back to the equal split once calm
        assert CONTROLS.budget_milliweights().get("ap-fat", 1000) == 1000
    finally:
        mgr.shutdown()


class _FakeCC:
    """Stands in for _CompactChunks: records which chunks the budget
    chose to spill and releases them like the real materialize."""

    def __init__(self, budget):
        self.budget = budget
        self.spilled: list[int] = []

    def materialize(self, ci: int, spill: bool = False):
        self.spilled.append(ci)
        self.budget.release(self, ci)


def test_weighted_shares_spill_only_the_fat_sessions_chunks(monkeypatch):
    monkeypatch.setenv("KSS_TPU_DEVICE_RESULT_BUDGET_MB", "1")
    chunk = 200 << 10   # 200 KiB

    def run(fat_weight: float | None) -> tuple[list[int], list[int]]:
        CONTROLS.reset()
        if fat_weight is not None:
            CONTROLS.set_budget_weight("bw-fat", fat_weight)
        budget = _DeviceResultBudget()
        fat, lean = _FakeCC(budget), _FakeCC(budget)
        with TRACER.session_scope("bw-fat"):
            for ci in range(4):           # 800 KiB
                budget.retain(fat, ci, chunk)
        with TRACER.session_scope("bw-lean"):
            budget.retain(lean, 0, chunk // 2)   # 100 KiB
        budget.drain()
        if budget._pool is not None:   # don't leak spill threads
            budget._pool.shutdown(wait=True)
        return fat.spilled, lean.spilled

    # equal split: each share is 512 KiB, the fat session spills its own
    # two least-recent chunks and never touches the lean neighbor
    fat_spilled, lean_spilled = run(None)
    assert fat_spilled == [0, 1] and lean_spilled == []
    # autopilot raised the fat session's weight to 3.0: its share grows
    # to 768 KiB, one spill suffices — the lean session still untouched
    fat_spilled, lean_spilled = run(3.0)
    assert fat_spilled == [0] and lean_spilled == []


# --------------------------------------------- effector: overload / shed


def test_shed_effector_hysteresis_and_recovery_band():
    mgr = _mgr(max_sessions=8)
    ap = Autopilot(mgr, interval=3600, slo_target=0.1)
    try:
        mgr.create("ap-shed", qos="best-effort")
        mgr.create("ap-crit", qos="critical")
        _fill_slo("ap-shed", 1.0)
        _fill_slo("ap-crit", 1.0)
        ap.tick()
        assert CONTROLS.shed_state("ap-shed") == (False, 0)  # streak 1
        ap.tick()
        shedding, retry = CONTROLS.shed_state("ap-shed")
        assert shedding and retry == 2   # ceil(2 * p99)
        # critical breaches identically but is never shed
        assert CONTROLS.shed_state("ap-crit") == (False, 0)
        # hovering inside the recovery band (0.8x..1x target) must not
        # flap the gate open — live waves keep arriving (in-flight
        # backlog still runs while shed), each tick sees fresh evidence
        _fill_slo("ap-shed", 0.09)
        for _ in range(4):
            _fill_slo("ap-shed", 0.09, n=1)
            ap.tick()
        assert CONTROLS.shed_state("ap-shed")[0] is True
        # a genuine recovery under 0.8x target lifts the shed
        _fill_slo("ap-shed", 0.01)
        ap.tick()
        ap.tick()
        assert CONTROLS.shed_state("ap-shed")[0] is False
        eff = ap.stats()["decisionsByEffector"]
        assert eff.get("shed", 0) >= 2   # one shed + one unshed landed
    finally:
        mgr.shutdown()


def test_shed_lifts_after_quiescence_and_can_reshed():
    """The anti-latch contract: once shed, the 429 gate stops inflow,
    the count-based SLO window freezes at its breach-era p99, and no
    recovery evidence can ever arrive through it.  Ticks where a
    shedding session ran ZERO new waves must therefore count toward
    recovery — and a client that floods again after the lift is shed
    again from fresh evidence."""
    mgr = _mgr(max_sessions=4)
    ap = Autopilot(mgr, interval=3600, slo_target=0.1)
    try:
        mgr.create("ap-quiet", qos="best-effort")
        _fill_slo("ap-quiet", 1.0)
        for _ in range(HYSTERESIS_TICKS):
            ap.tick()
        assert CONTROLS.shed_state("ap-quiet")[0] is True
        # inflow stops (clients back off per Retry-After): the window
        # still reads p99=1.0s, but with no new waves the shed must
        # lift after HYSTERESIS_TICKS quiet ticks, not latch forever
        ap.tick()
        assert CONTROLS.shed_state("ap-quiet")[0] is True   # streak 1
        ap.tick()
        assert CONTROLS.shed_state("ap-quiet")[0] is False
        # the returning flood is fresh breach evidence: shed again
        for _ in range(HYSTERESIS_TICKS):
            _fill_slo("ap-quiet", 1.0, n=1)
            ap.tick()
        assert CONTROLS.shed_state("ap-quiet")[0] is True
    finally:
        mgr.shutdown()


def test_failsafe_reverts_every_effector_and_recovers():
    mgr = _mgr(max_sessions=4)
    ap = Autopilot(mgr, interval=3600, slo_target=0.1)
    try:
        mgr.create("ap-fs", qos="best-effort")
        _fill_slo("ap-fs", 1.0)
        ap.tick()
        ap.tick()
        assert CONTROLS.shed_state("ap-fs")[0] is True
        CONTROLS.set_budget_weight("ap-fs", 2.0)

        real_brief = mgr.sessions_brief

        def boom():
            raise RuntimeError("telemetry plane unavailable")

        mgr.sessions_brief = boom
        assert ap.tick() == 0
        mgr.sessions_brief = real_brief
        # the fail-safe contract: EVERY override reverted in one step,
        # controller memory cleared, the loop keeps ticking
        assert ap.stats()["failsafes"] == 1
        assert CONTROLS.stats() == {}
        assert CONTROLS.shed_state("ap-fs") == (False, 0)
        ap.tick()   # clean slate: breach evidence rebuilds from zero
        assert CONTROLS.shed_state("ap-fs")[0] is False
        ap.tick()
        assert CONTROLS.shed_state("ap-fs")[0] is True
    finally:
        mgr.shutdown()


def test_autopilot_decide_events_survive_blackbox_schema():
    mgr = _mgr(max_sessions=4)
    ap = Autopilot(mgr, interval=3600, slo_target=0.1)
    try:
        mgr.create("ap-bb", qos="best-effort")
        _fill_slo("ap-bb", 1.0)
        ap.tick()
        ap.tick()
        assert CONTROLS.shed_state("ap-bb")[0] is True
        bundle, path = BLACKBOX.dump("test-autopilot", write=False)
        assert path is None
        kinds = validate_dump(bundle)["kinds"]
        assert kinds.get("autopilot.decide", 0) >= 1
        decides = [e for e in bundle["events"]
                   if e["kind"] == "autopilot.decide"]
        assert all({"effector", "session", "from", "to", "reason"}
                   <= set(e) for e in decides)
        # a decision without its evidence fields must fail validation
        bad = json.loads(json.dumps(bundle))
        bad["events"].append({"kind": "autopilot.decide", "t": 0.0,
                              "seq": 10 ** 9, "effector": "shed"})
        with pytest.raises(ValueError, match="autopilot.decide missing"):
            validate_dump(bad)
    finally:
        mgr.shutdown()


# ------------------------- decision provenance + the history ring


def test_shed_cycle_reconstructs_from_history_ring():
    """The causal-reconstruction contract (docs/metrics.md "History &
    correlation"): the full breach -> shed -> recovery arc reads back
    out of the columnar ring, and every shed decision's evidence
    matches the ring AT ITS RECORDED INDEX bit-for-bit (the controller
    plans from the exact planes the feeder sampled)."""
    from kube_scheduler_simulator_tpu_torch.utils import history
    from kube_scheduler_simulator_tpu_torch.utils.blackbox import FEEDER
    from kube_scheduler_simulator_tpu_torch.utils.history import HISTORY

    prev = history.set_enabled(True)
    HISTORY.reset()
    FEEDER.reset()
    mgr = _mgr(max_sessions=4)
    ap = Autopilot(mgr, interval=3600, slo_target=0.1)
    sid = "ap-ring"
    try:
        mgr.create(sid, qos="best-effort")
        _fill_slo(sid, 1.0)
        ap.tick()                     # breach streak 1 (one ring row)
        ap.tick()                     # streak 2 -> shed applied
        assert CONTROLS.shed_state(sid)[0] is True
        ap.tick()                     # quiesced streak 1
        ap.tick()                     # streak 2 -> shed lifted
        assert CONTROLS.shed_state(sid)[0] is False
        ap.tick()                     # one more row records the lift

        win = HISTORY.window(series=["slo.p99", "autopilot.shed"],
                             session=sid, since=0)
        p99 = win["series"][f"slo.p99{{session={sid}}}"]
        shed = win["series"][f"autopilot.shed{{session={sid}}}"]
        first = next(i for i, v in enumerate(shed) if v == 1.0)
        # breach at or before the first shed sample; the flag returns
        # to 0 later — the whole arc is reconstructible from columns
        assert any(v is not None and v > 0.1 for v in p99[:first + 1])
        assert any(v == 0.0 for v in shed[first:])

        sheds = [d for d in ap.stats()["lastDecisions"][sid]
                 if d["effector"] == "shed"]
        assert len(sheds) == 2
        for d in sheds:
            evd = d["evidence"]
            idx = evd["historyIndex"]
            # the cited ring row holds exactly the p99 the planner read
            assert (HISTORY.value(f"slo.p99{{session={sid}}}", idx)
                    == evd["p99WaveSeconds"])
            # the row was sampled before the decision applied: it shows
            # the pre-transition shed state
            assert (HISTORY.value(f"autopilot.shed{{session={sid}}}", idx)
                    == (0.0 if d["to"] == "shedding" else 1.0))
            assert evd["sloWindow"]["p99WaveSeconds"] \
                == evd["p99WaveSeconds"]
        on, off = sheds
        assert (on["from"], on["to"]) == ("open", "shedding")
        assert (off["from"], off["to"]) == ("shedding", "open")
        assert on["evidence"]["breachStreak"] >= HYSTERESIS_TICKS
        assert off["evidence"]["okStreak"] >= HYSTERESIS_TICKS
    finally:
        history.set_enabled(prev)
        mgr.shutdown()


def test_evidence_omits_history_index_when_disabled():
    """KSS_TPU_HISTORY=0 parity: the planner still reads the same
    one-gather-per-tick planes and decides identically — the evidence
    just cites no ring index (there is no ring row to cite)."""
    from kube_scheduler_simulator_tpu_torch.utils import history

    prev = history.set_enabled(False)
    mgr = _mgr(max_sessions=4)
    ap = Autopilot(mgr, interval=3600, slo_target=0.1)
    try:
        mgr.create("ap-nohist", qos="best-effort")
        _fill_slo("ap-nohist", 1.0)
        for _ in range(HYSTERESIS_TICKS):
            ap.tick()
        assert CONTROLS.shed_state("ap-nohist")[0] is True
        d = ap.stats()["lastDecisions"]["ap-nohist"][-1]
        assert d["effector"] == "shed" and d["to"] == "shedding"
        assert "historyIndex" not in d["evidence"]
        assert d["evidence"]["p99WaveSeconds"] == 1.0
    finally:
        history.set_enabled(prev)
        mgr.shutdown()


# -------------------------------------------------- idle-eviction pressure


def test_evict_idle_under_pressure_tier_order_never_critical():
    mgr = _mgr(max_sessions=8)
    try:
        for sid, qos in (("ev-be", "best-effort"), ("ev-std", "standard"),
                         ("ev-crit", "critical")):
            mgr.create(sid, qos=qos)
            mgr.get(sid, touch=False).last_used = time.time() - 100
        assert mgr.evict_idle_under_pressure(grace_s=1) == 1
        live = {sid for sid, _q, _t, _b in mgr.sessions_brief()}
        assert "ev-be" not in live   # best-effort goes first
        assert mgr.evict_idle_under_pressure(grace_s=1) == 1
        live = {sid for sid, _q, _t, _b in mgr.sessions_brief()}
        assert "ev-std" not in live
        # critical and the pinned default are never pressure-evicted
        assert mgr.evict_idle_under_pressure(grace_s=1) == 0
        live = {sid for sid, _q, _t, _b in mgr.sessions_brief()}
        assert {"ev-crit", "default"} <= live
    finally:
        mgr.shutdown()


# --------------------------------------------------- HTTP 429 contract


@pytest.fixture()
def server(monkeypatch):
    # a slow controller interval keeps the background autopilot from
    # un-shedding the manually-gated session mid-test
    monkeypatch.setenv("KSS_TPU_AUTOPILOT_INTERVAL_S", "60")
    cfg = SimulatorConfiguration(port=0)
    di = DIContainer(cfg, device="cpu")
    srv = SimulatorServer(di, port=0)
    srv.start(block=False)
    yield srv
    srv.shutdown()


def hreq(srv, method, path, body=None):
    """(status, headers, parsed body) — the shed contract needs the
    Retry-After HEADER, not just the JSON."""
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(url, data=data, method=method,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=10) as resp:
            raw = resp.read()
            return (resp.status, dict(resp.headers),
                    json.loads(raw) if raw else None)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, dict(e.headers), json.loads(raw) if raw else None


def test_http_shed_gate_429_with_retry_after(server):
    code, _h, made = hreq(server, "POST", "/api/v1/sessions",
                          {"id": "shed-http", "qos": "best-effort"})
    assert code == 201 and made["qos"] == "best-effort"
    code, _h, _b = hreq(server, "POST", "/api/v1/sessions",
                        {"id": "open-http"})
    assert code == 201
    pod = make_pods(1, seed=21)[0]
    CONTROLS.set_shed("shed-http", True, 7)
    try:
        code, headers, body = hreq(
            server, "POST", "/api/v1/sessions/shed-http/pods", pod)
        assert code == 429
        assert headers.get("Retry-After") == "7"
        assert body["reason"] == "Overloaded"
        assert body["retryAfterSeconds"] == 7
        # only workload-submitting POSTs shed: reads stay up, and the
        # un-shed neighbor session is untouched
        code, _h, _b = hreq(server, "GET",
                            "/api/v1/sessions/shed-http/pods")
        assert code == 200
        code, _h, _b = hreq(server, "POST",
                            "/api/v1/sessions/open-http/pods",
                            copy.deepcopy(pod))
        assert code == 201
        code, _h, ready = hreq(server, "GET", "/readyz")
        assert code == 200
        assert ready["autopilot"]["shedding"] == ["shed-http"]
        code, _h, listing = hreq(server, "GET", "/api/v1/sessions")
        assert code == 200
        assert listing["autopilot"]["controls"]["shed-http"]["shed"] is True
        # the decision-provenance surface rides the same block (a
        # manual CONTROLS.set_shed is not an autopilot decision, so
        # the per-session lists may be empty — the key must exist)
        assert isinstance(listing["autopilot"]["lastDecisions"], dict)
    finally:
        CONTROLS.set_shed("shed-http", False)
    code, _h, _b = hreq(server, "POST",
                        "/api/v1/sessions/shed-http/pods",
                        copy.deepcopy(pod))
    assert code == 201


# ------------------------------------------------------- byte parity


def test_parity_empty_registry_vs_unrelated_overrides():
    """The opt-out claim (docs/autopilot.md): an empty controls
    registry — and one populated only for OTHER sessions — schedules
    byte-identically to the static-knob baseline."""
    mgr = _mgr(max_sessions=4)
    try:
        nodes = make_nodes(8, seed=31)
        pods = make_pods(48, seed=32)

        def run(sid: str) -> dict:
            sess = mgr.create(sid)
            sess.di.engine.set_profiles(None)
            sess.di.engine.plugin_config = PluginSetConfig(
                enabled=list(ENABLED))
            sess.di.engine.chunk = 16
            for n in nodes:
                sess.di.store.create("nodes", copy.deepcopy(n))
            for p in pods:
                sess.di.store.create("pods", copy.deepcopy(p))
            sess.di.engine.schedule_pending()
            return {p["metadata"]["name"]:
                    (p["spec"].get("nodeName"),
                     dict(p["metadata"].get("annotations") or {}))
                    for p in sess.di.store.list("pods")[0]}

        baseline = run("par-a")
        CONTROLS.set_spec("par-other", -1, 256)
        CONTROLS.set_budget_weight("par-other", 3.0)
        CONTROLS.set_shed("par-other", True, 9)
        contended = run("par-b")
        assert contended == baseline
        # the aggressive profile applied to the RUNNING session is also
        # byte-invariant: rung/kcand only repartition the same rounds
        CONTROLS.set_spec("par-c", -1, 256)
        aggressive = run("par-c")
        assert aggressive == baseline
    finally:
        mgr.shutdown()


# ------------------------------------------------- churn workload seed


def test_make_churn_workload_deterministic_and_consistent():
    nodes_a, sched_a = make_churn_workload(12, ticks=20, seed=5)
    nodes_b, sched_b = make_churn_workload(12, ticks=20, seed=5)
    assert json.dumps(sched_a) == json.dumps(sched_b)
    assert json.dumps(nodes_a) == json.dumps(nodes_b)
    assert len(sched_a) == 20
    _nodes_c, sched_c = make_churn_workload(12, ticks=20, seed=6)
    assert json.dumps(sched_c) != json.dumps(sched_a)
    # departures only name pods created in an EARLIER tick, never twice
    live: set[str] = set()
    seen_deletes: set[str] = set()
    for step in sched_a:
        for name in step["delete"]:
            assert name in live and name not in seen_deletes
            live.discard(name)
            seen_deletes.add(name)
        for pod in step["create"]:
            # steady-shape contract for the scan cache: no affinity pins
            assert "affinity" not in pod["spec"]
            live.add(pod["metadata"]["name"])
