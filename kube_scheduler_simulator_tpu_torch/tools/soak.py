"""Soak gate for the port's SLO-driven autopilot: `python -m
kube_scheduler_simulator_tpu_torch.tools.soak [--device cpu] [--ticks N]
[--slo-target S] [json_out]`.

The port's counterpart of tools/soak.py: sustained multi-session traffic
against a live SimulatorServer with the autopilot on, checking the closed
loop's three promises end to end:

  * a well-behaved `standard` tenant under continuous arrival churn
    (models/workloads.py make_churn_workload) keeps its rolling p99 wave
    time inside the SLO target for the whole run;
  * an overloaded `best-effort` tenant is load-shed: its HTTP submissions
    get 429 with a Retry-After header and a retryAfterSeconds body field,
    every time, and the shed lifts once the overload stops;
  * a tenant hit by an injected structural device fault walks the
    degradation ladder down and recovers to rung 0 (device_resident) by
    the end of the run.

Sessions are also created and deleted mid-run, the history ring must
show the breach before the shed and the shed lifting, every shed
decision's evidence must match the ring at its index, and the final
black box must validate.

The SLO target: `--slo-target` seconds, or by default 1.5 x the standard
tenant's p99 over a calibration pass of the same stream, alone, before the
soak (a fixed target means nothing across devices and fleets; the JAX
tool's 0.25 s was set for 48 CPU nodes, and stays the least on the
CPU).  The verdict has the JAX tool's keys, and `calibration_p99_s`
beside `slo_target_p99_s`.

Knobs the loop needs (the autopilot's cadence and target, a 16-wave SLO
window, a history ring of 4,096 rows) are set for the run and restored
after it, so `run_soak` also runs in-process.  The collector is off for
the run and collects at the start of each standard tick, between waves,
in the calibration pass as in the soak; the objects alive when the run
starts are frozen out of it (gc.freeze).  A collection that lands in a
wave times the heap, not the scheduler, and the p99 of 16 waves is their
worst: on an NVIDIA H100 80GB HBM3 host the standard tenant's slow waves
(0.140-0.172 s against 0.05-0.09) each held a full collection of
0.079-0.109 s, and on an 8-core CPU host a caller's 2 M objects took
0.45 s to collect and moved the p99 from 0.109 s to 0.175 s.

Every wait has a deadline: each wave (WAVE_DEADLINE_S), each request
(REQUEST_DEADLINE_S) and each server's shutdown, whose joins run on a
thread joined with SHUTDOWN_DEADLINE_S.  A wait past its deadline writes
every thread's traceback to stderr and raises SoakTimeout, so a hang
fails with its traceback.  The verdict lists the standard tenant's wave
seconds, tick by tick, of the calibration pass (`calibration_waves_s`)
and of the soak (`soak_waves_s`).
"""

from __future__ import annotations

import argparse
import contextlib
import faulthandler
import gc
import json
import sys
import threading
import time

from . import add_device_arg, scoped_env

JAX_TOOL_TARGET_S = 0.25   # tools/soak.py's fixed target, for 48 CPU nodes
SLO_FACTOR = 1.5           # the target over the calibration pass's p99
# on the CPU the calibrated target is no less than the JAX tool's: a CPU
# pass's waves take tens of ms, so 1.5 x its p99 leaves no room for one
# pause of the host (the best-effort shed then never lifts in the warm-up)
CPU_FLOOR_S = JAX_TOOL_TARGET_S
SLO_WINDOW = 16
HISTORY_ROWS = 4096
STD, BE, DEG, CAL = "soak-std", "soak-be", "soak-deg", "soak-cal"

# the JAX tool pads each churn wave to a multiple of this quantum so
# every wave has one of a few compiled shapes; the port keeps the same
# waves, so the two drive the same traffic
WAVE_QUANTUM = 16

# deadlines: a wave, a request, and a server's shutdown (its threads'
# joins).  A wait past its deadline writes every thread's traceback to
# stderr and fails the soak, instead of running out a caller's clock.
WAVE_DEADLINE_S = 300.0
REQUEST_DEADLINE_S = 60.0
SHUTDOWN_DEADLINE_S = 60.0


class SoakTimeout(RuntimeError):
    """A soak step passed its deadline (every thread's traceback went to
    stderr)."""


def _dump(what: str, seconds: float) -> None:
    print(f"soak: {what} passed its {seconds:.0f} s deadline; every thread:",
          file=sys.stderr, flush=True)
    faulthandler.dump_traceback(file=sys.stderr, all_threads=True)


@contextlib.contextmanager
def _deadline(seconds: float, what: str):
    """A watchdog over the block: past `seconds` it dumps every thread's
    traceback at once (the block may be hung), and the block's end raises
    SoakTimeout."""
    fired = threading.Event()

    def fire():
        fired.set()
        _dump(what, seconds)

    timer = threading.Timer(seconds, fire)
    timer.daemon = True
    timer.start()
    try:
        yield
    finally:
        timer.cancel()
    if fired.is_set():
        raise SoakTimeout(f"soak: {what} took past its {seconds:.0f} s deadline")


def _within(seconds: float, fn, what: str) -> None:
    """fn() on a thread joined with a deadline: past it, every thread's
    traceback and SoakTimeout (the thread is left, a daemon)."""
    err: list = []

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised on the caller's thread
            err.append(e)

    t = threading.Thread(target=run, name=f"soak-{what}", daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        _dump(what, seconds)
        raise SoakTimeout(f"soak: {what} did not finish within {seconds:.0f} s")
    if err:
        raise err[0]


def _wave(eng, what: str, times: list | None = None) -> None:
    """One scheduling wave under its deadline; its seconds into `times`."""
    t0 = time.perf_counter()
    with _deadline(WAVE_DEADLINE_S, what):
        eng.schedule_pending()
    if times is not None:
        times.append(round(time.perf_counter() - t0, 6))


def _req(port: int, method: str, path: str, body=None):
    """-> (status, headers dict, parsed body|None) without raising on
    4xx/5xx: the 429 shed contract is what is under test."""
    import urllib.error
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method=method,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=REQUEST_DEADLINE_S) as resp:
            raw = resp.read()
            return resp.status, dict(resp.headers), (json.loads(raw) if raw else None)
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, dict(e.headers), (json.loads(raw) if raw else None)


def _fill(store, pods: list[dict]) -> None:
    for p in pods:
        store.create("pods", p)


def _pods(n: int, seed: int, prefix: str, cheap: bool = False) -> list[dict]:
    """make_pods with names unique to the burst; `cheap` shrinks requests
    to filler size so padding never exhausts capacity."""
    from ..models.workloads import make_pods

    pods = make_pods(n, seed=seed)
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"{prefix}-{i:05d}"
        if cheap:
            p["spec"]["containers"][0]["resources"]["requests"] = {
                "cpu": "50m", "memory": str(64 << 20)}
    return pods


def _slot_pods(n: int, seed: int, prefix: str) -> list[dict]:
    """Filler pods in the churn pods' own shape (app-labeled, tiny
    requests), so padding changes no wave's plugin inputs."""
    return [{
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {"name": f"{prefix}-{i:05d}", "namespace": "default",
                     "labels": {"app": f"job-{(seed + i) % 4}"}},
        "spec": {"containers": [{
            "name": "main", "image": "registry.k8s.io/pause:3.9",
            "resources": {"requests": {"cpu": "50m", "memory": str(64 << 20)}}}]},
    } for i in range(n)]


def _drop_pods(store, bound: bool, prefix: str = "") -> None:
    """Delete bound pods (completed work leaves) or pending ones (the
    backlog clients gave up on), so wave shapes stay uniform and node
    capacity never saturates."""
    pods, _rv = store.list("pods")
    for p in pods:
        meta = p["metadata"]
        if (bool((p.get("spec") or {}).get("nodeName")) == bound
                and meta["name"].startswith(prefix)):
            store.delete("pods", meta["name"], meta.get("namespace") or "default")


def _calibrate_overload(eng, store, target: float) -> int:
    """Pods per overload wave sized so one wave lasts about 2x the SLO
    target on this machine: the breach comes from sustained load.  The
    JAX tool's bounds (400 to 2,000 pods at its 0.25 s) scale with the
    target."""
    probe = 200
    _fill(store, _pods(probe, seed=11, prefix="soak-cal"))
    _wave(eng, "the overload probe's warm-up wave")  # not timed
    _fill(store, _pods(probe, seed=12, prefix="soak-cal2"))
    t0 = time.perf_counter()
    _wave(eng, "the overload probe's wave")
    per_pod = max(time.perf_counter() - t0, 1e-4) / probe
    _drop_pods(store, bound=True)
    _drop_pods(store, bound=False)
    most = int(2000 * max(1.0, target / JAX_TOOL_TARGET_S))
    return min(max(int(2 * target / per_pod), 400), most)


def _warm_standard(port: int, sid: str, eng, store) -> None:
    """Pay the tenant's first waves (each padded shape) up front, then roll
    them out of the SLO window with fast same-shape waves, so the measured
    loop sees steady-state churn."""
    for shape in (WAVE_QUANTUM, 2 * WAVE_QUANTUM):
        _fill(store, _slot_pods(shape, seed=60 + shape, prefix=f"soak-warm-{shape}"))
        _wave(eng, f"{sid}'s warm-up wave")
    for t in range(SLO_WINDOW):
        _fill(store, _slot_pods(WAVE_QUANTUM, seed=800 + t, prefix=f"soak-stdflush-{t}"))
        _wave(eng, f"{sid}'s flush wave")
    _drop_pods(store, bound=True)   # warm-up filler leaves


def _standard_tick(port: int, sid: str, eng, store, tick: dict, t: int,
                   failures: list[str], times: list) -> None:
    """The standard tenant's tick: a collection (module doc), HTTP
    create/delete per the churn schedule, padded to the wave quantum,
    then one wave, its seconds into `times`."""
    gc.collect()
    for pod in tick["create"]:
        code, _h, _b = _req(port, "POST", f"/api/v1/sessions/{sid}/pods", pod)
        if code != 201:
            failures.append(f"{sid} pod create -> {code} (tick {t})")
    for name in tick["delete"]:
        _req(port, "DELETE", f"/api/v1/sessions/{sid}/pods/default/{name}")
    created = len(tick["create"])
    pad = -created % WAVE_QUANTUM or WAVE_QUANTUM * (not created)
    if pad:
        _fill(store, _slot_pods(pad, seed=900 + t, prefix=f"soak-pad-{t}"))
    _wave(eng, f"{sid}'s tick {t}", times)
    _drop_pods(store, bound=True, prefix="soak-pad-")


def calibrate_standard(schedule: list[dict], nodes: list[dict], device: str,
                       times: list | None = None) -> float:
    """The standard tenant's p99 wave seconds over the whole churn stream,
    alone: its own server, no other tenant, the autopilot off (each
    wave's seconds into `times`)."""
    from ..server.server import SimulatorServer
    from ..server.sessions import SessionManager
    from ..utils.blackbox import SLO

    failures: list[str] = []
    with scoped_env(KSS_TPU_AUTOPILOT="0"):
        mgr = SessionManager(max_sessions=4, idle_ttl=0, start_scheduler=False, device=device)
        srv = SimulatorServer(mgr, port=0)
        srv.start(block=False)
    try:
        code, _h, _b = _req(srv.port, "POST", "/api/v1/sessions", {"id": CAL, "qos": "standard"})
        if code != 201:
            raise RuntimeError(f"calibration session create -> {code}")
        eng, store = mgr.get(CAL).di.engine, mgr.get(CAL).di.store
        for n in nodes:
            store.create("nodes", n)
        _warm_standard(srv.port, CAL, eng, store)
        for t, tick in enumerate(schedule):
            _standard_tick(srv.port, CAL, eng, store, tick, t, failures,
                           [] if times is None else times)
        if failures:
            raise RuntimeError(f"calibration pass failed: {failures[:3]}")
        return (SLO.stats(CAL) or {})["p99WaveSeconds"]
    finally:
        _within(SHUTDOWN_DEADLINE_S, srv.shutdown, "the calibration server's shutdown")
        SLO.drop_session(CAL)


def run_soak(ticks: int = 18, device: str = "cuda", std_nodes: int = 48,
             arrival_rate: float = 8.0, departure_rate: float = 4.0,
             slo_target: float | None = None) -> dict:
    """The soak (module doc).  The defaults are the JAX tool's stream
    (48 nodes, 8 arrivals and 4 departures a tick); `slo_target` None
    calibrates it.  -> the verdict."""
    from ..models.workloads import make_churn_workload
    from ..utils.blackbox import SLO
    from ..utils.history import HISTORY

    t_start = time.perf_counter()
    nodes, schedule = make_churn_workload(
        n_nodes=std_nodes, ticks=ticks, seed=5, arrival_rate=arrival_rate,
        departure_rate=departure_rate, name_prefix="soak")
    prev_window = SLO.set_window(SLO_WINDOW)
    HISTORY.ensure_capacity(HISTORY_ROWS)
    gc_was_on = gc.isenabled()
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        with scoped_env(KSS_TPU_SLO_WINDOW=str(SLO_WINDOW), KSS_TPU_HISTORY="1",
                        KSS_TPU_HISTORY_CAPACITY=str(HISTORY_ROWS)):
            cal_waves: list = []
            cal_p99 = calibrate_standard(schedule, nodes, device, cal_waves) \
                if slo_target is None else None
            target = slo_target if slo_target is not None else max(
                CPU_FLOOR_S if device == "cpu" else 0.0, SLO_FACTOR * cal_p99)
            with scoped_env(KSS_TPU_AUTOPILOT="1", KSS_TPU_AUTOPILOT_INTERVAL_S="0.1",
                            KSS_TPU_AUTOPILOT_SLO_TARGET_P99_S=repr(target),
                            KSS_TPU_AUTOPILOT_SHED_QOS="best-effort",
                            KSS_TPU_DEGRADE_PROBE_WAVES="3"):
                verdict = _soak(ticks, device, nodes, schedule, target)
    finally:
        if gc_was_on:
            gc.enable()
        gc.unfreeze()
        SLO.set_window(prev_window)
    verdict["calibration_p99_s"] = cal_p99
    verdict["calibration_waves_s"] = cal_waves
    verdict["std_nodes"] = std_nodes
    verdict["seconds"] = round(time.perf_counter() - t_start, 2)
    return verdict


def _soak(ticks: int, device: str, nodes: list[dict], schedule: list[dict],
          target: float) -> dict:
    from ..control import CONTROLS
    from ..models.workloads import make_nodes
    from ..server.server import SimulatorServer
    from ..server.sessions import SessionManager
    from ..utils import faults
    from ..utils.blackbox import BLACKBOX, validate_dump
    from ..utils.history import HISTORY

    failures: list[str] = []
    mgr = SessionManager(max_sessions=12, idle_ttl=0, start_scheduler=False, device=device)
    srv = SimulatorServer(mgr, port=0)
    srv.start(block=False)
    port = srv.port
    hist_since = HISTORY.last_index() + 1
    shed_responses = bad_shed = canaries = churned = 0
    deg_tripped = shed_lifted = recovered = False
    final_rung = None
    breach_before_shed = shed_lift_in_ring = False
    std_p99 = batch = None
    std_waves: list = []
    hist_rows = evidence_checked = 0
    ap = {}
    prev_plan = faults.current_plan()
    try:
        for sid, qos in ((STD, "standard"), (BE, "best-effort"), (DEG, "standard")):
            code, _h, _b = _req(port, "POST", "/api/v1/sessions", {"id": sid, "qos": qos})
            if code != 201:
                failures.append(f"session {sid} create -> {code}")
        engines = {sid: mgr.get(sid).di.engine for sid in (STD, BE, DEG)}
        stores = {sid: mgr.get(sid).di.store for sid in (STD, BE, DEG)}

        # ---- cluster seeding: the best-effort and degradation tenants
        # keep the JAX tool's fleets (96 and 24 nodes): their legs test
        # the controller, not scale
        for n in nodes:
            stores[STD].create("nodes", n)
        for n in make_nodes(96, seed=6):
            stores[BE].create("nodes", n)
        for n in make_nodes(24, seed=7):
            stores[DEG].create("nodes", n)

        batch = _calibrate_overload(engines[BE], stores[BE], target)
        _warm_standard(port, STD, engines[STD], stores[STD])
        for t in range(3 * SLO_WINDOW):
            _fill(stores[BE], _pods(WAVE_QUANTUM, seed=700 + t, prefix=f"soak-flush-{t}",
                                    cheap=True))
            _wave(engines[BE], f"{BE}'s flush wave")
            time.sleep(0.02)
            # the calibration's waves may have tripped the shed: flush
            # until the controller reopens the tenant
            if t >= SLO_WINDOW and not CONTROLS.shed_state(BE)[0]:
                break
        _drop_pods(stores[BE], bound=True)
        if CONTROLS.shed_state(BE)[0]:
            failures.append("best-effort tenant still shed after the warm-up flush — "
                            "the loop would start vacuous")

        # the degradation leg: one structural device fault early in the
        # run, scoped to DEG only
        faults.arm(faults.FaultPlan([
            faults.FaultRule("replay.scan_dispatch", nth=2, error="memory", times=1,
                             sessions=[DEG])], seed=1))

        # ---- churn + overload main loop
        for t in range(ticks):
            _standard_tick(port, STD, engines[STD], stores[STD], schedule[t], t, failures,
                           std_waves)

            # best-effort: one HTTP canary probes the shed state; while
            # open, the bulk overload lands and runs an over-target wave
            canary = _pods(1, seed=100 + t, prefix=f"soak-canary-{t}")[0]
            code, hdrs, body = _req(port, "POST", f"/api/v1/sessions/{BE}/pods", canary)
            canaries += 1
            if code == 429:
                shed_responses += 1
                retry_hdr = hdrs.get("Retry-After")
                retry_body = (body or {}).get("retryAfterSeconds")
                if (retry_hdr is None or not str(retry_hdr).isdigit()
                        or not isinstance(retry_body, int) or retry_body < 1):
                    bad_shed += 1
            elif code == 201:
                _fill(stores[BE], _pods(batch, seed=200 + t, prefix=f"soak-be-{t}"))
                _wave(engines[BE], f"{BE}'s overload wave {t}")
                _drop_pods(stores[BE], bound=True)   # completed work
            else:
                failures.append(f"be canary -> {code} (tick {t})")

            # faulted tenant: fresh small waves every tick; the first
            # trips the structural fault, the rest are the clean probe
            # waves the ladder needs to climb back
            _fill(stores[DEG], _pods(24, seed=300 + t, prefix=f"soak-deg-{t}"))
            _wave(engines[DEG], f"{DEG}'s wave {t}")
            _drop_pods(stores[DEG], bound=True)
            if engines[DEG].result_mode() != "device_resident":
                deg_tripped = True

            # session churn: short-lived best-effort tenants
            if t % 4 == 1:
                code, _h, _b = _req(port, "POST", "/api/v1/sessions",
                                    {"id": f"soak-churn-{t}", "qos": "best-effort"})
                if code == 201:
                    churned += 1
            elif t % 4 == 3:
                _req(port, "DELETE", f"/api/v1/sessions/soak-churn-{t - 2}")
            time.sleep(0.05)    # let controller ticks interleave

        if not deg_tripped:
            failures.append("structural fault never tripped the ladder (vacuous recovery "
                            "check)")
        if shed_responses == 0:
            failures.append("overloaded best-effort tenant was never shed")
        if bad_shed:
            failures.append(f"{bad_shed}/{shed_responses} shed responses missing the "
                            "Retry-After header / retryAfterSeconds body contract")

        # ---- cooldown: the overload stops, the shed must lift.  The
        # pending backlog is dropped (clients gave up); recovery is probed
        # through HTTP POSTs that keep 429ing while shed
        _drop_pods(stores[BE], bound=False)
        for t in range(6 * SLO_WINDOW):
            probe = _pods(1, seed=500 + t, prefix=f"soak-cool-{t}", cheap=True)[0]
            code, hdrs, body = _req(port, "POST", f"/api/v1/sessions/{BE}/pods", probe)
            if code == 201:
                shed_lifted = True
                _wave(engines[BE], f"{BE}'s probe wave")   # bind the probe pod
                _drop_pods(stores[BE], bound=True)
                break
            if code != 429:
                failures.append(f"cooldown probe -> {code} (tick {t})")
                break
            retry_hdr = hdrs.get("Retry-After")
            if retry_hdr is None or not str(retry_hdr).isdigit():
                failures.append(f"cooldown 429 missing Retry-After (tick {t})")
            time.sleep(0.05)
        if not shed_lifted:
            failures.append("shed never lifted after the overload stopped")
        else:
            # the probe wave recorded into a window of breach-era waves,
            # so the controller may rightly re-shed for one more cycle:
            # submissions must be accepted again within a bounded horizon
            code = None
            for t in range(6 * SLO_WINDOW):
                code, _h, _b = _req(port, "POST", f"/api/v1/sessions/{BE}/pods",
                                    _pods(1, seed=999 + t, prefix=f"soak-after-{t}")[0])
                if code != 429:
                    break
                time.sleep(0.05)
            if code != 201:
                failures.append(f"post-recovery submit -> {code}")

        final_rung = engines[DEG].result_mode()
        recovered = final_rung == "device_resident"
        if not recovered:
            failures.append(f"degradation ladder did not recover to rung 0: {final_rung}")

        std_slo = mgr.get(STD, touch=False).info().get("slo") or {}
        std_p99 = std_slo.get("p99WaveSeconds")
        if std_p99 is None or std_p99 > target:
            failures.append(f"standard tenant p99 {std_p99} breached the {target}s target "
                            "under churn")

        ap = mgr.stats().get("autopilot") or {}
        if not ap.get("decisions"):
            failures.append("autopilot made zero decisions all soak")
        if ap.get("failsafes"):
            failures.append(f"autopilot tripped its fail-safe {ap['failsafes']}x during a "
                            "clean soak")

        # ---- causal reconstruction from the history ring: breach, shed
        # and recovery read back out of the columnar ring, and every shed
        # decision's evidence equal to the ring at its index
        win = HISTORY.window(series=["slo.p99", "autopilot.shed"], session=BE,
                             since=hist_since)
        p99_col = win["series"].get(f"slo.p99{{session={BE}}}") or []
        shed_col = win["series"].get(f"autopilot.shed{{session={BE}}}") or []
        hist_rows = len(win["index"])
        first_shed = next((i for i, v in enumerate(shed_col) if v == 1.0), None)
        breach_before_shed = first_shed is not None and any(
            v is not None and v > target for v in p99_col[:first_shed + 1])
        shed_lift_in_ring = first_shed is not None and any(
            v == 0.0 for v in shed_col[first_shed:])
        if first_shed is None:
            failures.append("history ring never recorded the best-effort shed "
                            "(autopilot.shed == 1)")
        else:
            if not breach_before_shed:
                failures.append("history ring shows no p99 breach at or before the first "
                                "shed sample: breach -> shed is not reconstructible")
            if not shed_lift_in_ring:
                failures.append("history ring never recorded the shed lifting "
                                "(autopilot.shed back to 0)")

        for d in (ap.get("lastDecisions") or {}).get(BE) or []:
            if d.get("effector") != "shed":
                continue
            evd = d.get("evidence") or {}
            idx = evd.get("historyIndex")
            if not isinstance(idx, int):
                failures.append(f"shed decision carries no historyIndex: {d.get('reason')}")
                continue
            ring_p99 = HISTORY.value(f"slo.p99{{session={BE}}}", idx)
            ev_p99 = evd.get("p99WaveSeconds")
            if (ring_p99 is None) != (ev_p99 is None) or (
                    ring_p99 is not None and abs(ring_p99 - ev_p99) > 1e-9):
                failures.append(f"shed evidence p99 {ev_p99} != ring row {idx} value "
                                f"{ring_p99}: provenance broken")
            # the row was sampled before the decision applied, so it shows
            # the shed state before the transition
            ring_shed = HISTORY.value(f"autopilot.shed{{session={BE}}}", idx)
            want = 0.0 if d.get("to") == "shedding" else 1.0
            if ring_shed != want:
                failures.append(f"ring row {idx} shed flag {ring_shed} != pre-decision state "
                                f"{want} ({d.get('from')} -> {d.get('to')})")
            if d.get("to") == "open":
                # the lift rule: back inside the 0.8x recovery band, or
                # quiesced (no fresh waves)
                if not (ev_p99 is None or ev_p99 <= 0.8 * target
                        or int(evd.get("freshWaves") or 0) <= 0):
                    failures.append(f"shed lifted outside the recovery band: p99 {ev_p99} "
                                    f"with {evd.get('freshWaves')} fresh waves")
            evidence_checked += 1
        if evidence_checked == 0:
            failures.append("no shed decision evidence to check against the ring "
                            "(vacuous provenance)")

        doc, _path = BLACKBOX.dump("soak", write=False)
        try:
            validate_dump(doc)
        except Exception as e:  # noqa: BLE001 — the verdict reports it
            failures.append(f"black box failed validation: {e}")
    finally:
        if prev_plan is not None:
            faults.arm(prev_plan)
        else:
            faults.disarm()
        _within(SHUTDOWN_DEADLINE_S, srv.shutdown, "the soak server's shutdown")
        CONTROLS.reset()

    return {
        "ok": not failures,
        "failures": failures,
        "soak_p99_wave_seconds": std_p99,
        "soak_waves_s": std_waves,
        "soak_shed_rate": round(shed_responses / max(canaries, 1), 3),
        "soak_recovered_to_rung0": recovered,
        "all_shed_had_retry_after": shed_responses > 0 and bad_shed == 0,
        "shed_responses": shed_responses,
        "shed_lifted": shed_lifted,
        "slo_target_p99_s": target,
        "history_rows": hist_rows,
        "history_breach_before_shed": breach_before_shed,
        "history_shed_lift_recorded": shed_lift_in_ring,
        "shed_evidence_checked": evidence_checked,
        "ticks": ticks,
        "overload_batch": batch,
        "sessions_churned": churned,
        "final_rung": final_rung,
        "autopilot": {k: ap.get(k) for k in
                      ("ticks", "decisions", "failsafes", "decisionsByEffector")},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kss-torch-soak", description=__doc__)
    ap.add_argument("--ticks", type=int, default=18)
    ap.add_argument("--slo-target", type=float, default=None,
                    help="seconds; default 1.5 x a calibration pass's p99")
    add_device_arg(ap)
    ap.add_argument("json_out", nargs="?", default=None)
    args = ap.parse_args(argv)
    verdict = run_soak(ticks=args.ticks, device=args.device, slo_target=args.slo_target)
    print(json.dumps(verdict, indent=2))
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(verdict, fh, indent=2)
    if not verdict["ok"]:
        for f in verdict["failures"]:
            print(f"soak: FAIL — {f}", file=sys.stderr)
        return 1
    print(f"soak: ok — p99 {verdict['soak_p99_wave_seconds']:.3f}s against "
          f"{verdict['slo_target_p99_s']:.3f}s, {verdict['shed_responses']} sheds (all "
          f"Retry-After), recovered to rung 0, {verdict['seconds']}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
