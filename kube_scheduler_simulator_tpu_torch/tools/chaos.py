"""Chaos gate for the port: `python -m kube_scheduler_simulator_tpu_torch.tools.chaos
[--device cpu] [--seeds N] [--seed-base S] [--quick]`.

The port's counterpart of tools/chaos.py.  Runs concurrent two-session
scheduling waves under randomized, seeded fault plans over every seam of
utils/faults.py and checks the wave failure protocol's invariants:

  * waves complete under injected faults, through uncommitted-suffix
    retry or the degradation ladder, instead of aborting the backlog;
  * annotations and binds are byte-identical to the fault-free run of
    the same workload, for every session;
  * gang atomicity holds: every PodGroup is all-bound or all-unbound;
  * per-session isolation: every fault targets one session (the plan's
    session filter), and the neighbour's results still equal its own
    fault-free run, on the `device_resident` rung;
  * session admission survives create and evict faults with a
    consistent registry;
  * the autopilot's `autopilot.decide` seam fires, reverts every
    effector and leaves the controller ticking;
  * no lock-order cycle under the runtime lock witness
    (KSS_TPU_LOCK_WITNESS=1, tools/lockwitness.py).

The sessions run NodeResourcesFit and Coscheduling (the JAX tool's
plugin set) on the card's kernels unless `--device cpu`: the scan's
`step_chunk`, the speculative wave's kernels, B7 at the device-resident
rung and B8 `quorum_slice` for the gangs.  Each seed derives one
deterministic plan, so a failure prints the reproducing command.
`run_seed(seed, shape, device=...)` takes any shape, the 5,000-node one
of chip_smoke.py phase 32 included; a shape's optional "wedge_s" is how
long a wave may run before the gate calls it wedged (120 s, the JAX
tool's, for its 8 nodes).
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import threading
import time

from . import add_device_arg, scoped_env

DEFAULT_SEEDS = 3
FAULTED, NEIGHBOR = "chaos-a", "chaos-b"
QUICK_SHAPE = {"nodes": 5, "pods": 14, "gangs": 1, "gang_members": 3, "chunk": 6}
FULL_SHAPE = {"nodes": 8, "pods": 26, "gangs": 2, "gang_members": 3, "chunk": 8}


def _build_cluster(store, seed: int, n_nodes: int, n_pods: int, gangs: int,
                   gang_members: int) -> list[str]:
    from ..models.workloads import make_gang_workload, make_nodes, make_pods
    from ..plugins.coscheduling import ensure_podgroup_resource

    ensure_podgroup_resource(store)
    for n in make_nodes(n_nodes, seed=seed):
        store.create("nodes", n)
    for p in make_pods(n_pods, seed=seed):
        store.create("pods", p)
    pgs, pods = make_gang_workload(gangs, gang_members, seed=seed + 1,
                                   name_prefix=f"cg{seed}")
    for pg in pgs:
        store.create("podgroups", pg)
    for p in pods:
        store.create("pods", p)
    return [pg["metadata"]["name"] for pg in pgs]


def _engine(store, session: str, chunk: int, device: str):
    from ..framework.engine import SchedulerEngine
    from ..plugins.coscheduling import Coscheduling
    from ..plugins.registry import PluginSetConfig

    cfg = PluginSetConfig(enabled=["NodeResourcesFit", "Coscheduling"],
                          custom={"Coscheduling": Coscheduling()})
    eng = SchedulerEngine(store, plugin_config=cfg, chunk=chunk, device=device)
    eng.session = session
    return eng


def _plan_for(seed: int, target: str):
    """The seed's randomized plan (the JAX tool's, rule for rule), every
    rule scoped to `target`: the isolation invariant needs a neighbour
    that provably saw no fault."""
    from ..utils.faults import FaultPlan, FaultRule

    rng = random.Random(seed * 7919)
    rules = [
        # transient scan/fetch faults: heal via uncommitted-suffix retry
        FaultRule("replay.scan_dispatch", nth=rng.randint(1, 3),
                  error="runtime", times=1, sessions=[target]),
        # mid-round speculative fault: committed round chunks stand, the
        # uncommitted suffix retries against the store as it is now
        FaultRule("speculative.round", nth=rng.randint(1, 2),
                  error="runtime", times=1, sessions=[target]),
        # fused-dispatch fault: fires on the requesting thread before it
        # joins a batch, so only the target's wave aborts and retries
        FaultRule("fuse.dispatch", nth=rng.randint(1, 2),
                  error="runtime", times=1, sessions=[target]),
        FaultRule("replay.decision_fetch", p=0.15, error="io", times=2,
                  sessions=[target]),
        # structural fault: steps the degradation ladder down a rung
        FaultRule("replay.scan_dispatch", nth=rng.randint(5, 8),
                  error="memory", times=1, sessions=[target]),
        # decode fault: heals on re-read (or through a wave retry when it
        # surfaces through an in-wave reflect materialization)
        FaultRule("decode.chunk", nth=rng.randint(1, 2), error="runtime",
                  times=1, sessions=[target]),
        # write-back conflicts: heal under the reflector's own backoff
        FaultRule("reflector.write_back", p=0.2, error="conflict", times=2,
                  sessions=[target]),
        # compile fault: the wave retry builds the step again
        FaultRule("compile.build", nth=1, error="runtime", times=1,
                  sessions=[target]),
    ]
    return FaultPlan(rules, seed=seed)


def _collect_state(store, session: str) -> dict:
    """{pod name: (nodeName, annotations)}, read under the session's
    tracer scope so read-path fault rules can target it; the one retry is
    the heals-on-re-read invariant."""
    from ..utils.tracing import TRACER

    def read():
        out = {}
        with TRACER.session_scope(session):
            pods, _ = store.list("pods")
        for p in pods:
            meta = p.get("metadata") or {}
            out[meta.get("name", "")] = (
                (p.get("spec") or {}).get("nodeName"),
                dict(meta.get("annotations") or {}))
        return out

    try:
        return read()
    except Exception:
        # a transient injected decode fault surfaces to its first reader
        # and must heal on the next read without poisoning the chunk
        # (store/lazy.py); a second failure is a real fault
        return read()


def _run_once(seed: int, plan, shape: dict, device: str) -> dict:
    """One concurrent two-session run -> per-session state, gang names,
    result modes and any drive errors."""
    from ..cluster.store import ObjectStore
    from ..utils import faults

    sessions = {}
    gang_names = {}
    for i, sid in enumerate((FAULTED, NEIGHBOR)):
        store = ObjectStore()
        gang_names[sid] = _build_cluster(
            store, seed=seed + 50 * i, n_nodes=shape["nodes"], n_pods=shape["pods"],
            gangs=shape["gangs"], gang_members=shape["gang_members"])
        sessions[sid] = (store, _engine(store, sid, shape["chunk"], device))

    barrier = threading.Barrier(len(sessions))
    errors: dict[str, BaseException] = {}

    def drive(sid: str):
        _store, eng = sessions[sid]
        barrier.wait()
        try:
            eng.schedule_pending()
        except BaseException as e:  # noqa: BLE001 — the verdict reports it
            errors[sid] = e

    # the global plan is exactly `plan` (None: the fault-free reference)
    # for the run, and the previous one is restored after it: an
    # operator's env-armed KSS_TPU_FAULT_PLAN survives an embedded run.
    # The retry budget covers the plan's worst case (every bounded
    # transient rule trips in one wave), so the gate checks the protocol,
    # not a lucky spread of faults; an unbounded one would hide storms
    budget = 3
    if plan is not None:
        budget = max(sum((r.times or 0) for r in plan.rules
                         if r.error in ("runtime", "io", "timeout", "conflict")), 3)
    prev = faults.current_plan()
    wedge = shape.get("wedge_s", 120.0)
    with scoped_env(KSS_TPU_WAVE_MAX_RETRIES=(str(budget) if plan is not None
                                              else os.environ.get("KSS_TPU_WAVE_MAX_RETRIES"))):
        if plan is not None:
            faults.arm(plan)
        else:
            faults.disarm()
        try:
            threads = [threading.Thread(target=drive, args=(sid,), daemon=True,
                                        name=f"chaos-{sid}") for sid in sessions]
            for t in threads:
                t.start()
            for t, sid in zip(threads, sessions):
                t.join(timeout=wedge)
                if t.is_alive():
                    # a wedged wave is its own failure: report it instead
                    # of reading a store the wave still mutates
                    errors.setdefault(sid, TimeoutError(
                        f"wave wedged: thread still alive after {wedge:.0f}s"))
            state = {sid: (_collect_state(store, sid) if sid not in errors else {})
                     for sid, (store, _e) in sessions.items()}
        finally:
            if prev is not None:
                faults.arm(prev)
            else:
                faults.disarm()
    modes = {sid: eng.result_mode() for sid, (_s, eng) in sessions.items()}
    for sid, (_store, eng) in sessions.items():
        if sid not in errors:  # never block closing a wedged engine
            eng.close()
    return {"state": state, "gangs": gang_names, "errors": errors, "modes": modes}


def fault_free_state(seed: int, shape: dict, device: str, session: str = FAULTED) -> dict:
    """One session's cluster of `run_seed(seed, shape)` scheduled alone,
    with no plan armed, on `device`: what the gate's fault-free run of
    that session gives, computed elsewhere (chip_smoke.py phase 32 holds
    the card's run to the CPU's plain path with it)."""
    from ..cluster.store import ObjectStore
    from ..utils import faults

    store = ObjectStore()
    offset = 50 * (FAULTED, NEIGHBOR).index(session)
    _build_cluster(store, seed=seed + offset, n_nodes=shape["nodes"], n_pods=shape["pods"],
                   gangs=shape["gangs"], gang_members=shape["gang_members"])
    eng = _engine(store, session, shape["chunk"], device)
    prev = faults.current_plan()
    faults.disarm()
    try:
        eng.schedule_pending()
        return _collect_state(store, session)
    finally:
        if prev is not None:
            faults.arm(prev)
        eng.close()


def _gang_atomicity_failures(state: dict, gang_names: list[str]) -> list[str]:
    bad = []
    for g in gang_names:
        members = {n: s for n, (s, _a) in state.items() if n.startswith(g + "-")}
        bound = [n for n, s in members.items() if s]
        if bound and len(bound) != len(members):
            bad.append(f"gang {g}: {len(bound)}/{len(members)} bound")
    return bad


def _session_lifecycle_check(seed: int, device: str) -> list[str]:
    """Session create/evict seams: an injected construction failure must
    release the reservation (the id is re-creatable), an injected teardown
    failure must not wedge admission, and the registry stays consistent."""
    from ..server.sessions import SessionManager
    from ..utils import faults

    failures: list[str] = []
    mgr = SessionManager(max_sessions=3, idle_ttl=0, start_scheduler=False, device=device)
    plan = faults.FaultPlan([
        faults.FaultRule("session.create", nth=1, error="runtime"),
        faults.FaultRule("session.evict", nth=1, error="runtime"),
    ], seed=seed)
    try:
        with faults.armed(plan):
            try:
                mgr.create("c1")
                failures.append("session.create fault did not surface")
            except faults.InjectedFault:
                pass
            try:
                mgr.create("c1")   # reservation released: the same id admits
                mgr.create("c2")   # at capacity now (default + c1 + c2)
                mgr.create("c3")   # evicts the LRU c1 through the faulted path
            except Exception as e:  # noqa: BLE001 — the verdict reports it
                failures.append(f"admission after faults failed: {e!r}")
        ids = {s["id"] for s in mgr.list_sessions()}
        if ids != {"default", "c2", "c3"}:
            failures.append(f"registry inconsistent after faults: {ids}")
    finally:
        mgr.shutdown()
    return failures


def _autopilot_failsafe_check(seed: int, device: str) -> list[str]:
    """The autopilot.decide seam (control/autopilot.py): a fault while a
    tick applies its decisions must revert every effector to the static
    defaults (CONTROLS.reset()), count the failsafe and leave the
    controller ticking.  The rule is unscoped: the controller runs outside
    any session's tracer scope."""
    from ..control import CONTROLS
    from ..control.autopilot import Autopilot
    from ..server.sessions import SessionManager
    from ..utils import faults
    from ..utils.blackbox import SLO

    failures: list[str] = []
    mgr = SessionManager(max_sessions=4, idle_ttl=0, start_scheduler=False, device=device)
    try:
        mgr.create("ap-a", qos="best-effort")
        ap = Autopilot(mgr, interval=3600, slo_target=0.05)

        def waves(seconds, n=70):   # fill the whole SLO window
            for _ in range(n):
                SLO.observe_wave("ap-a", seconds, pods=10)

        waves(1.0)
        ap.tick()
        ap.tick()                   # breach for 2 ticks: shed applied
        if not CONTROLS.shed_state("ap-a")[0]:
            failures.append("autopilot never shed under synthetic breach")
        # a second effector's state must also revert on the trip
        CONTROLS.set_budget_weight("ap-a", 2.0)
        waves(0.001)                # recovered: the next ticks plan unshed
        plan = faults.FaultPlan([
            faults.FaultRule("autopilot.decide", nth=1, error="runtime")], seed=seed)
        with faults.armed(plan):
            ap.tick()
            ap.tick()               # ok for 2 ticks: a decision, the trip
        if plan.stats()["rules"][0]["trips"] != 1:
            failures.append("autopilot.decide fault never tripped (vacuous)")
        if ap.stats()["failsafes"] != 1:
            failures.append("failsafe counter not bumped after the trip")
        if CONTROLS.stats() != {}:
            failures.append("controls not reverted to static defaults after the trip: "
                            f"{CONTROLS.stats()}")
        # the controller survives: clean ticks run, and a renewed breach
        # sheds again from the reset state
        ap.tick()
        waves(1.0)
        ap.tick()
        ap.tick()
        if not CONTROLS.shed_state("ap-a")[0]:
            failures.append("controller wedged after the failsafe: a renewed breach "
                            "no longer sheds")
    finally:
        CONTROLS.reset()
        mgr.shutdown()
    return failures


def run_seed(seed: int, shape: dict, witness=None, device: str = "cuda",
             keep_state: bool = False) -> dict:
    """One seed: the chaos run, the fault-free reference, the invariants.
    -> {ok, seed, failures, injected, modes, dump} (and, with
    `keep_state`, "reference": each session's fault-free state)."""
    failures: list[str] = []
    plan = _plan_for(seed, FAULTED)
    # chaos first, as the JAX tool runs it (there the compile seam fires
    # only on a scan-cache miss, which the reference run would warm).  The
    # port has no such cache: `compile.build` fires where every replay,
    # stream and host path builds its step (framework/pipeline.py
    # build_step), once a wave or more, so the order does not decide
    # whether it trips; the retry builds the step again.
    chaos = _run_once(seed, plan, shape, device)
    ref = _run_once(seed, None, shape, device)
    for sid, err in chaos["errors"].items():
        failures.append(f"{sid}: wave did not complete: {err!r}")
    for sid, err in ref["errors"].items():
        failures.append(f"{sid}: fault-free reference failed: {err!r}")
    injected = sum(r["trips"] for r in plan.stats()["rules"])
    if injected == 0:
        failures.append("plan injected nothing — the seed is vacuous")
    for sid in (FAULTED, NEIGHBOR):
        got, want = chaos["state"].get(sid), ref["state"].get(sid)
        if got is None or want is None:
            continue
        if got != want:
            diff = sorted(set(k for k in want if want[k] != got.get(k))
                          | (set(got) - set(want)))[:4]
            role = "faulted" if sid == FAULTED else "NEIGHBOR (isolation)"
            failures.append(f"{sid} ({role}): state diverged from fault-free run at {diff}")
        failures.extend(f"{sid}: {m}" for m in _gang_atomicity_failures(
            got, chaos["gangs"][sid]))
    if chaos["modes"].get(NEIGHBOR) != "device_resident":
        failures.append(f"{NEIGHBOR} (isolation): left the device_resident rung: "
                        f"{chaos['modes'].get(NEIGHBOR)}")
    failures.extend(_session_lifecycle_check(seed, device))
    failures.extend(_autopilot_failsafe_check(seed, device))
    if witness is not None:
        try:
            witness.assert_no_cycles()
        except AssertionError as e:
            failures.append(f"lock witness: {e}")
    dump_path = None
    if failures:
        # a red run ships its own evidence: the black box (event ring,
        # counter deltas, armed plan, device fingerprint) next to the
        # reproducing seed
        import tempfile

        from ..utils.blackbox import BLACKBOX

        _doc, dump_path = BLACKBOX.dump(
            "chaos_failure", write=True,
            directory=os.environ.get("KSS_TPU_BLACKBOX_DIR") or tempfile.gettempdir())
    out = {"ok": not failures, "seed": seed, "failures": failures, "injected": injected,
           "modes": chaos["modes"], "dump": dump_path,
           "injected_by_seam": {}}
    for r in plan.stats()["rules"]:
        if r["trips"]:
            out["injected_by_seam"][r["seam"]] = (
                out["injected_by_seam"].get(r["seam"], 0) + r["trips"])
    if keep_state:
        out["reference"] = ref["state"]
        out["gangs"] = ref["gangs"]
    return out


def chaos_verdict(seeds: int = DEFAULT_SEEDS, seed_base: int = 1, quick: bool = False,
                  witness=None, device: str = "cuda") -> dict:
    """The machine-readable verdict the gate exits on."""
    shape = QUICK_SHAPE if quick else FULL_SHAPE
    t0 = time.perf_counter()
    results = [run_seed(seed_base + i, shape, witness=witness, device=device)
               for i in range(seeds)]
    return {
        "ok": all(r["ok"] for r in results),
        "seeds": [r["seed"] for r in results],
        "injected_total": sum(r["injected"] for r in results),
        "failures": [f for r in results for f in
                     (f"seed {r['seed']}: {m}" for m in r["failures"])],
        # black-box dumps of failing seeds: the first thing to open
        "dumps": [r["dump"] for r in results if r.get("dump")],
        "seconds": round(time.perf_counter() - t0, 2),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kss-torch-chaos", description=__doc__)
    ap.add_argument("--seeds", type=int, default=DEFAULT_SEEDS)
    ap.add_argument("--seed-base", type=int, default=1)
    ap.add_argument("--quick", action="store_true", help="the small single-wave shape")
    ap.add_argument("--json", dest="json_out", default=None)
    add_device_arg(ap)
    args = ap.parse_args(argv)

    witness = None
    if os.environ.get("KSS_TPU_LOCK_WITNESS") == "1":
        # before the port's waves create their locks
        from . import lockwitness

        witness = lockwitness.install()
    verdict = chaos_verdict(seeds=args.seeds, seed_base=args.seed_base, quick=args.quick,
                            witness=witness, device=args.device)
    print(json.dumps(verdict, indent=2))
    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as fh:
            json.dump(verdict, fh, indent=2)
    if not verdict["ok"]:
        bad = (verdict["failures"][0].split(":")[0] if verdict["failures"]
               else f"seed {args.seed_base}")
        print(f"chaos: FAIL — reproduce with: KSS_TPU_LOCK_WITNESS=1 python -m "
              f"kube_scheduler_simulator_tpu_torch.tools.chaos --device {args.device} "
              f"--seeds 1 --seed-base {bad.split()[-1]}", file=sys.stderr)
        for p in verdict.get("dumps") or []:
            print(f"chaos: black-box post-mortem dump: {p}", file=sys.stderr)
        return 1
    print(f"chaos: ok — {len(verdict['seeds'])} seeds, {verdict['injected_total']} faults "
          f"injected, {verdict['seconds']}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
