"""Black-box smoke gate for the port: `python -m
kube_scheduler_simulator_tpu_torch.tools.blackbox_smoke [--device cpu]`.

The port's counterpart of tools/blackbox_smoke.py.  Arms a one-rule fault
plan through the real KSS_TPU_FAULT_PLAN surface (a plan file, parsed by
utils/faults.py `FaultPlan.from_env`), runs an engine wave with the retry
budget pinned to 0, so the transient fault aborts the wave instead of
healing, and checks that a well-formed post-mortem dump landed in
KSS_TPU_BLACKBOX_DIR.  utils/blackbox.py `validate_dump` requires:

  * the fault trip on the record (seam, error, classification) and a
    classified cause;
  * the protocol's action (wave.abort here);
  * the speculative round history that preceded the fault;
  * non-empty counter deltas for the failing wave;
  * a device fingerprint with an explicit hbm_available flag.

On a card the wave runs the card's kernels and the fingerprint names the
card with hbm_available true (torch.cuda.memory_stats); on the CPU it
says there are no memory stats.  The plan is armed for the wave only and
the previous plan, knobs and black-box switch are restored after it, so
the smoke also runs in-process (`run(device)`).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile

from . import add_device_arg, scoped_env

PLAN = {"seed": 7, "rules": [
    {"seam": "replay.decision_fetch", "nth": 2, "error": "runtime"},
]}


def aborted_wave(device: str, dump_dir: str, trace_id: str | None = None) -> dict:
    """Arm PLAN from a plan file through KSS_TPU_FAULT_PLAN, run one
    NodeResourcesFit wave of 24 pods on 6 nodes (chunk 8) with retry budget
    0 (under `trace_id`'s trace scope when given) and read the dump it
    wrote.  -> {"surfaced": the InjectedFault or None, "files": the dumps
    in dump_dir, "doc": the last one parsed, or None}."""
    from ..cluster.store import ObjectStore
    from ..framework.engine import SchedulerEngine
    from ..models.workloads import make_nodes, make_pods
    from ..plugins.registry import PluginSetConfig
    from ..utils import blackbox, faults, history
    from ..utils.blackbox import FEEDER
    from ..utils.tracing import TRACER

    plan_path = os.path.join(dump_dir, "plan.json")
    with open(plan_path, "w", encoding="utf-8") as fh:
        json.dump(PLAN, fh)
    # the toggles the checks depend on are pinned: an inherited
    # KSS_TPU_SPECULATIVE=0 or KSS_TPU_BLACKBOX=0 must not fail the smoke
    with scoped_env(KSS_TPU_FAULT_PLAN="@" + plan_path, KSS_TPU_BLACKBOX_DIR=dump_dir,
                    KSS_TPU_WAVE_MAX_RETRIES="0", KSS_TPU_SPECULATIVE="1",
                    KSS_TPU_BLACKBOX="1", KSS_TPU_HISTORY="1"):
        prev_plan = faults.current_plan()
        prev_bb, prev_hist = blackbox.set_enabled(True), history.set_enabled(True)
        store = ObjectStore()
        for n in make_nodes(6, seed=1):
            store.create("nodes", n)
        for p in make_pods(24, seed=2):
            store.create("pods", p)
        engine = SchedulerEngine(
            store, plugin_config=PluginSetConfig(enabled=["NodeResourcesFit"]),
            chunk=8, device=device)
        FEEDER.sample()  # a pre-wave ring row: the dump's window has a baseline
        surfaced = None
        faults.arm(faults.FaultPlan.from_env())
        try:
            with TRACER.trace_scope(trace_id):
                engine.schedule_pending()
        except faults.InjectedFault as e:
            surfaced = e
        finally:
            if prev_plan is not None:
                faults.arm(prev_plan)
            else:
                faults.disarm()
            blackbox.set_enabled(prev_bb)
            history.set_enabled(prev_hist)
            engine.close()
    files = sorted(glob.glob(os.path.join(dump_dir, "blackbox-*.json")))
    doc = None
    if files:
        with open(files[-1], encoding="utf-8") as fh:
            doc = json.load(fh)
    return {"surfaced": surfaced, "files": files, "doc": doc}


def run(device: str = "cuda", dump_dir: str | None = None) -> dict:
    """The smoke: -> its verdict, {"ok": False, "failure": ...} on a fault."""
    from ..utils.blackbox import validate_dump

    dump_dir = dump_dir or tempfile.mkdtemp(prefix="kss-blackbox-smoke-")
    got = aborted_wave(device, dump_dir)
    if got["surfaced"] is None:
        return {"ok": False, "failure": "the armed fault never surfaced (retry budget 0 "
                                        "should abort the wave)"}
    if got["doc"] is None:
        return {"ok": False, "failure": f"no dump landed in {dump_dir}"}
    doc, path = got["doc"], got["files"][-1]
    try:
        res = validate_dump(doc, require_fault=True, require_rounds=True)
    except ValueError as e:
        return {"ok": False, "failure": f"malformed dump {path}: {e}"}
    dev = doc["device"]
    kinds = [d.get("kind") for d in dev.get("devices") or []]
    if device != "cpu" and not (dev.get("hbm_available") and kinds and kinds[0] != "cpu"):
        return {"ok": False, "failure": f"the dump's fingerprint names no card: {dev}"}
    return {
        "ok": True,
        "dump": path,
        "reason": doc["reason"],
        "cause": doc["cause"],
        "event_kinds": res["kinds"],
        "deltas": len(doc["counter_deltas"]),
        "hbm_available": dev["hbm_available"],
        "kind": kinds[0] if kinds else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kss-torch-blackbox-smoke", description=__doc__)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    verdict = run(args.device)
    if not verdict["ok"]:
        print(f"blackbox-smoke: FAIL — {verdict['failure']}", file=sys.stderr)
        return 1
    print(json.dumps(verdict))
    print(f"blackbox-smoke: ok — {verdict['reason']} dump at {verdict['dump']} "
          f"({sum(verdict['event_kinds'].values())} events, {verdict['deltas']} counter "
          f"deltas, device {verdict['kind']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
