"""Observability smoke gate for the port: `python -m
kube_scheduler_simulator_tpu_torch.tools.obs_smoke [--device cpu]`.

The port's counterpart of tools/obs_smoke.py, the causal-telemetry proof
in one process: arms a one-rule fault plan, runs a single engine wave
under an explicit trace id (the `trace_scope` the HTTP server enters for
a stamped request), lets the retry budget of 0 abort the wave, and checks
that the one trace id threads every observability surface:

  * tracer spans: the wave's and the speculative rounds' spans carry the
    id as an attr;
  * the black-box post-mortem dump: its events carry the id, and its
    telemetry-history window passes validate_dump's schema check
    (columns rectangular, timestamps aligned);
  * the Perfetto export: filtering by the id returns the wave's spans
    and the black-box instants.

The wave is blackbox_smoke's (`aborted_wave`), on the card's kernels
unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

from . import add_device_arg
from .blackbox_smoke import aborted_wave

TRACE_ID = "obs-smoke-trace"


def run(device: str = "cuda", dump_dir: str | None = None) -> dict:
    """The smoke: -> its verdict, {"ok": False, "failure": ...} on a fault."""
    from ..utils.blackbox import validate_dump
    from ..utils.tracing import TRACER

    def fail(msg: str) -> dict:
        return {"ok": False, "failure": msg}

    dump_dir = dump_dir or tempfile.mkdtemp(prefix="kss-obs-smoke-")
    got = aborted_wave(device, dump_dir, trace_id=TRACE_ID)
    if got["surfaced"] is None:
        return fail("the armed fault never surfaced (retry budget 0 should abort the wave)")

    # 1. spans: the wave's span tree carries the trace id as an attr
    traced_spans = [ev for ev in TRACER.events(limit=500) if ev.get("trace_id") == TRACE_ID]
    if not traced_spans:
        return fail(f"no tracer span carries the trace id {TRACE_ID!r}")

    # 2. the post-mortem dump: events stamped with the id, and an embedded
    #    history window that validates
    if got["doc"] is None:
        return fail(f"no dump landed in {dump_dir}")
    doc, path = got["doc"], got["files"][-1]
    try:
        res = validate_dump(doc, require_fault=True, require_rounds=True)
    except ValueError as e:
        return fail(f"malformed dump {path}: {e}")
    traced_events = [ev for ev in doc["events"]
                     if ev.get("trace_id") == TRACE_ID or TRACE_ID in (ev.get("traces") or ())]
    if not traced_events:
        return fail(f"no black-box event in the dump carries the trace id {TRACE_ID!r}")
    hist = doc.get("history")
    if not isinstance(hist, dict) or not hist.get("index"):
        return fail("the dump's embedded history window is missing or empty")

    # 3. Perfetto: filtering the export by the id returns the wave
    tevs = TRACER.perfetto(trace_id=TRACE_ID).get("traceEvents") or []
    pf_spans = [ev for ev in tevs if ev.get("ph") == "X"]
    pf_instants = [ev for ev in tevs if ev.get("ph") == "i"]
    if not pf_spans:
        return fail(f"perfetto(trace_id=...) returned no spans for {TRACE_ID!r}")
    if not pf_instants:
        return fail(f"perfetto(trace_id=...) returned no black-box instants for {TRACE_ID!r}")
    return {
        "ok": True,
        "trace_id": TRACE_ID,
        "dump": path,
        "reason": doc["reason"],
        "traced_spans": len(traced_spans),
        "traced_dump_events": len(traced_events),
        "history_rows": len(hist["index"]),
        "history_series": len(hist.get("series") or {}),
        "perfetto_spans": len(pf_spans),
        "perfetto_instants": len(pf_instants),
        "event_kinds": res["kinds"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kss-torch-obs-smoke", description=__doc__)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    v = run(args.device)
    if not v["ok"]:
        print(f"obs-smoke: FAIL — {v['failure']}", file=sys.stderr)
        return 1
    print(json.dumps(v))
    print(f"obs-smoke: ok — trace {TRACE_ID!r} threads {v['traced_spans']} spans, "
          f"{v['traced_dump_events']} dump events, {v['perfetto_spans']}+"
          f"{v['perfetto_instants']} perfetto events; history window {v['history_rows']} "
          f"rows x {v['history_series']} series")
    return 0


if __name__ == "__main__":
    sys.exit(main())
