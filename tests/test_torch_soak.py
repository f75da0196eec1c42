"""The port's soak gate (kube_scheduler_simulator_tpu_torch/tools/soak.py)
on the CPU: a live SimulatorServer on localhost with the autopilot on and
three tenants, over the JAX tool's churn stream (48 nodes, 8 arrivals and 4
departures a tick).

The short run (6 ticks) must keep the three promises: the standard
tenant's p99 inside the target, the best-effort tenant shed with
Retry-After on every 429 and the shed lifted, the faulted tenant back on
rung 0; and its verdict must carry every key of the JAX tool's
(tools/soak.py run_soak, read from its source: importing it sets
process-wide knobs).  Its target is the tool's default on the CPU: the
JAX tool's 0.25 s, which it set for 48 CPU nodes on an idle host, or 1.5
x a calibration pass's p99 where that is more: a wall-clock target fixed
for an idle host does not hold where other test processes share the
cores (the standard tenant's p99 was 0.75 s under the parallel suite).
The full-length run (18 ticks) is slow."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

from kube_scheduler_simulator_tpu_torch.tools import soak

ROOT = Path(__file__).resolve().parent.parent


def _jax_verdict_keys() -> set[str]:
    tree = ast.parse((ROOT / "tools" / "soak.py").read_text(encoding="utf-8"))
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_soak")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)]
    return {k.value for k in ret[-1].value.keys}


def _promises(v: dict) -> None:
    assert v["ok"], v["failures"]
    assert v["soak_p99_wave_seconds"] <= v["slo_target_p99_s"]
    assert v["shed_responses"] > 0 and v["all_shed_had_retry_after"] and v["shed_lifted"]
    assert v["soak_recovered_to_rung0"] and v["final_rung"] == "device_resident"
    assert v["history_breach_before_shed"] and v["history_shed_lift_recorded"]
    assert v["shed_evidence_checked"] > 0


def test_short_soak_keeps_the_three_promises():
    v = soak.run_soak(ticks=6, device="cpu")
    want = _jax_verdict_keys()
    assert len(want) > 15
    assert want <= set(v), sorted(want - set(v))
    assert v["calibration_p99_s"] > 0
    assert v["slo_target_p99_s"] == max(soak.CPU_FLOOR_S,
                                        soak.SLO_FACTOR * v["calibration_p99_s"])
    _promises(v)


@pytest.mark.slow
def test_full_soak_with_a_calibrated_target():
    v = soak.run_soak(ticks=18, device="cpu")
    assert v["calibration_p99_s"] > 0
    assert v["slo_target_p99_s"] == pytest.approx(max(soak.CPU_FLOOR_S,
                                                      soak.SLO_FACTOR * v["calibration_p99_s"]))
    _promises(v)
