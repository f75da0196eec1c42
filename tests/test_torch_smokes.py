"""The port's black-box and trace smokes (kube_scheduler_simulator_tpu_torch/
tools/blackbox_smoke.py, obs_smoke.py) on the CPU.

Each returns 0 on `--device cpu`.  The dump a smoke leaves passes the
port's utils/blackbox.py `validate_dump` and the JAX package's, whose
schema it shares key for key on the CPU.  One key differs on a card: the
fingerprint's `devices[].memory` holds what torch.cuda.memory_stats gives
(`bytes_in_use`, `peak_bytes_in_use`, `bytes_reserved`), where the JAX
package's holds what its backend's memory_stats gives (on a TPU also
`bytes_limit` and `largest_free_block_bytes`); `validate_dump` reads
neither, only `hbm_available`.  The smokes restore the armed plan and the
knobs they set, so they run in-process here."""

from __future__ import annotations

import json

import pytest

from kube_scheduler_simulator_tpu.utils.blackbox import validate_dump as jax_validate
from kube_scheduler_simulator_tpu_torch.tools import blackbox_smoke, obs_smoke
from kube_scheduler_simulator_tpu_torch.utils import faults
from kube_scheduler_simulator_tpu_torch.utils.blackbox import validate_dump


def _schema(doc, pre=""):
    out = set()
    if isinstance(doc, dict):
        for k, v in doc.items():
            out.add(pre + k)
            if k not in ("events", "counter_deltas", "env", "history", "open_spans"):
                out |= _schema(v, pre + k + ".")
    elif isinstance(doc, list) and doc and isinstance(doc[0], dict):
        out |= _schema(doc[0], pre + "[0].")
    return out


@pytest.mark.parametrize("tool", [blackbox_smoke, obs_smoke])
def test_smoke_returns_0_on_cpu(tool, capsys):
    assert faults.current_plan() is None
    assert tool.main(["--device", "cpu"]) == 0
    verdict = json.loads(capsys.readouterr().out.splitlines()[0])
    assert verdict["ok"]
    assert faults.current_plan() is None   # the smoke's plan was for its wave only


def test_blackbox_dump_validates_under_both_packages(tmp_path):
    v = blackbox_smoke.run("cpu", dump_dir=str(tmp_path))
    assert v["ok"], v
    assert (v["reason"], v["cause"]["seam"]) == ("wave_abort", "replay.decision_fetch")
    assert v["hbm_available"] is False and v["kind"] == "cpu"
    with open(v["dump"], encoding="utf-8") as fh:
        doc = json.load(fh)
    ours = validate_dump(doc, require_fault=True, require_rounds=True)
    theirs = jax_validate(doc, require_fault=True, require_rounds=True)
    assert ours["kinds"] == theirs["kinds"]
    assert {"fault.trip", "wave.abort", "speculative.round"} <= set(ours["kinds"])
    assert doc["device"] == {"available": True, "backend": "cpu", "hbm_available": False,
                             "devices": [{"id": 0, "platform": "cpu", "kind": "cpu",
                                          "memory": None}]}
    # the shared schema, the one the JAX package's smoke writes
    assert {"version", "reason", "cause", "events", "counter_deltas", "device", "history",
            "device.hbm_available", "cause.seam"} <= _schema(doc)


def test_trace_id_threads_spans_dump_and_export(tmp_path):
    v = obs_smoke.run("cpu", dump_dir=str(tmp_path))
    assert v["ok"], v
    assert v["traced_spans"] >= 1 and v["traced_dump_events"] >= 1
    assert v["perfetto_spans"] >= 1 and v["perfetto_instants"] >= 1
    assert v["history_rows"] >= 1
    with open(v["dump"], encoding="utf-8") as fh:
        doc = json.load(fh)
    jax_validate(doc, require_fault=True, require_rounds=True)
