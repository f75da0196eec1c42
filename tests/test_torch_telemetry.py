"""The port's device profile capture and the replay's telemetry taps, on
the CPU.

  * `Tracer.start_xla_profile` / `stop_xla_profile` run a torch.profiler
    session (CPU activity here, CUDA's too on a card) on a thread of its
    own, with the JAX tracer's contract (JAX utils/tracing.py:927-960,
    mirrored from tests/test_flight_recorder.py and tests/test_tracing.py):
    ProfileStateError on a double start and on a stop without a start, a
    session that dies outside the tracer reported the same way with the
    state cleared, and the stop's Chrome trace written into log_dir at
    the path it returns;
  * one CPU replay that retries a score width, retains its chunks, spills
    them under a zero budget and reads one back emits the six taps of the
    JAX replay under the JAX names: the `d2h_fetch` span, the
    `budget.spill` black-box record, the `device_chunks_retained` gauge,
    `replay_width_retries_total` and `wave_d2h_bytes_total`.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch.profiler

from kube_scheduler_simulator_tpu_torch.framework.replay import _DEVICE_BUDGET, replay
from kube_scheduler_simulator_tpu_torch.models import baseline_config
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import decode_pod_result
from kube_scheduler_simulator_tpu_torch.utils.blackbox import BLACKBOX
from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER, ProfileStateError, Tracer

# the module (the package's `framework.replay` attribute is the function)
replay_mod = importlib.import_module("kube_scheduler_simulator_tpu_torch.framework.replay")


def test_profile_double_start_and_stop_without_start(tmp_path):
    t = Tracer()
    with pytest.raises(ProfileStateError, match="no profile running"):
        t.stop_xla_profile()
    t.start_xla_profile(str(tmp_path))
    assert t.profiling
    with pytest.raises(ProfileStateError, match="already running"):
        t.start_xla_profile(str(tmp_path / "other"))
    path = t.stop_xla_profile()
    assert not t.profiling
    assert os.path.dirname(path) == str(tmp_path) and os.path.isfile(path)
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(ProfileStateError):
        t.stop_xla_profile()
    t.start_xla_profile(str(tmp_path))  # a new session after a clean stop
    assert os.path.isfile(t.stop_xla_profile())


def test_stop_profile_wraps_external_runtime_error(monkeypatch, tmp_path):
    """A session that died outside the tracer: the stop is a
    ProfileStateError (the server's 409), the state clears and a new
    start succeeds."""
    t = Tracer()
    real_stop = torch.profiler.profile.stop

    def dead_stop(self):
        real_stop(self)  # the session ends, and reports it died
        raise RuntimeError("no profiler session running")

    monkeypatch.setattr(torch.profiler.profile, "stop", dead_stop)
    t.start_xla_profile(str(tmp_path))
    with pytest.raises(ProfileStateError, match="no profiler session"):
        t.stop_xla_profile()
    assert not t.profiling
    monkeypatch.setattr(torch.profiler.profile, "stop", real_stop)
    t.start_xla_profile(str(tmp_path))
    assert os.path.isfile(t.stop_xla_profile())


def test_start_profile_wraps_external_runtime_error(monkeypatch, tmp_path):
    """A profiler started outside the tracer: the start is a
    ProfileStateError and nothing is left running."""
    t = Tracer()

    def busy_start(self):
        raise RuntimeError("a profiler is already enabled")

    monkeypatch.setattr(torch.profiler.profile, "start", busy_start)
    with pytest.raises(ProfileStateError, match="already enabled"):
        t.start_xla_profile(str(tmp_path))
    assert not t.profiling
    with pytest.raises(ProfileStateError, match="no profile running"):
        t.stop_xla_profile()


def test_replay_emits_the_jax_taps(monkeypatch):
    """One replay on the CPU's device-resident rung: a width retry (an
    injected overflow on its third chunk), every chunk retained and then
    spilled under a zero budget, one cold read: each of the six taps
    appears under the JAX replay's name."""
    nodes, pods, cfg = baseline_config(4, scale=0.02, seed=11)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    real = replay_mod._fetch_decisions
    state = {"count": 0}

    def inject(out, att):
        landing = real(out, att)
        state["count"] += 1
        if state["count"] == 3:
            land = landing.result

            def overflowed():
                c = land()
                c["raw_overflow"] = np.ones_like(c["raw_overflow"])
                return c

            landing.result = overflowed
        return landing

    monkeypatch.setattr(replay_mod, "_fetch_decisions", inject)
    for k in ("KSS_TPU_HOST_RESIDENT", "KSS_TPU_EAGER_DECODE", "KSS_TPU_DEVICE_RESULT_BUDGET_MB"):
        monkeypatch.delenv(k, raising=False)
    before = TRACER.summary()["counters"]
    spans0 = TRACER.summary()["spans"].get("d2h_fetch", {}).get("count", 0)
    rr = replay(cw, chunk=32, device="cpu", device_resident=True)
    assert rr.tiers == (None, "i32")
    n_chunks = len(rr._compact.packed)
    assert TRACER.snapshot()["gauges"]["device_chunks_retained"] >= n_chunks
    decode_pod_result(rr, 0)  # a cold read of chunk 0
    assert TRACER.summary()["spans"]["d2h_fetch"]["count"] == spans0 + 1

    monkeypatch.setenv("KSS_TPU_DEVICE_RESULT_BUDGET_MB", "0")
    rr2 = replay(cw, chunk=32, device="cpu", device_resident=True)
    _DEVICE_BUDGET.drain()
    spills = [e for e in BLACKBOX.events() if e.get("kind") == "budget.spill"]
    assert spills and spills[-1]["bytes"] > 0 and "chunk" in spills[-1]
    assert not any(rr2._compact.is_device(ci) for ci in range(len(rr2._compact.packed)))
    after = TRACER.summary()["counters"]
    assert after["replay_width_retries_total"] - before.get("replay_width_retries_total", 0) == 1
    wave = after["wave_d2h_bytes_total"] - before.get("wave_d2h_bytes_total", 0)
    assert wave == sum(rr._compact.d2h_bytes) + sum(rr2._compact.d2h_bytes) + sum(
        rr._compact.d2h_bytes[:2])  # the abandoned first tier's two chunks too
