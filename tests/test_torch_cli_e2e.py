"""Process-level round trip through the real CLIs: record a live
simulator with cmd/sched_recorder, then boot a second simulator that
replays the record file (the reference's record-and-replay workflow,
recorder.go + replayer.go, driven end-to-end).

The port's mirror of tests/test_cli_e2e.py: the same cases against the
port's modules (kube_scheduler_simulator_tpu_torch), every engine and
CLI on the CPU (device="cpu", --device cpu).
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _api(port, method, path, body=None):
    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=data, method=method,
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=10) as r:
        raw = r.read()
        return json.loads(raw) if raw else None


def _wait_up(port, timeout=60):
    deadline = time.time() + timeout
    while time.time() < deadline:
        try:
            _api(port, "GET", "/api/v1/nodes")
            return
        except Exception:
            time.sleep(0.3)
    raise TimeoutError(f"simulator on :{port} never came up")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    env.update({k: str(v) for k, v in extra.items()})
    return env


def test_record_then_replay_roundtrip(tmp_path):
    record = tmp_path / "record.jsonl"
    port_a, port_b = 18241, 18242  # apart from tests/test_cli_e2e.py's, which may run at once

    sim_a = subprocess.Popen(
        [sys.executable, "-m", "kube_scheduler_simulator_tpu_torch.cmd.simulator", "--device", "cpu"],
        env=_env(PORT=port_a), cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    rec = None
    sim_b = None
    try:
        _wait_up(port_a)
        rec = subprocess.Popen(
            [sys.executable, "-m", "kube_scheduler_simulator_tpu_torch.cmd.sched_recorder",
             "--path", str(record), "--kubeconfig", f"http://127.0.0.1:{port_a}"],
            env=_env(), cwd=str(tmp_path),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        time.sleep(1.5)  # recorder subscribes

        _api(port_a, "POST", "/api/v1/nodes", {
            "metadata": {"name": "rec-node"},
            "status": {"allocatable": {"cpu": "8", "memory": "32Gi", "pods": "110"}}})
        _api(port_a, "POST", "/api/v1/pods", {
            "metadata": {"name": "rec-pod"},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": "1", "memory": "1Gi"}}}]}})

        # wait until the live scheduler binds the pod, then let the
        # recorder flush (its interval is 5s; SIGTERM also flushes)
        deadline = time.time() + 60
        while time.time() < deadline:
            pod = _api(port_a, "GET", "/api/v1/pods/default/rec-pod")
            if (pod.get("spec") or {}).get("nodeName"):
                break
            time.sleep(0.5)
        assert pod["spec"]["nodeName"] == "rec-node"
        time.sleep(1)
        rec.send_signal(signal.SIGINT)
        rec.wait(timeout=30)

        lines = [json.loads(l) for l in record.read_text().splitlines()]
        assert any(l["event"] == "Add" and l["resource"]["kind"] == "Node"
                   for l in lines)
        assert any(l["event"] == "Add" and l["resource"]["kind"] == "Pod"
                   for l in lines)

        # boot a fresh simulator that replays the record; its own
        # scheduler re-schedules the (scheduled-pod-filtered) pods
        sim_b = subprocess.Popen(
            [sys.executable, "-m", "kube_scheduler_simulator_tpu_torch.cmd.simulator", "--device", "cpu"],
            env=_env(PORT=port_b, REPLAYER_ENABLED="1",
                     RECORD_FILE_PATH=str(record)),
            cwd=str(tmp_path),
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        _wait_up(port_b, timeout=90)
        nodes = _api(port_b, "GET", "/api/v1/nodes")["items"]
        assert [n["metadata"]["name"] for n in nodes] == ["rec-node"]
        deadline = time.time() + 60
        pod_b = {}
        while time.time() < deadline:
            items = _api(port_b, "GET", "/api/v1/pods")["items"]
            if items and (items[0].get("spec") or {}).get("nodeName") \
                    and (items[0]["metadata"].get("annotations") or {}):
                pod_b = items[0]
                break
            time.sleep(0.5)
        assert pod_b.get("spec", {}).get("nodeName") == "rec-node"
        assert "kube-scheduler-simulator.sigs.k8s.io/selected-node" in \
            pod_b["metadata"]["annotations"]
    finally:
        for proc in (rec, sim_a, sim_b):
            if proc is not None and proc.poll() is None:
                proc.terminate()
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()


def test_external_scheduler_mode(tmp_path):
    """KWOK disableKubeScheduler analogue: the simulator boots with its
    in-process scheduling loop OFF (EXTERNAL_SCHEDULER_ENABLED), and a
    standalone cmd/scheduler process drives scheduling over the HTTP API
    (--once), writing the result annotations back through the remote
    store."""
    port = 18243
    sim = subprocess.Popen(
        [sys.executable, "-m", "kube_scheduler_simulator_tpu_torch.cmd.simulator", "--device", "cpu"],
        env=_env(PORT=port, EXTERNAL_SCHEDULER_ENABLED="1"),
        cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        _wait_up(port)
        _api(port, "POST", "/api/v1/nodes", {
            "metadata": {"name": "ext-node"},
            "status": {"allocatable": {"cpu": "8", "memory": "32Gi",
                                       "pods": "110"}}})
        _api(port, "POST", "/api/v1/pods", {
            "metadata": {"name": "ext-pod"},
            "spec": {"containers": [{"name": "c", "resources": {
                "requests": {"cpu": "1", "memory": "1Gi"}}}]}})
        time.sleep(2)
        pod = _api(port, "GET", "/api/v1/pods/default/ext-pod")
        assert not (pod.get("spec") or {}).get("nodeName"), \
            "loop must be off in external-scheduler mode"

        r = subprocess.run(
            [sys.executable, "-m", "kube_scheduler_simulator_tpu_torch.cmd.scheduler",
             "--master", f"http://127.0.0.1:{port}", "--once", "--device", "cpu"],
            env=_env(), cwd=str(tmp_path), timeout=240,
            capture_output=True, text=True)
        assert r.returncode == 0, r.stderr[-2000:]

        pod = _api(port, "GET", "/api/v1/pods/default/ext-pod")
        assert pod["spec"].get("nodeName") == "ext-node"
        anns = pod["metadata"].get("annotations") or {}
        key = "kube-scheduler-simulator.sigs.k8s.io/selected-node"
        assert anns.get(key) == "ext-node"
    finally:
        sim.terminate()
        sim.wait(timeout=15)
