"""Remote-cluster client + standalone scheduler/recorder process topology.

Exercises the out-of-process architecture of the reference (scheduler and
sched-recorder as separate processes talking to the apiserver over HTTP,
reference: compose.yml:1-73) — here, RemoteCluster against a live
SimulatorServer running with the in-process scheduler disabled (the KWOK
disableKubeScheduler analogue).

The port's mirror of tests/test_remote.py: the same cases against the
port's modules (kube_scheduler_simulator_tpu_torch), every engine and
CLI on the CPU (device="cpu", --device cpu).
"""

import json
import time

import pytest

from kube_scheduler_simulator_tpu_torch.cluster.remote import RemoteCluster
from kube_scheduler_simulator_tpu_torch.cluster.store import AlreadyExists, Conflict, NotFound
from kube_scheduler_simulator_tpu_torch.config.config import SimulatorConfiguration
from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
from kube_scheduler_simulator_tpu_torch.models.workloads import make_nodes, make_pods
from kube_scheduler_simulator_tpu_torch.server.di import DIContainer
from kube_scheduler_simulator_tpu_torch.server.server import SimulatorServer
from kube_scheduler_simulator_tpu_torch.services.recorder import RecorderService
from kube_scheduler_simulator_tpu_torch.store import annotations as ann


@pytest.fixture()
def sim():
    """Server with the in-process scheduling loop OFF."""
    cfg = SimulatorConfiguration(port=0, external_scheduler_enabled=True)
    di = DIContainer(cfg, start_scheduler=not cfg.external_scheduler_enabled, device="cpu")
    srv = SimulatorServer(di, port=0, device="cpu")
    srv.start(block=False)
    remote = RemoteCluster(f"http://127.0.0.1:{srv.port}")
    yield srv, remote
    remote.close()
    srv.shutdown()


def test_remote_crud_and_errors(sim):
    srv, remote = sim
    node = make_nodes(1, seed=5)[0]
    created = remote.create("nodes", node)
    assert created["metadata"]["uid"]
    with pytest.raises(AlreadyExists):
        remote.create("nodes", node)

    got = remote.get("nodes", node["metadata"]["name"])
    assert got["metadata"]["name"] == node["metadata"]["name"]

    got["metadata"]["labels"] = {"zone": "z1"}
    updated = remote.update("nodes", got)
    assert updated["metadata"]["labels"]["zone"] == "z1"

    # stale-rv write → Conflict, like the apiserver
    got["metadata"]["resourceVersion"] = "1"
    with pytest.raises(Conflict):
        remote.update("nodes", got)

    items, rv = remote.list("nodes")
    assert len(items) == 1 and rv > 0
    items, _ = remote.list("nodes", label_selector={"matchLabels": {"zone": "z1"}})
    assert len(items) == 1
    items, _ = remote.list("nodes", label_selector={"matchLabels": {"zone": "nope"}})
    assert items == []

    remote.delete("nodes", node["metadata"]["name"])
    with pytest.raises(NotFound):
        remote.get("nodes", node["metadata"]["name"])


def test_remote_watch_stream(sim):
    srv, remote = sim
    q = remote.watch("pods")
    pod = make_pods(1, seed=6)[0]
    remote.create("pods", pod)
    rv, event_type, obj = q.get(timeout=10)
    assert event_type == "ADDED"
    assert obj["metadata"]["name"] == pod["metadata"]["name"]
    remote.unwatch("pods", q)


def test_remote_watch_no_duplicate_initial_events(sim):
    """An object that existed before the stream connected arrives exactly
    once (listing ADDED), not twice (listing + event-ring replay)."""
    srv, remote = sim
    node = make_nodes(1, seed=61)[0]
    remote.create("nodes", node)
    q = remote.watch("nodes")
    events = []
    deadline = time.time() + 3
    while time.time() < deadline:
        try:
            events.append(q.get(timeout=0.3))
        except Exception:
            pass
    added = [e for e in events
             if e[1] == "ADDED" and e[2]["metadata"]["name"] == node["metadata"]["name"]]
    assert len(added) == 1, f"expected 1 ADDED, got {len(added)}"
    remote.unwatch("nodes", q)


def test_remote_watch_late_registration_replays_initial_state(sim):
    """A watcher registered after the shared stream already delivered the
    initial listing still sees it (buffered replay) — the recorder
    subscribes to 7 kinds sequentially and must miss none."""
    srv, remote = sim
    node = make_nodes(1, seed=60)[0]
    remote.create("nodes", node)
    q_pods = remote.watch("pods")  # starts the shared stream
    # wait until the stream has delivered the nodes listing
    deadline = time.time() + 10
    while time.time() < deadline:
        with remote._lock:
            if remote._events["nodes"]:
                break
        time.sleep(0.05)
    q_nodes = remote.watch("nodes")  # late: after the initial listing
    rv, event_type, obj = q_nodes.get(timeout=10)
    assert event_type == "ADDED"
    assert obj["metadata"]["name"] == node["metadata"]["name"]
    remote.unwatch("pods", q_pods)
    remote.unwatch("nodes", q_nodes)


def test_standalone_scheduler_over_http(sim):
    """The cmd/scheduler flow: engine in 'another process' drives the
    simulator over HTTP; bindings and annotations land via PUT."""
    srv, remote = sim
    for n in make_nodes(3, seed=7):
        remote.create("nodes", n)
    pods = make_pods(4, seed=8)
    for p in pods:
        remote.create("pods", p)

    engine = SchedulerEngine(remote, device="cpu")  # own reflector over the remote store
    n = engine.schedule_pending()
    assert n == 4

    for p in pods:
        got = remote.get("pods", p["metadata"]["name"],
                         p["metadata"].get("namespace"))
        assert got["spec"].get("nodeName")
        anns = got["metadata"]["annotations"]
        assert ann.SELECTED_NODE in anns
        assert ann.FINAL_SCORE_RESULT in anns
        json.loads(anns[ann.FINAL_SCORE_RESULT])


def test_remote_watch_reconnect_resumes_without_duplicates(sim):
    """After a dropped stream, the client reconnects with per-kind
    *LastResourceVersion params: pre-drop objects are NOT re-delivered as
    ADDED, and post-drop events still arrive."""
    srv, remote = sim
    node = make_nodes(2, seed=62)[0]
    remote.create("nodes", node)
    q = remote.watch("nodes")
    rv, et, obj = q.get(timeout=10)
    assert et == "ADDED"

    remote._abort_stream()  # simulate a dropped connection
    time.sleep(1.0)         # reconnect loop (0.5s backoff)

    node2 = make_nodes(2, seed=62)[1]
    remote.create("nodes", node2)
    events = []
    deadline = time.time() + 10
    while time.time() < deadline and len(events) < 1:
        try:
            events.append(q.get(timeout=0.5))
        except Exception:
            pass
    # drain briefly to catch any duplicate re-listing
    deadline = time.time() + 1.5
    while time.time() < deadline:
        try:
            events.append(q.get(timeout=0.3))
        except Exception:
            pass
    names = [e[2]["metadata"]["name"] for e in events if e[1] == "ADDED"]
    assert node2["metadata"]["name"] in names
    assert node["metadata"]["name"] not in names, "pre-drop object re-delivered"


def test_recorder_over_remote(sim, tmp_path):
    srv, remote = sim
    path = tmp_path / "record.jsonl"
    rec = RecorderService(remote, str(path), flush_interval=0.1)
    rec.run()
    node = make_nodes(1, seed=9)[0]
    remote.create("nodes", node)
    remote.delete("nodes", node["metadata"]["name"])
    deadline = time.time() + 10
    while time.time() < deadline:
        lines = [json.loads(l) for l in path.read_text().splitlines()] if path.exists() else []
        if len(lines) >= 2:
            break
        time.sleep(0.1)
    rec.stop()
    events = [l["event"] for l in lines]
    assert "Add" in events and "Delete" in events
    dels = [l for l in lines if l["event"] == "Delete"]
    # delete records keep only identity fields (recorder.go:121-133)
    assert set(dels[0]["resource"].keys()) == {"apiVersion", "kind", "metadata"}
