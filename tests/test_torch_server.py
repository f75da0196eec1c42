"""HTTP API tests of the port's server — the mirror of tests/test_server.py:
the real server on an ephemeral port, `device="cpu"`, driven over HTTP.

Route-parity checks against reference simulator/server/server.go:42-61,
and a POSTed pod's 13 annotations against the JAX package's server on
the same nodes.
"""

import json
import threading
import time
import urllib.request

import pytest

from kube_scheduler_simulator_tpu.config.config import (
    SimulatorConfiguration as JaxConfiguration)
from kube_scheduler_simulator_tpu.server.di import DIContainer as JaxDI
from kube_scheduler_simulator_tpu.server.server import SimulatorServer as JaxServer
from kube_scheduler_simulator_tpu_torch.config.config import SimulatorConfiguration
from kube_scheduler_simulator_tpu_torch.models.workloads import make_nodes
from kube_scheduler_simulator_tpu_torch.server.di import DIContainer
from kube_scheduler_simulator_tpu_torch.server.server import SimulatorServer
from kube_scheduler_simulator_tpu_torch.store import annotations as ann

# a bound wait generous enough for a loaded CPU (the first wave builds the
# native codec)
BIND_WAIT_S = 60


@pytest.fixture()
def server():
    cfg = SimulatorConfiguration(port=0)
    di = DIContainer(cfg, device="cpu")
    srv = SimulatorServer(di, port=0, device="cpu")
    srv.start(block=False)
    yield srv
    srv.shutdown()


def _bound(srv, path):
    deadline = time.time() + BIND_WAIT_S
    while time.time() < deadline:
        _, got = req(srv, "GET", path)
        if (got.get("spec") or {}).get("nodeName"):
            return got
        time.sleep(0.1)
    return None


def req(srv, method, path, body=None):
    url = f"http://127.0.0.1:{srv.port}{path}"
    data = json.dumps(body).encode() if body is not None else None
    r = urllib.request.Request(url, data=data, method=method,
                               headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(r, timeout=10) as resp:
            raw = resp.read()
            return resp.status, json.loads(raw) if raw else None
    except urllib.error.HTTPError as e:
        raw = e.read()
        return e.code, json.loads(raw) if raw else None


def test_scheduler_configuration_roundtrip(server):
    code, cfg = req(server, "GET", "/api/v1/schedulerconfiguration")
    assert code == 200 and cfg["kind"] == "KubeSchedulerConfiguration"
    code, _ = req(server, "POST", "/api/v1/schedulerconfiguration", {
        "profiles": [{"schedulerName": "default-scheduler", "plugins": {
            "multiPoint": {"enabled": [{"name": "NodeResourcesFit", "weight": 9}],
                           "disabled": [{"name": "*"}]}}}],
    })
    assert code == 202
    code, cfg = req(server, "GET", "/api/v1/schedulerconfiguration")
    assert cfg["profiles"][0]["plugins"]["multiPoint"]["enabled"][0]["weight"] == 9


def test_resource_crud_and_scheduling_e2e(server):
    for n in make_nodes(3, seed=2):
        code, _ = req(server, "POST", "/api/v1/nodes", n)
        assert code == 201
    pod = {"metadata": {"name": "web", "namespace": "default"},
           "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "500m"}}}]}}
    code, created = req(server, "POST", "/api/v1/pods", pod)
    assert code == 201 and created["metadata"]["uid"]
    # the scheduling loop should bind + annotate it
    bound = _bound(server, "/api/v1/pods/default/web")
    assert bound, "pod was not scheduled by the scheduling loop"
    annos = bound["metadata"]["annotations"]
    assert annos[ann.SELECTED_NODE] == bound["spec"]["nodeName"]
    assert ann.FINAL_SCORE_RESULT in annos
    assert bound["status"]["phase"] == "Running"
    # the JAX package's server, same nodes, same pod: the same 13
    # annotations, byte for byte
    jsrv = JaxServer(JaxDI(JaxConfiguration(port=0)), port=0)
    jsrv.start(block=False)
    try:
        for n in make_nodes(3, seed=2):
            assert req(jsrv, "POST", "/api/v1/nodes", n)[0] == 201
        assert req(jsrv, "POST", "/api/v1/pods", pod)[0] == 201
        jbound = _bound(jsrv, "/api/v1/pods/default/web")
        assert jbound, "the JAX server did not bind the pod"
    finally:
        jsrv.shutdown()
    mine = {k: v for k, v in annos.items() if k.startswith(ann.PREFIX)}
    theirs = {k: v for k, v in jbound["metadata"]["annotations"].items()
              if k.startswith(ann.PREFIX)}
    assert len(mine) >= 13 and mine == theirs  # the 13 results and the history
    assert bound["spec"]["nodeName"] == jbound["spec"]["nodeName"]


def test_export_import_reset(server):
    req(server, "POST", "/api/v1/nodes", make_nodes(1, seed=3)[0])
    code, snap = req(server, "GET", "/api/v1/export")
    assert code == 200 and len(snap["nodes"]) == 1
    code, _ = req(server, "PUT", "/api/v1/reset")
    assert code == 202
    _, after = req(server, "GET", "/api/v1/export")
    assert after["nodes"] == []
    code, _ = req(server, "POST", "/api/v1/import", snap)
    assert code == 200
    _, back = req(server, "GET", "/api/v1/export")
    assert len(back["nodes"]) == 1


def test_listwatch_stream(server):
    req(server, "POST", "/api/v1/nodes", make_nodes(1, seed=4)[0])
    url = f"http://127.0.0.1:{server.port}/api/v1/listwatchresources"
    events = []

    def read_stream():
        with urllib.request.urlopen(url, timeout=5) as resp:
            dec = json.JSONDecoder()
            buf = ""
            while len(events) < 2:
                chunk = resp.read1(65536).decode()
                if not chunk:
                    break
                buf += chunk
                while buf:
                    try:
                        obj, end = dec.raw_decode(buf)
                    except json.JSONDecodeError:
                        break
                    events.append(obj)
                    buf = buf[end:]

    t = threading.Thread(target=read_stream, daemon=True)
    t.start()
    time.sleep(0.3)
    req(server, "POST", "/api/v1/nodes", {"metadata": {"name": "late-node"},
                                          "status": {"allocatable": {"cpu": "1"}}})
    t.join(timeout=5)
    kinds = [(e["kind"], e["eventType"]) for e in events]
    assert ("Node", "ADDED") in kinds
    names = [e["obj"]["metadata"]["name"] for e in events if e["kind"] == "Node"]
    assert "late-node" in names or len(names) >= 1


def test_extender_route_without_extenders(server):
    code, body = req(server, "POST", "/api/v1/extender/filter/0", {"Nodes": None})
    assert code == 400


def test_unknown_route_404(server):
    code, _ = req(server, "GET", "/api/v1/nosuch")
    assert code == 404


def test_web_ui_served(server):
    url = f"http://127.0.0.1:{server.port}/"
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/html")
        body = resp.read().decode()
    # the SPA loads its modules (api/store/components split like the
    # reference's web/ layout); fetch them and check load-bearing hooks
    for asset in ("yaml.js", "api.js", "store.js", "components.js", "app.js"):
        assert f"/web/{asset}" in body, asset
        with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/web/{asset}",
                                    timeout=10) as resp:
            assert resp.status == 200
            body += resp.read().decode()
    for needle in ("listwatchresources", "finalscore-result", "schedulerconfiguration",
                   "watchLoop", "api/v1/scenarios"):
        assert needle in body, needle


def test_listwatch_resume_skips_old_events(server):
    """The reconnect contract (reference handler/watcher.go takes
    *LastResourceVersion form values): a client resuming with the RV it
    already saw gets no replayed ADDED for old objects, only newer
    events."""
    _, created = req(server, "POST", "/api/v1/nodes",
                     {"metadata": {"name": "old-node"},
                      "status": {"allocatable": {"cpu": "1"}}})
    rv = created["metadata"]["resourceVersion"]
    url = (f"http://127.0.0.1:{server.port}/api/v1/listwatchresources"
           f"?nodesLastResourceVersion={rv}")
    events = []

    def read_stream():
        with urllib.request.urlopen(url, timeout=5) as resp:
            dec = json.JSONDecoder()
            buf = ""
            while not any(e["kind"] == "Node" for e in events):
                chunk = resp.read1(65536).decode()
                if not chunk:
                    break
                buf += chunk
                while buf:
                    try:
                        obj, end = dec.raw_decode(buf)
                    except json.JSONDecodeError:
                        break
                    events.append(obj)
                    buf = buf[end:]

    t = threading.Thread(target=read_stream, daemon=True)
    t.start()
    time.sleep(0.3)
    req(server, "POST", "/api/v1/nodes", {"metadata": {"name": "new-node"},
                                          "status": {"allocatable": {"cpu": "1"}}})
    t.join(timeout=5)
    node_names = [e["obj"]["metadata"]["name"] for e in events if e["kind"] == "Node"]
    assert "new-node" in node_names
    assert "old-node" not in node_names  # resumed past it


def test_profile_route_answers_not_implemented(server):
    """Device profile capture is not ported: a clear 501, never a 500."""
    code, body = req(server, "POST", "/api/v1/profile", {"action": "start"})
    assert code == 501 and "not ported" in body["message"]


def test_sessions_surface_reports_fuse_and_device(server):
    code, listing = req(server, "GET", "/api/v1/sessions")
    assert code == 200
    assert {"enabled", "fusedDeviceCalls", "dispatches"} <= set(listing["fuse"])
    assert server.manager.device == "cpu"
    assert server.di.engine.device.type == "cpu"


def test_new_scheduler_command_builds_the_server_on_the_device():
    from kube_scheduler_simulator_tpu_torch.scheduler.debuggable import new_scheduler_command

    di, srv = new_scheduler_command(port=0, start_scheduler=False, device="cpu")
    try:
        assert di.engine.device.type == "cpu" and srv.di is di
    finally:
        srv.manager.shutdown()


def test_kube_config_source_is_not_ported():
    cfg = SimulatorConfiguration(port=0, external_import_enabled=True, kube_config="x")
    with pytest.raises(NotImplementedError, match="kubeapi"):
        DIContainer(cfg, start_scheduler=False, device="cpu")
