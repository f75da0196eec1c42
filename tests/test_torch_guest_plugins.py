"""Guest plugins in the port (scheduler/guest.py, loaded by
scheduler/service.py at restart), mirroring tests/test_guest_plugins.py
case by case.

A guest for the port imports kube_scheduler_simulator_tpu_torch.plugins.custom;
the JAX package's guest imports its own.  Each case loads the same guest
source (with the package's import) through both packages and holds the
port to the JAX package exactly: the plugins collected, and, end to end,
every pod's node and annotation bytes after SchedulerService.restart_scheduler
and SchedulerEngine.schedule_pending(), with the rollback after a guest
that fails to load.  Beyond tests/test_guest_plugins.py: the same guest
POSTed to the port's HTTP server.
"""

import json

import pytest

import test_torch_engine as te
from kube_scheduler_simulator_tpu.models.workloads import make_nodes, make_pods
from kube_scheduler_simulator_tpu.scheduler import guest as jguest
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JService
from kube_scheduler_simulator_tpu_torch.plugins.custom import CustomPlugin
from kube_scheduler_simulator_tpu_torch.scheduler import guest as pguest
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
from kube_scheduler_simulator_tpu_torch.store import annotations as ann

PORT_PKG, JAX_PKG = "kube_scheduler_simulator_tpu_torch", "kube_scheduler_simulator_tpu"

GUEST_SRC = '''
from {pkg}.plugins.custom import CustomPlugin

class Plugin(CustomPlugin):
    default_weight = 1
    def filter(self, pod, node):
        idx = int(node["metadata"]["name"].rsplit("-", 1)[1])
        return None if idx == 0 else "guest says no"
'''

GUEST_FACTORY_SRC = '''
from {pkg}.plugins.custom import CustomPlugin

def plugin(name, args):
    class P(CustomPlugin):
        def score(self, pod, node):
            return int(args.get("bonus", 0))
    return P()
'''


def _write(tmp_path, stem: str, src: str, pkg: str):
    path = tmp_path / f"{stem}_{pkg}.py"
    path.write_text(src.format(pkg=pkg))
    return path


def _cfg_with_guest(path, name="MyGuest", enabled=True, args_extra=None):
    mp = {"enabled": ([{"name": name}] if enabled else [])}
    return {
        "apiVersion": "kubescheduler.config.k8s.io/v1",
        "kind": "KubeSchedulerConfiguration",
        "profiles": [{
            "schedulerName": "default-scheduler",
            "plugins": {"multiPoint": mp},
            "pluginConfig": [
                {"name": name,
                 "args": {"guestURL": str(path), **(args_extra or {})}},
            ],
        }],
    }


def test_collect_only_enabled(tmp_path):
    for mod, pkg in ((pguest, PORT_PKG), (jguest, JAX_PKG)):
        guest = _write(tmp_path, "guest", GUEST_SRC, pkg)
        out = mod.collect_guest_plugins(_cfg_with_guest(guest, enabled=True))
        assert list(out) == ["MyGuest"] and out["MyGuest"].name == "MyGuest"
        # not multiPoint-enabled -> not registered (wasm.go:46-55)
        assert mod.collect_guest_plugins(_cfg_with_guest(guest, enabled=False)) == {}
        # non-guest pluginConfig entries are skipped, not errors
        assert mod.collect_guest_plugins({"profiles": [{"pluginConfig": [
            {"name": "NodeResourcesFit", "args": {"scoringStrategy": {}}}]}]}) == {}
    port = pguest.collect_guest_plugins(
        _cfg_with_guest(_write(tmp_path, "guest", GUEST_SRC, PORT_PKG)))["MyGuest"]
    assert isinstance(port, CustomPlugin)
    assert type(port).__module__ == f"{PORT_PKG}.guests.MyGuest"
    assert port.has_filter and not port.has_score
    # a guest of the other package is not a CustomPlugin of the port
    with pytest.raises(ValueError, match="must produce a CustomPlugin"):
        pguest.collect_guest_plugins(
            _cfg_with_guest(_write(tmp_path, "guest", GUEST_SRC, JAX_PKG)))


def test_guest_factory_and_args(tmp_path):
    for mod, pkg in ((pguest, PORT_PKG), (jguest, JAX_PKG)):
        guest = _write(tmp_path, "guest_factory", GUEST_FACTORY_SRC, pkg)
        out = mod.collect_guest_plugins(
            _cfg_with_guest(guest, name="Bonus", args_extra={"bonus": 7}))
        p = out["Bonus"]
        assert p.name == "Bonus" and p.score({}, {}) == 7 and p.has_score


def test_network_guest_url_rejected(tmp_path):
    cfg = _cfg_with_guest("http://evil.example/p.py")
    with pytest.raises(ValueError, match="file") as got:
        pguest.collect_guest_plugins(cfg)
    with pytest.raises(ValueError, match="file") as want:
        jguest.collect_guest_plugins(cfg)
    assert str(got.value) == str(want.value)
    # file:// and plain paths are taken
    guest = _write(tmp_path, "guest", GUEST_SRC, PORT_PKG)
    for url in (f"file://{guest}", str(guest)):
        assert list(pguest.collect_guest_plugins(_cfg_with_guest(url))) == ["MyGuest"]


def _service_run(pkg, service_cls, guest, missing):
    """Restart a service of `pkg` with the guest, schedule one pod, then
    restart it with a guest path that does not exist -> (engine's enabled
    list, pod snapshot, the config after the failed restart, enabled
    after it)."""
    store = pkg.Store()
    engine = pkg.Engine(store, **pkg.kw)
    svc = service_cls(engine)
    svc.restart_scheduler(_cfg_with_guest(guest))
    enabled = list(engine.plugin_config.enabled)
    for n in make_nodes(3, seed=30):
        store.create("nodes", n)
    store.create("pods", make_pods(1, seed=31)[0])
    assert engine.schedule_pending() == 1
    snap = te.snapshot(store)
    # a broken guest path fails the restart and rolls back (scheduler.go:102-108)
    with pytest.raises(Exception):
        svc.restart_scheduler(_cfg_with_guest(missing))
    after = svc.get_config()
    engine.close()
    return enabled, snap, after, list(engine.plugin_config.enabled)


def test_guest_end_to_end_and_rollback(tmp_path):
    """The default profile plus the guest (13 filters), through the
    port's SchedulerService and engine, byte for byte against the JAX
    service's annotations."""
    got = _service_run(te.PORT, SchedulerService, _write(tmp_path, "guest", GUEST_SRC, PORT_PKG),
                       tmp_path / "missing.py")
    want = _service_run(te.JAX, JService, _write(tmp_path, "guest", GUEST_SRC, JAX_PKG),
                        tmp_path / "missing.py")
    enabled, snap, after, enabled_after = got
    assert "MyGuest" in enabled and enabled == want[0]
    te.assert_same(snap, want[1])
    (node, _, _, _, annos), = snap.values()
    # guest vetoes all but node 0, and its message lands in filter-result
    assert node == "node-00000"
    fr = json.loads(annos[ann.FILTER_RESULT])
    assert fr["node-00001"]["MyGuest"] == "guest says no"
    # rolled back: the guest still enabled, its config still current
    assert "MyGuest" in enabled_after and enabled_after == want[3]
    pcs = {p["name"]: p["args"] for p in after["profiles"][0]["pluginConfig"]}
    assert pcs["MyGuest"]["guestURL"].endswith(f"guest_{PORT_PKG}.py")
    jpcs = {p["name"]: p["args"] for p in want[2]["profiles"][0]["pluginConfig"]}
    assert {k: v for k, v in pcs.items() if k != "MyGuest"} == \
        {k: v for k, v in jpcs.items() if k != "MyGuest"}


def test_guest_through_the_http_configuration_api(tmp_path):
    """POST /api/v1/schedulerconfiguration with a guest, on the port's
    server (device="cpu"): the scheduling loop binds a POSTed pod where
    the guest lets it, its message in filter-result; a config whose guest
    does not load is refused and the guest's config stays current."""
    import test_torch_server as ts
    from kube_scheduler_simulator_tpu_torch.config.config import SimulatorConfiguration
    from kube_scheduler_simulator_tpu_torch.server.di import DIContainer
    from kube_scheduler_simulator_tpu_torch.server.server import SimulatorServer

    guest = _write(tmp_path, "guest", GUEST_SRC, PORT_PKG)
    di = DIContainer(SimulatorConfiguration(port=0), device="cpu")
    srv = SimulatorServer(di, port=0, device="cpu")
    srv.start(block=False)
    try:
        code, _ = ts.req(srv, "POST", "/api/v1/schedulerconfiguration", _cfg_with_guest(guest))
        assert code == 202
        for n in make_nodes(3, seed=30):
            assert ts.req(srv, "POST", "/api/v1/nodes", n)[0] in (200, 201)
        pod = make_pods(1, seed=31)[0]
        assert ts.req(srv, "POST", "/api/v1/pods", pod)[0] in (200, 201)
        got = ts._bound(srv, f"/api/v1/pods/{pod['metadata']['name']}")
        assert got is not None and got["spec"]["nodeName"] == "node-00000"
        fr = json.loads(got["metadata"]["annotations"][ann.FILTER_RESULT])
        assert fr["node-00001"]["MyGuest"] == "guest says no"
        code, _ = ts.req(srv, "POST", "/api/v1/schedulerconfiguration",
                         _cfg_with_guest(tmp_path / "missing.py"))
        assert code >= 400
        _, cfg = ts.req(srv, "GET", "/api/v1/schedulerconfiguration")
        pcs = {p["name"]: p["args"] for p in cfg["profiles"][0]["pluginConfig"]}
        assert pcs["MyGuest"]["guestURL"] == str(guest)
    finally:
        srv.shutdown()
