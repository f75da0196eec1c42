"""Custom-plugin Reserve/Permit/PreBind/PostBind lifecycle through the
port's engine, mirroring tests/test_custom_lifecycle.py case by case.

Each case builds the same store and the same plugins (each package's own
CustomPlugin subclass) and runs schedule_pending() on the JAX engine and
on the port's (device="cpu").  The port is held to the JAX engine
exactly: the bound count, the lifecycle call log (phase order: all
Reserves, all Permits, all PreBinds, PostBind after the bind; Unreserve
for every reserve plugin in reverse order on any failure), and every
pod's node, conditions and annotation bytes (reserve / permit / prebind
results, the rerun after a rejection).  The port's cases keep the JAX
test's own checks and timeouts; each run has a deadline of its own, so a
Permit wait that hangs fails the test instead of holding the suite.
"""

import json
import threading
import time

import pytest

import test_torch_engine as te
from kube_scheduler_simulator_tpu.models.workloads import make_nodes, make_pods
from kube_scheduler_simulator_tpu.plugins import custom as jcustom
from kube_scheduler_simulator_tpu.scheduler import debuggable as jdebuggable
from kube_scheduler_simulator_tpu.scheduler import extender as jextender
from kube_scheduler_simulator_tpu_torch.plugins import custom as pcustom
from kube_scheduler_simulator_tpu_torch.scheduler import debuggable as pdebuggable
from kube_scheduler_simulator_tpu_torch.scheduler import extender as pextender
from kube_scheduler_simulator_tpu_torch.store import annotations as ann

# (package, its CustomPlugin, its PluginExtender, its ExtenderService)
PORT = (te.PORT, pcustom.CustomPlugin, pdebuggable.PluginExtender, pextender.ExtenderService)
JAX = (te.JAX, jcustom.CustomPlugin, jdebuggable.PluginExtender, jextender.ExtenderService)
DEADLINE_S = 60  # per engine run; the slowest case waits 0.5 s


def lifecycle_cls(base):
    class LifecyclePlugin(base):
        """Records every lifecycle call into a shared event log."""

        def __init__(self, name, log, reserve_msg=None, permit_out=None, pre_bind_msg=None):
            self.name = name
            self.log = log
            self._reserve_msg = reserve_msg
            self._permit_out = permit_out
            self._pre_bind_msg = pre_bind_msg

        def reserve(self, pod, node):
            self.log.append((self.name, "reserve"))
            return self._reserve_msg

        def unreserve(self, pod, node):
            self.log.append((self.name, "unreserve"))

        def permit(self, pod, node):
            self.log.append((self.name, "permit"))
            return self._permit_out

        def pre_bind(self, pod, node):
            self.log.append((self.name, "pre_bind"))
            return self._pre_bind_msg

        def post_bind(self, pod, node):
            self.log.append((self.name, "post_bind"))

    return LifecyclePlugin


def within(seconds: float, fn):
    """fn() on a thread of its own -> its result; fails the test if it
    has not returned after `seconds`."""
    out = {}

    def target():
        try:
            out["value"] = fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            out["error"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(seconds)
    if t.is_alive():
        pytest.fail(f"schedule_pending() still running after {seconds} s")
    if "error" in out:
        raise out["error"]
    return out["value"]


def run(side, make_plugins, n_nodes=3, n_pods=1, setup=None):
    """One engine of `side` (PORT / JAX) over make_nodes(n_nodes, 31) and
    make_pods(n_pods, 32) with the plugins make_plugins(side, log) ->
    (#bound, pod snapshot, log, the engine's waiting pods, node labels)."""
    pkg = side[0]
    log = []
    plugins = make_plugins(side, log)
    store = te.fill(pkg, {"nodes": make_nodes(n_nodes, seed=31),
                          "pods": make_pods(n_pods, seed=32)})
    for p in plugins:
        p.store_ref = store
    cfg = pkg.Cfg(enabled=["NodeResourcesFit"] + [p.name for p in plugins],
                  custom={p.name: p for p in plugins})
    engine = pkg.Engine(store, plugin_config=cfg, **pkg.kw)
    if setup is not None:
        setup(side, engine)
    bound = within(DEADLINE_S, engine.schedule_pending)
    out = (bound, te.snapshot(store), list(log), dict(engine.waiting_pods),
           [dict(n["metadata"].get("labels") or {}) for n in store.list("nodes")[0]])
    engine.close()
    return out


def mirror(make_plugins, **kw):
    """run() on the port and on the JAX engine, held equal -> the port's."""
    got, want = run(PORT, make_plugins, **kw), run(JAX, make_plugins, **kw)
    assert got[0] == want[0], "bound"
    assert got[2] == want[2], f"log: port {got[2]} != jax {want[2]}"
    te.assert_same(got[1], want[1])
    assert got[3] == want[3] and got[4] == want[4]
    return got


def annos_of(snap, name="pod-00000"):
    return snap[("default", name)][4]


def plugins(*specs):
    """make_plugins for LifecyclePlugins given as (name, kwargs)."""
    return lambda side, log: [lifecycle_cls(side[1])(n, log, **kw) for n, kw in specs]


def test_happy_path_records_all_phases_and_postbind():
    bound, snap, log, _, _ = mirror(plugins(("A", {}), ("B", {})))
    assert bound == 1
    assert log == [
        ("A", "reserve"), ("B", "reserve"),
        ("A", "permit"), ("B", "permit"),
        ("A", "pre_bind"), ("B", "pre_bind"),
        ("A", "post_bind"), ("B", "post_bind"),
    ]
    annos = annos_of(snap)
    assert json.loads(annos[ann.RESERVE_RESULT]) == {"A": "success", "B": "success"}
    assert json.loads(annos[ann.PERMIT_STATUS_RESULT]) == {"A": "success", "B": "success"}
    assert json.loads(annos[ann.PRE_BIND_RESULT]) == {"A": "success", "B": "success"}
    assert snap[("default", "pod-00000")][0]


def test_reserve_failure_unreserves_all_in_reverse_order():
    bound, snap, log, _, _ = mirror(plugins(
        ("A", {}), ("B", {"reserve_msg": "no capacity token"}), ("C", {})))
    assert bound == 0
    assert log == [
        ("A", "reserve"), ("B", "reserve"),
        ("C", "unreserve"), ("B", "unreserve"), ("A", "unreserve"),
    ]
    assert json.loads(annos_of(snap)[ann.RESERVE_RESULT])["B"] == "no capacity token"
    node, _, _, conditions, _ = snap[("default", "pod-00000")]
    assert not node
    conds = {c["type"]: c for c in conditions}
    assert conds["PodScheduled"]["reason"] == "Unschedulable"


def test_permit_deny_unreserves_and_fails_bind():
    bound, snap, log, _, _ = mirror(plugins(("A", {}), ("B", {"permit_out": "quota exceeded"})))
    assert bound == 0
    assert log == [
        ("A", "reserve"), ("B", "reserve"),
        ("A", "permit"), ("B", "permit"),
        ("B", "unreserve"), ("A", "unreserve"),
    ]
    permits = json.loads(annos_of(snap)[ann.PERMIT_STATUS_RESULT])
    assert permits == {"A": "success", "B": "quota exceeded"}


def test_prebind_failure_unreserves_and_fails_bind():
    bound, snap, log, _, _ = mirror(plugins(
        ("A", {}), ("B", {"pre_bind_msg": "volume attach failed"})))
    assert bound == 0
    assert ("B", "unreserve") in log and ("A", "unreserve") in log
    assert log.index(("B", "unreserve")) < log.index(("A", "unreserve"))
    assert ("A", "post_bind") not in log
    assert json.loads(annos_of(snap)[ann.PRE_BIND_RESULT])["B"] == "volume attach failed"


def test_permit_wait_timeout_rejects():
    bound, snap, log, _, _ = mirror(plugins(("A", {"permit_out": ("wait", "10ms")})))
    assert bound == 0
    annos = annos_of(snap)
    assert json.loads(annos[ann.PERMIT_TIMEOUT_RESULT])["A"] == "10ms"
    assert json.loads(annos[ann.PERMIT_STATUS_RESULT])["A"] == "timeout"
    assert ("A", "unreserve") in log


def _waiter(on_waiting):
    """make_plugins for one plugin "A" waiting 30s, whose on_waiting is
    on_waiting(plugin, waiting_pod)."""

    def make(side, log):
        class Waiter(lifecycle_cls(side[1])):
            def on_waiting(self, waiting_pod):
                on_waiting(self, waiting_pod)

        return [Waiter("A", log, permit_out=("wait", "30s"))]

    return make


def test_permit_wait_allowed_by_handle():
    bound, snap, _, _, _ = mirror(_waiter(lambda p, wp: wp.allow(p.name)))
    assert bound == 1
    assert snap[("default", "pod-00000")][0]
    annos = annos_of(snap)
    assert json.loads(annos[ann.PERMIT_STATUS_RESULT])["A"] == "wait"
    assert json.loads(annos[ann.PERMIT_TIMEOUT_RESULT])["A"] == "30s"


def test_permit_wait_allowed_from_thread():
    def later_allow(plugin, wp):
        released = threading.Event()

        def _later():
            released.wait(5)
            wp.allow(plugin.name)

        threading.Thread(target=_later, daemon=True).start()
        released.set()

    bound, snap, _, waiting, _ = mirror(_waiter(later_allow))
    assert bound == 1
    assert snap[("default", "pod-00000")][0]
    assert waiting == {}


def test_permit_wait_rejected_by_handle():
    bound, snap, log, _, _ = mirror(_waiter(lambda p, wp: wp.reject(p.name, "external veto")))
    assert bound == 0
    assert json.loads(annos_of(snap)[ann.PERMIT_STATUS_RESULT])["A"] == "external veto"
    assert ("A", "unreserve") in log


def test_lifecycle_rejection_reruns_wave_for_later_pods():
    """A rejection after the pod was folded into the carry must not poison
    later pods of the wave: the wave re-runs against true state."""

    def make(side, log):
        class RejectOne(lifecycle_cls(side[1])):
            def reserve(self, pod, node):
                self.log.append((pod["metadata"]["name"], "reserve"))
                if pod["metadata"]["name"] == "pod-00000":
                    return "rejected by policy"
                return None

        return [RejectOne("A", log)]

    bound, snap, log, _, _ = mirror(make, n_nodes=3, n_pods=4)
    assert bound == 3
    assert not snap[("default", "pod-00000")][0]
    for i in (1, 2, 3):
        assert snap[("default", f"pod-0000{i}")][0]
    # pod-00000's reserve ran exactly once: subsequent waves exclude it
    assert log.count(("pod-00000", "reserve")) == 1


def test_permit_wait_does_not_stall_other_pods():
    """A waiting pod must not block the wave: the others bind while it
    waits; it binds on resolution."""
    seen = {}

    def make(side, log):
        class SlowWaiter(lifecycle_cls(side[1])):
            def permit(self, pod, node):
                self.log.append((self.name, "permit"))
                if pod["metadata"]["name"] == "pod-00000":
                    return ("wait", "10s")
                return None

            def on_waiting(self, waiting_pod):
                wp = waiting_pod

                def later():
                    time.sleep(0.5)
                    # how many OTHER pods bound while we waited
                    pods, _ = self.store_ref.list("pods")
                    seen[side[0] is te.PORT] = sum(
                        1 for p in pods
                        if (p.get("spec") or {}).get("nodeName")
                        and p["metadata"]["name"] != "pod-00000")
                    wp.allow(self.name)

                threading.Thread(target=later, daemon=True).start()

        return [SlowWaiter("A", log)]

    t0 = time.time()
    bound, snap, _, _, _ = run(PORT, make, n_pods=3)
    elapsed = time.time() - t0
    jbound, jsnap, _, _, _ = run(JAX, make, n_pods=3)
    te.assert_same(snap, jsnap)
    assert bound == jbound == 3
    # the 0.5 s wait overlapped the rest of the wave, and the others were
    # bound when the waiter was allowed
    assert seen == {True: 2, False: 2}
    assert elapsed < 5, f"wave stalled on the waiter: {elapsed:.1f}s"
    for name in ("pod-00000", "pod-00001", "pod-00002"):
        assert snap[("default", name)][0]
    assert json.loads(annos_of(snap)[ann.PERMIT_STATUS_RESULT])["A"] == "wait"


def test_mutating_plugin_cannot_corrupt_store_state():
    """Plugins receive private copies: a plugin that mutates the pod or
    node it is handed must not change live cluster state."""

    def make(side, log):
        class Mutator(lifecycle_cls(side[1])):
            def reserve(self, pod, node):
                pod.setdefault("metadata", {}).setdefault("labels", {})["rogue"] = "yes"
                if node is not None:
                    node.setdefault("metadata", {}).setdefault("labels", {})["rogue"] = "yes"
                return None

            def post_bind(self, pod, node):
                pod["spec"]["nodeName"] = "hijacked"

        return [Mutator("M", log)]

    bound, snap, _, _, node_labels = mirror(make)
    assert bound == 1
    assert snap[("default", "pod-00000")][0] not in (None, "hijacked")
    for labels in node_labels:
        assert "rogue" not in labels


def test_host_path_runs_postbind_after_successful_bind():
    """The host-interleaved path (forced by a cycle hook) runs PostBind
    after a successful bind."""

    def setup(side, engine):
        class NoopHook(side[2]):
            def before_filter(self, pod, node_name):
                return None

        engine.plugin_extenders = {"NodeResourcesFit": NoopHook()}
        assert engine._needs_host_path()

    bound, snap, log, _, _ = mirror(plugins(("A", {})), setup=setup)
    assert bound == 1
    assert ("A", "post_bind") in log
    assert snap[("default", "pod-00000")][0]


def test_bind_extender_failure_unreserves_custom_plugins():
    """A bind-verb extender failing the binding cycle (host path) runs
    Unreserve, as upstream does on any failure after Reserve."""

    def setup(side, engine):
        # bindVerb on a closed localhost port: the bind call fails the cycle
        engine.set_extenders(side[3]([{"urlPrefix": "http://127.0.0.1:1", "bindVerb": "bind"}]))

    bound, snap, log, _, _ = mirror(plugins(("A", {})), setup=setup)
    assert bound == 0
    assert ("A", "reserve") in log
    assert ("A", "unreserve") in log
    assert ("A", "post_bind") not in log
    assert not snap[("default", "pod-00000")][0]
