"""The engine's node-table reuse across waves (framework/engine.py
`_last_cw`, `pod_columns=`) and the preemption dry runs' reuse across
fit hypotheses (framework/preemption.py `_fit_cw`) on the port
(device="cpu") against the JAX engine.

A store of each package holds the same cluster, loaded through the
columnar plane (KSS_TPU_COLUMNAR=1) or the dict baseline (=0); four
waves of pods are scheduled with churn between them: nothing changes
(the node table is reused), eight node updates (delta patch), one node
added (rebuild).  After every wave each pod's node and annotation bytes
must equal the JAX engine's, and so must the node-table counters the
wave moved.
"""

from __future__ import annotations

import contextlib
import copy
import os

import pytest

from kube_scheduler_simulator_tpu.cluster.store import ObjectStore as JObjectStore
from kube_scheduler_simulator_tpu.framework.engine import SchedulerEngine as JEngine
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu.utils.tracing import TRACER as JTRACER
from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
from kube_scheduler_simulator_tpu_torch.models import workloads as pworkloads
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

COUNTERS = ("node_table_reuse_total", "node_table_delta_patches_total",
            "node_table_delta_rows_total", "node_table_builds_total",
            "compile_requests_gathered_total")
PLUGINS = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
           "TaintToleration", "NodeUnschedulable"]
N_NODES = 48
WAVE_PODS = 24


@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def counters(tracer) -> dict:
    totals = tracer.counter_totals()
    return {k: totals.get(k, 0) for k in COUNTERS}


def pods_state(store) -> dict:
    out = {}
    for p in store.list("pods")[0]:
        m = p["metadata"]
        out[m["name"]] = ((p.get("spec") or {}).get("nodeName"),
                          (p.get("status") or {}).get("conditions"),
                          dict(m.get("annotations") or {}))
    return out


def wave_pods(k: int) -> list:
    pods = pworkloads.make_pods(WAVE_PODS, seed=10 + k)
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"w{k}-{i:03d}"
    return pods


def churn_run(store_cls, engine_cls, cfg, tracer, columnar: bool, spec: str, **kw) -> list:
    """-> per wave (bound, counters moved, pods' state)."""
    with env(KSS_TPU_COLUMNAR="1" if columnar else "0"):
        store = store_cls()
    store.load_columnar("nodes", pworkloads.make_nodes_columnar(
        N_NODES, seed=5, taint_fraction=0.2, unschedulable_fraction=0.05))
    store.load_columnar("pods", pworkloads.make_pods_columnar(WAVE_PODS, seed=6,
                                                              with_affinity=True))
    engine = engine_cls(store, plugin_config=cfg, **kw)
    out = []

    def wave():
        before = counters(tracer)
        with env(KSS_TPU_SPECULATIVE=spec):
            bound = engine.schedule_pending()
        after = counters(tracer)
        out.append((bound, {k: after[k] - before[k] for k in COUNTERS}, pods_state(store)))

    wave()
    for p in wave_pods(1):  # nothing changes in the nodes: reuse
        store.create("pods", copy.deepcopy(p))
    wave()
    for i in range(0, N_NODES, 6):  # eight node updates: delta patch
        nd = store.get("nodes", f"node-{i:05d}")
        nd["status"]["allocatable"]["cpu"] = "96000m"
        store.update("nodes", nd)
    for p in wave_pods(2):
        store.create("pods", copy.deepcopy(p))
    wave()
    store.create("nodes", {"metadata": {"name": "node-added", "labels": {
        "disktype": "ssd", "topology.kubernetes.io/zone": "zone-0"}},
        "status": {"allocatable": {"cpu": "64000m", "memory": str(256 << 30),
                                   "pods": "110"}}})  # one node added: rebuild
    for p in wave_pods(3):
        store.create("pods", copy.deepcopy(p))
    wave()
    engine.close()
    return out


@pytest.mark.parametrize("spec", ["1", "0"], ids=["wave", "scan"])
@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
def test_engine_waves_with_churn_equal_jax(columnar, spec):
    port = churn_run(ObjectStore, SchedulerEngine, PluginSetConfig(enabled=PLUGINS), TRACER,
                     columnar, spec, device="cpu")
    jax = churn_run(JObjectStore, JEngine, JCfg(enabled=PLUGINS), JTRACER, columnar, spec)
    paths = []
    for k, ((bound, moved, state), (jbound, jmoved, jstate)) in enumerate(zip(port, jax)):
        assert bound == jbound, k
        assert moved == jmoved, f"wave {k}: {moved} != {jmoved}"
        assert state.keys() == jstate.keys(), k
        for name in jstate:
            assert state[name] == jstate[name], f"wave {k} pod {name}"
        paths.append({c for c in COUNTERS[:4] if moved[c]})
    assert paths == [{"node_table_builds_total"}, {"node_table_reuse_total"},
                     {"node_table_delta_patches_total", "node_table_delta_rows_total"},
                     {"node_table_builds_total"}]
    assert port[2][1]["node_table_delta_rows_total"] == 8
    # the columnar plane gathers the queue's request rows from the pod bank
    assert (port[0][1]["compile_requests_gathered_total"] > 0) == columnar


def node(name, cpu="1", mem="1Gi"):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "spec": {},
            "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110"}}}


def pod(name, cpu="100m", priority=0, node_name=None):
    p = {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": name, "namespace": "default", "labels": {}},
         "spec": {"priority": priority,
                  "containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}]},
         "status": {}}
    if node_name:
        p["spec"]["nodeName"] = node_name
        p["status"]["phase"] = "Running"
    return p


def preemption_objects() -> dict:
    """Four nodes each full of low-priority pods, and two high-priority
    pods that fit nowhere: the dry runs try several victim sets a node,
    each a fit hypothesis over the same nodes."""
    nodes = [node(f"n{i}", cpu="2") for i in range(4)]
    pods = [pod(f"v{i}-{j}", "600m", j, f"n{i}") for i in range(4) for j in range(3)]
    pods += [pod("pri-a", "1", 10), pod("pri-b", "1", 10)]
    return {"nodes": nodes, "pods": pods}


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
def test_preemption_reuses_the_table_across_hypotheses(columnar):
    def run(store_cls, engine_cls, cfg, tracer, **kw):
        with env(KSS_TPU_COLUMNAR="1" if columnar else "0"):
            store = store_cls()
        for resource, items in preemption_objects().items():
            for obj in items:
                store.create(resource, copy.deepcopy(obj))
        engine = engine_cls(store, plugin_config=cfg, **kw)
        before = counters(tracer)
        bound = [engine.schedule_pending() for _ in range(3)]
        after = counters(tracer)
        engine.close()
        return bound, {k: after[k] - before[k] for k in COUNTERS}, pods_state(store)

    bound, moved, state = run(ObjectStore, SchedulerEngine, PluginSetConfig(), TRACER,
                              device="cpu")
    jbound, jmoved, jstate = run(JObjectStore, JEngine, JCfg(), JTRACER)
    assert bound == jbound
    assert moved == jmoved
    assert state == jstate
    # the dry runs compiled over the previous hypothesis's table
    assert moved["node_table_reuse_total"] > 0
