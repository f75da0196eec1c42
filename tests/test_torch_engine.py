"""The port's scheduling engine (framework/engine.py `SchedulerEngine`)
against the JAX package's, on the CPU (device="cpu"): the same manifests
go into an ObjectStore of each package, each engine runs
`schedule_pending()`, and every pod of the two stores must agree exactly
(tolerance 0: strings and integers) — `spec.nodeName`, the nominated
node, the status conditions and all 13 result annotations, the
result-history included.

Covered here: the seven cases of tests/test_golden_annotations.py (the
golden strings included), BASELINE configs 1-5 at scale 0.01 and a
decorated default-profile fleet under both waves (KSS_TPU_SPECULATIVE=1,
the default speculative wave; =0, the sequential scan), both commit modes
and the three residency rungs; the result history across two waves; and
DefaultPreemption (victims, nominated node, PDB tie-breaks, the
post-filter annotation).
"""

import contextlib
import copy
import json
import os
import queue as queue_mod
from types import SimpleNamespace

import pytest

import chip_smoke
import test_golden_annotations as golden
from kube_scheduler_simulator_tpu.cluster.store import ObjectStore as JObjectStore
from kube_scheduler_simulator_tpu.framework.engine import SchedulerEngine as JEngine
from kube_scheduler_simulator_tpu.models import workloads as jworkloads
from kube_scheduler_simulator_tpu.plugins.coscheduling import (
    Coscheduling as JCoscheduling, ensure_podgroup_resource as jensure)
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu_torch.cluster.store import NotFound, ObjectStore
from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
from kube_scheduler_simulator_tpu_torch.models import workloads as pworkloads
from kube_scheduler_simulator_tpu_torch.plugins.coscheduling import (
    Coscheduling, ensure_podgroup_resource)
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.store import annotations as ann

JAX = SimpleNamespace(Store=JObjectStore, Engine=JEngine, Cfg=JCfg, wl=jworkloads,
                      Cosched=JCoscheduling, ensure=jensure, kw={})
PORT = SimpleNamespace(Store=ObjectStore, Engine=SchedulerEngine, Cfg=PluginSetConfig,
                       wl=pworkloads, Cosched=Coscheduling, ensure=ensure_podgroup_resource,
                       kw={"device": "cpu"})

KNOBS = ("KSS_TPU_SPECULATIVE", "KSS_TPU_HOST_RESIDENT", "KSS_TPU_EAGER_DECODE",
         "KSS_TPU_DEVICE_RESULT_BUDGET_MB", "KSS_TPU_DISABLE_NATIVE")
RUNGS = {"device": {}, "host": {"KSS_TPU_HOST_RESIDENT": "1"},
         "eager": {"KSS_TPU_EAGER_DECODE": "1"}}


@contextlib.contextmanager
def knobs(**values):
    """The engine's env knobs as given, every other one unset."""
    want = {k: None for k in KNOBS}
    want.update(values)
    old = {k: os.environ.get(k) for k in want}
    for k, v in want.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def snapshot(store) -> dict:
    """Every pod of the store: (nodeName, nominatedNodeName, phase,
    conditions, annotations)."""
    out = {}
    for p in store.list("pods")[0]:
        m, st = p["metadata"], p.get("status") or {}
        out[(m.get("namespace") or "default", m["name"])] = (
            (p.get("spec") or {}).get("nodeName"), st.get("nominatedNodeName"),
            st.get("phase"), st.get("conditions"), dict(m.get("annotations") or {}))
    return out


def fill(pkg, objects: dict):
    """A store of `pkg` holding deep copies of {resource: [manifests]}."""
    store = pkg.Store()
    if "podgroups" in objects:
        pkg.ensure(store)
    for resource, items in objects.items():
        for obj in items:
            store.create(resource, copy.deepcopy(obj))
    return store


def run(pkg, objects: dict, cfg_kw: dict, **engine_kw):
    """-> (#bound, snapshot, engine) of one schedule_pending() on a fresh
    store.  cfg_kw builds the package's PluginSetConfig; "Coscheduling"
    in its enabled list gets the package's plugin."""
    cfg_kw = dict(cfg_kw)
    if "Coscheduling" in cfg_kw.get("enabled", ()):
        cfg_kw["custom"] = {"Coscheduling": pkg.Cosched()}
    store = fill(pkg, objects)
    engine = pkg.Engine(store, plugin_config=pkg.Cfg(**cfg_kw), **engine_kw, **pkg.kw)
    bound = engine.schedule_pending()
    snap = snapshot(store)
    engine.close()
    return bound, snap, engine


def assert_same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for key in want:
        g, w = got[key], want[key]
        assert g[:4] == w[:4], f"{key}: {g[:4]} != {w[:4]}"
        assert g[4].keys() == w[4].keys(), key
        for a in w[4]:
            assert g[4][a] == w[4][a], f"{key} {a}\n  port: {g[4][a][:300]}\n  jax:  {w[4][a][:300]}"


# ------------------------------------------------ tests/test_golden_annotations.py

def _two_nodes(a_cpu="2", a_mem="4Gi", b_cpu="4", b_mem="8Gi"):
    return [{"metadata": {"name": "node-a"},
             "status": {"allocatable": {"cpu": a_cpu, "memory": a_mem, "pods": "10"}}},
            {"metadata": {"name": "node-b"},
             "status": {"allocatable": {"cpu": b_cpu, "memory": b_mem, "pods": "10"}}}]


def _pod(name, cpu, mem, **spec):
    return {"metadata": {"name": name}, "spec": {"containers": [
        {"name": "c", "resources": {"requests": {"cpu": cpu, "memory": mem}}}], **spec}}


def _golden_case(objects, enabled):
    bound, snap, _ = run(PORT, objects, {"enabled": enabled})
    _, ref, _ = run(JAX, objects, {"enabled": enabled})
    assert_same(snap, ref)
    return bound, {k[1]: v[4] for k, v in snap.items()}


def test_golden_annotation_strings():
    bound, anns = _golden_case({"nodes": _two_nodes(), "pods": [_pod("p1", "1", "2Gi")]},
                               ["NodeResourcesFit", "NodeResourcesBalancedAllocation"])
    assert bound == 1
    golden._assert_golden(anns["p1"], golden.GOLDEN)
    hist = json.loads(anns["p1"][ann.RESULT_HISTORY])
    assert len(hist) == 1
    golden._assert_golden(hist[0], golden.GOLDEN)


def test_golden_unschedulable_filter_message():
    bound, anns = _golden_case({"nodes": _two_nodes()[:1], "pods": [_pod("big", "16", "2Gi")]},
                               ["NodeResourcesFit"])
    assert bound == 0
    fr = json.loads(anns["big"][ann.FILTER_RESULT])
    assert fr["node-a"]["NodeResourcesFit"] == "Insufficient cpu"
    assert anns["big"][ann.SELECTED_NODE] == ""


def test_golden_integer_division_rounding():
    _, anns = _golden_case({"nodes": _two_nodes("4", "8Gi", "2", "4Gi"),
                            "pods": [_pod("p1", "1", "1Gi")]},
                           ["NodeResourcesFit", "NodeResourcesBalancedAllocation"])
    golden._assert_golden(anns["p1"], golden.GOLDEN_ROUNDING)


def test_golden_taint_reverse_normalize_weight():
    alloc = {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": "10"}}
    nodes = [
        {"metadata": {"name": "node-a"}, "status": alloc,
         "spec": {"taints": [{"key": "dedicated", "value": "gpu",
                              "effect": "PreferNoSchedule"}]}},
        {"metadata": {"name": "node-b"}, "status": alloc},
        {"metadata": {"name": "node-c"}, "status": alloc,
         "spec": {"taints": [{"key": "dedicated", "value": "gpu", "effect": "NoSchedule"}]}},
    ]
    _, anns = _golden_case({"nodes": nodes, "pods": [
        {"metadata": {"name": "p1"}, "spec": {"containers": [{"name": "c"}]}}]},
        ["TaintToleration"])
    golden._assert_golden(anns["p1"], golden.GOLDEN_TAINTS)


def test_golden_node_affinity_preferred_weights():
    affinity = {"nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{"matchExpressions": [
                {"key": "disk", "operator": "In", "values": ["ssd", "hdd"]}]}]},
        "preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 5, "preference": {"matchExpressions": [
                {"key": "disk", "operator": "In", "values": ["ssd"]}]}},
            {"weight": 3, "preference": {"matchExpressions": [
                {"key": "disk", "operator": "In", "values": ["hdd"]}]}}]}}
    alloc = {"allocatable": {"cpu": "4", "memory": "8Gi", "pods": "10"}}
    nodes = [{"metadata": {"name": "node-a", "labels": {"disk": "ssd"}}, "status": alloc},
             {"metadata": {"name": "node-b", "labels": {"disk": "hdd"}}, "status": alloc}]
    _, anns = _golden_case({"nodes": nodes, "pods": [
        {"metadata": {"name": "p1"},
         "spec": {"containers": [{"name": "c"}], "affinity": affinity}}]},
        ["NodeAffinity"])
    golden._assert_golden(anns["p1"], golden.GOLDEN_AFFINITY)


def _bind_order_run(pkg, objects, cfg_kw, **engine_kw):
    """run() that also records the bind order a watch subscriber sees and
    the parked gang members."""
    cfg_kw = dict(cfg_kw)
    if "Coscheduling" in cfg_kw.get("enabled", ()):
        cfg_kw["custom"] = {"Coscheduling": pkg.Cosched()}
    store = fill(pkg, objects)
    q = store.watch("pods")
    engine = pkg.Engine(store, plugin_config=pkg.Cfg(**cfg_kw), **engine_kw, **pkg.kw)
    bound = engine.schedule_pending()
    order, seen = [], set()
    while True:
        try:
            _rv, event_type, obj = q.get_nowait()
        except queue_mod.Empty:
            break
        name = obj["metadata"]["name"]
        if event_type == "MODIFIED" and (obj.get("spec") or {}).get("nodeName") \
                and name not in seen:
            seen.add(name)
            order.append(name)
    store.unwatch("pods", q)
    parked = sorted(engine.gang_parked)
    engine.close()
    return bound, order, snapshot(store), parked


def test_pipelined_commit_parity_with_sequential_postpass():
    nodes = pworkloads.make_nodes(20, seed=7, taint_fraction=0.2)
    pods = pworkloads.make_pods(110, seed=8, with_affinity=True, with_tolerations=True,
                                with_spread=True)
    for i, p in enumerate(pods):
        p["spec"]["priority"] = (i % 3) * 100
    cfg_kw = {"enabled": ["NodeResourcesFit", "NodeResourcesBalancedAllocation",
                          "NodeAffinity", "TaintToleration", "PodTopologySpread"]}
    objects = {"nodes": nodes, "pods": pods}
    ref = _bind_order_run(JAX, objects, cfg_kw, chunk=16)
    for pipeline in (True, False):
        got = _bind_order_run(PORT, objects, cfg_kw, chunk=16, pipeline_commit=pipeline)
        assert got[:2] == ref[:2]
        assert_same(got[2], ref[2])


def test_gang_pipelined_commit_parity_with_sequential_postpass():
    nodes = pworkloads.make_nodes(14, seed=21, taint_fraction=0.2)
    pgs, gpods = pworkloads.make_gang_workload(3, 5, seed=22)
    for p in gpods:
        if (p["metadata"]["labels"]["scheduling.x-k8s.io/pod-group"] == "gang-0001"
                and p["metadata"]["name"].endswith(("003", "004"))):
            p["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "9999999m"
    plain = pworkloads.make_pods(40, seed=23, with_affinity=True, with_tolerations=True)
    for i, p in enumerate(plain):
        p["spec"]["priority"] = (i % 3) * 100
    cfg_kw = {"enabled": ["NodeResourcesFit", "NodeResourcesBalancedAllocation",
                          "NodeAffinity", "TaintToleration", "Coscheduling"]}
    objects = {"nodes": nodes, "podgroups": pgs, "pods": gpods + plain}
    ref = _bind_order_run(JAX, objects, cfg_kw, chunk=8)
    assert len(ref[3]) == 3
    for pipeline in (True, False):
        got = _bind_order_run(PORT, objects, cfg_kw, chunk=8, pipeline_commit=pipeline)
        assert got[0] == ref[0] and got[1] == ref[1] and got[3] == ref[3]
        assert_same(got[2], ref[2])


# ------------------------------------------------ configs 1-5, the default profile

def _baseline(idx):
    nodes, pods, cfg = pworkloads.baseline_config(idx, scale=0.01, seed=0)
    return {"nodes": nodes, "pods": pods}, {"enabled": list(cfg.enabled)}


def _default_profile():
    nodes, pods, _ = pworkloads.baseline_config(5, scale=0.006, seed=3)
    volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=3)
    for bp, node in bound:
        bp["spec"]["nodeName"] = node
    objects = {"nodes": nodes, "storageclasses": volumes.get("storageclasses", []),
               "persistentvolumes": volumes.get("pvs", []),
               "persistentvolumeclaims": volumes.get("pvcs", []),
               "pods": [bp for bp, _ in bound] + pods}
    return objects, {}


WORKLOADS = {**{f"config{i}": (lambda i=i: _baseline(i)) for i in range(1, 6)},
             "default_profile": _default_profile}


@pytest.mark.parametrize("spec", ["1", "0"], ids=["wave", "scan"])
@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_engine_matches_jax(wl, spec):
    """Port == JAX engine for every pod, under both commit modes and the
    three residency rungs of the port."""
    objects, cfg_kw = WORKLOADS[wl]()
    with knobs(KSS_TPU_SPECULATIVE=spec):
        bound_ref, ref, _ = run(JAX, objects, cfg_kw, chunk=16)
    assert bound_ref > 0
    for pipeline in (True, False):
        for rung in RUNGS:
            with knobs(KSS_TPU_SPECULATIVE=spec, **RUNGS[rung]):
                bound, snap, engine = run(PORT, objects, cfg_kw, chunk=16,
                                          pipeline_commit=pipeline)
            assert bound == bound_ref, (pipeline, rung)
            assert_same(snap, ref)


def test_engine_needs_a_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SchedulerEngine(ObjectStore())


def test_engine_refuses_a_mesh():
    """A one-card mesh is ported (B12, tests/test_torch_mesh.py); a mesh
    over two cards is ROADMAP Queue B item B12b and raises, as does an
    object that is not a mesh."""
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(NotImplementedError, match="B12b"):
        SchedulerEngine(ObjectStore(), mesh=make_mesh(4, device=["cuda:0", "cuda:1"]),
                        device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        SchedulerEngine(ObjectStore(), mesh=object(), device="cpu")


@pytest.mark.parametrize("spec", ["1", "0"], ids=["wave", "scan"])
def test_engine_binds_with_a_cpu_mesh(spec):
    """SchedulerEngine(..., mesh=make_mesh(4, device="cpu")) binds every
    pod as the engine without a mesh, annotations and all."""
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh

    nodes = pworkloads.make_nodes(8, seed=71)
    pods = pworkloads.make_pods(12, seed=72)
    cfg = {"enabled": ["NodeResourcesFit", "NodeResourcesBalancedAllocation",
                       "NodeAffinity", "TaintToleration"]}
    with knobs(KSS_TPU_SPECULATIVE=spec):
        b0, s0, _ = run(PORT, {"nodes": nodes, "pods": pods}, cfg)
        b1, s1, _ = run(PORT, {"nodes": nodes, "pods": pods}, cfg,
                        mesh=make_mesh(4, device="cpu"))
    assert b1 == b0 > 0
    assert_same(s1, s0)


# ------------------------------------------------ tests/test_speculative_engine.py:242

@pytest.mark.parametrize("spec", ["1", "0"], ids=["wave", "scan"])
def test_result_history_across_waves_identical(spec):
    nodes = pworkloads.make_nodes(6, seed=61)
    base_pods = pworkloads.make_pods(10, seed=62)

    def history(pkg):
        store = fill(pkg, {"nodes": nodes})
        engine = pkg.Engine(store, plugin_config=pkg.Cfg(
            enabled=["NodeResourcesFit", "NodeResourcesBalancedAllocation"]),
            chunk=4, **pkg.kw)
        for p in base_pods:
            store.create("pods", copy.deepcopy(p))
        engine.schedule_pending()
        for p in store.list("pods", copy_objects=False)[0][:]:
            store.delete("pods", p["metadata"]["name"], "default")
        for p in base_pods:
            store.create("pods", copy.deepcopy(p))
        engine.schedule_pending()
        engine.close()
        return {p["metadata"]["name"]: (p["metadata"].get("annotations") or {}).get(
            ann.RESULT_HISTORY) for p in store.list("pods")[0]}

    with knobs(KSS_TPU_SPECULATIVE=spec):
        got, ref = history(PORT), history(JAX)
    assert got == ref
    assert all(h and len(json.loads(h)) >= 1 for h in got.values())


# ------------------------------------------------ tests/test_preemption.py

def node(name, cpu="1", mem="1Gi"):
    return {"apiVersion": "v1", "kind": "Node",
            "metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
            "spec": {},
            "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110"},
                       "capacity": {"cpu": cpu, "memory": mem, "pods": "110"}}}


def pod(name, cpu="100m", priority=0, node_name=None, labels=None, created=None):
    p = {"apiVersion": "v1", "kind": "Pod",
         "metadata": {"name": name, "namespace": "default", "labels": labels or {}},
         "spec": {"priority": priority,
                  "containers": [{"name": "c", "resources": {"requests": {"cpu": cpu}}}]},
         "status": {}}
    if node_name:
        p["spec"]["nodeName"] = node_name
        p["status"]["phase"] = "Running"
    if created:
        p["metadata"]["creationTimestamp"] = created
    return p


def pdb(name, match_labels, disruptions_allowed):
    return {"metadata": {"name": name, "namespace": "default"},
            "spec": {"selector": {"matchLabels": match_labels}},
            "status": {"disruptionsAllowed": disruptions_allowed}}


PREEMPTION = {
    "lower_priority_victim": {
        "nodes": [node("n1")],
        "pods": [pod("victim", "800m", 0, "n1"), pod("pri", "500m", 10)]},
    "reprieve_keeps_higher_priority": {
        "nodes": [node("n1", cpu="2")],
        "pods": [pod("low", "800m", 0, "n1"), pod("mid", "800m", 5, "n1"),
                 pod("pri", "1", 10)]},
    "lowest_victim_priority_node": {
        "nodes": [node("n1"), node("n2")],
        "pods": [pod("v1", "900m", 5, "n1"), pod("v2", "900m", 1, "n2"),
                 pod("pri", "500m", 10)]},
    "pdb_violation_breaks_tie": {
        "nodes": [node("n1"), node("n2")],
        "pods": [pod("a", "900m", 0, "n1", labels={"app": "guarded"}),
                 pod("b", "900m", 0, "n2", labels={"app": "free"}),
                 pod("pri", "500m", 10)],
        "poddisruptionbudgets": [pdb("guard", {"app": "guarded"}, 0)]},
    "unschedulable_without_victims": {
        "nodes": [node("n1")],
        "pods": [pod("peer", "800m", 10, "n1"), pod("pri", "500m", 10)]},
}


@pytest.mark.parametrize("case", list(PREEMPTION))
def test_default_preemption_matches_jax(case):
    """The default profile's PostFilter (DefaultPreemption) on the port:
    the same victims deleted, the same nominated node, the same
    post-filter annotation and retry-wave binds as the JAX engine."""
    objects = PREEMPTION[case]
    bound, snap, _ = run(PORT, objects, {})
    bound_ref, ref, _ = run(JAX, objects, {})
    assert bound == bound_ref
    assert_same(snap, ref)
    hist = json.loads(snap[("default", "pri")][4][ann.RESULT_HISTORY])
    pf = json.loads(hist[0][ann.POST_FILTER_RESULT])
    if case == "unschedulable_without_victims":
        assert bound == 0 and snap[("default", "pri")][0] is None
        return
    assert bound == 1
    victims = {"lower_priority_victim": "victim", "reprieve_keeps_higher_priority": "low",
               "lowest_victim_priority_node": "v2", "pdb_violation_breaks_tie": "b"}[case]
    assert ("default", victims) not in snap
    node_name = snap[("default", "pri")][0]
    assert pf[node_name] == {"DefaultPreemption": "preemption victim"}


def test_preemption_store_delete_semantics():
    """A preempted victim is gone from the port's store (NotFound)."""
    store = fill(PORT, PREEMPTION["lower_priority_victim"])
    engine = SchedulerEngine(store, device="cpu")
    assert engine.schedule_pending() == 1
    with pytest.raises(NotFound):
        store.get("pods", "victim")
    assert store.get("pods", "pri")["spec"]["nodeName"] == "n1"
    engine.close()
