"""compile_workload(reuse=, pod_columns=) on the port against the JAX
package's, on the CPU (device="cpu").

Each case runs one sequence of waves on a store of each package, through
the columnar plane (KSS_TPU_COLUMNAR=1) and the dict baseline (=0): a
first build, then the node set as it was (reuse), a delta of 1 and of
256 rows (patch), 257 rows (rebuild past KSS_TPU_COLUMNAR_DELTA_MAX),
a membership change, and a schema change; then a pod gather holding
opaque, deleted and unknown-uid pods.  Every wave compiles with the
previous wave's NodeTableReuse, as the engine does, and its NodeTable
arrays, its compiled tensors (exact, leaf for leaf) and the five
counters it moved must equal the JAX package's.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.cluster import store as jstore
from kube_scheduler_simulator_tpu.models import workloads as jworkloads
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu.state import compile as jcompile
from kube_scheduler_simulator_tpu.utils import faults as jfaults
from kube_scheduler_simulator_tpu.utils.tracing import TRACER as JTRACER
from kube_scheduler_simulator_tpu_torch.cluster import store as pstore
from kube_scheduler_simulator_tpu_torch.models import workloads as pworkloads
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile as pcompile
from kube_scheduler_simulator_tpu_torch.utils import faults as pfaults
from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER
from test_torch_compile import assert_host_flags_equal, assert_trees_equal

COUNTERS = ("node_table_reuse_total", "node_table_delta_patches_total",
            "node_table_delta_rows_total", "node_table_builds_total",
            "compile_requests_gathered_total")
PLUGINS = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
           "TaintToleration", "NodeUnschedulable"]
N_NODES = 300
N_PODS = 24


class Pkg:
    def __init__(self, port: bool):
        self.port = port
        self.store = pstore if port else jstore
        self.wl = pworkloads if port else jworkloads
        self.cfg = (PluginSetConfig if port else JCfg)(enabled=PLUGINS)
        self.tracer = TRACER if port else JTRACER
        self.faults = pfaults if port else jfaults
        self.compile = pcompile if port else jcompile

    def run(self, nodes, pods, reuse, pod_columns):
        kw = {"device": "cpu"} if self.port else {}
        return self.compile.compile_workload(nodes, pods, self.cfg, reuse=reuse,
                                             pod_columns=pod_columns, **kw)


@contextlib.contextmanager
def columnar_env(columnar: bool):
    old = os.environ.get("KSS_TPU_COLUMNAR")
    os.environ["KSS_TPU_COLUMNAR"] = "1" if columnar else "0"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("KSS_TPU_COLUMNAR", None)
        else:
            os.environ["KSS_TPU_COLUMNAR"] = old


def counters(tracer) -> dict:
    totals = tracer.counter_totals()
    return {k: totals.get(k, 0) for k in COUNTERS}


def edit_nodes(store, names, cpu: str) -> None:
    for name in names:
        nd = store.get("nodes", name)
        nd["status"]["allocatable"]["cpu"] = cpu
        store.update("nodes", nd)


def gather_pods(pkg: Pkg, store) -> list:
    """Pods for the gather case: the listing, one whose last sync faulted
    (opaque), one deleted after it was read, one with a uid the bank does
    not know and one with none."""
    plan = pkg.faults.FaultPlan([pkg.faults.FaultRule("store.columnar_sync", nth=1)], seed=0)
    pod = store.get("pods", "pod-00002")
    pod["metadata"].setdefault("labels", {})["edited"] = "yes"
    with pkg.faults.armed(plan):
        store.update("pods", pod)
    gone = store.get("pods", "pod-00005")
    store.delete("pods", "pod-00005")
    unknown = store.get("pods", "pod-00007")
    unknown["metadata"]["uid"] = "no-such-uid"
    unknown["metadata"]["name"] = "pod-unknown"
    no_uid = store.get("pods", "pod-00008")
    del no_uid["metadata"]["uid"]
    no_uid["metadata"]["name"] = "pod-no-uid"
    listing = pkg.store.list_shared(store, "pods")
    return list(listing) + [gone, unknown, no_uid], getattr(listing, "columns", None)


def waves(pkg: Pkg, columnar: bool, fresh: bool = False) -> list:
    """-> per wave (label, compiled workload, counters moved, and with
    `fresh` the workloads that compiles without `reuse=` give at the
    same moment: from the same listing, and from dict copies of its
    manifests)."""
    with columnar_env(columnar):
        store = pkg.store.ObjectStore()
    store.load_columnar("nodes", pkg.wl.make_nodes_columnar(
        N_NODES, seed=3, taint_fraction=0.2, unschedulable_fraction=0.1))
    store.load_columnar("pods", pkg.wl.make_pods_columnar(N_PODS, seed=4, with_affinity=True))
    names = [f"node-{i:05d}" for i in range(N_NODES)]
    out = []
    reuse = None

    def wave(label, pods=None, pod_columns=None):
        nonlocal reuse
        nodes = pkg.store.list_shared(store, "nodes")
        if pods is None:
            listing = pkg.store.list_shared(store, "pods")
            pods, pod_columns = list(listing), getattr(listing, "columns", None)
        before = counters(pkg.tracer)
        cw = pkg.run(nodes, pods, reuse, pod_columns)
        after = counters(pkg.tracer)
        reuse = pkg.compile.NodeTableReuse(cw)
        again = ((pkg.run(nodes, pods, None, None),
                  pkg.run([dict(n) for n in nodes], pods, None, None))  # dict() fills a lazy row
                 if fresh else ())
        out.append((label, cw, {k: after[k] - before[k] for k in COUNTERS}, again))

    wave("build")
    wave("identical")
    edit_nodes(store, names[3:4], "7000m")
    wave("delta 1")
    edit_nodes(store, names[10:266], "9000m")
    wave("delta 256")
    edit_nodes(store, names[20:277], "11000m")
    wave("257 rows")
    store.delete("nodes", names[-1])
    wave("membership")
    store.create("pods", {"metadata": {"name": "gpu-pod", "namespace": "default"},
                          "spec": {"containers": [{"name": "c", "resources": {"requests": {
                              "cpu": "100m", "example.com/gpu": "1"}}}]}})
    wave("schema")
    wave("gather", *gather_pods(pkg, store))
    return out


def table_arrays(cw) -> dict:
    t = cw.node_table
    return {"names": list(t.names), "allocatable": t.allocatable,
            "allowed_pods": t.allowed_pods, "unschedulable": t.unschedulable,
            "initial_requested": t.initial_requested, "labels": list(t.labels),
            "taints": [list(x) for x in t.taints], "columns": tuple(cw.schema.columns)}


EXPECTED = {  # the counters each wave moves, on the columnar plane and off it
    "build": {"node_table_builds_total": 1},
    "identical": {"node_table_reuse_total": 1},
    "delta 1": {"node_table_delta_patches_total": 1, "node_table_delta_rows_total": 1},
    "delta 256": {"node_table_delta_patches_total": 1, "node_table_delta_rows_total": 256},
    "257 rows": {"node_table_builds_total": 1},
    "membership": {"node_table_builds_total": 1},
    "schema": {"node_table_builds_total": 1},
    "gather": {"node_table_reuse_total": 1},
}


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
def test_reuse_waves_equal_jax(columnar):
    port = waves(Pkg(True), columnar)
    jax = waves(Pkg(False), columnar)
    assert [w[0] for w in port] == [w[0] for w in jax]
    for (label, cw, moved, _), (_, jcw, jmoved, _) in zip(port, jax):
        assert moved == jmoved, f"{label}: counters {moved} != {jmoved}"
        gathered = moved.pop("compile_requests_gathered_total")
        assert {k: v for k, v in moved.items() if v} == EXPECTED[label], label
        # the columnar plane gathers every listed pod's requests from the
        # bank; the extra gather-case pods (opaque, deleted, unknown) are
        # parsed from their manifests
        if columnar:
            assert gathered == (cw.n_pods - 4 if label == "gather" else cw.n_pods), label
        else:
            assert gathered == 0, label
        a, b = table_arrays(cw), table_arrays(jcw)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (label, k)
            else:
                assert a[k] == b[k], (label, k)
        assert cw.pod_keys == jcw.pod_keys, label
        for part in ("statics", "xs", "init_carry"):
            assert_trees_equal(getattr(cw, part), getattr(jcw, part), f"{label} {part}")
        assert_host_flags_equal(cw, jcw)


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
def test_reused_table_equals_a_fresh_build(columnar):
    """Each wave's reused, patched or rebuilt table equals the tables that
    compiles without `reuse=` build from the same listing and from plain
    dict copies of its manifests."""
    for label, cw, _, again in waves(Pkg(True), columnar, fresh=True):
        for fresh in again:
            a, b = table_arrays(cw), table_arrays(fresh)
            for k in a:
                if isinstance(a[k], np.ndarray):
                    assert np.array_equal(a[k], b[k]), (label, k)
                else:
                    assert a[k] == b[k], (label, k)
            for part in ("statics", "xs", "init_carry"):
                assert_trees_equal(getattr(cw, part), getattr(fresh, part), f"{label} {part}")


def test_delta_max_knob(monkeypatch):
    """KSS_TPU_COLUMNAR_DELTA_MAX bounds the patch: at 0 every changed
    wave rebuilds, at 1 a delta of 1 patches and one of 2 rebuilds."""
    pkg = Pkg(True)
    store = pstore.ObjectStore()
    store.load_columnar("nodes", pworkloads.make_nodes_columnar(16, seed=1))
    store.load_columnar("pods", pworkloads.make_pods_columnar(4, seed=2))
    pods = list(pstore.list_shared(store, "pods"))
    names = [f"node-{i:05d}" for i in range(16)]

    def compile_after(edit, reuse):
        edit_nodes(store, edit, "5000m")
        before = counters(TRACER)
        cw = pkg.run(pstore.list_shared(store, "nodes"), pods, reuse, None)
        after = counters(TRACER)
        return cw, {k: after[k] - before[k] for k in COUNTERS if after[k] != before[k]}

    cw, _ = compile_after([], None)
    monkeypatch.setenv("KSS_TPU_COLUMNAR_DELTA_MAX", "0")
    cw, moved = compile_after(names[:1], pcompile.NodeTableReuse(cw))
    assert moved == {"node_table_builds_total": 1}
    monkeypatch.setenv("KSS_TPU_COLUMNAR_DELTA_MAX", "1")
    cw, moved = compile_after(names[1:2], pcompile.NodeTableReuse(cw))
    assert moved == {"node_table_delta_patches_total": 1, "node_table_delta_rows_total": 1}
    cw, moved = compile_after(names[2:4], pcompile.NodeTableReuse(cw))
    assert moved == {"node_table_builds_total": 1}


def test_compile_spans_split_the_compile():
    """A compile records its split: schema, node table, pod requests,
    each plugin's build and the upload."""
    from kube_scheduler_simulator_tpu_torch.models import baseline_config

    nodes, pods, cfg = baseline_config(5, scale=0.01, seed=0)
    TRACER.reset()
    pcompile.compile_workload(nodes, pods, cfg, device="cpu")
    spans = set(TRACER.summary()["spans"])
    want = {"compile_schema", "compile_node_table", "compile_pod_requests",
            "compile_build_core", "compile_upload"}
    want |= {f"compile_build_{name}" for name in cfg.active_plugins()
             if name not in ("NodeResourcesFit", "NodeResourcesBalancedAllocation")}
    assert want <= spans, sorted(want - spans)
