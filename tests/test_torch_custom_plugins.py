"""Custom out-of-tree plugins in the port (plugins/custom.py, B13's rows),
mirroring tests/test_custom_plugins.py case by case.

Each case runs the same manifests through the JAX package and through
the port (device="cpu": the plain PyTorch versions of the kernels), with
each package's own CustomPlugin subclass, and holds the port to the JAX
replay or engine exactly (tolerance 0: annotation bytes, the selected
node), and to the scalar oracle reference_impl/sequential.py where the
JAX test uses it.  The port's cases keep the JAX test's own checks.
"""

import json

import pytest

import test_torch_engine as te
from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.models.workloads import make_nodes, make_pods
from kube_scheduler_simulator_tpu.plugins import custom as jcustom
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu.reference_impl.sequential import SequentialScheduler
from kube_scheduler_simulator_tpu.scheduler import debuggable as jdebuggable
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
from kube_scheduler_simulator_tpu_torch.framework.replay import replay
from kube_scheduler_simulator_tpu_torch.plugins import custom as pcustom
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.scheduler import debuggable as pdebuggable
from kube_scheduler_simulator_tpu_torch.state.compile import compile_workload
from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result
from kube_scheduler_simulator_tpu_torch.store import annotations as ann


def _idx(node) -> int:
    return int(node["metadata"]["name"].rsplit("-", 1)[1])


def plugins_for(base):
    """The JAX test's plugins, subclassing `base` (one package's
    CustomPlugin): {class name: class}."""

    class EvenNodesOnly(base):
        """Vetoes odd-indexed nodes; prefers high node indices."""

        name = "EvenNodesOnly"
        default_weight = 2

        def filter(self, pod, node):
            return None if _idx(node) % 2 == 0 else "odd nodes not allowed"

        def score(self, pod, node):
            return _idx(node)

    class HalfNormalize(base):
        """Scores the node index; NormalizeScore halves every score."""

        name = "HalfNormalize"
        default_weight = 3

        def score(self, pod, node):
            return _idx(node) * 10

        def normalize(self, scores):
            return [s // 2 for s in scores]

    class HugeScorer(base):
        """Scores beyond int32 (upstream node scores are int64)."""

        name = "HugeScorer"
        default_weight = 1

        def score(self, pod, node):
            return (1 << 33) + _idx(node)

    class NodeNumber(base):
        """examples/nodenumber_plugin.py, on `base`."""

        name = "NodeNumber"
        default_weight = 1

        def __init__(self, reverse: bool = False):
            self.reverse = reverse

        def score(self, pod, node):
            pod_suffix = (pod.get("metadata", {}).get("name") or "")[-1:]
            node_suffix = (node.get("metadata", {}).get("name") or "")[-1:]
            if not (pod_suffix.isdigit() and node_suffix.isdigit()):
                return 0
            match = pod_suffix == node_suffix
            return 10 if match != self.reverse else 0

    return {c.__name__: c for c in (EvenNodesOnly, HalfNormalize, HugeScorer, NodeNumber)}


JP = plugins_for(jcustom.CustomPlugin)
PP = plugins_for(pcustom.CustomPlugin)


def recorder_for(base):
    """examples/plugin_extender.py's RequestedCpuRecorder, on `base` (one
    package's PluginExtender)."""

    class RequestedCpuRecorder(base):
        KEY = "sample.simulator.example.com/requested-cpu"

        def after_cycle(self, pod, annotations, result_store):
            meta = pod.get("metadata") or {}
            total_m = 0
            for c in (pod.get("spec") or {}).get("containers", []):
                v = ((c.get("resources") or {}).get("requests") or {}).get("cpu", "0")
                total_m += int(float(v[:-1])) if v.endswith("m") else int(float(v) * 1000)
            result_store.add_custom_result(
                meta.get("namespace") or "default", meta.get("name", ""),
                self.KEY, f"{total_m}m")

    return RequestedCpuRecorder


def _cfgs(enabled_in_tree: list[str], plugin: str):
    """(port config, JAX config) with `plugin` of each package enabled."""
    return (PluginSetConfig(enabled=enabled_in_tree + [plugin], custom={plugin: PP[plugin]()}),
            JCfg(enabled=enabled_in_tree + [plugin], custom={plugin: JP[plugin]()}))


def _three_way(nodes, pods, cfg, jcfg, chunk):
    """The port's replay against the JAX replay and the oracle -> (port
    replay, oracle results)."""
    rr = replay(compile_workload(nodes, pods, cfg, device="cpu"), chunk=chunk, device="cpu")
    jrr = jax_replay(jax_compile(nodes, pods, jcfg), chunk=chunk)
    seq = SequentialScheduler(nodes, pods, jcfg).schedule_all()
    for i, (sa, ss) in enumerate(seq):
        da = decode_pod_result(rr, i)
        assert sorted(da) == sorted(ALL_PLUGIN_KEYS)
        assert int(rr.selected[i]) == int(jrr.selected[i]) == ss, f"pod {i}: selected"
        ja = jax_decode(jrr, i)
        for k in ALL_PLUGIN_KEYS:
            assert da[k] == ja[k], f"pod {i} {k}: port vs JAX"
            assert da[k] == sa[k], f"pod {i} {k}: port vs oracle"
    return rr, seq


def test_custom_plugin_parity():
    nodes = make_nodes(6, seed=20)
    pods = make_pods(8, seed=21)
    cfg, jcfg = _cfgs(["NodeResourcesFit"], "EvenNodesOnly")
    rr, seq = _three_way(nodes, pods, cfg, jcfg, chunk=8)
    # custom filter message appears in the annotation
    fr = json.loads(decode_pod_result(rr, 0)[ann.FILTER_RESULT])
    assert fr["node-00001"]["EvenNodesOnly"] == "odd nodes not allowed"
    # odd nodes never selected
    for s in rr.selected:
        assert s % 2 == 0


def test_custom_normalize_requires_host_path():
    """replay() cannot run a Python NormalizeScore and refuses with the
    JAX package's message."""
    nodes = make_nodes(3, seed=22)
    pods = make_pods(2, seed=23)
    cfg, jcfg = _cfgs(["NodeResourcesFit"], "HalfNormalize")
    with pytest.raises(ValueError, match="NormalizeScore") as got:
        replay(compile_workload(nodes, pods, cfg, device="cpu"), chunk=2, device="cpu")
    with pytest.raises(ValueError, match="NormalizeScore") as want:
        jax_replay(jax_compile(nodes, pods, jcfg), chunk=2)
    assert str(got.value) == str(want.value)
    # filter_only (preemption's fit checks) takes it
    rr = replay(compile_workload(nodes, pods, cfg, device="cpu"), chunk=2, device="cpu",
                filter_only=True)
    assert rr.scheduled == 2


def _store_run(pkg, nodes, pods, cfg, extenders=None):
    """One schedule_pending() of `pkg` (te.PORT / te.JAX) -> (#bound,
    snapshot, engine)."""
    store = te.fill(pkg, {"nodes": nodes, "pods": pods})
    engine = pkg.Engine(store, plugin_config=cfg, **pkg.kw)
    if extenders:
        engine.plugin_extenders = extenders
    bound = engine.schedule_pending()
    snap = te.snapshot(store)
    engine.close()
    return bound, snap, engine


def test_custom_normalize_scheduled_and_recorded():
    """The engine routes a custom NormalizeScore to the host path;
    finalscore-result = normalize(raw) x weight, equal to the JAX engine
    and the oracle."""
    nodes = make_nodes(4, seed=24)
    pods = make_pods(3, seed=25)
    cfg, jcfg = _cfgs(["NodeResourcesFit"], "HalfNormalize")
    assert SchedulerEngine(ObjectStore(), plugin_config=cfg, device="cpu")._needs_host_path()
    n_bound, snap, _ = _store_run(te.PORT, nodes, pods, cfg)
    jn_bound, jsnap, _ = _store_run(te.JAX, nodes, pods, jcfg)
    te.assert_same(snap, jsnap)
    assert n_bound == jn_bound

    seq = SequentialScheduler(nodes, pods, jcfg).schedule_all()
    assert n_bound == sum(1 for _, s in seq if s >= 0)
    for i, (sa, ss) in enumerate(seq):
        node, _, _, _, annos = snap[("default", pods[i]["metadata"]["name"])]
        for k in (ann.SCORE_RESULT, ann.FINAL_SCORE_RESULT, ann.FILTER_RESULT,
                  ann.SELECTED_NODE):
            assert annos.get(k) == sa[k], f"pod {i} {k}"
        assert (node or "") == (nodes[ss]["metadata"]["name"] if ss >= 0 else "")
    # the record really shows halved scores: raw = idx*10, final = idx*5*w
    annos = snap[("default", pods[0]["metadata"]["name"])][4]
    fs, sc = json.loads(annos[ann.FINAL_SCORE_RESULT]), json.loads(annos[ann.SCORE_RESULT])
    for node_name, entry in fs.items():
        idx = int(node_name.rsplit("-", 1)[1])
        assert sc[node_name]["HalfNormalize"] == str(idx * 10)
        assert entry["HalfNormalize"] == str((idx * 10 // 2) * 3)


def _command_run(mod, plugin_cls, ext_base, kw):
    """new_scheduler_command of one package with the plugin and a Marker
    extender -> (the pods seen by the extender, the pod's annotations)."""
    seen = []

    class Marker(ext_base):
        def after_cycle(self, pod, annotations, result_store):
            meta = pod["metadata"]
            seen.append(meta["name"])
            result_store.add_custom_result(
                meta.get("namespace") or "default", meta["name"],
                "my-debug-annotation", "cycle-observed",
            )

    di, _server = mod.new_scheduler_command(
        with_plugins=[plugin_cls()], with_plugin_extenders={"EvenNodesOnly": Marker()},
        start_scheduler=False, **kw)
    try:
        for n in make_nodes(4, seed=23):
            di.store.create("nodes", n)
        di.store.create("pods", make_pods(1, seed=24)[0])
        assert di.engine.schedule_pending() == 1
        return seen, di.store.get("pods", "pod-00000")["metadata"]["annotations"]
    finally:
        di.shutdown()


def test_new_scheduler_command_with_plugin_and_extender():
    """The default profile plus EvenNodesOnly: 13 filters, 9 scorers."""
    seen, annos = _command_run(pdebuggable, PP["EvenNodesOnly"], pdebuggable.PluginExtender,
                               {"device": "cpu"})
    jseen, jannos = _command_run(jdebuggable, JP["EvenNodesOnly"],
                                 jdebuggable.PluginExtender, {})
    assert seen == jseen == ["pod-00000"]
    assert annos == jannos
    assert annos["my-debug-annotation"] == "cycle-observed"
    assert "EvenNodesOnly" in annos[ann.FINAL_SCORE_RESULT]


def test_custom_plugins_survive_restart_and_reset():
    for mod, cls, kw in ((pdebuggable, PP["EvenNodesOnly"], {"device": "cpu"}),
                         (jdebuggable, JP["EvenNodesOnly"], {})):
        di, _server = mod.new_scheduler_command(with_plugins=[cls()], start_scheduler=False,
                                                **kw)
        svc = di.scheduler_service
        # a config apply (only profiles honored) must not drop the custom plugin
        svc.restart_scheduler(svc.get_config())
        assert "EvenNodesOnly" in di.engine.plugin_config.custom
        assert "EvenNodesOnly" in di.engine.plugin_config.enabled
        svc.reset_scheduler()
        assert "EvenNodesOnly" in di.engine.plugin_config.custom
        di.shutdown()


def test_extender_duration_and_nodes_response():
    from kube_scheduler_simulator_tpu.scheduler.extender import ExtenderClient as JClient
    from kube_scheduler_simulator_tpu.utils.duration import parse_duration_seconds as jparse
    from kube_scheduler_simulator_tpu_torch.scheduler.extender import ExtenderClient
    from kube_scheduler_simulator_tpu_torch.utils.duration import parse_duration_seconds

    c = ExtenderClient({"urlPrefix": "http://x", "httpTimeout": "100ms"})
    assert c.timeout == JClient({"urlPrefix": "http://x", "httpTimeout": "100ms"}).timeout
    assert abs(c.timeout - 0.1) < 1e-9
    for v in ("1m30s", 2, "250ms", "1h"):
        assert parse_duration_seconds(v) == jparse(v)
    assert parse_duration_seconds("1m30s") == 90.0


def test_custom_scores_beyond_int32_round_trip():
    """HugeScorer's 2^33 raws: a "host" column, exact in the annotations."""
    nodes = make_nodes(4, seed=30)
    pods = make_pods(3, seed=31)
    cfg, jcfg = _cfgs(["NodeResourcesFit"], "HugeScorer")
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    jcw = jax_compile(nodes, pods, jcfg)
    pos = cw.config.scorers().index("HugeScorer")
    assert cw.host["score_dtypes"][pos] == "host" == jcw.host["score_dtypes"][pos]
    assert cw.host["score_dtypes"] == jcw.host["score_dtypes"]
    assert (cw.host["static_score_rows"]["HugeScorer"] > (1 << 33) - 1).any()
    rr, seq = _three_way(nodes, pods, cfg, jcfg, chunk=4)
    # the huge raw survives exactly
    sr = json.loads(decode_pod_result(rr, 0)[ann.SCORE_RESULT])
    assert any(int(v["HugeScorer"]) > (1 << 33) - 1 for v in sr.values())


def _queue_order(pkg, cfg_of):
    store = pkg.Store()
    store.create("nodes", {"metadata": {"name": "n1"},
                           "status": {"allocatable": {"cpu": "8", "memory": "16Gi",
                                                      "pods": "100"}}})
    for name, prio in [("a", 0), ("b", 50), ("c", 0)]:
        store.create("pods", {"metadata": {"name": name},
                              "spec": {"priority": prio, "containers": [{"name": "c"}]}})
    eng = pkg.Engine(store, plugin_config=cfg_of(pkg), **pkg.kw)
    return [p["metadata"]["name"] for p in eng.pending_pods()]


def test_custom_queue_sort_replaces_priority_sort():
    """A custom less() orders the queue; without one, PrioritySort."""

    def name_sort(pkg):
        base = pcustom.CustomPlugin if pkg is te.PORT else jcustom.CustomPlugin

        class NameSort(base):
            name = "NameSort"

            def less(self, a, b):  # reverse-alphabetical by name
                return a["metadata"]["name"] > b["metadata"]["name"]

        return pkg.Cfg(enabled=["NodeResourcesFit", "NameSort"], custom={"NameSort": NameSort()})

    got, want = _queue_order(te.PORT, name_sort), _queue_order(te.JAX, name_sort)
    assert got == want == ["c", "b", "a"]
    plain = (lambda pkg: pkg.Cfg(enabled=["NodeResourcesFit"]))
    assert _queue_order(te.PORT, plain) == _queue_order(te.JAX, plain) == ["b", "a", "c"]


def test_two_queue_sort_plugins_rejected():
    """Upstream refuses more than one QueueSort plugin; both engines do,
    with the same message."""
    errors = []
    for pkg, base in ((te.PORT, pcustom.CustomPlugin), (te.JAX, jcustom.CustomPlugin)):
        class SortA(base):
            name = "SortA"

            def less(self, a, b):
                return False

        class SortB(SortA):
            name = "SortB"

        store = pkg.Store()
        store.create("pods", {"metadata": {"name": "p"},
                              "spec": {"containers": [{"name": "c"}]}})
        eng = pkg.Engine(store, plugin_config=pkg.Cfg(
            enabled=["NodeResourcesFit", "SortA", "SortB"],
            custom={"SortA": SortA(), "SortB": SortB()}), **pkg.kw)
        with pytest.raises(ValueError, match="one QueueSort") as e:
            eng.pending_pods()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def _example(stem: str):
    """A module of examples/ (they subclass the JAX package's classes)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "examples" / f"{stem}.py"
    spec = importlib.util.spec_from_file_location(f"_example_{stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_plugins_work_end_to_end():
    """NodeNumber and RequestedCpuRecorder as examples/ ships them,
    through the JAX engine, and the port's copies defined above through
    the port's engine: the same placement and annotations."""
    nodes = [{"metadata": {"name": f"node{j}"},
              "status": {"allocatable": {"cpu": "8", "memory": "16Gi", "pods": "10"}}}
             for j in (1, 2)]
    pod = {"metadata": {"name": "pod2"},
           "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "500m"}}}]}}
    shipped = (_example("nodenumber_plugin").NodeNumber,
               _example("plugin_extender").RequestedCpuRecorder)
    runs = []
    for pkg, (plugin, recorder) in (
            (te.PORT, (PP["NodeNumber"], recorder_for(pdebuggable.PluginExtender))),
            (te.JAX, shipped)):
        cfg = pkg.Cfg(enabled=["NodeResourcesFit", "NodeNumber"],
                      custom={"NodeNumber": plugin()})
        runs.append(_store_run(pkg, nodes, [pod], cfg,
                               extenders={"NodeResourcesFit": recorder()}))
    (bound, snap, _), (jbound, jsnap, _) = runs
    te.assert_same(snap, jsnap)
    assert bound == jbound == 1
    node, _, _, _, annos = snap[("default", "pod2")]
    assert node == "node2"  # NodeNumber: pod2 prefers node2
    assert annos["sample.simulator.example.com/requested-cpu"] == "500m"
    assert annos[ann.SELECTED_NODE] == "node2"
