"""Multiple scheduler profiles in the port (framework/engine.py
`set_profiles`, routed by spec.schedulerName), mirroring
tests/test_multi_profile.py case by case.

Each case runs the same configuration and manifests through the JAX
package's SchedulerService and engine and through the port's
(device="cpu"), and holds the port to the JAX package exactly: every
pod's node, nominated node, conditions and annotation bytes, the parsed
profiles, the errors, and the configuration kept after a rollback.  The
port's cases keep the JAX test's own checks.
"""

import copy

import pytest

import test_torch_engine as te
from kube_scheduler_simulator_tpu.scheduler import convert as jconvert
from kube_scheduler_simulator_tpu.scheduler.service import SchedulerService as JService
from kube_scheduler_simulator_tpu_torch.scheduler import convert as pconvert
from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService

BOTH = ((te.PORT, SchedulerService, pconvert), (te.JAX, JService, jconvert))


def _nodes():
    # node-big has more headroom; MostAllocated prefers node-small
    return [
        {"metadata": {"name": "node-big"},
         "status": {"allocatable": {"cpu": "16", "memory": "64Gi", "pods": "100"}}},
        {"metadata": {"name": "node-small"},
         "status": {"allocatable": {"cpu": "2", "memory": "8Gi", "pods": "100"}}},
    ]


def _pod(name, scheduler_name=None):
    spec = {"containers": [{"name": "c", "resources": {
        "requests": {"cpu": "1", "memory": "2Gi"}}}]}
    if scheduler_name:
        spec["schedulerName"] = scheduler_name
    return {"kind": "Pod", "metadata": {"name": name}, "spec": spec}


def _two_profile_config(convert):
    cfg = convert.default_scheduler_config()
    spread = copy.deepcopy(cfg["profiles"][0])
    binpack = copy.deepcopy(cfg["profiles"][0])
    spread["schedulerName"] = "default-scheduler"
    binpack["schedulerName"] = "bin-packing"
    binpack["pluginConfig"] = [{
        "name": "NodeResourcesFit",
        "args": {"scoringStrategy": {"type": "MostAllocated"}}}]
    cfg["profiles"] = [spread, binpack]
    return cfg


def _service_with(pkg, service_cls, cfg, nodes):
    store = pkg.Store()
    for n in nodes:
        store.create("nodes", copy.deepcopy(n))
    engine = pkg.Engine(store, **pkg.kw)
    svc = service_cls(engine, initial_config=copy.deepcopy(cfg))
    return svc, engine, store


def _both(run):
    """run(pkg, service_cls, convert) for the port, then the JAX package;
    the port's result."""
    got, want = (run(*b) for b in BOTH)
    assert got == want
    return got


def _schedule(make_cfg, nodes, pods, extra=None):
    """A run that creates `pods`, schedules, and returns (#bound, the
    store's snapshot)."""

    def run(pkg, service_cls, convert):
        svc, engine, store = _service_with(pkg, service_cls, make_cfg(convert), nodes)
        for p in pods:
            store.create("pods", copy.deepcopy(p))
        out = engine.schedule_pending()
        if extra is not None:
            out = (out, extra(svc, engine, store, convert))
        snap = te.snapshot(store)
        engine.close()
        return out, snap

    (got, snap), (want, jsnap) = (run(*b) for b in BOTH)
    te.assert_same(snap, jsnap)
    assert got == want
    return got, snap


def test_parse_profiles_reads_every_profile():
    def run(pkg, service_cls, convert):
        profs = convert.parse_profiles(_two_profile_config(convert))
        return [(name, ps.enabled, ps.weights, ps.args) for name, ps in profs.items()]

    profs = _both(run)
    assert [p[0] for p in profs] == ["default-scheduler", "bin-packing"]
    # the default profile carries the scheme-defaulted args (LeastAllocated)
    assert profs[0][3]["NodeResourcesFit"]["scoringStrategy"]["type"] == "LeastAllocated"
    assert profs[1][3]["NodeResourcesFit"]["scoringStrategy"]["type"] == "MostAllocated"


def test_same_pod_schedules_differently_per_profile():
    bound, snap = _schedule(_two_profile_config, _nodes(),
                            [_pod("p-default"), _pod("p-packed", "bin-packing")])
    assert bound == 2
    # LeastAllocated prefers the big node; MostAllocated the small one
    assert snap[("default", "p-default")][0] == "node-big"
    assert snap[("default", "p-packed")][0] == "node-small"


def test_unknown_scheduler_name_is_left_alone():
    bound, snap = _schedule(_two_profile_config, _nodes(),
                            [_pod("p-foreign", "someone-elses-scheduler")])
    assert bound == 0
    node, _, _, conds, _ = snap[("default", "p-foreign")]
    assert not node
    # untouched: no Unschedulable condition — no scheduler owns it
    assert not any(c.get("type") == "PodScheduled" for c in conds or [])


def test_unset_scheduler_name_falls_back_to_first_profile():
    def cfg(convert):
        c = _two_profile_config(convert)
        c["profiles"][0]["schedulerName"] = "primary"  # no default-scheduler
        return c

    bound, snap = _schedule(cfg, _nodes(), [_pod("p-unset")])
    assert bound == 1
    assert snap[("default", "p-unset")][0]


def test_global_priority_order_across_profiles():
    """A high-priority pod of profile B wins contended capacity over a
    low-priority pod of profile A (one shared activeQ upstream)."""
    nodes = [{"metadata": {"name": "only"},
              "status": {"allocatable": {"cpu": "1", "memory": "2Gi", "pods": "10"}}}]
    hi = _pod("p-high", "bin-packing")
    hi["spec"]["priority"] = 1000
    bound, snap = _schedule(_two_profile_config, nodes, [_pod("p-low"), hi])
    assert bound == 1
    assert snap[("default", "p-high")][0] == "only"
    assert not snap[("default", "p-low")][0]


def test_duplicate_profile_names_rejected_with_rollback():
    def run(pkg, service_cls, convert):
        cfg = _two_profile_config(convert)
        cfg["profiles"][1]["schedulerName"] = "default-scheduler"
        with pytest.raises(ValueError, match="duplicated profile") as e:
            convert.parse_profiles(cfg)
        svc, engine, store = _service_with(pkg, service_cls, convert.default_scheduler_config(),
                                           _nodes())
        with pytest.raises(ValueError) as e2:
            svc.restart_scheduler(cfg)
        # rollback kept the old config current and the engine consistent
        kept = svc.get_config()
        store.create("pods", _pod("p-after"))
        bound = engine.schedule_pending()
        snap = te.snapshot(store)
        engine.close()
        return str(e.value), str(e2.value), kept, bound, snap

    got, want = (run(*b) for b in BOTH)
    assert got[:4] == want[:4]
    te.assert_same(got[4], want[4])
    assert got[2]["profiles"][0]["schedulerName"] == "default-scheduler"
    assert got[3] == 1


def test_engine_less_service_still_validates():
    def run(pkg, service_cls, convert):
        svc = service_cls(engine=None)
        bad = _two_profile_config(convert)
        bad["profiles"][1]["schedulerName"] = "default-scheduler"
        with pytest.raises(ValueError) as e:
            svc.restart_scheduler(bad)
        return str(e.value), svc.get_config()

    msg, kept = _both(run)
    assert len(kept["profiles"]) == 1  # old config kept


def test_legacy_set_plugin_config_clears_routing():
    def extra(svc, engine, store, convert):
        assert engine.profiles is not None
        cfg_cls = type(engine.plugin_config)
        engine.set_plugin_config(cfg_cls(enabled=["NodeResourcesFit"]))
        assert engine.profiles is None  # legacy API takes over completely
        store.create("pods", _pod("p-any", "whatever-name"))
        return engine.schedule_pending()

    (bound0, bound), snap = _schedule(_two_profile_config, _nodes(), [], extra=extra)
    assert bound0 == 0
    assert bound == 1  # no routing: every pod scheduled


def test_config_apply_updates_profiles():
    def extra(svc, engine, store, convert):
        svc.restart_scheduler(_two_profile_config(convert))
        return engine.schedule_pending()

    (early, bound), snap = _schedule(lambda c: c.default_scheduler_config(), _nodes(),
                                     [_pod("p-early", "bin-packing")], extra=extra)
    assert early == 0  # profile doesn't exist yet
    assert bound == 1
    assert snap[("default", "p-early")][0] == "node-small"
