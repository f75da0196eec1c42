"""Gang scheduling in the port: kernel B8's plain version
(framework/gang.py `quorum_slice_plain`, through `quorum_slice` on the
CPU) against the JAX package's `quorum_slice`, exactly, on random slices
(absent groups, n = 0 and G = 0 included); and the port's engine against
the JAX engine on the scenarios of tests/test_gang_scheduling.py — full
gang binds, below-quorum parking, quorum completing in a later wave,
timeout rejection with the permit annotations, the Coscheduling PreFilter
rejects, streaming cuts with straddling gangs (chunk 4, gangs of 5) and
the speculative wave's gang-aligned round cuts.  Every pod of the two
stores must agree exactly, along with the bound counts and the parked
and waiting sets.
"""

import copy
import json
import time

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.framework import gang as jgang
from kube_scheduler_simulator_tpu_torch.framework import gang as pgang
from kube_scheduler_simulator_tpu_torch.kernels import gang as kgang
from kube_scheduler_simulator_tpu_torch.store import annotations as ann
from test_torch_engine import JAX, PORT, assert_same, fill, knobs, snapshot


# ------------------------------------------------ B8's plain version

def _random_slice(rng, n, g):
    """gid with contiguous groups (some absent, -1 runs between), random
    selections, already and minMember."""
    gid = np.full(n, -1, np.int32)
    pos = 0
    for k in range(g):
        if rng.random() < 0.25:
            continue  # a group absent from the slice
        size = int(rng.integers(1, 7))
        gid[pos:pos + size] = k
        pos += size + int(rng.integers(0, 3))
        if pos >= n:
            break
    gid = gid[:n]
    sel = np.where(rng.random(n) < 0.6, rng.integers(0, 9, n), -1).astype(np.int32)
    already = rng.integers(0, 4, g).astype(np.int32)
    min_member = rng.integers(1, 8, g).astype(np.int32)
    return gid, sel, already, min_member


@pytest.mark.parametrize("n,g", [(1, 1), (7, 3), (40, 6), (80, 12), (200, 30), (33, 40)])
def test_quorum_slice_plain_matches_jax(n, g):
    rng = np.random.default_rng(n * 100 + g)
    for _ in range(12):
        args = _random_slice(rng, n, g)
        want = jgang.quorum_slice(*args)
        got = pgang.quorum_slice(*args, device="cpu")
        for w, x in zip(want, got):
            assert w.dtype == x.dtype and w.shape == x.shape
            np.testing.assert_array_equal(x, w)


@pytest.mark.parametrize("n,g", [(0, 3), (5, 0), (0, 0)])
def test_quorum_slice_empty(n, g):
    rng = np.random.default_rng(1)
    args = (np.full(n, -1, np.int32), np.zeros(n, np.int32),
            rng.integers(0, 3, g).astype(np.int32), np.ones(g, np.int32))
    launches = kgang.quorum_slice.launches
    for w, x in zip(jgang.quorum_slice(*args), pgang.quorum_slice(*args, device="cpu")):
        assert w.dtype == x.dtype and w.shape == x.shape
        np.testing.assert_array_equal(x, w)
    assert kgang.quorum_slice.launches == launches


def test_quorum_slice_absent_groups_admit_on_already():
    """A group absent from the slice admits exactly when its already count
    reaches minMember (segment_min of an empty segment, clipped)."""
    gid = np.array([-1, 1, 1, -1], np.int32)
    sel = np.array([0, 2, -1, 3], np.int32)
    already = np.array([3, 0, 1], np.int32)
    min_member = np.array([3, 2, 2], np.int32)
    want = jgang.quorum_slice(gid, sel, already, min_member)
    got = pgang.quorum_slice(gid, sel, already, min_member, device="cpu")
    for w, x in zip(want, got):
        np.testing.assert_array_equal(x, w)
    assert got[0].tolist() == [True, False, False]


def test_quorum_slice_plain_is_the_cpu_path():
    """On the CPU the wrapper runs the plain version and counts no launch."""
    import torch

    rng = np.random.default_rng(9)
    gid, sel, already, mm = _random_slice(rng, 40, 6)
    launches = kgang.quorum_slice.launches
    packed = torch.from_numpy(np.concatenate([gid, sel, already, mm]))
    out = kgang.quorum_slice(packed, 40, 6).numpy()
    admit, wave, wait = pgang.quorum_slice_plain(*(torch.from_numpy(a) for a in
                                                   (gid, sel, already, mm)))
    np.testing.assert_array_equal(out, np.concatenate(
        [admit.numpy().astype(np.int32), wave.numpy(), wait.numpy().astype(np.int32)]))
    assert kgang.quorum_slice.launches == launches


# ------------------------------------------------ tests/test_gang_scheduling.py

def _gang_objects(pkg, n_nodes=4, members=3, min_member=None, timeout=30,
                  infeasible=(), n_groups=1, seed=2, node_seed=1, cpu_milli=500):
    pgs, pods = pkg.wl.make_gang_workload(n_groups, members, min_member=min_member, seed=seed,
                                          timeout_seconds=timeout, cpu_milli=cpu_milli)
    for i in infeasible:
        pods[i]["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "9999999m"
    return {"nodes": pkg.wl.make_nodes(n_nodes, seed=node_seed), "podgroups": pgs,
            "pods": pods}


def _engine(pkg, store, pipeline=True, chunk=512, enabled=("NodeResourcesFit",)):
    cfg = pkg.Cfg(enabled=list(enabled) + ["Coscheduling"],
                  custom={"Coscheduling": pkg.Cosched()})
    return pkg.Engine(store, plugin_config=cfg, chunk=chunk, pipeline_commit=pipeline,
                      **pkg.kw)


def _state(engine, store, bounds):
    return {"bound": bounds, "pods": snapshot(store),
            "parked": sorted(engine.gang_parked),
            "waiting": sorted(engine.waiting_pods)}


def full_gang(pkg, pipeline):
    store = fill(pkg, _gang_objects(pkg))
    engine = _engine(pkg, store, pipeline)
    return _state(engine, store, [engine.schedule_pending()])


def below_quorum(pkg, pipeline):
    store = fill(pkg, _gang_objects(pkg, infeasible=(2,)))
    engine = _engine(pkg, store, pipeline)
    return _state(engine, store, [engine.schedule_pending()])


def quorum_across_waves(pkg, pipeline):
    store = fill(pkg, _gang_objects(pkg, infeasible=(2,)))
    engine = _engine(pkg, store, pipeline)
    bounds = [engine.schedule_pending()]
    bad = sorted(p["metadata"]["name"] for p in store.list("pods")[0])[2]
    pod = store.get("pods", bad)
    store.delete("pods", bad, "default")
    pod["metadata"].pop("resourceVersion", None)
    pod["metadata"].pop("uid", None)
    pod["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "100m"
    store.create("pods", pod)
    bounds.append(engine.schedule_pending())
    return _state(engine, store, bounds)


def timeout_rejects(pkg, pipeline):
    store = fill(pkg, _gang_objects(pkg, timeout=0.15, infeasible=(2,)))
    engine = _engine(pkg, store, pipeline)
    bounds = [engine.schedule_pending()]
    time.sleep(0.25)
    bounds.append(engine._gang_maintain())  # what the next schedule_pending runs first
    return _state(engine, store, bounds)


def prefilter_quorum(pkg, pipeline):
    store = fill(pkg, _gang_objects(pkg, members=2, min_member=5))
    engine = _engine(pkg, store, pipeline)
    return _state(engine, store, [engine.schedule_pending()])


def prefilter_min_resources(pkg, pipeline):
    objects = _gang_objects(pkg, n_nodes=2, members=2, seed=3)
    objects["podgroups"][0]["spec"]["minResources"] = {"cpu": "100000", "memory": "1Ti"}
    store = fill(pkg, objects)
    engine = _engine(pkg, store, pipeline)
    return _state(engine, store, [engine.schedule_pending()])


def assumed_capacity(pkg, pipeline):
    store = fill(pkg, {"nodes": [{"metadata": {"name": "only"}, "status": {
        "allocatable": {"cpu": "2", "memory": "8Gi", "pods": "10"}}}]})
    objects = _gang_objects(pkg, infeasible=(2,), cpu_milli=900)
    pkg.ensure(store)
    for res in ("podgroups", "pods"):
        for obj in objects[res]:
            store.create(res, copy.deepcopy(obj))
    engine = _engine(pkg, store, pipeline)
    bounds = [engine.schedule_pending()]
    filler = pkg.wl.make_pods(1, seed=7)[0]
    filler["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "500m"
    store.create("pods", filler)
    bounds.append(engine.schedule_pending())
    return _state(engine, store, bounds)


def straddling(pkg, pipeline):
    nodes = pkg.wl.make_nodes(10, seed=7)
    pgs, gpods = pkg.wl.make_gang_workload(3, 5, seed=9)
    for p in gpods:
        if (p["metadata"]["labels"][pgang.POD_GROUP_LABEL] == "gang-0001"
                and p["metadata"]["name"].endswith("004")):
            p["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "9999999m"
    store = fill(pkg, {"nodes": nodes, "podgroups": pgs, "pods": gpods})
    engine = _engine(pkg, store, pipeline, chunk=4)
    return _state(engine, store, [engine.schedule_pending()])


def mixed_wave(pkg, pipeline):
    """Gangs among plain pods under four plugins: the speculative wave's
    rounds cut on gang boundaries (aligned_cut), the scan's chunks too."""
    nodes = pkg.wl.make_nodes(12, seed=31, taint_fraction=0.2)
    pgs, gpods = pkg.wl.make_gang_workload(4, 4, seed=32, cpu_milli=700)
    gpods[5]["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "9999999m"
    plain = pkg.wl.make_pods(24, seed=33, with_affinity=True, with_tolerations=True)
    store = fill(pkg, {"nodes": nodes, "podgroups": pgs, "pods": gpods + plain})
    engine = _engine(pkg, store, pipeline, chunk=8,
                     enabled=("NodeResourcesFit", "NodeResourcesBalancedAllocation",
                              "NodeAffinity", "TaintToleration"))
    return _state(engine, store, [engine.schedule_pending()])


SCENARIOS = {f.__name__: f for f in (full_gang, below_quorum, quorum_across_waves,
                                     timeout_rejects, prefilter_quorum,
                                     prefilter_min_resources, assumed_capacity,
                                     straddling, mixed_wave)}


def _assert_same_state(got, want):
    assert got["bound"] == want["bound"]
    assert got["parked"] == want["parked"]
    assert got["waiting"] == want["waiting"]
    assert_same(got["pods"], want["pods"])


@pytest.mark.parametrize("spec", ["1", "0"], ids=["wave", "scan"])
@pytest.mark.parametrize("name", list(SCENARIOS))
def test_gang_scenario_matches_jax(name, spec):
    fn = SCENARIOS[name]
    with knobs(KSS_TPU_SPECULATIVE=spec):
        want = fn(JAX, True)
        for pipeline in (True, False):
            _assert_same_state(fn(PORT, pipeline), want)


def _permits(state, name):
    a = state["pods"][("default", name)][4]
    return (json.loads(a[ann.PERMIT_STATUS_RESULT]),
            json.loads(a[ann.PERMIT_TIMEOUT_RESULT]))


def test_gang_outcomes_on_the_port():
    """The outcomes the JAX tests assert, read from the port's runs."""
    st = full_gang(PORT, True)
    names = sorted(k[1] for k in st["pods"])
    assert st["bound"] == [3] and st["parked"] == [] and st["waiting"] == []
    assert _permits(st, names[0]) == ({"Coscheduling": "wait"}, {"Coscheduling": "30s"})
    assert _permits(st, names[2]) == ({"Coscheduling": "success"}, {"Coscheduling": "0s"})

    st = below_quorum(PORT, True)
    assert st["bound"] == [0] and [k[1] for k in st["parked"]] == names[:2]
    assert all(v[0] is None for v in st["pods"].values())

    st = quorum_across_waves(PORT, True)
    assert st["bound"] == [0, 3] and st["parked"] == []

    st = timeout_rejects(PORT, True)
    assert st["bound"] == [0, 0] and st["parked"] == [] and st["waiting"] == []
    assert _permits(st, names[0]) == ({"Coscheduling": "timeout"},
                                      {"Coscheduling": "0.15s"})
    assert "timed out" in _permits(st, names[1])[0]["Coscheduling"]

    st = prefilter_quorum(PORT, True)
    a = st["pods"][("default", sorted(k[1] for k in st["pods"])[0])][4]
    assert "cannot reach quorum" in json.loads(a[ann.PRE_FILTER_STATUS_RESULT])["Coscheduling"]

    st = straddling(PORT, True)
    assert st["bound"] == [10] and len(st["parked"]) == 4

    st = assumed_capacity(PORT, True)
    assert st["bound"] == [0, 0] and len(st["parked"]) == 2


def test_stream_takes_gang_and_ignore():
    """replay_speculative_stream takes the engine's gang context and
    ignore set (JAX speculative.py:655-661): rounds of 6 over gangs of 4
    cut back to gang boundaries, with the JAX stream's selections and
    stats (rounds, accepts, the scan fallback)."""
    from types import SimpleNamespace

    from kube_scheduler_simulator_tpu.parallel.speculative import (
        replay_speculative_stream as jstream)
    from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
    from kube_scheduler_simulator_tpu.state.compile import compile_workload as jcompile
    from kube_scheduler_simulator_tpu_torch.models import make_gang_workload, make_nodes
    from kube_scheduler_simulator_tpu_torch.parallel.speculative import (
        replay_speculative_stream)
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.state import compile_workload

    _, pods = make_gang_workload(5, 4, seed=4)
    nodes = make_nodes(6, seed=5)
    gang = SimpleNamespace(gid=np.repeat(np.arange(5, dtype=np.int32), 4),
                           start=np.arange(0, 20, 4, dtype=np.int32))
    ignore = frozenset({"Coscheduling"})
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=["NodeResourcesFit"]),
                          device="cpu")
    rr, stats = replay_speculative_stream(cw, chunk=8, batch=6, gang=gang, ignore=ignore,
                                          device="cpu")
    jcw = jcompile(nodes, pods, JCfg(enabled=["NodeResourcesFit"]))
    jrr, jstats = jstream(jcw, chunk=8, batch=6, gang=gang, ignore=ignore)
    np.testing.assert_array_equal(rr.selected, np.asarray(jrr.selected))
    assert stats == jstats
    assert stats["rounds"] > 0
