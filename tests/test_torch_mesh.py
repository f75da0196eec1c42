"""The port's node-sharded mesh (parallel/mesh.py, kernels/mesh.py: B12)
against its unsharded path and the JAX package's sharded calls.

The JAX package's tests/test_mesh.py runs its mesh on the conftest's 8
virtual CPU devices; each of its tests is ported here, with the port's
mesh on the CPU (`device="cpu"`: the plain twins of the sharded kernels,
which compute each shard's partials over its own node slice and combine
them in rank order).  Every comparison is exact (tolerance 0): selected
nodes, feasible counts, PreFilter rejects, compact outputs, carries and
the 13 annotation blobs.

Beyond test_mesh.py, the decomposition cases: an argmax tie across two
shards, a spread minimum that lies only in the last shard,
InterPodAffinity's matched_total counted once per bind, a hostname
topology (domains are nodes, D == N), the default profile with volumes at
S = 4, the stream at dp = 2 against the JAX package's, and an engine
whose fleet does not divide the mesh falling back with its counter.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kube_scheduler_simulator_tpu.cluster.store import ObjectStore as JObjectStore
from kube_scheduler_simulator_tpu.framework.engine import SchedulerEngine as JEngine
from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.models.workloads import make_nodes, make_pods
from kube_scheduler_simulator_tpu.parallel import mesh as jmesh
from kube_scheduler_simulator_tpu.parallel import speculative as jspec
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
from kube_scheduler_simulator_tpu_torch.framework import replay
from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step, slice_pod
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _slice_xs
from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
from kube_scheduler_simulator_tpu_torch.models import baseline_config
from kube_scheduler_simulator_tpu_torch.parallel import (
    initialize_distributed, make_mesh, shard_workload, sharded_step, speculative_scores)
from kube_scheduler_simulator_tpu_torch.parallel import speculative as pspec
from kube_scheduler_simulator_tpu_torch.parallel.mesh import Mesh, can_shard, gather_to_host
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result
from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

CPU = "cpu"


def _workload(n_nodes=16, n_pods=12, seed=80):
    """tests/test_mesh.py:19: the JAX package's generator, so both
    packages see the same manifests."""
    nodes = make_nodes(n_nodes, seed=seed, taint_fraction=0.25)
    pods = make_pods(n_pods, seed=seed + 1, with_affinity=True,
                     with_tolerations=True, with_spread=True)
    return nodes, pods


def _jax_scan_selections(cw, step):
    carry = cw.init_carry
    sel = []
    for i in range(cw.n_pods):
        sl = jax.tree.map(lambda a: a[i] if hasattr(a, "ndim") and a.ndim else a, cw.xs)
        sl["is_pad"] = jnp.asarray(False)
        carry, out = step(carry, sl)
        sel.append(int(out.selected))
    return sel


def _port_scan_selections(cw, step):
    carry = _clone_carry(cw.init_carry)
    sel = []
    for i in range(cw.n_pods):
        sl = slice_pod(cw.xs, i)
        sl["is_pad"] = torch.tensor(False)
        carry, out = step(carry, sl)
        sel.append(int(out.selected))
    return sel


def _jax_sharded_selections(nodes, pods, dp):
    cw = jmesh.shard_workload(jax_compile(nodes, pods, JCfg()), jmesh.make_mesh(8, dp=dp))
    return _jax_scan_selections(cw, jmesh.sharded_step(cw))


def assert_same_results(a, b, what=""):
    """Two ReplayResults: the per-pod rows and the 13 annotation blobs."""
    assert a.cw.n_pods == b.cw.n_pods
    np.testing.assert_array_equal(a.selected, b.selected, err_msg=what)
    np.testing.assert_array_equal(a.feasible_count, b.feasible_count, err_msg=what)
    np.testing.assert_array_equal(a.prefilter_reject, b.prefilter_reject, err_msg=what)
    for i in range(a.cw.n_pods):
        da, db = decode_pod_result(a, i), decode_pod_result(b, i)
        for key in ALL_PLUGIN_KEYS:
            assert da[key] == db[key], f"{what} pod {i} {key}\n{da[key][:300]}\n{db[key][:300]}"


def assert_same_as_jax(rr, jrr):
    np.testing.assert_array_equal(rr.selected, np.asarray(jrr.selected))
    for i in range(rr.cw.n_pods):
        da, db = decode_pod_result(rr, i), jax_decode(jrr, i)
        for key in ALL_PLUGIN_KEYS:
            assert da[key] == db[key], f"pod {i} {key}: port vs JAX"


# ------------------------------------------------ tests/test_mesh.py

def test_sharded_step_matches_unsharded():
    nodes, pods = _workload()
    base_sel = [int(s) for s in replay(compile_workload(nodes, pods, PluginSetConfig(),
                                                        device=CPU), chunk=4, device=CPU).selected]
    cw = shard_workload(compile_workload(nodes, pods, PluginSetConfig(), device=CPU),
                        make_mesh(8, dp=1, device=CPU))
    assert _port_scan_selections(cw, sharded_step(cw)) == base_sel
    assert _jax_sharded_selections(nodes, pods, dp=1) == base_sel


def test_sharded_dp_mesh_matches_unsharded():
    nodes, pods = _workload(n_nodes=8, n_pods=8, seed=81)
    base_sel = [int(s) for s in replay(compile_workload(nodes, pods, PluginSetConfig(),
                                                        device=CPU), chunk=4, device=CPU).selected]
    mesh = make_mesh(8, dp=2, device=CPU)  # 2-way speculative batch x 4-way node shard
    assert mesh.shape == {"dp": 2, "nodes": 4}
    cw = shard_workload(compile_workload(nodes, pods, PluginSetConfig(), device=CPU), mesh)
    assert cw.mesh.node_slices(cw.n_nodes) == ((0, 2), (2, 4), (4, 6), (6, 8))
    assert _port_scan_selections(cw, sharded_step(cw, mesh)) == base_sel
    assert _jax_sharded_selections(nodes, pods, dp=2) == base_sel


def test_sharded_replay_annotations_byte_identical():
    nodes, pods = _workload(n_nodes=24, n_pods=10, seed=83)
    base = replay(compile_workload(nodes, pods, PluginSetConfig(), device=CPU), chunk=4,
                  device=CPU)
    sharded = replay(compile_workload(nodes, pods, PluginSetConfig(), device=CPU), chunk=4,
                     device=CPU, mesh=make_mesh(8, dp=1, device=CPU))
    assert_same_results(sharded, base, "mesh vs unsharded")
    jrr = jax_replay(jax_compile(nodes, pods, JCfg()), chunk=4, mesh=jmesh.make_mesh(8, dp=1))
    assert_same_as_jax(sharded, jrr)


def _engine_run(store_cls, engine_cls, nodes, pods, cfg, **kw):
    store = store_cls()
    for n in nodes:
        store.create("nodes", copy.deepcopy(n))
    for p in pods:
        store.create("pods", copy.deepcopy(p))
    engine = engine_cls(store, plugin_config=cfg, **kw)
    bound = engine.schedule_pending()
    placements, annos = {}, {}
    for p in pods:
        cur = store.get("pods", p["metadata"]["name"])
        placements[p["metadata"]["name"]] = cur["spec"].get("nodeName") or ""
        annos[p["metadata"]["name"]] = dict(cur["metadata"].get("annotations") or {})
    return bound, placements, annos


@pytest.mark.parametrize("spec", ["1", "0"], ids=["wave", "scan"])
def test_engine_schedules_with_mesh(spec, monkeypatch):
    monkeypatch.setenv("KSS_TPU_SPECULATIVE", spec)
    nodes, pods = _workload(n_nodes=16, n_pods=6, seed=84)
    b0, p0, a0 = _engine_run(ObjectStore, SchedulerEngine, nodes, pods, PluginSetConfig(),
                             device=CPU)
    b1, p1, a1 = _engine_run(ObjectStore, SchedulerEngine, nodes, pods, PluginSetConfig(),
                             device=CPU, mesh=make_mesh(8, dp=1, device=CPU))
    assert (b1, p1) == (b0, p0)
    assert a1 == a0
    jb, jp, ja = _engine_run(JObjectStore, JEngine, nodes, pods, JCfg(),
                             mesh=jmesh.make_mesh(8, dp=1))
    assert (b1, p1) == (jb, jp)
    assert a1 == ja


def test_make_mesh_rejects_non_divisible_dp():
    for kw in ({"dp": 3}, {"dp": 0}):
        with pytest.raises(ValueError) as port_err:
            make_mesh(8, device=CPU, **kw)
        with pytest.raises(ValueError) as jax_err:
            jmesh.make_mesh(8, **kw)
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="divide"):
        make_mesh(8, dp=3, device=CPU)
    with pytest.raises(ValueError, match="dp must be >= 1"):
        make_mesh(8, dp=0, device=CPU)
    assert make_mesh(8, dp=2, device=CPU).shape == {"dp": 2, "nodes": 4}
    # one card: the "nodes" extent is a cluster size, at most 8 CTAs
    with pytest.raises(ValueError, match="at most 8"):
        make_mesh(16, device=CPU)
    assert make_mesh(16, dp=2, device=CPU).shape == {"dp": 2, "nodes": 8}
    # shards on separate cards are ROADMAP Queue B item B12b
    with pytest.raises(NotImplementedError, match="B12b"):
        make_mesh(8, device=["cuda:0", "cuda:1"])
    # "cuda" names the current card: with "cuda:0" that is one card, so the
    # mesh passes the B12b check and needs the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(8, device=["cuda", "cuda:0"])
    else:
        assert make_mesh(8, device=["cuda", "cuda:0"]).device == torch.device("cuda", 0)
    with pytest.raises(NotImplementedError, match="B12b"):
        initialize_distributed()


def test_speculative_batch_consistent_with_step():
    nodes, pods = _workload(n_nodes=8, n_pods=4, seed=82)
    cw = compile_workload(nodes, pods, PluginSetConfig(), device=CPU)
    step = build_step(cw)
    singles = []
    for i in range(cw.n_pods):
        sl = slice_pod(cw.xs, i)
        sl["is_pad"] = torch.tensor(False)
        _, out = step(_clone_carry(cw.init_carry), sl)
        singles.append(int(out.selected))
    xs_batch = dict(cw.xs)
    xs_batch["is_pad"] = torch.zeros(cw.n_pods, dtype=torch.bool)
    outs = speculative_scores(cw)(cw.init_carry, xs_batch)
    assert [int(s) for s in outs.selected] == singles
    meshed = speculative_scores(cw, make_mesh(8, dp=2, device=CPU))(cw.init_carry, xs_batch)
    for f in outs._fields:
        assert torch.equal(getattr(meshed, f), getattr(outs, f)), f
    # the JAX package's batched scores, field for field
    jcw = jax_compile(nodes, pods, JCfg())
    jxs = dict(jcw.xs)
    jxs["is_pad"] = jnp.zeros((jcw.n_pods,), dtype=bool)
    jouts = jmesh.speculative_scores(jcw)(jcw.init_carry, jxs)
    for f in outs._fields:
        np.testing.assert_array_equal(getattr(outs, f).numpy(), np.asarray(getattr(jouts, f)),
                                      err_msg=f)
    assert [int(s) for s in jouts.selected] == singles


# ------------------------------------------------ the decomposition, exact

def _node(name, cpu="4", mem="8Gi", labels=None, taints=None):
    n = {"metadata": {"name": name, "labels": {"kubernetes.io/hostname": name,
                                                **(labels or {})}},
         "status": {"allocatable": {"cpu": cpu, "memory": mem, "pods": "110"}},
         "spec": {}}
    if taints:
        n["spec"]["taints"] = taints
    return n


def _pod(name, cpu="100m", labels=None, spec=None):
    return {"metadata": {"name": name, "namespace": "default", "labels": labels or {}},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {
                "cpu": cpu, "memory": "128Mi"}}}], **(spec or {})}}


def _chunk_both(cw, shards):
    """One chunk of the whole queue through the unsharded plain step and
    the sharded twin -> ((carry, out), (carry, out))."""
    kw = dict(out_mode="compact", pack_mode="p16",
              score_dtypes=tuple("i16" for _ in cw.config.scorers()))
    step = build_step(cw, **kw)
    sstep = build_step(shard_workload(cw, make_mesh(shards, device=CPU)), **kw)
    xs = _slice_xs(cw.xs, 0, cw.n_pods, cw.n_pods)
    xs["is_pad"] = torch.zeros(cw.n_pods, dtype=torch.bool)
    base = step.plain_scan(_clone_carry(cw.init_carry), xs)
    sharded = kmesh.step_chunk_sharded_plain(sstep, _clone_carry(cw.init_carry), xs)
    return base, sharded


def _assert_same_chunk(base, sharded):
    (c0, o0), (c1, o1) = base, sharded
    for f in o0._fields:
        a, b = getattr(o0, f), getattr(o1, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a.to(torch.int64), b.to(torch.int64)), f
    assert list(c0) == list(c1)
    for k in c0:
        x, y = c0[k], c1[k]
        for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert torch.equal(a, b), k


def test_argmax_tie_across_two_shards():
    """Nodes 1 and 2 score equal best, one in each shard of two; the
    combine keeps (value desc, index asc): node 1, as unsharded."""
    nodes = [_node("n0", cpu="1"), _node("n1"), _node("n2"), _node("n3", cpu="1")]
    cw = compile_workload(nodes, [_pod("p0")], PluginSetConfig(), device=CPU)
    base, sharded = _chunk_both(cw, 2)
    assert int(base[1].selected[0]) == 1
    _assert_same_chunk(base, sharded)
    # and when the tie lies across the last two of four shards
    nodes = [_node("n0", cpu="1"), _node("n1", cpu="1"), _node("n2"), _node("n3")]
    cw = compile_workload(nodes, [_pod("p0")], PluginSetConfig(), device=CPU)
    base, sharded = _chunk_both(cw, 4)
    assert int(base[1].selected[0]) == 2
    _assert_same_chunk(base, sharded)


def _spread_pod(name):
    return _pod(name, labels={"app": "web"}, spec={"topologySpreadConstraints": [{
        "maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "web"}}}]})


@pytest.mark.parametrize("shards", [2, 4])
def test_spread_minimum_only_in_the_last_shard(shards):
    """Hostname spread: nodes 0-2 hold a matching pod, node 3 none, so the
    global minimum 0 lies only in the last shard.  A shard-local minimum
    would pass nodes 0-1 (skew 1); the combined one fails them (skew 2)."""
    nodes = [_node(f"n{i}") for i in range(4)]
    bound = [(_spread_pod(f"b{i}"), f"n{i}") for i in range(3)]
    cw = compile_workload(nodes, [_spread_pod("p0")], PluginSetConfig(), bound_pods=bound,
                          device=CPU)
    base, sharded = _chunk_both(cw, shards)
    assert int(base[1].selected[0]) == 3
    assert int(base[1].feasible_count[0]) == 1
    _assert_same_chunk(base, sharded)
    rr = replay(cw, chunk=1, device=CPU, mesh=make_mesh(shards, device=CPU))
    assert int(rr.selected[0]) == 3
    jrr = jax_replay(jax_compile(nodes, [_spread_pod("p0")], JCfg(), bound_pods=bound), chunk=1)
    assert_same_as_jax(rr, jrr)


def _ip_pod(name, zone_term=True):
    term = {"labelSelector": {"matchLabels": {"app": "db"}},
            "topologyKey": "zone" if zone_term else "kubernetes.io/hostname"}
    return _pod(name, labels={"app": "db"}, spec={"affinity": {
        "podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 10, "podAffinityTerm": term}]},
        "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {**term, "topologyKey": "kubernetes.io/hostname"}]}}})


def test_interpod_matched_total_counted_once_per_bind():
    """Eight pods that match their own terms bind over four shards: the
    carry's matched_total must count each bind once (S owners would count
    it S times) and every [T, N] matrix must equal the unsharded one."""
    nodes = [_node(f"n{i}", labels={"zone": f"z{i % 2}"}) for i in range(8)]
    pods = [_ip_pod(f"p{i}") for i in range(8)]
    cw = compile_workload(nodes, pods, PluginSetConfig(), device=CPU)
    base, sharded = _chunk_both(cw, 4)
    _assert_same_chunk(base, sharded)
    bound = int((base[1].selected >= 0).sum())
    assert bound == 8
    total = sharded[0]["InterPodAffinity"].matched_total
    assert int(total.sum()) == bound * int((cw.xs["InterPodAffinity"].t_matches[0]).sum())


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_hostname_topology_domains_are_nodes(shards):
    """Spread and InterPod over kubernetes.io/hostname: each domain is one
    node, so the domain axis D equals N and every node-space carry row is
    a domain row.  Sharded replay == unsharded == the JAX package's
    sharded replay."""
    nodes = [_node(f"n{i}", cpu=str(2 + i % 3)) for i in range(8)]
    pods = ([_spread_pod(f"s{i}") for i in range(6)]
            + [_ip_pod(f"a{i}", zone_term=False) for i in range(6)])
    cw = compile_workload(nodes, pods, PluginSetConfig(), device=CPU)
    assert cw.statics["PodTopologySpread"].dom_idx.shape[1] == len(nodes)
    base = replay(cw, chunk=4, device=CPU)
    sharded = replay(cw, chunk=4, device=CPU, mesh=make_mesh(shards, device=CPU))
    assert_same_results(sharded, base, f"S={shards}")
    jrr = jax_replay(jax_compile(nodes, pods, JCfg()), chunk=4, mesh=jmesh.make_mesh(8))
    assert_same_as_jax(sharded, jrr)


def test_default_profile_with_volumes_at_four_shards():
    """The default profile (all 14 Filter/Score plugins, the volume
    family included) on chip_smoke's decorated config-5 fleet: the
    sharded replay's rows and annotations equal the unsharded replay's,
    and one chunk's carry equals the unsharded one's."""
    nodes, pods, _ = baseline_config(5, scale=0.02, seed=0)
    pods = pods[:96]
    volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=0)
    cw = compile_workload(nodes, pods, PluginSetConfig(), volumes=volumes, bound_pods=bound,
                          device=CPU)
    assert len(nodes) % 4 == 0
    base = replay(cw, chunk=32, device=CPU)
    sharded = replay(cw, chunk=32, device=CPU, mesh=make_mesh(4, device=CPU))
    assert_same_results(sharded, base, "default profile S=4")
    assert (base.prefilter_reject != 0).any()
    cw32 = compile_workload(nodes, pods[:32], PluginSetConfig(), volumes=volumes,
                            bound_pods=bound, device=CPU)
    _assert_same_chunk(*_chunk_both(cw32, 4))


def test_stream_at_dp2_matches_jax_stream():
    """replay_speculative_stream(cw, mesh) with dp = 2 x nodes = 4 against
    the unsharded stream, the scan, and the JAX package's stream on its
    8-device mesh; the ladder's rungs are dp multiples."""
    nodes, pods, cfg = baseline_config(5, scale=0.01, seed=0)
    nodes, pods = nodes[:48], pods[:40]
    mesh = make_mesh(8, dp=2, device=CPU)
    cw = compile_workload(nodes, pods, cfg, device=CPU)
    rr, stats = pspec.replay_speculative_stream(cw, mesh, chunk=16, pods=pods)
    rr0, stats0 = pspec.replay_speculative_stream(cw, chunk=16, pods=pods)
    assert_same_results(rr, rr0, "stream mesh vs unsharded")
    assert_same_results(rr, replay(cw, chunk=16, device=CPU), "stream mesh vs scan")
    assert all(b % 2 == 0 for b in stats["round_batches"])
    jcw = jax_compile(nodes, pods, JCfg(enabled=cfg.enabled))
    jrr, jstats = jspec.replay_speculative_stream(jcw, jmesh.make_mesh(8, dp=2), chunk=16,
                                                  pods=pods)
    assert_same_as_jax(rr, jrr)
    assert stats == jstats
    # replay_speculative(cw, mesh) takes the mesh too
    rs, _ = pspec.replay_speculative(cw, mesh, batch=8, pods=pods)
    assert_same_results(rs, rr0, "replay_speculative on a mesh")


def test_indivisible_node_count_falls_back_with_counter():
    """A fleet of 12 nodes on an 8-shard mesh: the wave runs unsharded,
    binds exactly as an engine without a mesh, and counts itself once."""
    nodes, pods = _workload(n_nodes=12, n_pods=6, seed=85)
    mesh = make_mesh(8, device=CPU)
    assert not can_shard(12, mesh) and can_shard(16, mesh)
    before = TRACER.counter_totals().get("mesh_fallback_indivisible_nodes_total", 0)
    got = _engine_run(ObjectStore, SchedulerEngine, nodes, pods, PluginSetConfig(),
                      device=CPU, mesh=mesh)
    after = TRACER.counter_totals().get("mesh_fallback_indivisible_nodes_total", 0)
    assert after - before == 1
    want = _engine_run(ObjectStore, SchedulerEngine, nodes, pods, PluginSetConfig(),
                       device=CPU)
    assert got == want
    with pytest.raises(ValueError, match="divide evenly"):
        shard_workload(compile_workload(nodes, pods, PluginSetConfig(), device=CPU), mesh)


def _claiming_shards(cw, shards):
    """cw carrying a mesh that claims `shards` node shards, past what
    make_mesh and shard_workload accept: what a wrapper must refuse."""
    mesh = object.__new__(Mesh)
    mesh.shape, mesh.device = {"dp": 1, "nodes": shards}, cw.device
    return dataclasses.replace(cw, mesh=mesh)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    nodes, pods = _workload(n_nodes=16, n_pods=2, seed=86)
    cw = compile_workload(nodes, pods, PluginSetConfig(), device=CPU)
    step = build_step(cw)
    xs = _slice_xs(cw.xs, 0, 2, 2)
    xs["is_pad"] = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="1 to 8"):
        kmesh.step_chunk_sharded(build_step(_claiming_shards(cw, 16)),
                                 _clone_carry(cw.init_carry), xs)
    with pytest.raises(ValueError, match="divide evenly"):
        kmesh.spec_eval_sharded(build_step(_claiming_shards(cw, 3)), cw.init_carry, xs)
    with pytest.raises(ValueError, match="sharded over a mesh"):
        kmesh.step_chunk_sharded(step, _clone_carry(cw.init_carry), xs)
    assert gather_to_host(torch.arange(4).reshape(2, 2).t()).flags["C_CONTIGUOUS"]


def test_twin_refuses_a_leaf_without_a_node_axis():
    """Every tensor leaf of a sharded workload needs its node axis declared
    in state/compile.py NODE_AXES: the twin refuses a leaf missing there
    rather than leave it whole in every shard."""
    nodes, pods = _workload(n_nodes=8, n_pods=2, seed=87)
    cw = shard_workload(compile_workload(nodes, pods, PluginSetConfig(), device=CPU),
                        make_mesh(2, device=CPU))
    xs = _slice_xs(cw.xs, 0, 2, 2)
    xs["is_pad"] = torch.zeros(2, dtype=torch.bool)
    kmesh.spec_eval_sharded(build_step(cw), cw.init_carry, xs)
    statics = {**cw.statics, "NewPlugin": torch.zeros(3, cw.n_nodes)}
    odd = dataclasses.replace(cw, statics=statics)
    with pytest.raises(KeyError, match="NODE_AXES"):
        kmesh.spec_eval_sharded(build_step(odd), cw.init_carry, xs)

