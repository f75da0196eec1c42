"""The port's mesh over cards (B12b: parallel/mesh.py, kernels/mesh.py
Cards, step_chunk_cards, spec_eval_cards, spec_commit_cards) on virtual
CPU cards, against the unsharded port and the JAX package's mesh on the
conftest's 8 virtual CPU devices.

The JAX package never runs its mesh on more than one real device in its
tests: tests/test_mesh.py:37-119 and tests/test_device_resident.py:165
hold it on 8 virtual CPU devices.  The port holds its card mesh the same
way: `make_mesh(n, dp, device="cpu", _virtual=True)` gives n virtual
cards, each with its own tensors (its node slice of every [.., N]
tensor, the cluster-wide carries and the whole node-to-domain rows), and
the plain twins walk the per-card tensors and fold the per-card partials
in card order, as the kernels' PeerScope does on the card.  Each mirror
runs at n = 2, 4 and 8 virtual cards and dp = 1 and 2.  Every comparison
is exact (tolerance 0): selected nodes, feasible counts, PreFilter
rejects, the 13 annotation blobs, the attribution dicts and the carries.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from kube_scheduler_simulator_tpu_torch.framework.replay import (_clone_carry, _slice_xs,
                                                                 plugin_attribution)
from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
from kube_scheduler_simulator_tpu_torch.models import baseline_config
from kube_scheduler_simulator_tpu_torch.parallel import (
    global_devices, make_mesh, shard_workload, sharded_step, speculative_scores)
from kube_scheduler_simulator_tpu_torch.parallel import speculative as pspec
from kube_scheduler_simulator_tpu_torch.parallel.mesh import gather_to_host
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result

CPU = "cpu"
MESHES = [(2, 1), (4, 1), (8, 1), (2, 2), (4, 2), (8, 2)]
IDS = [f"n{n}-dp{dp}" for n, dp in MESHES]


def _cards(n, dp):
    return make_mesh(n, dp=dp, device=CPU, _virtual=True)


def _workload(n_nodes=16, n_pods=12, seed=80):
    """tests/test_mesh.py:19: the JAX package's generator, so both
    packages see the same manifests."""
    nodes = make_nodes(n_nodes, seed=seed, taint_fraction=0.25)
    pods = make_pods(n_pods, seed=seed + 1, with_affinity=True,
                     with_tolerations=True, with_spread=True)
    return nodes, pods


def _port_scan_selections(cw, step):
    """tests/test_mesh.py:27 `_scan_selections`: one pod at a time through
    the step, over the workload's cards."""
    carry = _clone_carry(cw.init_carry)
    sel = []
    for i in range(cw.n_pods):
        sl = cw.xs.map(lambda x: slice_pod(x, i))
        sl["is_pad"] = torch.tensor(False)
        carry, out = step(carry, sl)
        sel.append(int(out.selected))
    return sel


def _jax_sharded_selections(nodes, pods, dp):
    cw = jmesh.shard_workload(jax_compile(nodes, pods, JCfg()), jmesh.make_mesh(8, dp=dp))
    step = jmesh.sharded_step(cw)
    carry, sel = cw.init_carry, []
    for i in range(cw.n_pods):
        sl = jax.tree.map(lambda a: a[i] if hasattr(a, "ndim") and a.ndim else a, cw.xs)
        sl["is_pad"] = jnp.asarray(False)
        carry, out = step(carry, sl)
        sel.append(int(out.selected))
    return sel


def _base_selections(nodes, pods):
    return [int(s) for s in replay(compile_workload(nodes, pods, PluginSetConfig(), device=CPU),
                                   chunk=4, device=CPU).selected]


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


# ------------------------------------------------ tests/test_mesh.py:37-119

@pytest.mark.parametrize("n,dp", MESHES, ids=IDS)
def test_sharded_step_matches_unsharded(n, dp):
    nodes, pods = _workload()
    base_sel = _base_selections(nodes, pods)
    mesh = _cards(n, dp)
    cw = shard_workload(compile_workload(nodes, pods, PluginSetConfig(), device=CPU), mesh)
    assert isinstance(cw.init_carry, kmesh.Cards) and len(cw.init_carry) == n
    assert _port_scan_selections(cw, sharded_step(cw, mesh)) == base_sel
    assert _jax_sharded_selections(nodes, pods, dp=dp) == base_sel


@pytest.mark.parametrize("dp", [1, 2])
def test_sharded_dp_mesh_matches_unsharded(dp):
    """tests/test_mesh.py:51 at 8 nodes: eight cards of one node each."""
    nodes, pods = _workload(n_nodes=8, n_pods=8, seed=81)
    base_sel = _base_selections(nodes, pods)
    mesh = _cards(8, dp)
    assert mesh.shape == {"dp": dp, "nodes": 8 // dp}
    cw = shard_workload(compile_workload(nodes, pods, PluginSetConfig(), device=CPU), mesh)
    w = 8 // mesh.shape["nodes"]
    for k, part in enumerate(cw.init_carry):
        assert part["core"].requested.shape[0] == w  # the card's slice
    # the node-to-domain rows stay whole on every card
    assert all(p["PodTopologySpread"].dom_idx.shape[-1] == 8 for p in cw.statics)
    assert _port_scan_selections(cw, sharded_step(cw, mesh)) == base_sel
    assert _jax_sharded_selections(nodes, pods, dp=dp) == base_sel


@pytest.mark.parametrize("n,dp", MESHES, ids=IDS)
def test_sharded_replay_annotations_byte_identical(n, dp):
    nodes, pods = _workload(n_nodes=24, n_pods=10, seed=83)
    base = replay(compile_workload(nodes, pods, PluginSetConfig(), device=CPU), chunk=4,
                  device=CPU)
    sharded = replay(compile_workload(nodes, pods, PluginSetConfig(), device=CPU), chunk=4,
                     device=CPU, mesh=_cards(n, dp))
    assert_same_results(sharded, base, f"{n} cards vs unsharded")
    jrr = jax_replay(jax_compile(nodes, pods, JCfg()), chunk=4, mesh=jmesh.make_mesh(8, dp=dp))
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
@pytest.mark.parametrize("n,dp", [(4, 1), (8, 2)], ids=["n4-dp1", "n8-dp2"])
def test_engine_schedules_with_mesh(spec, n, dp, monkeypatch):
    monkeypatch.setenv("KSS_TPU_SPECULATIVE", spec)
    nodes, pods = _workload(n_nodes=16, n_pods=6, seed=84)
    b0, p0, a0 = _engine_run(ObjectStore, SchedulerEngine, nodes, pods, PluginSetConfig(),
                             device=CPU)
    b1, p1, a1 = _engine_run(ObjectStore, SchedulerEngine, nodes, pods, PluginSetConfig(),
                             device=CPU, mesh=_cards(n, dp))
    assert (b1, p1) == (b0, p0)
    assert a1 == a0
    jb, jp, ja = _engine_run(JObjectStore, JEngine, nodes, pods, JCfg(),
                             mesh=jmesh.make_mesh(8, dp=dp))
    assert (b1, p1) == (jb, jp)
    assert a1 == ja


def test_engine_falls_back_on_indivisible_nodes():
    """JAX engine.py:1186-1192: a fleet the cards do not divide runs
    unsharded, with the same outcome."""
    from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

    nodes, pods = _workload(n_nodes=10, n_pods=6, seed=85)
    before = TRACER.snapshot()["counters"].get("mesh_fallback_indivisible_nodes_total", 0)
    b0, p0, a0 = _engine_run(ObjectStore, SchedulerEngine, nodes, pods, PluginSetConfig(),
                             device=CPU)
    b1, p1, a1 = _engine_run(ObjectStore, SchedulerEngine, nodes, pods, PluginSetConfig(),
                             device=CPU, mesh=_cards(4, 1))
    assert (b1, p1, a1) == (b0, p0, a0)
    after = TRACER.snapshot()["counters"].get("mesh_fallback_indivisible_nodes_total", 0)
    assert after > before


def test_make_mesh_over_cards_errors():
    """tests/test_mesh.py:109 and the card mesh's own refusals: each names
    what it refuses."""
    for kw in ({"dp": 3}, {"dp": 0}):
        with pytest.raises(ValueError) as port_err:
            make_mesh(8, device=CPU, _virtual=True, **kw)
        with pytest.raises(ValueError) as jax_err:
            jmesh.make_mesh(8, **kw)
        assert str(port_err.value) == str(jax_err.value)
    assert _cards(8, 2).shape == {"dp": 2, "nodes": 4}
    assert _cards(8, 2).virtual and len(_cards(8, 2).cards) == 8
    with pytest.raises(ValueError, match="at most 8"):
        make_mesh(16, device=CPU, _virtual=True)
    with pytest.raises(ValueError, match="cards only"):
        make_mesh(2, device=["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="only 2 present"):
        make_mesh(4, device=["cuda:0", "cuda:1"])
    with pytest.raises(ValueError, match="one device"):
        make_mesh(2, device=["cuda:0", "cuda:1"], _virtual=True)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    # a card that is not present: the error names it
    with pytest.raises(RuntimeError, match=rf"'cuda:{max(have, 1)}'\] not present"):
        make_mesh(2, device=["cuda:0", f"cuda:{max(have, 1)}"])
    # B12c: a process mesh is laid over global_devices(), which needs
    # initialize_distributed first (tests/test_torch_mesh_procs.py)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        global_devices()
    # a workload placed over one mesh is not re-placed over another
    nodes, pods = _workload(n_nodes=8, n_pods=4, seed=86)
    cw = shard_workload(compile_workload(nodes, pods, PluginSetConfig(), device=CPU), _cards(2, 1))
    with pytest.raises(ValueError, match="placed over"):
        shard_workload(cw, _cards(4, 1))
    with pytest.raises(ValueError, match="divide evenly"):
        shard_workload(compile_workload(nodes[:6], pods, PluginSetConfig(), device=CPU),
                       _cards(4, 1))


@pytest.mark.parametrize("n,dp", [(2, 1), (4, 2), (8, 2)], ids=["n2-dp1", "n4-dp2", "n8-dp2"])
def test_speculative_batch_consistent_with_step(n, dp):
    """tests/test_mesh.py:120: the batched eval over the mesh equals one
    pod at a time against the same frozen carry."""
    nodes, pods = _workload(n_nodes=8, n_pods=4, seed=82)
    cw = compile_workload(nodes, pods, PluginSetConfig(), device=CPU)
    step = build_step(cw)
    singles = [step.eval_plain(cw.init_carry, slice_pod(cw.xs, i)) for i in range(cw.n_pods)]
    mesh = _cards(n, dp)
    scw = shard_workload(cw, mesh)
    batch = _slice_xs(scw.xs, 0, 4, 4)
    batch["is_pad"] = torch.zeros(4, dtype=torch.bool)
    outs = speculative_scores(scw, mesh)(scw.init_carry, batch)
    for i, one in enumerate(singles):
        for f in ("selected", "feasible_count", "prefilter_reject"):
            assert int(getattr(outs, f)[i]) == int(getattr(one, f)), (i, f)
        torch.testing.assert_close(outs.filter_codes[i], one.filter_codes, rtol=0, atol=0)
        torch.testing.assert_close(outs.score_final[i], one.score_final, rtol=0, atol=0)


# ------------------------------------------------ tests/test_device_resident.py:165

def _mixed_workload():
    """tests/test_device_resident.py `_mixed_workload`: taints, affinity
    and toleration pods, a host score column (spread) and two
    PreFilter-rejected pods mid-queue, 16 nodes."""
    nodes = make_nodes(16, seed=3, taint_fraction=0.3)
    pods = make_pods(50, seed=4, with_affinity=True, with_tolerations=True, with_spread=True)
    for j, at in enumerate((7, 33)):
        pods.insert(at, {
            "metadata": {"name": f"pvc-pod-{j}", "namespace": "default"},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}}}],
                     "volumes": [{"name": "v", "persistentVolumeClaim": {
                         "claimName": f"missing-{j}"}}]},
        })
    for i, p in enumerate(pods):
        p["spec"]["priority"] = (i % 3) * 100
    return nodes, pods


@pytest.mark.parametrize("n", [2, 4, 8])
def test_replay_level_mesh_attribution_parity(n, monkeypatch):
    """plugin_attribution over a card-mesh device-resident replay equals
    the host tally of a host-resident replay, and the JAX package's over
    its 8-device mesh; no chunk was materialized for it."""
    nodes, pods = _mixed_workload()
    enabled = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
               "TaintToleration", "PodTopologySpread"]
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=list(enabled)), device=CPU)
    for k in ("KSS_TPU_HOST_RESIDENT", "KSS_TPU_EAGER_DECODE", "KSS_TPU_DEVICE_RESULT_BUDGET_MB"):
        monkeypatch.delenv(k, raising=False)
    rr_mesh = replay(cw, chunk=16, device=CPU, mesh=_cards(n, 1))
    att_mesh = plugin_attribution(rr_mesh)
    assert all(rr_mesh._compact.is_device(ci) for ci in range(len(rr_mesh._compact.packed)))
    monkeypatch.setenv("KSS_TPU_HOST_RESIDENT", "1")
    rr_host = replay(cw, chunk=16, device=CPU)
    assert plugin_attribution(rr_host) == att_mesh
    assert_same_results(rr_mesh, rr_host, "card mesh vs host-resident")
    monkeypatch.delenv("KSS_TPU_HOST_RESIDENT")
    from kube_scheduler_simulator_tpu.framework.replay import plugin_attribution as jatt

    jrr = jax_replay(jax_compile(nodes, pods, JCfg(enabled=list(enabled))), chunk=16,
                     mesh=jmesh.make_mesh(8, dp=1))
    assert jatt(jrr) == att_mesh


# ------------------------------------------------ the stream and the decomposition

@pytest.mark.parametrize("n,dp", [(2, 1), (4, 2), (8, 2)], ids=["n2-dp1", "n4-dp2", "n8-dp2"])
def test_stream_over_cards_matches_scan_and_jax(n, dp):
    """replay_speculative_stream over virtual cards (config 5: label-coupled,
    so dense rounds, the interaction rule's cuts and the general commit on
    every card) equals the unsharded scan and the JAX stream over its
    8-device mesh."""
    nodes, pods, cfg = baseline_config(5, scale=0.004, seed=0)
    nodes, pods = nodes[:16], pods[:20]
    cw = compile_workload(nodes, pods, cfg, device=CPU)
    base = replay(cw, chunk=8, device=CPU)
    rr, stats = pspec.replay_speculative_stream(cw, mesh=_cards(n, dp), chunk=8, pods=pods)
    assert_same_results(rr, base, f"stream over {n} cards")
    assert stats["rounds"] > 1
    from kube_scheduler_simulator_tpu.models import baseline_config as jbaseline

    jn, jp, jcfg = jbaseline(5, scale=0.004, seed=0)
    jrr, _ = jspec.replay_speculative_stream(jax_compile(jn[:16], jp[:20], jcfg),
                                             jmesh.make_mesh(8, dp=dp), chunk=8, pods=jp[:20])
    assert_same_as_jax(rr, jrr)


def test_stream_over_cards_safe_set_runs_dense():
    """A node-local plugin set, whose stream runs sparse rounds without a
    mesh, runs dense rounds over cards (parallel/speculative.py module
    doc) with the same bytes."""
    nodes, pods = _workload(n_nodes=16, n_pods=12, seed=87)
    safe = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
            "TaintToleration"]
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=safe), device=CPU)
    base = replay(cw, chunk=4, device=CPU)
    rr, _ = pspec.replay_speculative_stream(cw, mesh=_cards(4, 2), chunk=4, batch=4)
    assert_same_results(rr, base, "safe set over cards")
    scw = shard_workload(cw, _cards(4, 1))
    assert pspec._fuse_family(scw, 4, None, frozenset())[2] is False


def test_twins_hold_the_carry_per_card():
    """After a replay chunk over cards each card's carry is its slice of
    the unsharded carry, and the replicated cluster-wide carries agree on
    every card (InterPod's matched_total: config 5)."""
    nodes, pods, cfg = baseline_config(5, scale=0.004, seed=0)
    nodes, pods = nodes[:16], pods[:16]
    cw = compile_workload(nodes, pods, cfg, device=CPU)
    step = build_step(cw)
    xs = _slice_xs(cw.xs, 0, 16, 16)
    xs["is_pad"] = torch.zeros(16, dtype=torch.bool)
    want, _ = step.plain_scan(_clone_carry(cw.init_carry), xs)
    mesh = _cards(4, 2)
    scw = shard_workload(cw, mesh)
    sstep = build_step(scw)
    sxs = _slice_xs(scw.xs, 0, 16, 16)
    sxs["is_pad"] = torch.zeros(16, dtype=torch.bool)
    got, _ = sstep.scan(_clone_carry(scw.init_carry), sxs)
    w = 16 // mesh.shape["nodes"]
    for k, part in enumerate(got):
        lo = (k % mesh.shape["nodes"]) * w
        torch.testing.assert_close(part["core"].requested, want["core"].requested[lo:lo + w],
                                   rtol=0, atol=0)
        torch.testing.assert_close(part["PodTopologySpread"],
                                   want["PodTopologySpread"][:, lo:lo + w], rtol=0, atol=0)
        ic, wic = part["InterPodAffinity"], want["InterPodAffinity"]
        torch.testing.assert_close(ic.matched, wic.matched[:, lo:lo + w], rtol=0, atol=0)
        torch.testing.assert_close(ic.matched_total, wic.matched_total, rtol=0, atol=0)


def test_gather_to_host_joins_cards_in_order():
    parts = [torch.arange(6).reshape(2, 3) + 10 * k for k in range(3)]
    got = gather_to_host(parts)
    np.testing.assert_array_equal(got, torch.cat(parts, dim=-1).numpy())
    assert got.flags["C_CONTIGUOUS"]
