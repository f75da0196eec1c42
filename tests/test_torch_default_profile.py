"""The scheduler's default profile through the port, against the JAX
package and the scalar oracle.

* The whole default lineup (14 Filter/Score plugins, the volume family
  included) on the randomized fleets of tests/test_parity.py:55
  `test_full_plugin_set_fuzz_parity`, seeds 11, 23 and 47.
* `PluginSetConfig()` (all 16 default names) on a BASELINE config-5 fleet
  at test scale, decorated as chip_smoke.py decorates the full-size one
  (unschedulable nodes, node images, hostPorts, nodeName pins, WFFC
  claims on zone-affine PVs, zone-labelled bound PVs, ReadWriteOncePod
  pairs, CSI volumes under a CSINode limit, missing claims).
* The SAFE-set speculative stream (the eight node-local plugins, hostPorts
  and images on) against the JAX package's `replay_speculative_stream`,
  stats dict included.

Every comparison is exact: selected nodes, feasible counts, PreFilter
rejects and the 13 annotation blobs of every pod.
"""

import contextlib
import os

import numpy as np
import pytest

import chip_smoke
from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.models.workloads import make_nodes, make_pods
from kube_scheduler_simulator_tpu.parallel import speculative as jspec
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.reference_impl.sequential import SequentialScheduler
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework import replay
from kube_scheduler_simulator_tpu_torch.models import baseline_config, make_slot_pinned_workload
from kube_scheduler_simulator_tpu_torch.parallel import speculative as pspec
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result

LINEUP = [
    "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity",
    "NodePorts", "NodeResourcesFit", "VolumeRestrictions", "VolumeZone",
    "NodeVolumeLimits", "VolumeBinding", "PodTopologySpread",
    "InterPodAffinity", "NodeResourcesBalancedAllocation", "ImageLocality",
]


def assert_three_way(rr, jrr, seq):
    assert len(seq) == rr.cw.n_pods
    for i, (seq_ann, seq_sel) in enumerate(seq):
        assert int(rr.selected[i]) == int(jrr.selected[i]) == seq_sel, f"pod {i}: selected"
        assert int(rr.feasible_count[i]) == int(jrr.feasible_count[i]), f"pod {i}: feasible"
        assert int(rr.prefilter_reject[i]) == int(jrr.prefilter_reject[i]), f"pod {i}: reject"
        a, ja = decode_pod_result(rr, i), jax_decode(jrr, i)
        for key in ALL_PLUGIN_KEYS:
            assert a[key] == ja[key], f"pod {i} {key}: port vs JAX\n{a[key][:300]}\n{ja[key][:300]}"
            assert a[key] == seq_ann[key], f"pod {i} {key}: port vs oracle"


def _fuzz_fleet(seed):
    """tests/test_parity.py:55's workload, manifest for manifest."""
    rng = np.random.default_rng(seed)
    nodes = make_nodes(16, seed=seed, taint_fraction=0.3)
    pods = make_pods(24, seed=seed + 1, with_affinity=True, with_tolerations=True,
                     with_spread=True, with_interpod=True)
    for p in pods:
        if rng.random() < 0.2:
            p["spec"]["containers"][0]["ports"] = [
                {"hostPort": int(rng.integers(30000, 30006))}]
        if rng.random() < 0.05:
            p["spec"]["nodeName"] = f"node-{int(rng.integers(16)):05d}"
    scs = [{"metadata": {"name": "standard"},
            "provisioner": "x", "volumeBindingMode": "WaitForFirstConsumer"}]
    pvcs, pvs = [], []
    for i in range(6):
        pvcs.append({"metadata": {"name": f"claim-{i}", "namespace": "default",
                                  "uid": f"uid-{i}"},
                     "spec": {"storageClassName": "standard",
                              "accessModes": ["ReadWriteOnce"],
                              "resources": {"requests": {"storage": "1Gi"}}}})
        pvs.append({"metadata": {"name": f"pv-{i}"},
                    "spec": {"capacity": {"storage": "2Gi"},
                             "accessModes": ["ReadWriteOnce"],
                             "storageClassName": "standard"}})
    for i, p in enumerate(pods[:6]):
        p["spec"]["volumes"] = [{"name": "v",
                                 "persistentVolumeClaim": {"claimName": f"claim-{i}"}}]
    return nodes, pods, {"pvcs": pvcs, "pvs": pvs, "storageclasses": scs}


@pytest.mark.parametrize("seed", [11, 23, 47])
def test_full_plugin_set_fuzz_parity(seed):
    nodes, pods, volumes = _fuzz_fleet(seed)
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=list(LINEUP)),
                          volumes=volumes, device="cpu")
    assert len(cw.config.filters()) == 12 and len(cw.config.scorers()) == 8
    rr = replay(cw, chunk=8, device="cpu")
    jcfg = JPluginSetConfig(enabled=list(LINEUP))
    jrr = jax_replay(jax_compile(nodes, pods, jcfg, volumes=volumes), chunk=8)
    seq = SequentialScheduler(nodes, pods, jcfg, volumes=volumes).schedule_all()
    assert_three_way(rr, jrr, seq)


def test_default_config_lineup_matches_jax():
    """PluginSetConfig() names the JAX package's plugins at every point,
    in the same order, with the same weights."""
    cfg, jcfg = PluginSetConfig(), JPluginSetConfig()
    for point in ("active_plugins", "filters", "scorers", "prefilters", "prescorers",
                  "preenqueues", "postfilters"):
        assert getattr(cfg, point)() == getattr(jcfg, point)(), point
    assert [cfg.weight(n) for n in cfg.scorers()] == [jcfg.weight(n) for n in jcfg.scorers()]
    assert len(cfg.enabled) == 16 and len(cfg.filters()) == 12


_FLEET = {}


def default_fleet():
    """BASELINE config 5 at 200 pods x 100 nodes, decorated for the default
    profile -> (nodes, pods, volumes, bound pods)."""
    if not _FLEET:
        nodes, pods, _ = baseline_config(5, scale=0.02, seed=0)
        volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=0)
        _FLEET["fleet"] = (nodes, pods, volumes, bound)
    return _FLEET["fleet"]


def test_default_profile_fleet_matches_jax_and_oracle():
    nodes, pods, volumes, bound = default_fleet()
    cw = compile_workload(nodes, pods, PluginSetConfig(), volumes=volumes, bound_pods=bound,
                          device="cpu")
    rr = replay(cw, chunk=64, device="cpu")
    jrr = jax_replay(jax_compile(nodes, pods, JPluginSetConfig(), volumes=volumes,
                                 bound_pods=bound), chunk=64)
    seq = SequentialScheduler(nodes, pods, JPluginSetConfig(), bound_pods=bound,
                              volumes=volumes).schedule_all()
    assert_three_way(rr, jrr, seq)
    # the fleet reaches every kind chip_smoke.py samples
    codes = rr.filter_codes
    col = {name: k for k, name in enumerate(cw.config.filters())}
    assert (rr.prefilter_reject & 1).any() and (rr.prefilter_reject & 2).any()
    assert (codes[:, col["NodePorts"]] != 0).any()
    assert ((codes[:, col["VolumeBinding"]] & 2) != 0).any()
    assert (codes[:, col["NodeVolumeLimits"]] != 0).any()
    assert (codes[:, col["VolumeZone"]] != 0).any()
    assert (codes[:, col["NodeUnschedulable"]] != 0).any()


def test_default_profile_chunking_invariant():
    """The chunk size is no part of the result: chunk 7 (padded chunks,
    carries across many launches) equals one chunk of the whole queue."""
    nodes, pods, volumes, bound = default_fleet()
    cw = compile_workload(nodes, pods, PluginSetConfig(), volumes=volumes, bound_pods=bound,
                          device="cpu")
    a, b = replay(cw, chunk=7, device="cpu"), replay(cw, chunk=cw.n_pods, device="cpu")
    assert (a.selected == b.selected).all()
    assert (a.prefilter_reject == b.prefilter_reject).all()
    assert (a.filter_codes == b.filter_codes).all()
    assert (a.score_raw == b.score_raw).all()


def test_default_profile_refused_by_speculation():
    """The volume family stays on the scan, as in the JAX package."""
    for enabled in (None, LINEUP, pspec.SAFE_SPECULATIVE | {"VolumeZone"}):
        cfg = PluginSetConfig(enabled=sorted(enabled)) if enabled else PluginSetConfig()
        jcfg = JPluginSetConfig(enabled=sorted(enabled)) if enabled else JPluginSetConfig()
        assert pspec.speculation_ok(cfg) is jspec.speculation_ok(jcfg) is False
    safe = sorted(pspec.SAFE_SPECULATIVE)
    assert pspec.speculation_ok(PluginSetConfig(enabled=safe))
    assert jspec.speculation_ok(JPluginSetConfig(enabled=safe))


@contextlib.contextmanager
def host_resident():
    old = os.environ.get("KSS_TPU_HOST_RESIDENT")
    os.environ["KSS_TPU_HOST_RESIDENT"] = "1"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("KSS_TPU_HOST_RESIDENT", None)
        else:
            os.environ["KSS_TPU_HOST_RESIDENT"] = old


def _safe_slot():
    nodes, pods = make_slot_pinned_workload(96, 48, seed=3)
    chip_smoke.decorate_default_profile(nodes, pods, seed=3, volumes_on=False)
    return nodes, pods


def _safe_contended():
    # tight nodes and many hostPorts: rounds roll back, dense rounds run
    nodes = make_nodes(12, seed=21, taint_fraction=0.2)
    pods = make_pods(80, seed=22, with_affinity=True, with_tolerations=True)
    chip_smoke.decorate_default_profile(nodes, pods, seed=21, volumes_on=False)
    for i, p in enumerate(pods):
        if i % 3 == 0:
            p["spec"]["containers"][0]["ports"] = [{"hostPort": 30000 + i % 4}]
    return nodes, pods


# (fleet, keywords, direct): direct runs replay_speculative, every pod
# through a round (no scan fallback)
SAFE_STREAMS = {"slot": (_safe_slot, {"chunk": 32}, False),
                "contended": (_safe_contended, {"chunk": 16}, False),
                "contended_direct": (_safe_contended, {"batch": 8}, True)}


@pytest.mark.parametrize("name", sorted(SAFE_STREAMS))
def test_safe_set_stream_matches_jax(name):
    build, kw, direct = SAFE_STREAMS[name]
    nodes, pods = build()
    safe = sorted(pspec.SAFE_SPECULATIVE)
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=safe), device="cpu")
    jcw = jax_compile(nodes, pods, JPluginSetConfig(enabled=safe))
    with host_resident():
        if direct:
            rr, stats = pspec.replay_speculative(cw, **kw)
            jrr, jstats = jspec.replay_speculative(jcw, None, **kw)
        else:
            rr, stats = pspec.replay_speculative_stream(cw, **kw)
            jrr, jstats = jspec.replay_speculative_stream(jcw, **kw)
    assert stats == jstats
    assert stats["rounds"] > 0 and "NodePorts" in cw.init_carry
    for field in ("selected", "feasible_count", "prefilter_reject"):
        assert (getattr(rr, field) == getattr(jrr, field)).all(), field
    for group in ("packed", "raw8", "raw16", "raw32"):
        assert len(getattr(rr._compact, group)) == len(getattr(jrr._compact, group)), group
        for ci in range(len(getattr(rr._compact, group))):
            a, b = rr._compact.host(group, ci), jrr._compact.host(group, ci)
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{group} chunk {ci}"
    for i in range(cw.n_pods):
        assert decode_pod_result(rr, i) == jax_decode(jrr, i), f"pod {i}"
    # and the stream equals the port's own scan
    base = replay(cw, chunk=kw.get("chunk", 512), device="cpu")
    assert (base.selected == rr.selected).all()
