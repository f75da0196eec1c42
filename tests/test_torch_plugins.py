"""Each plain plugin function of the port (B1a-B1f) against its JAX
counterpart, on the compiled state plus carries drawn from
numpy.random.default_rng(seed), handed to both sides through
kube_scheduler_simulator_tpu_torch.state.convert.from_numpy_workload.
Exact equality: every compared value is an integer or a bool.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.models.workloads import baseline_config as jax_baseline_config
from kube_scheduler_simulator_tpu.models.workloads import make_nodes, make_pods
from kube_scheduler_simulator_tpu.plugins import affinity as j_affinity
from kube_scheduler_simulator_tpu.plugins import fitscoring as j_fitscoring
from kube_scheduler_simulator_tpu.plugins import interpod as j_interpod
from kube_scheduler_simulator_tpu.plugins import noderesources as j_nr
from kube_scheduler_simulator_tpu.plugins import taints as j_taints
from kube_scheduler_simulator_tpu.plugins import topologyspread as j_spread
from kube_scheduler_simulator_tpu.plugins.base import CoreCarry as JCoreCarry
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu_torch.framework.pipeline import slice_pod
from kube_scheduler_simulator_tpu_torch.plugins import affinity, fitscoring, interpod
from kube_scheduler_simulator_tpu_torch.plugins import noderesources as nr
from kube_scheduler_simulator_tpu_torch.plugins import taints, topologyspread
from kube_scheduler_simulator_tpu_torch.state.convert import from_numpy_workload

SIX = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
       "TaintToleration", "PodTopologySpread", "InterPodAffinity"]
PODS_CHECKED = 6


def _policy_workload():
    """Config-5 shapes plus spread constraints with non-default inclusion
    policies and minDomains: the [P, MC, N] eligibility layout and
    md_unsat."""
    nodes = make_nodes(24, seed=5, taint_fraction=0.3)
    pods = make_pods(30, seed=6, with_affinity=True, with_tolerations=True,
                     with_spread=True, with_interpod=True)
    for i, pod in enumerate(pods):
        for c in pod["spec"].get("topologySpreadConstraints", []):
            if i % 3 == 0:
                c["nodeTaintsPolicy"] = "Honor"
            if i % 4 == 1:
                c["nodeAffinityPolicy"] = "Ignore"
            if i % 5 == 2 and c["whenUnsatisfiable"] == "DoNotSchedule":
                c["minDomains"] = 12
    return nodes, pods, JPluginSetConfig(enabled=list(SIX))


WORKLOADS = {
    "config5": lambda: jax_baseline_config(5, scale=0.01, seed=0),
    "tiny": lambda: (make_nodes(8, seed=3, taint_fraction=0.2),
                     make_pods(16, seed=4, with_affinity=True, with_tolerations=True,
                               with_spread=True, with_interpod=True),
                     JPluginSetConfig(enabled=list(SIX))),
    "policies": _policy_workload,
}


def _random_carry(jcw, rng):
    """A carry of the JAX package's types with numpy leaves: resource
    accumulators around the nodes' capacity (some overcommitted), pod
    counts around the 110 limit, small spread / InterPod counts."""
    alloc = np.asarray(jcw.statics["core"].allocatable)
    n, r = alloc.shape
    carry = {"core": JCoreCarry(
        requested=(alloc * rng.uniform(0.0, 1.1, size=(n, r))).astype(np.int64),
        nonzero=(alloc[:, :2] * rng.uniform(0.0, 1.1, size=(n, 2))).astype(np.int64),
        num_pods=rng.integers(0, 112, size=n).astype(np.int64))}
    if "PodTopologySpread" in jcw.init_carry:
        g = np.asarray(jcw.init_carry["PodTopologySpread"]).shape[0]
        carry["PodTopologySpread"] = rng.integers(0, 7, size=(g, n)).astype(np.int32)
    if "InterPodAffinity" in jcw.init_carry:
        t = np.asarray(jcw.init_carry["InterPodAffinity"].matched).shape[0]

        def mat(hi):
            return (rng.integers(0, hi, size=(t, n)) * (rng.random((t, n)) < 0.4)).astype(np.int32)

        carry["InterPodAffinity"] = j_interpod.InterPodCarry(
            matched=mat(4), have_req_anti=mat(2), have_req_aff=mat(2),
            sym_pref_aff=mat(150), sym_pref_anti=mat(150),
            matched_total=(rng.integers(0, 5, size=t) * (rng.random(t) < 0.5)).astype(np.int32))
    return carry


class Case:
    """One workload's state on both sides: JAX arrays and port tensors."""

    def __init__(self, name, seed=0):
        nodes, pods, cfg = WORKLOADS[name]()
        self.jcw = jax_compile(nodes, pods, cfg)
        rng = np.random.default_rng(seed)
        carry_np = _random_carry(self.jcw, rng)
        to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        self.statics, self.xs, self.carry = from_numpy_workload(
            to_np(self.jcw.statics), to_np(self.jcw.xs), carry_np, device="cpu")
        self.jstatics = self.jcw.statics
        self.jxs = self.jcw.xs
        self.jcarry = jax.tree.map(jnp.asarray, carry_np)
        self.feasible = rng.random((self.jcw.n_pods, self.jcw.n_nodes)) < 0.7
        self.sel = rng.integers(-1, self.jcw.n_nodes, size=self.jcw.n_pods).astype(np.int32)
        self.pods = sorted(set(np.linspace(0, self.jcw.n_pods - 1, PODS_CHECKED).astype(int)))

    def pod(self, i):
        return (slice_pod(self.xs, i),
                {k: jax.tree.map(lambda a: a[i], v) for k, v in self.jxs.items()})


_CASES = {}


def case(name):
    if name not in _CASES:
        _CASES[name] = Case(name)
    return _CASES[name]


_JIT = {}


def jit(fn, **static):
    """jax.jit of fn with keyword arguments bound (one compile per
    function and shape instead of one per operation)."""
    key = (fn, tuple(sorted((k, repr(v)) for k, v in static.items())))
    if key not in _JIT:
        _JIT[key] = jax.jit(lambda *a: fn(*a, **static))
    return _JIT[key]


def same(port, ref, what):
    a = port.cpu().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    b = np.asarray(ref)
    assert a.shape == b.shape, f"{what}: shape {a.shape} vs {b.shape}"
    assert np.array_equal(a.astype(np.int64), b.astype(np.int64)), f"{what}: values differ"


def same_tree(port, ref, what):
    for f in ref._fields:
        same(getattr(port, f), getattr(ref, f), f"{what}.{f}")


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_fit_filter(wl):
    c = case(wl)
    for i in c.pods:
        x, jx = c.pod(i)
        same(nr.fit_filter(c.statics["core"], x["core"], c.carry["core"]),
             jit(j_nr.fit_filter)(c.jstatics["core"], jx["core"], c.jcarry["core"]), f"pod {i}")


STRATEGIES = [
    None,
    {"scoringStrategy": {"type": "MostAllocated",
                         "resources": [{"name": "cpu", "weight": 2}, {"name": "memory", "weight": 1}]}},
    {"scoringStrategy": {"type": "RequestedToCapacityRatio",
                         "resources": [{"name": "cpu", "weight": 1}, {"name": "memory", "weight": 3},
                                       {"name": "ephemeral-storage", "weight": 1}],
                         "requestedToCapacityRatio": {"shape": [
                             {"utilization": 0, "score": 10}, {"utilization": 40, "score": 7},
                             {"utilization": 100, "score": 0}]}}},
]


@pytest.mark.parametrize("wl", list(WORKLOADS))
@pytest.mark.parametrize("args", STRATEGIES, ids=["least", "most", "rtcr"])
def test_fit_score(wl, args):
    c = case(wl)
    st, jst = fitscoring.parse_fit_strategy(args), j_fitscoring.parse_fit_strategy(args)
    for i in c.pods:
        x, jx = c.pod(i)
        same(nr.fit_score(c.statics["core"], x["core"], c.carry["core"], strategy=st,
                          schema=c.jcw.schema),
             jit(j_nr.fit_score, strategy=jst, schema=c.jcw.schema)(
                 c.jstatics["core"], jx["core"], c.jcarry["core"]), f"pod {i}")


@pytest.mark.parametrize("wl", list(WORKLOADS))
@pytest.mark.parametrize("resources", [("cpu", "memory"), ("cpu", "memory", "ephemeral-storage")],
                         ids=["two", "three"])
def test_balanced_score(wl, resources):
    c = case(wl)
    for i in c.pods:
        x, jx = c.pod(i)
        same(nr.balanced_score(c.statics["core"], x["core"], c.carry["core"],
                               resources=resources, schema=c.jcw.schema),
             jit(j_nr.balanced_score, resources=resources, schema=c.jcw.schema)(
                 c.jstatics["core"], jx["core"], c.jcarry["core"]), f"pod {i}")


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_core_bind_update(wl):
    c = case(wl)
    for i in c.pods:
        x, jx = c.pod(i)
        sel = int(c.sel[i])
        same_tree(nr.core_bind_update(c.carry["core"], x["core"], torch.tensor(sel, dtype=torch.int32)),
                  jit(j_nr.core_bind_update)(c.jcarry["core"], jx["core"], jnp.int32(sel)), f"pod {i}")


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_affinity(wl):
    c = case(wl)
    for i in c.pods:
        x, jx = c.pod(i)
        st, jst = c.statics["NodeAffinity"], c.jstatics["NodeAffinity"]
        same(affinity.filter_kernel(st, x["NodeAffinity"]),
             jit(j_affinity.filter_kernel)(jst, jx["NodeAffinity"]), f"filter pod {i}")
        raw = affinity.score_kernel(st, x["NodeAffinity"])
        jraw = jit(j_affinity.score_kernel)(jst, jx["NodeAffinity"])
        same(raw, jraw, f"score pod {i}")
        feas = c.feasible[i]
        same(affinity.normalize(raw, torch.from_numpy(feas)),
             jit(j_affinity.normalize)(jraw, jnp.asarray(feas)), f"normalize pod {i}")


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_taints(wl):
    c = case(wl)
    for i in c.pods:
        x, jx = c.pod(i)
        same(taints.taint_filter(x["TaintToleration"]),
             jit(j_taints.taint_filter)(jx["TaintToleration"]), f"filter pod {i}")
        raw = taints.taint_score(x["TaintToleration"])
        jraw = jit(j_taints.taint_score)(jx["TaintToleration"])
        same(raw, jraw, f"score pod {i}")
        for feas in (c.feasible[i], np.zeros_like(c.feasible[i])):
            same(taints.taint_normalize(raw, torch.from_numpy(feas)),
                 jit(j_taints.taint_normalize)(jraw, jnp.asarray(feas)), f"normalize pod {i}")


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_topologyspread(wl):
    c = case(wl)
    st, jst = c.statics["PodTopologySpread"], c.jstatics["PodTopologySpread"]
    counts, jcounts = c.carry["PodTopologySpread"], c.jcarry["PodTopologySpread"]
    for i in c.pods:
        x, jx = c.pod(i)
        x, jx = x["PodTopologySpread"], jx["PodTopologySpread"]
        for m in range(topologyspread.MAX_CONSTRAINTS):
            for a, b in zip(topologyspread._per_constraint(st, x, counts, m),
                            jit(j_spread._per_constraint, m=m)(jst, jx, jcounts)):
                same(a, b, f"_per_constraint pod {i} slot {m}")
        same(topologyspread.filter_kernel(st, x, counts),
             jit(j_spread.filter_kernel)(jst, jx, jcounts), f"filter pod {i}")
        raw, ign = topologyspread.score_kernel(st, x, counts)
        jraw, jign = jit(j_spread.score_kernel)(jst, jx, jcounts)
        same(raw, jraw, f"score pod {i}")
        same(ign, jign, f"ignored pod {i}")
        feas = c.feasible[i]
        same(topologyspread.normalize(raw, ign, torch.from_numpy(feas)),
             jit(j_spread.normalize)(jraw, jign, jnp.asarray(feas)), f"normalize pod {i}")
        sel = int(c.sel[i])
        same(topologyspread.bind_update(st, x, counts, torch.tensor(sel, dtype=torch.int32)),
             jit(j_spread.bind_update)(jst, jx, jcounts, jnp.int32(sel)), f"bind pod {i}")


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_interpod(wl):
    c = case(wl)
    st, jst = c.statics["InterPodAffinity"], c.jstatics["InterPodAffinity"]
    carry, jcarry = c.carry["InterPodAffinity"], c.jcarry["InterPodAffinity"]
    for i in c.pods:
        x, jx = c.pod(i)
        x, jx = x["InterPodAffinity"], jx["InterPodAffinity"]
        same(interpod.filter_kernel(st, x, carry),
             jit(j_interpod.filter_kernel)(jst, jx, jcarry), f"filter pod {i}")
        raw = interpod.score_kernel(st, x, carry)
        jraw = jit(j_interpod.score_kernel)(jst, jx, jcarry)
        same(raw, jraw, f"score pod {i}")
        feas = c.feasible[i]
        same(interpod.normalize(raw, torch.from_numpy(feas)),
             jit(j_interpod.normalize)(jraw, jnp.asarray(feas)), f"normalize pod {i}")
        sel = int(c.sel[i])
        same_tree(interpod.bind_update(st, x, carry, torch.tensor(sel, dtype=torch.int32)),
                  jit(j_interpod.bind_update)(jst, jx, jcarry, jnp.int32(sel)), f"bind pod {i}")


def test_interpod_self_match_escape():
    """The escape reads the cluster-wide matched_total: with it zero a
    pod that matches its own required affinity terms passes at keyed
    nodes; with any match elsewhere in the cluster it fails."""
    c = case("config5")
    st, jst = c.statics["InterPodAffinity"], c.jstatics["InterPodAffinity"]
    x, jx = c.pod(0)
    x, jx = copy.copy(x["InterPodAffinity"]), jx["InterPodAffinity"]
    t = x.h_req_aff.shape[0]
    h = np.zeros(t, np.int32)
    h[0] = 1
    x = x._replace(h_req_aff=torch.from_numpy(h), self_ok=torch.tensor(True))
    jx = jx._replace(h_req_aff=jnp.asarray(h), self_ok=jnp.asarray(True))
    carry, jcarry = c.carry["InterPodAffinity"], c.jcarry["InterPodAffinity"]
    for total in (0, 3):
        mt = np.asarray(jcarry.matched_total).copy()
        mt[0] = total
        zeros = np.zeros_like(np.asarray(jcarry.matched))
        pc = carry._replace(matched=torch.from_numpy(zeros), have_req_anti=torch.from_numpy(zeros),
                            matched_total=torch.from_numpy(mt))
        jc = jcarry._replace(matched=jnp.asarray(zeros), have_req_anti=jnp.asarray(zeros),
                             matched_total=jnp.asarray(mt))
        code = interpod.filter_kernel(st, x, pc)
        same(code, j_interpod.filter_kernel(jst, jx, jc), f"matched_total {total}")
        keyed = np.asarray(jst.dom_idx)[0] >= 0
        assert (code.numpy()[keyed] == (0 if total == 0 else 1)).all()


# ------------------------------------------------ the default profile's further plugins (B9)

def _default_profile_workload():
    """BASELINE config 5 at 200 pods x 100 nodes decorated as chip_smoke.py
    decorates its fleet, plus inline disks (GCE, read-only GCE, EBS) and
    pods with two unbound claims, so every B9 function has work."""
    import chip_smoke

    nodes, pods, _ = jax_baseline_config(5, scale=0.02, seed=0)
    volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=0)
    disks = [{"gcePersistentDisk": {"pdName": "pd-1"}},
             {"gcePersistentDisk": {"pdName": "pd-1", "readOnly": True}},
             {"awsElasticBlockStore": {"volumeID": "ebs-1", "readOnly": True}},
             {"gcePersistentDisk": {"pdName": "pd-2"}}]
    for i in range(12):
        pods[3 * i]["spec"].setdefault("volumes", []).append({"name": "disk", **disks[i % 4]})
    claimants = [p for p in pods
                 if any((v.get("persistentVolumeClaim") or {}).get("claimName", "")
                        .startswith("claim-") for v in p["spec"].get("volumes", []))]
    for i, p in enumerate(claimants[:4]):
        name = f"second-{i}"
        volumes["pvcs"].append({"metadata": {"name": name, "namespace": "default"},
                                "spec": {"storageClassName": "wffc",
                                         "accessModes": ["ReadWriteOnce"],
                                         "resources": {"requests": {"storage": str(2 << 30)}}}})
        p["spec"]["volumes"].append({"name": name, "persistentVolumeClaim": {"claimName": name}})
    return jax_compile(nodes, pods, JPluginSetConfig(), bound_pods=bound, volumes=volumes)


class DefaultCase:
    """The default profile's state on both sides, with its B9 carries drawn
    from numpy.random.default_rng(seed)."""

    def __init__(self, seed=0):
        self.jcw = _default_profile_workload()
        rng = np.random.default_rng(seed)
        to_np = lambda tree: jax.tree.map(np.asarray, tree)  # noqa: E731
        init = to_np(self.jcw.init_carry)
        carry_np = dict(init)
        bools = lambda a, p: rng.random(np.shape(a)) < p  # noqa: E731
        carry_np["NodePorts"] = type(init["NodePorts"])(
            *[bools(a, 0.2) for a in init["NodePorts"]])
        carry_np["NodeVolumeLimits"] = type(init["NodeVolumeLimits"])(
            on_node=bools(init["NodeVolumeLimits"].on_node, 0.3))
        carry_np["VolumeRestrictions"] = type(init["VolumeRestrictions"])(
            *[bools(a, 0.3) for a in init["VolumeRestrictions"]])
        carry_np["VolumeBinding"] = type(init["VolumeBinding"])(
            claimed=bools(init["VolumeBinding"].claimed, 0.4))
        self.statics, self.xs, self.carry = from_numpy_workload(
            to_np(self.jcw.statics), to_np(self.jcw.xs), carry_np, device="cpu")
        self.jstatics, self.jxs = self.jcw.statics, self.jcw.xs
        self.jcarry = jax.tree.map(jnp.asarray, carry_np)
        p, n = self.jcw.n_pods, self.jcw.n_nodes
        self.sel = rng.integers(-1, n, size=p).astype(np.int32)
        # the pods each function has work for, plus a spread of the rest
        self.pods = sorted(set(np.linspace(0, p - 1, PODS_CHECKED).astype(int)))

    def pods_with(self, name, field):
        rows = np.asarray(getattr(self.jxs[name], field)).reshape(self.jcw.n_pods, -1)
        hit = np.flatnonzero(rows.any(axis=1))
        return sorted(set(self.pods) | set(hit[:8].tolist()))

    def pod(self, i):
        return (slice_pod(self.xs, i),
                {k: jax.tree.map(lambda a: a[i], v) for k, v in self.jxs.items()})


_DEFAULT = {}


def default_case():
    if not _DEFAULT:
        _DEFAULT["case"] = DefaultCase()
    return _DEFAULT["case"]


def test_b9_plain_functions_cover_the_workload():
    c = default_case()
    assert c.jcw.config.filters() == [
        "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity", "NodePorts",
        "NodeResourcesFit", "VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding",
        "VolumeZone", "PodTopologySpread", "InterPodAffinity"]
    assert np.asarray(c.jxs["VolumeBinding"].active).sum(axis=1).max() == 2
    assert np.asarray(c.jxs["VolumeRestrictions"].w_any).any()
    assert np.asarray(c.jxs["NodeVolumeLimits"].pod_vols).any()
    assert np.asarray(c.jxs["NodePorts"].w_spec).any()


@pytest.mark.parametrize("name", ["NodeUnschedulable", "NodeName"])
def test_unsched_and_nodename_filters(name):
    c = default_case()
    port_fn = {"NodeUnschedulable": taints.unsched_filter, "NodeName": taints.nodename_filter}
    jax_fn = {"NodeUnschedulable": j_taints.unsched_filter,
              "NodeName": j_taints.nodename_filter}
    for i in c.pods_with(name, "fail"):
        x, jx = c.pod(i)
        same(port_fn[name](x[name]), jit(jax_fn[name])(jx[name]), f"{name} pod {i}")


def test_ports():
    from kube_scheduler_simulator_tpu.plugins import ports as j_ports
    from kube_scheduler_simulator_tpu_torch.plugins import ports

    c = default_case()
    st, jst = c.statics["NodePorts"], c.jstatics["NodePorts"]
    carry, jcarry = c.carry["NodePorts"], c.jcarry["NodePorts"]
    for i in c.pods_with("NodePorts", "w_any"):
        x, jx = c.pod(i)
        x, jx = x["NodePorts"], jx["NodePorts"]
        same(ports.filter_kernel(st, x, carry), jit(j_ports.filter_kernel)(jst, jx, jcarry),
             f"filter pod {i}")
        sel = int(c.sel[i])
        same_tree(ports.bind_update(st, x, carry, torch.tensor(sel, dtype=torch.int32)),
                  jit(j_ports.bind_update)(jst, jx, jcarry, jnp.int32(sel)), f"bind pod {i}")


def test_imagelocality():
    from kube_scheduler_simulator_tpu.plugins import imagelocality as j_image
    from kube_scheduler_simulator_tpu_torch.plugins import imagelocality

    c = default_case()
    rows = c.jcw.host["static_score_rows"]["ImageLocality"]
    assert rows.any()
    for i in c.pods_with("ImageLocality", "score"):
        x, jx = c.pod(i)
        same(imagelocality.score_kernel(x["ImageLocality"]),
             jit(j_image.score_kernel)(jx["ImageLocality"]), f"score pod {i}")


def test_imagelocality_build_matches_jax():
    """The port's `build` (one row per distinct image set, numpy
    arithmetic) against the JAX package's per-node Python loop."""
    from kube_scheduler_simulator_tpu.plugins import imagelocality as j_image
    import chip_smoke
    from kube_scheduler_simulator_tpu_torch.plugins import imagelocality

    nodes, pods, _ = jax_baseline_config(5, scale=0.02, seed=3)
    chip_smoke.decorate_default_profile(nodes, pods, seed=3, volumes_on=False)
    pods[0]["spec"]["initContainers"] = [{"name": "init", "image": nodes[0]["status"]["images"][0]["names"][0]}]
    same(imagelocality.build(nodes, pods).score, j_image.build(nodes, pods).score, "score rows")


def test_volumezone():
    from kube_scheduler_simulator_tpu.plugins import volumezone as j_zone
    from kube_scheduler_simulator_tpu_torch.plugins import volumezone

    c = default_case()
    for i in c.pods_with("VolumeZone", "codes"):
        x, jx = c.pod(i)
        same(volumezone.filter_kernel(x["VolumeZone"]),
             jit(j_zone.filter_kernel)(jx["VolumeZone"]), f"filter pod {i}")


def test_nodevolumelimits():
    from kube_scheduler_simulator_tpu.plugins import nodevolumelimits as j_nvl
    from kube_scheduler_simulator_tpu_torch.plugins import nodevolumelimits

    c = default_case()
    st, jst = c.statics["NodeVolumeLimits"], c.jstatics["NodeVolumeLimits"]
    carry, jcarry = c.carry["NodeVolumeLimits"], c.jcarry["NodeVolumeLimits"]
    for i in c.pods_with("NodeVolumeLimits", "pod_vols"):
        x, jx = c.pod(i)
        x, jx = x["NodeVolumeLimits"], jx["NodeVolumeLimits"]
        same(nodevolumelimits.filter_kernel(st, x, carry),
             jit(j_nvl.filter_kernel)(jst, jx, jcarry), f"filter pod {i}")
        sel = int(c.sel[i])
        same_tree(nodevolumelimits.bind_update(x, carry, torch.tensor(sel, dtype=torch.int32)),
                  jit(j_nvl.bind_update)(jx, jcarry, jnp.int32(sel)), f"bind pod {i}")


def test_volumerestrictions():
    from kube_scheduler_simulator_tpu.plugins import volumerestrictions as j_vr
    from kube_scheduler_simulator_tpu_torch.plugins import volumerestrictions

    c = default_case()
    st, jst = c.statics["VolumeRestrictions"], c.jstatics["VolumeRestrictions"]
    carry, jcarry = c.carry["VolumeRestrictions"], c.jcarry["VolumeRestrictions"]
    pods = sorted(set(c.pods_with("VolumeRestrictions", "w_any"))
                  | set(c.pods_with("VolumeRestrictions", "rwop")))
    for i in pods:
        x, jx = c.pod(i)
        x, jx = x["VolumeRestrictions"], jx["VolumeRestrictions"]
        same(volumerestrictions.prefilter_reject(x, carry),
             jit(j_vr.prefilter_reject)(jx, jcarry), f"prefilter_reject pod {i}")
        same(volumerestrictions.filter_kernel(st, x, carry),
             jit(j_vr.filter_kernel)(jst, jx, jcarry), f"filter pod {i}")
        sel = int(c.sel[i])
        same_tree(volumerestrictions.bind_update(x, carry, torch.tensor(sel, dtype=torch.int32)),
                  jit(j_vr.bind_update)(jx, jcarry, jnp.int32(sel)), f"bind pod {i}")


def test_volumebinding():
    from kube_scheduler_simulator_tpu.plugins import volumebinding as j_vb
    from kube_scheduler_simulator_tpu_torch.plugins import volumebinding

    c = default_case()
    st, jst = c.statics["VolumeBinding"], c.jstatics["VolumeBinding"]
    carry, jcarry = c.carry["VolumeBinding"], c.jcarry["VolumeBinding"]
    for i in c.pods_with("VolumeBinding", "active"):
        x, jx = c.pod(i)
        x, jx = x["VolumeBinding"], jx["VolumeBinding"]
        fail, chosen = volumebinding._greedy_choices(st, x, carry.claimed)
        jfail, jchosen = jit(j_vb._greedy_choices)(jst, jx, jcarry.claimed)
        same(fail, jfail, f"greedy bindfail pod {i}")
        same(chosen, jchosen, f"greedy chosen pod {i}")
        same(volumebinding.filter_kernel(st, x, carry),
             jit(j_vb.filter_kernel)(jst, jx, jcarry), f"filter pod {i}")
        for sel in (int(c.sel[i]), -1, int(np.argmin(np.asarray(jfail)))):
            same_tree(volumebinding.bind_update(st, x, carry, torch.tensor(sel, dtype=torch.int32)),
                      jit(j_vb.bind_update)(jst, jx, jcarry, jnp.int32(sel)), f"bind pod {i} {sel}")
    n = c.jcw.n_nodes
    same(volumebinding.score_kernel(n, "cpu"), j_vb.score_kernel(n), "score")
