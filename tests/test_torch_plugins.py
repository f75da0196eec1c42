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
