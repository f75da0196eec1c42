"""DefaultPreemption: the PostFilter extension point.

A copy of kube_scheduler_simulator_tpu/framework/preemption.py, host code with its
imports rewired to the port.

Capability parity with upstream DefaultPreemption as recorded by the
reference simulator (reference: simulator/scheduler/plugin/wrappedplugin.go
:550-583 records PostFilter; resultstore/store.go:439-458 stores
"preemption victim" at the nominated node and an empty entry for every
other evaluated node).  Algorithm follows upstream
pkg/scheduler/framework/plugins/defaultpreemption (v1.32):

  1. eligibility: preemptionPolicy "Never" never preempts;
  2. candidate nodes: only nodes whose Filter rejection is *resolvable* by
     removing pods — i.e. the first failing plugin is one whose verdict
     depends on the pods already on the node (NodeResourcesFit,
     PodTopologySpread, InterPodAffinity, and NodePorts).  Nodes rejected
     by node-property plugins (NodeName, NodeUnschedulable, NodeAffinity,
     TaintToleration) are UnschedulableAndUnresolvable upstream and are
     skipped;
  3. per candidate node: dry-run with ALL lower-priority pods removed; if
     the pod then fits, reprieve victims most-important-first (priority
     desc, earlier creation first), keeping each one that still lets the
     pod fit — the rest are the victim set;
  4. candidate selection (upstream pickOneNodeForPreemption): fewest PDB
     violations first (PodDisruptionBudgets are storable even though they
     are outside the 7 synced GVRs — the real scheduler honors any PDBs
     present), then lowest highest-victim priority, then smallest
     priority sum, then fewest victims, then latest
     highest-priority-victim creation, then node order;
  5. execution: delete the victims, set the preemptor's
     status.nominatedNodeName.

The dry-run oracle re-runs the *same tensor kernels* as live scheduling
(compile_workload over the cluster minus the removed pods, one-pod
replay), so preemption verdicts can never drift from filter semantics.

Documented divergences from upstream (also in docs/SEMANTICS.md):
candidate search starts at node 0 instead of a random offset, and the
terminating-victims eligibility check is skipped (the cluster model has
no graceful deletion).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

# Plugins whose Filter rejection upstream reports as Unschedulable (the
# preemptible status); all other tensorized filters return
# UnschedulableAndUnresolvable upstream.
RESOLVABLE_PLUGINS = {
    "NodeResourcesFit",
    "PodTopologySpread",
    "InterPodAffinity",
    "NodePorts",
    # removing pods can free inline disks / CSI attachment slots
    "VolumeRestrictions",
    "NodeVolumeLimits",
}

# upstream DefaultPreemptionArgs defaults
MIN_CANDIDATE_NODES_PERCENTAGE = 10
MIN_CANDIDATE_NODES_ABSOLUTE = 100

PLUGIN_NAME = "DefaultPreemption"


@dataclass
class PreemptionOutcome:
    nominated_node: str = ""            # "" == preemption failed
    victims: list[dict] = field(default_factory=list)
    evaluated_nodes: list[str] = field(default_factory=list)


def _priority(pod: dict) -> int:
    return int((pod.get("spec") or {}).get("priority") or 0)


def _creation(pod: dict) -> str:
    """Victim age for the tie-break ladder: upstream GetPodStartTime uses
    status.startTime when the kubelet set one, else creationTimestamp."""
    start = (pod.get("status") or {}).get("startTime")
    return start or (pod.get("metadata") or {}).get("creationTimestamp") or ""


def _pod_key(pod: dict) -> str:
    meta = pod.get("metadata") or {}
    return f"{meta.get('namespace') or 'default'}/{meta.get('name', '')}"


def _num_candidates(n_nodes: int,
                    pct: int = MIN_CANDIDATE_NODES_PERCENTAGE,
                    abs_: int = MIN_CANDIDATE_NODES_ABSOLUTE) -> int:
    n = max(n_nodes * pct // 100, abs_)
    return min(n, n_nodes)


def filter_pods_with_pdb_violation(pods: list[dict], pdbs: list[dict]
                                   ) -> tuple[list[dict], list[dict]]:
    """(violating, non-violating) split, upstream
    filterPodsWithPDBViolation semantics: each pod decrements every
    matching PDB's remaining disruptionsAllowed; once a budget goes
    negative, further matching pods (and that one) are violating."""
    from ..state.selectors import label_selector_matches

    allowed = [
        int(((pdb.get("status") or {}).get("disruptionsAllowed")) or 0)
        for pdb in pdbs
    ]
    violating, ok = [], []
    for pod in pods:
        meta = pod.get("metadata") or {}
        ns = meta.get("namespace") or "default"
        labels = {k: str(v) for k, v in (meta.get("labels") or {}).items()}
        is_violating = False
        for i, pdb in enumerate(pdbs):
            pdb_ns = (pdb.get("metadata") or {}).get("namespace") or "default"
            if pdb_ns != ns:
                continue
            selector = (pdb.get("spec") or {}).get("selector")
            # upstream filterPodsWithPDBViolation: "A PDB with a nil or
            # empty selector can't match anything" (unlike the eviction
            # API, where {} selects the namespace)
            if (not selector
                    or (not selector.get("matchLabels")
                        and not selector.get("matchExpressions"))
                    or not label_selector_matches(selector, labels)):
                continue
            allowed[i] -= 1
            if allowed[i] < 0:
                is_violating = True
        (violating if is_violating else ok).append(pod)
    return violating, ok


def first_fail_plugins(codes: np.ndarray, active_names: list[str]) -> list[str | None]:
    """Per node, the first filter plugin (upstream order) that rejected it,
    or None if the node passed.  codes: [F, N] over the ACTIVE filters."""
    out: list[str | None] = []
    n_nodes = codes.shape[1] if codes.ndim == 2 else 0
    for n in range(n_nodes):
        hit = None
        for f, name in enumerate(active_names):
            if codes[f, n] != 0:
                hit = name
                break
        out.append(hit)
    return out


class Preemptor:
    """Runs preemption for one unschedulable pod against live store state."""

    def __init__(self, store, plugin_config, extender_service=None,
                 device="cuda"):
        self.store = store
        self.plugin_config = plugin_config
        # where the fit hypotheses compile and replay (the engine's device)
        self.device = device
        # webhook extenders with a preemptVerb participate in candidate
        # selection (upstream preemption callExtenders; the reference
        # proxies + records the round-trip, extender/service.go:45-85)
        self.extender_service = extender_service
        # DefaultPreemptionArgs from pluginConfig (upstream defaults
        # minCandidateNodesPercentage=10, minCandidateNodesAbsolute=100)
        args = (getattr(plugin_config, "args", None) or {}).get(
            "DefaultPreemption") or {}
        pct = args.get("minCandidateNodesPercentage")
        abs_ = args.get("minCandidateNodesAbsolute")
        # null -> default (upstream nil-pointer defaulting); an explicit 0
        # is valid ("use only the other knob") and must survive
        self.min_candidate_pct = (
            MIN_CANDIDATE_NODES_PERCENTAGE if pct is None else int(pct))
        self.min_candidate_abs = (
            MIN_CANDIDATE_NODES_ABSOLUTE if abs_ is None else int(abs_))
        self._fit_cache: dict = {}
        self._nodes: list[dict] | None = None   # store snapshot, per preempt()
        self._pods_all: list[dict] | None = None
        self._volumes: dict | None = None

    # ------------------------------------------------------------ oracle

    def _fits(self, pod: dict, node_name: str, removed: frozenset[str]) -> bool:
        """Would `pod` pass all Filter plugins on `node_name` with the pods
        in `removed` (set of ns/name keys) deleted from the cluster?

        Each hypothesis recompiles the workload's tensors (numpy, then
        one copy to the device) and replays the one pod through the step
        kernel (B1)."""
        cache_key = (node_name, removed)
        hit = self._fit_cache.get(cache_key)
        if hit is not None:
            return hit

        from .replay import replay
        from ..state.compile import compile_workload

        nodes = self._nodes
        bound = [
            (p, p["spec"]["nodeName"]) for p in self._pods_all
            if (p.get("spec") or {}).get("nodeName") and _pod_key(p) not in removed
        ]
        # node-table reuse across hypotheses (`reuse=`) is ROADMAP Queue A
        # item 2: it changes compile time, never a result
        cw = compile_workload(
            nodes, [pod], self.plugin_config, bound_pods=bound,
            volumes=self._volumes, namespaces=self._namespaces,
            device=self.device,
        )
        # host-resident: the oracle reads the single pod's codes right
        # below, so device residency would just add an unoverlapped
        # round-trip (plus an attribution reduction nobody consumes)
        # per fit hypothesis.  The JAX package's filter_only= (skip the
        # score phase) is not ported: the codes are the same
        rr = replay(cw, chunk=1, device_resident=False, device=self.device)
        try:
            j = cw.node_table.names.index(node_name)
        except ValueError:
            return False
        if int(rr.prefilter_reject[0]) != 0:
            # PreFilter still rejects the pod in the hypothesis (e.g. the
            # ReadWriteOncePod holder is not among the removed victims)
            self._fit_cache[cache_key] = False
            return False
        active = [
            f for f, name in enumerate(cw.config.filters())
            if not cw.host["filter_skip"][name][0]
        ]
        ok = bool((rr.codes_of(0)[active, j] == 0).all()) if active else True
        self._fit_cache[cache_key] = ok
        return ok

    # ------------------------------------------------------------ algorithm

    def preempt(self, pod: dict, failed: list[tuple[str, str | None]]) -> PreemptionOutcome:
        """failed: (node name, first failing plugin or None) for every node
        evaluated in the failed scheduling cycle."""
        from ..cluster.store import list_shared

        def _shared(resource):
            # read-only snapshot, no per-object deep copies
            return list_shared(self.store, resource)

        self._fit_cache.clear()
        self._nodes = _shared("nodes")
        self._pods_all = _shared("pods")
        self._volumes = {
            "pvcs": _shared("persistentvolumeclaims"),
            "pvs": _shared("persistentvolumes"),
            "storageclasses": _shared("storageclasses"),
        }
        try:
            self._pdbs = _shared("poddisruptionbudgets")
        except KeyError:
            self._pdbs = []
        self._namespaces = _shared("namespaces")
        # gang quorum guard (docs/gang-scheduling.md): bound PodGroup
        # members whose eviction would drop a running group below its
        # minMember are never preemption victims
        from .gang import GangDirectory, preemption_protected

        self._gang_protected = preemption_protected(
            self._pods_all, GangDirectory(self.store))
        evaluated = [n for n, _ in failed]
        out = PreemptionOutcome(evaluated_nodes=evaluated)

        if ((pod.get("spec") or {}).get("preemptionPolicy") or "") == "Never":
            return out

        pod_prio = _priority(pod)
        potential = [
            n for n, plugin in failed
            if plugin is not None and plugin in RESOLVABLE_PLUGINS
        ]
        if not potential:
            return out

        by_node: dict[str, list[dict]] = {}
        for p in self._pods_all:
            nn = (p.get("spec") or {}).get("nodeName")
            if nn:
                by_node.setdefault(nn, []).append(p)

        budget = _num_candidates(len(potential), self.min_candidate_pct,
                                 self.min_candidate_abs)
        candidates: list[tuple[str, list[dict], int]] = []
        for node in potential:
            if len(candidates) >= budget:
                break
            found = self._victims_on(node, by_node.get(node, []), pod, pod_prio)
            if found is not None:
                victims, violations = found
                candidates.append((node, victims, violations))
        if not candidates:
            return out

        if self.extender_service is not None:
            candidates = self._call_extenders(pod, candidates)
            if not candidates:
                return out

        node, victims = self._select(candidates)
        out.nominated_node = node
        out.victims = victims
        return out

    def _call_extenders(self, pod: dict,
                        candidates: list[tuple[str, list[dict], int]]
                        ) -> list[tuple[str, list[dict], int]]:
        """upstream preemption callExtenders: each preempt-capable extender
        receives ExtenderPreemptionArgs{Pod, NodeNameToVictims} and returns
        a (possibly narrowed) node->victims map — whose NumPDBViolations
        REPLACES the locally computed count, as upstream builds the final
        candidates from the extender's answer; an unignorable error aborts
        preemption.  Each round-trip is recorded into
        extender-preempt-result by the service's store."""
        def _pods_of(victims_obj) -> list:
            # the k8s extender/v1 Victims json tag is lowercase "pods";
            # accept the capitalized Go-field spelling too (as the
            # node-map and UID keys already do)
            v = victims_obj or {}
            return v.get("Pods") or v.get("pods") or []

        def _nv_of(victims_obj) -> int:
            v = victims_obj or {}
            return int(v.get("NumPDBViolations")
                       or v.get("numPDBViolations") or 0)

        node_to_victims: dict[str, dict] = {
            node: {"Pods": victims, "NumPDBViolations": violations}
            for node, victims, violations in candidates
        }
        order = [node for node, _, _ in candidates]
        for idx, ext in enumerate(self.extender_service.extenders):
            if not ext.preempt_verb or not node_to_victims:
                continue
            if not ext.is_interested(pod):
                continue
            args = {"Pod": pod, "NodeNameToVictims": node_to_victims}
            try:
                result = self.extender_service.handle("preempt", idx, args)
            except Exception:
                if ext.ignorable:
                    continue
                return []  # non-ignorable extender error aborts preemption
            # key-presence lookup: an explicit {} answer ("no candidate
            # may be preempted") must not read as "no opinion"
            from ..scheduler.extender import pick_field as _field

            ret = _field(result, "NodeNameToVictims", "nodeNameToVictims")
            if ret is None:
                # nodeCacheCapable contract: MetaVictims carry pod UIDs
                meta = _field(result, "NodeNameToMetaVictims",
                              "nodeNameToMetaVictims")
                if meta is None:
                    continue
                ret = {}
                for node, mv in meta.items():
                    olds = {}
                    for v in _pods_of(node_to_victims.get(node)):
                        vm = v.get("metadata") or {}
                        olds[vm.get("uid") or vm.get("name", "")] = v
                    pods = [
                        olds[m.get("UID") or m.get("uid") or ""]
                        for m in _pods_of(mv)
                        if (m.get("UID") or m.get("uid") or "") in olds
                    ]
                    ret[node] = {"Pods": pods,
                                 "NumPDBViolations": (mv or {}).get("NumPDBViolations")
                                 or (mv or {}).get("numPDBViolations") or 0}
            else:
                ret = {n: {"Pods": _pods_of(v), "NumPDBViolations": _nv_of(v)}
                       for n, v in ret.items()}
            node_to_victims = {
                n: v for n, v in ret.items() if n in node_to_victims
            }
        return [
            (n, _pods_of(node_to_victims[n]), _nv_of(node_to_victims[n]))
            for n in order if n in node_to_victims
        ]

    def _victims_on(self, node: str, node_pods: list[dict], pod: dict,
                    pod_prio: int) -> tuple[list[dict], int] | None:
        """(minimal victim set on `node`, #PDB-violating victims), or None
        if removing every lower-priority pod still doesn't make `pod` fit.

        PDB handling follows upstream SelectVictimsOnNode: split the
        potential victims into PDB-violating and non-violating, reprieve
        the violating ones FIRST (so budget-covered pods are preferred as
        the ones actually evicted), and count the violating pods that
        could not be reprieved."""
        lower = [
            p for p in node_pods
            if _priority(p) < pod_prio
            and _pod_key(p) not in self._gang_protected
        ]
        all_removed = frozenset(_pod_key(p) for p in lower)
        if not self._fits(pod, node, all_removed):
            return None
        # reprieve most-important-first (upstream MoreImportantPod order)
        lower.sort(key=lambda p: (-_priority(p), _creation(p), _pod_key(p)))
        violating, non_violating = filter_pods_with_pdb_violation(
            lower, self._pdbs or [])
        removed = set(all_removed)
        victims: list[dict] = []
        violations = 0

        def reprieve(v: dict) -> bool:
            removed.discard(_pod_key(v))
            if not self._fits(pod, node, frozenset(removed)):
                removed.add(_pod_key(v))
                victims.append(v)
                return False
            return True

        for v in violating:
            if not reprieve(v):
                violations += 1
        for v in non_violating:
            reprieve(v)
        # keep victim list in MoreImportantPod order (execution + records)
        order = {_pod_key(p): i for i, p in enumerate(lower)}
        victims.sort(key=lambda p: order[_pod_key(p)])
        return victims, violations

    @staticmethod
    def _select(candidates: list[tuple[str, list[dict], int]]
                ) -> tuple[str, list[dict]]:
        """upstream pickOneNodeForPreemption: fewest PDB violations, then
        the victim-priority/count/age tie-break ladder."""

        def rank(c: tuple[str, list[dict], int]):
            _, victims, violations = c
            if not victims:  # no-victim candidates win their violation tier
                return (violations, 0, 0, 0, 0, _InvStr(""))
            prios = [_priority(v) for v in victims]
            top = max(prios)
            # later creation must rank first; _InvStr inverts string order
            latest = max(_creation(v) for v in victims if _priority(v) == top)
            return (violations, 1, top, sum(prios), len(victims), _InvStr(latest))

        best = min(range(len(candidates)), key=lambda i: (rank(candidates[i]), i))
        node, victims, _ = candidates[best]
        return node, victims


class _InvStr(str):
    """String with inverted ordering (later timestamps rank first)."""

    def __lt__(self, other):  # noqa: D105
        return str.__gt__(self, other)

    def __gt__(self, other):  # noqa: D105
        return str.__lt__(self, other)
