"""Workload compiler: manifests -> torch tensors.

Port of kube_scheduler_simulator_tpu/state/compile.py:87
`compile_workload` for the core resource carry and every plugin of the
default profile (upstream v1.32 getDefaultPlugins: the 14 Filter/Score
plugins, the volume family included; DefaultPreemption and
SchedulingGates compile to nothing, as in the JAX package).  The whole
workload is compiled ONCE into

  * static per-node tensors (allocatable, allowed pods, domain indices),
  * per-pod tensors with leading axis P (requests, precompiled match rows)
    — the xs the replay walks pod by pod,
  * the initial carry (resource accumulators, per-domain counts),

all on one device.  Already-bound pods (`bound_pods`) are folded into the
initial carry the way informers prime the scheduler's NodeInfo snapshots.

The volume family's PreFilter rejects that a workload fixes at compile
time (a missing PVC or StorageClass, an unbound Immediate claim) land in
`host["prefilter_reject"]` (messages per plugin, for the decoder) and in
`xs["force_unsched"]` ([P] bool, the step's prefilter-reject bit 1).

Not ported here: node-table reuse and delta patching (`reuse=`), the
columnar pod view (`pod_columns=`) and tracing.  A custom plugin compiles
to nothing when it neither filters nor scores (its lifecycle points and
Coscheduling run on the host, in the engine); one with filter or score
rows raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from .nodes import NodeTable, build_node_table
from .resources import ResourceSchema, pod_resource_request
from ..plugins import registry as reg
from .volumes import build_volume_table, pod_pvc_keys
from ..plugins import (
    affinity, imagelocality, interpod, noderesources, nodevolumelimits, ports,
    taints, topologyspread, volumebinding, volumerestrictions, volumezone,
)
from ..plugins.base import CoreCarry, to_tensor

VOLUME_PLUGINS = ("VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone")


@dataclass
class CompiledWorkload:
    schema: ResourceSchema
    node_table: NodeTable
    pods: list[dict]
    pod_keys: list[str]                 # "namespace/name"
    config: reg.PluginSetConfig
    statics: dict[str, Any]             # plugin name -> static NamedTuple
    xs: dict[str, Any]                  # plugin name -> per-pod NamedTuple (leading axis P)
    init_carry: dict[str, Any]          # carry component name -> tensor(s)
    host: dict[str, Any] = field(default_factory=dict)  # numpy skip flags etc.
    device: torch.device = torch.device("cpu")

    @property
    def n_pods(self) -> int:
        return len(self.pods)

    @property
    def n_nodes(self) -> int:
        return self.node_table.n


def _pod_key(pod: dict) -> str:
    meta = pod.get("metadata") or {}
    return f"{meta.get('namespace') or 'default'}/{meta.get('name', '')}"


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def compile_workload(
    nodes: list[dict],
    pods: list[dict],
    config: reg.PluginSetConfig | None = None,
    bound_pods: list[tuple[dict, str]] | None = None,
    volumes: dict | None = None,
    namespaces: list[dict] | None = None,
    device="cuda",
) -> CompiledWorkload:
    """Compile (nodes, queue pods, already-bound pods) into tensors on
    `device` ("cuda" by default; "cpu" runs the plain PyTorch path).

    bound_pods: (pod manifest, node name) pairs folded into the initial
    carry; they also contribute to topology/affinity counts.
    volumes: optional {"pvcs": [...], "pvs": [...], "storageclasses":
    [...], "csinodes": [...]} manifest lists backing the volume family.
    namespaces: namespace manifests that InterPodAffinity's
    namespaceSelector resolves against."""
    device = resolve_device(device)
    config = config or reg.PluginSetConfig()
    enabled = set(config.active_plugins())
    custom = sorted(n for n in enabled if config.is_custom(n))
    rows = [n for n in custom
            if config.custom[n].has_filter or config.custom[n].has_score]
    if rows:
        raise NotImplementedError(
            f"custom plugins {rows} filter or score: their [P, N] rows are not "
            "ported yet (ROADMAP.md Queue A)")
    bound_pods = bound_pods or []
    volumes = volumes or {}
    schema = ResourceSchema.discover(pods + [bp for bp, _ in bound_pods], nodes)
    table = build_node_table(nodes, schema)

    requests, nonzero = _pod_requests(pods, schema)

    statics: dict[str, Any] = {}
    xs: dict[str, Any] = {}
    init_carry: dict[str, Any] = {}
    host: dict[str, Any] = {"node_table": table, "schema": schema}

    # core resource carry, primed with bound pods
    name_idx = {name: j for j, name in enumerate(table.names)}
    req0 = table.initial_requested.copy()
    nz0 = table.initial_nonzero.copy()
    np0 = table.initial_num_pods.copy()
    if bound_pods:
        b_req, b_nz = _pod_requests([bp for bp, _ in bound_pods], schema)
        for bi, (_, node_name) in enumerate(bound_pods):
            j = name_idx.get(node_name)
            if j is None:
                continue
            req0[j] += b_req[bi]
            nz0[j] += b_nz[bi]
            np0[j] += 1

    # Fit static/xs double as the core resource tensors even when the Fit
    # plugin itself is disabled (bind updates always need pod requests).
    fit_static, fit_xs = noderesources.build_fit(
        table, schema, requests, nonzero,
        fit_args=config.args.get("NodeResourcesFit"), device=device)
    statics["core"] = fit_static
    xs["core"] = fit_xs
    init_carry["core"] = CoreCarry(
        requested=to_tensor(req0, device),
        nonzero=to_tensor(nz0, device),
        num_pods=to_tensor(np0, device),
    )

    if "NodeAffinity" in enabled:
        st, x = affinity.build(
            table, pods, args=config.args.get("NodeAffinity"), host_out=host,
            device=device)
        statics["NodeAffinity"] = st
        xs["NodeAffinity"] = x
    if "NodePorts" in enabled:
        st, x, carry = ports.build(table, pods, bound_pods, device=device)
        statics["NodePorts"] = st
        xs["NodePorts"] = x
        init_carry["NodePorts"] = carry
    if "ImageLocality" in enabled:
        xs["ImageLocality"] = imagelocality.build(nodes, pods, host_out=host, device=device)
    if "TaintToleration" in enabled:
        xs["TaintToleration"] = taints.build_taints(
            table, pods, host_out=host, device=device)
    if "NodeUnschedulable" in enabled:
        xs["NodeUnschedulable"] = taints.build_unschedulable(table, pods, device=device)
    if "NodeName" in enabled:
        xs["NodeName"] = taints.build_nodename(table, pods, device=device)
    if "PodTopologySpread" in enabled:
        st, x, counts_dom = topologyspread.build(table, pods, device=device)
        statics["PodTopologySpread"] = st
        xs["PodTopologySpread"] = x
        _prime_spread_counts(counts_dom, st, pods, bound_pods, name_idx)
        init_carry["PodTopologySpread"] = topologyspread.assemble_counts(st, counts_dom)
    if any(name in enabled for name in VOLUME_PLUGINS):
        _compile_volumes(table, pods, bound_pods, volumes, enabled, statics, xs,
                         init_carry, host, device)
    if "InterPodAffinity" in enabled:
        # the term table spans queue + bound pods so the bound pods' terms
        # (which matter for the symmetric existing-pod checks) share the
        # same term ids; the per-pod xs are then cut back to the queue
        bound_manifests = [bp for bp, _ in bound_pods]
        st, x_all, dom_mats = interpod.build(
            table, pods + bound_manifests,
            hard_weight=int((config.args.get("InterPodAffinity") or {})
                            .get("hardPodAffinityWeight")
                            or interpod.DEFAULT_HARD_POD_AFFINITY_WEIGHT),
            namespaces=namespaces, device=device,
        )
        statics["InterPodAffinity"] = st
        xs["InterPodAffinity"] = interpod.InterPodXS(
            *[v[:len(pods)] for v in x_all])
        _prime_interpod_counts(dom_mats, st, x_all, len(pods), bound_pods, name_idx)
        init_carry["InterPodAffinity"] = interpod.assemble_carry(st, dom_mats)

    cw = CompiledWorkload(
        schema=schema,
        node_table=table,
        pods=pods,
        pod_keys=[_pod_key(pod) for pod in pods],
        config=config,
        statics=statics,
        xs=xs,
        init_carry=init_carry,
        host=host,
        device=device,
    )
    _collect_host_flags(cw)
    return cw


def _compile_volumes(table, pods, bound_pods, volumes, enabled, statics, xs,
                     init_carry, host, device) -> None:
    """The volume family (compile.py:225-270): its tensors, and the
    PreFilter rejects fixed at compile time, keyed by the plugin whose
    PreFilter reports them (the earliest enabled prefilter in config
    order wins at decode time)."""
    p = len(pods)
    vt = build_volume_table(
        table, volumes.get("pvcs"), volumes.get("pvs"),
        volumes.get("storageclasses"), volumes.get("csinodes"),
    )
    host["volume_table"] = vt
    rejects: dict[str, list[str | None]] = {}
    if "VolumeRestrictions" in enabled:
        st, x, carry = volumerestrictions.build(vt, table, pods, bound_pods, device=device)
        statics["VolumeRestrictions"] = st
        xs["VolumeRestrictions"] = x
        init_carry["VolumeRestrictions"] = carry
        # upstream VolumeRestrictions' PreFilter does the PVC lister
        # lookup first, so a missing PVC rejects there
        rejects["VolumeRestrictions"] = [_missing_pvc_message(vt, pod) for pod in pods]
    if "NodeVolumeLimits" in enabled:
        st, x, carry = nodevolumelimits.build(vt, table, pods, bound_pods, device=device)
        statics["NodeVolumeLimits"] = st
        xs["NodeVolumeLimits"] = x
        init_carry["NodeVolumeLimits"] = carry
    if "VolumeBinding" in enabled:
        st, x, carry, vb_rejects = volumebinding.build(vt, table, pods, bound_pods,
                                                       device=device)
        statics["VolumeBinding"] = st
        xs["VolumeBinding"] = x
        init_carry["VolumeBinding"] = carry
        rejects["VolumeBinding"] = vb_rejects
        # VolumeCapacityPriority is off: Score is constant 0 for every
        # (pod, node), kept host-resident
        host.setdefault("static_score_rows", {})["VolumeBinding"] = (
            np.zeros((p, table.n), dtype=np.int8))
    if "VolumeZone" in enabled:
        xs["VolumeZone"] = volumezone.build(vt, table, pods, device=device)
    if any(any(m is not None for m in msgs) for msgs in rejects.values()):
        host["prefilter_reject"] = rejects
        xs["force_unsched"] = to_tensor(np.asarray([
            any(msgs[i] is not None for msgs in rejects.values())
            for i in range(p)
        ], dtype=bool), device)


def _missing_pvc_message(vt, pod: dict) -> str | None:
    """upstream volumerestrictions PreFilter: the PVC lister Get fails."""
    for key in pod_pvc_keys(pod):
        if key not in vt.pvcs:
            return f'persistentvolumeclaim "{key.split("/", 1)[1]}" not found'
    return None


def _pod_requests(pods: list[dict], schema: ResourceSchema):
    """[P, R] requests + [P, 2] nonzero rows."""
    requests = np.zeros((len(pods), schema.n), dtype=np.int64)
    nonzero = np.zeros((len(pods), 2), dtype=np.int64)
    for i, pod in enumerate(pods):
        requests[i], nonzero[i] = pod_resource_request(pod, schema)
    return requests, nonzero


def _prime_spread_counts(counts_dom, st, pods, bound_pods, name_idx):
    """Fold already-bound pods into the domain-space match counts (in
    place; topologyspread.assemble_counts converts to node space after)."""
    if not bound_pods:
        return
    from .selectors import label_selector_matches

    dom_idx = _np(st.dom_idx)
    # MUST intern identically to topologyspread.build or bound-pod
    # priming would credit the wrong count groups
    groups = topologyspread.constraint_groups(pods)
    for bp, node_name in bound_pods:
        j = name_idx.get(node_name)
        if j is None:
            continue
        ns = (bp.get("metadata") or {}).get("namespace") or "default"
        labels = {k: str(v) for k, v in ((bp.get("metadata") or {}).get("labels") or {}).items()}
        for c_id, (gns, _, sel) in enumerate(groups):
            if gns == ns and label_selector_matches(sel, labels) and dom_idx[c_id, j] >= 0:
                counts_dom[c_id, dom_idx[c_id, j]] += 1


def _prime_interpod_counts(dom_mats, st, x_all, n_queue, bound_pods, name_idx):
    """Fold bound pods (rows n_queue.. of x_all) into the domain-space
    interpod count mats (in place; interpod.assemble_carry converts to the
    node-space carry afterwards)."""
    if not bound_pods:
        return
    dom_idx = _np(st.dom_idx)
    t_matches = _np(x_all.t_matches)
    h_req_anti = _np(x_all.h_req_anti)
    h_req_aff = _np(x_all.h_req_aff)
    h_pref_aff_w = _np(x_all.h_pref_aff_w)
    h_pref_anti_w = _np(x_all.h_pref_anti_w)
    for bi, (_, node_name) in enumerate(bound_pods):
        j = name_idx.get(node_name)
        if j is None:
            continue
        i = n_queue + bi
        for t_id in range(dom_idx.shape[0]):
            dm = dom_idx[t_id, j]
            if dm < 0:
                continue
            dom_mats["matched"][t_id, dm] += bool(t_matches[i, t_id])
            dom_mats["have_req_anti"][t_id, dm] += int(h_req_anti[i, t_id])
            dom_mats["have_req_aff"][t_id, dm] += int(h_req_aff[i, t_id])
            dom_mats["sym_pref_aff"][t_id, dm] += int(h_pref_aff_w[i, t_id])
            dom_mats["sym_pref_anti"][t_id, dm] += int(h_pref_anti_w[i, t_id])


def _collect_host_flags(cw: CompiledWorkload):
    """numpy copies of the per-pod skip flags for the annotation decoder
    (compile.py:386)."""
    skips_filter: dict[str, np.ndarray] = {}
    skips_score: dict[str, np.ndarray] = {}
    p = cw.n_pods
    for name in cw.config.active_plugins():
        x = cw.xs.get(name)
        skips_filter[name] = (
            _np(x.filter_skip) if x is not None and hasattr(x, "filter_skip") else np.zeros(p, bool)
        )
        skips_score[name] = (
            _np(x.score_skip) if x is not None and hasattr(x, "score_skip") else np.zeros(p, bool)
        )
    cw.host["filter_skip"] = skips_filter
    cw.host["score_skip"] = skips_score
    cw.host["max_filter_code"] = _max_filter_code(cw)
    if "PodTopologySpread" in cw.config.scorers():
        # static inputs for the host-side recompute of the score-ignore
        # mask (framework/replay.py _tsp_ignored_chunk)
        st = cw.statics["PodTopologySpread"]
        x = cw.xs["PodTopologySpread"]
        cw.host["tsp_ignore"] = (
            _np(st.dom_idx) < 0,
            _np(x.c_id),
            _np(x.is_score),
        )
    cw.host["score_dtypes"] = tuple(
        _score_dtype(cw, name) for name in cw.config.scorers()
    )


# static per-plugin bound on the filter codes each function can emit —
# lets the replay pick the narrowest first-fail packing
# (framework/pipeline.py pack_filter_codes)
_FILTER_CODE_BOUNDS = {
    "NodeAffinity": 1, "NodeUnschedulable": 1, "NodeName": 1, "NodePorts": 1,
    "VolumeRestrictions": 1, "NodeVolumeLimits": 1, "VolumeZone": 1,
    "InterPodAffinity": 3, "VolumeBinding": 7,
}


# raw scores provably bounded by framework.MaxNodeScore (100): they travel
# as int8 in the compact replay without a runtime overflow check
_SCORE_I8_SAFE = frozenset({
    "NodeResourcesFit", "NodeResourcesBalancedAllocation", "ImageLocality",
    "VolumeBinding",
})


def _score_dtype(cw: CompiledWorkload, name: str) -> str:
    """compile.py:456: the compact transfer group of one scorer's raw."""
    if name in cw.host.get("static_score_rows", {}):
        # raw is a precompiled host-resident [P, N] row: it never travels
        # back from the device — the replay reads the host copy
        return "host"
    if name in _SCORE_I8_SAFE:
        return "i8"
    if name == "TaintToleration":
        # raw = count of intolerable PreferNoSchedule taints on the node
        if max((len(t) for t in cw.node_table.taints), default=0) <= 127:
            return "i8"
        return "i16"
    if name == "NodeAffinity":
        # only reached when every pod skips NodeAffinity scoring (no host
        # stash): the bound of the unique preference rows
        a = _np(cw.statics[name].pref_rows)
        # NOT np.abs: |int_min| overflows to a negative bound
        bound = max(int(a.max(initial=0)), -int(a.min(initial=0)))
        if bound <= 0x7F:
            return "i8"
        if bound <= 0x7FFF:
            return "i16"
        if bound <= 0x7FFFFFFF:
            return "i32"
        return "i64"
    # dynamic raws (PodTopologySpread, InterPodAffinity): optimistic i16,
    # the replay's widening ladder covers overflow
    return "i16"


def _max_filter_code(cw: CompiledWorkload) -> int:
    bound = 0
    for name in cw.config.filters():
        if name == "NodeResourcesFit":
            b = (1 << (cw.schema.n + 1)) - 1
        elif name == "TaintToleration":
            b = max((len(t) for t in cw.node_table.taints), default=0)
        elif name == "PodTopologySpread":
            b = 2 * topologyspread.MAX_CONSTRAINTS
        else:
            b = _FILTER_CODE_BOUNDS[name]
        bound = max(bound, b)
    return bound
