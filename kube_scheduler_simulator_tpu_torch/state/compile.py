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

A prior wave's node table is reused (`reuse=`, compile.py:87-160): as
it is when the node set, its resourceVersions and the resource schema
are unchanged, patched row by row when at most
KSS_TPU_COLUMNAR_DELTA_MAX rows changed (`_node_delta`), else rebuilt.
Listings from the store's columnar plane (cluster/columnar.py) carry
their bank view: the schema, the node key and the table are read from
its columns, and with `pod_columns=` the pods' request rows are
gathered from the pod bank by uid.  TRACER counts each path
(node_table_reuse_total, node_table_delta_patches_total,
node_table_delta_rows_total, node_table_builds_total,
compile_requests_gathered_total).

Every part is built on the host, as numpy and CPU tensors, and the
statics, xs and initial carry are moved to `device` in one last step:
TRACER spans split a compile into compile_schema, compile_node_table,
compile_pod_requests, compile_build_<plugin> (core for the resource
carry) and compile_upload (names that pass the Prometheus rules, which
validate_exposition holds the spans' histograms to).

A custom plugin's filter and score rows (plugins/custom.py
`build_custom`, one host call per (pod, node)) go into `xs[name]` as a
`CustomXS`, its messages into `host["custom_msgs"][name]`; its lifecycle
points, QueueSort and Coscheduling run on the host, in the engine.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from .nodes import (NodeTable, build_node_table, build_node_table_columnar,
                    patch_node_table, patch_node_table_columnar)
from .resources import ResourceSchema, pod_resource_request
from ..utils.env import env_int
from ..utils.tracing import TRACER
from ..plugins import registry as reg
from .volumes import build_volume_table, pod_pvc_keys
from ..plugins import (
    affinity, custom, imagelocality, interpod, noderesources, nodevolumelimits, ports,
    taints, topologyspread, volumebinding, volumerestrictions, volumezone,
)
from ..plugins.base import CoreCarry, to_tensor

VOLUME_PLUGINS = ("VolumeRestrictions", "NodeVolumeLimits", "VolumeBinding", "VolumeZone")


# The node axis of every tensor leaf that compile_workload emits, by part
# ("statics", "carry", and "xs" for ONE pod, so without the pod axis),
# component and field; a component that is a bare tensor maps to its axis.
# None: the leaf has no node axis (cluster-wide, or indexed by groups,
# terms, volumes or slots).  A width-1 node axis (the compact always-pass
# rows of VolumeZone and VolumeBinding) broadcasts.  The node-sharded
# step's plain twin (kernels/mesh.py) cuts each shard's view by this
# table and refuses a leaf that is missing from it.
NODE_AXES: dict[str, dict[str, Any]] = {
    "statics": {
        "core": {"allocatable": 0, "allowed_pods": 0, "ignored": None},
        "NodeAffinity": {"req_rows": 1, "pref_rows": 1},
        "NodePorts": {"sq": None},
        "PodTopologySpread": {"dom_idx": 1},
        "InterPodAffinity": {"dom_idx": 1, "hard_weight": None},
        "VolumeRestrictions": {"strict": None},
        "NodeVolumeLimits": {"driver_onehot": None, "limits": 0},
        "VolumeBinding": {"pv_cap": None, "pv_node_ok": 1},
    },
    "carry": {
        "core": {"requested": 0, "nonzero": 0, "num_pods": 0},
        "NodePorts": {"used_any": 0, "used_wild": 0, "used_spec": 0},
        "PodTopologySpread": 1,
        "InterPodAffinity": {"matched": 1, "have_req_anti": 1, "have_req_aff": 1,
                             "sym_pref_aff": 1, "sym_pref_anti": 1, "matched_total": None},
        "VolumeRestrictions": {"used_any": 0, "used_rw": 0, "rwop_used": None},
        "NodeVolumeLimits": {"on_node": 0},
        "VolumeBinding": {"claimed": None},
    },
    "xs": {
        "core": {"requests": None, "nonzero": None},
        "NodeAffinity": {"req_idx": None, "pref_idx": None, "filter_skip": None,
                         "score_skip": None},
        "NodePorts": {"w_wild": None, "w_spec": None, "w_any": None, "filter_skip": None},
        "ImageLocality": {"score": -1},
        "TaintToleration": {"filter_code": -1, "prefer_count": -1},
        "NodeUnschedulable": {"fail": -1},
        "NodeName": {"fail": -1},
        "PodTopologySpread": {"pm": None, "c_id": None, "max_skew": None, "is_filter": None,
                              "is_score": None, "weight": None, "eligible": -1,
                              "md_unsat": None, "filter_skip": None, "score_skip": None},
        "InterPodAffinity": {"t_matches": None, "h_req_aff": None, "h_req_anti": None,
                             "h_pref_aff_w": None, "h_pref_anti_w": None, "self_ok": None,
                             "filter_skip": None},
        "VolumeRestrictions": {"w_any": None, "w_rw": None, "rwop": None, "filter_skip": None},
        "NodeVolumeLimits": {"pod_vols": None, "filter_skip": None},
        "VolumeBinding": {"bound_code": -1, "want": None, "active": None, "provision_ok": -1,
                          "filter_skip": None},
        "VolumeZone": {"codes": -1, "filter_skip": None},
        "force_unsched": None,
        "is_pad": None,
    },
}
# the xs of a custom plugin (plugins/custom.py CustomXS), under the
# plugin's own name
CUSTOM_XS_AXES = {"codes": -1, "scores": -1}


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
    # set by parallel/mesh.py shard_workload: the one-card mesh the node
    # axis is sharded over (its node_slices(n_nodes) are the shards')
    mesh: Any = None

    @property
    def n_pods(self) -> int:
        return len(self.pods)

    @property
    def n_nodes(self) -> int:
        return self.node_table.n


def _pod_key(pod: dict) -> str:
    meta = pod.get("metadata") or {}
    return f"{meta.get('namespace') or 'default'}/{meta.get('name', '')}"


class NodeTableReuse:
    """Slim handle for compile_workload(reuse=...): holds only the node
    table and schema (what the reuse path reads), so callers caching it
    between waves don't pin the previous wave's per-pod device tensors."""

    __slots__ = ("host", "schema", "node_table")

    def __init__(self, cw: CompiledWorkload):
        self.host = {"node_key": cw.host.get("node_key")}
        self.schema = cw.schema
        self.node_table = cw.node_table


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def compile_workload(
    nodes: list[dict],
    pods: list[dict],
    config: reg.PluginSetConfig | None = None,
    bound_pods: list[tuple[dict, str]] | None = None,
    volumes: dict | None = None,
    reuse: "CompiledWorkload | NodeTableReuse | None" = None,
    namespaces: list[dict] | None = None,
    pod_columns=None,
    device="cuda",
) -> CompiledWorkload:
    """Compile (nodes, queue pods, already-bound pods) into tensors on
    `device` ("cuda" by default; "cpu" runs the plain PyTorch path).

    bound_pods: (pod manifest, node name) pairs folded into the initial
    carry; they also contribute to topology/affinity counts.
    volumes: optional {"pvcs": [...], "pvs": [...], "storageclasses":
    [...], "csinodes": [...]} manifest lists backing the volume family.
    reuse: a prior wave's workload (or its NodeTableReuse): its NodeTable
    is reused when the node set, resourceVersions and the discovered
    resource schema are unchanged, and patched row-wise when at most
    KSS_TPU_COLUMNAR_DELTA_MAX rows changed.
    namespaces: namespace manifests that InterPodAffinity's
    namespaceSelector resolves against.
    pod_columns: the pod listing's columnar view (ColumnarManifestList
    .columns): request rows are gathered from the bank's pre-parsed
    columns by uid instead of parsed per wave."""
    device = resolve_device(device)
    config = config or reg.PluginSetConfig()
    enabled = set(config.active_plugins())
    bound_pods = bound_pods or []
    volumes = volumes or {}
    # columnar listings (cluster/columnar.ColumnarManifestList) carry their
    # bank view: schema discovery, the node-table identity and the table
    # build read columns instead of walking N manifests
    cols = getattr(nodes, "columns", None)
    with TRACER.span("compile_schema"):
        if cols is not None:
            schema = ResourceSchema.discover_columnar(
                pods + [bp for bp, _ in bound_pods], cols)
            node_key = cols.identity()
        else:
            schema = ResourceSchema.discover(pods + [bp for bp, _ in bound_pods], nodes)
            node_key = tuple(
                ((n.get("metadata") or {}).get("name", ""),
                 (n.get("metadata") or {}).get("resourceVersion", ""))
                for n in nodes)
    with TRACER.span("compile_node_table"):
        schema, table = _node_table(nodes, cols, schema, node_key, reuse)

    with TRACER.span("compile_pod_requests"):
        requests, nonzero = _pod_requests(pods, schema, pod_columns)

    statics: dict[str, Any] = {}
    xs: dict[str, Any] = {}
    init_carry: dict[str, Any] = {}
    host: dict[str, Any] = {"node_table": table, "schema": schema, "node_key": node_key}
    # every part is built on the host; compile_upload moves it to `device`
    cpu = torch.device("cpu")

    # core resource carry, primed with bound pods
    with _build_span("core"):
        name_idx = {name: j for j, name in enumerate(table.names)}
        req0 = table.initial_requested.copy()
        nz0 = table.initial_nonzero.copy()
        np0 = table.initial_num_pods.copy()
        if bound_pods:
            b_req, b_nz = _pod_requests([bp for bp, _ in bound_pods], schema, pod_columns)
            for bi, (_, node_name) in enumerate(bound_pods):
                j = name_idx.get(node_name)
                if j is None:
                    continue
                req0[j] += b_req[bi]
                nz0[j] += b_nz[bi]
                np0[j] += 1
        # Fit static/xs double as the core resource tensors even when the
        # Fit plugin itself is disabled (bind updates always need pod
        # requests).
        fit_static, fit_xs = noderesources.build_fit(
            table, schema, requests, nonzero,
            fit_args=config.args.get("NodeResourcesFit"), device=cpu)
        statics["core"] = fit_static
        xs["core"] = fit_xs
        init_carry["core"] = CoreCarry(
            requested=to_tensor(req0, cpu),
            nonzero=to_tensor(nz0, cpu),
            num_pods=to_tensor(np0, cpu),
        )

    if "NodeAffinity" in enabled:
        with _build_span("NodeAffinity"):
            st, x = affinity.build(
                table, pods, args=config.args.get("NodeAffinity"), host_out=host, device=cpu)
            statics["NodeAffinity"] = st
            xs["NodeAffinity"] = x
    if "NodePorts" in enabled:
        with _build_span("NodePorts"):
            st, x, carry = ports.build(table, pods, bound_pods, device=cpu)
            statics["NodePorts"] = st
            xs["NodePorts"] = x
            init_carry["NodePorts"] = carry
    if "ImageLocality" in enabled:
        with _build_span("ImageLocality"):
            xs["ImageLocality"] = imagelocality.build(nodes, pods, host_out=host, device=cpu)
    if "TaintToleration" in enabled:
        with _build_span("TaintToleration"):
            xs["TaintToleration"] = taints.build_taints(table, pods, host_out=host, device=cpu)
    if "NodeUnschedulable" in enabled:
        with _build_span("NodeUnschedulable"):
            xs["NodeUnschedulable"] = taints.build_unschedulable(table, pods, device=cpu)
    if "NodeName" in enabled:
        with _build_span("NodeName"):
            xs["NodeName"] = taints.build_nodename(table, pods, device=cpu)
    if "PodTopologySpread" in enabled:
        with _build_span("PodTopologySpread"):
            st, x, counts_dom = topologyspread.build(table, pods, device=cpu)
            statics["PodTopologySpread"] = st
            xs["PodTopologySpread"] = x
            _prime_spread_counts(counts_dom, st, pods, bound_pods, name_idx)
            init_carry["PodTopologySpread"] = topologyspread.assemble_counts(st, counts_dom)
    if any(name in enabled for name in VOLUME_PLUGINS):
        _compile_volumes(table, pods, bound_pods, volumes, enabled, statics, xs,
                         init_carry, host, cpu)
    for name, plugin in config.custom.items():
        # a plugin with neither point has no rows (its lifecycle points
        # run on the host), where the JAX package builds two of zeros
        if name not in enabled or not (plugin.has_filter or plugin.has_score):
            continue
        with _build_span(name):
            x, msg_table = custom.build_custom(plugin, table, pods, nodes, name=name,
                                               host_out=host, device=cpu)
            xs[name] = x
            host.setdefault("custom_msgs", {})[name] = msg_table
    if "InterPodAffinity" in enabled:
        # the term table spans queue + bound pods so the bound pods' terms
        # (which matter for the symmetric existing-pod checks) share the
        # same term ids; the per-pod xs are then cut back to the queue
        with _build_span("InterPodAffinity"):
            bound_manifests = [bp for bp, _ in bound_pods]
            st, x_all, dom_mats = interpod.build(
                table, pods + bound_manifests,
                hard_weight=int((config.args.get("InterPodAffinity") or {})
                                .get("hardPodAffinityWeight")
                                or interpod.DEFAULT_HARD_POD_AFFINITY_WEIGHT),
                namespaces=namespaces, device=cpu,
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
    # the host flags read the parts while they are still on the host
    _collect_host_flags(cw)
    with TRACER.span("compile_upload"):
        moved: dict[int, torch.Tensor] = {}
        cw.statics = _upload(statics, device, moved)
        cw.xs = _upload(xs, device, moved)
        cw.init_carry = _upload(init_carry, device, moved)
    return cw


@contextlib.contextmanager
def _build_span(name: str):
    """The span of one plugin's build, ended on every exit path."""
    with TRACER.span(f"compile_build_{name}"):
        yield


def _upload(tree, device: torch.device, moved: dict):
    """`tree` (dicts, NamedTuples, tuples and lists of tensors; other
    leaves pass through) with every tensor on `device`; a tensor that
    appears twice is moved once (`moved`, by id), so aliases stay
    aliases.  On the CPU it returns the same tensors."""
    if isinstance(tree, torch.Tensor):
        if tree.device == device:
            return tree
        got = moved.get(id(tree))
        if got is None:
            got = moved[id(tree)] = tree.to(device)
        return got
    if isinstance(tree, dict):
        return {k: _upload(v, device, moved) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_upload(v, device, moved) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(_upload(v, device, moved) for v in tree)
    return tree


def _node_table(nodes, cols, schema: ResourceSchema, node_key, reuse):
    """(schema, NodeTable) for this wave (compile.py:124-148): a prior
    wave's table as it is (same node key and schema), patched at the rows
    whose resourceVersion moved (`_node_delta`), or built afresh."""
    if (reuse is not None
            and tuple(reuse.schema.columns) == tuple(schema.columns)
            and reuse.schema.n == schema.n):
        old_key = reuse.host.get("node_key")
        if old_key == node_key:
            TRACER.count("node_table_reuse_total")
            return reuse.schema, reuse.node_table
        delta = _node_delta(old_key, node_key, cols)
        if delta is not None:
            schema = reuse.schema
            if cols is not None:
                table = patch_node_table_columnar(reuse.node_table, cols, delta, schema)
            else:
                table = patch_node_table(reuse.node_table, nodes, delta, schema)
            TRACER.count("node_table_delta_patches_total")
            TRACER.count("node_table_delta_rows_total", len(delta))
            return schema, table
    table = (build_node_table_columnar(cols, schema) if cols is not None
             else build_node_table(nodes, schema))
    TRACER.count("node_table_builds_total")
    return schema, table


def _node_delta(old_key, node_key, cols):
    """Positions whose node rows changed between waves, or None when the
    delta path doesn't apply (different membership/order, too many
    changes, incomparable keys).  Bounded by KSS_TPU_COLUMNAR_DELTA_MAX
    rows: past that a full rebuild is cheaper than the patch walk."""
    delta_max = env_int("KSS_TPU_COLUMNAR_DELTA_MAX", 256)
    if delta_max <= 0 or not isinstance(old_key, tuple):
        return None
    if cols is not None:
        # columnar identity: ("columnar", bank_id, names_version, rv bytes)
        if (len(old_key) != 4 or len(node_key) != 4
                or old_key[:3] != node_key[:3]):
            return None
        old_rv = np.frombuffer(old_key[3], dtype=np.int64)
        if len(old_rv) != cols.n:
            return None
        changed = np.flatnonzero(old_rv != cols.rv)
        return changed if 0 < len(changed) <= delta_max else None
    # dict identity: ((name, rv), ...)
    if len(old_key) != len(node_key):
        return None
    changed = []
    for i, (a, b) in enumerate(zip(old_key, node_key)):
        if a == b:
            continue
        if a[0] != b[0]:
            return None  # membership/order changed: rebuild
        changed.append(i)
        if len(changed) > delta_max:
            return None
    return np.asarray(changed, dtype=np.int64) if changed else None


def _compile_volumes(table, pods, bound_pods, volumes, enabled, statics, xs,
                     init_carry, host, device) -> None:
    """The volume family (compile.py:225-270): its tensors, and the
    PreFilter rejects fixed at compile time, keyed by the plugin whose
    PreFilter reports them (the earliest enabled prefilter in config
    order wins at decode time)."""
    p = len(pods)
    with _build_span("volume_table"):
        vt = build_volume_table(
            table, volumes.get("pvcs"), volumes.get("pvs"),
            volumes.get("storageclasses"), volumes.get("csinodes"),
        )
    host["volume_table"] = vt
    rejects: dict[str, list[str | None]] = {}
    if "VolumeRestrictions" in enabled:
        with _build_span("VolumeRestrictions"):
            st, x, carry = volumerestrictions.build(vt, table, pods, bound_pods, device=device)
            statics["VolumeRestrictions"] = st
            xs["VolumeRestrictions"] = x
            init_carry["VolumeRestrictions"] = carry
            # upstream VolumeRestrictions' PreFilter does the PVC lister
            # lookup first, so a missing PVC rejects there
            rejects["VolumeRestrictions"] = [_missing_pvc_message(vt, pod) for pod in pods]
    if "NodeVolumeLimits" in enabled:
        with _build_span("NodeVolumeLimits"):
            st, x, carry = nodevolumelimits.build(vt, table, pods, bound_pods, device=device)
            statics["NodeVolumeLimits"] = st
            xs["NodeVolumeLimits"] = x
            init_carry["NodeVolumeLimits"] = carry
    if "VolumeBinding" in enabled:
        with _build_span("VolumeBinding"):
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
        with _build_span("VolumeZone"):
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


def _pod_requests(pods: list[dict], schema: ResourceSchema, pod_columns=None):
    """[P, R] requests + [P, 2] nonzero rows (compile.py:345).  With a
    columnar pod view, rows are gathered from the bank's pre-parsed
    request columns by uid (one vectorized fancy-index per schema
    column); pods the bank can't answer (no uid match, opaque or deleted
    rows) are parsed from their manifests."""
    p = len(pods)
    requests = np.zeros((p, schema.n), dtype=np.int64)
    nonzero = np.zeros((p, 2), dtype=np.int64)
    misses = range(p)
    if pod_columns is not None and p:
        bank = pod_columns.bank
        by_uid = bank.row_by_uid
        rows = np.full(p, -1, dtype=np.int64)
        miss = []
        # the uid -> row mapping is dict lookups; the per-column gather
        # below is the vectorized part
        # kss-analyze: allow(pod-loop) a dict lookup a pod, on the host before the upload
        for i, pod in enumerate(pods):
            uid = (pod.get("metadata") or {}).get("uid")
            row = by_uid.get(uid) if uid else None
            if row is None or bank.opaque[row] or bank.deleted[row]:
                miss.append(i)
            else:
                rows[i] = row
        ok = rows >= 0
        if ok.any():
            okr = rows[ok]
            for j, rname in enumerate(schema.columns):
                col = bank.req.get(rname)
                if col is not None:
                    requests[ok, j] = col[okr]
            nonzero[ok] = bank.nonzero[okr]
            TRACER.count("compile_requests_gathered_total", int(ok.sum()))
        misses = miss
    for i in misses:
        requests[i], nonzero[i] = pod_resource_request(pods[i], schema)
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
    """compile.py:500: the compact transfer group of one scorer's raw."""
    if name in cw.host.get("static_score_rows", {}):
        # raw is a precompiled host-resident [P, N] row (custom scores
        # among them): it never travels back from the device — the replay
        # reads the host copy
        return "host"
    if name in _SCORE_I8_SAFE:
        return "i8"
    if name == "TaintToleration":
        # raw = count of intolerable PreferNoSchedule taints on the node
        if max((len(t) for t in cw.node_table.taints), default=0) <= 127:
            return "i8"
        return "i16"
    rows = None
    if name == "NodeAffinity":
        # only reached when every pod skips NodeAffinity scoring (no host
        # stash): the bound of the unique preference rows
        rows = cw.statics[name].pref_rows
    elif cw.config.is_custom(name) and hasattr(cw.xs.get(name), "scores"):
        # a custom plugin without a host stash (has_score False): bound 0
        rows = cw.xs[name].scores
    if rows is not None:
        a = _np(rows)
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
        elif name in _FILTER_CODE_BOUNDS:
            b = _FILTER_CODE_BOUNDS[name]
        elif name in cw.host.get("custom_msgs", {}):
            b = len(cw.host["custom_msgs"][name])
        else:
            b = 1 << 30  # unknown plugin: force wide packing
        bound = max(bound, b)
    return bound
