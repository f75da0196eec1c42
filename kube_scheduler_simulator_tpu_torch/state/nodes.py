"""Columnar node table.

A copy of kube_scheduler_simulator_tpu/state/nodes.py, host code with its
imports rewired to the port.

Parses a list of Node manifests (plain dicts, same shape the reference
handles as unstructured objects via client-go) into dense numpy arrays +
per-node label/taint structures.  This is the host-side half of the state
split: label/taint *structure* is static during a replay, so it lives here
and gets baked into dense match arrays by compile.py; the *resource
accumulators* become the device-side carry.

Reference behavior mirrored: the scheduler sees allocatable via
NodeInfo.Allocatable; pods-per-node via AllowedPodNumber; unschedulable
nodes are filtered by the NodeUnschedulable plugin (tolerated by pods that
tolerate the node.kubernetes.io/unschedulable:NoSchedule taint).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .resources import ResourceSchema

NO_SCHEDULE = "NoSchedule"
PREFER_NO_SCHEDULE = "PreferNoSchedule"
NO_EXECUTE = "NoExecute"


@dataclass
class NodeTable:
    names: list[str]
    allocatable: np.ndarray        # [N, R] int64
    allowed_pods: np.ndarray       # [N]    int64
    initial_requested: np.ndarray  # [N, R] int64 (from already-bound pods)
    initial_nonzero: np.ndarray    # [N, 2] int64
    initial_num_pods: np.ndarray   # [N]    int64
    # per-node label dicts / taint tuple lists: a plain list from the
    # manifest build, or a lazy columnar sequence (_LabelRows/_TaintRows,
    # cluster/columnar.py) that synthesizes rows on demand — consumers
    # index/iterate either
    labels: "list[dict[str, str]]"
    taints: "list[list[tuple[str, str, str]]]"
    unschedulable: np.ndarray      # [N] bool

    @property
    def n(self) -> int:
        return len(self.names)

    @property
    def label_index(self):
        """Lazy columnar label index for vectorized selector matching
        (state/selectors.LabelIndex); cached on the table."""
        idx = getattr(self, "_label_index", None)
        if idx is None:
            from .selectors import LabelIndex

            idx = LabelIndex(self.labels, self.names)
            object.__setattr__(self, "_label_index", idx)
        return idx


def build_node_table(nodes: list[dict], schema: ResourceSchema) -> NodeTable:
    n = len(nodes)
    names: list[str] = []
    allocatable = np.zeros((n, schema.n), dtype=np.int64)
    allowed = np.full(n, 110, dtype=np.int64)  # kubelet default max-pods
    labels: list[dict[str, str]] = []
    taints: list[list[tuple[str, str, str]]] = []
    unsched = np.zeros(n, dtype=bool)

    for i, node in enumerate(nodes):
        meta = node.get("metadata") or {}
        name = meta.get("name", f"node-{i}")
        names.append(name)
        status = node.get("status") or {}
        alloc = status.get("allocatable") or {}
        allocatable[i] = schema.parse_map(alloc)
        if "pods" in alloc:
            allowed[i] = int(float(alloc["pods"]))
        lab = {k: str(v) for k, v in (meta.get("labels") or {}).items()}
        # kubernetes.io/hostname is implicit on real nodes; KWOK sets it too.
        lab.setdefault("kubernetes.io/hostname", name)
        labels.append(lab)
        spec = node.get("spec") or {}
        taints.append([
            (t.get("key", ""), str(t.get("value", "")), t.get("effect", NO_SCHEDULE))
            for t in spec.get("taints") or []
        ])
        unsched[i] = bool(spec.get("unschedulable", False))

    return NodeTable(
        names=names,
        allocatable=allocatable,
        allowed_pods=allowed,
        initial_requested=np.zeros((n, schema.n), dtype=np.int64),
        initial_nonzero=np.zeros((n, 2), dtype=np.int64),
        initial_num_pods=np.zeros(n, dtype=np.int64),
        labels=labels,
        taints=taints,
        unschedulable=unsched,
    )


def _parse_node_row(node: dict, name: str, schema: ResourceSchema):
    """One node manifest -> (alloc_row, allowed, labels, taints, unsched)
    — the same parse build_node_table does per row, for the columnar
    opaque-row fallback and the delta patch."""
    meta = node.get("metadata") or {}
    status = node.get("status") or {}
    alloc = status.get("allocatable") or {}
    row = schema.parse_map(alloc)
    allowed = int(float(alloc["pods"])) if "pods" in alloc else 110
    lab = {k: str(v) for k, v in (meta.get("labels") or {}).items()}
    lab.setdefault("kubernetes.io/hostname", name)
    spec = node.get("spec") or {}
    taints = [
        (t.get("key", ""), str(t.get("value", "")), t.get("effect", NO_SCHEDULE))
        for t in spec.get("taints") or []
    ]
    return row, allowed, lab, taints, bool(spec.get("unschedulable", False))


def build_node_table_columnar(cols, schema: ResourceSchema) -> NodeTable:
    """NodeTable from a columnar view (cluster/columnar.NodeColumns):
    the numeric surface is gathered vectorized from the bank columns and
    labels/taints stay lazy sequences over the captured column refs — no
    per-node Python loop except for OPAQUE rows (sync faults), which are
    re-parsed from their manifests and patched in as overrides."""
    n = cols.n
    allocatable = cols.alloc_matrix(schema.columns)
    allowed = cols.allowed_pods().copy()
    unsched = cols.unschedulable()
    labels = cols.label_rows()
    taints = cols.taint_rows()
    lab_over: dict[int, dict] = {}
    taint_over: dict[int, list] = {}
    for pos in cols.opaque_positions():
        pos = int(pos)
        row, a, lab, tnt, us = _parse_node_row(
            cols.row_manifest(pos), cols.names[pos], schema)
        allocatable[pos] = row
        allowed[pos] = a
        unsched[pos] = us
        lab_over[pos] = lab
        taint_over[pos] = tnt
    if lab_over:
        labels = labels.with_overrides(lab_over)
        taints = taints.with_overrides(taint_over)
    return NodeTable(
        names=list(cols.names),
        allocatable=allocatable,
        allowed_pods=allowed,
        initial_requested=np.zeros((n, schema.n), dtype=np.int64),
        initial_nonzero=np.zeros((n, 2), dtype=np.int64),
        initial_num_pods=np.zeros(n, dtype=np.int64),
        labels=labels,
        taints=taints,
        unschedulable=unsched,
    )


def patch_node_table(table: NodeTable, nodes: list[dict],
                     changed: "np.ndarray", schema: ResourceSchema) -> NodeTable:
    """Delta path, dict source: same node names in the same order, only
    `changed` positions' manifests differ — re-parse those rows into
    copies of the previous wave's arrays instead of rebuilding all N.
    Returns a NEW NodeTable (tables are immutable snapshots; replay
    buffers may still pin the old one)."""
    allocatable = table.allocatable.copy()
    allowed = table.allowed_pods.copy()
    unsched = table.unschedulable.copy()
    labels = list(table.labels)
    taints = list(table.taints)
    for i in changed:
        i = int(i)
        name = (nodes[i].get("metadata") or {}).get("name", f"node-{i}")
        row, a, lab, tnt, us = _parse_node_row(nodes[i], name, schema)
        allocatable[i] = row
        allowed[i] = a
        unsched[i] = us
        labels[i] = lab
        taints[i] = tnt
    return NodeTable(
        names=table.names,
        allocatable=allocatable,
        allowed_pods=allowed,
        # always zeros at build time; compile copies before priming
        initial_requested=table.initial_requested,
        initial_nonzero=table.initial_nonzero,
        initial_num_pods=table.initial_num_pods,
        labels=labels,
        taints=taints,
        unschedulable=unsched,
    )


def patch_node_table_columnar(table: NodeTable, cols,
                              changed: "np.ndarray",
                              schema: ResourceSchema) -> NodeTable:
    """Delta path, columnar source: gather only the changed rows from
    the current bank columns into copies of the previous wave's arrays.
    Labels/taints for changed rows come in as overrides over the OLD
    lazy sequences (whose captured column refs predate the update's
    copy-on-write)."""
    allocatable = table.allocatable.copy()
    allowed = table.allowed_pods.copy()
    unsched = table.unschedulable.copy()
    rows = cols.rows[changed]
    bank = cols.bank
    for j, rname in enumerate(schema.columns):
        col = bank.res.get(rname)
        allocatable[changed, j] = col[rows] if col is not None else 0
    allowed[changed] = bank.allowed_pods[rows]
    unsched[changed] = bank.unschedulable[rows]
    fresh_labels = cols.label_rows()
    fresh_taints = cols.taint_rows()
    lab_over: dict[int, dict] = {}
    taint_over: dict[int, list] = {}
    opaque = set(int(p) for p in cols.opaque_positions())
    for pos in changed:
        pos = int(pos)
        if pos in opaque:
            row, a, lab, tnt, us = _parse_node_row(
                cols.row_manifest(pos), cols.names[pos], schema)
            allocatable[pos] = row
            allowed[pos] = a
            unsched[pos] = us
            lab_over[pos] = lab
            taint_over[pos] = tnt
        else:
            lab_over[pos] = fresh_labels[pos]
            taint_over[pos] = fresh_taints[pos]
    labels = (table.labels.with_overrides(lab_over)
              if hasattr(table.labels, "with_overrides")
              else _list_with(table.labels, lab_over))
    taints = (table.taints.with_overrides(taint_over)
              if hasattr(table.taints, "with_overrides")
              else _list_with(table.taints, taint_over))
    return NodeTable(
        names=table.names,
        allocatable=allocatable,
        allowed_pods=allowed,
        initial_requested=table.initial_requested,
        initial_nonzero=table.initial_nonzero,
        initial_num_pods=table.initial_num_pods,
        labels=labels,
        taints=taints,
        unschedulable=unsched,
    )


def _list_with(seq, overrides: dict[int, object]) -> list:
    out = list(seq)
    for i, v in overrides.items():
        out[i] = v
    return out
