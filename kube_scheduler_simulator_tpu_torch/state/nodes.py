"""Columnar node table (port of kube_scheduler_simulator_tpu/state/nodes.py:1-100).

The columnar build and patch paths (`build_node_table_columnar`,
`patch_node_table*`) are not ported yet: they wait for the engine slice.

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
    # per-node label dicts / taint tuple lists
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
