"""Label-selector / node-affinity / toleration matching (host-side).

A copy of kube_scheduler_simulator_tpu/state/selectors.py.

Everything in this module is *static* for the duration of a replay: node
labels and taints never change while pods schedule, and pod selectors are
fixed at admission.  So all of it is evaluated once, on the host, into
dense numpy arrays that the device-side kernels consume — matching is never
done on-device.  This is the key device-first restructuring of the reference's
hot loop (reference: simulator/scheduler/plugin/wrappedplugin.go:523-548
runs these matches per pod x node x plugin inside the Go scheduler).

Semantics follow upstream k8s.io/kubernetes v1.32 (pinned by the
reference's simulator/go.mod:59):

* v1.NodeSelector: OR over terms; term = AND over matchExpressions and
  matchFields; operators In, NotIn, Exists, DoesNotExist, Gt, Lt.
* metav1.LabelSelector: AND over matchLabels and matchExpressions
  (In, NotIn, Exists, DoesNotExist).
* Toleration.ToleratesTaint: key match (empty key + Exists tolerates all),
  operator Exists/Equal, effect match (empty effect matches all).
"""

from __future__ import annotations

import numpy as np

from .nodes import NodeTable


def _expr_matches_labels(expr: dict, labels: dict[str, str]) -> bool:
    key = expr.get("key", "")
    op = expr.get("operator", "")
    values = expr.get("values") or []
    has = key in labels
    if op == "In":
        return has and labels[key] in values
    if op == "NotIn":
        return has and labels[key] not in values
    if op == "Exists":
        return has
    if op == "DoesNotExist":
        return not has
    if op in ("Gt", "Lt"):
        # upstream requires exactly one integer value; an invalid
        # expression never matches
        if not has or len(values) != 1:
            return False
        try:
            lab = int(labels[key])
            val = int(values[0])
        except ValueError:
            return False
        return lab > val if op == "Gt" else lab < val
    return False


def node_selector_term_matches(term: dict, labels: dict[str, str], node_name: str) -> bool:
    """One v1.NodeSelectorTerm vs one node. Empty term matches nothing
    (upstream nodeaffinity.NewNodeSelector drops nil/empty terms)."""
    exprs = term.get("matchExpressions") or []
    fields = term.get("matchFields") or []
    if not exprs and not fields:
        return False
    for e in exprs:
        if not _expr_matches_labels(e, labels):
            return False
    for f in fields:
        # only metadata.name is a valid field selector on nodes
        if f.get("key") != "metadata.name":
            return False
        if not _expr_matches_labels(dict(f, key="metadata.name"), {"metadata.name": node_name}):
            return False
    return True


def node_selector_matches(selector: dict, labels: dict[str, str], node_name: str) -> bool:
    """v1.NodeSelector (OR over terms)."""
    terms = selector.get("nodeSelectorTerms") or []
    return any(node_selector_term_matches(t, labels, node_name) for t in terms)


def label_selector_matches(selector: dict | None, labels: dict[str, str]) -> bool:
    """metav1.LabelSelector. A nil selector matches nothing; an empty
    selector ({}) matches everything (apimachinery semantics)."""
    if selector is None:
        return False
    for k, v in (selector.get("matchLabels") or {}).items():
        if labels.get(k) != str(v):
            return False
    for e in selector.get("matchExpressions") or []:
        if not _expr_matches_labels(e, labels):
            return False
    return True


def spec_key(*parts) -> str:
    """Canonical cache key for selector/toleration specs.  Pods stamped
    from one template share these specs, so the plugin build steps memoize per-node
    match rows per unique spec instead of re-matching per (pod, node)."""
    import json

    return json.dumps(parts, sort_keys=True, separators=(",", ":"))


def object_matches_label_selector(selector: dict | None, obj: dict) -> bool:
    """label_selector_matches against an object's metadata.labels, with
    values stringified the way the apiserver stores them."""
    labels = {
        k: str(v)
        for k, v in (((obj.get("metadata") or {}).get("labels")) or {}).items()
    }
    return label_selector_matches(selector, labels)


def toleration_tolerates(tol: dict, taint_key: str, taint_value: str, taint_effect: str) -> bool:
    """upstream v1.Toleration.ToleratesTaint."""
    if tol.get("effect") and tol["effect"] != taint_effect:
        return False
    key = tol.get("key") or ""
    op = tol.get("operator") or "Equal"
    if key:
        if key != taint_key:
            return False
    elif op != "Exists":
        # empty key with operator Equal never matches
        return False
    if op == "Exists":
        return True
    if op == "Equal":
        return (tol.get("value") or "") == taint_value
    return False


def tolerations_tolerate(tolerations: list[dict], taint_key, taint_value, taint_effect) -> bool:
    return any(toleration_tolerates(t, taint_key, taint_value, taint_effect) for t in tolerations)


# ---------------------------------------------------------------------------
# dense pod x node precompilation helpers
# ---------------------------------------------------------------------------

def pods_match_label_selector(selector: dict | None, pods: list[dict]) -> np.ndarray:
    """[P] bool: which pods' labels match the selector."""
    out = np.zeros(len(pods), dtype=bool)
    for i, pod in enumerate(pods):
        labels = {k: str(v) for k, v in ((pod.get("metadata") or {}).get("labels") or {}).items()}
        out[i] = label_selector_matches(selector, labels)
    return out


def has_untolerated_do_not_schedule_taint(taints, tolerations) -> bool:
    """upstream helper.DoNotScheduleTaintsFilterFunc: does the node carry a
    NoSchedule/NoExecute taint the pod's tolerations don't cover?
    taints: [(key, value, effect)] as NodeTable.taints stores them."""
    from .nodes import NO_EXECUTE, NO_SCHEDULE

    for key, value, eff in taints:
        if eff in (NO_SCHEDULE, NO_EXECUTE) and not tolerations_tolerate(
                tolerations, key, value, eff):
            return True
    return False


# ---------------------------------------------------------------- vectorized
# Columnar matching over ALL nodes at once: workload compilation evaluates
# a few hundred unique selector specs against thousands of nodes, and the
# per-(spec, node) scalar walk above dominated compile_workload at 5k
# nodes.  A LabelIndex interns each label key into one object-dtype numpy
# column; each expression then evaluates as one vector op over [N].

class LabelIndex:
    """Per-key columns of node label values (None = key absent)."""

    def __init__(self, labels: list[dict[str, str]], names: list[str]):
        self.n = len(labels)
        self.names = np.asarray(names, dtype=object)
        self._labels = labels
        self._cols: dict[str, np.ndarray] = {}

    def column(self, key: str) -> np.ndarray:
        col = self._cols.get(key)
        if col is None:
            fast = getattr(self._labels, "column", None)
            if fast is not None:
                # columnar label rows (cluster/columnar._LabelRows):
                # the interned column gathered without per-row Python
                col = fast(key)
            else:
                col = np.array([lab.get(key) for lab in self._labels],
                               dtype=object)
            self._cols[key] = col
        return col


def _expr_rows(expr: dict, idx: LabelIndex, col: np.ndarray) -> np.ndarray:
    """_expr_matches_labels vectorized: [N] bool for one expression."""
    op = expr.get("operator", "")
    values = expr.get("values") or []
    has = np.not_equal(col, None)
    if op == "In":
        return has & np.isin(col, np.array(values, dtype=object))
    if op == "NotIn":
        return has & ~np.isin(col, np.array(values, dtype=object))
    if op == "Exists":
        return has
    if op == "DoesNotExist":
        return ~has
    if op in ("Gt", "Lt"):
        if len(values) != 1:
            return np.zeros(idx.n, dtype=bool)
        try:
            val = int(values[0])
        except ValueError:
            return np.zeros(idx.n, dtype=bool)
        out = np.zeros(idx.n, dtype=bool)
        for j in np.flatnonzero(has):
            try:
                lab = int(col[j])
            except ValueError:
                continue
            out[j] = lab > val if op == "Gt" else lab < val
        return out
    return np.zeros(idx.n, dtype=bool)


def node_selector_term_rows(term: dict, idx: LabelIndex) -> np.ndarray:
    """node_selector_term_matches over all nodes: [N] bool."""
    exprs = term.get("matchExpressions") or []
    fields = term.get("matchFields") or []
    if not exprs and not fields:
        return np.zeros(idx.n, dtype=bool)
    out = np.ones(idx.n, dtype=bool)
    for e in exprs:
        out &= _expr_rows(e, idx, idx.column(e.get("key", "")))
    for f in fields:
        if f.get("key") != "metadata.name":
            return np.zeros(idx.n, dtype=bool)
        out &= _expr_rows(f, idx, idx.names)
    return out


def node_selector_rows(selector: dict, idx: LabelIndex) -> np.ndarray:
    """node_selector_matches over all nodes: [N] bool (OR over terms)."""
    out = np.zeros(idx.n, dtype=bool)
    for t in selector.get("nodeSelectorTerms") or []:
        out |= node_selector_term_rows(t, idx)
    return out


def match_labels_rows(match_labels: dict, idx: LabelIndex) -> np.ndarray:
    """nodeSelector-style exact matchLabels over all nodes: [N] bool."""
    out = np.ones(idx.n, dtype=bool)
    for k, v in match_labels.items():
        out &= np.equal(idx.column(k), str(v))
    return out
