"""Columnar node/pod data plane: hot fields in numpy columns.

A copy of kube_scheduler_simulator_tpu/cluster/columnar.py, host code with
its imports rewired to the port.

The dict ObjectStore keeps every object as a full manifest dict; at
100k nodes the per-wave compile re-parses 100k dicts and every listing
materializes 100k Python objects.  This module is the columnar backing
that removes the node axis from Python:

  * `ColumnarNodeBank` / `ColumnarPodBank` — hot fields (name,
    resourceVersion, allocatable/request columns, interned labels,
    taints, pod phase/nodeName) live in numpy arrays, one row per
    object incarnation.  Rows are append-only: a delete tombstones its
    row and a re-create gets a fresh row, so a row index captured by an
    old snapshot can never be re-pointed at a different object.
  * `LazyManifest` — the compat shim: a dict subclass the store keeps
    as the stored object for bulk-loaded rows; it synthesizes its full
    manifest from the bank columns on first real access and behaves
    exactly like the eager dict afterwards.  Consumers that never touch
    a row (the engine's node listings) never pay the synthesis.
  * `NodeColumns` / `PodColumns` — read views the store attaches to
    shared listings (`ColumnarManifestList.columns`): a sorted row-index
    gather over the bank that `state/compile.py` consumes directly,
    vectorized, instead of re-parsing manifests.

Write-path consistency: the manifest (stored dict) is always the source
of truth for rows written through the dict CRUD; the columns are a
synchronized cache (`sync_from_manifest`, guarded by the
`store.columnar_sync` fault seam).  A failed sync marks the row OPAQUE:
readers fall back to the manifest for that row, so a mid-sync fault
degrades to the dict path instead of corrupting the shim.

Snapshot safety: numeric/label/taint columns captured by a compiled
NodeTable are never mutated in place after an update — the bank
replaces whole column arrays copy-on-write (`_cow`), so a previous
wave's table (still pinned by lazy annotation decode) keeps reading the
bytes it captured.
"""

from __future__ import annotations

import itertools
import threading
from typing import Callable

import numpy as np

from ..utils.quantity import parse_cpu_milli, parse_memory_bytes

_BASE_RES = ("cpu", "memory", "ephemeral-storage")
_HOSTNAME = "kubernetes.io/hostname"
_BANK_IDS = itertools.count(1)

DEFAULT_ALLOWED_PODS = 110  # kubelet default max-pods (state/nodes.py)


class LazyManifest(dict):
    """A stored object that synthesizes itself from bank columns on
    first access.  Until filled, the underlying dict storage is EMPTY —
    every dict-protocol entry point below materializes first, so any
    consumer holding one observes exactly the eager manifest's content.

    json.dumps's C encoder walks dict storage directly (bypassing these
    overrides): serialization paths that stream stored objects must call
    `fill()` / `LazyManifest.ensure(obj)` first (StreamWriter.send does;
    copying reads materialize through __deepcopy__)."""

    __slots__ = ("_bank", "_row")

    def __init__(self, bank, row: int):
        super().__init__()
        self._bank = bank
        self._row = row

    def fill(self) -> None:
        bank = self._bank
        if bank is not None:
            # update BEFORE clearing _bank: a concurrent reader must
            # never observe "filled" with empty dict storage (the update
            # of a str-keyed dict is atomic under the GIL; a double fill
            # writes identical content)
            dict.update(self, bank.synthesize(self._row))
            self._bank = None

    @staticmethod
    def ensure(obj):
        """Materialize obj if it is a lazy row; returns obj."""
        if type(obj) is LazyManifest:
            obj.fill()
        return obj

    # -- reads
    def __getitem__(self, k):
        self.fill()
        return dict.__getitem__(self, k)

    def get(self, k, default=None):
        self.fill()
        return dict.get(self, k, default)

    def __contains__(self, k):
        self.fill()
        return dict.__contains__(self, k)

    def __iter__(self):
        self.fill()
        return dict.__iter__(self)

    def __len__(self):
        self.fill()
        return dict.__len__(self)

    def keys(self):
        self.fill()
        return dict.keys(self)

    def values(self):
        self.fill()
        return dict.values(self)

    def items(self):
        self.fill()
        return dict.items(self)

    def __eq__(self, other):
        self.fill()
        if type(other) is LazyManifest:
            other.fill()
        return dict.__eq__(self, other)

    def __ne__(self, other):
        return not self.__eq__(other)

    __hash__ = None  # dicts are unhashable; keep that

    def __repr__(self):
        self.fill()
        return dict.__repr__(self)

    def copy(self):
        self.fill()
        return dict(self)

    def __copy__(self):
        self.fill()
        return dict(self)

    def __deepcopy__(self, memo):
        import copy as _copy

        self.fill()
        return _copy.deepcopy(dict(self), memo)

    def __reduce__(self):
        self.fill()
        return (dict, (), None, None, iter(dict.items(self)))

    # -- writes (stored objects are replace-on-update, but be safe)
    def __setitem__(self, k, v):
        self.fill()
        dict.__setitem__(self, k, v)

    def __delitem__(self, k):
        self.fill()
        dict.__delitem__(self, k)

    def setdefault(self, k, default=None):
        self.fill()
        return dict.setdefault(self, k, default)

    def update(self, *a, **kw):
        self.fill()
        dict.update(self, *a, **kw)

    def pop(self, *a):
        self.fill()
        return dict.pop(self, *a)

    def popitem(self):
        self.fill()
        return dict.popitem(self)


def _grow(arr: np.ndarray, cap: int) -> np.ndarray:
    out = np.zeros(cap, dtype=arr.dtype)
    out[: len(arr)] = arr
    return out


class _ColumnarBank:
    """Row machinery shared by the node and pod banks."""

    def __init__(self, capacity: int = 64):
        self.bank_id = next(_BANK_IDS)
        cap = max(int(capacity), 1)
        self.n = 0                       # rows allocated (incl. tombstones)
        self.names: list[str] = []
        self.rv = np.zeros(cap, dtype=np.int64)
        self.opaque = np.zeros(cap, dtype=bool)
        self.deleted = np.zeros(cap, dtype=bool)
        self.uid: list[str | None] = []
        self.created: list[str | None] = []
        self.manifests: list[dict | None] = []   # dict-backed rows
        self.row_of: dict[str, int] = {}         # live key -> row
        self.names_version = 0           # bumps on add/delete (membership)
        self.uid_factory: Callable[[], str] | None = None
        self._uid_lock = threading.Lock()
        # label columns: key -> object array (None = absent); replaced
        # copy-on-write on update so captured snapshots stay stable
        self.label_cols: dict[str, np.ndarray] = {}

    # -------------------------------------------------------------- rows
    def _cap(self) -> int:
        return len(self.rv)

    def _ensure_cap(self, need: int) -> None:
        cap = self._cap()
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        self.rv = _grow(self.rv, cap)
        self.opaque = _grow(self.opaque, cap)
        self.deleted = _grow(self.deleted, cap)
        self.label_cols = {
            k: self._grow_obj(col, cap) for k, col in self.label_cols.items()
        }
        self._grow_extra(cap)

    @staticmethod
    def _grow_obj(col: np.ndarray, cap: int) -> np.ndarray:
        out = np.empty(cap, dtype=object)
        out[: len(col)] = col
        return out

    def _grow_extra(self, cap: int) -> None:  # subclass columns
        raise NotImplementedError

    def new_row(self, key: str) -> int:
        """Append a fresh row for `key` (replacing any tombstoned one)."""
        row = self.n
        self._ensure_cap(row + 1)
        self.n += 1
        self.names.append(key)
        self.uid.append(None)
        self.created.append(None)
        self.manifests.append(None)
        self.row_of[key] = row
        self.names_version += 1
        return row

    def bulk_rows(self, names: list[str]) -> int:
        """Append len(names) fresh rows at once (generator fast path);
        returns the first row index.  Column payloads are written by the
        caller directly into the bank arrays."""
        start = self.n
        count = len(names)
        self._ensure_cap(start + count)
        self.n = start + count
        self.names.extend(names)
        self.uid.extend([None] * count)
        self.created.extend([None] * count)
        self.manifests.extend([None] * count)
        row_of = self.row_of
        for i, k in enumerate(names, start):
            row_of[k] = i
        self.names_version += 1
        return start

    def drop(self, key: str) -> None:
        row = self.row_of.pop(key, None)
        if row is not None:
            self.deleted[row] = True
            self.names_version += 1

    # ------------------------------------------------- copy-on-write sets
    def _cow_label(self, key: str, row: int, value) -> None:
        col = self.label_cols.get(key)
        if col is None:
            col = np.empty(self._cap(), dtype=object)
            self.label_cols[key] = col
        else:
            col = col.copy()
            self.label_cols[key] = col
        col[row] = value

    def _set_labels(self, row: int, labels: dict[str, str],
                    cow: bool) -> None:
        if cow:
            for key in self.label_cols:
                if key not in labels and self.label_cols[key][row] is not None:
                    self._cow_label(key, row, None)
            for key, val in labels.items():
                col = self.label_cols.get(key)
                if col is None or col[row] != val:
                    self._cow_label(key, row, val)
        else:
            for key in self.label_cols:
                if key not in labels:
                    self.label_cols[key][row] = None
            for key, val in labels.items():
                col = self.label_cols.get(key)
                if col is None:
                    col = np.empty(self._cap(), dtype=object)
                    self.label_cols[key] = col
                col[row] = val

    # ----------------------------------------------------------- helpers
    def ensure_uid(self, row: int) -> str:
        u = self.uid[row]
        if u is None:
            with self._uid_lock:
                u = self.uid[row]
                if u is None:
                    u = (self.uid_factory or _default_uid)()
                    self.uid[row] = u
        return u

    def row_manifest(self, row: int) -> dict:
        """The authoritative manifest for a row: the stored dict when
        dict-backed, a fresh synthesis otherwise."""
        m = self.manifests[row]
        return m if m is not None else self.synthesize(row)

    def synthesize(self, row: int) -> dict:  # subclass responsibility
        raise NotImplementedError


def _default_uid() -> str:
    import uuid

    return str(uuid.uuid4())


class ColumnarNodeBank(_ColumnarBank):
    """Node hot fields.  Resource columns are registered on demand
    (`res`/`res_present`, parsed base units); `taints` rows are
    immutable lists replaced copy-on-write."""

    def __init__(self, capacity: int = 64):
        super().__init__(capacity)
        cap = self._cap()
        self.res: dict[str, np.ndarray] = {}
        self.res_present: dict[str, np.ndarray] = {}
        self.allowed_pods = np.full(cap, DEFAULT_ALLOWED_PODS, dtype=np.int64)
        self.unschedulable = np.zeros(cap, dtype=bool)
        self.taints: list[list[tuple[str, str, str]]] = []

    def _grow_extra(self, cap: int) -> None:
        self.res = {k: _grow(c, cap) for k, c in self.res.items()}
        self.res_present = {k: _grow(c, cap)
                            for k, c in self.res_present.items()}
        grown = np.full(cap, DEFAULT_ALLOWED_PODS, dtype=np.int64)
        grown[: len(self.allowed_pods)] = self.allowed_pods
        self.allowed_pods = grown
        self.unschedulable = _grow(self.unschedulable, cap)

    def new_row(self, key: str) -> int:
        row = super().new_row(key)
        self.taints.append([])
        return row

    def bulk_rows(self, names: list[str]) -> int:
        start = super().bulk_rows(names)
        self.taints.extend([] for _ in names)
        return start

    def _res_col(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        col = self.res.get(name)
        if col is None:
            col = np.zeros(self._cap(), dtype=np.int64)
            self.res[name] = col
            self.res_present[name] = np.zeros(self._cap(), dtype=bool)
        return col, self.res_present[name]

    def _set_alloc(self, row: int, alloc: dict, cow: bool) -> None:
        names = set()
        for name, value in (alloc or {}).items():
            if name == "pods":
                v = int(float(value))
                if cow:
                    self.allowed_pods = self.allowed_pods.copy()
                self.allowed_pods[row] = v
                continue
            parsed = (parse_cpu_milli(value) if name == "cpu"
                      else parse_memory_bytes(value))
            names.add(name)
            col, present = self._res_col(name)
            if cow:
                col = col.copy()
                present = present.copy()
                self.res[name] = col
                self.res_present[name] = present
            col[row] = parsed
            present[row] = True
        if "pods" not in (alloc or {}):
            if cow and self.allowed_pods[row] != DEFAULT_ALLOWED_PODS:
                self.allowed_pods = self.allowed_pods.copy()
            self.allowed_pods[row] = DEFAULT_ALLOWED_PODS
        for name in self.res:
            if name not in names and self.res_present[name][row]:
                if cow:
                    self.res[name] = self.res[name].copy()
                    self.res_present[name] = self.res_present[name].copy()
                self.res[name][row] = 0
                self.res_present[name][row] = False

    def sync_from_manifest(self, row: int, obj: dict, cow: bool) -> None:
        """Refresh a row's columns from its manifest (the dict write
        path).  Raises on malformed input — the caller marks the row
        opaque and the manifest stays the source of truth."""
        meta = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        status = obj.get("status") or {}
        self._set_alloc(row, status.get("allocatable") or {}, cow)
        labels = {k: str(v) for k, v in (meta.get("labels") or {}).items()}
        # the implicit hostname label, defaulted exactly where
        # state/nodes.build_node_table defaults it
        labels.setdefault(_HOSTNAME, meta.get("name", self.names[row]))
        self._set_labels(row, labels, cow)
        taints = [
            (t.get("key", ""), str(t.get("value", "")),
             t.get("effect", "NoSchedule"))
            for t in spec.get("taints") or []
        ]
        if cow:
            if taints != self.taints[row]:
                self.taints = list(self.taints)
                self.taints[row] = taints
            self.unschedulable = self.unschedulable.copy()
        else:
            self.taints[row] = taints
        self.unschedulable[row] = bool(spec.get("unschedulable", False))

    # --------------------------------------------------------- synthesis
    def synthesize(self, row: int) -> dict:
        """The full manifest for a generator-created row, byte-identical
        in content to the dict the eager generator + store create path
        would have stored (field insertion order mirrors that path)."""
        name = self.names[row]
        labels: dict[str, str] = {}
        for key, col in self.label_cols.items():
            v = col[row]
            if v is not None:
                labels[key] = v
        meta: dict = {"name": name, "labels": labels}
        meta["uid"] = self.ensure_uid(row)
        meta["resourceVersion"] = str(int(self.rv[row]))
        if self.created[row] is not None:
            meta["creationTimestamp"] = self.created[row]
        spec: dict = {}
        if self.taints[row]:
            spec["taints"] = [
                {"key": k, "value": v, "effect": e}
                for k, v, e in self.taints[row]
            ]
        if self.unschedulable[row]:
            spec["unschedulable"] = True
        alloc: dict = {}
        for rname in _BASE_RES:
            present = self.res_present.get(rname)
            if present is not None and present[row]:
                val = int(self.res[rname][row])
                alloc[rname] = f"{val}m" if rname == "cpu" else str(val)
        for rname, present in self.res_present.items():
            if rname not in _BASE_RES and present[row]:
                alloc[rname] = str(int(self.res[rname][row]))
        alloc["pods"] = str(int(self.allowed_pods[row]))
        return {
            "apiVersion": "v1",
            "kind": "Node",
            "metadata": meta,
            "spec": spec,
            "status": {
                "allocatable": alloc,
                "conditions": [{"type": "Ready", "status": "True"}],
            },
        }

    def view(self, keys: list[str] | None = None) -> "NodeColumns":
        if keys is None:
            keys = sorted(self.row_of)
        rows = np.fromiter((self.row_of[k] for k in keys),
                           dtype=np.int64, count=len(keys))
        return NodeColumns(self, keys, rows)


class ColumnarPodBank(_ColumnarBank):
    """Pod hot fields: phase/nodeName handles and the parsed resource
    request rows compile_workload gathers by uid instead of re-parsing
    every pod's containers each wave."""

    def __init__(self, capacity: int = 64):
        super().__init__(capacity)
        cap = self._cap()
        self.namespace: list[str] = []
        self.phase = np.empty(cap, dtype=object)
        self.node_name = np.empty(cap, dtype=object)
        self.req: dict[str, np.ndarray] = {}       # resource -> int64 col
        self.nonzero = np.zeros((cap, 2), dtype=np.int64)
        self.row_by_uid: dict[str, int] = {}

    def _grow_extra(self, cap: int) -> None:
        self.phase = self._grow_obj(self.phase, cap)
        self.node_name = self._grow_obj(self.node_name, cap)
        self.req = {k: _grow(c, cap) for k, c in self.req.items()}
        nz = np.zeros((cap, 2), dtype=np.int64)
        nz[: len(self.nonzero)] = self.nonzero
        self.nonzero = nz

    def new_row(self, key: str) -> int:
        row = super().new_row(key)
        self.namespace.append(key.partition("/")[0])
        return row

    def bulk_rows(self, names: list[str]) -> int:
        start = super().bulk_rows(names)
        self.namespace.extend(k.partition("/")[0] for k in names)
        return start

    def ensure_uid(self, row: int) -> str:
        u = self.uid[row]
        if u is None:
            u = super().ensure_uid(row)
            self.row_by_uid[u] = row
        return u

    def _req_col(self, name: str) -> np.ndarray:
        col = self.req.get(name)
        if col is None:
            col = np.zeros(self._cap(), dtype=np.int64)
            self.req[name] = col
        return col

    def sync_from_manifest(self, row: int, obj: dict, cow: bool) -> None:
        """Refresh pod hot columns.  The request row is parsed ONCE here
        (same math as state/resources.pod_resource_request, over the
        pod's own resource names) and gathered per wave-schema column at
        compile time.  Raises on malformed input — caller marks opaque."""
        from ..state.resources import ResourceSchema, pod_resource_request

        meta = obj.get("metadata") or {}
        spec = obj.get("spec") or {}
        status = obj.get("status") or {}
        uid = meta.get("uid")
        if uid:
            old = self.uid[row]
            if old and old != uid:
                self.row_by_uid.pop(old, None)
            self.uid[row] = uid
            self.row_by_uid[uid] = row
        self.phase[row] = status.get("phase")
        self.node_name[row] = spec.get("nodeName")
        ext: set[str] = set()
        for c in (spec.get("containers") or []) + (spec.get("initContainers") or []):
            for rname in ((c.get("resources") or {}).get("requests")) or {}:
                if rname not in _BASE_RES and rname != "pods":
                    ext.add(rname)
        for rname in spec.get("overhead") or {}:
            if rname not in _BASE_RES and rname != "pods":
                ext.add(rname)
        schema = ResourceSchema(tuple(sorted(ext)))
        total, nonzero = pod_resource_request(obj, schema)
        for j, rname in enumerate(schema.columns):
            self._req_col(rname)[row] = total[j]
        for rname in self.req:
            if rname not in schema.columns:
                self.req[rname][row] = 0
        self.nonzero[row] = nonzero
        labels = {k: str(v) for k, v in (meta.get("labels") or {}).items()}
        self._set_labels(row, labels, cow=False)

    def request_row(self, uid: str, columns: tuple[str, ...]):
        """(total[R], nonzero[2]) for a synced pod, or None when the row
        is missing/opaque (caller falls back to the per-pod parse)."""
        row = self.row_by_uid.get(uid)
        if row is None or self.opaque[row] or self.deleted[row]:
            return None
        total = np.zeros(len(columns), dtype=np.int64)
        for j, rname in enumerate(columns):
            col = self.req.get(rname)
            if col is not None:
                total[j] = col[row]
        return total, self.nonzero[row].copy()

    # --------------------------------------------------------- synthesis
    def synthesize(self, row: int) -> dict:
        name = self.names[row].partition("/")[2]
        labels: dict[str, str] = {}
        for key, col in self.label_cols.items():
            v = col[row]
            if v is not None:
                labels[key] = v
        meta: dict = {
            "name": name,
            "namespace": self.namespace[row],
        }
        if labels:
            meta["labels"] = labels
        meta["uid"] = self.ensure_uid(row)
        meta["resourceVersion"] = str(int(self.rv[row]))
        if self.created[row] is not None:
            meta["creationTimestamp"] = self.created[row]
        cpu = int(self._req_col("cpu")[row])
        mem = int(self._req_col("memory")[row])
        spec: dict = {
            "containers": [{
                "name": "main",
                "image": "registry.k8s.io/pause:3.9",
                "resources": {"requests": {"cpu": f"{cpu}m",
                                           "memory": str(mem)}},
            }],
        }
        aff = self.synth_affinity(row)
        if aff is not None:
            spec["affinity"] = aff
        obj = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": meta,
            "spec": spec,
        }
        if self.phase[row] or self.node_name[row]:
            if self.node_name[row]:
                spec["nodeName"] = self.node_name[row]
            if self.phase[row]:
                obj["status"] = {"phase": self.phase[row]}
        return obj

    # required-only nodeAffinity templates for generated pods: code 0 =
    # none; codes 1..K index `affinity_templates` (models/workloads.py
    # registers them); stored per row so synthesis is exact
    affinity_templates: list[dict] = []

    def synth_affinity(self, row: int) -> dict | None:
        code_col = getattr(self, "_affinity_code", None)
        if code_col is None:
            return None
        code = int(code_col[row])
        if code <= 0 or code > len(self.affinity_templates):
            return None
        import copy as _copy

        return _copy.deepcopy(self.affinity_templates[code - 1])

    def set_affinity_codes(self, codes: np.ndarray,
                           templates: list[dict]) -> None:
        self._affinity_code = codes.astype(np.int64)
        self.affinity_templates = list(templates)

    def view(self, keys: list[str] | None = None) -> "PodColumns":
        if keys is None:
            keys = sorted(self.row_of)
        rows = np.fromiter((self.row_of[k] for k in keys),
                           dtype=np.int64, count=len(keys))
        return PodColumns(self, keys, rows)


class NodeColumns:
    """Sorted read view over a ColumnarNodeBank: the `.columns` handle
    compile_workload consumes.  Gathers are vectorized; captured column
    references stay valid because bank updates are copy-on-write."""

    def __init__(self, bank: ColumnarNodeBank, keys: list[str],
                 rows: np.ndarray):
        self.bank = bank
        self.names = keys
        self.rows = rows
        self.rv = bank.rv[rows] if len(rows) else np.zeros(0, np.int64)
        self._label_cols = dict(bank.label_cols)
        self._taints = bank.taints

    @property
    def n(self) -> int:
        return len(self.names)

    def identity(self) -> tuple:
        """Cheap wave-to-wave table identity: same bank + same
        membership/order + same resourceVersions => same node table."""
        return ("columnar", self.bank.bank_id, self.bank.names_version,
                self.rv.tobytes())

    def opaque_positions(self) -> np.ndarray:
        """View positions whose columns are unreliable (sync faults):
        readers re-parse those rows' manifests."""
        if not len(self.rows):
            return np.zeros(0, dtype=np.int64)
        return np.flatnonzero(self.bank.opaque[self.rows])

    def row_manifest(self, pos: int) -> dict:
        return self.bank.row_manifest(int(self.rows[pos]))

    def extended_names(self) -> set[str]:
        """Exact extended-resource names present on THIS view's rows —
        matches ResourceSchema.discover over the materialized dicts."""
        out: set[str] = set()
        for rname, present in self.bank.res_present.items():
            if rname in _BASE_RES:
                continue
            if len(self.rows) and bool(present[self.rows].any()):
                out.add(rname)
        for pos in self.opaque_positions():
            alloc = ((self.row_manifest(int(pos)).get("status") or {})
                     .get("allocatable")) or {}
            for rname in alloc:
                if rname not in _BASE_RES and rname != "pods":
                    out.add(rname)
        return out

    def alloc_matrix(self, columns: tuple[str, ...]) -> np.ndarray:
        """[N, R] int64 allocatable in schema column order."""
        out = np.zeros((len(self.rows), len(columns)), dtype=np.int64)
        for j, rname in enumerate(columns):
            col = self.bank.res.get(rname)
            if col is not None:
                out[:, j] = col[self.rows]
        return out

    def allowed_pods(self) -> np.ndarray:
        return self.bank.allowed_pods[self.rows]

    def unschedulable(self) -> np.ndarray:
        return self.bank.unschedulable[self.rows].copy()

    def label_rows(self) -> "_LabelRows":
        return _LabelRows(self._label_cols, self.rows, self.names)

    def taint_rows(self) -> "_TaintRows":
        return _TaintRows(self._taints, self.rows)


class PodColumns:
    """Sorted read view over a ColumnarPodBank."""

    def __init__(self, bank: ColumnarPodBank, keys: list[str],
                 rows: np.ndarray):
        self.bank = bank
        self.keys = keys
        self.rows = rows

    @property
    def n(self) -> int:
        return len(self.keys)

    def request_row(self, uid: str, columns: tuple[str, ...]):
        return self.bank.request_row(uid, columns)


class _LabelRows:
    """Sequence of per-node label dicts synthesized on demand from the
    captured label columns — NodeTable.labels without N dict objects.
    `column(key)` is the LabelIndex fast path: the captured column
    gathered once, no per-row Python."""

    __slots__ = ("_cols", "_rows", "_names", "_gathered", "_overrides")

    def __init__(self, cols: dict[str, np.ndarray], rows: np.ndarray,
                 names: list[str], overrides: dict[int, dict] | None = None):
        self._cols = cols
        self._rows = rows
        self._names = names
        self._gathered: dict[str, np.ndarray] = {}
        self._overrides = overrides or {}

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        ov = self._overrides.get(int(i))
        if ov is not None:
            return ov
        row = int(self._rows[i])
        out: dict[str, str] = {}
        for key, col in self._cols.items():
            v = col[row]
            if v is not None:
                out[key] = v
        out.setdefault(_HOSTNAME, self._names[i])
        return out

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def column(self, key: str) -> np.ndarray:
        g = self._gathered.get(key)
        if g is not None:
            return g
        col = self._cols.get(key)
        if col is None:
            g = np.full(len(self._rows), None, dtype=object)
        else:
            g = col[self._rows]
        if key == _HOSTNAME:
            missing = np.equal(g, None)
            if missing.any():
                g = g.copy()
                g[missing] = np.asarray(self._names,
                                        dtype=object)[missing]
        for i, ov in self._overrides.items():
            if g is self._cols.get(key):
                g = g.copy()
            g[i] = ov.get(key)
            if key == _HOSTNAME and g[i] is None:
                g[i] = self._names[i]
        self._gathered[key] = g
        return g

    def with_overrides(self, overrides: dict[int, dict]) -> "_LabelRows":
        merged = dict(self._overrides)
        merged.update(overrides)
        return _LabelRows(self._cols, self._rows, self._names, merged)


class _TaintRows:
    """Sequence view of per-node taint lists (shared immutable rows)."""

    __slots__ = ("_pool", "_rows", "_overrides")

    def __init__(self, pool: list, rows: np.ndarray,
                 overrides: dict[int, list] | None = None):
        self._pool = pool
        self._rows = rows
        self._overrides = overrides or {}

    def __len__(self) -> int:
        return len(self._rows)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        ov = self._overrides.get(int(i))
        if ov is not None:
            return ov
        return self._pool[int(self._rows[i])]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def with_overrides(self, overrides: dict[int, list]) -> "_TaintRows":
        merged = dict(self._overrides)
        merged.update(overrides)
        return _TaintRows(self._pool, self._rows, merged)


class ColumnarManifestList(list):
    """A shared listing that carries its columnar view: list element i
    is the stored object for `columns` row position i (lazy until
    touched).  `compile_workload` detects `.columns` and never touches
    the elements; dict consumers index/iterate as usual."""

    __slots__ = ("columns",)

    def __init__(self, items, columns):
        super().__init__(items)
        self.columns = columns
