"""The port's columnar data plane (cluster/columnar.py, the write mirror
of cluster/store.py) against the dict baseline and against the JAX
package's store.

The first eight tests mirror tests/test_columnar_store.py on the port's
ObjectStore: every suite runs one operation sequence against a columnar
store (KSS_TPU_COLUMNAR=1, the default) and a dict-baseline store
(KSS_TPU_COLUMNAR=0) with uuid and time pinned, and compares the raw
`json.dumps` bytes (insertion order included) of every read surface:
get, list, watch events, dump, snapshot export.  The fault seam
`store.columnar_sync` leaves the shim consistent: the row goes opaque,
the manifest stays authoritative, and the columnar node-table build
(compile_workload on device="cpu") re-parses it.

The rest hold the port's columnar store to the JAX package's columnar
store, byte for byte, for the same operation sequence: the bulk load,
CRUD on lazy rows, watch streams, dump, the faulted sync, and the banks'
columns themselves.

Uid pinning: lazy rows draw their uid on first read, the eager path at
create, so each store runs its ops as a phase with the pinned uuid
counter reset at the phase start, and materializes its lazy rows in row
order (materialize_reads) so both phases assign uid k to the same
logical object.
"""

from __future__ import annotations

import itertools
import json
import time
import uuid

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.cluster import store as jstore
from kube_scheduler_simulator_tpu.models import workloads as jworkloads
from kube_scheduler_simulator_tpu.utils import faults as jfaults
from kube_scheduler_simulator_tpu_torch.cluster.columnar import LazyManifest
from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore, list_shared
from kube_scheduler_simulator_tpu_torch.models.workloads import (
    make_nodes_columnar, make_pods_columnar)
from kube_scheduler_simulator_tpu_torch.models import workloads as pworkloads
from kube_scheduler_simulator_tpu_torch.utils import faults
from kube_scheduler_simulator_tpu_torch.utils.faults import FaultPlan, FaultRule


class _UuidPin:
    def __init__(self):
        self.reset()

    def reset(self):
        self._c = itertools.count()

    def __call__(self):
        return f"00000000-0000-4000-8000-{next(self._c):012d}"


@pytest.fixture
def pin(monkeypatch):
    """Pin uuid.uuid4 (resettable counter) and the store's
    creationTimestamp clock so both stores stamp identical bytes for
    identical per-phase operation sequences."""
    p = _UuidPin()
    monkeypatch.setattr(uuid, "uuid4", p)
    monkeypatch.setattr(time, "gmtime", lambda *a: time.struct_time(
        (2026, 1, 1, 0, 0, 0, 3, 1, 0)))
    return p


def make_store(monkeypatch, columnar: bool, cls=ObjectStore):
    monkeypatch.setenv("KSS_TPU_COLUMNAR", "1" if columnar else "0")
    store = cls()
    monkeypatch.delenv("KSS_TPU_COLUMNAR")
    return store


def raw(obj) -> str:
    """Raw (insertion-ordered) JSON bytes of a possibly-lazy manifest,
    materialized the way real serializers must (json's C encoder walks
    dict storage, bypassing LazyManifest's overrides); a lazy row of
    either package fills through its own class."""
    ensure = getattr(type(obj), "ensure", None)
    if ensure is not None:
        ensure(obj)
    return json.dumps(obj)


def load_population(s, n_nodes=40, n_pods=25, wl=pworkloads):
    s.load_columnar("nodes", wl.make_nodes_columnar(
        n_nodes, seed=3, taint_fraction=0.2, unschedulable_fraction=0.1))
    s.load_columnar("pods", wl.make_pods_columnar(
        n_pods, seed=4, with_affinity=True))


def load_both(pin, monkeypatch, materialize=True, **kw):
    """(columnar store, dict store) holding the same generated
    population, uid-aligned: each load runs as its own pinned phase, and
    the columnar store materializes its lazy rows in row order — the
    same order the dict store's eager fallback created them."""
    a = make_store(monkeypatch, True)
    pin.reset()
    load_population(a, **kw)
    if materialize:
        a.materialize_reads()
    b = make_store(monkeypatch, False)
    pin.reset()
    load_population(b, **kw)
    return a, b


NODE = {
    "metadata": {"name": "crud-node", "labels": {"zone": "z1"}},
    "spec": {"taints": [{"key": "k", "value": "v", "effect": "NoSchedule"}]},
    "status": {"allocatable": {"cpu": "8000m", "memory": "1073741824",
                               "example.com/gpu": "4", "pods": "110"}},
}
POD = {
    "metadata": {"name": "crud-pod", "labels": {"app": "a0"}},
    "spec": {"containers": [{"name": "c", "resources": {
        "requests": {"cpu": "250m", "memory": "2097152"}}}]},
}


def crud_sequence(s) -> None:
    """The golden op sequence: create, update, delete, re-create."""
    s.create("nodes", json.loads(json.dumps(NODE)))
    s.create("pods", json.loads(json.dumps(POD)))
    nd = s.get("nodes", "crud-node")
    nd["status"]["allocatable"]["cpu"] = "16000m"
    nd["metadata"]["labels"]["zone"] = "z2"
    s.update("nodes", nd)
    s.delete("pods", "crud-pod")
    s.create("pods", json.loads(json.dumps(POD)))


# ------------------------------------------------ tests/test_columnar_store.py

def test_crud_surface_byte_parity(pin, monkeypatch):
    a = make_store(monkeypatch, True)
    b = make_store(monkeypatch, False)
    qa, qb = a.watch("nodes"), b.watch("nodes")
    for s in (a, b):
        pin.reset()
        crud_sequence(s)
    assert raw(a.get("nodes", "crud-node")) == raw(b.get("nodes", "crud-node"))
    assert raw(a.get("pods", "crud-pod")) == raw(b.get("pods", "crud-pod"))
    la, rva = a.list("nodes")
    lb, rvb = b.list("nodes")
    assert rva == rvb and [raw(o) for o in la] == [raw(o) for o in lb]
    assert raw(a.dump()) == raw(b.dump())
    ev_a = [qa.get_nowait() for _ in range(qa.qsize())]
    ev_b = [qb.get_nowait() for _ in range(qb.qsize())]
    assert ([(rv, t, raw(o)) for rv, t, o in ev_a]
            == [(rv, t, raw(o)) for rv, t, o in ev_b])


def test_lazy_rows_byte_identical_to_eager_path(pin, monkeypatch):
    """load_columnar's lazy rows synthesize the same bytes, raw insertion
    order included, as the eager fallback stores."""
    a, b = load_both(pin, monkeypatch)
    for resource in ("nodes", "pods"):
        la, rva = a.list(resource)
        lb, rvb = b.list(resource)
        assert rva == rvb
        assert [raw(o) for o in la] == [raw(o) for o in lb]
    assert raw(a.get("nodes", "node-00007")) == raw(b.get("nodes", "node-00007"))
    assert raw(a.get("pods", "pod-00003")) == raw(b.get("pods", "pod-00003"))
    assert raw(a.dump()) == raw(b.dump())


def test_watch_events_from_bulk_load_match_eager(pin, monkeypatch):
    a = make_store(monkeypatch, True)
    b = make_store(monkeypatch, False)
    qa, qb = a.watch("nodes"), b.watch("nodes")
    pin.reset()
    a.load_columnar("nodes", make_nodes_columnar(12, seed=3))
    a.materialize_reads()
    pin.reset()
    b.load_columnar("nodes", make_nodes_columnar(12, seed=3))
    ev_a = [qa.get_nowait() for _ in range(qa.qsize())]
    ev_b = [qb.get_nowait() for _ in range(qb.qsize())]
    assert len(ev_a) == 12
    assert ([(rv, t, raw(o)) for rv, t, o in ev_a]
            == [(rv, t, raw(o)) for rv, t, o in ev_b])


def lazy_row_edits(s) -> None:
    nd = s.get("nodes", "node-00003")
    nd["status"]["allocatable"]["cpu"] = "123000m"
    s.update("nodes", nd)
    s.delete("nodes", "node-00005")
    s.create("nodes", {"metadata": {"name": "node-00005"},
                       "status": {"allocatable": {"cpu": "1000m", "pods": "10"}}})
    with pytest.raises(Exception):
        s.get("nodes", "node-00099")


def test_update_and_delete_of_lazy_rows(pin, monkeypatch):
    """Mutating a lazy row (update / delete / re-create) keeps the shim
    on the dict baseline: rv sequencing, tombstoned reads, final bytes."""
    a, b = load_both(pin, monkeypatch)
    for s in (a, b):
        pin.reset()
        lazy_row_edits(s)
    la, rva = a.list("nodes")
    lb, rvb = b.list("nodes")
    assert rva == rvb
    assert [raw(o) for o in la] == [raw(o) for o in lb]
    assert (a.get("nodes", "node-00005")["metadata"]["resourceVersion"]
            == b.get("nodes", "node-00005")["metadata"]["resourceVersion"])


def test_materialize_reads_fills_lazy_rows(pin, monkeypatch):
    """Shared (no-copy) listings hand out lazy rows whose dict storage is
    empty until filled; materialize_reads() leaves the shared objects
    carrying full bytes."""
    a, b = load_both(pin, monkeypatch, materialize=False)
    sa = list_shared(a, "nodes")
    lazy = [o for o in sa if type(o) is LazyManifest and not dict.__len__(o)]
    assert lazy, "expected unfilled lazy rows before the flush"
    assert json.dumps(lazy[0]) == "{}"  # the bypass materialize guards
    pin.reset()
    a.materialize_reads()
    assert all(dict.__len__(o) for o in list_shared(a, "nodes"))
    assert ([json.dumps(o) for o in list_shared(a, "nodes")]
            == [raw(o) for o in list_shared(b, "nodes")])


def test_snapshot_export_byte_parity(pin, monkeypatch):
    from kube_scheduler_simulator_tpu_torch.services.snapshot import SnapshotService

    class _Sched:
        def get_config(self):
            return {"profiles": []}

    a, b = load_both(pin, monkeypatch, n_nodes=15, n_pods=10)
    snap_a = SnapshotService(a, _Sched()).snap()
    snap_b = SnapshotService(b, _Sched()).snap()
    assert json.dumps(snap_a) == json.dumps(snap_b)


def test_columnar_off_pins_dict_baseline(monkeypatch):
    s = make_store(monkeypatch, False)
    assert not s._banks
    n = s.load_columnar("nodes", make_nodes_columnar(8, seed=1))
    assert n == 8
    assert all(type(o) is dict for o in list_shared(s, "nodes"))


def faulted_edit(s, pin) -> None:
    pin.reset()
    nd = s.get("nodes", "node-00004")
    nd["status"]["allocatable"]["cpu"] = "99000m"
    s.update("nodes", nd)


def test_columnar_sync_fault_leaves_shim_consistent(pin, monkeypatch):
    """A fault at the store.columnar_sync seam mid-update never surfaces
    to the writer: the row goes opaque, the manifest stays
    authoritative, and every read surface, the columnar node-table build
    included, matches the dict baseline."""
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.state.compile import compile_workload

    from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

    a, b = load_both(pin, monkeypatch, n_nodes=20, n_pods=5)
    plan = FaultPlan([FaultRule("store.columnar_sync", nth=1)], seed=0)
    opaque0 = TRACER.counter_totals().get("store_columnar_opaque_rows_total", 0)
    with faults.armed(plan):
        faulted_edit(a, pin)
    faulted_edit(b, pin)
    assert plan.stats()["rules"][0]["trips"] == 1
    assert TRACER.counter_totals().get("store_columnar_opaque_rows_total", 0) == opaque0 + 1
    bank = a._banks["nodes"]
    assert bank.opaque[bank.row_of["node-00004"]]
    assert raw(a.get("nodes", "node-00004")) == raw(b.get("nodes", "node-00004"))
    assert raw(a.dump()) == raw(b.dump())
    cfg = PluginSetConfig(enabled=["NodeResourcesFit"])
    na, _ = a.list("nodes", copy_objects=False)
    nb, _ = b.list("nodes", copy_objects=False)
    pa, _ = a.list("pods", copy_objects=False)
    cw_a = compile_workload(na, list(pa), cfg, pod_columns=getattr(pa, "columns", None),
                            device="cpu")
    cw_b = compile_workload([dict(o) for o in nb], list(pa), cfg, device="cpu")
    assert list(cw_a.node_table.names) == list(cw_b.node_table.names)
    assert np.array_equal(cw_a.node_table.allocatable, cw_b.node_table.allocatable)
    row = list(cw_a.node_table.names).index("node-00004")
    cpu_col = list(cw_a.schema.columns).index("cpu")
    assert cw_a.node_table.allocatable[row, cpu_col] == 99000


# ------------------------------------------------ the port's store vs the JAX store

def test_seam_is_in_the_ports_seams():
    """The port fires store.columnar_sync where the JAX package does."""
    assert "store.columnar_sync" in faults.SEAMS
    assert faults.SEAMS == jfaults.SEAMS


def load_pair(pin, monkeypatch, materialize=True, **kw):
    """(port columnar store, JAX columnar store) with the same population
    from each package's own generators, uid-aligned by phase."""
    a = make_store(monkeypatch, True)
    pin.reset()
    load_population(a, **kw)
    if materialize:
        a.materialize_reads()
    b = make_store(monkeypatch, True, jstore.ObjectStore)
    pin.reset()
    load_population(b, wl=jworkloads, **kw)
    if materialize:
        b.materialize_reads()
    return a, b


def surfaces(s) -> dict:
    out = {}
    for resource in ("nodes", "pods"):
        items, rv = s.list(resource)
        out[resource] = (rv, [raw(o) for o in items])
    out["dump"] = raw(s.dump())
    return out


@pytest.mark.parametrize("columnar", [True, False], ids=["columnar", "dict"])
def test_crud_surfaces_equal_jax_store(pin, monkeypatch, columnar):
    a = make_store(monkeypatch, columnar)
    b = make_store(monkeypatch, columnar, jstore.ObjectStore)
    qa, qb = a.watch("nodes"), b.watch("nodes")
    for s in (a, b):
        pin.reset()
        crud_sequence(s)
    assert surfaces(a) == surfaces(b)
    ev_a = [qa.get_nowait() for _ in range(qa.qsize())]
    ev_b = [qb.get_nowait() for _ in range(qb.qsize())]
    assert ([(rv, t, raw(o)) for rv, t, o in ev_a]
            == [(rv, t, raw(o)) for rv, t, o in ev_b])


@pytest.mark.parametrize("materialize", [True, False], ids=["materialized", "lazy"])
def test_bulk_load_and_lazy_edits_equal_jax_store(pin, monkeypatch, materialize):
    """The generators draw the same banks, and the port's lazy rows read,
    update, delete and re-create as the JAX store's do."""
    a, b = load_pair(pin, monkeypatch, materialize=materialize)
    if not materialize:
        for s in (a, b):
            pin.reset()
            s.materialize_reads()
    assert surfaces(a) == surfaces(b)
    for s in (a, b):
        pin.reset()
        lazy_row_edits(s)
    assert surfaces(a) == surfaces(b)


def test_banks_equal_jax_banks(pin, monkeypatch):
    """The banks' columns, row for row, after a bulk load and edits; and
    the listing's columnar views give the same node identity and columns."""
    a, b = load_pair(pin, monkeypatch)
    for s in (a, b):
        pin.reset()
        lazy_row_edits(s)
        crud_sequence(s)
    for resource in ("nodes", "pods"):
        ba, bb = a._banks[resource], b._banks[resource]
        assert ba.n == bb.n
        assert dict(ba.row_of) == dict(bb.row_of)
        for name in ("rv", "opaque", "deleted"):
            assert np.array_equal(getattr(ba, name)[:ba.n], getattr(bb, name)[:bb.n]), name
    ca = list_shared(a, "nodes").columns
    cb = list_shared(b, "nodes").columns
    assert ca.n == cb.n and list(ca.names) == list(cb.names)
    assert ca.identity()[2:] == cb.identity()[2:]
    cols = ("cpu", "memory", "ephemeral-storage", "example.com/gpu")
    assert np.array_equal(ca.alloc_matrix(cols), cb.alloc_matrix(cols))
    assert np.array_equal(ca.allowed_pods(), cb.allowed_pods())
    assert np.array_equal(ca.unschedulable(), cb.unschedulable())
    assert list(ca.label_rows()) == list(cb.label_rows())
    assert list(ca.taint_rows()) == list(cb.taint_rows())


def test_faulted_sync_equals_jax_store(pin, monkeypatch):
    """The same fault plan on both stores: the same row goes opaque, and
    every read surface stays equal."""
    a, b = load_pair(pin, monkeypatch, n_nodes=20, n_pods=5)
    plan = FaultPlan([FaultRule("store.columnar_sync", nth=1)], seed=0)
    jplan = jfaults.FaultPlan([jfaults.FaultRule("store.columnar_sync", nth=1)], seed=0)
    with faults.armed(plan):
        faulted_edit(a, pin)
    with jfaults.armed(jplan):
        faulted_edit(b, pin)
    assert plan.stats()["rules"][0]["trips"] == jplan.stats()["rules"][0]["trips"] == 1
    ba, bb = a._banks["nodes"], b._banks["nodes"]
    assert np.array_equal(ba.opaque[:ba.n], bb.opaque[:bb.n])
    assert surfaces(a) == surfaces(b)
