"""One-shot importer: copy resources from a source cluster.

Capability parity with the reference one-shot importer (reference:
simulator/oneshotimporter/importer.go): lists the 7 GVRs from the source
in dependency order — namespaces, priorityclasses, storageclasses, pvcs,
nodes, pvs, pods (:29-37) — with an optional label selector, and creates
each object in the simulator via the resource applier (:58-95), which
strips immutable fields and runs the mandatory mutation hooks.

The source is anything with .list(resource, label_selector=...) —
another ObjectStore (a second simulated cluster, the fake-source-cluster
of compose.local.yml:19-33) or a JSON/file-backed source.

A copy of kube_scheduler_simulator_tpu/services/importer.py.
"""

from __future__ import annotations

from ..cluster.store import AlreadyExists, NotFound
from .resourceapplier import ResourceApplier

IMPORT_ORDER = [
    "namespaces",
    "priorityclasses",
    "storageclasses",
    "persistentvolumeclaims",
    "nodes",
    "persistentvolumes",
    "pods",
]


class OneShotImporter:
    def __init__(self, source, applier: ResourceApplier,
                 resources: list[str] | None = None):
        self.source = source
        self.applier = applier
        self.resources = resources or list(IMPORT_ORDER)

    def import_cluster_resources(self, label_selector: dict | None = None) -> int:
        n = 0
        for resource in self.resources:
            try:
                items, _ = self.source.list(resource, label_selector=label_selector)
            except NotFound:
                # the source cluster doesn't serve this GVR (e.g. a CRD
                # registered in the simulator but not installed at the
                # source) — the reference's dynamic lister would likewise
                # come back empty; skip, don't abort the import
                continue
            for obj in items:
                try:
                    if self.applier.create(resource, obj) is not None:
                        n += 1
                except AlreadyExists:
                    pass
        return n


class FileSource:
    """A snapshot-JSON-backed import source (for importing from a file the
    way the reference imports from a real cluster's kubeconfig)."""

    _FIELD = {
        "namespaces": "namespaces", "priorityclasses": "priorityClasses",
        "storageclasses": "storageClasses",
        "persistentvolumeclaims": "pvcs", "nodes": "nodes",
        "persistentvolumes": "pvs", "pods": "pods",
    }

    def __init__(self, snapshot: dict):
        self.snapshot = snapshot

    def list(self, resource: str, namespace=None, label_selector=None):
        from ..state.selectors import label_selector_matches

        items = self.snapshot.get(self._FIELD.get(resource, resource)) or []
        if label_selector is not None:
            items = [
                o for o in items
                if label_selector_matches(
                    label_selector,
                    {k: str(v) for k, v in ((o.get("metadata") or {}).get("labels") or {}).items()},
                )
            ]
        return items, 0
