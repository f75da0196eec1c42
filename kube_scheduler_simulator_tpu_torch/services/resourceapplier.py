"""Generic resource applier with filter/mutate hook chains.

Capability parity with the reference's resourceapplier
(reference: simulator/resourceapplier/resourceapplier.go:91-194,268-286):
create/update/delete of unstructured objects with

  * immutable-field stripping on every apply (uid, generation,
    resourceVersion, creationTimestamp — :278-286);
  * pluggable per-resource filter/mutate hook chains, with the mandatory
    hooks always appended (reference: resourceapplier/resource.go:38-100):
      - mutatePV: bound PersistentVolumes get their claimRef UID
        re-resolved against the destination cluster's PVC (:38-63);
      - mutatePods: ServiceAccount + OwnerReferences dropped so pods don't
        depend on objects the simulator doesn't import (:65-81);
      - filterPodsForUpdating: updates to already-scheduled pods are
        skipped so the simulator's own scheduler keeps authority over
        placement (:85-100).

A copy of kube_scheduler_simulator_tpu/services/resourceapplier.py.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Callable

from ..cluster.store import NotFound, ObjectStore

FilterFn = Callable[[str, dict], bool]   # (resource, obj) -> keep?
MutateFn = Callable[[str, dict], dict]


@dataclass
class ApplierOptions:
    filter_before_creating: dict[str, list[FilterFn]] = field(default_factory=dict)
    mutate_before_creating: dict[str, list[MutateFn]] = field(default_factory=dict)
    filter_before_updating: dict[str, list[FilterFn]] = field(default_factory=dict)
    mutate_before_updating: dict[str, list[MutateFn]] = field(default_factory=dict)


def _strip_immutable(obj: dict) -> dict:
    obj = copy.deepcopy(obj)
    meta = obj.setdefault("metadata", {})
    for f in ("uid", "generation", "resourceVersion", "creationTimestamp"):
        meta.pop(f, None)
    return obj


class ResourceApplier:
    def __init__(self, store: ObjectStore, options: ApplierOptions | None = None):
        self.store = store
        o = options or ApplierOptions()
        self._filter_create = dict(o.filter_before_creating)
        self._mutate_create = dict(o.mutate_before_creating)
        self._filter_update = dict(o.filter_before_updating)
        self._mutate_update = dict(o.mutate_before_updating)
        # mandatory hooks (reference: resourceapplier/resource.go)
        self._mutate_create.setdefault("persistentvolumes", []).append(self._mutate_pv)
        self._mutate_update.setdefault("persistentvolumes", []).append(self._mutate_pv)
        self._mutate_create.setdefault("pods", []).append(self._mutate_pod)
        self._mutate_update.setdefault("pods", []).append(self._mutate_pod)
        self._filter_update.setdefault("pods", []).append(self._filter_scheduled_pod)

    # ----------------------------------------------------------- hooks

    def _mutate_pv(self, resource: str, obj: dict) -> dict:
        claim = (obj.get("spec") or {}).get("claimRef")
        if not claim:
            return obj
        try:
            pvc = self.store.get(
                "persistentvolumeclaims", claim.get("name", ""), claim.get("namespace")
            )
            claim["uid"] = pvc["metadata"]["uid"]
        except NotFound:
            claim.pop("uid", None)
        return obj

    def _mutate_pod(self, resource: str, obj: dict) -> dict:
        spec = obj.setdefault("spec", {})
        spec.pop("serviceAccountName", None)
        spec.pop("serviceAccount", None)
        obj.get("metadata", {}).pop("ownerReferences", None)
        return obj

    def _filter_scheduled_pod(self, resource: str, obj: dict) -> bool:
        # skip updates carrying a scheduled pod: placement in the
        # simulator belongs to the simulator's own scheduler.  The
        # reference filters on the INCOMING object's nodeName
        # (resource.go:82-99 filterPodsForUpdating), not the destination's
        # — a source-side bind must never leak into the simulator
        return not ((obj.get("spec") or {}).get("nodeName"))

    # ----------------------------------------------------------- apply

    def create(self, resource: str, obj: dict) -> dict | None:
        for f in self._filter_create.get(resource, []):
            if not f(resource, obj):
                return None
        obj = _strip_immutable(obj)
        for m in self._mutate_create.get(resource, []):
            obj = m(resource, obj)
        # _strip_immutable already made a private copy: transfer ownership
        return self.store.create(resource, obj, owned=True)

    def update(self, resource: str, obj: dict) -> dict | None:
        for f in self._filter_update.get(resource, []):
            if not f(resource, obj):
                return None
        obj = _strip_immutable(obj)
        for m in self._mutate_update.get(resource, []):
            obj = m(resource, obj)
        # _strip_immutable already made a private copy: transfer ownership
        return self.store.update(resource, obj, owned=True)

    def delete(self, resource: str, obj: dict) -> None:
        meta = obj.get("metadata") or {}
        self.store.delete(resource, meta.get("name", ""), meta.get("namespace"))
