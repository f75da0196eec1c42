"""Replayer: re-apply a recorded event file against the cluster.

Capability parity with the reference replayer (reference:
simulator/replayer/replayer.go:37-103): reads the JSON-lines record file
sequentially and applies each event through the resource applier — Create
for "Add" (AlreadyExists tolerated), Update for "Update", Delete for
"Delete" (NotFound tolerated).  Exactly like the reference, NO timing is
reproduced: events apply as fast as possible, in order; Record.Time is
parsed but ignored.  Unscheduled pods created by the replay are then
picked up by the scheduling engine.

A copy of kube_scheduler_simulator_tpu/services/replayer.py.
"""

from __future__ import annotations

import json

from ..cluster.store import AlreadyExists, NotFound
from .recorder import EVENT_NAMES
from .resourceapplier import ResourceApplier

_KIND_TO_RESOURCE = {
    "Namespace": "namespaces",
    "PriorityClass": "priorityclasses",
    "StorageClass": "storageclasses",
    "PersistentVolumeClaim": "persistentvolumeclaims",
    "Node": "nodes",
    "PersistentVolume": "persistentvolumes",
    "Pod": "pods",
}


class ReplayerService:
    def __init__(self, applier: ResourceApplier, record_file_path: str):
        self.applier = applier
        self.path = record_file_path

    def replay(self) -> int:
        """Apply all records; returns the number applied."""
        n = 0
        with open(self.path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                self._apply(rec)
                n += 1
        return n

    def _apply(self, rec: dict) -> None:
        event = rec.get("event")
        obj = rec.get("resource") or {}
        resource = _KIND_TO_RESOURCE.get(obj.get("kind", ""))
        if resource is None:
            return
        if event == "Add":
            try:
                self.applier.create(resource, obj)
            except AlreadyExists:
                pass
        elif event == "Update":
            try:
                self.applier.update(resource, obj)
            except NotFound:
                pass
        elif event == "Delete":
            try:
                self.applier.delete(resource, obj)
            except NotFound:
                pass
