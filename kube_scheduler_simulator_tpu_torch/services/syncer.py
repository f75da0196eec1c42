"""Syncer: continuous import from a source cluster.

Capability parity with the reference syncer (reference:
simulator/syncer/syncer.go): dynamic-informer-equivalent watches on the
source cluster for the same resource list (:23-31); Add/Update/Delete
events are forwarded to the resource applier (:53-74), tolerating
NotFound on delete; updates to pods the simulator has already scheduled
are dropped by the applier's mandatory filter hook so the simulator's own
scheduler keeps placement authority (reference:
docs/import-cluster-resources.md:39-55).

A copy of kube_scheduler_simulator_tpu/services/syncer.py.
"""

from __future__ import annotations

import threading

from ..cluster.store import ADDED, DELETED, MODIFIED, AlreadyExists, NotFound, ObjectStore
from .importer import IMPORT_ORDER
from .resourceapplier import ResourceApplier


class SyncerService:
    def __init__(self, source: ObjectStore, applier: ResourceApplier,
                 resources: list[str] | None = None):
        self.source = source
        self.applier = applier
        self.resources = resources or list(IMPORT_ORDER)
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._queues = {}

    def run(self) -> None:
        """Initial list+create, then stream source events until stop()."""
        for resource in self.resources:
            # subscribe BEFORE the initial list so no event is lost
            try:
                q = self.source.watch(resource)
            except NotFound:
                # GVR not served by the source (a simulator-only CRD):
                # skip it rather than aborting the whole sync
                continue
            self._queues[resource] = q
            items, _ = self.source.list(resource)
            for obj in items:
                try:
                    self.applier.create(resource, obj)
                except AlreadyExists:
                    pass
            t = threading.Thread(target=self._consume, args=(resource, q), daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for resource, q in self._queues.items():
            self.source.unwatch(resource, q)
            q.put(None)
        for t in self._threads:
            t.join(timeout=1)

    def _consume(self, resource: str, q) -> None:
        while not self._stop.is_set():
            ev = q.get()
            if ev is None:
                return
            _, event_type, obj = ev
            try:
                if event_type == ADDED:
                    try:
                        self.applier.create(resource, obj)
                    except AlreadyExists:
                        # initial list already created it
                        pass
                elif event_type == MODIFIED:
                    try:
                        self.applier.update(resource, obj)
                    except NotFound:
                        self.applier.create(resource, obj)
                elif event_type == DELETED:
                    try:
                        self.applier.delete(resource, obj)
                    except NotFound:
                        pass
            except Exception:
                # tolerate individual event failures, like the reference's
                # logged-and-continue informer handlers
                pass
