"""Recorder: append cluster events to a JSON-lines file.

Capability parity with the reference recorder (reference:
simulator/recorder/recorder.go): watches the 7 resource kinds (:45-53
DefaultGVRs), appends Record{time, event(Add/Update/Delete), resource} to
an in-memory slice (:109-139), and a background goroutine-equivalent
thread flushes JSON lines to the file every FlushInterval (default 5s,
:28, :141-177).  Delete events keep only apiVersion/kind/name/namespace,
as the reference does.  The record file format is line-compatible:
{"time": ..., "event": "Add", "resource": {...}}.

A copy of kube_scheduler_simulator_tpu/services/recorder.py.
"""

from __future__ import annotations

import datetime
import json
import threading

from ..cluster.store import ADDED, DELETED, MODIFIED, ObjectStore, RESOURCES, DEFAULT_GVRS

EVENT_NAMES = {ADDED: "Add", MODIFIED: "Update", DELETED: "Delete"}
DEFAULT_FLUSH_INTERVAL = 5.0


class RecorderService:
    def __init__(self, store: ObjectStore, path: str,
                 flush_interval: float = DEFAULT_FLUSH_INTERVAL,
                 resources: list[str] | None = None):
        self.store = store
        self.path = path
        self.flush_interval = flush_interval
        self.resources = resources or list(DEFAULT_GVRS)
        self._records: list[dict] = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._queues = {}

    def run(self) -> None:
        open(self.path, "w").close()  # truncate, as a fresh recording
        for resource in self.resources:
            q = self.store.watch(resource)
            self._queues[resource] = q
            t = threading.Thread(
                target=self._consume, args=(resource, q), daemon=True
            )
            t.start()
            self._threads.append(t)
        flusher = threading.Thread(target=self._flush_loop, daemon=True)
        flusher.start()
        self._threads.append(flusher)

    def stop(self) -> None:
        self._stop.set()
        for resource, q in self._queues.items():
            self.store.unwatch(resource, q)
            q.put(None)  # unblock consumer
        self._flush()

    # ----------------------------------------------------------- internals

    def _consume(self, resource: str, q) -> None:
        while not self._stop.is_set():
            ev = q.get()
            if ev is None:
                return
            _, event_type, obj = ev
            self._record(event_type, obj)

    def _record(self, event_type: str, obj: dict) -> None:
        # watch events may carry lazy columnar rows; json's C encoder
        # bypasses dict-subclass overrides, so materialize before the
        # object is queued for serialization
        fill = getattr(obj, "fill", None)
        if fill is not None:
            fill()
        if event_type == DELETED:
            # keep only identity fields (reference: recorder.go:121-133)
            obj = {
                "apiVersion": obj.get("apiVersion"),
                "kind": obj.get("kind"),
                "metadata": {
                    "name": (obj.get("metadata") or {}).get("name"),
                    "namespace": (obj.get("metadata") or {}).get("namespace"),
                },
            }
        rec = {
            "time": datetime.datetime.now(datetime.timezone.utc).isoformat(),
            "event": EVENT_NAMES[event_type],
            "resource": obj,
        }
        with self._lock:
            self._records.append(rec)

    def _flush_loop(self) -> None:
        while not self._stop.wait(self.flush_interval):
            self._flush()

    def _flush(self) -> None:
        with self._lock:
            batch, self._records = self._records, []
        if not batch:
            return
        with open(self.path, "a") as f:
            for rec in batch:
                f.write(json.dumps(rec) + "\n")
