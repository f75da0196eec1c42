"""In-memory cluster object store — the KWOK/etcd analogue.

A copy of kube_scheduler_simulator_tpu/cluster/store.py, host code with its
imports rewired to the port, without its columnar data plane (the numpy
banks mirrored on every write, `load_columnar`, KSS_TPU_COLUMNAR): nothing
in the port reads that view until compile_workload takes `pod_columns=`.

The reference runs against a KWOK fake cluster (etcd + kube-apiserver with
no kubelets, reference: compose.yml:53-66, kwok.yaml:1-12) and talks to it
via client-go.  This store replaces that whole external dependency with an
in-process structure offering the same contract the simulator's services
rely on:

  * objects are unstructured dicts keyed by (resource, namespace/name);
  * a single monotonically increasing resourceVersion (etcd revision
    analogue) stamped on every write;
  * optimistic concurrency: update with a stale metadata.resourceVersion
    fails with Conflict — required for the reflector's conflict-retry path
    (reference: storereflector.go:136-151);
  * list + watch: watch(resource, since_rv) replays buffered events after
    since_rv then streams live ones (RetryWatcher analogue, reference:
    resourcewatcher/resourcewatcher.go:106-134);
  * dump()/restore() of the full keyspace — the etcd snapshot/restore the
    reset service uses (reference: reset/reset.go:32-85).

Thread-safe; watch queues are unbounded stdlib queues.
"""

from __future__ import annotations

import copy
import itertools
import queue
import threading
import time
import uuid


# resource name -> (kind, namespaced).  The first 7 are the kinds the
# reference simulator watches/records/syncs (reference:
# recorder/recorder.go:45-53 DefaultGVRs — see DEFAULT_GVRS below);
# PodDisruptionBudgets are additionally storable so PDB-aware preemption
# can honor them (the real scheduler reads PDBs from the apiserver even
# though the simulator never syncs them).
RESOURCES: dict[str, tuple[str, bool]] = {
    "namespaces": ("Namespace", False),
    "priorityclasses": ("PriorityClass", False),
    "storageclasses": ("StorageClass", False),
    "persistentvolumeclaims": ("PersistentVolumeClaim", True),
    "nodes": ("Node", False),
    "persistentvolumes": ("PersistentVolume", False),
    "pods": ("Pod", True),
    "poddisruptionbudgets": ("PodDisruptionBudget", True),
}

# the reference's 7 DefaultGVRs — the watch/record/sync surface
DEFAULT_GVRS = [
    "namespaces", "priorityclasses", "storageclasses",
    "persistentvolumeclaims", "nodes", "persistentvolumes", "pods",
]

API_VERSIONS = {
    "priorityclasses": "scheduling.k8s.io/v1",
    "storageclasses": "storage.k8s.io/v1",
    "poddisruptionbudgets": "policy/v1",
}

ADDED, MODIFIED, DELETED = "ADDED", "MODIFIED", "DELETED"

_EVENT_BUFFER = 4096  # per-resource ring buffer for watch replay

class ApiError(Exception):
    status = 500
    reason = "InternalError"

    def __init__(self, msg: str):
        super().__init__(msg)
        self.message = msg


class NotFound(ApiError):
    status = 404
    reason = "NotFound"


class AlreadyExists(ApiError):
    status = 409
    reason = "AlreadyExists"


class Conflict(ApiError):
    status = 409
    reason = "Conflict"


def obj_key(obj: dict, namespaced: bool) -> str:
    meta = obj.get("metadata") or {}
    name = meta.get("name", "")
    if namespaced:
        return f"{meta.get('namespace') or 'default'}/{name}"
    return name


class ObjectStore:
    def __init__(self, extra_resources: list[dict] | None = None):
        """extra_resources: declarative GVR registrations beyond the
        built-in table — the RESTMapper analogue (the reference's
        resourceapplier works on any GVK via dynamic client + RESTMapper,
        resourceapplier.go:91-194,268-276).  Each entry:
        {"resource": plural, "kind": Kind, "namespaced": bool,
        "apiVersion": group/version} — from config extraResources or
        register_resource()."""
        self._lock = threading.RLock()
        self.resources: dict[str, tuple[str, bool]] = dict(RESOURCES)
        self.api_versions: dict[str, str] = dict(API_VERSIONS)
        self._objects: dict[str, dict[str, dict]] = {r: {} for r in RESOURCES}
        self._rv = itertools.count(1)
        self._last_rv = 0
        self._events: dict[str, list[tuple[int, str, dict]]] = {r: [] for r in RESOURCES}
        self._watchers: dict[str, list[queue.Queue]] = {r: [] for r in RESOURCES}
        # read hooks (store/lazy.py LazyReflections): deferred-annotation
        # materializers drained before copying reads return, so API
        # consumers observe exactly the eager write-back's bytes while
        # the engine's shared-manifest fast paths (copy_object(s)=False)
        # stay off the decode
        self._read_hooks: list = []
        # per-resource write counters keying the sorted-listing cache
        self._res_version: dict[str, int] = {}
        self._list_cache: dict[str, tuple] = {}
        for spec in extra_resources or []:
            self.register_resource(
                spec["resource"], spec.get("kind") or spec["resource"].capitalize(),
                namespaced=bool(spec.get("namespaced", True)),
                api_version=spec.get("apiVersion") or "v1",
            )

    def register_resource(self, resource: str, kind: str,
                          namespaced: bool = True,
                          api_version: str = "v1") -> None:
        """Register an additional resource kind so CRUD/watch/dump/restore
        (and every service built on them: applier, importer, syncer,
        recorder, watcher, snapshot) carry it.  Idempotent."""
        with self._lock:
            if resource not in self.resources:
                self._objects[resource] = {}
                self._events[resource] = []
                self._watchers[resource] = []
            self.resources[resource] = (kind, namespaced)
            if api_version and api_version != "v1":
                self.api_versions[resource] = api_version

    # ----------------------------------------------------------- read hooks

    def add_read_hook(self, hook) -> None:
        """Register a deferred-annotation materializer.  `hook.flush(
        resource, name, namespace)` runs BEFORE copying reads (get with
        copy_object=True, list with copy_objects=True, dump) return —
        with no store lock held, so a hook may write back through the
        normal update path; name=None flushes the whole resource,
        resource=None flushes everything.  `hook.discard(resource,
        name, namespace)` drops pending state for deleted/reset
        objects.  Idempotent per hook object."""
        with self._lock:
            if hook not in self._read_hooks:
                self._read_hooks.append(hook)

    def remove_read_hook(self, hook) -> None:
        with self._lock:
            try:
                self._read_hooks.remove(hook)
            except ValueError:
                pass

    def materialize_reads(self, resource: str | None = None,
                          name: str | None = None,
                          namespace: str | None = None) -> None:
        """Drain registered read hooks (no-op without hooks or pending
        state) — the transparent-read barrier copying reads run, also
        callable directly by consumers of the shared-manifest fast
        paths (snapshot export, the HTTP watch stream) that need the
        eager bytes without paying per-object deep copies."""
        for hook in tuple(self._read_hooks):
            hook.flush(resource, name, namespace)

    def _discard_hooks(self, resource: str | None, name: str | None = None,
                       namespace: str | None = None) -> None:
        for hook in tuple(self._read_hooks):
            hook.discard(resource, name, namespace)

    # ----------------------------------------------------------- listing cache

    def _bump(self, resource: str) -> None:
        """Invalidate the sorted-listing cache for resource (lock held)."""
        self._res_version[resource] = self._res_version.get(resource, 0) + 1

    # ----------------------------------------------------------- helpers

    def _next_rv(self) -> int:
        self._last_rv = next(self._rv)
        return self._last_rv

    def _notify(self, resource: str, event_type: str, obj: dict, rv: int):
        ev = (rv, event_type, obj)
        buf = self._events[resource]
        buf.append(ev)
        if len(buf) > _EVENT_BUFFER:
            del buf[: len(buf) - _EVENT_BUFFER]
        for q in self._watchers[resource]:
            q.put(ev)

    def _stamp_kind(self, resource: str, obj: dict):
        kind, _ = self.resources[resource]
        obj.setdefault("kind", kind)
        obj.setdefault("apiVersion", self.api_versions.get(resource, "v1"))

    # the apiserver's built-in PriorityClasses (scheduling.k8s.io)
    _BUILTIN_PRIORITY_CLASSES = {
        "system-cluster-critical": 2000000000,
        "system-node-critical": 2000001000,
    }

    def _admit_pod_priority(self, obj: dict) -> None:
        """Priority admission analogue: resolve .spec.priority from
        priorityClassName (or the globalDefault class) at create time,
        the way the reference's kube-apiserver does for pods the
        simulator imports or users post.  Caller holds the lock."""
        spec = obj.setdefault("spec", {})
        if spec.get("priority") is not None:
            return
        name = spec.get("priorityClassName") or ""
        if name:
            if name in self._BUILTIN_PRIORITY_CLASSES:
                spec["priority"] = self._BUILTIN_PRIORITY_CLASSES[name]
                return
            pc = self._objects["priorityclasses"].get(name)
            if pc is None:
                e = ApiError(f'no PriorityClass with name "{name}" was found')
                e.status = 400
                e.reason = "Invalid"
                raise e
            spec["priority"] = int(pc.get("value") or 0)
            return
        for pc in self._objects["priorityclasses"].values():
            if pc.get("globalDefault"):
                spec["priorityClassName"] = pc["metadata"]["name"]
                spec["priority"] = int(pc.get("value") or 0)
                return

    # ----------------------------------------------------------- CRUD

    def create(self, resource: str, obj: dict, owned: bool = False) -> dict:
        """owned=True transfers ownership of obj (no entry copy) — see
        update()."""
        if resource not in self.resources:
            raise NotFound(f"unknown resource {resource}")
        _, namespaced = self.resources[resource]
        if not owned:
            obj = copy.deepcopy(obj)
        meta = obj.setdefault("metadata", {})
        if namespaced:
            meta.setdefault("namespace", "default")
        key = obj_key(obj, namespaced)
        with self._lock:
            if key in self._objects[resource]:
                raise AlreadyExists(f"{resource} \"{key}\" already exists")
            if resource == "pods":
                self._admit_pod_priority(obj)
            rv = self._next_rv()
            meta["uid"] = meta.get("uid") or str(uuid.uuid4())
            meta["resourceVersion"] = str(rv)
            meta.setdefault(
                "creationTimestamp",
                time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            )
            self._stamp_kind(resource, obj)
            self._objects[resource][key] = obj
            self._bump(resource)
            # events and the return share the stored dict (see update():
            # stored objects are replaced, never mutated in place)
            self._notify(resource, ADDED, obj, rv)
            return obj

    def update(self, resource: str, obj: dict, owned: bool = False) -> dict:
        """owned=True transfers ownership of obj to the store (no entry
        copy) — the caller MUST NOT touch obj afterwards.  The return
        value and watch events share the stored dict: stored objects are
        never mutated in place (updates REPLACE them), and consumers must
        not mutate what they receive (the informer-cache contract, same
        as list_shared)."""
        if resource not in self.resources:
            raise NotFound(f"unknown resource {resource}")
        _, namespaced = self.resources[resource]
        if not owned:
            obj = copy.deepcopy(obj)
        meta = obj.setdefault("metadata", {})
        if namespaced:
            meta.setdefault("namespace", "default")
        key = obj_key(obj, namespaced)
        with self._lock:
            cur = self._objects[resource].get(key)
            if cur is None:
                raise NotFound(f"{resource} \"{key}\" not found")
            sent_rv = meta.get("resourceVersion")
            if sent_rv and sent_rv != cur["metadata"]["resourceVersion"]:
                raise Conflict(
                    f"Operation cannot be fulfilled on {resource} \"{key}\": "
                    "the object has been modified"
                )
            if resource == "pods":
                self._validate_pod_update(key, cur, obj)
            rv = self._next_rv()
            meta["uid"] = cur["metadata"]["uid"]
            meta["resourceVersion"] = str(rv)
            meta.setdefault("creationTimestamp", cur["metadata"].get("creationTimestamp"))
            self._stamp_kind(resource, obj)
            self._objects[resource][key] = obj
            self._bump(resource)
            self._notify(resource, MODIFIED, obj, rv)
            return obj

    def delete(self, resource: str, name: str, namespace: str | None = None) -> None:
        if resource not in self.resources:
            raise NotFound(f"unknown resource {resource}")
        _, namespaced = self.resources[resource]
        key = f"{namespace or 'default'}/{name}" if namespaced else name
        with self._lock:
            cur = self._objects[resource].pop(key, None)
            if cur is None:
                raise NotFound(f"{resource} \"{key}\" not found")
            rv = self._next_rv()
            self._bump(resource)
            self._notify(resource, DELETED, cur, rv)  # popped: share freely
        if self._read_hooks:
            # a deleted object's deferred annotations are unobservable:
            # drop them (outside the lock) so they stop pinning the
            # wave's replay buffers
            self._discard_hooks(resource, name, namespace)

    def get(self, resource: str, name: str, namespace: str | None = None,
            copy_object: bool = True) -> dict:
        """copy_object=False returns the STORED object (no deep copy) —
        the read-only fast path; the caller must not mutate it (writers
        build a new object copy-on-write and update(owned=True))."""
        if resource not in self.resources:
            raise NotFound(f"unknown resource {resource}")
        _, namespaced = self.resources[resource]
        if copy_object and self._read_hooks:
            # transparent lazy-annotation materialization (store/lazy.py):
            # runs before the lock so the hook's write-back can take it
            self.materialize_reads(resource, name, namespace)
        key = f"{namespace or 'default'}/{name}" if namespaced else name
        with self._lock:
            cur = self._objects[resource].get(key)
            if cur is None:
                raise NotFound(f"{resource} \"{key}\" not found")
        # deep copy OUTSIDE the lock hold: stored objects are replaced,
        # never mutated in place (the update() contract), so the
        # reference grabbed under the lock is an immutable snapshot and
        # the O(object) copy must not serialize every other store user
        return copy.deepcopy(cur) if copy_object else cur

    def list(self, resource: str, namespace: str | None = None,
             label_selector: dict | None = None,
             copy_objects: bool = True) -> tuple[list[dict], int]:
        """-> (items, list resourceVersion).

        copy_objects=False returns the STORED objects without deep copies
        — a read-only fast path for the scheduling engine, whose per-wave
        listings of 10k annotated pods otherwise spend more time in
        deepcopy than in scheduling (callers MUST NOT mutate the returned
        manifests; upstream informer-cache objects carry the same
        contract)."""
        from ..state.selectors import object_matches_label_selector

        if copy_objects and self._read_hooks:
            # copying lists are the API-read surface: drain deferred
            # annotations for the whole resource first (the engine's
            # per-wave listings use copy_objects=False and stay lazy)
            self.materialize_reads(resource)
        with self._lock:
            if resource not in self.resources:
                raise NotFound(f"unknown resource {resource}")
            _, namespaced = self.resources[resource]
            # sorted-listing cache keyed on the per-resource write
            # counter: successive waves over an unchanged keyspace skip
            # the O(N log N) sort
            ver = self._res_version.get(resource, 0)
            entry = self._list_cache.get(resource)
            if entry is not None and entry[0] == ver:
                _, keys, shared = entry
            else:
                pairs = sorted(self._objects[resource].items())
                keys = [k for k, _ in pairs]
                shared = [o for _, o in pairs]
                self._list_cache[resource] = (ver, keys, shared)
            if namespace is None and label_selector is None:
                # fresh list object per call (callers may mutate the
                # LIST; the elements stay shared as documented)
                items = list(shared)
            else:
                items = []
                for key, obj in zip(keys, shared):
                    if namespace:
                        # namespaced keys carry the namespace
                        ns = (key.partition("/")[0] if namespaced else
                              ((obj.get("metadata") or {}).get("namespace")
                               or "default"))
                        if ns != namespace:
                            continue
                    if label_selector is not None and not \
                            object_matches_label_selector(label_selector, obj):
                        continue
                    items.append(obj)
            rv = self._last_rv
        if copy_objects:
            # the listing snapshot is the references; the O(N x object)
            # deep copies run outside the lock hold (stored objects are
            # replace-on-update, so the refs cannot change underneath) —
            # a 10k-pod copying list() must not stall writers/watchers
            items = [copy.deepcopy(obj) for obj in items]
        return items, rv

    def _validate_pod_update(self, key: str, cur: dict, obj: dict) -> None:
        """apiserver validation: spec.nodeName is write-once (only the
        empty->set transition of binding is allowed); this is what
        actually protects the simulator's placement authority from synced
        source-cluster updates."""
        cur_node = (cur.get("spec") or {}).get("nodeName") or ""
        new_node = (obj.get("spec") or {}).get("nodeName") or ""
        if cur_node and new_node != cur_node:
            e = ApiError(
                f'Pod "{key}" is invalid: spec: Forbidden: pod '
                "updates may not change fields other than allowed ones "
                f"(spec.nodeName {cur_node!r} -> {new_node!r})"
            )
            e.status = 422
            e.reason = "Invalid"
            raise e

    def apply_batch(self, resource: str, mutations) -> int:
        """Apply many read-modify-write updates under ONE lock hold — the
        scheduling engine's wave-commit write path: a wave's binds, status
        marks and reflector write-backs cost one lock acquisition and one
        contiguous resourceVersion range instead of N get+update round
        trips (each a lock acquisition plus a conflict-retry risk against
        concurrent writers).

        mutations: iterable of (name, namespace, mutate).  Each mutate
        callback receives a copy-on-write view of the CURRENT object (top
        level and the metadata/spec/status dicts are fresh; anything
        deeper is SHARED with the stored object and must be replaced, not
        mutated in place — the same contract as the engine's
        _update_pod).  A mutate returning False skips the write (no
        resourceVersion bump, no event); objects missing from the store
        are skipped, matching the per-pod path's NotFound no-op.  Per
        object the semantics are update(owned=True): rv stamp, uid/kind
        preservation, pod nodeName write-once validation (a validation
        failure raises mid-batch; earlier writes stand, exactly as the
        sequential loop would have left them).  Watch events fire in
        mutation order under the same lock hold, so subscribers observe
        the batch as one contiguous rv run.  Returns #objects written."""
        from ..utils.tracing import TRACER

        if resource not in self.resources:
            raise NotFound(f"unknown resource {resource}")
        _, namespaced = self.resources[resource]
        written = 0
        try:
            with self._lock:
                for name, namespace, mutate in mutations:
                    key = (f"{namespace or 'default'}/{name}"
                           if namespaced else name)
                    cur = self._objects[resource].get(key)
                    if cur is None:
                        continue
                    obj = dict(cur)
                    for part in ("metadata", "spec", "status"):
                        if part in obj:
                            obj[part] = dict(obj[part])
                    if mutate(obj) is False:
                        continue
                    if resource == "pods":
                        self._validate_pod_update(key, cur, obj)
                    meta = obj.setdefault("metadata", {})
                    rv = self._next_rv()
                    meta["uid"] = cur["metadata"]["uid"]
                    meta["resourceVersion"] = str(rv)
                    meta.setdefault("creationTimestamp",
                                    cur["metadata"].get("creationTimestamp"))
                    self._stamp_kind(resource, obj)
                    self._objects[resource][key] = obj
                    self._notify(resource, MODIFIED, obj, rv)
                    written += 1
                if written:
                    self._bump(resource)
        finally:
            if written:
                TRACER.count("store_batch_writes_total", written)
                TRACER.count("store_batches_total")
        return written

    # ----------------------------------------------------------- watch

    def watch(self, resource: str, since_rv: int = 0) -> queue.Queue:
        """Queue of (rv, event_type, object); buffered events newer than
        since_rv are replayed first.  Call unwatch() when done."""
        q: queue.Queue = queue.Queue()
        with self._lock:
            if resource not in self.resources:
                raise NotFound(f"unknown resource {resource}")
            for ev in self._events[resource]:
                if ev[0] > since_rv:
                    q.put(ev)
            self._watchers[resource].append(q)
        return q

    def list_and_watch(self, resource: str) -> tuple[list[dict], int, queue.Queue]:
        """Atomic list + watch registration: -> (items, rv, queue) where
        the queue carries exactly the events AFTER rv — the informer
        ListAndWatch contract without the ring-buffer race a separate
        list() then watch(since_rv=rv) pair has under heavy concurrent
        write traffic.  Items are the STORED objects (no deep copies,
        the list_shared contract: callers must not mutate them); call
        unwatch() when done with the queue."""
        q: queue.Queue = queue.Queue()
        with self._lock:
            if resource not in self.resources:
                raise NotFound(f"unknown resource {resource}")
            items = [obj for _, obj in sorted(self._objects[resource].items())]
            self._watchers[resource].append(q)
            return items, self._last_rv, q

    def unwatch(self, resource: str, q: queue.Queue) -> None:
        with self._lock:
            try:
                self._watchers[resource].remove(q)
            except ValueError:
                pass

    # ----------------------------------------------------------- etcd analogue

    def dump(self) -> dict:
        """Full keyspace snapshot (the etcd-prefix dump reset takes at boot,
        reference: reset/reset.go:32-55)."""
        if self._read_hooks:
            # snapshot fidelity: deferred annotations must be on the
            # objects the dump captures
            self.materialize_reads()
        with self._lock:
            # shallow per-resource snapshot under the lock pins the exact
            # keyspace state; the heavy deep copy happens outside it
            # (stored objects are never mutated in place)
            snap = {r: dict(objs) for r, objs in self._objects.items()}
        return copy.deepcopy(snap)

    def restore(self, kvs: dict) -> None:
        """Delete-prefix + re-put (reference: reset/reset.go:57-78).  Watch
        subscribers receive DELETED/ADDED events for the transition."""
        # copy the incoming keyspace BEFORE taking the lock: the caller's
        # dicts must not be shared with stored state, but the O(keyspace)
        # deep copy has no business inside the write lock hold
        copies = {resource: {key: copy.deepcopy(obj)
                             for key, obj in objs.items()}
                  for resource, objs in kvs.items()}
        if self._read_hooks:
            # the replaced keyspace invalidates every deferred record
            # (new incarnations, new uids): drop them all
            self._discard_hooks(None)
        with self._lock:
            for resource in list(self.resources):
                for key in list(self._objects[resource]):
                    cur = self._objects[resource].pop(key)
                    self._notify(resource, DELETED, cur, self._next_rv())
                self._bump(resource)
            for resource, objs in copies.items():
                if resource not in self.resources and objs:
                    # a dump from a store with registered extras: infer
                    # the registration from the objects themselves
                    first = next(iter(objs.values()))
                    self.register_resource(
                        resource, first.get("kind") or resource.capitalize(),
                        namespaced="/" in next(iter(objs)),
                        api_version=first.get("apiVersion") or "v1")
                for key, obj in objs.items():
                    self._objects[resource][key] = obj
                    self._notify(resource, ADDED, obj, self._next_rv())
                self._bump(resource)


def list_shared(store, resource: str) -> list[dict]:
    """Read-only listing without per-object deep copies — the engine's
    informer-cache fast path (callers MUST NOT mutate the returned
    manifests).  Stores without a `copy_objects` parameter (e.g. the
    remote HTTP cluster client) fall back to the plain listing.  The
    capability is probed ONCE per store by signature inspection and
    cached on the store object, so a TypeError raised inside a
    conforming store's list body propagates instead of being
    misread as "no fast path"."""
    fast = getattr(store, "_shared_list_ok", None)
    if fast is None:
        import inspect

        try:
            fast = "copy_objects" in inspect.signature(store.list).parameters
        except (TypeError, ValueError):
            fast = False
        try:
            store._shared_list_ok = fast
        except AttributeError:
            pass  # __slots__ store: re-probe next time
    if fast:
        return store.list(resource, copy_objects=False)[0]
    return store.list(resource)[0]
