"""Remote cluster client: CRUD + watch over the simulator HTTP API.

The client-go analogue for this framework: the reference's scheduler,
recorder, and syncer processes talk to a kube-apiserver through client-go
clientsets and dynamic informers (reference:
simulator/cmd/sched-recorder/recorder.go:39-51,
simulator/syncer/syncer.go:53-74).  Here, any out-of-process component
(the standalone scheduler of cmd/scheduler.py, the sched-recorder CLI,
a syncer source) talks to a simulator server's `/api/v1/*` resource CRUD
routes and its `/listwatchresources` push stream through this class,
which implements the same interface as `cluster.store.ObjectStore`
(get/list/create/update/delete/watch/unwatch), so every service that
takes an ObjectStore also works against a remote simulator.

Watch is informer-style: ONE shared streaming connection per client
(the reference's shared informer factory), demultiplexed by kind into
per-resource queues carrying (rv, event_type, obj) tuples — the same
wire tuples ObjectStore.watch delivers.

A copy of kube_scheduler_simulator_tpu/cluster/remote.py, host code with
its imports rewired to the port (cluster/store.py, state/selectors.py,
services/resourcewatcher.py): the standalone scheduler
(cmd/scheduler.py) runs the port's SchedulerEngine over it.
"""

from __future__ import annotations

import http.client
import json
import queue
import threading
import urllib.error
import urllib.parse
import urllib.request

from .store import (
    ADDED,
    AlreadyExists,
    ApiError,
    Conflict,
    DELETED,
    MODIFIED,
    NotFound,
    RESOURCES,
    _EVENT_BUFFER,
)

_KIND_TO_RESOURCE = {kind: res for res, (kind, _) in RESOURCES.items()}

_WATCH_EVENTS = {"ADDED": ADDED, "MODIFIED": MODIFIED, "DELETED": DELETED}


def _obj_rv(obj: dict) -> int:
    try:
        return int(((obj.get("metadata") or {}).get("resourceVersion")) or 0)
    except (TypeError, ValueError):
        return 0


class RemoteCluster:
    def __init__(self, base_url: str, timeout: float = 10.0,
                 extra_resources: list[dict] | None = None):
        """extra_resources mirrors ObjectStore's registry: the client of a
        server configured with extraResources declares the same table so
        paths/watch buckets exist for those kinds."""
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._lock = threading.Lock()
        self.resources: dict[str, tuple[str, bool]] = dict(RESOURCES)
        for spec in extra_resources or []:
            self.resources[spec["resource"]] = (
                spec.get("kind") or spec["resource"].capitalize(),
                bool(spec.get("namespaced", True)))
        self._kind_to_resource = {
            kind: res for res, (kind, _) in self.resources.items()}
        self._watchers: dict[str, list[queue.Queue]] = {r: [] for r in self.resources}
        # recent events per resource, replayed to late-registered watchers
        # so a subscriber added after the stream's initial listing still
        # sees the full state (mirrors ObjectStore's event ring buffer)
        self._events: dict[str, list[tuple[int, str, dict]]] = {r: [] for r in self.resources}
        # highest rv seen per resource — resent as *LastResourceVersion on
        # reconnect so a dropped stream resumes instead of re-listing
        # (the reference RetryWatcher resumes the same way,
        # resourcewatcher.go:127-134)
        self._last_rv: dict[str, int] = {r: 0 for r in self.resources}
        self._stream_thread: threading.Thread | None = None
        self._stream_resp = None
        self._stream_started = False
        self._closed = threading.Event()

    # ----------------------------------------------------------- HTTP

    def _request(self, method: str, path: str, body: dict | None = None) -> dict | None:
        url = self.base_url + path
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            url, data=data, method=method,
            headers={"Content-Type": "application/json"} if data else {},
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                raw = resp.read()
                return json.loads(raw) if raw else None
        except urllib.error.HTTPError as e:
            raw = e.read()
            try:
                payload = json.loads(raw) if raw else {}
            except ValueError:
                payload = {}
            msg = payload.get("message") or raw.decode(errors="replace")
            reason = payload.get("reason", "")
            if e.code == 404 or reason == "NotFound":
                raise NotFound(msg) from None
            if reason == "AlreadyExists":
                raise AlreadyExists(msg) from None
            if reason == "Conflict":
                raise Conflict(msg) from None
            err = ApiError(msg)
            err.status = e.code
            raise err from None

    def _obj_path(self, resource: str, name: str, namespace: str | None) -> str:
        _, namespaced = self.resources[resource]
        if namespaced:
            return f"/api/v1/{resource}/{namespace or 'default'}/{name}"
        return f"/api/v1/{resource}/{name}"

    # ----------------------------------------------------------- CRUD

    def get(self, resource: str, name: str, namespace: str | None = None,
            copy_object: bool = True) -> dict:
        # copy_object accepted for in-process-store signature parity; an
        # HTTP GET always materializes a fresh dict
        return self._request("GET", self._obj_path(resource, name, namespace))

    def list(self, resource: str, namespace: str | None = None,
             label_selector: dict | None = None) -> tuple[list[dict], int]:
        path = f"/api/v1/{resource}"
        if namespace:
            path += "?" + urllib.parse.urlencode({"namespace": namespace})
        out = self._request("GET", path) or {}
        items = out.get("items") or []
        if label_selector is not None:
            from ..state.selectors import object_matches_label_selector

            items = [o for o in items
                     if object_matches_label_selector(label_selector, o)]
        try:
            rv = int(out.get("resourceVersion") or 0)
        except ValueError:
            rv = 0
        return items, rv

    def create(self, resource: str, obj: dict, owned: bool = False) -> dict:
        # owned accepted for in-process-store signature parity; a
        # serialized HTTP POST never aliases the caller's dict
        return self._request("POST", f"/api/v1/{resource}", obj)

    def update(self, resource: str, obj: dict, owned: bool = False) -> dict:
        # owned is the in-process store's ownership-transfer hint; a
        # serialized HTTP PUT never aliases the caller's dict, so it is
        # accepted and ignored here
        meta = obj.get("metadata") or {}
        path = self._obj_path(resource, meta.get("name", ""), meta.get("namespace"))
        return self._request("PUT", path, obj)

    def delete(self, resource: str, name: str, namespace: str | None = None) -> None:
        self._request("DELETE", self._obj_path(resource, name, namespace))

    # ----------------------------------------------------------- watch

    def watch(self, resource: str, since_rv: int = 0) -> queue.Queue:
        """Queue of (rv, event_type, obj) for one resource kind, fed by the
        shared stream.  The stream's initial listing arrives as ADDED
        events (the reference watcher emits the same,
        resourcewatcher.go:61-90); events at or below since_rv are
        dropped client-side."""
        if self._closed.is_set():
            raise RuntimeError("RemoteCluster is closed")
        q: queue.Queue = queue.Queue()
        q._since_rv = since_rv  # consulted by the demux thread
        with self._lock:
            for ev in self._events[resource]:
                if ev[0] > since_rv:
                    q.put(ev)
            self._watchers[resource].append(q)
            if not self._stream_started:
                self._stream_started = True
                self._stream_thread = threading.Thread(
                    target=self._stream_loop, daemon=True
                )
                self._stream_thread.start()
        return q

    def unwatch(self, resource: str, q: queue.Queue) -> None:
        with self._lock:
            try:
                self._watchers[resource].remove(q)
            except ValueError:
                pass

    def close(self) -> None:
        self._closed.set()
        self._abort_stream()
        with self._lock:
            for qs in self._watchers.values():
                for q in qs:
                    q.put(None)
                qs.clear()

    def _abort_stream(self) -> None:
        """Unblock the stream thread's in-progress read.  Closing the
        HTTPResponse from another thread deadlocks on the buffered
        reader's lock, so shut the socket down instead — the blocked
        read then returns EOF immediately."""
        import socket as _socket

        resp = self._stream_resp
        if resp is None:
            return
        try:
            resp.fp.raw._sock.shutdown(_socket.SHUT_RDWR)
        except (AttributeError, OSError, ValueError):
            pass

    def _stream_loop(self) -> None:
        from ..services.resourcewatcher import WATCH_PARAMS

        base = self.base_url + "/api/v1/listwatchresources"
        while not self._closed.is_set():
            with self._lock:
                params = {WATCH_PARAMS[r]: str(rv)
                          for r, rv in self._last_rv.items() if rv > 0}
            url = base + ("?" + urllib.parse.urlencode(params) if params else "")
            try:
                resp = urllib.request.urlopen(url, timeout=None)
            except (urllib.error.URLError, OSError):
                if self._closed.wait(0.5):
                    return
                continue
            self._stream_resp = resp
            decoder = json.JSONDecoder()
            buf = ""
            try:
                while not self._closed.is_set():
                    chunk = resp.read1(65536) if hasattr(resp, "read1") else resp.read(4096)
                    if not chunk:
                        break
                    buf += chunk.decode()
                    while buf:
                        buf = buf.lstrip()
                        try:
                            ev, end = decoder.raw_decode(buf)
                        except ValueError:
                            break  # partial object; wait for more bytes
                        buf = buf[end:]
                        self._dispatch(ev)
            except Exception:
                # EOF mid-chunk after an abort, a dropped server, or a
                # malformed event: never let the stream thread die — fall
                # through to reconnect (RetryWatcher semantics)
                pass
            finally:
                try:
                    resp.close()
                except (OSError, http.client.HTTPException):
                    pass
            # reconnect (the reference's RetryWatcher auto-reconnects,
            # resourcewatcher.go:127-134) unless the client closed us
            if self._closed.wait(0.5):
                return

    def _dispatch(self, ev: dict) -> None:
        resource = self._kind_to_resource.get(ev.get("kind") or "")
        event_type = _WATCH_EVENTS.get(ev.get("eventType") or "")
        obj = ev.get("obj")
        if resource is None or event_type is None or obj is None:
            return
        rv = _obj_rv(obj)
        with self._lock:
            if rv > self._last_rv[resource]:
                self._last_rv[resource] = rv
            buf = self._events[resource]
            buf.append((rv, event_type, obj))
            if len(buf) > _EVENT_BUFFER:
                del buf[: len(buf) - _EVENT_BUFFER]
            for q in self._watchers[resource]:
                if rv and rv <= getattr(q, "_since_rv", 0):
                    continue
                q.put((rv, event_type, obj))
