"""Real kube-apiserver client: the import/sync/record source adapter.

The reference's importer, syncer, and recorder take client-go dynamic
clients against any real cluster (reference:
simulator/oneshotimporter/importer.go:29-37, syncer/syncer.go:53-74,
cmd/sched-recorder/recorder.go:69-93; headline feature in
simulator/docs/import-cluster-resources.md:1-55).  This module is that
capability for this framework: `KubeAPICluster` speaks the kube-apiserver
REST protocol — list with labelSelector and resourceVersion, streaming
watch with resume and 410-Gone recovery, kubeconfig auth (token, basic,
client certificates, CA pinning, insecure-skip-verify) — and implements
the same read interface as `cluster.store.ObjectStore`
(get/list/watch/unwatch, plus create/update/delete for completeness), so
`OneShotImporter`, `SyncerService`, and `RecorderService` can point at a
production cluster unchanged.

Event tuples match ObjectStore.watch: (rv, event_type, obj) with
event_type in {ADDED, MODIFIED, DELETED}.  Real resourceVersions are
opaque strings; they are exposed as ints when they parse (etcd rvs do),
else a per-client monotonic counter stands in — consumers only use rv
for ordering/resume diagnostics, resume itself keeps the server's exact
string.

No kubernetes client library is required (none is vendored here — the
protocol is plain HTTPS + JSON, which is the point of the adapter).

A copy of kube_scheduler_simulator_tpu/cluster/kubeapi.py, host code with
its imports rewired to the port: its events are the port's ObjectStore
tuples (cluster/store.py), and a session's kubeConfig import or sync
source (server/di.py) dials a cluster through `connect_source`.
"""

from __future__ import annotations

import base64
import json
import queue
import ssl
import tempfile
import threading
import urllib.error
import urllib.parse
import urllib.request

from .store import (
    ADDED,
    ApiError,
    AlreadyExists,
    Conflict,
    DELETED,
    MODIFIED,
    NotFound,
    RESOURCES,
)

# GVR -> (API path prefix, namespaced).  The simulator's seven GVRs
# (reference: recorder/recorder.go:45-53) live in three API groups.
API_PATHS: dict[str, tuple[str, bool]] = {
    "namespaces": ("/api/v1", False),
    "nodes": ("/api/v1", False),
    "pods": ("/api/v1", True),
    "persistentvolumes": ("/api/v1", False),
    "persistentvolumeclaims": ("/api/v1", True),
    "priorityclasses": ("/apis/scheduling.k8s.io/v1", False),
    "storageclasses": ("/apis/storage.k8s.io/v1", False),
}

_WATCH_TYPES = {"ADDED": ADDED, "MODIFIED": MODIFIED, "DELETED": DELETED}


def _label_selector_str(sel) -> str:
    """dict {k: v} or metav1.LabelSelector-shaped dict -> selector string."""
    if not sel:
        return ""
    if isinstance(sel, str):
        return sel
    if "matchLabels" in sel or "matchExpressions" in sel:
        parts = [f"{k}={v}" for k, v in (sel.get("matchLabels") or {}).items()]
        for e in sel.get("matchExpressions") or []:
            op = (e.get("operator") or "In").lower()
            key = e.get("key", "")
            vals = ",".join(e.get("values") or [])
            if op == "in":
                parts.append(f"{key} in ({vals})")
            elif op == "notin":
                parts.append(f"{key} notin ({vals})")
            elif op == "exists":
                parts.append(key)
            elif op == "doesnotexist":
                parts.append(f"!{key}")
        return ",".join(parts)
    return ",".join(f"{k}={v}" for k, v in sel.items())


def _data_or_file(data_b64: str | None, path: str | None,
                  keep: list) -> str | None:
    """Inline base64 kubeconfig data -> temp file (ssl wants paths).
    Files land in `keep` and are unlinked by the caller the moment the
    SSL context has loaded them — key material must not linger in
    $TMPDIR."""
    if data_b64:
        f = tempfile.NamedTemporaryFile(suffix=".pem", delete=False)
        f.write(base64.b64decode(data_b64))
        f.flush()
        keep.append(f)
        return f.name
    return path


def load_kubeconfig(path: str, context: str | None = None):
    """Parse a kubeconfig -> (server_url, ssl.SSLContext | None, headers).

    Supports the fields the reference's clientcmd path exercises for the
    simulator: cluster.server, certificate-authority(-data),
    insecure-skip-tls-verify; user.token, username/password,
    client-certificate(-data) + client-key(-data)."""
    with open(path) as f:
        text = f.read()
    try:
        # a kubeconfig in JSON (a subset of YAML, which kubectl reads too)
        # parses without PyYAML
        kc = json.loads(text) or {}
    except ValueError:
        import yaml

        kc = yaml.safe_load(text) or {}
    ctx_name = context or kc.get("current-context") or ""
    ctx = next((c["context"] for c in kc.get("contexts") or []
                if c.get("name") == ctx_name), None)
    if ctx is None:
        raise ValueError(f"kubeconfig: context {ctx_name!r} not found")
    cluster = next((c["cluster"] for c in kc.get("clusters") or []
                    if c.get("name") == ctx.get("cluster")), None)
    if cluster is None or not cluster.get("server"):
        raise ValueError("kubeconfig: cluster/server missing")
    user = next((u["user"] for u in kc.get("users") or []
                 if u.get("name") == ctx.get("user")), {}) or {}

    server = cluster["server"].rstrip("/")
    headers: dict[str, str] = {}
    if user.get("token"):
        headers["Authorization"] = f"Bearer {user['token']}"
    elif user.get("username") is not None:
        cred = f"{user.get('username', '')}:{user.get('password', '')}"
        headers["Authorization"] = (
            "Basic " + base64.b64encode(cred.encode()).decode())

    sslctx = None
    if server.startswith("https"):
        import os

        keep: list = []
        try:
            if cluster.get("insecure-skip-tls-verify"):
                sslctx = ssl.create_default_context()
                sslctx.check_hostname = False
                sslctx.verify_mode = ssl.CERT_NONE
            else:
                ca = _data_or_file(cluster.get("certificate-authority-data"),
                                   cluster.get("certificate-authority"), keep)
                sslctx = ssl.create_default_context(cafile=ca)
            cert = _data_or_file(user.get("client-certificate-data"),
                                 user.get("client-certificate"), keep)
            key = _data_or_file(user.get("client-key-data"),
                                user.get("client-key"), keep)
            if cert and key:
                sslctx.load_cert_chain(cert, key)
        finally:
            # ssl loads files eagerly — inline cert/key material must not
            # outlive this call on disk
            for f in keep:
                f.close()
                try:
                    os.unlink(f.name)
                # best-effort temp-file cleanup; the config loaded
                # kss-analyze: allow(swallowed-exception)
                except OSError:
                    pass
    return server, sslctx, headers


class KubeAPICluster:
    """ObjectStore-shaped client over a real kube-apiserver."""

    def __init__(self, base_url: str | None = None,
                 kubeconfig: str | None = None, context: str | None = None,
                 timeout: float = 10.0, token: str | None = None,
                 extra_paths: dict[str, tuple[str, bool]] | None = None):
        if kubeconfig:
            base_url, sslctx, headers = load_kubeconfig(kubeconfig, context)
        else:
            if not base_url:
                raise ValueError("base_url or kubeconfig required")
            sslctx, headers = None, {}
            if base_url.startswith("https"):
                sslctx = ssl.create_default_context()
        if token:
            headers["Authorization"] = f"Bearer {token}"
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self.headers = headers
        self.sslctx = sslctx
        self.paths = dict(API_PATHS)
        self.paths.update(extra_paths or {})
        self.resources = {r: (RESOURCES.get(r, (r.capitalize(), ns))[0], ns)
                          for r, (_, ns) in self.paths.items()}
        self._lock = threading.Lock()
        self._watchers: dict[str, list[queue.Queue]] = {}
        self._watch_threads: dict[str, threading.Thread] = {}
        self._watch_stop: dict[str, threading.Event] = {}
        self._rv_counter = 0
        # own lock: _rv_int's synthesized-counter branch (non-integer
        # server rvs) is reached from paths already holding self._lock
        # (the late-subscriber handover replay) — sharing the watch lock
        # deadlocked there
        self._rv_lock = threading.Lock()

    # ---------------- HTTP plumbing -------------------------------------

    def _url(self, resource: str, name: str | None = None,
             namespace: str | None = None, query: dict | None = None) -> str:
        try:
            prefix, namespaced = self.paths[resource]
        except KeyError:
            raise NotFound(f"resource {resource!r} has no API path") from None
        path = prefix
        if namespaced and namespace:
            path += f"/namespaces/{urllib.parse.quote(namespace)}"
        path += f"/{resource}"
        if name:
            path += f"/{urllib.parse.quote(name)}"
        url = self.base_url + path
        if query:
            url += "?" + urllib.parse.urlencode(
                {k: v for k, v in query.items() if v not in (None, "")})
        return url

    def _request(self, method: str, url: str, body: dict | None = None,
                 timeout: float | None = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(url, data=data, method=method)
        for k, v in self.headers.items():
            req.add_header(k, v)
        if data is not None:
            req.add_header("Content-Type", "application/json")
        try:
            return urllib.request.urlopen(
                req, timeout=timeout or self.timeout, context=self.sslctx)
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = e.read().decode(errors="replace")[:300]
            # the detail body is advisory; the HTTPError re-raises typed
            # kss-analyze: allow(swallowed-exception)
            except OSError:
                pass
            if e.code == 404:
                raise NotFound(detail or url) from None
            if e.code == 409:
                raise (AlreadyExists(detail) if "already exists" in detail
                       else Conflict(detail)) from None
            err = ApiError(f"{method} {url}: HTTP {e.code} {detail}")
            err.status = e.code
            raise err from None

    def _json(self, method: str, url: str, body: dict | None = None) -> dict:
        with self._request(method, url, body) as resp:
            return json.loads(resp.read())

    def _rv_int(self, rv_str) -> int:
        try:
            return int(rv_str)
        except (TypeError, ValueError):
            with self._rv_lock:
                self._rv_counter += 1
                return self._rv_counter

    # ---------------- store interface -----------------------------------

    def get(self, resource: str, name: str, namespace: str | None = None,
            **_kw) -> dict:
        namespaced = self.paths.get(resource, ("", False))[1]
        if namespaced and not namespace:
            namespace = "default"  # ObjectStore.get parity
        return self._json("GET", self._url(
            resource, name, namespace if namespaced else None))

    def _list_raw(self, resource: str, namespace: str | None = None,
                  label_selector=None) -> tuple[list[dict], str]:
        sel = _label_selector_str(label_selector)
        data = self._json("GET", self._url(
            resource, namespace=namespace,
            query={"labelSelector": sel} if sel else None))
        items = data.get("items") or []
        kind = data.get("kind", "")
        item_kind = kind[:-4] if kind.endswith("List") else None
        for obj in items:
            # list items omit kind/apiVersion; stamp them the way client-go
            # dynamic listers do so downstream consumers see full objects
            obj.setdefault("kind", item_kind or self.resources[resource][0])
            obj.setdefault("apiVersion", data.get("apiVersion", "v1"))
        rv = ((data.get("metadata") or {}).get("resourceVersion")) or ""
        return items, rv

    def list(self, resource: str, namespace: str | None = None,
             label_selector=None) -> tuple[list[dict], int]:
        items, rv = self._list_raw(resource, namespace, label_selector)
        return items, self._rv_int(rv)

    def create(self, resource: str, obj: dict) -> dict:
        ns = (obj.get("metadata") or {}).get("namespace")
        return self._json("POST", self._url(resource, namespace=ns), obj)

    def update(self, resource: str, obj: dict) -> dict:
        meta = obj.get("metadata") or {}
        return self._json("PUT", self._url(
            resource, meta.get("name", ""), meta.get("namespace")), obj)

    def delete(self, resource: str, name: str,
               namespace: str | None = None) -> None:
        self._json("DELETE", self._url(resource, name, namespace))

    # ---------------- watch ---------------------------------------------

    def watch(self, resource: str, since_rv: int = 0) -> queue.Queue:
        """Subscribe to a server-side watch stream; returns a queue of
        (rv, event_type, obj).  One streaming connection per resource,
        shared by all subscribers; reconnects with the last seen
        resourceVersion (the RetryWatcher behavior, reference:
        resourcewatcher/resourcewatcher.go:127-134) and recovers from
        410 Gone by restarting from the server's current state."""
        if resource not in self.paths:
            raise NotFound(f"resource {resource!r} has no API path")
        q: queue.Queue = queue.Queue()
        buf: queue.Queue | None = None
        with self._lock:
            start_thread = resource not in self._watch_threads
            if start_thread:
                self._watchers.setdefault(resource, []).append(q)
                stop = threading.Event()
                t = threading.Thread(target=self._watch_loop,
                                     args=(resource, stop), daemon=True,
                                     name=f"kubeapi-watch-{resource}")
                self._watch_stop[resource] = stop
                self._watch_threads[resource] = t
                t.start()
            else:
                # the shared loop's initial-state replay already
                # happened; give THIS subscriber its own ADDED replay so
                # every subscriber sees ListAndWatch semantics regardless
                # of arrival order.  The buffer joins the fan-out UNDER
                # THE SAME LOCK HOLD as the _watch_threads check: were it
                # registered in a second acquisition, the last existing
                # subscriber could unwatch() in the window, stopping the
                # loop thread and leaving this subscriber attached to a
                # dead fan-out (one ADDED replay, then silence).  With
                # the buffer already in the subscriber list, unwatch()
                # sees it and keeps the loop alive.
                buf = queue.Queue()
                self._watchers.setdefault(resource, []).append(buf)
        if buf is not None:
            # handover: snapshot ADDEDs first, then buffered events minus
            # the state the snapshot already carries — a buffered event
            # whose resourceVersion EQUALS the listed object's is the very
            # update the list reflected, so replaying it would double-
            # deliver.  The comparison is on the server's EXACT rv
            # strings: resourceVersions are opaque (only equality is
            # defined), and the synthesized _rv_int counters are assigned
            # in arrival order, which is meaningless for non-integer rvs
            # (ADVICE r5 #3).  An event for a key the list doesn't carry
            # (e.g. a DELETE racing the list) always goes through.  The
            # swap buffer -> q is atomic with deliveries (_fanout puts
            # under the lock).
            try:
                items, _ = self._list_raw(resource)
            except BaseException:
                # no orphan subscriber on a failed replay list; unwatch
                # also stops the loop thread if buf was the last one
                self.unwatch(resource, buf)
                raise
            listed: dict = {}
            listed_uid: dict = {}
            for obj in items:
                m = obj.get("metadata") or {}
                k = (m.get("namespace"), m.get("name"))
                listed[k] = m.get("resourceVersion")
                listed_uid[k] = m.get("uid")
            with self._lock:
                subs = self._watchers[resource]
                subs[subs.index(buf)] = q
                for obj in items:
                    orv = (obj.get("metadata") or {}).get("resourceVersion")
                    q.put((self._rv_int(orv), ADDED, obj))
                buffered: list[tuple] = []
                while True:
                    try:
                        buffered.append(buf.get_nowait())
                    # Empty IS the drain's termination, not a failure
                    # kss-analyze: allow(swallowed-exception)
                    except queue.Empty:
                        break
                # the buffer is FIFO per key: the buffered event whose rv
                # EQUALS the listed object's marks the point the snapshot
                # already reflects — drop it and everything before it for
                # that key (older intermediates would regress the
                # subscriber's cache AFTER the newer ADDED), deliver only
                # what came after.  An equal-rv DELETED still goes
                # through: a pre-list delete can't appear in the list, so
                # an equal-rv DELETED is a real post-list deletion.
                # When NO buffered event matches the listed rv (the list
                # raced ahead of the fan-out) opaque rvs are undecidable;
                # events are then DELIVERED — a transiently stale
                # re-delivery self-heals on the next live event, whereas
                # dropping a genuinely newer update loses it forever
                # (the at-least-once bias of the ADVICE r5 #3 contract).
                cut: dict = {}
                for idx, ev in enumerate(buffered):
                    m = (ev[2].get("metadata") or {})
                    k = (m.get("namespace"), m.get("name"))
                    if (k in listed and ev[1] != DELETED
                            and m.get("resourceVersion") == listed[k]):
                        cut[k] = idx + 1
                dead_listed: set = set()
                for idx, ev in enumerate(buffered):
                    m = (ev[2].get("metadata") or {})
                    k = (m.get("namespace"), m.get("name"))
                    if k not in listed:
                        q.put(ev)
                        continue
                    if idx < cut.get(k, 0):
                        continue  # at-or-before the snapshot's state
                    buid, luid = m.get("uid"), listed_uid.get(k)
                    if buid and luid and buid != luid:
                        # a different uid is another incarnation of the
                        # key.  BEFORE the listed incarnation's own
                        # DELETED it can only be an older one (a pre-list
                        # delete can't be listed): stale MODIFIEDs, and a
                        # DELETED that must not remove the live object.
                        # AFTER it, it's a post-list recreate — deliver,
                        # or the subscriber never learns the new object
                        # exists.
                        if k in dead_listed:
                            q.put(ev)
                        continue
                    if ev[1] == DELETED and buid and luid:
                        # the LISTED incarnation died post-list (a
                        # pre-list delete can't appear in the list)
                        dead_listed.add(k)
                    brv, lrv = m.get("resourceVersion"), listed[k]
                    if brv == lrv:
                        if ev[1] != DELETED:
                            continue  # duplicate of the snapshot's state
                    else:
                        try:
                            if int(brv) < int(lrv):
                                continue  # provably older than the snapshot
                        # kss-analyze: allow(swallowed-exception)
                        except (TypeError, ValueError):
                            pass  # opaque rvs: only equality is defined
                    q.put(ev)
        return q

    def unwatch(self, resource: str, q: queue.Queue) -> None:
        with self._lock:
            subs = self._watchers.get(resource, [])
            if q in subs:
                subs.remove(q)
            if not subs and resource in self._watch_threads:
                self._watch_stop[resource].set()
                del self._watch_threads[resource]
                del self._watch_stop[resource]

    def stop(self) -> None:
        with self._lock:
            for stop in self._watch_stop.values():
                stop.set()
            self._watch_threads.clear()
            self._watch_stop.clear()

    def _fanout(self, resource: str, item: tuple) -> None:
        # puts happen UNDER the lock: late-subscriber handover (watch())
        # swaps its buffer for the real queue atomically with respect to
        # deliveries, so no event can race past the swap
        with self._lock:
            for q in self._watchers.get(resource, []):
                q.put(item)

    def _watch_loop(self, resource: str, stop: threading.Event) -> None:
        resume_rv: str | None = None  # server's exact string, for resume
        backoff = 0.5
        while not stop.is_set():
            try:
                if resume_rv is None:
                    # ListAndWatch (client-go reflector semantics): the
                    # initial state arrives as ADDED events, then the
                    # watch resumes from the list's resourceVersion —
                    # the reference's informer-driven recorder records
                    # pre-existing objects exactly this way
                    items, rv_str = self._list_raw(resource)
                    for obj in items:
                        orv = ((obj.get("metadata") or {})
                               .get("resourceVersion"))
                        self._fanout(resource,
                                     (self._rv_int(orv), ADDED, obj))
                    resume_rv = rv_str or "0"
                url = self._url(resource, query={
                    "watch": "true",
                    "resourceVersion": resume_rv,
                    "allowWatchBookmarks": "true",
                })
                # long-lived stream: no read timeout beyond connect
                with self._request("GET", url, timeout=3600) as resp:
                    backoff = 0.5
                    for line in resp:
                        if stop.is_set():
                            return
                        if not line.strip():
                            continue
                        ev = json.loads(line)
                        etype = ev.get("type", "")
                        obj = ev.get("object") or {}
                        rv_str = ((obj.get("metadata") or {})
                                  .get("resourceVersion"))
                        if etype == "BOOKMARK":
                            resume_rv = rv_str or resume_rv
                            continue
                        if etype == "ERROR":
                            if (obj.get("code") == 410
                                    or "Gone" in str(obj.get("reason", ""))):
                                resume_rv = None  # expired: restart fresh
                            break
                        mapped = _WATCH_TYPES.get(etype)
                        if mapped is None:
                            continue
                        resume_rv = rv_str or resume_rv
                        if stop.is_set():
                            return  # superseded loop must not double-fan
                        self._fanout(resource,
                                     (self._rv_int(rv_str), mapped, obj))
            except NotFound:
                return  # GVR vanished; nothing to stream
            # transient stream failure: backoff reconnect IS the handling
            # kss-analyze: allow(swallowed-exception)
            except (ApiError, urllib.error.URLError, OSError,
                    json.JSONDecodeError):
                pass  # drop to reconnect
            if stop.wait(backoff):
                return
            backoff = min(backoff * 2, 30.0)


def connect_source(spec: str, timeout: float = 10.0):
    """A source cluster from a CLI/config string.

    - an existing file path -> kubeconfig against a real apiserver
    - a URL serving /apis (API group discovery) -> bare-URL real
      apiserver (KWOK et al. without auth)
    - any other URL -> a simulator server (`cluster.remote.RemoteCluster`)
    """
    import os

    if os.path.isfile(spec):
        return KubeAPICluster(kubeconfig=spec, timeout=timeout)
    probe = KubeAPICluster(base_url=spec, timeout=min(timeout, 5.0))
    try:
        with probe._request("GET", spec.rstrip("/") + "/apis") as resp:
            if (resp.status == 200
                    and "groups" in json.loads(resp.read() or b"{}")):
                return KubeAPICluster(base_url=spec, timeout=timeout)
    # the probe failing IS the signal to fall back to RemoteCluster
    # kss-analyze: allow(swallowed-exception)
    except (ApiError, NotFound, urllib.error.URLError, OSError, ValueError):
        pass
    from .remote import RemoteCluster

    return RemoteCluster(spec, timeout=timeout)
