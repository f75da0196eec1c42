"""Scheduler extender support: webhook client, recording proxy, config rewrite.

A copy of kube_scheduler_simulator_tpu/scheduler/extender.py, host code with its
imports rewired to the port.

Capability parity with the reference extender subsystem
(reference: simulator/scheduler/extender/):

  * Extender client (extender.go:86-199): HTTP POST of ExtenderArgs JSON to
    the configured urlPrefix + verb, 5s default timeout, managedResources /
    nodeCacheCapable handling reduced to the JSON contract; Prioritize
    results are weight-scaled by the caller as upstream does.
  * Service (service.go:28-85): one entry per config extender; each call
    records (args, result) into the extender result store, then returns
    the real extender's response verbatim.
  * OverrideExtendersCfgToSimulator (service.go:88-109): rewrites each
    extender's urlPrefix to
    http://localhost:<port>/api/v1/extender/<verb>/<index> so scheduler
    traffic routes through the simulator, is recorded, and is then
    forwarded to the user's real extender.
  * Result store (extender/resultstore/resultstore.go): per-verb
    map[extenderHost] -> result JSON under the 4 annotation keys
    extender-{filter,prioritize,preempt,bind}-result
    (extender/annotation/annotation.go:3-12).
"""

from __future__ import annotations

import json
import threading
import urllib.request
from urllib.parse import urlparse

from ..store import annotations as ann

DEFAULT_TIMEOUT_SECONDS = 5  # reference: extender.go:22-24


# ---------------------------------------------------------------- wire form
#
# The reference stores extender results as Go structs and re-marshals them
# for the annotation, so the recorded JSON always carries the canonical
# k8s.io/kube-scheduler/extender/v1 tags in struct DECLARATION order, with
# omitempty semantics, and drops fields the struct doesn't declare.
# Canonicalizing at record time reproduces those bytes regardless of how
# the user's extender cased its response.  Field specs: (canonical tag,
# accepted aliases, omitempty).

# omitempty values: "ptr" fields (pointer-typed in Go) drop only nil —
# a non-nil empty slice like nodenames [] IS emitted; plain slices/maps/
# strings/ints drop their Go zero value.
_FILTER_RESULT_FIELDS = [
    ("nodes", ("nodes", "Nodes"), "ptr"),
    ("nodenames", ("nodenames", "NodeNames", "nodeNames"), "ptr"),
    ("failedNodes", ("failedNodes", "FailedNodes"), True),
    ("failedAndUnresolvable",
     ("failedAndUnresolvable", "FailedAndUnresolvableNodes",
      "failedAndUnresolvableNodes"), True),
    ("error", ("error", "Error"), True),
]
_HOST_PRIORITY_FIELDS = [  # HostPriority has NO omitempty
    ("host", ("host", "Host"), False, ""),
    ("score", ("score", "Score"), False, 0),
]
_META_POD_FIELDS = [("uid", ("uid", "UID"), True)]
_META_VICTIMS_FIELDS = [
    ("pods", ("pods", "Pods"), True),
    ("numPDBViolations", ("numPDBViolations", "NumPDBViolations"), True),
]
_BINDING_RESULT_FIELDS = [("error", ("error", "Error"), True)]


def pick_field(obj: dict, *aliases) -> object:
    """First PRESENT key among casing aliases (an explicit empty value
    must not read as 'absent'). Shared by the canonicalizer, the engine's
    webhook paths, and preemption's extender call."""
    for a in aliases:
        if a in obj:
            return obj[a]
    return None


def _pick(obj: dict, aliases) -> object:
    return pick_field(obj, *aliases)


def _canon_struct(obj, fields, nested=()) -> dict:
    """Rebuild a struct-shaped dict in declaration order with canonical
    tags; omitempty fields drop None/""/empty containers/0 (Go zero
    values).  `nested` maps a tag to a canonicalizer for its value."""
    if not isinstance(obj, dict):
        return {}
    out = {}
    nested = dict(nested)
    for spec in fields:
        tag, aliases, omitempty = spec[0], spec[1], spec[2]
        v = _pick(obj, aliases)
        if tag in nested and v is not None:
            v = nested[tag](v)
        if omitempty == "ptr":
            if v is None:
                continue  # nil pointer; non-nil empty values ARE emitted
        elif omitempty:
            if v is None or v == "" or v == [] or v == {} or v == 0:
                continue
        elif v is None:
            v = spec[3]  # Go zero value for a missing non-omitempty field
        out[tag] = v
    return out


def _canon_sorted_map(m, value_fn) -> dict:
    """Go sorts map keys when marshalling."""
    if not isinstance(m, dict):
        return {}
    return {k: value_fn(m[k]) for k in sorted(m)}


def _canon_meta_victims(v) -> dict:
    return _canon_struct(
        v, _META_VICTIMS_FIELDS,
        nested={"pods": lambda pods: [
            _canon_struct(p, _META_POD_FIELDS) for p in (pods or [])]})


def canonicalize_result(verb: str, result):
    """Extender response -> the exact object the reference would have
    stored (typed struct round-trip)."""
    if verb == "filter":
        return _canon_struct(
            result, _FILTER_RESULT_FIELDS,
            nested={
                "failedNodes": lambda m: _canon_sorted_map(m, lambda v: v),
                "failedAndUnresolvable":
                    lambda m: _canon_sorted_map(m, lambda v: v),
            })
    if verb == "prioritize":
        if not isinstance(result, list):
            return []
        return [_canon_struct(e, _HOST_PRIORITY_FIELDS) for e in result]
    if verb == "preempt":
        canon = _canon_struct(
            result,
            [("nodeNameToMetaVictims",
              ("nodeNameToMetaVictims", "NodeNameToMetaVictims"), True)],
            nested={"nodeNameToMetaVictims":
                    lambda m: _canon_sorted_map(m, _canon_meta_victims)})
        if not canon and isinstance(result, dict):
            # lenient NodeNameToVictims answers (full pod objects) are
            # honored for narrowing, so the record must show them too —
            # converted to the canonical meta form (uids), as the
            # reference's typed round-trip would have required
            victims = pick_field(result, "nodeNameToVictims",
                                 "NodeNameToVictims")
            if isinstance(victims, dict):
                meta = {}
                for node in sorted(victims):
                    v = victims[node] or {}
                    pods = pick_field(v, "pods", "Pods") or []
                    mv = {"pods": [
                        {"uid": ((p.get("metadata") or {}).get("uid")
                                 or (p.get("metadata") or {}).get("name", ""))}
                        for p in pods]}
                    if not mv["pods"]:
                        del mv["pods"]
                    npdb = pick_field(v, "numPDBViolations", "NumPDBViolations")
                    if npdb:
                        mv["numPDBViolations"] = npdb
                    meta[node] = mv
                if meta:
                    canon = {"nodeNameToMetaVictims": meta}
        return canon
    if verb == "bind":
        return _canon_struct(result, _BINDING_RESULT_FIELDS)
    return result


def marshal_wire(hostmap: dict) -> str:
    """map[extenderHost]result -> Go-marshal-identical JSON: hosts (map
    keys) sorted, struct fields kept in canonical declaration order, Go
    HTML escaping."""
    ordered = {h: hostmap[h] for h in sorted(hostmap)}
    s = json.dumps(ordered, sort_keys=False, separators=(",", ":"),
                   ensure_ascii=False)
    return s.replace("<", "\\u003c").replace(">", "\\u003e").replace("&", "\\u0026")


def _tls_material(data_b64, path: str | None) -> bytes | None:
    """One TLSClientConfig field to PEM bytes: inline data wins over the
    file path (client-go transport.Config loads *File into *Data only when
    the data form is empty).  Data accepts base64 (the Go []byte JSON wire
    form) or raw PEM text/bytes."""
    if data_b64:
        if isinstance(data_b64, bytes):
            raw = data_b64
        else:
            s = data_b64.strip()
            if s.startswith("-----BEGIN"):
                raw = s.encode()
            else:
                import base64

                raw = base64.b64decode(s)
        return raw
    if path:
        with open(path, "rb") as f:
            return f.read()
    return None


class ExtenderClient:
    """HTTP(S) client for one configured extender.

    TLS mirrors the reference's makeTransport
    (reference: simulator/scheduler/extender/extender.go:54-84 over
    client-go rest.TLSConfigFor): tlsConfig carries
    insecure/serverName/certFile/keyFile/caFile/certData/keyData/caData
    (data forms base64 per Go []byte marshalling, file forms read at
    client build); enableHTTPS with no CA configured implies insecure;
    insecure together with a CA is rejected, as client-go rejects it."""

    def __init__(self, config: dict):
        self.config = config
        self.url_prefix = (config.get("urlPrefix") or "").rstrip("/")
        self.weight = int(config.get("weight") or 1)
        from ..utils.duration import parse_duration_seconds

        raw_timeout = config.get("httpTimeout")
        self.timeout = (
            parse_duration_seconds(raw_timeout) if raw_timeout else DEFAULT_TIMEOUT_SECONDS
        )
        self.filter_verb = config.get("filterVerb") or ""
        self.prioritize_verb = config.get("prioritizeVerb") or ""
        self.preempt_verb = config.get("preemptVerb") or ""
        self.bind_verb = config.get("bindVerb") or ""
        self.ignorable = bool(config.get("ignorable", False))
        # name set only: ignoredByScheduler (excluding the resource from
        # node fit math) is not modeled
        self.managed_resources = {
            r["name"] for r in (config.get("managedResources") or [])
            if r.get("name")
        }
        self._opener = self._build_opener(
            config.get("tlsConfig") or {}, bool(config.get("enableHTTPS")))

    def _build_opener(self, tc: dict, enable_https: bool):
        """urllib opener with the extender's TLS client settings, or None
        for plain-http extenders (urlopen default)."""
        import urllib.request as _rq

        https = enable_https or self.url_prefix.startswith("https://")
        if not tc and not https:
            return None
        import http.client
        import ssl
        import tempfile

        insecure = bool(tc.get("insecure"))
        server_name = tc.get("serverName") or None
        ca = _tls_material(tc.get("caData"), tc.get("caFile"))
        cert = _tls_material(tc.get("certData"), tc.get("certFile"))
        key = _tls_material(tc.get("keyData"), tc.get("keyFile"))
        if insecure and ca is not None:
            # client-go transport.Config validation: a CA with the
            # insecure flag is contradictory
            raise ValueError(
                "extender tlsConfig: specifying a root CA with insecure is not allowed")
        if enable_https and ca is None:
            insecure = True  # reference extender.go:66-72
        ctx = ssl.create_default_context()
        if ca is not None:
            ctx.load_verify_locations(cadata=ca.decode())
        if insecure:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if cert is not None and key is not None:
            # ssl's cert-chain loader is file-path only; inline data goes
            # through ephemeral files deleted as soon as they are loaded
            with tempfile.NamedTemporaryFile(suffix=".pem") as cf, \
                    tempfile.NamedTemporaryFile(suffix=".pem") as kf:
                cf.write(cert)
                cf.flush()
                kf.write(key)
                kf.flush()
                ctx.load_cert_chain(cf.name, kf.name)

        class _SNIConnection(http.client.HTTPSConnection):
            """Verify/SNI against tlsConfig.serverName instead of the URL
            host (Go tls.Config.ServerName semantics)."""

            def connect(self_c):
                import socket

                sock = socket.create_connection(
                    (self_c.host, self_c.port), self_c.timeout)
                self_c.sock = ctx.wrap_socket(
                    sock, server_hostname=server_name or self_c.host)

        class _Handler(_rq.HTTPSHandler):
            def https_open(self_h, req):
                return self_h.do_open(
                    lambda host, timeout=None, **kw: _SNIConnection(
                        host, timeout=timeout), req)

        return _rq.build_opener(_Handler())

    @property
    def host(self) -> str:
        return urlparse(self.url_prefix).netloc or self.url_prefix

    def is_interested(self, pod: dict) -> bool:
        """Upstream HTTPExtender.IsInterested: an extender with
        managedResources only sees pods requesting at least one of them
        (containers or initContainers); no managedResources = all pods."""
        if not self.managed_resources:
            return True
        spec = pod.get("spec") or {}
        for field in ("containers", "initContainers"):
            for c in spec.get(field) or []:
                resources = c.get("resources") or {}
                for section in ("requests", "limits"):
                    for name in (resources.get(section) or {}):
                        if name in self.managed_resources:
                            return True
        return False

    def _send(self, verb: str, args: dict) -> dict:
        url = f"{self.url_prefix}/{verb}"
        req = urllib.request.Request(
            url, data=json.dumps(args).encode(), method="POST",
            headers={"Content-Type": "application/json"},
        )
        opener = self._opener.open if self._opener else urllib.request.urlopen
        with opener(req, timeout=self.timeout) as resp:
            return json.loads(resp.read() or b"{}")

    def filter(self, args: dict) -> dict:
        return self._send(self.filter_verb, args)

    def prioritize(self, args: dict) -> dict:
        return self._send(self.prioritize_verb, args)

    def preempt(self, args: dict) -> dict:
        return self._send(self.preempt_verb, args)

    def bind(self, args: dict) -> dict:
        return self._send(self.bind_verb, args)


class ExtenderResultStore:
    """4 annotation blobs, per-verb map[extenderHost] -> result."""

    def __init__(self):
        self._mu = threading.Lock()
        self._results: dict[str, dict[str, dict]] = {}

    def _entry(self, namespace: str, pod_name: str) -> dict:
        k = f"{namespace}/{pod_name}"
        if k not in self._results:
            self._results[k] = {"filter": {}, "prioritize": {}, "preempt": {}, "bind": {}}
        return self._results[k]

    def _add(self, verb: str, args: dict, result, host: str):
        pod = (args.get("Pod") or args.get("pod") or {})
        meta = pod.get("metadata") or {}
        with self._mu:
            e = self._entry(meta.get("namespace") or "default", meta.get("name", ""))
            e[verb][host] = canonicalize_result(verb, result)

    def add_filter_result(self, args, result, host):
        self._add("filter", args, result, host)

    def add_prioritize_result(self, args, result, host):
        self._add("prioritize", args, result, host)

    def add_preempt_result(self, args, result, host):
        self._add("preempt", args, result, host)

    def add_bind_result(self, args, result, host):
        # bind args carry PodNamespace/PodName directly
        ns = args.get("PodNamespace") or args.get("podNamespace") or "default"
        name = args.get("PodName") or args.get("podName") or ""
        with self._mu:
            self._entry(ns, name)["bind"][host] = canonicalize_result("bind", result)

    def get_stored_result(self, pod: dict) -> dict[str, str] | None:
        meta = pod.get("metadata") or {}
        k = f"{meta.get('namespace') or 'default'}/{meta.get('name', '')}"
        with self._mu:
            e = self._results.get(k)
            if e is None:
                return None
            return {
                ann.EXTENDER_FILTER_RESULT: marshal_wire(e["filter"]),
                ann.EXTENDER_PRIORITIZE_RESULT: marshal_wire(e["prioritize"]),
                ann.EXTENDER_PREEMPT_RESULT: marshal_wire(e["preempt"]),
                ann.EXTENDER_BIND_RESULT: marshal_wire(e["bind"]),
            }

    def delete_data(self, pod: dict) -> None:
        meta = pod.get("metadata") or {}
        with self._mu:
            self._results.pop(f"{meta.get('namespace') or 'default'}/{meta.get('name', '')}", None)


class ExtenderService:
    """Recording proxy in front of the configured extenders
    (reference: service.go:45-85)."""

    def __init__(self, extender_configs: list[dict], result_store: ExtenderResultStore | None = None):
        self.extenders = [ExtenderClient(c) for c in extender_configs or []]
        self.result_store = result_store or ExtenderResultStore()

    def handle(self, verb: str, idx: int, args: dict) -> dict:
        if idx < 0 or idx >= len(self.extenders):
            raise IndexError(f"extender {idx} not configured")
        ext = self.extenders[idx]
        if verb == "filter":
            result = ext.filter(args)
            self.result_store.add_filter_result(args, result, ext.host)
        elif verb == "prioritize":
            result = ext.prioritize(args)
            self.result_store.add_prioritize_result(args, result, ext.host)
        elif verb == "preempt":
            result = ext.preempt(args)
            self.result_store.add_preempt_result(args, result, ext.host)
        elif verb == "bind":
            result = ext.bind(args)
            self.result_store.add_bind_result(args, result, ext.host)
        else:
            raise ValueError(f"unknown extender verb {verb}")
        return result


def override_extenders_cfg_to_simulator(cfg: dict, port: int) -> dict:
    """Rewrite extender urlPrefixes to route through the simulator proxy
    (reference: service.go:88-109)."""
    import copy

    cfg = copy.deepcopy(cfg or {})
    for i, ext in enumerate(cfg.get("extenders") or []):
        ext["urlPrefix"] = f"http://localhost:{port}/api/v1/extender"
        for verb_field, verb in (
            ("filterVerb", "filter"), ("prioritizeVerb", "prioritize"),
            ("preemptVerb", "preempt"), ("bindVerb", "bind"),
        ):
            if ext.get(verb_field):
                ext[verb_field] = f"{verb}/{i}"
    return cfg
