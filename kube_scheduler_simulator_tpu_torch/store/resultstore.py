"""Result store: per-pod scheduling results, serialized to annotations.

A copy of kube_scheduler_simulator_tpu/store/resultstore.py, host code with its
imports rewired to the port.

API parity with the reference result store (reference:
simulator/scheduler/plugin/resultstore/store.go): granular Add* methods
per extension point keyed by namespace/pod, get_stored_result() producing
the 13 annotation JSON blobs (:133-198), finalscore = normalized score x
plugin weight (:488-507, weight map semantics of plugins.go:289-304),
delete_data() (:509-520), and AddCustomResult for plugin-extender
debugging payloads (:617-626).

The tensor engine deposits whole decoded result maps via put_decoded()
(its per-pod output already IS the 13 encoded blobs); the granular
methods serve host-side escape hatches (extenders, plugin extenders) and
API compatibility.  Granular adds and decoded deposits merge: granular
values overwrite the decoded blob for the touched keys.

Lazy mode (store/lazy.py, the default on the batched wave paths): the
engine deposits a `(wave, index)` handle via put_lazy() instead of the
decoded blobs; get_stored_result() materializes the pod's chunk through
the wave's memoized chunk decode transparently — including the chunk's
device->host fetch when the wave left its results device-resident
(framework/replay.py) — and take_deferred() hands the whole entry to
the reflector as a deferred write-back so the wave's critical path
never decodes (or transfers the heavy tensors) at all.  The merge
semantics are unchanged: the lazily materialized 13 keys are the base,
decoded deposits overlay them, granular adds overlay both.
"""

from __future__ import annotations

import json
import threading

from . import annotations as ann

PASSED = ann.PASSED_FILTER_MESSAGE
SUCCESS = ann.SUCCESS_MESSAGE


def _key(namespace: str, pod_name: str) -> str:
    return f"{namespace}/{pod_name}"


_FIELDS = (
    "selected_node", "pre_score", "score", "final_score",
    "pre_filter_status", "pre_filter_result", "filter", "post_filter",
    "permit", "permit_timeout", "reserve", "prebind", "bind",
    "custom", "decoded", "lazy",
)


class _Result:
    __slots__ = _FIELDS

    def __init__(self):
        self.selected_node = ""
        self.pre_score: dict[str, str] = {}
        self.score: dict[str, dict[str, str]] = {}
        self.final_score: dict[str, dict[str, str]] = {}
        self.pre_filter_status: dict[str, str] = {}
        self.pre_filter_result: dict[str, list[str]] = {}
        self.filter: dict[str, dict[str, str]] = {}
        self.post_filter: dict[str, dict[str, str]] = {}
        self.permit: dict[str, str] = {}
        self.permit_timeout: dict[str, str] = {}
        self.reserve: dict[str, str] = {}
        self.prebind: dict[str, str] = {}
        self.bind: dict[str, str] = {}
        self.custom: dict[str, str] = {}
        self.decoded: dict[str, str] = {}
        # (LazyWave, pod index) handle — the wave's tensors stand in for
        # the 13 decoded blobs until a read materializes them
        self.lazy: tuple | None = None


class _Snapshot:
    """Reference snapshot of one _Result taken under the store lock —
    the O(keys) copy get_stored_result pays while holding _mu; the JSON
    decode/merge/encode of the (potentially ~MB) blobs runs on this
    detached view after release (the encode-off-the-store-lock
    rule, enforced by kss-analyze serialize-under-lock)."""

    __slots__ = _FIELDS

    def __init__(self, r: _Result):
        def snap2(d):
            # two-level snapshot: granular adds mutate the inner
            # per-node dicts in place, so sharing them outside the lock
            # would race the marshal in _merge_snapshot
            return {node: dict(plugins) for node, plugins in d.items()}

        self.decoded = dict(r.decoded)
        self.lazy = r.lazy
        self.pre_filter_result = {p: list(v)
                                  for p, v in r.pre_filter_result.items()}
        self.pre_filter_status = dict(r.pre_filter_status)
        self.filter = snap2(r.filter)
        self.post_filter = snap2(r.post_filter)
        self.pre_score = dict(r.pre_score)
        self.score = snap2(r.score)
        self.final_score = snap2(r.final_score)
        self.reserve = dict(r.reserve)
        self.permit = dict(r.permit)
        self.permit_timeout = dict(r.permit_timeout)
        self.prebind = dict(r.prebind)
        self.bind = dict(r.bind)
        self.custom = dict(r.custom)
        self.selected_node = r.selected_node


def _merge_snapshot(snap: _Snapshot) -> dict[str, str]:
    """The 13 annotation blobs from a snapshot: lazy-materialized base
    (one memoized chunk decode on a cold read), decoded deposits over
    it, granular adds over both — runs with NO lock held."""
    out: dict[str, str] = {}
    if snap.lazy is not None:
        wave, idx = snap.lazy
        out.update(wave.get(idx))
    out.update(snap.decoded)

    def put(key, granular, nested=False):
        """Merge granular adds OVER the decoded blob for the key:
        a custom plugin's Reserve result must not erase an
        in-tree plugin's decoded entry under the same key."""
        if not granular:
            if key not in out:
                out[key] = ann.marshal({} if not isinstance(granular, str) else "")
            return
        base = {}
        if key in out:
            try:
                base = json.loads(out[key])
            except ValueError:
                base = {}
            if not isinstance(base, dict):
                base = {}
        if nested:
            for node, plugins in granular.items():
                base.setdefault(node, {}).update(plugins)
        else:
            base.update(granular)
        out[key] = ann.marshal(base)

    put(ann.PRE_FILTER_RESULT, snap.pre_filter_result)
    put(ann.PRE_FILTER_STATUS_RESULT, snap.pre_filter_status)
    put(ann.FILTER_RESULT, snap.filter, nested=True)
    put(ann.POST_FILTER_RESULT, snap.post_filter, nested=True)
    put(ann.PRE_SCORE_RESULT, snap.pre_score)
    put(ann.SCORE_RESULT, snap.score, nested=True)
    put(ann.FINAL_SCORE_RESULT, snap.final_score, nested=True)
    put(ann.RESERVE_RESULT, snap.reserve)
    put(ann.PERMIT_STATUS_RESULT, snap.permit)
    put(ann.PERMIT_TIMEOUT_RESULT, snap.permit_timeout)
    put(ann.PRE_BIND_RESULT, snap.prebind)
    put(ann.BIND_RESULT, snap.bind)
    if snap.selected_node or ann.SELECTED_NODE not in out:
        out[ann.SELECTED_NODE] = snap.selected_node
    out.update(snap.custom)
    return out


class DeferredResult:
    """A consumed result-store entry whose materialization is deferred:
    the reflector queues these (store/lazy.py LazyReflections) instead
    of decoding on the wave's critical path; result_set() runs the same
    merge get_stored_result would have."""

    __slots__ = ("_snap",)

    def __init__(self, snap: _Snapshot):
        self._snap = snap

    def ready(self) -> bool:
        """True once materialization cannot block: the backing wave is
        sealed (or there is no lazy part).  Drains skip unready records
        — they belong to the in-flight wave's timeline, and applying
        them would stall the reader until the replay finishes."""
        lazy = self._snap.lazy
        return lazy is None or getattr(lazy[0], "sealed", True)

    def result_set(self) -> dict[str, str]:
        return _merge_snapshot(self._snap)


class ResultStore:
    def __init__(self, score_plugin_weight: dict[str, int] | None = None):
        self._mu = threading.Lock()
        self._results: dict[str, _Result] = {}
        self.score_plugin_weight = score_plugin_weight or {}

    def _get(self, namespace: str, pod_name: str) -> _Result:
        k = _key(namespace, pod_name)
        if k not in self._results:
            self._results[k] = _Result()
        return self._results[k]

    # ------------------------------------------------------------ adds

    def put_decoded(self, namespace: str, pod_name: str, annotations: dict[str, str]):
        with self._mu:
            r = self._get(namespace, pod_name)
            shadowed = False
            if ann.SELECTED_NODE in annotations:
                # a full-cycle deposit (every cycle's 13 keys include
                # selected-node, "" when unschedulable) fully shadows a
                # leftover lazy handle — drop it so it stops pinning the
                # old wave's replay buffers and costing a dead chunk
                # decode on read; partial overlays (the extender-bind
                # record) keep the base
                shadowed = r.lazy is not None
                r.lazy = None
            r.decoded.update(annotations)
        if shadowed:
            # an UNREAD wave's results just vanished behind a newer
            # cycle — rare (a pod re-scheduled before anyone read it),
            # and exactly the evidence loss a post-mortem should show
            from ..utils.blackbox import BLACKBOX

            BLACKBOX.record("result.lazy_shadowed",
                            pod=_key(namespace, pod_name), by="decoded")

    def has_result(self, pod: dict) -> bool:
        """True when an entry exists for the pod — the informer's cheap
        existence check, guaranteed never to materialize a lazy handle
        (get_stored_result would decode the pod's chunk)."""
        meta = pod.get("metadata") or {}
        k = _key(meta.get("namespace") or "default", meta.get("name", ""))
        with self._mu:
            return k in self._results

    def put_lazy(self, namespace: str, pod_name: str, wave, index: int):
        """Deposit a lazy handle: `wave.get(index)` yields the pod's 13
        decoded blobs on first read (store/lazy.py LazyWave).  Replaces
        any previous cycle's deposit, like a full put_decoded would;
        later put_decoded / granular adds overlay it."""
        with self._mu:
            r = self._get(namespace, pod_name)
            shadowed = r.lazy is not None
            r.lazy = (wave, index)
            r.decoded = {}
        if shadowed:
            # only the rare cross-wave overwrite records (never the
            # per-pod hot path: fresh entries have no handle to shadow)
            from ..utils.blackbox import BLACKBOX

            BLACKBOX.record("result.lazy_shadowed",
                            pod=_key(namespace, pod_name), by="lazy")

    def add_filter_result(self, namespace, pod_name, node_name, plugin_name, reason):
        with self._mu:
            r = self._get(namespace, pod_name)
            r.filter.setdefault(node_name, {})[plugin_name] = reason

    def add_post_filter_result(self, namespace, pod_name, nominated_node_name,
                               plugin_name, node_names):
        with self._mu:
            r = self._get(namespace, pod_name)
            for node_name in node_names:
                r.post_filter.setdefault(node_name, {})
                if node_name == nominated_node_name:
                    r.post_filter[node_name][plugin_name] = ann.POST_FILTER_NOMINATED_MESSAGE

    def add_score_result(self, namespace, pod_name, node_name, plugin_name, score: int):
        with self._mu:
            r = self._get(namespace, pod_name)
            r.score.setdefault(node_name, {})[plugin_name] = str(int(score))
            self._add_normalized_locked(r, node_name, plugin_name, score)

    def add_normalized_score_result(self, namespace, pod_name, node_name,
                                    plugin_name, normalized_score: int):
        with self._mu:
            r = self._get(namespace, pod_name)
            self._add_normalized_locked(r, node_name, plugin_name, normalized_score)

    def _add_normalized_locked(self, r: _Result, node_name, plugin_name, score: int):
        weight = self.score_plugin_weight.get(plugin_name, 0)
        r.final_score.setdefault(node_name, {})[plugin_name] = str(int(score) * int(weight))

    def add_pre_filter_result(self, namespace, pod_name, plugin_name, reason,
                              pre_filter_result=None):
        with self._mu:
            r = self._get(namespace, pod_name)
            r.pre_filter_status[plugin_name] = reason
            if pre_filter_result is not None:
                r.pre_filter_result[plugin_name] = list(pre_filter_result)

    def add_pre_score_result(self, namespace, pod_name, plugin_name, reason):
        with self._mu:
            self._get(namespace, pod_name).pre_score[plugin_name] = reason

    def add_permit_result(self, namespace, pod_name, plugin_name, status, timeout: str):
        with self._mu:
            r = self._get(namespace, pod_name)
            r.permit[plugin_name] = status
            r.permit_timeout[plugin_name] = timeout

    def add_selected_node(self, namespace, pod_name, node_name):
        with self._mu:
            self._get(namespace, pod_name).selected_node = node_name

    def add_reserve_result(self, namespace, pod_name, plugin_name, status):
        with self._mu:
            self._get(namespace, pod_name).reserve[plugin_name] = status

    def add_bind_result(self, namespace, pod_name, plugin_name, status):
        with self._mu:
            self._get(namespace, pod_name).bind[plugin_name] = status

    def add_pre_bind_result(self, namespace, pod_name, plugin_name, status):
        with self._mu:
            self._get(namespace, pod_name).prebind[plugin_name] = status

    def add_custom_result(self, namespace, pod_name, annotation_key, result):
        with self._mu:
            self._get(namespace, pod_name).custom[annotation_key] = result

    # ------------------------------------------------------------ read/delete

    def get_stored_result(self, pod: dict) -> dict[str, str] | None:
        meta = pod.get("metadata") or {}
        k = _key(meta.get("namespace") or "default", meta.get("name", ""))
        with self._mu:
            r = self._results.get(k)
            if r is None:
                return None
            snap = _Snapshot(r)
        # merge (and any lazy chunk decode) runs after release so
        # concurrent granular adds and the engine's deposits never
        # queue behind serialization
        return _merge_snapshot(snap)

    def take_deferred(self, namespace: str, pod_name: str) -> DeferredResult | None:
        """Consume a LAZY entry as a deferred write-back: the snapshot
        is taken and the entry removed (the delete-after-reflect
        contract) without materializing anything — the reflector queues
        the DeferredResult and a later read pays the decode.  Entries
        without a lazy handle return None; the caller reflects them
        eagerly as before."""
        k = _key(namespace or "default", pod_name)
        with self._mu:
            r = self._results.get(k)
            if r is None or r.lazy is None:
                return None
            snap = _Snapshot(r)
            del self._results[k]
        return DeferredResult(snap)

    def delete_data(self, pod: dict) -> None:
        meta = pod.get("metadata") or {}
        with self._mu:
            self._results.pop(_key(meta.get("namespace") or "default", meta.get("name", "")), None)
