"""Store reflector: write scheduling results back onto Pod annotations.

A copy of kube_scheduler_simulator_tpu/store/reflector.py, host code with its
imports rewired to the port.

Capability parity with the reference reflector (reference:
simulator/scheduler/storereflector/storereflector.go):

  * merges the stored result maps of all registered result stores into the
    pod's annotations (:113-129);
  * appends the merged result set to the `result-history` annotation,
    dropping entries from the OLDEST side until the encoded array fits the
    256KiB apiserver annotation limit (:163-190);
  * updates the pod with re-fetch + conflict retry under exponential
    backoff (100ms x3, 6 steps — :136-151, util/retry.go:10-27), deletes
    the store entry only after a successful write (:156-159).

The reference triggers this from a Pod-informer Update handler; here the
scheduling engine calls reflect() after binding (same effect, no informer
round-trip needed in-process), and an optional watch-driven mode mirrors
the informer wiring for externally-bound pods.
"""

from __future__ import annotations

import json

from . import annotations as ann
from ..cluster.store import Conflict, NotFound, ObjectStore
from ..utils.faults import fault_point
from ..utils.retry import retry_with_exponential_backoff
from ..utils.tracing import TRACER

RESULT_HISTORY_LIMIT = ann.TOTAL_ANNOTATION_SIZE_LIMIT


def _encode_record(result_set: dict[str, str]) -> str:
    """marshal(result_set) — native escape pass when available (the
    values are whole annotation blobs; escaping them dominates the
    reflector's cost at cluster scale)."""
    from .native_decode import encode_string_map

    rec = encode_string_map(result_set)
    return rec if rec is not None else ann.marshal(result_set)


def _objects_only(raw: str) -> bool:
    """True when every element boundary in a compact JSON array is
    object-to-object: each "}," is followed by "{".  One scan, no parse;
    conservative — a "}," inside a string value false-positives and the
    caller just takes the slow parsing path instead."""
    i = raw.find("},")
    while i != -1:
        if i + 2 >= len(raw) or raw[i + 2] != "{":
            return False
        i = raw.find("},", i + 2)
    return True


def encode_history_record(result_set: dict[str, str]) -> str:
    """The encoded history record for result_set — precomputable OUTSIDE
    any store lock (it depends only on the result set, not the pod), so
    batched reflectors can pay the escape pass of ~250KB of blobs per
    pod off-lock.  Raises ValueError when the record alone cannot fit:
    JSON encoding never shrinks a string, so sum(len(k)+len(v))+syntax
    is a lower bound on the encoded record — when even that exceeds the
    limit (every pod at >=1k-node scale), raise before building and
    escaping hundreds of KB per pod."""
    lower_bound = 1 + sum(len(k) + len(v) + 6 for k, v in result_set.items())
    if lower_bound > RESULT_HISTORY_LIMIT:
        raise ValueError(
            "result record alone exceeds the annotation size limit"
        )
    return _encode_record(result_set)


def update_result_history(pod: dict, result_set: dict[str, str],
                          rec: str | None = None) -> None:
    """Append result_set to the result-history annotation, trimming oldest
    entries until the encoded JSON fits the 256KiB limit.

    Fast path: the existing history is this function's own output (a JSON
    array), so the new record is spliced in textually — no re-parse and
    no re-escape of the accumulated records.  The trim branch (only once
    the limit is hit) falls back to parse + drop-oldest.

    rec: the precomputed encode_history_record(result_set), when the
    caller already paid for it (the batched reflector encodes off-lock)."""
    annotations = pod.setdefault("metadata", {}).setdefault("annotations", {})
    raw = annotations.get(ann.RESULT_HISTORY, "[]")
    if rec is None:
        rec = encode_history_record(result_set)
    # textual-splice fast path: only for values shaped like this
    # function's own output (empty array, or array of objects) — anything
    # else falls through to the parsing path so corrupt histories raise
    # instead of being spliced into deeper corruption.  _objects_only
    # proves every element boundary is object-to-object without a full
    # parse (conservative: a legit value containing "}," that isn't a
    # boundary just falls to the slow path).  Residual trust: an object
    # element whose VALUES aren't strings (e.g. '[{"k":1,"m":"s"}]') can
    # keep the shell and splice where the reference's map[string]string
    # unmarshal would error — full validation would re-parse ~256 KiB
    # per pod, the cost this fast path exists to avoid.
    if raw == "[]" or (raw.startswith('[{"') and raw.endswith('"}]')
                       and _objects_only(raw)):
        encoded = ("[" + rec + "]" if raw == "[]"
                   else raw[:-1] + "," + rec + "]")
        if len(encoded) <= RESULT_HISTORY_LIMIT:
            annotations[ann.RESULT_HISTORY] = encoded
            return
    try:
        results = json.loads(raw)
    except json.JSONDecodeError as e:
        # the reference surfaces a broken existing history as an error
        # (updateResultHistory json.Unmarshal, storereflector.go:169-171)
        # rather than silently resetting it; reflect() treats this like
        # the oversized-record case (log-and-continue without history)
        raise ValueError(f"broken result-history annotation: {e}") from e
    if not isinstance(results, list):
        raise ValueError(
            "broken result-history annotation: not a JSON array")
    if any(not isinstance(r, dict) for r in results):
        # the reference unmarshals into []map[string]string and errors on
        # non-object elements ('[1,2]', '["a"]')
        raise ValueError(
            "broken result-history annotation: non-object element")
    if any(not isinstance(v, str) for r in results for v in r.values()):
        # ... and on non-string values ('[{"k":1}]')
        raise ValueError(
            "broken result-history annotation: non-string value")
    results.append(result_set)
    while results:
        encoded = ann.marshal(results)
        if len(encoded) <= RESULT_HISTORY_LIMIT:
            annotations[ann.RESULT_HISTORY] = encoded
            return
        results = results[1:]
    raise ValueError(
        "result history still exceeds annotation limit even after removing several histories"
    )


class _PendingRecord:
    """One deferred wave write-back for a pod: the uid the wave
    committed against (the reflect() recreation guard) and the ordered
    result parts (DeferredResult handles and/or eager dicts, in result
    -store registration order)."""

    __slots__ = ("uid", "parts")

    def __init__(self, uid: str | None, parts: list):
        self.uid = uid
        self.parts = parts

    def ready(self) -> bool:
        """True when materializing cannot block (every lazy part's wave
        is sealed).  A record queued by a still-streaming wave is NOT
        ready: a reader skips it — the bind event it trails is already
        annotation-less in eager mode too at that point — instead of
        stalling on the replay; it lands on the first read after the
        wave seals."""
        return all(p.ready() for p in self.parts if hasattr(p, "ready"))

    def result_set(self) -> dict[str, str]:
        out: dict[str, str] = {}
        for part in self.parts:
            out.update(part.result_set() if hasattr(part, "result_set")
                       else part)
        return out


class LazyReflections:
    """Deferred reflector write-backs, drained by ObjectStore read hooks.

    reflect_batch() queues a _PendingRecord per pod instead of
    materializing blobs on the wave's critical path; the first read of
    the pod (GET / copying list / export / the HTTP watch stream)
    drains its queue — records apply IN ORDER, so a pod scheduled by
    several waves before anyone reads it gets exactly the eager path's
    annotation bytes and result-history sequence.  Exactly-once per
    pod under concurrent readers (in-flight event handshake); the
    decode — including the chunk's device->host materialization when
    the wave's results are device-resident (framework/replay.py, the
    `d2h_fetch` span) — and the store write run with NO registry lock
    held."""

    def __init__(self, store, stop=None):
        import threading

        self.store = store
        # owner's teardown event: interrupts the conflict-retry backoff
        # of a drain racing shutdown/eviction (utils/retry.py stop)
        self.stop = stop
        self._mu = threading.Lock()
        self._pending: dict[tuple[str, str], list[_PendingRecord]] = {}
        self._inflight: dict[tuple[str, str], object] = {}

    def add(self, namespace: str, name: str, uid: str | None,
            parts: list) -> None:
        key = (namespace or "default", name)
        with self._mu:
            self._pending.setdefault(key, []).append(
                _PendingRecord(uid, parts))

    def has(self, namespace: str, name: str) -> bool:
        with self._mu:
            return (namespace or "default", name) in self._pending

    def pending_count(self) -> int:
        with self._mu:
            return sum(len(v) for v in self._pending.values())

    # ------------------------------------------- ObjectStore hook surface

    def flush(self, resource: str | None, name: str | None = None,
              namespace: str | None = None) -> None:
        if resource not in (None, "pods"):
            return
        if name is not None:
            self._drain((namespace or "default", name))
            return
        self._drain_all()

    def discard(self, resource: str | None, name: str | None = None,
                namespace: str | None = None) -> None:
        if resource not in (None, "pods"):
            return
        with self._mu:
            if name is None:
                self._pending.clear()
            else:
                self._pending.pop((namespace or "default", name), None)

    # ---------------------------------------------------------- drain

    @staticmethod
    def _take_ready_locked(recs: list[_PendingRecord]) -> list[_PendingRecord]:
        """The longest READY prefix (order must hold: a later record may
        never land before an earlier one, so an unready record blocks
        everything after it — but never the reader)."""
        n = 0
        for rec in recs:
            if not rec.ready():
                break
            n += 1
        return recs[:n]

    def _drain(self, key: tuple[str, str]) -> None:
        import threading

        with self._mu:
            ev = self._inflight.get(key)
            if ev is not None:
                owner = False
            else:
                recs = self._pending.get(key)
                if not recs:
                    return
                ready = self._take_ready_locked(recs)
                if not ready:
                    return  # in-flight wave's timeline: skip, don't stall
                if len(ready) == len(recs):
                    del self._pending[key]
                else:
                    self._pending[key] = recs[len(ready):]
                recs = ready
                ev = self._inflight[key] = threading.Event()
                owner = True
        if not owner:
            # another reader is applying this pod's records: wait so our
            # caller's subsequent read observes the written annotations
            ev.wait()
            return
        try:
            self._apply(key, recs)
        except BaseException:
            with self._mu:
                # put the unapplied records back at the FRONT so order
                # is preserved for the next reader
                self._pending.setdefault(key, [])[:0] = recs
                del self._inflight[key]
            ev.set()
            raise
        with self._mu:
            del self._inflight[key]
        ev.set()

    def _drain_all(self) -> None:
        """Whole-resource flush (copying list / dump / export): ONE
        snapshot of the pending keys — records a concurrent wave adds
        mid-flush belong to that wave's timeline, not this read's — and
        one batched write through the store's apply_batch surface (a
        10k-pod drain costs one lock hold and one contiguous rv range,
        like the eager reflect_batch it replaces, instead of 10k
        conflict-retried updates)."""
        import threading

        if getattr(self.store, "apply_batch", None) is None:
            with self._mu:
                keys = list(self._pending)
            for key in keys:
                self._drain(key)
            return
        taken: list[tuple[tuple[str, str], list[_PendingRecord]]] = []
        events: dict[tuple[str, str], threading.Event] = {}
        busy: list[threading.Event] = []
        with self._mu:
            for key in list(self._pending):
                ev = self._inflight.get(key)
                if ev is not None:
                    busy.append(ev)
                    continue
                recs = self._pending[key]
                ready = self._take_ready_locked(recs)
                if not ready:
                    continue
                if len(ready) == len(recs):
                    del self._pending[key]
                else:
                    self._pending[key] = recs[len(ready):]
                ev = threading.Event()
                self._inflight[key] = ev
                events[key] = ev
                taken.append((key, ready))
        try:
            if taken:
                self._apply_batch(taken)
        except BaseException:
            with self._mu:
                for key, recs in taken:
                    self._pending.setdefault(key, [])[:0] = recs
                    del self._inflight[key]
            for ev in events.values():
                ev.set()
            raise
        with self._mu:
            for key in events:
                del self._inflight[key]
        for ev in events.values():
            ev.set()
        for ev in busy:
            # per-pod drains racing this flush: wait so the caller's
            # read observes their writes too
            ev.wait()

    def _apply_batch(self, taken) -> None:
        """Materialize + write many pods' deferred records through ONE
        apply_batch call.  The decode and the history-record encode (the
        escape pass over ~250KB of blobs per pod) run HERE, before the
        store lock — the mutate callbacks only merge and splice (the
        off-lock rule, same as reflect_batch's prepare phase)."""
        prepared = []
        for key, recs in taken:
            sets = []
            for rec in recs:
                result_set = rec.result_set()
                hist_rec = None
                skip_history = False
                try:
                    hist_rec = encode_history_record(result_set)
                except ValueError as e:
                    skip_history = True
                    import sys

                    print(f"reflector: result-history not updated: {e}",
                          file=sys.stderr)
                sets.append((rec.uid, result_set, hist_rec, skip_history))
            prepared.append((key, sets))

        def mutation(key, sets):
            def mutate(pod: dict):
                meta = pod.get("metadata") or {}
                cur_uid = meta.get("uid")
                live = [s for s in sets
                        if not (s[0] and cur_uid not in (None, s[0]))]
                if not live:
                    return False
                annotations = dict(meta.get("annotations") or {})
                meta["annotations"] = annotations
                for _uid, result_set, hist_rec, skip_history in live:
                    annotations.update(result_set)
                    if skip_history:
                        continue
                    try:
                        update_result_history(pod, result_set, rec=hist_rec)
                    except ValueError as e:
                        import sys

                        print(f"reflector: result-history not updated: {e}",
                              file=sys.stderr)
                return True

            return mutate

        self.store.apply_batch("pods", [
            (key[1], key[0], mutation(key, sets))
            for key, sets in prepared
        ])

    def _apply(self, key: tuple[str, str], recs: list[_PendingRecord]) -> None:
        """reflect()'s per-pod semantics for a queue of deferred
        records: uid guard per record, annotation merge + history
        append in record order, ONE conflict-retried update."""
        namespace, name = key

        def attempt() -> tuple[bool, Exception | None]:
            try:
                fault_point("reflector.write_back")
            except Conflict:
                return False, None  # injected conflict: retry under backoff
            try:
                cur = self.store.get("pods", name, namespace,
                                     copy_object=False)
            except NotFound:
                return True, None
            cur_uid = (cur.get("metadata") or {}).get("uid")
            live = [r for r in recs
                    if not (r.uid and cur_uid not in (None, r.uid))]
            if not live:
                return True, None
            pod = dict(cur)
            meta = dict(cur.get("metadata") or {})
            annotations = dict(meta.get("annotations") or {})
            meta["annotations"] = annotations
            pod["metadata"] = meta
            for rec in live:
                result_set = rec.result_set()
                annotations.update(result_set)
                try:
                    update_result_history(pod, result_set)
                except ValueError as e:
                    import sys

                    print(f"reflector: result-history not updated: {e}",
                          file=sys.stderr)
            try:
                self.store.update("pods", pod, owned=True)
            except NotFound:
                return True, None
            except Conflict:
                return False, None  # re-fetch and retry
            return True, None

        retry_with_exponential_backoff(attempt, stop=self.stop)


def reflect_each(reflect_fn, items) -> None:
    """reflect_fn(ns, name, uid=uid) for EVERY (ns, name, uid) item even
    if an earlier one fails; the first error surfaces after the sweep —
    the per-pod fallback contract shared by reflect_batch and the
    engine's _ReflectBatcher (one place, so the wave-parity semantics
    cannot drift between them)."""
    first_err = None
    for ns, name, uid in items:
        try:
            reflect_fn(ns, name, uid=uid)
        except Exception as e:  # noqa: BLE001
            first_err = first_err or e
    if first_err is not None:
        raise first_err


class StoreReflector:
    def __init__(self, store: ObjectStore, sleep=None):
        import threading

        self.store = store
        self.result_stores: dict[str, object] = {}
        self._sleep = sleep  # injectable for tests
        # teardown interrupt: the write path's exponential backoff
        # sleeps up to ~36s; setting this (DIContainer.shutdown /
        # session eviction) wakes any in-flight backoff immediately
        # (utils/retry.py RetryAborted) instead of riding it out
        self.stop_event = threading.Event()
        self._watch_thread = None
        self._watch_queue = None
        self._lazy: LazyReflections | None = None

    def defer_supported(self) -> bool:
        """True when this reflector can defer wave write-backs: the
        store offers both the batched-commit surface and the read hooks
        that make deferred annotations transparent to readers."""
        return (getattr(self.store, "apply_batch", None) is not None
                and getattr(self.store, "add_read_hook", None) is not None)

    def lazy_pending(self) -> LazyReflections:
        """The deferred write-back registry, installed as a store read
        hook on first use (store/lazy.py module docs)."""
        if self._lazy is None:
            reg = LazyReflections(self.store, stop=self.stop_event)
            self.store.add_read_hook(reg)
            self._lazy = reg
        return self._lazy

    def add_result_store(self, result_store, key: str) -> None:
        """reference: storereflector.go AddResultStore."""
        self.result_stores[key] = result_store

    def register_result_saving_to_informer(self, stop_event) -> None:
        """The reference's informer wiring (ResisterResultSavingToInformer
        [sic], storereflector.go:56-81): a pod-update watcher that
        reflects stored results whenever a pod changes — the path an
        EXTERNAL scheduler's bind (through the HTTP API) takes, where no
        in-process engine calls reflect() after binding.  Do NOT enable it
        alongside an engine that reflects inline (the default simulator
        wiring): both paths appending the same record would duplicate it
        in result-history.  Idempotent; the watcher thread stops (and
        unsubscribes its queue) with stop_event."""
        import threading

        if self._watch_thread is not None:
            return
        _, rv = self.store.list("pods")
        q = self.store.watch("pods", since_rv=rv)
        self._watch_queue = q

        def pump():
            try:
                while not stop_event.is_set():
                    ev = q.get()
                    if ev is None:
                        return
                    _, event_type, obj = ev
                    if event_type == "DELETED":
                        # purge any unreflected results so a long-lived
                        # informer process doesn't accumulate entries for
                        # pods whose deletion-time updates were filtered
                        # (the reference leaks here; completing the
                        # cleanup matches our UID-guard precedent)
                        for rs in self.result_stores.values():
                            rs.delete_data(obj)
                        continue
                    if event_type != "MODIFIED":
                        continue
                    meta = obj.get("metadata") or {}
                    if meta.get("deletionTimestamp"):
                        # the reference's FilterFunc excludes pods being
                        # deleted (storereflector.go:61-68): no result
                        # write races a graceful deletion
                        continue
                    ns = meta.get("namespace") or "default"
                    name = meta.get("name", "")
                    # only fire when some store holds a result for the pod
                    # (the reference's handler re-GETs and no-ops
                    # otherwise; checking first avoids a write cycle per
                    # unrelated update).  has_result is the
                    # non-materializing probe — get_stored_result on a
                    # lazy entry would decode the pod's chunk per event
                    if any(rs.has_result(obj)
                           if hasattr(rs, "has_result")
                           else rs.get_stored_result(obj)
                           for rs in self.result_stores.values()):
                        try:
                            self.reflect(ns, name, uid=meta.get("uid"))
                        # kss-analyze: allow(swallowed-exception)
                        except Exception:
                            pass  # klog-and-continue, as the reference does
            finally:
                # stop_event exits must also unsubscribe, or the abandoned
                # unbounded queue keeps accumulating every pod event
                self.store.unwatch("pods", q)

        t = threading.Thread(target=pump, daemon=True,
                             name="reflector-informer")
        t.start()
        self._watch_thread = t

    def stop_informer(self) -> None:
        if self._watch_queue is not None:
            self.store.unwatch("pods", self._watch_queue)
            self._watch_queue.put(None)
            self._watch_queue = None
        if self._watch_thread is not None:
            self._watch_thread.join(timeout=2)
            self._watch_thread = None

    def reflect(self, namespace: str, name: str, uid: str | None = None) -> None:
        """Merge all result stores' data for the pod into its annotations
        (with history), conflict-retrying; delete store data on success.

        uid (when the caller knows it) guards against the pod having been
        deleted and recreated under the same name since scheduling — the
        reference aborts on UID mismatch (storereflector.go:107-109) so a
        fresh pod never inherits a stale result record."""
        if self._lazy is not None:
            # deferred records from earlier waves must land BEFORE this
            # cycle's result, or the pod's annotations and history would
            # reorder relative to the eager path
            self._lazy.flush("pods", name, namespace)

        last_pod: dict = {}

        def attempt() -> tuple[bool, Exception | None]:
            try:
                fault_point("reflector.write_back")
            except Conflict:
                return False, None  # injected conflict: retry under backoff
            try:
                cur = self.store.get("pods", name, namespace,
                                     copy_object=False)
            except NotFound:
                return True, None
            if uid and (cur.get("metadata") or {}).get("uid") not in (None, uid):
                # recreated pod: purge the stale record so the new pod's
                # own cycle starts clean (the reference merely errors out
                # and leaks the store entry, storereflector.go:107-109 —
                # deleting completes the guard's intent)
                stale = {"metadata": {"namespace": namespace, "name": name}}
                for rs in self.result_stores.values():
                    rs.delete_data(stale)
                return True, None
            result_set: dict[str, str] = {}
            for rs in self.result_stores.values():
                m = rs.get_stored_result(cur) or {}
                result_set.update(m)
            if not result_set:
                return True, None
            # copy-on-write along the touched path (metadata.annotations):
            # everything else stays shared with the stored object, which
            # is replaced — never mutated — by update()
            pod = dict(cur)
            meta = dict(cur.get("metadata") or {})
            annotations = dict(meta.get("annotations") or {})
            meta["annotations"] = annotations
            pod["metadata"] = meta
            annotations.update(result_set)
            try:
                update_result_history(pod, result_set)
            except ValueError as e:
                # log-and-continue, as the reference does
                # (storereflector.go:131-134 klog.Errorf then Update)
                import sys

                print(f"reflector: result-history not updated: {e}",
                      file=sys.stderr)
            try:
                # get() returned a private copy; transfer ownership (the
                # pod dict is only read below, which the contract allows)
                self.store.update("pods", pod, owned=True)
            except NotFound:
                return True, None
            except Conflict:
                return False, None  # re-fetch and retry
            last_pod.clear()
            last_pod.update(pod)
            return True, None

        kwargs = {"sleep": self._sleep} if self._sleep else {}
        retry_with_exponential_backoff(attempt, stop=self.stop_event,
                                       **kwargs)
        if last_pod:
            for rs in self.result_stores.values():
                rs.delete_data(last_pod)

    def reflect_batch(self, items) -> None:
        """reflect() for many pods through one ObjectStore.apply_batch
        call (conflict-free by construction, so no retry loop), then the
        result-store entries of the pods actually written are deleted —
        the engine's batched wave-commit surface.  items: iterable of
        (namespace, name, uid).  Stores without apply_batch (the remote
        HTTP client) fall back to per-pod reflect().

        Two phases so the expensive work stays OFF the store lock: the
        result-set merge and the history-record encode (the escape pass
        over ~250KB of blobs per pod — the dominant reflect cost at
        cluster scale) depend only on the result stores, so they run
        before apply_batch; the mutate callbacks then only splice and
        stamp under the lock, and a concurrent wave's binds never queue
        behind a batch of record encodes."""
        if getattr(self.store, "apply_batch", None) is None:
            reflect_each(self.reflect, items)
            return
        try:
            fault_point("reflector.write_back")
        except Exception:
            # a failed batch write-back degrades to the per-pod
            # conflict-retried path — same bytes, same record order,
            # just without the single-lock-hold batching
            TRACER.inc("wave_faults_total", seam="reflector.write_back",
                       action="batch_fallback")
            reflect_each(self.reflect, items)
            return
        defer_ok = getattr(self.store, "add_read_hook", None) is not None
        prepared: list[tuple] = []
        for ns, name, uid in items:
            key_pod = {"metadata": {"namespace": ns, "name": name}}
            # lazy entries defer whole: take the consumed snapshot into
            # the pending registry instead of decoding here — the wave's
            # critical path carries only tensor handles (store/lazy.py)
            parts: list = []
            any_lazy = False
            for rs in self.result_stores.values():
                d = None
                if defer_ok:
                    taker = getattr(rs, "take_deferred", None)
                    if taker is not None:
                        d = taker(ns, name)
                if d is not None:
                    parts.append(d)
                    any_lazy = True
                else:
                    m = rs.get_stored_result(key_pod) or {}
                    if m:
                        parts.append(m)
            if not parts:
                continue
            if any_lazy:
                self.lazy_pending().add(ns, name, uid, parts)
                continue
            if self._lazy is not None and self._lazy.has(ns, name):
                # eager result over a pod with older deferred records:
                # land those first so history order matches eager mode
                self._lazy.flush("pods", name, ns)
            result_set: dict[str, str] = {}
            for part in parts:
                result_set.update(part)
            if not result_set:
                continue
            rec = None
            skip_history = False
            try:
                rec = encode_history_record(result_set)
            except ValueError as e:
                # log-and-continue (reference storereflector.go:131-134)
                # HERE, off-lock — at >=1k-node scale every record
                # overflows and a per-pod stderr write under the store
                # lock would serialize the whole batch against binds
                skip_history = True
                import sys

                print(f"reflector: result-history not updated: {e}",
                      file=sys.stderr)
            prepared.append((ns, name, uid, result_set, rec, skip_history))
        if not prepared:
            return
        written: list[dict] = []
        self.store.apply_batch("pods", [
            (name, ns, self._reflect_mutation(ns, name, uid, result_set,
                                              rec, skip_history, written))
            for ns, name, uid, result_set, rec, skip_history in prepared
        ])
        for pod in written:
            for rs in self.result_stores.values():
                rs.delete_data(pod)

    def _reflect_mutation(self, namespace: str, name: str, uid: str | None,
                          result_set: dict[str, str], rec: str | None,
                          skip_history: bool, written: list):
        """apply_batch mutate callback with reflect()'s per-pod logic:
        UID guard (purge-and-skip on a recreated pod), annotation merge,
        history append (log-and-continue on ValueError) using the
        pre-encoded record; skip_history marks an oversize record the
        prepare phase already logged."""

        def mutate(pod: dict):
            meta = pod.get("metadata") or {}
            if uid and meta.get("uid") not in (None, uid):
                stale = {"metadata": {"namespace": namespace, "name": name}}
                for rs in self.result_stores.values():
                    rs.delete_data(stale)
                return False
            # metadata is already copy-on-write fresh (the apply_batch
            # contract); the annotations dict below it is still shared
            annotations = dict(meta.get("annotations") or {})
            meta["annotations"] = annotations
            annotations.update(result_set)
            if not skip_history:
                try:
                    update_result_history(pod, result_set, rec=rec)
                except ValueError as e:
                    import sys

                    print(f"reflector: result-history not updated: {e}",
                          file=sys.stderr)
            written.append(pod)
            return True

        return mutate
