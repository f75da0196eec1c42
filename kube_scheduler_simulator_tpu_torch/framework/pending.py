"""Incremental pending-pod index for the scheduling engine.

A copy of kube_scheduler_simulator_tpu/framework/pending.py, host code with its
imports rewired to the port.

The engine's queue used to be rebuilt every wave: list every pod in the
store (10k+ manifests at cluster scale), filter the unbound ones and
re-sort the survivors — O(P log P) work per wave even when a wave binds
a handful of pods.  This index maintains the PrioritySort order
(descending .spec.priority, FIFO by resourceVersion within equal
priority — the engine's documented queue contract) incrementally from
store watch events: a bind/create/delete/update costs O(log P) here, so
a steady-state wave pays O(events) instead of O(P log P).

Gang-aware ordering (docs/gang-scheduling.md): pods carrying the
``scheduling.x-k8s.io/pod-group`` label enqueue CONTIGUOUSLY at their
group's minimum sort key (over every unbound member, parked members
included), so a scheduling wave always sees whole gangs back to back —
the invariant the engine's vectorized gang-quorum pass and the
streaming committer's gang-boundary cuts rely on.  Within a group,
members keep their own PrioritySort order; pods without the label are
ordered exactly as before.  ``gang_sorted`` applies the identical
composite order to a plain listing (the engine's legacy fallback path),
so the two paths cannot drift.

Consistency: the index seeds from ObjectStore.list_and_watch (atomic
list + subscription, so no event is lost in the gap) and drains its
event queue synchronously inside pending() — ObjectStore delivers
events under its write lock, so by the time a wave asks for the queue
every completed store write is visible.  Manifests are the STORED
objects (the informer-cache contract shared with list_shared): callers
must not mutate them.

The engine only routes through the index for stores exposing
list_and_watch (the in-process ObjectStore) and when no custom
QueueSort plugin is enabled (an arbitrary less() defeats incremental
ordering); everything else falls back to the legacy list+sort path.
"""

from __future__ import annotations

import bisect
import queue

from .gang import group_key_of


def _key(pod: dict) -> tuple[str, str]:
    meta = pod.get("metadata") or {}
    return (meta.get("namespace") or "default", meta.get("name", ""))


def _rv_fifo(rv) -> tuple[int, str]:
    """FIFO component of the sort key, tolerant of the non-integer
    resourceVersions cluster/kubeapi.py is documented to synthesize for
    some source clusters: integers keep their numeric order (the
    secondary string is never consulted between distinct integers),
    non-integers sort as 0 with a deterministic lexicographic
    tie-break instead of raising ValueError."""
    s = str(rv) if rv is not None else "0"
    try:
        return (int(s), "")
    except ValueError:
        return (0, s)


def _sort_key(pod: dict) -> tuple[int, int, str]:
    # PrioritySort: priority desc, FIFO (resourceVersion) within — must
    # stay bit-compatible with the engine's legacy sort key
    prio = -int((pod.get("spec") or {}).get("priority") or 0)
    return (prio, *_rv_fifo((pod.get("metadata") or {}).get("resourceVersion")))


def _is_pending(pod: dict) -> bool:
    return not ((pod.get("spec") or {}).get("nodeName"))


_NO_GROUP = ("", "")  # sorts before any (namespace, group) pair


def _entry_key(own_sk, gkey, gmin):
    """Composite queue key: ungrouped pods sort at their own key; gang
    members sort at their group's min key, grouped contiguously by the
    group identity, own order within."""
    if gkey is None:
        return (own_sk, _NO_GROUP, own_sk)
    return (gmin, gkey, own_sk)


def gang_sorted(pods: list[dict], skip=None) -> list[dict]:
    """The legacy-path equivalent of the index's order: PrioritySort
    with gang-contiguous grouping.  Group min keys are computed over
    ALL the given pods (callers pass every unbound pod, so parked gang
    members still anchor their group's position, matching the index);
    `skip` keys are dropped from the result AFTER ordering."""
    gmin: dict[tuple[str, str], tuple] = {}
    keyed = []
    for p in pods:
        sk = _sort_key(p)
        gk = group_key_of(p)
        keyed.append((p, sk, gk))
        if gk is not None and (gk not in gmin or sk < gmin[gk]):
            gmin[gk] = sk
    skip = skip or ()
    out = [
        (_entry_key(sk, gk, gmin.get(gk)), p)
        for p, sk, gk in keyed if _key(p) not in skip
    ]
    out.sort(key=lambda e: (e[0], _key(e[1])))
    return [p for _, p in out]


# an idle engine on a busy store accumulates events between waves; past
# this backlog a fresh list_and_watch seed is cheaper than draining, and
# it reclaims the queue's memory in one shot
_REBUILD_BACKLOG = 8192


class PendingPodIndex:
    """Priority-ordered set of unscheduled pods, updated from watch
    events.  Single-consumer (the engine's wave loop); not thread-safe —
    waves already serialize on the engine."""

    def __init__(self, store):
        self.store = store
        self._seed()

    def _seed(self) -> None:
        items, _rv, self._q = self.store.list_and_watch("pods")
        # pod key -> (entry_key, pod, own_sk, gkey)
        self._by_key: dict[tuple[str, str], tuple] = {}
        # sorted [(entry_key, key)]: unique because key is unique, so
        # bisect can find exact entries for O(log P) removal
        self._order: list[tuple[tuple, tuple[str, str]]] = []
        # gang bookkeeping: group key -> {pod key: own_sk}
        self._gmembers: dict[tuple[str, str], dict[tuple[str, str], tuple]] = {}
        for pod in items:
            self._apply(pod, pending=_is_pending(pod))

    # ------------------------------------------------------------ gangs

    def _gmin(self, gkey) -> tuple:
        return min(self._gmembers[gkey].values())

    def _reposition_group(self, gkey) -> None:
        """Re-key every resident member of gkey after its min sort key
        changed (a member arrived below the old min, or the min member
        left).  Groups are small, so the O(|group| log P) re-insert is
        cheap relative to a wave."""
        gmin = self._gmin(gkey)
        for k in self._gmembers[gkey]:
            ek, pod, own_sk, _ = self._by_key[k]
            new_ek = _entry_key(own_sk, gkey, gmin)
            if new_ek == ek:
                continue
            i = bisect.bisect_left(self._order, (ek, k))
            del self._order[i]
            self._by_key[k] = (new_ek, pod, own_sk, gkey)
            bisect.insort(self._order, (new_ek, k))

    # ------------------------------------------------------------ apply

    def _apply(self, pod: dict, pending: bool) -> None:
        k = _key(pod)
        old = self._by_key.pop(k, None)
        if old is not None:
            ek, _, _, old_gkey = old
            i = bisect.bisect_left(self._order, (ek, k))
            del self._order[i]
            if old_gkey is not None:
                members = self._gmembers[old_gkey]
                was_min = members[k] == min(members.values())
                del members[k]
                if not members:
                    del self._gmembers[old_gkey]
                elif was_min:
                    self._reposition_group(old_gkey)
        if pending:
            own_sk = _sort_key(pod)
            gkey = group_key_of(pod)
            old_min = None
            if gkey is not None:
                members = self._gmembers.setdefault(gkey, {})
                old_min = min(members.values()) if members else None
                members[k] = own_sk
                gmin = own_sk if (old_min is None or own_sk < old_min) \
                    else old_min
            else:
                gmin = None
            ek = _entry_key(own_sk, gkey, gmin)
            self._by_key[k] = (ek, pod, own_sk, gkey)
            bisect.insort(self._order, (ek, k))
            if old_min is not None and own_sk < old_min:
                # the new member lowered the group min: re-key the
                # residents (AFTER this member's own insert — the
                # reposition walks every member incl. this one)
                self._reposition_group(gkey)

    def refresh(self) -> None:
        """Drain buffered store events into the index; a backlog beyond
        _REBUILD_BACKLOG (the engine sat idle through heavy store churn)
        re-seeds from a fresh atomic list instead."""
        if self._q.qsize() > _REBUILD_BACKLOG:
            self.store.unwatch("pods", self._q)
            self._seed()
            return
        while True:
            try:
                _rv, event_type, obj = self._q.get_nowait()
            except queue.Empty:
                return
            self._apply(obj, pending=(event_type != "DELETED")
                        and _is_pending(obj))

    def pending(self) -> list[dict]:
        """Unscheduled pods in queue order (SHARED store manifests)."""
        self.refresh()
        by_key = self._by_key
        return [by_key[k][1] for _, k in self._order]

    def close(self) -> None:
        self.store.unwatch("pods", self._q)
