"""Coscheduling: PodGroup all-or-nothing admission through the plugin
framework boundary.

A copy of kube_scheduler_simulator_tpu/plugins/coscheduling.py.

Semantics follow the upstream scheduler-plugins coscheduling plugin
(sigs.k8s.io/scheduler-plugins pkg/coscheduling): pods opt in with the
``scheduling.x-k8s.io/pod-group`` label naming a PodGroup object
(generic GVR ``scheduling.x-k8s.io/v1alpha1/podgroups``, stored in the
ObjectStore like any extra resource — see tests/test_generic_gvr.py):

  * **PreFilter** rejects a member whose group can never reach quorum —
    fewer than ``minMember`` member pods exist, or ``minResources``
    (when set) exceeds the cluster's free capacity.  The engine runs
    this screen before compiling the wave (the rejection is a property
    of the pod set, not of any node) and records it under
    ``prefilter-result-status`` exactly like an in-tree PreFilter
    rejection.
  * **Permit** answers "wait" while fewer than ``minMember`` members are
    placed (bound, assumed, or waiting), parking the member in
    ``SchedulerEngine.waiting_pods``; the member that completes the
    quorum gets "success" and fires a group-wide ``allow()``.
  * **Unreserve** rejects every waiting sibling — any post-Reserve
    failure (a timeout expiry included) takes the whole gang down,
    upstream coscheduling's Unreserve behavior.

On the engine's batched wave paths this plugin never executes per pod:
the engine detects it (``is_gang_plugin``) and replaces the per-pod
Permit calls with the **vectorized gang-quorum pass**
(framework/gang.py ``quorum_slice`` — kernel B8, one launch per
committed range), keeping both the streaming and the sequential commit
paths gang-atomic with bit-identical annotations.  The per-pod methods
here serve the host-interleaved path and configurations that mix
Coscheduling with other custom lifecycle plugins (the fallback matrix
in docs/gang-scheduling.md).
"""

from __future__ import annotations

from .custom import CustomPlugin
from ..framework.gang import (
    POD_GROUP_API_VERSION,
    POD_GROUP_GVR,
    POD_GROUP_KIND,
    POD_GROUP_LABEL,
    POD_GROUP_RESOURCE,
    GangDirectory,
    ensure_podgroup_resource,
    group_key_of,
)

__all__ = [
    "Coscheduling",
    "POD_GROUP_API_VERSION",
    "POD_GROUP_GVR",
    "POD_GROUP_KIND",
    "POD_GROUP_LABEL",
    "POD_GROUP_RESOURCE",
    "ensure_podgroup_resource",
]

PLUGIN_NAME = "Coscheduling"


class Coscheduling(CustomPlugin):
    """The gang-admission plugin.  Enable it like any out-of-tree
    plugin::

        cosched = Coscheduling()
        cfg = PluginSetConfig(enabled=[..., "Coscheduling"],
                              custom={"Coscheduling": cosched})

    The engine attaches itself on first use (``attach``); standalone use
    (no engine) degrades to per-call store reads with no sibling
    bookkeeping."""

    name = PLUGIN_NAME
    is_gang_plugin = True

    def __init__(self, store=None):
        self.store = store
        self._engine = None

    def attach(self, engine) -> None:
        """Bind the plugin to the engine whose waiting_pods map holds
        the parked siblings (the framework-handle analogue)."""
        self._engine = engine
        if self.store is None:
            self.store = engine.store

    # ------------------------------------------------------------ helpers

    def _directory(self) -> GangDirectory | None:
        if self.store is None:
            return None
        d = GangDirectory(self.store)
        if not d:
            return None
        from ..cluster.store import list_shared

        d.scan_members(list_shared(self.store, "pods"))
        return d

    def _waiting_siblings(self, key) -> list:
        eng = self._engine
        if eng is None:
            return []
        return [
            wp for k, wp in list(eng.waiting_pods.items())
            if group_key_of(wp.pod) == key
        ]

    # ------------------------------------------------------------ permit

    def permit(self, pod: dict, node: dict):
        key = group_key_of(pod)
        if key is None:
            return None
        d = self._directory()
        spec = d.specs.get(key) if d is not None else None
        if spec is None:
            return None  # label without a PodGroup: ordinary pod
        waiting = self._waiting_siblings(key)
        placed = d.bound.get(key, 0) + len(waiting) + 1  # +1: this pod
        if placed >= spec.min_member:
            # quorum complete: group-wide allow for the parked siblings
            for wp in waiting:
                wp.allow(self.name)
            return None
        return ("wait", spec.timeout_str)

    def unreserve(self, pod: dict, node: dict) -> None:
        """Any failure after Reserve (permit deny, timeout expiry,
        prebind failure) rejects the whole gang: every waiting sibling
        is rejected with a deterministic message."""
        key = group_key_of(pod)
        if key is None:
            return
        msg = f'rejected: gang "{key[0]}/{key[1]}" member failed'
        for wp in self._waiting_siblings(key):
            wp.reject(self.name, msg)
