"""Gang scheduling primitives: the PodGroup directory and the
vectorized all-or-nothing quorum pass.

Port of kube_scheduler_simulator_tpu/framework/gang.py: the host code
is a copy; `quorum_slice` (:195) is kernel B8 with its plain version
beside it.

A *gang* is a PodGroup (generic GVR ``scheduling.x-k8s.io/v1alpha1``,
resource ``podgroups`` — the upstream scheduler-plugins coscheduling
CRD) plus the pods carrying its name in the
``scheduling.x-k8s.io/pod-group`` label.  The group is useful only when
``minMember`` of its pods place simultaneously: the engine admits a
group all-or-nothing — either every feasible member binds in the same
wave epoch, or every feasible member is parked in
``SchedulerEngine.waiting_pods`` (the Permit "wait" analogue) until
quorum completes in a later wave or ``scheduleTimeoutSeconds`` expires
and the whole gang is rejected.

This module holds the pieces shared by the engine, the Coscheduling
plugin (plugins/coscheduling.py), the pending-queue ordering
(framework/pending.py) and the preemption quorum guard
(framework/preemption.py):

  * ``GangDirectory`` — a wave-start snapshot of the PodGroup specs and
    per-group member counts read from the ObjectStore;
  * ``quorum_slice`` — the vectorized quorum pass: ONE segment
    reduction over a pod→group id vector (kernel B8, csrc/gang.cu, on
    the card; ``quorum_slice_plain`` on the CPU) computes per-group
    placed-member counts and the allow/park decision for every group in
    the range (no per-pod Python loop — the acceptance bar for the
    gang subsystem, docs/gang-scheduling.md);
  * ``preemption_protected`` — bound gang members preemption must never
    victimize (evicting them would drop a running group below
    ``minMember``).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

# upstream scheduler-plugins coscheduling surface
POD_GROUP_LABEL = "scheduling.x-k8s.io/pod-group"
POD_GROUP_RESOURCE = "podgroups"
POD_GROUP_KIND = "PodGroup"
POD_GROUP_API_VERSION = "scheduling.x-k8s.io/v1alpha1"

POD_GROUP_GVR = {
    "resource": POD_GROUP_RESOURCE,
    "kind": POD_GROUP_KIND,
    "namespaced": True,
    "apiVersion": POD_GROUP_API_VERSION,
}

# default Permit wait when a PodGroup sets no scheduleTimeoutSeconds
# (docs/environment-variables.md)
_TIMEOUT_ENV = "KSS_TPU_GANG_TIMEOUT_SECONDS"
DEFAULT_TIMEOUT_SECONDS = 60.0


def default_timeout_seconds() -> float:
    try:
        return float(os.environ.get(_TIMEOUT_ENV, "") or DEFAULT_TIMEOUT_SECONDS)
    except ValueError:
        return DEFAULT_TIMEOUT_SECONDS


def ensure_podgroup_resource(store) -> None:
    """Register the podgroups GVR on a store that supports declarative
    registration (idempotent; no-op for stores without the surface,
    e.g. the remote HTTP client)."""
    reg = getattr(store, "register_resource", None)
    if reg is not None:
        reg(POD_GROUP_RESOURCE, POD_GROUP_KIND, namespaced=True,
            api_version=POD_GROUP_API_VERSION)


def group_key_of(pod: dict) -> tuple[str, str] | None:
    """(namespace, group name) from the pod-group label, or None."""
    meta = pod.get("metadata") or {}
    name = (meta.get("labels") or {}).get(POD_GROUP_LABEL)
    if not name:
        return None
    return (meta.get("namespace") or "default", name)


def _fmt_timeout(seconds: float) -> str:
    """The permit-result-timeout string for a gang wait — integral
    seconds render bare ("30s"), like the duration strings plugins pass."""
    if seconds == int(seconds):
        return f"{int(seconds)}s"
    return f"{seconds:g}s"


@dataclass(frozen=True)
class GroupSpec:
    namespace: str
    name: str
    min_member: int
    timeout_seconds: float
    timeout_str: str
    min_resources: dict | None = None

    @property
    def key(self) -> tuple[str, str]:
        return (self.namespace, self.name)


class GangDirectory:
    """Wave-start snapshot of PodGroup specs + member counts.

    Reads shared store manifests (the informer-cache contract) — never
    mutates them.  A pod whose label names a PodGroup that does not
    exist is treated as an ordinary pod (upstream coscheduling schedules
    label-without-CRD pods individually)."""

    def __init__(self, store):
        self.specs: dict[tuple[str, str], GroupSpec] = {}
        self.total: dict[tuple[str, str], int] = {}
        self.bound: dict[tuple[str, str], int] = {}
        self._scanned = False
        self._store = store
        from ..cluster.store import NotFound, list_shared

        try:
            items = list_shared(store, POD_GROUP_RESOURCE)
        except (NotFound, KeyError):
            items = []
        for pg in items:
            meta = pg.get("metadata") or {}
            spec = pg.get("spec") or {}
            ns = meta.get("namespace") or "default"
            name = meta.get("name", "")
            timeout = spec.get("scheduleTimeoutSeconds")
            timeout = (default_timeout_seconds() if timeout is None
                       else float(timeout))
            self.specs[(ns, name)] = GroupSpec(
                namespace=ns, name=name,
                min_member=int(spec.get("minMember") or 1),
                timeout_seconds=timeout,
                timeout_str=_fmt_timeout(timeout),
                min_resources=spec.get("minResources") or None,
            )

    def __bool__(self) -> bool:
        return bool(self.specs)

    def scan_members(self, pods: list[dict]) -> None:
        """Count member pods (total and bound) per group over a shared
        pod listing; idempotent per directory."""
        if self._scanned:
            return
        self._scanned = True
        for p in pods:
            key = group_key_of(p)
            if key is None or key not in self.specs:
                continue
            self.total[key] = self.total.get(key, 0) + 1
            if (p.get("spec") or {}).get("nodeName"):
                self.bound[key] = self.bound.get(key, 0) + 1

    # ------------------------------------------------------- PreFilter

    def prefilter_reason(self, key: tuple[str, str],
                         free_fn=None) -> str | None:
        """The upstream-coscheduling PreFilter verdict for a member of
        `key`: a rejection message when the group can NEVER reach quorum
        from the current cluster state, else None.

          * fewer than minMember member pods exist anywhere;
          * minResources (when set) exceeds the cluster's free capacity
            (free_fn() -> {"cpu": milli, "memory": bytes}, computed
            lazily by the caller — documented simplification of the
            upstream quota check, docs/gang-scheduling.md).
        """
        spec = self.specs.get(key)
        if spec is None:
            return None
        total = self.total.get(key, 0)
        if total < spec.min_member:
            return (f'PodGroup "{key[0]}/{key[1]}" cannot reach quorum: '
                    f"{total} member pod(s) exist, minMember={spec.min_member}")
        if spec.min_resources and free_fn is not None:
            from ..utils.quantity import parse_cpu_milli, parse_memory_bytes

            free = free_fn()
            want_cpu = parse_cpu_milli(spec.min_resources.get("cpu") or 0)
            want_mem = parse_memory_bytes(spec.min_resources.get("memory") or 0)
            if want_cpu > free.get("cpu", 0) or want_mem > free.get("memory", 0):
                return (f'PodGroup "{key[0]}/{key[1]}" minResources cannot be '
                        "satisfied by the cluster's free capacity")
        return None


# ---------------------------------------------------------------- quorum


def quorum_slice_plain(gid, selected, already, min_member):
    """B8's plain PyTorch version: the reference's segment reduction
    (gang.py:195) with `scatter_add_`, `cumsum` and
    `scatter_reduce_(..., "amin")`.  gid / selected [n] and already /
    min_member [G] int32 tensors with n, G > 0 -> (admit [G] bool,
    wave [G] int32, wait_mask [n] bool).  The CPU path and the card's
    reference; nothing on the card's main path calls it."""
    n = int(gid.shape[0])
    g = int(min_member.shape[0])
    dev = gid.device
    grouped = gid >= 0
    feas = (selected >= 0) & grouped
    # ungrouped pods land in a dummy trailing segment, sliced off
    seg = torch.where(grouped, gid, g).to(torch.int64)
    feas_i = feas.to(torch.int32)
    wave = torch.zeros(g + 1, dtype=torch.int32, device=dev).scatter_add_(
        0, seg, feas_i)[:g]
    admit = (wave + already) >= min_member
    cf = torch.cumsum(feas_i, 0, dtype=torch.int32)
    # segment_min: an empty segment keeps the int32 identity, then clips
    idx = torch.where(grouped, torch.arange(n, device=dev), n)
    first = torch.full((g + 1,), np.iinfo(np.int32).max, dtype=torch.int64,
                       device=dev).scatter_reduce_(0, seg, idx, "amin")[:g]
    first = torch.clamp(first, 0, n - 1)
    gbase = cf[first] - feas_i[first]
    gid_safe = torch.where(grouped, gid, 0).to(torch.int64)
    rank = cf - gbase[gid_safe]
    wait_mask = feas & ((already[gid_safe] + rank) < min_member[gid_safe])
    return admit, wave, wait_mask


def quorum_slice(gid: np.ndarray, selected: np.ndarray,
                 already: np.ndarray, min_member: np.ndarray,
                 device="cuda") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The vectorized gang-quorum pass over one contiguous pending
    slice (kernel B8, kernels/gang.py): per-group feasible counts and
    the allow/park decision — no per-pod Python loop.

    Every gang present in the slice must be FULLY contained in it (the
    gang-contiguous pending order guarantees this; the streaming
    committer cuts chunk ranges on gang boundaries).

    gid:        [n] int32, wave-local group id per pod (-1 ungrouped)
    selected:   [n] int32, replayed node selection (-1 infeasible)
    already:    [G] int32, waiting + bound members per group before the wave
    min_member: [G] int32
    device:     where the pass runs: a CUDA device launches B8 (one
                host-to-device copy of the four rows, one copy back), the
                CPU runs quorum_slice_plain

    Returns numpy (admit [G] bool, wave_counts [G] int32,
    wait_mask [n] bool).  wait_mask marks feasible members whose Permit
    would have answered "wait" (their 1-based feasible rank within the
    group, plus `already`, is still below minMember) — the members that
    park when the group is below quorum, and that record the "wait"
    permit-result (then a group-wide allow) when the group admits.
    """
    from ..kernels.gang import quorum_slice as _kernel

    n = int(gid.shape[0])
    g = int(min_member.shape[0])
    if n == 0 or g == 0:
        return (np.zeros(g, bool), np.zeros(g, np.int32), np.zeros(n, bool))
    packed = np.concatenate([
        np.asarray(gid, np.int32), np.asarray(selected, np.int32),
        np.asarray(already, np.int32), np.asarray(min_member, np.int32)])
    out = _kernel(torch.from_numpy(packed).to(device), n, g).cpu().numpy()
    admit_np = out[:g] != 0
    wave_np = out[g:2 * g].astype(np.int32)
    wait_mask = out[2 * g:] != 0
    # flight-recorder tap (docs/metrics.md): per-PASS decision counts for
    # the groups this slice actually touched.  A group re-examined by a
    # later pass counts again here — the engine's
    # gang_groups_admitted_total counter stays the deduplicated total.
    present = wave_np > 0
    n_admit = int((present & admit_np).sum())
    n_park = int((present & ~admit_np).sum())
    from ..utils.tracing import TRACER

    if n_admit:
        TRACER.inc("gang_quorum_groups_total", n_admit, decision="admit")
    if n_park:
        TRACER.inc("gang_quorum_groups_total", n_park, decision="park")
    return (admit_np, wave_np, wait_mask)


def aligned_cut(gid: np.ndarray, start: np.ndarray, lo: int, k: int,
                p: int) -> int:
    """Pull a prospective cut at pod lo+k back to the nearest gang
    boundary, so gangs stream as ALL-OR-NOTHING prefix units: when the
    pods on either side of the cut share a group (gangs are contiguous
    in pending order), the cut retreats to the group's first index and
    the whole gang re-evaluates next round against the updated carry —
    exactly the state its members would have seen sequentially, so
    parity is unaffected; the pullback only keeps a gang's members in
    one acceptance unit.  A gang larger than the unit (pullback would
    leave an empty, non-terminating round) is accepted mid-gang instead
    — the streaming committer's gang-cut watermark still defers its
    COMMIT until the group is whole, so admission stays atomic.

    Used by the speculative stream's round acceptance (the quorum
    decision itself remains quorum_slice at commit)."""
    a = lo + k
    if k <= 0 or a >= p:
        return k
    g = int(gid[a])
    if g >= 0 and int(gid[a - 1]) == g:
        pull = int(start[g]) - lo
        if pull >= 1:
            return pull
    return k


# ------------------------------------------------------------ preemption


def preemption_protected(pods_all: list[dict],
                         directory: GangDirectory) -> set[str]:
    """Pod keys ("ns/name") of bound gang members that preemption must
    never victimize: a running PodGroup never drops below minMember, so
    per group only the (bound - minMember) LEAST important members stay
    eligible (least important = lowest priority, then latest creation —
    the reverse of upstream MoreImportantPod)."""
    if not directory.specs:
        return set()
    members: dict[tuple[str, str], list[dict]] = {}
    for p in pods_all:
        if not ((p.get("spec") or {}).get("nodeName")):
            continue
        key = group_key_of(p)
        if key is None or key not in directory.specs:
            continue
        members.setdefault(key, []).append(p)
    protected: set[str] = set()

    def _prio(p: dict) -> int:
        return int((p.get("spec") or {}).get("priority") or 0)

    def _created(p: dict) -> str:
        start = (p.get("status") or {}).get("startTime")
        return start or (p.get("metadata") or {}).get("creationTimestamp") or ""

    def _key(p: dict) -> str:
        meta = p.get("metadata") or {}
        return f"{meta.get('namespace') or 'default'}/{meta.get('name', '')}"

    for key, ms in members.items():
        quota = len(ms) - directory.specs[key].min_member
        if quota <= 0:
            protected.update(_key(p) for p in ms)
            continue
        # least-important-first; later creation is less important, so
        # invert the timestamp ordering via a sort on the negated rank
        ms_sorted = sorted(
            ms, key=lambda p: (_prio(p), _RevStr(_created(p)), _key(p)))
        protected.update(_key(p) for p in ms_sorted[quota:])
    return protected


class _RevStr(str):
    """String with inverted ordering (later timestamps sort first)."""

    def __lt__(self, other):  # noqa: D105
        return str.__gt__(self, other)

    def __gt__(self, other):  # noqa: D105
        return str.__lt__(self, other)
