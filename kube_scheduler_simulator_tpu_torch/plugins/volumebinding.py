"""VolumeBinding tensor functions.

Port of kube_scheduler_simulator_tpu/plugins/volumebinding.py:
`classify_pod` (:96), `prime_claims` (:125), `build` (:158),
`_greedy_choices` :222, `filter_kernel` :249, `bind_update` :254 and
`score_kernel` :265.  On the card the greedy choice, the filter and the
bind run inside csrc/volumes.cuh.

Upstream v1.32 `volumebinding`:

* PreFilter: Skip when the pod has no PVC volumes; rejects the pod
  outright (UnschedulableAndUnresolvable) when a PVC is missing, when an
  unbound PVC's StorageClass uses Immediate binding ("pod has unbound
  immediate PersistentVolumeClaims"), or when the StorageClass doesn't
  exist — those become compile-time per-pod rejects here.
* Filter (FindPodVolumes): a node fails with
    - "node(s) had volume node affinity conflict" when a *bound* PVC's PV
      has a node affinity not matching the node,
    - "node(s) didn't find available persistent volumes to bind" when some
      unbound WaitForFirstConsumer PVC can neither claim an existing
      matching PV nor be dynamically provisioned on the node,
    - "node(s) unavailable due to one or more pvc(s) bound to non-existent
      pv(s)" when a bound PVC references a PV that doesn't exist;
  the first two can be reported together, which is why codes are a bitmask.
* Reserve/PreBind assume + bind the chosen PVs; Score returns 0 with the
  VolumeCapacityPriority feature gate off (the default).

Tensorization: the bound-PV conflicts and the PreFilter rejects are static
per pod.  The *dynamic* part is PV claiming: pods with unbound WFFC PVCs
consume matching PVs as they bind, so the carry is `claimed[V]` and the
Filter runs the greedy findMatchingVolume per node — per PVC slot k, the
smallest-capacity available matching PV (ties -> lowest PV index), excluded
from later slots, with the StorageClass' allowedTopologies for dynamic
provisioning when no PV matches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from .base import to_tensor
from ..state.volumes import (
    NO_PROVISIONER,
    VolumeTable,
    allowed_topologies_match,
    pod_pvc_keys,
    pv_matches_claim,
)

NAME = "VolumeBinding"
ERR_NODE_CONFLICT = "node(s) had volume node affinity conflict"
ERR_BIND_CONFLICT = "node(s) didn't find available persistent volumes to bind"
ERR_PV_NOT_EXIST = (
    "node(s) unavailable due to one or more pvc(s) bound to non-existent pv(s)"
)
ERR_UNBOUND_IMMEDIATE = "pod has unbound immediate PersistentVolumeClaims"

# filter code bitmask
CODE_NODE_CONFLICT = 1
CODE_BIND_CONFLICT = 2
CODE_PV_NOT_EXIST = 4


def decode_filter(code: int, node_idx: int, aux) -> str:
    if code & CODE_PV_NOT_EXIST:
        return ERR_PV_NOT_EXIST
    parts = []
    if code & CODE_NODE_CONFLICT:
        parts.append(ERR_NODE_CONFLICT)
    if code & CODE_BIND_CONFLICT:
        parts.append(ERR_BIND_CONFLICT)
    return ", ".join(parts)


class BindingStatic(NamedTuple):
    pv_cap: torch.Tensor       # [V] int64
    pv_node_ok: torch.Tensor   # [V, N] bool


class BindingXS(NamedTuple):
    bound_code: torch.Tensor    # [P, N] (or [P, 1]) int32: node-conflict / pv-missing bits
    want: torch.Tensor          # [P, K, V] bool
    active: torch.Tensor        # [P, K] bool
    provision_ok: torch.Tensor  # [P, K, N] bool
    filter_skip: torch.Tensor   # [P] bool


class BindingCarry(NamedTuple):
    claimed: torch.Tensor       # [V] bool


# pv_cap tensor (by identity) -> its PVs in (capacity, index) order
_PV_ORDER = WeakIdKeyDictionary()


def pv_order(static: BindingStatic) -> torch.Tensor:
    """The PVs in (capacity, index) order, int32 on their device: a stable
    sort of the capacities, made once per static (statics never change
    after compile; `build` makes it) and read by the plain walk below and
    by the kernels (csrc/volumes.cuh, through kernels/step.py)."""
    order = _PV_ORDER.get(static.pv_cap)
    if order is None:
        order = torch.sort(static.pv_cap, stable=True).indices.to(torch.int32)
        _PV_ORDER[static.pv_cap] = order
    return order


def classify_pod(vt: VolumeTable, pod: dict):
    """-> (reject_msg | None, bound_pv_idx list, unbound PVCInfo list).

    reject_msg is the upstream PreFilter UnschedulableAndUnresolvable
    message; missing-PVC rejects also belong to VolumeRestrictions, whose
    PreFilter runs first and does the same lister lookup (compile.py)."""
    bound: list[int] = []
    unbound = []
    for key in pod_pvc_keys(pod):
        pvc = vt.pvcs.get(key)
        if pvc is None:
            name = key.split("/", 1)[1]
            return f'persistentvolumeclaim "{name}" not found', [], []
        if pvc.volume_name:
            bound.append(vt.pv_index.get(pvc.volume_name, -1))
            continue
        sc = vt.classes.get(pvc.storage_class or "")
        if sc is None:
            return (
                f'storageclass.storage.k8s.io "{pvc.storage_class}" not found',
                [], [],
            )
        if not sc.wait_for_first_consumer:
            return ERR_UNBOUND_IMMEDIATE, [], []
        unbound.append(pvc)
    return None, bound, unbound


def prime_claims(vt: VolumeTable, bound_pods, name_idx: dict[str, int]) -> np.ndarray:
    """claimed[V] with already-bound pods' WFFC claims re-applied: each
    bound pod's greedy choice re-derived host-side with the same rule
    (smallest capacity, lowest index), in bound_pods order."""
    claimed = vt.pv_claimed0.copy()
    for bp, node_name in bound_pods or []:
        j = name_idx.get(node_name)
        if j is None:
            continue
        reject, _, unbound = classify_pod(vt, bp)
        if reject is not None or not unbound:
            continue
        chosen: set[int] = set()
        for pvc in unbound:
            best = None
            for vi, pv in enumerate(vt.pvs):
                if claimed[vi] or vi in chosen or not vt.pv_node_ok[vi, j]:
                    continue
                if not pv_matches_claim(pv, pvc):
                    continue
                if best is None or pv.capacity < vt.pvs[best].capacity:
                    best = vi
            if best is not None:
                chosen.add(best)
        for vi in chosen:
            claimed[vi] = True
    return claimed


def build(vt: VolumeTable, table, pods: list[dict], bound_pods=None, device="cpu"):
    """-> (BindingStatic, BindingXS, BindingCarry, reject list[str | None])."""
    p, n, v = len(pods), table.n, vt.n_pvs
    classified = [classify_pod(vt, pod) for pod in pods]
    k_max = max((len(unbound) for _, _, unbound in classified), default=0)

    any_bound = any(bound for _, bound, _ in classified)
    # compact [P, 1] when no pod has bound PVCs (broadcast over the nodes)
    bound_code = np.zeros((p, n if any_bound else 1), dtype=np.int32)
    want = np.zeros((p, k_max, v), dtype=bool)
    active = np.zeros((p, k_max), dtype=bool)
    provision_ok = np.zeros((p, k_max, n), dtype=bool)
    skip = np.ones(p, dtype=bool)
    rejects: list[str | None] = []
    # rows shared by every claim of one storage class / every claim with
    # the same match inputs
    topo_rows: dict[str, np.ndarray] = {}
    want_rows: dict[tuple, np.ndarray] = {}

    for i, pod in enumerate(pods):
        reject, bound, unbound = classified[i]
        rejects.append(reject)
        if reject is not None:
            continue
        if pod_pvc_keys(pod):
            skip[i] = False
        for b in bound:
            if b < 0:
                bound_code[i, :] |= CODE_PV_NOT_EXIST
            else:
                bound_code[i, :] |= np.where(
                    vt.pv_node_ok[b], 0, CODE_NODE_CONFLICT
                ).astype(np.int32)
        for k, pvc in enumerate(unbound):
            active[i, k] = True
            wkey = (pvc.key, pvc.storage_class, pvc.access_modes, pvc.request,
                    repr(pvc.selector))
            if wkey not in want_rows:
                want_rows[wkey] = np.asarray(
                    [pv_matches_claim(pv, pvc) for pv in vt.pvs], dtype=bool)
            want[i, k] = want_rows[wkey]
            sc_name = pvc.storage_class or ""
            sc = vt.classes[sc_name]
            if sc.provisioner and sc.provisioner != NO_PROVISIONER:
                if sc_name not in topo_rows:
                    topo_rows[sc_name] = np.asarray(
                        [allowed_topologies_match(sc, table.labels[j]) for j in range(n)],
                        dtype=bool)
                provision_ok[i, k] = topo_rows[sc_name]

    static = BindingStatic(pv_cap=to_tensor(vt.pv_cap, device),
                           pv_node_ok=to_tensor(vt.pv_node_ok, device))
    pv_order(static)
    xs = BindingXS(
        bound_code=to_tensor(bound_code, device),
        want=to_tensor(want, device),
        active=to_tensor(active, device),
        provision_ok=to_tensor(provision_ok, device),
        filter_skip=to_tensor(skip, device),
    )
    name_idx = {name: j for j, name in enumerate(table.names)}
    carry = BindingCarry(claimed=to_tensor(prime_claims(vt, bound_pods, name_idx), device))
    return static, xs, carry, rejects


def _greedy_choices(static: BindingStatic, sl: BindingXS, claimed: torch.Tensor):
    """Per-node greedy matching over the pod's K unbound-PVC slots, as the
    kernel walks it (csrc/volumes.cuh vb_greedy): the pod's candidates are
    the unclaimed PVs some active slot wants, in (capacity, index) order;
    per slot k in order, at each node the first candidate the slot wants,
    allowed there and not taken by an earlier slot, which is the JAX
    argmin's first minimum (the least capacity, ties to the lowest index).

    -> (bindfail [N] bool, chosen [V, N] bool: PV v claimed when this pod
    lands on node n)."""
    v, n = static.pv_node_ok.shape
    k_max = sl.want.shape[0]
    dev = claimed.device
    chosen = torch.zeros((v, n), dtype=torch.bool, device=dev)
    bindfail = torch.zeros(n, dtype=torch.bool, device=dev)
    cand = torch.zeros(0, dtype=torch.int64, device=dev)
    if v > 0 and k_max > 0:
        order = pv_order(static).long()
        wanted = (sl.want & sl.active[:, None]).any(dim=0) & ~claimed
        cand = order[wanted[order]]
    allowed = static.pv_node_ok[cand]                                    # [m, N]
    nodes = torch.arange(n, device=dev)
    for k in range(k_max):
        ok = sl.want[k][cand][:, None] & allowed & ~chosen[cand]         # [m, N]
        has = ok.any(dim=0)
        if cand.numel():
            pick = cand[torch.argmax(ok.to(torch.uint8), dim=0)]        # the first allowed
            use = sl.active[k] & has
            chosen[pick, nodes] |= use
        ok_k = has | sl.provision_ok[k]
        bindfail = bindfail | (sl.active[k] & ~ok_k)
    return bindfail, chosen


def filter_kernel(static: BindingStatic, sl: BindingXS, carry: BindingCarry) -> torch.Tensor:
    bindfail, _ = _greedy_choices(static, sl, carry.claimed)
    return (sl.bound_code | torch.where(bindfail, CODE_BIND_CONFLICT, 0)).to(torch.int32)


def bind_update(static: BindingStatic, sl: BindingXS, carry: BindingCarry,
                selected: torch.Tensor) -> BindingCarry:
    """Claim the PVs the greedy matcher picked on the selected node."""
    v = static.pv_cap.shape[0]
    if v == 0 or sl.want.shape[0] == 0:
        return carry
    _, chosen = _greedy_choices(static, sl, carry.claimed)
    col = chosen[:, torch.clamp(selected, min=0).to(torch.int64)]
    return BindingCarry(claimed=carry.claimed | (col & (selected >= 0)))


def score_kernel(n_nodes: int, device) -> torch.Tensor:
    """VolumeCapacityPriority is off by default: Score returns 0."""
    return torch.zeros(n_nodes, dtype=torch.int64, device=device)
