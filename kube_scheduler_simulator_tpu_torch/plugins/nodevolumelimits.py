"""NodeVolumeLimits (CSI) tensor functions.

Port of kube_scheduler_simulator_tpu/plugins/nodevolumelimits.py: `build`
(:65), `filter_kernel` :125 and `bind_update` :137.  On the card the
filter and the bind run inside csrc/volumes.cuh.

Upstream v1.32 `nodevolumelimits.CSILimits`: Filter fails a node when
attaching the pod's CSI volumes would push any driver's unique-volume
count on that node over the CSINode-reported allocatable limit — status
"node(s) exceed max volume count".  Nodes with no CSINode object or no
limit for the driver are never failed.  PreFilter returns Skip when the
pod has no PVC-backed volumes.

Tensorization: CSI volumes (driver, volumeHandle) over PVC-bound PVs are
interned as c-slots with a driver id; the carry tracks the per-node
unique-volume bitmap `on_node[N, C]` (a volume shared by two pods counts
once).  Per-driver counts are an int64 [N, C] x [C, D] product against
the driver one-hot; a pod's filter walks only its own volumes (the
kernel's per-pod list) against them.  As in the JAX package, volumes a pod acquires through
dynamic WaitForFirstConsumer provisioning are not counted against later
pods, and inline ephemeral CSI volumes are not modelled.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import to_tensor
from ..state.volumes import VolumeTable, pod_pvc_keys

NAME = "NodeVolumeLimits"
ERR_MAX_VOLUME_COUNT = "node(s) exceed max volume count"


class LimitsStatic(NamedTuple):
    driver_onehot: torch.Tensor  # [C, D] bool
    limits: torch.Tensor         # [N, D] int64 (-1 = unlimited)


class LimitsXS(NamedTuple):
    pod_vols: torch.Tensor       # [P, C] bool
    filter_skip: torch.Tensor    # [P] bool


class LimitsCarry(NamedTuple):
    on_node: torch.Tensor        # [N, C] bool


def pod_csi_volumes(vt: VolumeTable, pod: dict) -> list[tuple[str, str]]:
    """(driver, handle) for each CSI volume reached through a bound PVC."""
    out = []
    for key in pod_pvc_keys(pod):
        pvc = vt.pvcs.get(key)
        if pvc is None or not pvc.volume_name:
            continue
        i = vt.pv_index.get(pvc.volume_name)
        if i is None:
            continue
        pv = vt.pvs[i]
        if pv.csi_driver and pv.csi_handle:
            out.append((pv.csi_driver, pv.csi_handle))
    return out


def build(vt: VolumeTable, table, pods: list[dict],
          bound_pods: list[tuple[dict, str]], device="cpu"):
    """-> (LimitsStatic, LimitsXS, LimitsCarry).  With no CSINode-published
    limits every dimension is 0 and the filter can never fail a node."""
    drivers = sorted(vt.csi_limits)
    d_idx = {d: i for i, d in enumerate(drivers)}

    vol_id: dict[tuple[str, str], int] = {}
    vol_driver: list[int] = []

    def c_of(vol: tuple[str, str]) -> int | None:
        if vol[0] not in d_idx:
            return None  # unlimited driver: irrelevant to the filter
        i = vol_id.get(vol)
        if i is None:
            i = vol_id[vol] = len(vol_id)
            vol_driver.append(d_idx[vol[0]])
        return i

    pod_vol_lists = [pod_csi_volumes(vt, p) for p in pods]
    bound_vol_lists = [(pod_csi_volumes(vt, bp), nn) for bp, nn in bound_pods]
    for vols in pod_vol_lists + [v for v, _ in bound_vol_lists]:
        for vol in vols:
            c_of(vol)

    p, n = len(pods), table.n
    nc, ndrv = len(vol_id), len(drivers)
    pod_vols = np.zeros((p, nc), dtype=bool)
    skip = np.ones(p, dtype=bool)
    for i, pod in enumerate(pods):
        if pod_pvc_keys(pod):
            skip[i] = False  # upstream Skips only pods with no PVC volumes
        for vol in pod_vol_lists[i]:
            c = c_of(vol)
            if c is not None:
                pod_vols[i, c] = True

    on_node = np.zeros((n, nc), dtype=bool)
    name_idx = {name: j for j, name in enumerate(table.names)}
    for vols, node_name in bound_vol_lists:
        j = name_idx.get(node_name)
        if j is None:
            continue
        for vol in vols:
            c = c_of(vol)
            if c is not None:
                on_node[j, c] = True

    onehot = np.zeros((nc, ndrv), dtype=bool)
    for c, d in enumerate(vol_driver):
        onehot[c, d] = True
    limits = np.stack([vt.csi_limits[d] for d in drivers], axis=1) if drivers else \
        np.zeros((n, 0), dtype=np.int64)

    static = LimitsStatic(driver_onehot=to_tensor(onehot, device),
                          limits=to_tensor(limits, device))
    xs = LimitsXS(pod_vols=to_tensor(pod_vols, device), filter_skip=to_tensor(skip, device))
    carry = LimitsCarry(on_node=to_tensor(on_node, device))
    return static, xs, carry


def _per_driver(x: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
    """int64 [N, C] @ [C, D] of two bool operands, as a broadcast sum (an
    integer matmul is not on every device)."""
    return (x.to(torch.int64)[:, :, None] * onehot.to(torch.int64)[None, :, :]).sum(1)


def filter_kernel(static: LimitsStatic, sl: LimitsXS, carry: LimitsCarry) -> torch.Tensor:
    """[N] int32: 1 where a driver limit would be exceeded.

    The kernel's walk (csrc/volumes.cuh nvl_filter): the pod's own volumes,
    compacted, give `added` per (node, driver), the volumes of that list not
    yet on the node; `existing` is the per-(node, driver) count of unique
    volumes on the node, which the kernel keeps beside the bitmap.  A pod
    that brings no volume fails no node."""
    n = carry.on_node.shape[0]
    vols = torch.nonzero(sl.pod_vols).flatten()                                 # the pod's list
    if vols.numel() == 0:
        return torch.zeros(n, dtype=torch.int32, device=carry.on_node.device)
    existing = _per_driver(carry.on_node, static.driver_onehot)                 # [N, D]
    added = _per_driver(~carry.on_node[:, vols], static.driver_onehot[vols])    # [N, D]
    # upstream checks only drivers the pod ADDS volumes for, so a node
    # already over its limit still accepts pods that bring nothing new
    over = (static.limits >= 0) & (added > 0) & (existing + added > static.limits)
    return torch.any(over, dim=1).to(torch.int32)


def bind_update(sl: LimitsXS, carry: LimitsCarry, selected: torch.Tensor) -> LimitsCarry:
    n = carry.on_node.shape[0]
    onehot = (torch.arange(n, device=carry.on_node.device) == selected)[:, None]
    return LimitsCarry(on_node=carry.on_node | (onehot & sl.pod_vols[None, :]))
