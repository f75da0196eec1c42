"""VolumeZone filter function.

Port of kube_scheduler_simulator_tpu/plugins/volumezone.py: `build` (:76)
and `filter_kernel` :97.  On the card the kernel reads the row
(csrc/volumes.cuh volumezone_filter).

Upstream v1.32 `volumezone`: Filter fails a node when some PVC's bound PV
carries a zone/region topology label whose (comma-separated) value set
does not contain the node's value for that label — status
"node(s) had no available volume zone".  PreFilter returns Skip unless
some bound PV carries a zone label.

PV zone labels and node labels are both static during a replay, so the
whole plugin compiles to a per-pod [N] code row evaluated on the host.
Unbound PVCs are skipped (VolumeBinding owns them).  When every pod Skips
the rows are [P, 1] and broadcast over the nodes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import to_tensor
from ..state.volumes import ZONE_LABELS, VolumeTable, pod_pvc_keys

NAME = "VolumeZone"
ERR_VOLUME_ZONE_CONFLICT = "node(s) had no available volume zone"


class VolumeZoneXS(NamedTuple):
    codes: torch.Tensor        # [P, N] (or [P, 1]) int32 (0 pass, 1 zone conflict)
    filter_skip: torch.Tensor  # [P] bool


def _zone_conflict(node_labels: dict[str, str], pv_labels) -> bool:
    for key in ZONE_LABELS:
        if key not in pv_labels:
            continue
        allowed = {z.strip() for z in str(pv_labels[key]).split(",")}
        if node_labels.get(key) not in allowed:
            return True
    return False


def pod_zone_codes(vt: VolumeTable, node_labels_list, pod: dict,
                   pv_rows: dict) -> np.ndarray | None:
    """[N] int32 codes for one pod, or None when the plugin Skips.
    pv_rows caches each PV's conflict row across pods."""
    keys = pod_pvc_keys(pod)
    if not keys:
        return None
    n = len(node_labels_list)
    codes = np.zeros(n, dtype=np.int32)
    relevant = False
    for key in keys:
        pvc = vt.pvcs.get(key)
        if pvc is None or not pvc.volume_name:
            # missing PVC / unbound: VolumeBinding's PreFilter owns the
            # rejection; nothing zone-specific to check here
            continue
        i = vt.pv_index.get(pvc.volume_name)
        if i is None:
            continue
        labels = vt.pvs[i].labels
        if not any(k in labels for k in ZONE_LABELS):
            continue
        relevant = True
        row = pv_rows.get(i)
        if row is None:
            row = pv_rows[i] = np.asarray(
                [_zone_conflict(nl, labels) for nl in node_labels_list], dtype=bool)
        codes[row] = 1
    # upstream PreFilter: Skip unless some bound PV carries a zone label
    return codes if relevant else None


def build(vt: VolumeTable, table, pods: list[dict], device="cpu") -> VolumeZoneXS:
    p, n = len(pods), table.n
    per_pod: dict[int, np.ndarray] = {}
    skip = np.ones(p, dtype=bool)
    pv_rows: dict[int, np.ndarray] = {}
    for i, pod in enumerate(pods):
        c = pod_zone_codes(vt, table.labels, pod, pv_rows)
        if c is not None:
            per_pod[i] = c
            skip[i] = False
    # compact [P, 1] when every pod Skips: the filter broadcasts to [N]
    if not per_pod:
        codes = np.zeros((p, 1), dtype=np.int32)
    else:
        codes = np.zeros((p, n), dtype=np.int32)
        for i, c in per_pod.items():
            codes[i] = c
    return VolumeZoneXS(codes=to_tensor(codes, device), filter_skip=to_tensor(skip, device))


def filter_kernel(sl: VolumeZoneXS) -> torch.Tensor:
    return sl.codes
