"""NodeResourcesFit + NodeResourcesBalancedAllocation tensor functions.

Port of kube_scheduler_simulator_tpu/plugins/noderesources.py: build code
(:44-85), `fit_filter` (:87), `fit_score` (:157), `balanced_score` (:191)
and `core_bind_update` (:228), as plain PyTorch.  The card runs the same
math in csrc/fit.cuh.

Filter (Fit): a node fails when
  * len(pods)+1 > allowedPodNumber                  -> "Too many pods"
  * request[r] > allocatable[r] - requested[r]      -> "Insufficient <r>"
The failure code is a bitmask with bit 0 = too-many-pods and bit 1+r =
resource column r; all insufficient resources are reported, comma-joined,
in column order.

Score (Fit): scoringStrategy-driven weighted mean of per-resource scores
(fitscoring.py).  Score (BalancedAllocation): fractions f_r = min(req_r /
alloc_r, 1); for 2 resources std = |f0-f1|/2, else population std; score =
int64((1 - std) * 100), in float64 as upstream.  Neither has
ScoreExtensions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import fitscoring
from .base import MAX_NODE_SCORE, to_tensor
from ..state.resources import CPU, MEMORY, ResourceSchema

NAME_FIT = "NodeResourcesFit"
NAME_BALANCED = "NodeResourcesBalancedAllocation"


class FitStatic(NamedTuple):
    allocatable: torch.Tensor   # [N, R] int64
    allowed_pods: torch.Tensor  # [N] int64
    ignored: torch.Tensor       # [R] bool — NodeResourcesFitArgs ignored*


def fit_ignored_mask(schema: ResourceSchema, args: dict | None) -> np.ndarray:
    """[R] bool mask of schema columns excluded from the fit check by
    NodeResourcesFitArgs.ignoredResources / ignoredResourceGroups.
    Upstream fitsRequest only skips EXTENDED resources (domain-prefixed
    names); cpu/memory/ephemeral-storage are never ignorable."""
    a = args or {}
    names = set(a.get("ignoredResources") or [])
    groups = set(a.get("ignoredResourceGroups") or [])
    out = np.zeros(len(schema.columns), dtype=bool)
    for r, col in enumerate(schema.columns):
        # IsExtendedResourceName: domain-prefixed and NOT kubernetes.io/
        if "/" not in col:
            continue
        prefix = col.split("/", 1)[0]
        if prefix == "kubernetes.io" or prefix.endswith(".kubernetes.io"):
            continue
        if col in names or prefix in groups:
            out[r] = True
    return out


class FitPodXS(NamedTuple):
    requests: torch.Tensor  # [P, R] int64 (actual; filter path)
    nonzero: torch.Tensor   # [P, 2] int64 (scoring path)


def build_fit(table, schema: ResourceSchema, requests, nonzero,
              fit_args: dict | None = None, device="cpu"):
    static = FitStatic(
        allocatable=to_tensor(table.allocatable, device),
        allowed_pods=to_tensor(table.allowed_pods, device),
        ignored=to_tensor(fit_ignored_mask(schema, fit_args), device),
    )
    xs = FitPodXS(requests=to_tensor(requests, device),
                  nonzero=to_tensor(nonzero, device))
    return static, xs


def fit_filter(static: FitStatic, pod: FitPodXS, carry) -> torch.Tensor:
    """[N] int32 bitmask; 0 == pass."""
    free = static.allocatable - carry.requested          # [N, R]
    insufficient = (pod.requests[None, :] > free) & ~static.ignored[None, :]
    too_many = (carry.num_pods + 1) > static.allowed_pods  # [N]
    shifts = torch.arange(insufficient.shape[1], dtype=torch.int32,
                          device=free.device)
    bits = torch.where(insufficient, 2 << shifts, 0)
    res_code = torch.sum(bits, dim=1, dtype=torch.int32)
    # upstream fitsRequest early-returns after the pod-count check when the
    # pod requests nothing — an overcommitted node (free < 0) still fits a
    # zero-request pod
    res_code = torch.where(torch.all(pod.requests == 0), 0, res_code)
    return res_code + too_many.to(torch.int32)


def decode_fit_filter(code: int, schema: ResourceSchema) -> str:
    reasons = []
    if code & 1:
        reasons.append("Too many pods")
    for r, name in enumerate(schema.columns):
        if code & (2 << r):
            reasons.append(f"Insufficient {name}")
    return ", ".join(reasons)


def _resource_req_alloc(static: FitStatic, pod: FitPodXS, carry, name: str,
                        schema: ResourceSchema | None,
                        use_requested: bool = False):
    """-> (requested [N], allocatable [N]) for one scored resource.
    cpu/memory use the non-zero-defaulted accumulators unless
    use_requested (RequestedToCapacityRatio) selects the raw ones;
    ephemeral-storage and scalar resources always read the raw
    accumulators."""
    if name == "cpu":
        if use_requested:
            return carry.requested[:, CPU] + pod.requests[CPU], static.allocatable[:, CPU]
        return carry.nonzero[:, 0] + pod.nonzero[0], static.allocatable[:, CPU]
    if name == "memory":
        if use_requested:
            return carry.requested[:, MEMORY] + pod.requests[MEMORY], static.allocatable[:, MEMORY]
        return carry.nonzero[:, 1] + pod.nonzero[1], static.allocatable[:, MEMORY]
    if schema is not None and name in schema.columns:
        c = schema.columns.index(name)
        return carry.requested[:, c] + pod.requests[c], static.allocatable[:, c]
    # untracked resource: requested 0 against capacity 0 — the zero
    # capacity makes _resource_active exclude it everywhere
    n = static.allocatable.shape[0]
    zeros = torch.zeros(n, dtype=torch.int64, device=static.allocatable.device)
    return zeros, zeros


def _resource_active(static: FitStatic, pod: FitPodXS, name: str,
                     alloc, schema: ResourceSchema | None):
    """[N] bool — does this resource take part in the weighted mean on
    each node?  Upstream skips a resource whose allocatable is 0, and a
    scalar (extended) resource the pod does not request."""
    active = alloc > 0
    if name not in fitscoring.NATIVE_RESOURCES:
        if schema is not None and name in schema.columns:
            c = schema.columns.index(name)
            active = active & (pod.requests[c] > 0)
        else:
            active = torch.zeros_like(active)
    return active


def fit_score(static: FitStatic, pod: FitPodXS, carry,
              strategy: fitscoring.FitStrategy | None = None,
              schema: ResourceSchema | None = None) -> torch.Tensor:
    """Weighted mean of per-resource scores, inactive resources excluded
    from the weight sum per node, 0 when every resource is inactive.
    Least/Most use truncating int64 division of non-negative operands;
    RequestedToCapacityRatio drops resources whose score is 0 from the
    weight sum and rounds the mean half up."""
    if strategy is None:
        strategy = fitscoring.FitStrategy(
            fitscoring.LEAST_ALLOCATED, fitscoring.DEFAULT_RESOURCES, ())
    rtcr = strategy.stype == fitscoring.REQUESTED_TO_CAPACITY_RATIO
    n = static.allocatable.shape[0]
    dev = static.allocatable.device
    total = torch.zeros(n, dtype=torch.int64, device=dev)
    wsum = torch.zeros(n, dtype=torch.int64, device=dev)
    for name, w in strategy.resources:
        req, alloc = _resource_req_alloc(static, pod, carry, name, schema,
                                         use_requested=rtcr)
        active = _resource_active(static, pod, name, alloc, schema)
        s = fitscoring.score_resource_vec(strategy, req, alloc)
        if rtcr:
            active = active & (s > 0)
        total = total + torch.where(active, s * w, 0)
        wsum = wsum + torch.where(active, w, 0)
    if rtcr:
        return torch.where(
            wsum > 0, (2 * total + wsum) // torch.clamp(2 * wsum, min=1), 0)
    return torch.where(wsum > 0, total // torch.clamp(wsum, min=1), 0)


def balanced_score(static: FitStatic, pod: FitPodXS, carry,
                   resources: tuple[str, ...] = ("cpu", "memory"),
                   schema: ResourceSchema | None = None) -> torch.Tensor:
    """balanced_allocation.go: std of per-resource utilization fractions,
    score = int64((1-std)·100), float64.  Sums over the resource axis run
    in resource order (an explicit loop), so the kernel can repeat them
    term for term."""
    fracs = []
    masks = []
    for name in resources:
        req, alloc = _resource_req_alloc(static, pod, carry, name, schema)
        a = alloc.to(torch.float64)
        f = torch.clamp(req.to(torch.float64) / torch.clamp(a, min=1.0), max=1.0)
        fracs.append(f)
        masks.append(_resource_active(static, pod, name, alloc, schema))
    cnt = sum(m.to(torch.int64) for m in masks)
    if len(resources) == 2:
        # both present -> |f0-f1|/2; one missing -> single fraction, std 0
        std = torch.where(cnt == 2, torch.abs(fracs[0] - fracs[1]) / 2.0, 0.0)
    else:
        fm = [torch.where(m, f, 0.0) for f, m in zip(fracs, masks)]
        denom = torch.clamp(cnt, min=1).to(torch.float64)
        s1 = _ordered_sum(fm)
        mean = s1 / denom
        var = _ordered_sum([torch.where(m, (f - mean) ** 2, 0.0)
                            for f, m in zip(fracs, masks)]) / denom
        # exactly two present fractions a,b (positions unknown):
        # |a-b| = sqrt(2·Σf² - (Σf)²)
        s2 = _ordered_sum([torch.where(m, f * f, 0.0)
                           for f, m in zip(fracs, masks)])
        two_std = torch.sqrt(torch.clamp(2.0 * s2 - s1 * s1, min=0.0)) / 2.0
        std = torch.where(cnt > 2, torch.sqrt(var),
                          torch.where(cnt == 2, two_std, 0.0))
    return ((1.0 - std) * MAX_NODE_SCORE).to(torch.int64)


def _ordered_sum(terms):
    out = terms[0]
    for t in terms[1:]:
        out = out + t
    return out


def core_bind_update(carry, pod: FitPodXS, sel):
    """Apply a bind to the shared resource accumulators; sel == -1 leaves
    them untouched (the added row is multiplied by 0)."""
    bound = (sel >= 0).to(torch.int64)
    idx = torch.clamp(sel, min=0).reshape(1).to(torch.int64)
    requested = carry.requested.index_add(
        0, idx, (pod.requests * bound).reshape(1, -1))
    nonzero = carry.nonzero.index_add(
        0, idx, (pod.nonzero * bound).reshape(1, -1))
    num_pods = carry.num_pods.index_add(0, idx, bound.reshape(1))
    return carry._replace(requested=requested, nonzero=nonzero, num_pods=num_pods)
