"""NodeResourcesFit / NodeResourcesBalancedAllocation scoringStrategy.

Port of kube_scheduler_simulator_tpu/plugins/fitscoring.py: the strategy
parsing (:49-80) and the tensor scorer (`_jnp_trunc_div` :124,
`_broken_linear_vec` :129, `score_resource_vec` :142).  The scalar oracle
(:82-121) belongs to the JAX package's sequential reference and is not
ported.

Upstream v1.32 semantics (pkg/scheduler/framework/plugins/noderesources):
  * resource_allocation.go score():   node = Σ score_r·w_r  //  Σ w_r
  * least_allocated.go:  (cap-req)·100/cap, 0 when req>cap or cap==0
  * most_allocated.go:   req·100/cap,       0 when req>cap or cap==0
  * requested_to_capacity_ratio.go: shape points (utilization 0-100,
    score 0-10 scaled ×10 at build); rawScore = broken-linear(utilization)
    with utilization = req·100/cap, and rawScore(100) when cap==0 or
    req>cap.  All arithmetic int64 with Go truncating division.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

MAX_NODE_SCORE = 100
MAX_CUSTOM_PRIORITY_SCORE = 10

DEFAULT_RESOURCES = (("cpu", 1), ("memory", 1))

LEAST_ALLOCATED = "LeastAllocated"
MOST_ALLOCATED = "MostAllocated"
REQUESTED_TO_CAPACITY_RATIO = "RequestedToCapacityRatio"


# resources handled natively by calculateResourceAllocatableRequest;
# everything else is a scalar resource bypassed when the pod doesn't
# request it
NATIVE_RESOURCES = ("cpu", "memory", "ephemeral-storage")


class FitStrategy(NamedTuple):
    stype: str
    resources: tuple[tuple[str, int], ...]   # (name, weight)
    shape: tuple[tuple[int, int], ...]       # (utilization, score×10) ascending


def parse_fit_strategy(args: dict | None) -> FitStrategy:
    ss = (args or {}).get("scoringStrategy") or {}
    stype = ss.get("type") or LEAST_ALLOCATED
    res = tuple(
        (r.get("name") or "", int(r.get("weight") or 1))
        for r in (ss.get("resources") or [])
    ) or DEFAULT_RESOURCES
    shape = tuple(
        (int(p.get("utilization") or 0),
         int(p.get("score") or 0) * (MAX_NODE_SCORE // MAX_CUSTOM_PRIORITY_SCORE))
        for p in ((ss.get("requestedToCapacityRatio") or {}).get("shape") or [])
    )
    if stype == REQUESTED_TO_CAPACITY_RATIO and not shape:
        raise ValueError("RequestedToCapacityRatio strategy needs a shape")
    return FitStrategy(stype, res, shape)


def parse_balanced_resources(args: dict | None) -> tuple[str, ...]:
    """NodeResourcesBalancedAllocationArgs carries `resources` at the TOP
    level (upstream wire format); a scoringStrategy wrapper is accepted as
    a fallback for configs written against the NodeResourcesFitArgs
    shape."""
    a = args or {}
    res = a.get("resources")
    if res is None:
        res = (a.get("scoringStrategy") or {}).get("resources") or []
    names = tuple((r.get("name") or "") for r in res)
    return names or ("cpu", "memory")


def _torch_trunc_div(a, b):
    """Go integer division, truncating toward zero (fitscoring.py:124):
    `//` floors, so divide magnitudes and restore the sign."""
    q = torch.abs(a) // torch.abs(b)
    return torch.where((a >= 0) == (b >= 0), q, -q)


def _broken_linear_vec(shape: tuple[tuple[int, int], ...], p):
    out = torch.full_like(p, shape[-1][1])
    for i in range(len(shape) - 1, -1, -1):
        u, s = shape[i]
        if i == 0:
            val = torch.full_like(p, s)
        else:
            up, sp = shape[i - 1]
            val = sp + _torch_trunc_div(
                (s - sp) * (p - up),
                torch.tensor(u - up, dtype=torch.int64, device=p.device))
        out = torch.where(p <= u, val, out)
    return out


def score_resource_vec(strategy: FitStrategy, requested, capacity):
    """[N] int64 per-resource score; `strategy` is fixed per workload."""
    requested = requested.to(torch.int64)
    capacity = capacity.to(torch.int64)
    if strategy.stype == REQUESTED_TO_CAPACITY_RATIO:
        over = (capacity == 0) | (requested > capacity)
        util = torch.where(
            over, MAX_NODE_SCORE,
            requested * MAX_NODE_SCORE // torch.clamp(capacity, min=1))
        return _broken_linear_vec(strategy.shape, util)
    ok = (capacity > 0) & (requested <= capacity)
    cap = torch.clamp(capacity, min=1)
    if strategy.stype == MOST_ALLOCATED:
        return torch.where(ok, requested * MAX_NODE_SCORE // cap, 0)
    return torch.where(ok, (capacity - requested) * MAX_NODE_SCORE // cap, 0)
