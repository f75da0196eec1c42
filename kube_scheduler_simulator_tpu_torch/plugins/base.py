"""Plugin kernel protocol over torch tensors.

Port of kube_scheduler_simulator_tpu/plugins/base.py: a plugin is a module
of plain tensor functions evaluated over ALL nodes at once,

    filter_kernel(static, pod_xs, carry)  -> codes  [N] int32  (0 == pass)
    score_kernel (static, pod_xs, carry)  -> raw    [N] int64
    normalize    (raw, feasible)          -> normed [N] int64
    bind_update  (static, pod_xs, own_carry, sel)   -> own_carry

plus a host-side `build()` that precompiles the workload into static /
per-pod tensors and a `decode_filter()` that maps a failure code back to
the reference's status message.  These plain functions are what the CPU
runs; on the card the whole step is one hand-written kernel
(csrc/step.cu) that computes the same functions.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MAX_NODE_SCORE = 100  # upstream framework.MaxNodeScore


def to_tensor(a, device) -> torch.Tensor:
    """numpy array (or scalar) -> contiguous tensor on `device`, dtype kept
    (a read-only or strided array is copied first)."""
    return torch.from_numpy(np.require(a, requirements=("C", "W"))).to(device)


class CoreCarry(NamedTuple):
    """Shared mutable cluster state (base.py:31): upstream NodeInfo's
    Requested (the Filter path), NonZeroRequested (scoring path, 100m /
    200Mi defaults) and the pod count."""

    requested: torch.Tensor   # [N, R] int64
    nonzero: torch.Tensor     # [N, 2] int64  (cpu milli, memory bytes)
    num_pods: torch.Tensor    # [N] int64


def default_normalize_score(raw, feasible, reverse: bool):
    """upstream helper.DefaultNormalizeScore (int64 exact) over the
    feasible-node subset (base.py:45).  `//` on int64 tensors floors, as
    jnp's does."""
    raw = raw.to(torch.int64)
    return default_normalize_apply(raw, torch.where(feasible, raw, 0).max(), reverse)


def default_normalize_apply(raw, max_count, reverse: bool):
    """DefaultNormalizeScore given max_count, the max of int64 raw over
    the feasible set (0 elsewhere): the node-sharded step reduces it
    across shards first (kernels/mesh.py)."""
    safe_max = torch.clamp(max_count, min=1)
    scaled = raw * MAX_NODE_SCORE // safe_max
    if reverse:
        scaled = MAX_NODE_SCORE - scaled
        # maxCount == 0: all scores set to maxPriority
        return torch.where(max_count == 0, MAX_NODE_SCORE, scaled)
    return torch.where(max_count == 0, raw, scaled)
