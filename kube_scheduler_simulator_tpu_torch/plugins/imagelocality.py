"""ImageLocality score function.

Port of kube_scheduler_simulator_tpu/plugins/imagelocality.py: `build`
(:95, with the host copy of the row in `static_score_rows`, :105),
`score_kernel` :109, and the scalar helpers `calculate_priority` :66 and
`score_for` :79.  On the card the kernel reads the row (csrc/pod.cuh
score_raw), weighted into the total like every scorer.

Upstream v1.32 `imagelocality`: Score only (no Filter, no NormalizeScore).

    sumScores = Σ over the pod's (init)containers whose image exists on
                the node of  size_bytes * (nodes_having_image / total_nodes)
    score     = 100 * (clamp(sumScores, min, max) - min) / (max - min)
    min       = 23 MB * numContainers,  max = 1000 MB * numContainers

Node images never change during a replay, so the whole score precompiles
to a static [P, N] int64 tensor; pods with the same images and container
count share one row computation.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .base import to_tensor

NAME = "ImageLocality"

MB = 1024 * 1024
MIN_THRESHOLD = 23 * MB
MAX_CONTAINER_THRESHOLD = 1000 * MB
MAX_NODE_SCORE = 100


class ImageXS(NamedTuple):
    score: torch.Tensor  # [P, N] int64, precomputed


def normalized_image_name(name: str) -> str:
    """upstream normalizedImageName: append :latest when untagged."""
    if name.rfind(":") <= name.rfind("/") and "@" not in name:
        name += ":latest"
    return name


def node_image_states(nodes: list[dict]) -> dict[str, tuple[int, set[int]]]:
    """image name -> (size_bytes, node indices having it)."""
    states: dict[str, tuple[int, set[int]]] = {}
    for j, node in enumerate(nodes):
        for img in ((node.get("status") or {}).get("images")) or []:
            size = int(img.get("sizeBytes") or 0)
            for nm in img.get("names") or []:
                nm = normalized_image_name(nm)
                # first-seen size wins, like nodeinfo's imageStates
                _, have = states.setdefault(nm, (size, set()))
                have.add(j)
    return states


def pod_images(pod: dict) -> tuple[list[str], int]:
    """(normalized image names, container count incl. init containers)."""
    spec = pod.get("spec") or {}
    containers = (spec.get("initContainers") or []) + (spec.get("containers") or [])
    return [
        normalized_image_name(c.get("image") or "") for c in containers if c.get("image")
    ], len(containers)


def calculate_priority(sum_scores: int, num_containers: int) -> int:
    max_threshold = MAX_CONTAINER_THRESHOLD * num_containers
    if sum_scores < MIN_THRESHOLD:
        sum_scores = MIN_THRESHOLD
    elif sum_scores > max_threshold:
        sum_scores = max_threshold
    return MAX_NODE_SCORE * (sum_scores - MIN_THRESHOLD) // (max_threshold - MIN_THRESHOLD)


def score_for(pod: dict, states, n_nodes: int) -> np.ndarray:
    """[N] int64 ImageLocality score of one pod: `calculate_priority` at
    every node, vectorized (every operand is a non-negative int64, so
    numpy's // is Python's)."""
    images, num_containers = pod_images(pod)
    out = np.zeros(n_nodes, dtype=np.int64)
    if not images or num_containers == 0:
        return out
    sums = np.zeros(n_nodes, dtype=np.int64)
    for nm in images:
        st = states.get(nm)
        if st is None:
            continue
        size, have = st
        scaled = int(float(size) * (float(len(have)) / float(n_nodes)))
        sums[np.fromiter(have, dtype=np.int64, count=len(have))] += scaled
    max_threshold = MAX_CONTAINER_THRESHOLD * num_containers
    clamped = np.clip(sums, MIN_THRESHOLD, max_threshold)
    return MAX_NODE_SCORE * (clamped - MIN_THRESHOLD) // (max_threshold - MIN_THRESHOLD)


def build(nodes: list[dict], pods: list[dict], host_out: dict | None = None,
          device="cpu") -> ImageXS:
    states = node_image_states(nodes)
    n = len(nodes)
    score = np.zeros((len(pods), n), dtype=np.int64)
    rows: dict[tuple, np.ndarray] = {}
    for i, pod in enumerate(pods):
        images, num_containers = pod_images(pod)
        key = (tuple(images), num_containers)
        if key not in rows:
            rows[key] = score_for(pod, states, n)
        score[i] = rows[key]
    if host_out is not None:
        # score_kernel is a pure pass-through of this precompiled row: the
        # compact replay keeps it host-resident ("host" group, never fetched)
        host_out.setdefault("static_score_rows", {})[NAME] = score
    return ImageXS(score=to_tensor(score, device))


def score_kernel(sl: ImageXS) -> torch.Tensor:
    return sl.score.to(torch.int64)
