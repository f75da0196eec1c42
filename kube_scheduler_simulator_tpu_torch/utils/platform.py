"""Host platform facts.

Port of kube_scheduler_simulator_tpu/utils/platform.py
`effective_cpu_count` (:47).
"""

from __future__ import annotations

import os


def effective_cpu_count() -> int:
    """CPUs actually usable by THIS process: the scheduler affinity mask
    (cgroup cpusets / taskset) when available, else os.cpu_count().
    os.cpu_count() alone reports host logical cores, so a 1-CPU container
    on an 8-core host would wrongly enable the multi-core code paths."""
    try:
        return len(os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return os.cpu_count() or 1
