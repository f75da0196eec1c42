from .workloads import (  # noqa: F401
    make_nodes, make_pods, baseline_config, BASELINE_CONFIGS, SLOT_LABEL,
    make_slot_pinned_workload, make_gang_workload, make_nodes_columnar,
    make_pods_columnar, make_churn_workload)
