from .workloads import make_nodes, make_pods, baseline_config, BASELINE_CONFIGS  # noqa: F401
