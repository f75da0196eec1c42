"""Scenario phases and step phases (KEP-140,
keps/140-scenario-based-simulation/README.md ScenarioPhase/StepPhase).

A copy of kube_scheduler_simulator_tpu/scenario/types.py.
"""

PHASE_PENDING = "Pending"
PHASE_RUNNING = "Running"
PHASE_PAUSED = "Paused"      # all operations done but no DoneOperation yet
PHASE_SUCCEEDED = "Succeeded"
PHASE_FAILED = "Failed"
PHASE_UNKNOWN = "Unknown"

STEP_OPERATING = "Operating"
STEP_OPERATING_COMPLETED = "OperatingCompleted"
STEP_CONTROLLER_RUNNING = "ControllerRunning"
STEP_CONTROLLER_COMPLETED = "ControllerCompleted"
STEP_COMPLETED = "Finished"

# resource-kind mapping for operation objects (kind -> store resource).
# PodGroup rides the generic-GVR registration (framework/gang.py
# ensure_podgroup_resource / config extraResources) — scenarios can
# create gangs directly (docs/gang-scheduling.md).
KIND_TO_RESOURCE = {
    "Namespace": "namespaces",
    "PriorityClass": "priorityclasses",
    "StorageClass": "storageclasses",
    "PersistentVolumeClaim": "persistentvolumeclaims",
    "Node": "nodes",
    "PersistentVolume": "persistentvolumes",
    "Pod": "pods",
    "PodGroup": "podgroups",
}
