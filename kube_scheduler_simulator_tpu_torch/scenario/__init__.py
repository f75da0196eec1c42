"""Scenario-based simulation (KEP-140).

The reference ships only a kubebuilder scaffold for this (an empty
Scenario CRD and a no-op Reconcile,
scenario/api/v1alpha1/scenario_types.go:27-64,
scenario/internal/controller/scenario_controller.go); the real design
lives in keps/140-scenario-based-simulation/README.md.  This package
implements that design against the simulator's cluster store: Scenario
specs with per-MajorStep create/patch/delete/done operations, the
scheduler engine as the SimulationController run to quiescence each
step, and a ScenarioResult timeline recording every operation plus
generated PodScheduled events.

A copy of kube_scheduler_simulator_tpu/scenario/__init__.py.
"""

from .runner import ScenarioService, merge_patch
from .types import (
    PHASE_FAILED,
    PHASE_PAUSED,
    PHASE_PENDING,
    PHASE_RUNNING,
    PHASE_SUCCEEDED,
)

__all__ = [
    "ScenarioService", "merge_patch",
    "PHASE_PENDING", "PHASE_RUNNING", "PHASE_PAUSED",
    "PHASE_SUCCEEDED", "PHASE_FAILED",
]
