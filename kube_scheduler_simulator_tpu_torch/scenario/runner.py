"""Scenario runner: execute KEP-140 scenarios against the cluster store.

Design source: keps/140-scenario-based-simulation/README.md — the
ScenarioStep clock ("What happens in a single MajorStep"): at each
MajorStep, (1) the step's spec.operations are applied (each successful
resource change advances MinorStep), (2) the SimulationController — here
the tensor scheduler engine — runs until it "can no longer do anything
with the current cluster state", (3) generated events (PodScheduled) are
appended to the result timeline, (4) if the step carries a
DoneOperation the scenario becomes Succeeded; after the last step
without one it becomes Paused (more operations may be added).

Operations are exactly the KEP's four: createOperation, patchOperation
(JSON merge patch, RFC 7386 — the KEP's PatchType default),
deleteOperation, doneOperation.  An operation with zero or multiple of
these set fails the scenario, as specified.

A copy of kube_scheduler_simulator_tpu/scenario/runner.py.
"""

from __future__ import annotations

import copy
import threading

from ..cluster.store import ApiError, ObjectStore
from .types import (
    KIND_TO_RESOURCE,
    PHASE_FAILED,
    PHASE_PAUSED,
    PHASE_PENDING,
    PHASE_RUNNING,
    PHASE_SUCCEEDED,
    STEP_COMPLETED,
    STEP_CONTROLLER_COMPLETED,
    STEP_CONTROLLER_RUNNING,
    STEP_OPERATING,
)

SIMULATOR_VERSION = "kube-scheduler-simulator-tpu/0.1"


class _Cancelled(Exception):
    """The scenario was deleted (or replaced) while its worker ran."""

_OP_FIELDS = ("createOperation", "patchOperation", "deleteOperation", "doneOperation")


def merge_patch(target, patch):
    """RFC 7386 JSON merge patch."""
    if not isinstance(patch, dict):
        return copy.deepcopy(patch)
    if not isinstance(target, dict):
        target = {}
    out = copy.deepcopy(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = merge_patch(out.get(k), v)
    return out


def _op_kind(op: dict) -> str:
    present = [f for f in _OP_FIELDS if op.get(f) is not None]
    if len(present) != 1:
        raise ValueError(
            "operation must set exactly one of createOperation/patchOperation/"
            f"deleteOperation/doneOperation, got {present or 'none'}"
        )
    return present[0]


def _resource_for(type_meta: dict) -> str:
    kind = (type_meta or {}).get("kind") or ""
    resource = KIND_TO_RESOURCE.get(kind)
    if resource is None:
        raise ValueError(f"unsupported kind {kind!r} in scenario operation")
    return resource


class ScenarioService:
    """Holds named scenarios; runs each in a worker thread against the
    store + engine (the KEP's scenario controller + SimulationController
    loop).  The engine is optional — without one, steps only apply
    operations (useful for pure state manipulation)."""

    def __init__(self, store: ObjectStore, engine=None):
        self.store = store
        self.engine = engine
        self._lock = threading.Lock()
        self._scenarios: dict[str, dict] = {}
        self._threads: dict[str, threading.Thread] = {}
        # generation token per live scenario: a worker only writes status/
        # timeline while its token is still current, so deleting a running
        # scenario (and recreating the name) orphans the old worker
        # instead of letting it corrupt the new one
        self._gens: dict[str, object] = {}

    # ------------------------------------------------------------- CRUD

    def create(self, scenario: dict, run: bool = True) -> dict:
        name = ((scenario.get("metadata") or {}).get("name")) or ""
        if not name:
            raise ValueError("scenario needs metadata.name")
        with self._lock:
            if name in self._scenarios:
                raise ValueError(f"scenario {name!r} already exists")
            sc = copy.deepcopy(scenario)
            sc.setdefault("kind", "Scenario")
            sc.setdefault("apiVersion", "simulation.sigs.k8s.io/v1alpha1")
            sc["status"] = {
                "phase": PHASE_PENDING,
                "stepStatus": {"step": {"major": 0, "minor": 0}, "phase": ""},
                "scenarioResult": {
                    "simulatorVersion": SIMULATOR_VERSION,
                    "timeline": {},
                },
            }
            self._scenarios[name] = sc
            token = object()
            self._gens[name] = token
            if run:
                t = threading.Thread(target=self.run, args=(name, token), daemon=True)
                self._threads[name] = t
        if run:
            t.start()
        return copy.deepcopy(sc)

    def get(self, name: str) -> dict:
        with self._lock:
            sc = self._scenarios.get(name)
            if sc is None:
                raise KeyError(name)
            return copy.deepcopy(sc)

    def list(self) -> list[dict]:
        with self._lock:
            return [copy.deepcopy(s) for s in self._scenarios.values()]

    def delete(self, name: str) -> None:
        with self._lock:
            if name not in self._scenarios:
                raise KeyError(name)
            del self._scenarios[name]
            # invalidating the token also cancels the worker at its next
            # step boundary
            self._gens.pop(name, None)
            self._threads.pop(name, None)

    def wait(self, name: str, timeout: float | None = 60) -> dict:
        t = self._threads.get(name)
        if t is not None:
            t.join(timeout)
        return self.get(name)

    # ------------------------------------------------------------- run

    def run(self, name: str, token: object | None = None) -> dict:
        """Execute the scenario to completion (synchronously)."""
        with self._lock:
            sc = self._scenarios.get(name)
            if sc is None:
                raise KeyError(name)
            if token is None:
                token = self._gens.get(name)
            ops = copy.deepcopy((sc.get("spec") or {}).get("operations") or [])
            status = sc["status"]
            status["phase"] = PHASE_RUNNING

        try:
            done = self._run_steps(name, token, ops)
        except _Cancelled:
            return {}
        except Exception as e:
            self._set_status(name, token, phase=PHASE_FAILED, message=str(e))
            return self.get(name)
        self._set_status(
            name, token,
            phase=PHASE_SUCCEEDED if done else PHASE_PAUSED,
            message=None if done else
            "all operations finished without a doneOperation; "
            "operations can still be added",
        )
        try:
            return self.get(name)
        except KeyError:
            return {}

    # ------------------------------------------------------------ steps

    def _set_status(self, name: str, token, phase=None, message=None,
                    step=None, step_phase=None):
        with self._lock:
            sc = self._scenarios.get(name)
            if sc is None or self._gens.get(name) is not token:
                return  # deleted or replaced: the stale worker stays silent
            st = sc["status"]
            if phase is not None:
                st["phase"] = phase
            st["message"] = message
            if step is not None:
                st["stepStatus"]["step"] = step
            if step_phase is not None:
                st["stepStatus"]["phase"] = step_phase

    def _append_timeline(self, name: str, token, major: int, event: dict):
        with self._lock:
            sc = self._scenarios.get(name)
            if sc is None or self._gens.get(name) is not token:
                return
            tl = sc["status"]["scenarioResult"]["timeline"]
            tl.setdefault(str(major), []).append(event)

    def _check_live(self, name: str, token) -> None:
        with self._lock:
            if self._gens.get(name) is not token:
                raise _Cancelled(name)

    def _run_steps(self, name: str, token, ops: list[dict]) -> bool:
        by_step: dict[int, list[dict]] = {}
        for i, op in enumerate(ops):
            op.setdefault("id", f"op-{i}")
            by_step.setdefault(int(op.get("step") or 0), []).append(op)

        for major in sorted(by_step):
            self._check_live(name, token)  # cancelled by delete()
            minor = 0
            self._set_status(name, token, step={"major": major, "minor": minor},
                             step_phase=STEP_OPERATING)
            done_requested = False
            for op in by_step[major]:
                self._check_live(name, token)
                field = _op_kind(op)  # raises -> scenario Failed
                if field == "doneOperation":
                    done_requested = True
                    self._append_timeline(name, token, major, {
                        "id": op["id"],
                        "step": {"major": major, "minor": minor},
                        "done": {"operation": op["doneOperation"]},
                    })
                    continue
                minor += self._apply_op(name, token, major, minor, op, field)

            # SimulationController (the scheduler) runs to quiescence
            if self.engine is not None:
                self._set_status(name, token, step_phase=STEP_CONTROLLER_RUNNING)
                minor = self._run_controller(name, token, major, minor)
                self._set_status(name, token, step_phase=STEP_CONTROLLER_COMPLETED)

            self._set_status(name, token, step={"major": major, "minor": minor},
                             step_phase=STEP_COMPLETED)
            if done_requested:
                return True
        return False

    def _apply_op(self, name, token, major, minor, op, field) -> int:
        """Apply one create/patch/delete operation; returns 1 if a resource
        changed (MinorStep advances on every resource operation)."""
        body = op[field]
        if field == "createOperation":
            obj = body.get("object") or {}
            resource = _resource_for(obj)
            result = self.store.create(resource, obj)
            self._append_timeline(name, token, major, {
                "id": op["id"], "step": {"major": major, "minor": minor},
                "create": {"operation": body, "result": result},
            })
            return 1
        meta = body.get("objectMeta") or {}
        resource = _resource_for(body.get("typeMeta"))
        if field == "patchOperation":
            cur = self.store.get(resource, meta.get("name"), meta.get("namespace"))
            import json as _json

            patch = body.get("patch")
            patch_obj = _json.loads(patch) if isinstance(patch, str) else (patch or {})
            new = merge_patch(cur, patch_obj)
            # identity is immutable under patch
            new.setdefault("metadata", {})["name"] = cur["metadata"]["name"]
            if "namespace" in cur["metadata"]:
                new["metadata"]["namespace"] = cur["metadata"]["namespace"]
            new["metadata"]["resourceVersion"] = cur["metadata"].get("resourceVersion")
            result = self.store.update(resource, new)
            self._append_timeline(name, token, major, {
                "id": op["id"], "step": {"major": major, "minor": minor},
                "patch": {"operation": body, "result": result},
            })
            return 1
        # deleteOperation
        self.store.delete(resource, meta.get("name"), meta.get("namespace"))
        self._append_timeline(name, token, major, {
            "id": op["id"], "step": {"major": major, "minor": minor},
            "delete": {"operation": body},
        })
        return 1

    def _run_controller(self, name, token, major, minor) -> int:
        """Run the scheduler until it can no longer bind anything; emit a
        generated PodScheduled timeline event per newly-bound pod (the
        KEP's generated timeline entries)."""
        before = {
            (p["metadata"].get("namespace") or "default", p["metadata"]["name"])
            for p in self.store.list("pods")[0]
            if (p.get("spec") or {}).get("nodeName")
        }
        while True:
            n = self.engine.schedule_pending()
            if not n:
                break
        gen = 0
        for p in self.store.list("pods")[0]:
            key = (p["metadata"].get("namespace") or "default", p["metadata"]["name"])
            if (p.get("spec") or {}).get("nodeName") and key not in before:
                self._append_timeline(name, token, major, {
                    "id": f"generated-{major}-{minor}",
                    "step": {"major": major, "minor": minor},
                    "podScheduled": {
                        "pod": f"{key[0]}/{key[1]}",
                        "node": p["spec"]["nodeName"],
                    },
                })
                minor += 1
                gen += 1
        return minor
