"""Waiting pods — real Permit "wait" semantics.

A copy of kube_scheduler_simulator_tpu/framework/waiting.py, host code with its
imports rewired to the port.

Upstream, a Permit plugin returning Wait parks the pod in the framework's
waitingPods map; other plugins (or any holder of the framework handle) can
Allow/Reject it per plugin, and an expired timeout rejects the pod
(reference: simulator/scheduler/plugin/wrappedplugin.go:588-620 records
the "wait" status and the timeout into permit-result / permit-result-timeout;
the park/allow/reject machinery is upstream
k8s.io/kubernetes pkg/scheduler/framework/runtime/waiting_pods_map.go).

Here the engine parks the pod in ``SchedulerEngine.waiting_pods`` keyed by
(namespace, name); each waiting plugin may observe the handle via an
optional ``on_waiting(waiting_pod)`` method (the in-process analogue of a
goroutine holding the framework handle), and the engine then blocks until
every pending plugin allowed, any rejected, or the shortest per-plugin
timeout expired.
"""

from __future__ import annotations

import threading
import time


class WaitingPod:
    """Handle for a pod parked by Permit "wait" statuses.

    allow(plugin)/reject(plugin, msg) may be called from any thread (the
    analogue of upstream's WaitingPod interface)."""

    def __init__(self, pod: dict, plugin_timeouts: dict[str, float]):
        self.pod = pod
        now = time.monotonic()
        self._deadlines = {p: now + t for p, t in plugin_timeouts.items()}
        self._rejected: tuple[str, str] | None = None
        self._cv = threading.Condition()

    def pending_plugins(self) -> list[str]:
        with self._cv:
            return list(self._deadlines)

    def allow(self, plugin_name: str) -> None:
        with self._cv:
            self._deadlines.pop(plugin_name, None)
            self._cv.notify_all()

    def reject(self, plugin_name: str, msg: str = "rejected") -> None:
        """First rejection wins (a concurrent second reject cannot
        change the recorded plugin/message); pending deadlines are
        cleared so the handle reads as settled afterwards."""
        with self._cv:
            if self._rejected is None:
                self._rejected = (plugin_name, msg)
            self._deadlines.clear()
            self._cv.notify_all()

    def wait(self) -> tuple[str, str] | None:
        """Block until resolved. None == allowed by everyone; otherwise
        (plugin, message) for an explicit reject or a timeout expiry.

        Timeout selection is deterministic — earliest deadline, then
        plugin name — so the plugin recorded into permit-result-timeout
        is reproducible regardless of dict iteration order; the expiry
        settles the handle (a second wait() returns the same
        rejection)."""
        with self._cv:
            while True:
                if self._rejected is not None:
                    return self._rejected
                if not self._deadlines:
                    return None
                now = time.monotonic()
                expired = sorted(
                    (d, p) for p, d in self._deadlines.items() if d <= now)
                if expired:
                    # upstream: timeout rejects the waiting pod
                    self._rejected = (expired[0][1], "timeout")
                    self._deadlines.clear()
                    return self._rejected
                self._cv.wait(timeout=min(self._deadlines.values()) - now)
