"""Reset service: restore the cluster to its boot state.

Capability parity with the reference reset service (reference:
simulator/reset/reset.go): at construction it snapshots ALL keys of the
backing store (the etcd-prefix dump, :32-55); Reset() deletes the prefix,
re-puts the initial keys, and resets the scheduler configuration to its
initial value (:57-85).  The reference does this through direct etcd
access bypassing the apiserver; here the store IS the etcd analogue, and
its restore() emits watch events so connected UIs converge.

A copy of kube_scheduler_simulator_tpu/services/reset.py.
"""

from __future__ import annotations

from ..cluster.store import ObjectStore


class ResetService:
    def __init__(self, store: ObjectStore, scheduler_service):
        self.store = store
        self.scheduler = scheduler_service
        self._initial = store.dump()
        self._initial_config = scheduler_service.get_config()

    def reset(self) -> None:
        self.store.restore(self._initial)
        self.scheduler.restart_scheduler(self._initial_config)
