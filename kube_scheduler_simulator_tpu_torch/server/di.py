"""DI container: construct all services once, wire dependencies.

Capability parity with the reference DI container (reference:
simulator/server/di/di.go:39-78): scheduler service, snapshot, reset,
resource watcher, resource applier, and — conditionally on config flags —
the one-shot importer, syncer, and replayer.  Extra here: the scheduling
loop thread, which replaces the reference's separate debuggable-scheduler
container by running the tensor engine in-process whenever pods await
scheduling.

Multi-session serving (server/sessions.py): a DIContainer IS the
per-session context — everything it owns (store, reflector, engine,
result store, scheduling loop, service set) is private to one simulated
cluster.  What it does NOT own is shared process-wide by design: the
cross-session fuse coordinator (parallel/fuse.FUSE — sessions of one
workload family share round launches) and the device-result retention
budget (framework/replay._DEVICE_BUDGET — one
KSS_TPU_DEVICE_RESULT_BUDGET_MB pool split into per-session shares).
The `session` argument stamps the engine so waves record under that
session's tracer scope.

A copy of kube_scheduler_simulator_tpu/server/di.py, rewired to the
port: `device` ("cuda" by default, which raises without a card; "cpu"
runs the plain PyTorch path) goes to the engine.  A `kube_config`
import or sync source is dialed through cluster/kubeapi.py
`connect_source` (a kube-apiserver, or a simulator server through
cluster/remote.py) and closed at shutdown, as in the JAX package; a
`source_store` passed in works as there too.
"""

from __future__ import annotations

import threading
import time
import traceback

from ..utils.tracing import TRACER

from ..cluster.store import ADDED, MODIFIED, ObjectStore
from ..config.config import SimulatorConfiguration
from ..framework.engine import SchedulerEngine
from ..scenario.runner import ScenarioService
from ..scheduler.service import SchedulerService
from ..services.importer import OneShotImporter
from ..services.recorder import RecorderService
from ..services.replayer import ReplayerService
from ..services.reset import ResetService
from ..services.resourceapplier import ResourceApplier
from ..services.resourcewatcher import ResourceWatcherService
from ..services.snapshot import SnapshotService
from ..services.syncer import SyncerService
from ..store.reflector import StoreReflector


class SchedulingLoop:
    """Watches pod events and runs scheduling waves for pending pods —
    the in-process analogue of the always-running debuggable-scheduler
    container.  Debounces so a burst of creates compiles as ONE batched
    tensor workload instead of one compile per pod."""

    def __init__(self, store: ObjectStore, engine: SchedulerEngine,
                 debounce: float = 0.05):
        self.store = store
        self.engine = engine
        self.debounce = debounce
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._q = None
        # last wave crash ({time, error, traceback}) — the loop survives
        # engine exceptions, but a silently wedged loop is unobservable;
        # /readyz surfaces this and scheduling_loop_crashes_total counts
        self.last_crash: dict | None = None

    def start(self):
        self._q = self.store.watch("pods")
        threading.Thread(target=self._watch, daemon=True).start()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._q is not None:
            self.store.unwatch("pods", self._q)
            self._q.put(None)
        self._wake.set()

    def kick(self):
        self._wake.set()

    def _watch(self):
        while not self._stop.is_set():
            ev = self._q.get()
            if ev is None:
                return
            _, event_type, obj = ev
            if event_type == ADDED and not ((obj.get("spec") or {}).get("nodeName")):
                self._wake.set()

    def _run(self):
        while not self._stop.is_set():
            self._wake.wait()
            if self._stop.is_set():
                return
            self._wake.clear()
            self._stop.wait(self.debounce)  # batch bursts
            try:
                self.engine.schedule_pending()
            except Exception as e:  # keep the loop alive like a crashed-and-restarted pod
                tb = traceback.format_exc()
                self.last_crash = {
                    "time": time.time(),
                    "error": f"{type(e).__name__}: {e}",
                    "traceback": tb,
                }
                session = getattr(self.engine, "session", None)
                if session is not None:
                    TRACER.inc("scheduling_loop_crashes_total",
                               session=session)
                else:
                    TRACER.count("scheduling_loop_crashes_total")
                traceback.print_exc()


class DIContainer:
    def __init__(self, cfg: SimulatorConfiguration | None = None,
                 source_store: ObjectStore | None = None,
                 start_scheduler: bool = True,
                 session: str | None = None, device="cuda"):
        self.session = session
        self.cfg = cfg or SimulatorConfiguration()
        self.store = ObjectStore(
            extra_resources=getattr(self.cfg, "extra_resources", None))
        # extra GVRs ride the same watch/record/sync surface as the
        # built-in seven (DEFAULT_GVRS + config extraResources)
        from ..cluster.store import DEFAULT_GVRS

        extra_gvrs = [
            spec["resource"]
            for spec in getattr(self.cfg, "extra_resources", None) or []
            if spec.get("resource") not in DEFAULT_GVRS
        ]
        self._gvrs = list(DEFAULT_GVRS) + extra_gvrs
        self.applier = ResourceApplier(self.store)
        self.reflector = StoreReflector(self.store)
        self.engine = SchedulerEngine(self.store, reflector=self.reflector, device=device)
        self.engine.session = session
        initial_scheduler_cfg = self.cfg.initial_scheduler_config()
        self.scheduler_service = SchedulerService(self.engine, initial_scheduler_cfg)
        self.snapshot_service = SnapshotService(self.store, self.scheduler_service)
        self.scenario_service = ScenarioService(self.store, self.engine)
        self.reset_service = ResetService(self.store, self.scheduler_service)
        self.watcher_service = ResourceWatcherService(self.store,
                                                      resources=self._gvrs)

        self.importer = None
        self.syncer = None
        self.replayer = None
        self.recorder = None
        if ((self.cfg.external_import_enabled or self.cfg.resource_sync_enabled)
                and source_store is None and self.cfg.kube_config):
            # the reference builds a client-go config from the kubeConfig
            # field for import/sync sources (config.go:94-98); here that
            # is a real-apiserver REST client (or a simulator URL —
            # connect_source probes)
            from ..cluster.kubeapi import connect_source

            source_store = connect_source(self.cfg.kube_config)
            self._owned_source = source_store
        if self.cfg.external_import_enabled:
            if source_store is None:
                raise ValueError("externalImportEnabled requires a source "
                                 "cluster (kubeConfig or source_store)")
            self.importer = OneShotImporter(source_store, self.applier,
                                            resources=self._gvrs)
        if self.cfg.resource_sync_enabled:
            if source_store is None:
                raise ValueError("resourceSyncEnabled requires a source "
                                 "cluster (kubeConfig or source_store)")
            self.syncer = SyncerService(source_store, self.applier,
                                        resources=self._gvrs)
        if self.cfg.replayer_enabled:
            self.replayer = ReplayerService(self.applier, self.cfg.record_file_path)

        self.scheduling_loop = SchedulingLoop(self.store, self.engine)
        if start_scheduler:
            self.scheduling_loop.start()

    def new_recorder(self, path: str, flush_interval: float = 5.0) -> RecorderService:
        self.recorder = RecorderService(self.store, path, flush_interval,
                                        resources=self._gvrs)
        return self.recorder

    def shutdown(self):
        # interrupt any in-flight write-back/bind backoff FIRST: the
        # retry schedule sleeps up to ~36s and eviction must not ride it
        # out (utils/retry.py stop; the aborted write surfaces as
        # RetryAborted to its wave, which teardown tolerates)
        self.reflector.stop_event.set()
        self.scheduling_loop.stop()
        if self.syncer:
            self.syncer.stop()
        if self.recorder:
            self.recorder.stop()
        src = getattr(self, "_owned_source", None)
        if src is not None:
            # a source THIS container dialed from cfg.kube_config — release
            # its watch threads/sockets (callers own any source they pass)
            if hasattr(src, "close"):
                src.close()
            elif hasattr(src, "stop"):
                src.stop()
