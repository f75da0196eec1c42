"""Simulator configuration: env vars over config.yaml over defaults.

A copy of kube_scheduler_simulator_tpu/config/config.py.  PyYAML is
imported where a file is read, so a process that reads no YAML (the
card's machine may not have the package) never needs it.

Capability parity with the reference config package (reference:
simulator/config/config.go): a versioned SimulatorConfiguration decoded
from ./config.yaml (reference decodes via the k8s scheme with defaulting,
:125-146; fields config/v1alpha1/types.go:23-80), each field overridable
by the same environment variables the reference reads (:148-300):

  PORT, KUBE_APISERVER_URL, KUBE_SCHEDULER_SIMULATOR_ETCD_URL,
  CORS_ALLOWED_ORIGIN_LIST, KUBE_SCHEDULER_CONFIG_PATH,
  EXTERNAL_IMPORT_ENABLED, RESOURCE_SYNC_ENABLED, REPLAYER_ENABLED,
  RECORD_FILE_PATH

and the reference's feature-exclusivity rule: externalImportEnabled,
resourceSyncEnabled and replayerEnabled cannot be enabled together
(:94-96).  etcdURL/kubeApiServerUrl are accepted for config-file
compatibility but unused — the cluster store is in-process here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class SimulatorConfiguration:
    port: int = 1212
    etcd_url: str = ""
    kube_api_server_url: str = ""
    kube_api_host: str = ""
    kube_api_port: int = 3131
    cors_allowed_origin_list: list[str] = field(default_factory=list)
    kube_scheduler_config_path: str = ""
    external_import_enabled: bool = False
    resource_import_label_selector: dict = field(default_factory=dict)
    resource_sync_enabled: bool = False
    replayer_enabled: bool = False
    record_file_path: str = ""
    kube_config: str = ""
    # KWOK `disableKubeScheduler: true` analogue (reference: kwok.yaml:3-8):
    # leave the in-process scheduling loop off so a standalone
    # cmd/scheduler process drives scheduling over the HTTP API
    external_scheduler_enabled: bool = False
    # declarative RESTMapper analogue: additional resource kinds the store
    # (and applier/importer/syncer/recorder/watcher/snapshot on top of it)
    # carries — the reference applies any GVK via dynamic client +
    # RESTMapper (resourceapplier.go:91-194,268-276).  Entries:
    # {resource, kind, namespaced, apiVersion}
    extra_resources: list = field(default_factory=list)

    def validate(self) -> None:
        if sum([self.external_import_enabled, self.resource_sync_enabled,
                self.replayer_enabled]) > 1:
            raise ValueError(
                "externalImportEnabled, resourceSyncEnabled and replayerEnabled "
                "cannot be used simultaneously"
            )

    def initial_scheduler_config(self) -> dict | None:
        """Load the KubeSchedulerConfiguration the simulator boots with
        (reference: config.go:232-257)."""
        if not self.kube_scheduler_config_path:
            return None
        import yaml

        with open(self.kube_scheduler_config_path) as f:
            return yaml.safe_load(f)


def _env_bool(name: str, cur: bool) -> bool:
    v = os.environ.get(name)
    if v is None or v == "":
        return cur
    return v.lower() in ("1", "true", "yes")


def load_config(path: str = "./config.yaml") -> SimulatorConfiguration:
    cfg = SimulatorConfiguration()
    if os.path.exists(path):
        import yaml

        with open(path) as f:
            raw = yaml.safe_load(f) or {}
        cfg.port = int(raw.get("port") or cfg.port)
        cfg.etcd_url = raw.get("etcdURL") or cfg.etcd_url
        cfg.kube_api_server_url = raw.get("kubeApiServerUrl") or cfg.kube_api_server_url
        cfg.cors_allowed_origin_list = raw.get("corsAllowedOriginList") or []
        cfg.kube_scheduler_config_path = raw.get("kubeSchedulerConfigPath") or ""
        cfg.external_import_enabled = bool(raw.get("externalImportEnabled", False))
        cfg.resource_import_label_selector = raw.get("resourceImportLabelSelector") or {}
        cfg.resource_sync_enabled = bool(raw.get("resourceSyncEnabled", False))
        cfg.replayer_enabled = bool(raw.get("replayEnabled", raw.get("replayerEnabled", False)))
        cfg.record_file_path = raw.get("recordFilePath") or ""
        cfg.kube_config = raw.get("kubeConfig") or ""
        cfg.external_scheduler_enabled = bool(raw.get("externalSchedulerEnabled", False))
        cfg.extra_resources = raw.get("extraResources") or []

    env = os.environ
    if env.get("PORT"):
        cfg.port = int(env["PORT"])
    if env.get("KUBE_APISERVER_URL"):
        cfg.kube_api_server_url = env["KUBE_APISERVER_URL"]
    if env.get("KUBE_SCHEDULER_SIMULATOR_ETCD_URL"):
        cfg.etcd_url = env["KUBE_SCHEDULER_SIMULATOR_ETCD_URL"]
    if env.get("CORS_ALLOWED_ORIGIN_LIST"):
        cfg.cors_allowed_origin_list = env["CORS_ALLOWED_ORIGIN_LIST"].split(",")
    if env.get("KUBE_SCHEDULER_CONFIG_PATH"):
        cfg.kube_scheduler_config_path = env["KUBE_SCHEDULER_CONFIG_PATH"]
    cfg.external_import_enabled = _env_bool("EXTERNAL_IMPORT_ENABLED", cfg.external_import_enabled)
    cfg.resource_sync_enabled = _env_bool("RESOURCE_SYNC_ENABLED", cfg.resource_sync_enabled)
    cfg.replayer_enabled = _env_bool("REPLAYER_ENABLED", cfg.replayer_enabled)
    if env.get("RECORD_FILE_PATH"):
        cfg.record_file_path = env["RECORD_FILE_PATH"]
    if env.get("KUBE_CONFIG"):
        cfg.kube_config = env["KUBE_CONFIG"]
    cfg.external_scheduler_enabled = _env_bool(
        "EXTERNAL_SCHEDULER_ENABLED", cfg.external_scheduler_enabled)
    if env.get("EXTRA_RESOURCES"):
        import json

        cfg.extra_resources = json.loads(env["EXTRA_RESOURCES"])

    cfg.validate()
    return cfg
