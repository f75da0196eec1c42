"""Guest plugins: config-declared out-of-tree plugins loaded at restart.

A copy of kube_scheduler_simulator_tpu/scheduler/guest.py.  A guest for
the port subclasses this package's `CustomPlugin`
(kube_scheduler_simulator_tpu_torch.plugins.custom); it is registered
under kube_scheduler_simulator_tpu_torch.guests.{name}.

The wasm-extension analogue (reference: simulator/scheduler/config/wasm.go
RegisterWasmPlugins:14-28, getWasmRegistryFromUnversionedConfig:31-58):
the reference scans every profile's pluginConfig for args that decode as
a wasm PluginConfig (i.e. carry a guest URL), then registers a factory
for each such name that is also multiPoint-enabled, so users can add
plugins to a RUNNING simulator via configuration alone — no recompile.

Here the guest is a Python module instead of a wasm binary (the same
"external program file loaded at config time" capability): a pluginConfig
entry whose args carry `guestURL` (or `guestPath`) pointing at a .py file
is loaded with importlib and must provide either

    class Plugin(CustomPlugin): ...          # class named Plugin, or
    def plugin(name, args) -> CustomPlugin:  # a factory

The loaded object enters the tensor pipeline as a custom plugin
(plugins/custom.py): filter/score evaluated host-side per (pod, node) at
workload-compile time, results recorded with full annotation parity.
Like the reference, only multiPoint-enabled names are registered; a
guestURL naming a missing file fails the restart (and the service rolls
back to the previous config, scheduler.go:102-108 semantics).
"""

from __future__ import annotations

import importlib.util
import sys

from ..plugins.custom import CustomPlugin


def _guest_path(args: dict) -> str | None:
    url = args.get("guestURL") or args.get("guestPath") or ""
    if not url:
        return None
    if url.startswith("file://"):
        return url[len("file://"):]
    if "://" in url:
        raise ValueError(
            f"guestURL {url!r}: only local file paths / file:// URLs are "
            "supported (no network egress)"
        )
    return url


def load_guest_plugin(name: str, path: str, args: dict) -> CustomPlugin:
    spec = importlib.util.spec_from_file_location(
        f"kube_scheduler_simulator_tpu_torch.guests.{name}", path
    )
    if spec is None or spec.loader is None:
        raise ValueError(f"guest plugin {name}: cannot load {path!r}")
    mod = importlib.util.module_from_spec(spec)
    # registered so the guest can import itself / use dataclasses etc.
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)

    if hasattr(mod, "plugin"):
        p = mod.plugin(name, args)
    elif hasattr(mod, "Plugin"):
        p = mod.Plugin()
    else:
        raise ValueError(
            f"guest plugin {name}: {path!r} defines neither a `plugin(name, "
            "args)` factory nor a `Plugin` class"
        )
    if not isinstance(p, CustomPlugin):
        raise ValueError(
            f"guest plugin {name}: {path!r} must produce a CustomPlugin, "
            f"got {type(p).__name__}"
        )
    p.name = name  # the config's name wins, as with wasm.PluginFactory(name)
    return p


def collect_guest_plugins(cfg: dict | None) -> dict[str, CustomPlugin]:
    """Scan a KubeSchedulerConfiguration for guest plugin configs and load
    each one that is multiPoint-enabled (the reference's two-step scan,
    wasm.go:34-55)."""
    out: dict[str, CustomPlugin] = {}
    for profile in (cfg or {}).get("profiles") or []:
        guests: dict[str, dict] = {}
        for pc in profile.get("pluginConfig") or []:
            args = pc.get("args") or {}
            path = _guest_path(args)
            if path is None:
                continue  # not a guest plugin config
            if pc.get("name"):
                guests[pc["name"]] = {"path": path, "args": args}
        if not guests:
            continue
        mp = (profile.get("plugins") or {}).get("multiPoint") or {}
        enabled = {p.get("name") for p in mp.get("enabled") or []}
        for name, g in guests.items():
            if name in enabled:
                out[name] = load_guest_plugin(name, g["path"], g["args"])
    return out
