"""Deprecated: use scheduler.debuggable instead.

A copy of kube_scheduler_simulator_tpu/scheduler/external.py.

API parity with the reference's deprecated pkg/externalscheduler
(reference: simulator/pkg/externalscheduler/external_scheduler.go:39 —
"Deprecated: use debuggablescheduler"), kept so integrations written
against the old name keep working.  CreateOptionForOutOfTreePlugin
(:42-117) registered an out-of-tree plugin with the wrapping machinery;
here it returns the plugin unchanged for passing to
new_scheduler_command(with_plugins=[...]).
"""

from __future__ import annotations

import warnings

from .debuggable import PluginExtender, new_scheduler_command  # noqa: F401


def create_option_for_out_of_tree_plugin(plugin):
    """Deprecated WithPlugin-option analogue: validates the plugin and
    returns it for new_scheduler_command(with_plugins=[...])."""
    warnings.warn(
        "externalscheduler is deprecated; use "
        "kube_scheduler_simulator_tpu_torch.scheduler.debuggable",
        DeprecationWarning,
        stacklevel=2,
    )
    from ..plugins.custom import CustomPlugin

    if not isinstance(plugin, CustomPlugin):
        raise TypeError(f"expected CustomPlugin, got {type(plugin).__name__}")
    return plugin
