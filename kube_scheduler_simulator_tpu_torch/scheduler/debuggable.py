"""Debuggable-scheduler library: embed custom plugins and hooks.

A copy of kube_scheduler_simulator_tpu/scheduler/debuggable.py without
`new_scheduler_command` (:131-162), which builds the HTTP server: the
port's serving layers are ROADMAP Queue A item 10.  The hooks below are
what the engine reads.

API parity with the reference's integration library
(reference: simulator/pkg/debuggablescheduler/command.go:14-75):

    NewSchedulerCommand(WithPlugin(...), WithPluginExtenders(...))

becomes

    di, server = new_scheduler_command(
        with_plugins=[MyPlugin()],
        with_plugin_extenders={"NodeResourcesFit": MyExtender()},
        config=<KubeSchedulerConfiguration dict>, port=1212)

Custom plugins (plugins/custom.py) with filter or score rows are not
ported yet (compile_workload raises for them); plugin extenders are host-side hooks with the reference's PluginExtenders
semantics (wrappedplugin.go:159-171) applied per extension point around
the decode/commit of each pod's cycle, plus the AddCustomResult debugging
flow (resultstore/store.go:617-626).  When any registered extender
intercepts (or a custom plugin has NormalizeScore), the engine schedules
that profile on the host-interleaved path so hook outcomes really affect
placement.
"""

from __future__ import annotations


class PluginExtender:
    """Host-side hooks around one plugin's extension points, mirroring the
    reference's Before/After contract (wrappedplugin.go — e.g. Score():
    BeforeScore non-success short-circuits BEFORE the original plugin runs
    and nothing is recorded; the store records the ORIGINAL result; the
    After return value replaces what the framework sees, leaving the
    record untouched):

      before_filter(pod, node_name) -> str | None
          non-None message: the plugin is skipped for that node, nothing
          is recorded for it (or any later filter plugin) on that node,
          and the node is infeasible.
      after_filter(pod, node_name, msg: str | None) -> str | None
          msg is the plugin's own outcome (None == passed). Return a
          message to make the node infeasible (or None to pass) — the
          framework obeys, the record keeps the plugin's own result.
      before_score(pod, node_name) -> str | None
          non-None message: the scoring cycle errors, the pod fails this
          cycle (upstream RunScorePlugins error), nothing recorded.
      after_score(pod, node_name, score: int) -> int
          the returned score feeds normalization/selection; the
          score-result record keeps the original, while finalscore-result
          reflects this value (the store records normalize's output,
          which runs on the After-modified scores).
      after_normalize(pod, scores: dict[str, int]) -> dict[str, int] | None
          rewrite the normalized per-node scores the framework ranks by;
          records (written before AfterNormalize upstream) are untouched.
      before_reserve / after_reserve, before_permit / after_permit,
      before_pre_bind / after_pre_bind (custom lifecycle plugins only):
          before_* -> str | None: non-None rejects without running or
          recording the plugin; after_*(pod, node, msg) -> str | None:
          rewrite the framework outcome, record keeps the plugin's own.
      before_post_bind / after_post_bind: observers.

      after_cycle(pod, annotations, result_store): called after the
      cycle's results are decoded and deposited, before the reflector
      writes them back; add custom annotations via
      result_store.add_custom_result(ns, name, key, value).
    """

    def before_filter(self, pod: dict, node_name: str):
        return None

    def after_filter(self, pod: dict, node_name: str, msg):
        return msg

    def before_score(self, pod: dict, node_name: str):
        return None

    def after_score(self, pod: dict, node_name: str, score: int) -> int:
        return score

    def after_normalize(self, pod: dict, scores: dict):
        return None

    def before_reserve(self, pod: dict, node: dict):
        return None

    def after_reserve(self, pod: dict, node: dict, msg):
        return msg

    def before_permit(self, pod: dict, node: dict):
        return None

    def after_permit(self, pod: dict, node: dict, out):
        return out

    def before_pre_bind(self, pod: dict, node: dict):
        return None

    def after_pre_bind(self, pod: dict, node: dict, msg):
        return msg

    def before_post_bind(self, pod: dict, node: dict) -> None:
        pass

    def after_post_bind(self, pod: dict, node: dict) -> None:
        pass

    def after_cycle(self, pod: dict, annotations: dict[str, str], result_store) -> None:
        pass


_CYCLE_HOOKS = (
    "before_filter", "after_filter", "before_score", "after_score",
    "after_normalize",
)


def has_hook(ext, name: str) -> bool:
    """True when `ext` overrides hook `name` (works for non-subclasses
    too: any defined method that isn't the PluginExtender default counts;
    an absent method never does)."""
    m = getattr(type(ext), name, None)
    return m is not None and m is not getattr(PluginExtender, name)


def intercepts_cycle(ext) -> bool:
    """Does this extender override any filter/score/normalize hook (and so
    require the host-interleaved scheduling path)?"""
    return any(has_hook(ext, h) for h in _CYCLE_HOOKS)
