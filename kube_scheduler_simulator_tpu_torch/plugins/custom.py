"""Out-of-tree (custom) plugins — the WithPlugin analogue.

A copy of kube_scheduler_simulator_tpu/plugins/custom.py without its
device rows (`CustomXS`, `build_custom`, :123-158): the port compiles a
custom plugin that neither filters nor scores (its lifecycle points,
QueueSort and Coscheduling run on the host); one with filter/score rows
raises NotImplementedError in `compile_workload` until those rows land
in the kernels (ROADMAP Queue A).

The reference lets users build a debuggable scheduler embedding their own
plugins (reference: simulator/pkg/debuggablescheduler/command.go:64-75
WithPlugin/WithPluginExtenders; the wrapping machinery then records their
results like any in-tree plugin).  Here a custom plugin is a Python object:

    class MyPlugin(CustomPlugin):
        name = "MyPlugin"
        default_weight = 1
        def filter(self, pod, node) -> str | None: ...   # None == pass
        def score(self, pod, node) -> int: ...
        def normalize(self, scores: list[int]) -> list[int]: ...  # optional

Because the tensor pipeline precompiles the workload, custom plugin
results are evaluated host-side ONCE per (pod, node) at compile time and
enter the device program as dense arrays — exactly like the in-tree
label-based plugins.  The contract (documented divergence from the
reference, docs/SEMANTICS.md): custom filter/score must be pure functions
of (pod manifest, node manifest); they do not observe in-flight bind state.
Custom messages are interned per plugin; "passed"/"success" recording
follows the shim semantics (wrappedplugin.go:523-548).

Plugin extenders (Before/After hooks with AddCustomResult) run in the
engine around each pod's cycle; see scheduler/debuggable.py.
"""

from __future__ import annotations


class CustomPlugin:
    name: str = "CustomPlugin"
    default_weight: int = 1

    # presence of overridden methods decides the extension points
    def filter(self, pod: dict, node: dict) -> str | None:  # pragma: no cover
        raise NotImplementedError

    def score(self, pod: dict, node: dict) -> int:  # pragma: no cover
        raise NotImplementedError

    def normalize(self, scores: list[int]) -> list[int]:
        return list(scores)

    # host-side lifecycle extension points, run around the bind of the
    # pod's winning node (the reference wraps these for out-of-tree
    # plugins too, wrappedplugin.go:588-752); statuses are recorded into
    # the reserve/permit/prebind result annotations
    def reserve(self, pod: dict, node: dict) -> str | None:  # pragma: no cover
        """None == success; a message rejects (Unreserve runs)."""
        raise NotImplementedError

    def unreserve(self, pod: dict, node: dict) -> None:  # pragma: no cover
        raise NotImplementedError

    def permit(self, pod: dict, node: dict):  # pragma: no cover
        """None == allow; ("wait", timeout_str) records wait then allows
        (docs/SEMANTICS.md); a message denies."""
        raise NotImplementedError

    def pre_bind(self, pod: dict, node: dict) -> str | None:  # pragma: no cover
        """None == success; a message fails the bind."""
        raise NotImplementedError

    def post_bind(self, pod: dict, node: dict) -> None:  # pragma: no cover
        raise NotImplementedError

    def less(self, pod_a: dict, pod_b: dict) -> bool:  # pragma: no cover
        """QueueSort extension point: True when pod_a should be scheduled
        before pod_b.  A custom plugin overriding this replaces the
        default PrioritySort queue order, the way the reference wraps a
        user QueueSort plugin (wrappedplugin.go:754-771
        wrappedPluginWithQueueSort; upstream allows exactly one enabled
        QueueSort plugin)."""
        raise NotImplementedError

    @property
    def has_queue_sort(self) -> bool:
        return type(self).less is not CustomPlugin.less

    @property
    def has_filter(self) -> bool:
        return type(self).filter is not CustomPlugin.filter

    @property
    def has_score(self) -> bool:
        return type(self).score is not CustomPlugin.score

    @property
    def has_normalize(self) -> bool:
        return type(self).normalize is not CustomPlugin.normalize

    @property
    def has_reserve(self) -> bool:
        return type(self).reserve is not CustomPlugin.reserve

    @property
    def has_unreserve(self) -> bool:
        return type(self).unreserve is not CustomPlugin.unreserve

    @property
    def has_permit(self) -> bool:
        return type(self).permit is not CustomPlugin.permit

    @property
    def has_pre_bind(self) -> bool:
        return type(self).pre_bind is not CustomPlugin.pre_bind

    @property
    def has_post_bind(self) -> bool:
        return type(self).post_bind is not CustomPlugin.post_bind

    @property
    def has_lifecycle(self) -> bool:
        return (self.has_reserve or self.has_permit or self.has_pre_bind
                or self.has_post_bind)
