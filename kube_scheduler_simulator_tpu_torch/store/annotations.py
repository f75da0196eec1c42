"""Result annotation keys — exact parity with the reference.

A copy of kube_scheduler_simulator_tpu/store/annotations.py.

reference: simulator/scheduler/plugin/annotation/annotation.go:3-30 (13
plugin keys), simulator/scheduler/extender/annotation/annotation.go:3-12
(4 extender keys), simulator/scheduler/storereflector/annotation.go:4
(result history).
"""

PREFIX = "kube-scheduler-simulator.sigs.k8s.io/"

PRE_FILTER_STATUS_RESULT = PREFIX + "prefilter-result-status"
PRE_FILTER_RESULT = PREFIX + "prefilter-result"
FILTER_RESULT = PREFIX + "filter-result"
POST_FILTER_RESULT = PREFIX + "postfilter-result"
PRE_SCORE_RESULT = PREFIX + "prescore-result"
SCORE_RESULT = PREFIX + "score-result"
FINAL_SCORE_RESULT = PREFIX + "finalscore-result"
RESERVE_RESULT = PREFIX + "reserve-result"
PERMIT_STATUS_RESULT = PREFIX + "permit-result"
PERMIT_TIMEOUT_RESULT = PREFIX + "permit-result-timeout"
PRE_BIND_RESULT = PREFIX + "prebind-result"
BIND_RESULT = PREFIX + "bind-result"
SELECTED_NODE = PREFIX + "selected-node"

EXTENDER_FILTER_RESULT = PREFIX + "extender-filter-result"
EXTENDER_PRIORITIZE_RESULT = PREFIX + "extender-prioritize-result"
EXTENDER_PREEMPT_RESULT = PREFIX + "extender-preempt-result"
EXTENDER_BIND_RESULT = PREFIX + "extender-bind-result"

RESULT_HISTORY = PREFIX + "result-history"

# messages, reference: simulator/scheduler/plugin/resultstore/store.go:26-35
PASSED_FILTER_MESSAGE = "passed"
SUCCESS_MESSAGE = "success"
WAIT_MESSAGE = "wait"
POST_FILTER_NOMINATED_MESSAGE = "preemption victim"

# the apiserver's total annotation size limit the reflector trims history
# to (reference: storereflector.go:177-190, validation.TotalAnnotationSizeLimitB)
TOTAL_ANNOTATION_SIZE_LIMIT = 256 * 1024

ALL_PLUGIN_KEYS = [
    PRE_FILTER_STATUS_RESULT, PRE_FILTER_RESULT, FILTER_RESULT,
    POST_FILTER_RESULT, PRE_SCORE_RESULT, SCORE_RESULT, FINAL_SCORE_RESULT,
    RESERVE_RESULT, PERMIT_STATUS_RESULT, PERMIT_TIMEOUT_RESULT,
    PRE_BIND_RESULT, BIND_RESULT, SELECTED_NODE,
]


def marshal(obj) -> str:
    """Go encoding/json-compatible: compact, map keys sorted, HTML-escaped.

    Go escapes < > & to \\u003c \\u003e \\u0026 by default; scheduler
    messages and k8s names never contain them, but match anyway.
    """
    import json

    s = json.dumps(obj, sort_keys=True, separators=(",", ":"), ensure_ascii=False)
    return s.replace("<", "\\u003c").replace(">", "\\u003e").replace("&", "\\u0026")
