"""Replay results -> per-pod result annotations.

Port of kube_scheduler_simulator_tpu/store/decode.py: `decode_pod_result`
(:104) with its PreFilter-reject early-out (:112-130),
`prefilter_reject_message` (:66), `_assemble` (:265), `decode_all` (:306)
and the `_DECODERS` entries (:47) of every default plugin, on the
pure-Python encoder path.
The native C++ codec (native/annotation_codec.cpp, store/native_decode.py)
and the chunk/parallel decoders are a later slice; the Python encoder
writes the same bytes.

Reconstructs exactly what the reference's result store serializes for each
pod (13 JSON blobs):

  * stop-at-first-fail truncation of the filter map;
  * scoring recorded only when >1 node was feasible;
  * score map covers only feasible nodes;
  * PreFilter/PreScore Skip recorded as "";
  * finalscore = normalized score x plugin weight;
  * a pod whose cycle a PreFilter aborted records only the PreFilter
    statuses up to the rejecting plugin.
"""

from __future__ import annotations

from . import annotations as ann
from ..framework.replay import ReplayResult
from ..plugins import (
    affinity, interpod, noderesources, nodevolumelimits, ports, taints,
    topologyspread, volumebinding, volumerestrictions, volumezone,
)

_DECODERS = {
    "NodeResourcesFit": lambda code, node, aux: noderesources.decode_fit_filter(code, aux["schema"]),
    "NodeAffinity": affinity.decode_filter,
    "TaintToleration": taints.decode_taint_filter,
    "NodeUnschedulable": lambda code, node, aux: taints.ERR_UNSCHEDULABLE,
    "NodeName": lambda code, node, aux: taints.ERR_NODE_NAME,
    "NodePorts": lambda code, node, aux: ports.ERR_NODE_PORTS,
    "PodTopologySpread": topologyspread.decode_filter,
    "InterPodAffinity": interpod.decode_filter,
    "VolumeRestrictions": lambda code, node, aux: volumerestrictions.ERR_DISK_CONFLICT,
    "NodeVolumeLimits": lambda code, node, aux: nodevolumelimits.ERR_MAX_VOLUME_COUNT,
    "VolumeBinding": volumebinding.decode_filter,
    "VolumeZone": lambda code, node, aux: volumezone.ERR_VOLUME_ZONE_CONFLICT,
}


def prefilter_reject_message(cw, i: int, dynamic_code: int) -> tuple[str, str] | None:
    """(plugin name, message) of the PreFilter reject that aborted pod i's
    cycle, or None.  As upstream RunPreFilterPlugins: the first rejecting
    plugin in config order wins; within VolumeRestrictions the static
    (PVC-lister) reject precedes the dynamic ReadWriteOncePod conflict."""
    static = cw.host.get("prefilter_reject", {})
    if not static and not dynamic_code:
        return None
    for name in cw.config.prefilters():
        msgs = static.get(name)
        if msgs is not None and msgs[i] is not None:
            return name, msgs[i]
        if name == "VolumeRestrictions" and (dynamic_code & 1):
            return name, volumerestrictions.ERR_RWOP_CONFLICT
    return None


def decode_filter_message(name: str, code: int, node_idx: int, host_aux) -> str:
    return _DECODERS[name](code, node_idx, host_aux)


def decode_pod_result(rr: ReplayResult, i: int) -> dict[str, str]:
    """The 13 plugin annotations for pod i, values JSON-encoded as Go would."""
    cw = rr.cw
    cfg = cw.config
    names = cw.node_table.names
    filter_names = cfg.filters()
    score_names = cfg.scorers()
    fskip = cw.host["filter_skip"]
    sskip = cw.host["score_skip"]

    # --- prefilter reject: the cycle aborted before Filter --------------
    reject = prefilter_reject_message(cw, i, int(rr.prefilter_reject[i]))
    if reject is not None:
        rej_name, rej_msg = reject
        pf: dict[str, str] = {}
        for name in cfg.prefilters():
            if name == rej_name:
                pf[name] = rej_msg
                break
            pf[name] = "" if fskip[name][i] else ann.SUCCESS_MESSAGE
        empty = ann.marshal({})
        out = {key: empty for key in ann.ALL_PLUGIN_KEYS}
        out[ann.PRE_FILTER_STATUS_RESULT] = ann.marshal(pf)
        out[ann.SELECTED_NODE] = ""
        return out

    prefilter_status = {}
    for name in cfg.prefilters():
        prefilter_status[name] = "" if fskip[name][i] else ann.SUCCESS_MESSAGE

    # --- filter (stop at first fail per node) ---------------------------
    active = [
        (f, name) for f, name in enumerate(filter_names) if not fskip[name][i]
    ]
    codes = rr.codes_of(i)  # [F, N]
    filter_map: dict[str, dict[str, str]] = {}
    for n, node in enumerate(names):
        entry = {}
        for f, name in active:
            c = int(codes[f, n])
            if c == 0:
                entry[name] = ann.PASSED_FILTER_MESSAGE
            else:
                entry[name] = decode_filter_message(name, c, n, cw.host)
                break
        if entry:
            filter_map[node] = entry

    # --- score (only when >1 feasible node) -----------------------------
    feasible_count = int(rr.feasible_count[i])
    prescore: dict[str, str] = {}
    score_map: dict[str, dict[str, str]] = {}
    final_map: dict[str, dict[str, str]] = {}
    if feasible_count > 1:
        for name in cfg.prescorers():
            prescore[name] = "" if sskip[name][i] else ann.SUCCESS_MESSAGE
        feasible = rr.feasible_of(i)
        if feasible is None:
            feasible = (codes[[f for f, _ in active], :] == 0).all(axis=0) if active else None
        raw = rr.raw_of(i)
        fin = rr.final_of(i)
        for n, node in enumerate(names):
            if feasible is not None and not feasible[n]:
                continue
            se, fe = {}, {}
            for s, name in enumerate(score_names):
                if sskip[name][i]:
                    continue
                se[name] = str(int(raw[s, n]))
                fe[name] = str(int(fin[s, n]))
            if se:
                score_map[node] = se
                final_map[node] = fe

    return _assemble(cfg, names, rr, i, prefilter_status, prescore,
                     ann.marshal(filter_map), ann.marshal(score_map),
                     ann.marshal(final_map))


def _assemble(cfg, names, rr, i: int, prefilter_status: dict,
              prescore: dict, filter_json: str, score_json: str,
              final_json: str) -> dict[str, str]:
    """Bind-phase maps + the 13-key annotation dict."""
    sel = int(rr.selected[i])
    scheduled = sel >= 0
    bind = {"DefaultBinder": ann.SUCCESS_MESSAGE} if scheduled else {}
    # VolumeBinding is the only default plugin implementing Reserve and
    # PreBind; the reference records "success" for each on the happy path
    reserve: dict[str, str] = {}
    prebind: dict[str, str] = {}
    if scheduled and "VolumeBinding" in cfg.enabled and not cfg.is_custom("VolumeBinding"):
        reserve["VolumeBinding"] = ann.SUCCESS_MESSAGE
        prebind["VolumeBinding"] = ann.SUCCESS_MESSAGE
    empty = ann.marshal({})
    return {
        ann.PRE_FILTER_STATUS_RESULT: ann.marshal(prefilter_status),
        ann.PRE_FILTER_RESULT: empty,
        ann.FILTER_RESULT: filter_json,
        ann.POST_FILTER_RESULT: empty,
        ann.PRE_SCORE_RESULT: ann.marshal(prescore),
        ann.SCORE_RESULT: score_json,
        ann.FINAL_SCORE_RESULT: final_json,
        ann.RESERVE_RESULT: ann.marshal(reserve),
        ann.PERMIT_STATUS_RESULT: empty,
        ann.PERMIT_TIMEOUT_RESULT: empty,
        ann.PRE_BIND_RESULT: ann.marshal(prebind),
        ann.BIND_RESULT: ann.marshal(bind),
        ann.SELECTED_NODE: names[sel] if scheduled else "",
    }


def decode_all(rr: ReplayResult) -> list[dict[str, str]]:
    return [decode_pod_result(rr, i) for i in range(rr.cw.n_pods)]
