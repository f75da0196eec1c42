"""Replay results -> per-pod result annotations.

Port of kube_scheduler_simulator_tpu/store/decode.py: `_native_ctx`
(:36), `decode_pod_result` (:91) with its PreFilter-reject early-out,
`prefilter_reject_message` (:66), `_marshal_small` and `_assemble`
(:250-303), `decode_all` (:306), the chunk decoders `_decode_pool`
(:293), `_chunk_skip_mask` (:303), `_assemble_chunk` (:332),
`_decode_chunk_native` (:362), `decode_chunk_into` (:383),
`_decode_path_label` (:407), `_decode_chunk_into` (:419),
`decode_release_batches` (:460) and `decode_all_parallel` (:535), and the
`_DECODERS` entries (:47) of every default plugin, and a custom plugin's
interned messages (:87).

Decoder ladder: the chunk-granular native call (one GIL-released C call
per compact chunk, a C-side worker pool) -> the per-pod fused native
decode -> the pure-Python encoder, which KSS_TPU_DISABLE_NATIVE=1 selects
(or a workload whose messages the codec cannot tabulate).  All three write
the same bytes.  A codec that cannot be built raises.

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

import threading

import numpy as np

from . import annotations as ann
from ..framework.replay import ReplayResult
from ..utils.env import native_disabled
from ..utils.faults import fault_point
from ..utils.platform import effective_cpu_count
from ..utils.tracing import TRACER
from ..plugins import (
    affinity, interpod, noderesources, nodevolumelimits, ports, taints,
    topologyspread, volumebinding, volumerestrictions, volumezone,
)

def _native_ctx(cw):
    """The workload's native codec context, built once and kept in
    cw.host; None selects the Python encoder (KSS_TPU_DISABLE_NATIVE=1, or
    messages the codec cannot tabulate).  A codec that cannot be built
    raises."""
    if native_disabled():
        return None
    if "_native_ctx" not in cw.host:
        from . import native_decode

        cw.host["_native_ctx"] = native_decode.build_context(cw)
    return cw.host["_native_ctx"]


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
    dec = _DECODERS.get(name)
    if dec is None:  # custom plugin: interned message table
        return host_aux["custom_msgs"][name][code - 1]
    return dec(code, node_idx, host_aux)


def decode_pod_result(rr: ReplayResult, i: int, feasible_override=None,
                      host_index: int | None = None) -> dict[str, str]:
    """The 13 plugin annotations for pod i, values JSON-encoded as Go would.

    feasible_override: [N] bool — the extender path narrows feasibility
    after the plugin filters (upstream scores only nodes that survive the
    extender Filter round-trip too); it replaces the feasibility derived
    from the filter codes for the score maps.
    host_index: index into the CompiledWorkload's per-pod host tables
    (skip flags, static prefilter rejects) when it differs from `i` — the
    engine's host path builds single-row ReplayResults (i=0) against the
    full workload's cw."""
    cw = rr.cw
    hi = i if host_index is None else host_index
    cfg = cw.config
    names = cw.node_table.names
    filter_names = cfg.filters()
    score_names = cfg.scorers()
    fskip = cw.host["filter_skip"]
    sskip = cw.host["score_skip"]

    # --- prefilter reject: the cycle aborted before Filter --------------
    reject = prefilter_reject_message(cw, hi, int(rr.prefilter_reject[i]))
    if reject is not None:
        rej_name, rej_msg = reject
        pf: dict[str, str] = {}
        for name in cfg.prefilters():
            if name == rej_name:
                pf[name] = rej_msg
                break
            pf[name] = "" if fskip[name][hi] else ann.SUCCESS_MESSAGE
        empty = _marshal_small({})
        out = {key: empty for key in ann.ALL_PLUGIN_KEYS}
        out[ann.PRE_FILTER_STATUS_RESULT] = _marshal_small(pf)
        out[ann.SELECTED_NODE] = ""
        return out

    prefilter_status = {}
    for name in cfg.prefilters():
        prefilter_status[name] = "" if fskip[name][hi] else ann.SUCCESS_MESSAGE

    native_ctx = _native_ctx(cw)

    # --- fused native path (compact replay layout only) -----------------
    if native_ctx is not None and rr._compact is not None and feasible_override is None:
        from . import native_decode

        feasible_count = int(rr.feasible_count[i])
        filter_json, score_json, final_json = native_decode.decode_pod_fused(
            native_ctx, rr, i, hi, feasible_count > 1)
        prescore = {}
        if feasible_count > 1:
            for name in cfg.prescorers():
                prescore[name] = "" if sskip[name][hi] else ann.SUCCESS_MESSAGE
        return _assemble(cfg, names, rr, i, prefilter_status, prescore,
                         filter_json, score_json, final_json)

    # --- filter (stop at first fail per node) ---------------------------
    active = [
        (f, name) for f, name in enumerate(filter_names) if not fskip[name][hi]
    ]
    codes = rr.codes_of(i)  # [F, N]
    filter_json: str | None = None
    if native_ctx is not None:
        from . import native_decode

        active_mask = np.asarray([not fskip[name][hi] for name in filter_names], np.uint8)
        filter_json = native_decode.encode_filter(native_ctx, codes, active_mask)
    else:
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
    score_json: str | None = None
    final_json: str | None = None
    if feasible_count > 1:
        for name in cfg.prescorers():
            prescore[name] = "" if sskip[name][hi] else ann.SUCCESS_MESSAGE
        feasible = rr.feasible_of(i)
        if feasible is None:
            feasible = (codes[[f for f, _ in active], :] == 0).all(axis=0) if active else None
        if feasible_override is not None:
            feasible = feasible_override
        raw = rr.raw_of(i)
        fin = rr.final_of(i)
        if native_ctx is not None:
            from . import native_decode

            sskip_mask = np.asarray([bool(sskip[name][hi]) for name in score_names], np.uint8)
            feas = (np.ones(len(names), np.uint8) if feasible is None
                    else np.asarray(feasible, np.uint8))
            score_json = native_decode.encode_scores(native_ctx, raw, sskip_mask, feas)
            final_json = native_decode.encode_scores(native_ctx, fin, sskip_mask, feas)
        else:
            for n, node in enumerate(names):
                if feasible is not None and not feasible[n]:
                    continue
                se, fe = {}, {}
                for s, name in enumerate(score_names):
                    if sskip[name][hi]:
                        continue
                    se[name] = str(int(raw[s, n]))
                    fe[name] = str(int(fin[s, n]))
                if se:
                    score_map[node] = se
                    final_map[node] = fe

    return _assemble(
        cfg, names, rr, i, prefilter_status, prescore,
        filter_json if filter_json is not None else ann.marshal(filter_map),
        score_json if score_json is not None else ann.marshal(score_map),
        final_json if final_json is not None else ann.marshal(final_map))


_MARSHAL_CACHE: dict = {}


def _marshal_small(d: dict) -> str:
    """marshal() memoized for the tiny per-pod status maps: they repeat
    across pods (a handful of distinct skip patterns per workload)."""
    key = tuple(sorted(d.items()))
    s = _MARSHAL_CACHE.get(key)
    if s is None:
        if len(_MARSHAL_CACHE) > 4096:
            _MARSHAL_CACHE.clear()
        s = _MARSHAL_CACHE.setdefault(key, ann.marshal(d))
    return s


def _assemble(cfg, names, rr, i: int, prefilter_status: dict,
              prescore: dict, filter_json: str, score_json: str | None,
              final_json: str | None) -> dict[str, str]:
    """Bind-phase maps + the 13-key annotation dict (every decode path)."""
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
    empty = _marshal_small({})
    return {
        ann.PRE_FILTER_STATUS_RESULT: _marshal_small(prefilter_status),
        ann.PRE_FILTER_RESULT: empty,
        ann.FILTER_RESULT: filter_json,
        ann.POST_FILTER_RESULT: empty,
        ann.PRE_SCORE_RESULT: _marshal_small(prescore),
        ann.SCORE_RESULT: score_json if score_json is not None else empty,
        ann.FINAL_SCORE_RESULT: final_json if final_json is not None else empty,
        ann.RESERVE_RESULT: _marshal_small(reserve),
        ann.PERMIT_STATUS_RESULT: empty,
        ann.PERMIT_TIMEOUT_RESULT: empty,
        ann.PRE_BIND_RESULT: _marshal_small(prebind),
        ann.BIND_RESULT: _marshal_small(bind),
        ann.SELECTED_NODE: names[sel] if scheduled else "",
    }


def decode_all(rr: ReplayResult) -> list[dict[str, str]]:
    return [decode_pod_result(rr, i) for i in range(rr.cw.n_pods)]


_DECODE_POOL = None
_DECODE_POOL_LOCK = threading.Lock()


def _decode_pool():
    """The process's decode thread pool, created on first use."""
    global _DECODE_POOL
    with _DECODE_POOL_LOCK:
        if _DECODE_POOL is None:
            from concurrent.futures import ThreadPoolExecutor

            _DECODE_POOL = ThreadPoolExecutor(max_workers=8, thread_name_prefix="decode")
        return _DECODE_POOL


def _chunk_skip_mask(rr, lo: int, hi: int):
    """[hi-lo] uint8 marking PreFilter-rejected pods (the Python early-out
    owns them: their cycle aborted before Filter, so there are no blobs),
    or None when the range has none.  The same condition as
    prefilter_reject_message: a static reject for the pod, or the dynamic
    ReadWriteOncePod bit with VolumeRestrictions enabled.  The static part
    is a function of the workload, vectorized once per cw."""
    cw = rr.cw
    static = cw.host.get("prefilter_reject", {})
    dyn = np.asarray(rr.prefilter_reject[lo:hi])
    if not static and not dyn.any():
        return None
    mask = cw.host.get("_static_reject_any")
    if mask is None:
        mask = np.zeros(cw.n_pods, bool)
        for msgs in static.values():
            mask |= np.asarray([m is not None for m in msgs], bool)
        cw.host["_static_reject_any"] = mask
    skip = mask[lo:hi].copy()
    if "VolumeRestrictions" in cw.config.prefilters():
        skip |= (dyn & 1).astype(bool)
    if not skip.any():
        return None
    return np.ascontiguousarray(skip, np.uint8)


def _assemble_chunk(rr, lo: int, hi: int, triples, out: list, base: int) -> None:
    """Per-pod tail of the chunk decode: blob strs -> the 13-key dicts."""
    cw = rr.cw
    cfg = cw.config
    names = cw.node_table.names
    fskip = cw.host["filter_skip"]
    sskip = cw.host["score_skip"]
    prefilters = cfg.prefilters()
    prescorers = cfg.prescorers()
    feasible_count = rr.feasible_count
    for i in range(lo, hi):
        t = triples[i - lo]
        if t is None:  # PreFilter reject: the early-out owns it
            out[i - base] = decode_pod_result(rr, i)
            continue
        filter_json, score_json, final_json = t
        prefilter_status = {name: "" if fskip[name][i] else ann.SUCCESS_MESSAGE
                            for name in prefilters}
        prescore = {}
        if int(feasible_count[i]) > 1:
            for name in prescorers:
                prescore[name] = "" if sskip[name][i] else ann.SUCCESS_MESSAGE
        out[i - base] = _assemble(cfg, names, rr, i, prefilter_status, prescore,
                                  filter_json, score_json, final_json)


def _decode_chunk_native(rr, lo: int, hi: int, out: list, base: int) -> bool:
    """Pods lo..hi (a range within ONE compact chunk) through the
    chunk-granular native call: one GIL-released ctx_decode_chunk runs the
    C worker pool over the range; Python keeps only the PreFilter-reject
    early-out and the 13-key _assemble.  False when there is no native
    context (the caller takes the next rung)."""
    ctx = _native_ctx(rr.cw)
    if ctx is None:
        return False
    from . import native_decode

    triples, _thread_s = native_decode.decode_chunk_fused(
        ctx, rr, lo, hi, skip=_chunk_skip_mask(rr, lo, hi))
    _assemble_chunk(rr, lo, hi, triples, out, base)
    return True


def decode_chunk_into(rr, lo: int, hi: int, out: list, base: int = 0) -> None:
    """Decode pods lo..hi into out[lo-base:hi-base]: the replay(on_chunk=)
    streaming consumer, which runs while the device executes later chunks.
    Idempotent per index (a width-tier rerun re-delivers chunks).  base:
    the offset of a chunk-local sink (out[i-base]) instead of a
    queue-length list.  Takes the decoder ladder of the module doc.

    A failed decode re-raises to its caller, counted as
    decode_failures_total{path=...}, and never poisons the chunk: the lazy
    read path clears for retry (store/lazy.py), so a transient fault heals
    on the next read.  `decode.chunk` is its fault seam."""
    try:
        _decode_chunk_into(rr, lo, hi, out, base)
    except Exception:
        TRACER.inc("decode_failures_total", path=_decode_path_label(rr))
        raise


def _decode_chunk_into(rr, lo: int, hi: int, out: list, base: int) -> None:
    fault_point("decode.chunk")
    cc = rr._compact
    if cc is not None:
        # chunk-granular native decode; ranges spanning several compact
        # chunks split on chunk boundaries
        s0, routed = lo, True
        while s0 < hi:
            s1 = min(hi, (s0 // cc.chunk + 1) * cc.chunk)
            if not _decode_chunk_native(rr, s0, s1, out, base):
                routed = False
                break
            s0 = s1
        if routed:
            return
        lo = s0  # keep anything the native path already decoded
    if hi - lo < 16 or effective_cpu_count() < 2:
        # single-core hosts: the pool's dispatch and recon-lock traffic
        # cost more than the GIL-released C calls can win back
        for i in range(lo, hi):
            out[i - base] = decode_pod_result(rr, i)
        return
    if cc is not None and _native_ctx(rr.cw) is None:
        # the Python encoder reads codes_of/raw_of/final_of: rebuild the
        # chunk once here so the pool's workers share it
        rr._chunk_recon(lo // cc.chunk, scores=True)
    for i, a in zip(range(lo, hi),
                    _decode_pool().map(lambda i: decode_pod_result(rr, i), range(lo, hi))):
        out[i - base] = a


def _decode_path_label(rr) -> str:
    """The rung decode_chunk_into takes for rr: "native_chunk" (compact
    layout with a native context), "native_pod" (full arrays) or
    "python"; "unknown" when even that cannot be told."""
    try:
        if _native_ctx(rr.cw) is None:
            return "python"
        return "native_chunk" if rr._compact is not None else "native_pod"
    except Exception:  # noqa: BLE001 — a label for a failure tap
        return "unknown"


def decode_release_batches(rr, lo: int, hi: int, on_pod=None, batch: int = 64) -> None:
    """Decode pods lo..hi in small batches aligned to the compact chunks,
    releasing each batch's annotations after on_pod(i, ann): the
    reflector-style consumer that holds nothing (a whole 512-pod chunk of
    full-width strings is ~0.7 GB).  Batches never straddle a compact
    chunk.  On the chunk-granular native path the batches pipeline: batch
    k+1's GIL-released C decode runs on a pool thread while this thread
    builds batch k's strs and calls on_pod.  on_pod sees pods in order."""
    cc = rr._compact
    ranges: list[tuple[int, int]] = []
    s0 = lo
    while s0 < hi:
        s1 = min(s0 + batch, hi)
        if cc is not None:
            s1 = min(s1, (s0 // cc.chunk + 1) * cc.chunk)
        ranges.append((s0, s1))
        s0 = s1

    ctx = _native_ctx(rr.cw) if cc is not None else None
    if ctx is None:
        for b0, b1 in ranges:
            sink = [None] * (b1 - b0)
            decode_chunk_into(rr, b0, b1, sink, base=b0)
            if on_pod is not None:
                for j, a in enumerate(sink):
                    on_pod(b0 + j, a)
        return

    from . import native_decode

    pool = _decode_pool()

    def start(r):
        return pool.submit(native_decode.decode_chunk_start, ctx, rr, r[0], r[1],
                           _chunk_skip_mask(rr, *r))

    fut = start(ranges[0]) if ranges else None
    try:
        for k, (b0, b1) in enumerate(ranges):
            fault_point("decode.chunk")
            handle = fut.result()
            fut = start(ranges[k + 1]) if k + 1 < len(ranges) else None
            triples = native_decode.decode_chunk_take(handle)
            sink: list = [None] * (b1 - b0)
            _assemble_chunk(rr, b0, b1, triples, sink, b0)
            if on_pod is not None:
                for j, a in enumerate(sink):
                    on_pod(b0 + j, a)
    except BaseException as e:
        if isinstance(e, Exception):
            TRACER.inc("decode_failures_total", path="native_chunk")
        if fut is not None:  # free the in-flight batch's arena
            try:
                fut.result().discard()
            except Exception:  # noqa: BLE001 — the original error re-raises below
                pass
        raise


def decode_all_parallel(rr: ReplayResult, n: int | None = None) -> list[dict[str, str]]:
    """Decode pods 0..n chunk by chunk through decode_chunk_into, whose
    native rung runs the JSON encoding in C outside the GIL.  A result
    holding full arrays takes the serial loop."""
    if n is None:
        n = rr.cw.n_pods
    cc = rr._compact
    if cc is None:
        return [decode_pod_result(rr, i) for i in range(n)]
    out: list = [None] * n
    for lo in range(0, n, cc.chunk):
        decode_chunk_into(rr, lo, min(lo + cc.chunk, n), out)
    return out
