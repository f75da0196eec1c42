"""Wrapper of the step kernel (csrc/step.cu `step_chunk`).

`step_chunk(step, carry, xs_chunk)` runs one chunk of pods through the
scheduling step of framework/pipeline.py `Step`:

  * for tensors on the card it launches the hand-written kernel once, on
    PyTorch's current stream, without synchronising: one thread-block
    cluster of S CTAs, 16 where the card has room for it and 8 otherwise
    (`step_chunk.shards`), each CTA a slice of the nodes.  It returns the
    chunk's StepOut / CompactOut (leading pod axis) with `carry` updated
    in place;
  * for tensors on the CPU it runs the plain PyTorch version,
    `Step.plain_scan`, because there is no card to launch on.

There is no fallback: a failed build or launch raises.  `step_chunk.launches`
counts kernel launches (and nothing else), so a run can show that its
main path went through the kernel.

The kernel takes its ~100 pointers and its scalars in one C struct,
`StepArgs` (csrc/common.cuh), mirrored here as a ctypes.Structure; the
wrapper checks every tensor's device, dtype, shape and contiguity before
it takes a pointer.  The step's tables (plugin ids, weights, the raw
groups, the custom slots, the strategies' resources and shape points) sit
in StepArgs' fixed arrays while they fit (MAX_F filters, MAX_S scorers,
MAX_CUSTOM custom plugins with rows, MAX_RES resources, MAX_SHAPE shape
points); a workload past any of them gets all its tables in one int64
array on the card (`StepArgs.ext`, `step_tables`), which the kernels read
instead.  A pod past MAX_VBK unbound claims takes VolumeBinding's wide
walk (csrc/volumes.cuh vb_greedy_wide), whose open-slot masks pass the
thread's own array past 256 claims: the launch's plan then gives their
bytes and its caller allocates them with the spill (StepArgs.vb_masks,
`vb_masks`).  No count is bounded on the card.
"""

from __future__ import annotations

import ctypes

import torch

from ..framework.pipeline import PACK_MODES, CompactOut, StepOut
from ..plugins import fitscoring, volumebinding
from ..plugins.fitscoring import parse_balanced_resources, parse_fit_strategy
from ..plugins.topologyspread import MAX_CONSTRAINTS
from ..state.resources import CPU, MEMORY

# StepArgs' fixed arrays (csrc/common.cuh KSS_MAX_*): past any of them the
# tables go to StepArgs.ext
MAX_F, MAX_S, MAX_RES, MAX_SHAPE, MAX_VBK, MAX_CUSTOM = 16, 16, 8, 16, 8, 8

PLUGIN_IDS = {
    "NodeResourcesFit": 0,
    "NodeResourcesBalancedAllocation": 1,
    "NodeAffinity": 2,
    "TaintToleration": 3,
    "PodTopologySpread": 4,
    "InterPodAffinity": 5,
    "NodeUnschedulable": 6,
    "NodeName": 7,
    "NodePorts": 8,
    "ImageLocality": 9,
    "VolumeRestrictions": 10,
    "NodeVolumeLimits": 11,
    "VolumeBinding": 12,
    "VolumeZone": 13,
}
# a custom plugin's id: P_CUSTOM + its slot, its index among the step's
# custom plugins in name order (custom_ids)
P_CUSTOM = 16
RES_NONZERO, RES_REQUESTED, RES_NONE = 0, 1, 2
FIT_TYPES = {fitscoring.LEAST_ALLOCATED: 0, fitscoring.MOST_ALLOCATED: 1,
             fitscoring.REQUESTED_TO_CAPACITY_RATIO: 2}
G_NONE, G_RAW8, G_RAW16, G_RAW32 = 0, 1, 2, 3

_PTR_FIELDS = (
    "allocatable", "allowed_pods", "fit_ignored", "requested", "nonzero",
    "num_pods", "pod_requests", "pod_nonzero", "is_pad",
    "aff_req_rows", "aff_pref_rows", "aff_req_idx", "aff_pref_idx",
    "aff_filter_skip", "aff_score_skip",
    "taint_code", "taint_prefer",
    "sp_dom_idx", "sp_counts", "sp_pm", "sp_c_id", "sp_max_skew",
    "sp_is_filter", "sp_is_score", "sp_weight", "sp_eligible", "sp_md_unsat",
    "sp_filter_skip", "sp_score_skip",
    "ip_dom_idx", "ip_matched", "ip_have_req_anti", "ip_have_req_aff",
    "ip_sym_pref_aff", "ip_sym_pref_anti", "ip_matched_total",
    "ip_t_matches", "ip_h_req_aff", "ip_h_req_anti", "ip_h_pref_aff_w",
    "ip_h_pref_anti_w", "ip_self_ok", "ip_filter_skip",
    "unsched_fail", "nodename_fail",
    "np_sq", "np_w_wild", "np_w_spec", "np_w_any", "np_filter_skip",
    "np_used_any", "np_used_wild", "np_used_spec",
    "image_score", "vz_codes", "vz_filter_skip",
    "nvl_onehot", "nvl_limits", "nvl_pod_vols", "nvl_filter_skip", "nvl_on_node",
    "vr_strict", "vr_w_any", "vr_w_rw", "vr_rwop", "vr_filter_skip",
    "vr_used_any", "vr_used_rw", "vr_rwop_used",
    "vb_pv_cap", "vb_pv_node_ok", "vb_bound_code", "vb_want", "vb_active",
    "vb_provision_ok", "vb_filter_skip", "vb_claimed", "vb_order",
    "force_unsched",
)
_OUT_PTR_FIELDS = (
    "out_codes", "out_raw", "out_final",
    "out_packed", "out_raw8", "out_raw16", "out_raw32", "out_overflow",
    "out_selected", "out_feasible_count", "out_prefilter_reject",
    "clock", "spill", "ext", "vb_masks",
)
_LL = ctypes.c_longlong
_INT = ctypes.c_int


class StepArgs(ctypes.Structure):
    """Mirror of `struct StepArgs` in csrc/common.cuh, field for field."""

    _fields_ = (
        [(f, ctypes.c_void_p) for f in _PTR_FIELDS]
        + [("cu_codes", ctypes.c_void_p * MAX_CUSTOM),
           ("cu_scores", ctypes.c_void_p * MAX_CUSTOM)]
        + [(f, ctypes.c_void_p) for f in _OUT_PTR_FIELDS]
        + [("ip_hard_weight", _LL), ("score_weight", _LL * MAX_S),
           ("fit_weight", _LL * MAX_RES), ("shape_u", _LL * MAX_SHAPE),
           ("shape_s", _LL * MAX_SHAPE)]
        + [(f, _INT) for f in ("C", "N", "R", "G", "T", "K",
                               "F", "S", "S8", "S16", "S32")]
        + [("filter_ids", _INT * MAX_F), ("score_ids", _INT * MAX_S),
           ("score_group", _INT * MAX_S), ("score_row", _INT * MAX_S)]
        + [(f, _INT) for f in ("compact", "pack_code_bits", "pack_bytes",
                               "raw32_bytes", "check_group", "fit_type",
                               "fit_nres")]
        + [("fit_src", _INT * MAX_RES), ("fit_col", _INT * MAX_RES),
           ("fit_need_request", _INT * MAX_RES)]
        + [("fit_nshape", _INT), ("bal_nres", _INT)]
        + [("bal_src", _INT * MAX_RES), ("bal_col", _INT * MAX_RES),
           ("bal_need_request", _INT * MAX_RES)]
        + [(f, _INT) for f in ("has_spread", "has_interpod", "sp_elig_per_slot",
                               "Q", "QS", "VC", "VD", "RD", "RR", "VV", "VK",
                               "vz_width", "vb_width",
                               "has_ports", "has_nvl", "has_vr", "has_vb",
                               "node_base", "whole_n")]
    )


def _ptr(t: torch.Tensor, dtype, shape, what: str) -> int:
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")
    return t.data_ptr()


def _resource_desc(name: str, schema, use_requested: bool):
    """(source, column, pod-must-request-it) of one scored resource: the
    kernel's form of noderesources._resource_req_alloc / _resource_active."""
    if name == "cpu":
        return (RES_REQUESTED, CPU, 0) if use_requested else (RES_NONZERO, 0, 0)
    if name == "memory":
        return (RES_REQUESTED, MEMORY, 0) if use_requested else (RES_NONZERO, 1, 0)
    if name in schema.columns:
        need = 0 if name in fitscoring.NATIVE_RESOURCES else 1
        return RES_REQUESTED, schema.columns.index(name), need
    return RES_NONE, 0, 0  # untracked: capacity 0, never active


def _score_groups(step):
    """Per scorer (group, row), the checked group and the raw32 width, as
    pipeline.Step.plain groups the compact raws."""
    groups, rows = [], []
    counts = {G_RAW8: 0, G_RAW16: 0, G_RAW32: 0}
    for g in step.score_dtypes:
        if g == "host":
            groups.append(G_NONE)
            rows.append(0)
            continue
        gid = G_RAW32 if step.wide_raw else {"i8": G_RAW8, "i16": G_RAW16, "i32": G_RAW32}[g]
        groups.append(gid)
        rows.append(counts[gid])
        counts[gid] += 1
    check = {None: G_RAW16, "i32": G_RAW32, "i64": G_NONE}[step.wide_raw]
    return groups, rows, counts, check, 8 if step.wide_raw == "i64" else 4


def make_args(step, carry, xs, outs: dict | None) -> StepArgs:
    """Fill StepArgs from the workload, the carry, the chunk's xs and the
    output tensors (none when `outs` is None), checking each tensor on the
    way.  Past the fixed arrays the tables go to a device array
    (step_tables) that the returned StepArgs holds (`ext_tensor`): keep
    the StepArgs until the launch has been issued."""
    cw = step.cw
    n, r = cw.n_nodes, cw.schema.n
    c = xs["is_pad"].shape[0]
    f, s = len(step.filter_names), len(step.score_names)
    i64, i32, i16, u8, f64, b = (torch.int64, torch.int32, torch.int16, torch.uint8,
                                 torch.float64, torch.bool)
    a = StepArgs()
    a.C, a.N, a.R, a.F, a.S = c, n, r, f, s
    # a card of a card mesh (kernels/mesh.py _CardWorkload): its first node,
    # and the width of the rows it keeps whole (csrc/common.cuh whole_at)
    a.node_base = getattr(cw, "node_base", 0)
    a.whole_n = whole = getattr(cw, "whole_n", n)

    st, cc, cx = cw.statics["core"], carry["core"], xs["core"]
    a.allocatable = _ptr(st.allocatable, i64, (n, r), "allocatable")
    a.allowed_pods = _ptr(st.allowed_pods, i64, (n,), "allowed_pods")
    a.fit_ignored = _ptr(st.ignored, b, (r,), "ignored")
    a.requested = _ptr(cc.requested, i64, (n, r), "carry.requested")
    a.nonzero = _ptr(cc.nonzero, i64, (n, 2), "carry.nonzero")
    a.num_pods = _ptr(cc.num_pods, i64, (n,), "carry.num_pods")
    a.pod_requests = _ptr(cx.requests, i64, (c, r), "xs.requests")
    a.pod_nonzero = _ptr(cx.nonzero, i64, (c, 2), "xs.nonzero")
    a.is_pad = _ptr(xs["is_pad"], b, (c,), "is_pad")

    if "NodeAffinity" in cw.statics:
        st, x = cw.statics["NodeAffinity"], xs["NodeAffinity"]
        a.aff_req_rows = _ptr(st.req_rows, b, (st.req_rows.shape[0], n), "req_rows")
        a.aff_pref_rows = _ptr(st.pref_rows, i32, (st.pref_rows.shape[0], n), "pref_rows")
        a.aff_req_idx = _ptr(x.req_idx, i32, (c,), "req_idx")
        a.aff_pref_idx = _ptr(x.pref_idx, i32, (c,), "pref_idx")
        a.aff_filter_skip = _ptr(x.filter_skip, b, (c,), "NodeAffinity.filter_skip")
        a.aff_score_skip = _ptr(x.score_skip, b, (c,), "NodeAffinity.score_skip")
    if "TaintToleration" in xs:
        x = xs["TaintToleration"]
        a.taint_code = _ptr(x.filter_code, i16, (c, n), "taint filter_code")
        a.taint_prefer = _ptr(x.prefer_count, i16, (c, n), "taint prefer_count")
    if "PodTopologySpread" in cw.statics:
        st, x = cw.statics["PodTopologySpread"], xs["PodTopologySpread"]
        g = st.dom_idx.shape[0]
        mc = MAX_CONSTRAINTS
        a.G = g
        a.has_spread = 1
        a.sp_dom_idx = _ptr(st.dom_idx, i32, (g, whole), "spread dom_idx")
        a.sp_counts = _ptr(carry["PodTopologySpread"], i32, (g, n), "spread counts")
        a.sp_pm = _ptr(x.pm, b, (c, g), "spread pm")
        a.sp_c_id = _ptr(x.c_id, i32, (c, mc), "spread c_id")
        a.sp_max_skew = _ptr(x.max_skew, i32, (c, mc), "spread max_skew")
        a.sp_is_filter = _ptr(x.is_filter, b, (c, mc), "spread is_filter")
        a.sp_is_score = _ptr(x.is_score, b, (c, mc), "spread is_score")
        a.sp_weight = _ptr(x.weight, f64, (c, mc), "spread weight")
        a.sp_elig_per_slot = int(x.eligible.dim() == 3)
        a.sp_eligible = _ptr(x.eligible, b, (c, mc, n) if a.sp_elig_per_slot else (c, n),
                             "spread eligible")
        a.sp_md_unsat = _ptr(x.md_unsat, b, (c, mc), "spread md_unsat")
        a.sp_filter_skip = _ptr(x.filter_skip, b, (c,), "spread filter_skip")
        a.sp_score_skip = _ptr(x.score_skip, b, (c,), "spread score_skip")
    if "InterPodAffinity" in cw.statics:
        st, x, ic = cw.statics["InterPodAffinity"], xs["InterPodAffinity"], carry["InterPodAffinity"]
        t = st.dom_idx.shape[0]
        a.T = t
        a.has_interpod = 1
        a.ip_hard_weight = step.ip_hard_weight
        a.ip_dom_idx = _ptr(st.dom_idx, i32, (t, whole), "interpod dom_idx")
        for fld in ("matched", "have_req_anti", "have_req_aff", "sym_pref_aff", "sym_pref_anti"):
            setattr(a, "ip_" + fld, _ptr(getattr(ic, fld), i32, (t, n), "interpod " + fld))
        a.ip_matched_total = _ptr(ic.matched_total, i32, (t,), "interpod matched_total")
        a.ip_t_matches = _ptr(x.t_matches, b, (c, t), "interpod t_matches")
        a.ip_h_req_aff = _ptr(x.h_req_aff, i32, (c, t), "interpod h_req_aff")
        a.ip_h_req_anti = _ptr(x.h_req_anti, i32, (c, t), "interpod h_req_anti")
        a.ip_h_pref_aff_w = _ptr(x.h_pref_aff_w, i64, (c, t), "interpod h_pref_aff_w")
        a.ip_h_pref_anti_w = _ptr(x.h_pref_anti_w, i64, (c, t), "interpod h_pref_anti_w")
        a.ip_self_ok = _ptr(x.self_ok, b, (c,), "interpod self_ok")
        a.ip_filter_skip = _ptr(x.filter_skip, b, (c,), "interpod filter_skip")

    _plugin_args(a, cw, carry, xs, c, n, whole)
    _tables(a, step, xs, c, n, carry["core"].requested.device)

    if outs is None:
        return a
    if step.out_mode == "full":
        a.out_codes = _ptr(outs["filter_codes"], i32, (c, f, n), "filter_codes")
        a.out_raw = _ptr(outs["score_raw"], i32, (c, s, n), "score_raw")
        a.out_final = _ptr(outs["score_final"], i32, (c, s, n), "score_final")
    else:
        _, _, counts, check, raw32_bytes = _score_groups(step)
        dtype, code_bits, _ = PACK_MODES[step.pack_mode]
        a.compact = 1
        a.pack_code_bits = code_bits
        a.pack_bytes = outs["packed_filter"].element_size()
        a.raw32_bytes = raw32_bytes
        a.check_group = check
        a.S8, a.S16, a.S32 = counts[G_RAW8], counts[G_RAW16], counts[G_RAW32]
        a.out_packed = _ptr(outs["packed_filter"], dtype, (c, n), "packed_filter")
        a.out_raw8 = _ptr(outs["raw8"], torch.int8, (c, a.S8, n), "raw8")
        a.out_raw16 = _ptr(outs["raw16"], i16, (c, a.S16, n), "raw16")
        a.out_raw32 = _ptr(outs["raw32"], i64 if raw32_bytes == 8 else i32,
                           (c, a.S32, n), "raw32")
        a.out_overflow = _ptr(outs["raw_overflow"], b, (c,), "raw_overflow")
    a.out_selected = _ptr(outs["selected"], i32, (c,), "selected")
    a.out_feasible_count = _ptr(outs["feasible_count"], i32, (c,), "feasible_count")
    a.out_prefilter_reject = _ptr(outs["prefilter_reject"], i32, (c,), "prefilter_reject")
    return a


def step_tables(step, xs, c: int, n: int) -> dict:
    """The step's tables, each a list: filter and score plugin ids, score
    weights, raw groups and rows (compact mode; 0 in full mode), the
    NodeResourcesFit strategy's (source, column, need-request, weight) per
    resource and its shape points, BalancedAllocation's (source, column,
    need-request) per resource, the fit type, and each custom slot's
    (codes, scores) addresses in slot order, checked."""
    cw = step.cw
    s = len(step.score_names)
    slots = custom_ids(step)  # in slot order
    ids = {**PLUGIN_IDS, **slots}
    custom = [(_ptr(xs[name].codes, torch.int32, (c, n), f"{name}.codes"),
               _ptr(xs[name].scores, torch.int64, (c, n), f"{name}.scores")) for name in slots]
    strategy = parse_fit_strategy(cw.config.args.get("NodeResourcesFit"))
    rtcr = strategy.stype == fitscoring.REQUESTED_TO_CAPACITY_RATIO
    balanced = parse_balanced_resources(cw.config.args.get("NodeResourcesBalancedAllocation"))
    groups, rows = ([0] * s, [0] * s) if step.out_mode == "full" else _score_groups(step)[:2]
    return {
        "filters": [ids[name] for name in step.filter_names],
        "scores": [ids[name] for name in step.score_names],
        "weights": [int(w) for w in step.weights],
        "groups": groups, "rows": rows,
        "fit": [(*_resource_desc(name, cw.schema, rtcr), int(w))
                for name, w in strategy.resources],
        "shape": [(int(u), int(sc)) for u, sc in strategy.shape],
        "balanced": [_resource_desc(name, cw.schema, False) for name in balanced],
        "fit_type": FIT_TYPES[strategy.stype],
        "custom": custom,
    }


def tables_fit(t: dict) -> bool:
    """Whether the tables fit StepArgs' fixed arrays (else StepArgs.ext)."""
    return (len(t["filters"]) <= MAX_F and len(t["scores"]) <= MAX_S
            and len(t["custom"]) <= MAX_CUSTOM and len(t["fit"]) <= MAX_RES
            and len(t["shape"]) <= MAX_SHAPE and len(t["balanced"]) <= MAX_RES)


def ext_values(t: dict) -> list[int]:
    """The tables as csrc/common.cuh lays them out in StepArgs.ext."""
    vals = [*t["filters"], *t["scores"], *t["weights"], *t["groups"], *t["rows"]]
    for j in range(4):
        vals += [d[j] for d in t["fit"]]
    for j in range(2):
        vals += [p[j] for p in t["shape"]]
    for j in range(3):
        vals += [d[j] for d in t["balanced"]]
    for codes, scores in t["custom"]:
        vals += [codes, scores]
    return vals


def _tables(a: StepArgs, step, xs, c: int, n: int, dev: torch.device) -> None:
    """The step's tables into the fixed arrays, or, past them, into one
    int64 array on dev that a.ext points to (held as a.ext_tensor)."""
    t = step_tables(step, xs, c, n)
    a.fit_type = t["fit_type"]
    a.fit_nres, a.fit_nshape, a.bal_nres = len(t["fit"]), len(t["shape"]), len(t["balanced"])
    if not tables_fit(t):
        host = torch.tensor(ext_values(t), dtype=torch.int64)
        if dev.type == "cuda":
            # a pinned source: the copy queues behind the launches so far
            # and the allocator keeps the buffer until it has run
            ext = host.pin_memory().to(dev, non_blocking=True)
        else:
            ext = host
        a.ext = ext.data_ptr()
        a.ext_tensor = ext
        return
    for k, pid in enumerate(t["filters"]):
        a.filter_ids[k] = pid
    for k, pid in enumerate(t["scores"]):
        a.score_ids[k], a.score_weight[k] = pid, t["weights"][k]
        a.score_group[k], a.score_row[k] = t["groups"][k], t["rows"][k]
    for k, (src, col, need, w) in enumerate(t["fit"]):
        a.fit_src[k], a.fit_col[k], a.fit_need_request[k], a.fit_weight[k] = src, col, need, w
    for k, (u, sc) in enumerate(t["shape"]):
        a.shape_u[k], a.shape_s[k] = u, sc
    for k, (src, col, need) in enumerate(t["balanced"]):
        a.bal_src[k], a.bal_col[k], a.bal_need_request[k] = src, col, need
    for k, (codes, scores) in enumerate(t["custom"]):
        a.cu_codes[k], a.cu_scores[k] = codes, scores


def _plugin_args(a: StepArgs, cw, carry, xs, c: int, n: int, whole: int) -> None:
    """The default profile's further plugins (csrc/taints.cuh, ports.cuh,
    volumes.cuh and the ImageLocality row) and the compile-time PreFilter
    rejects: each one's pointers, checked, where the workload has it."""
    i32, i64, b = torch.int32, torch.int64, torch.bool
    if "NodeUnschedulable" in xs:
        a.unsched_fail = _ptr(xs["NodeUnschedulable"].fail, b, (c, n), "NodeUnschedulable.fail")
    if "NodeName" in xs:
        a.nodename_fail = _ptr(xs["NodeName"].fail, b, (c, n), "NodeName.fail")
    if "NodePorts" in cw.statics:
        st, x, pc = cw.statics["NodePorts"], xs["NodePorts"], carry["NodePorts"]
        a.Q, a.QS = pc.used_any.shape[1], pc.used_spec.shape[1]
        a.has_ports = 1
        a.np_sq = _ptr(st.sq, i32, (a.QS,), "ports sq")
        a.np_w_wild = _ptr(x.w_wild, b, (c, a.Q), "ports w_wild")
        a.np_w_spec = _ptr(x.w_spec, b, (c, a.QS), "ports w_spec")
        a.np_w_any = _ptr(x.w_any, b, (c, a.Q), "ports w_any")
        a.np_filter_skip = _ptr(x.filter_skip, b, (c,), "ports filter_skip")
        a.np_used_any = _ptr(pc.used_any, b, (n, a.Q), "ports used_any")
        a.np_used_wild = _ptr(pc.used_wild, b, (n, a.Q), "ports used_wild")
        a.np_used_spec = _ptr(pc.used_spec, b, (n, a.QS), "ports used_spec")
    if "ImageLocality" in xs:
        a.image_score = _ptr(xs["ImageLocality"].score, i64, (c, n), "ImageLocality.score")
    if "VolumeZone" in xs:
        x = xs["VolumeZone"]
        a.vz_width = x.codes.shape[-1]
        if a.vz_width not in (1, n):
            raise ValueError(f"VolumeZone.codes: shape {tuple(x.codes.shape)}")
        a.vz_codes = _ptr(x.codes, i32, (c, a.vz_width), "VolumeZone.codes")
        a.vz_filter_skip = _ptr(x.filter_skip, b, (c,), "VolumeZone.filter_skip")
    if "NodeVolumeLimits" in cw.statics:
        st, x, lc = cw.statics["NodeVolumeLimits"], xs["NodeVolumeLimits"], carry["NodeVolumeLimits"]
        a.VC, a.VD = st.driver_onehot.shape
        a.has_nvl = 1
        a.nvl_onehot = _ptr(st.driver_onehot, b, (a.VC, a.VD), "limits driver_onehot")
        a.nvl_limits = _ptr(st.limits, i64, (n, a.VD), "limits limits")
        a.nvl_pod_vols = _ptr(x.pod_vols, b, (c, a.VC), "limits pod_vols")
        a.nvl_filter_skip = _ptr(x.filter_skip, b, (c,), "limits filter_skip")
        a.nvl_on_node = _ptr(lc.on_node, b, (n, a.VC), "limits on_node")
    if "VolumeRestrictions" in cw.statics:
        st, x, rc = (cw.statics["VolumeRestrictions"], xs["VolumeRestrictions"],
                     carry["VolumeRestrictions"])
        a.RD, a.RR = rc.used_any.shape[1], rc.rwop_used.shape[0]
        a.has_vr = 1
        a.vr_strict = _ptr(st.strict, b, (a.RD,), "restrictions strict")
        a.vr_w_any = _ptr(x.w_any, b, (c, a.RD), "restrictions w_any")
        a.vr_w_rw = _ptr(x.w_rw, b, (c, a.RD), "restrictions w_rw")
        a.vr_rwop = _ptr(x.rwop, b, (c, a.RR), "restrictions rwop")
        a.vr_filter_skip = _ptr(x.filter_skip, b, (c,), "restrictions filter_skip")
        a.vr_used_any = _ptr(rc.used_any, b, (n, a.RD), "restrictions used_any")
        a.vr_used_rw = _ptr(rc.used_rw, b, (n, a.RD), "restrictions used_rw")
        a.vr_rwop_used = _ptr(rc.rwop_used, b, (a.RR,), "restrictions rwop_used")
    if "VolumeBinding" in cw.statics:
        st, x, bc = cw.statics["VolumeBinding"], xs["VolumeBinding"], carry["VolumeBinding"]
        a.VV, a.VK = st.pv_cap.shape[0], x.active.shape[1]
        a.vb_width = x.bound_code.shape[-1]
        if a.vb_width not in (1, n):
            raise ValueError(f"VolumeBinding.bound_code: shape {tuple(x.bound_code.shape)}")
        a.has_vb = 1
        a.vb_pv_cap = _ptr(st.pv_cap, i64, (a.VV,), "binding pv_cap")
        a.vb_pv_node_ok = _ptr(st.pv_node_ok, b, (a.VV, whole), "binding pv_node_ok")
        a.vb_bound_code = _ptr(x.bound_code, i32, (c, a.vb_width), "binding bound_code")
        a.vb_want = _ptr(x.want, b, (c, a.VK, a.VV), "binding want")
        a.vb_active = _ptr(x.active, b, (c, a.VK), "binding active")
        a.vb_provision_ok = _ptr(x.provision_ok, b, (c, a.VK, whole), "binding provision_ok")
        a.vb_filter_skip = _ptr(x.filter_skip, b, (c,), "binding filter_skip")
        a.vb_claimed = _ptr(bc.claimed, b, (a.VV,), "binding claimed")
        a.vb_order = _ptr(volumebinding.pv_order(st), torch.int32, (a.VV,), "binding pv order")
    if "force_unsched" in xs:
        a.force_unsched = _ptr(xs["force_unsched"], b, (c,), "force_unsched")


def custom_ids(step) -> dict[str, int]:
    """The kernel's id of each custom plugin the step filters or scores
    with (B13): P_CUSTOM + its index in name order."""
    cfg = step.cw.config
    names = sorted({n for n in (*step.filter_names, *step.score_names) if cfg.is_custom(n)})
    return {name: P_CUSTOM + k for k, name in enumerate(names)}


def alloc_outputs(step, c: int, device) -> dict:
    """Output tensors of one launch over c pods (torch.empty: the kernel
    writes every element it is responsible for; it keeps a pod's rows on
    chip, or in StepArgs.spill)."""
    n = step.cw.n_nodes
    f, s = len(step.filter_names), len(step.score_names)

    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    outs = {
        "selected": empty((c,), torch.int32),
        "feasible_count": empty((c,), torch.int32),
        "prefilter_reject": empty((c,), torch.int32),
    }
    if step.out_mode == "full":
        outs["filter_codes"] = empty((c, f, n), torch.int32)
        outs["score_raw"] = empty((c, s, n), torch.int32)
        outs["score_final"] = empty((c, s, n), torch.int32)
    else:
        _, _, counts, _, raw32_bytes = _score_groups(step)
        outs["packed_filter"] = empty((c, n), PACK_MODES[step.pack_mode][0])
        outs["raw8"] = empty((c, counts[G_RAW8], n), torch.int8)
        outs["raw16"] = empty((c, counts[G_RAW16], n), torch.int16)
        outs["raw32"] = empty((c, counts[G_RAW32], n),
                              torch.int64 if raw32_bytes == 8 else torch.int32)
        outs["raw_overflow"] = empty((c,), torch.bool)
    return outs


def _tensors(tree):
    for v in tree.values():
        if isinstance(v, torch.Tensor):
            yield v
        else:
            yield from (a for a in v if isinstance(a, torch.Tensor))


def check_device(what: str, dev: torch.device, *trees) -> None:
    """Every tensor of the trees (dicts of tensors / NamedTuples) on dev."""
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    for tree in trees:
        for t in _tensors(tree):
            if t.device != dev:
                raise ValueError(f"{what}: a tensor on {t.device}, the carry on {dev}")


def load_lib(stem: str) -> ctypes.CDLL:
    """The built library of csrc/<stem>.cu, its StepArgs layout checked."""
    from . import build

    lib = build.load(stem)
    if lib.kss_step_args_size() != ctypes.sizeof(StepArgs):
        raise RuntimeError(f"StepArgs layout differs between csrc/common.cuh and "
                           f"kernels/step.py ({stem})")
    return lib


def stream_of(dev: torch.device) -> ctypes.c_void_p:
    """PyTorch's current stream on dev, for a launch."""
    with torch.cuda.device(dev):
        return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


def check_launch(what: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def plan_cluster(lib: ctypes.CDLL, args: StepArgs, ctas: int, dev: torch.device,
                 shards: int = 1):
    """The plan of one launch of step_chunk's cluster kernel over
    `shards` "nodes" shards (a mesh's; 1 without one) (csrc/
    step_kernel.cuh kss_step_plan) -> (R, the device memory that holds the
    CTAs' state or None, that of VolumeBinding's open-slot masks or None).
    `ctas` 0 lets the kernel pick R.  Where a CTA's state does not fit in
    shared memory it goes to device memory, and where a pod passes the
    threads' own mask arrays the masks do (csrc/common.cuh vb_mask_words):
    each allocated here on `dev` and set on args.spill, args.vb_masks; the
    caller launches before it lets the tensors go (PyTorch's allocator
    orders their reuse after the launch on the stream)."""
    out, nbytes, mbytes = ctypes.c_int(0), ctypes.c_longlong(0), ctypes.c_longlong(0)
    check_launch("step_chunk plan", lib.kss_step_plan(ctypes.byref(args), ctas, shards,
                                                      ctypes.byref(out), ctypes.byref(nbytes),
                                                      ctypes.byref(mbytes)))
    spill = masks = None
    if nbytes.value:
        spill = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
        args.spill = spill.data_ptr()
    if mbytes.value:
        masks = vb_masks(mbytes.value, dev, [args])
    return out.value, spill, masks


def vb_masks(nbytes: int, dev: torch.device, table) -> torch.Tensor:
    """`nbytes` of device memory for VolumeBinding's open-slot masks, set
    on every StepArgs of `table` (one buffer a launch)."""
    masks = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    for args in table:
        args.vb_masks = masks.data_ptr()
    return masks


CLOCK_SLOTS = 8  # csrc/common.cuh KSS_CLOCK_SLOTS
CLOCK_PHASES = ("pre-reductions", "filter", "score", "normalize reductions",
                "normalize and argmax", "bind", "NodeVolumeLimits", "VolumeBinding")


def step_chunk(step, carry: dict, xs_chunk: dict, *, _shards: int = 0,
               _clock: torch.Tensor | None = None):
    """One chunk of pods -> (carry, StepOut / CompactOut with a leading pod
    axis).  CUDA tensors: one launch of one thread-block cluster, carry
    updated in place; `step_chunk.shards` records the cluster size it took
    (16 where the card has room for such a cluster, else 8), and
    `step_chunk.spilled` whether the CTAs' state went to device memory
    (a slice too wide for shared memory).  CPU tensors: the plain version.

    For tests and measurement only: `_shards` forces the cluster size (1
    to 16); `_clock`, a zeroed int64 [C * CLOCK_SLOTS + 2] tensor on the
    card, runs the phase-clock build of the kernel (csrc/step.cu under
    -DKSS_PHASE_CLOCK), which adds each pod's phase times in ns
    (CLOCK_PHASES) and stamps the launch's start and end."""
    dev = carry["core"].requested.device
    if dev.type == "cpu":
        return step.plain_scan(carry, xs_chunk)
    check_device("step_chunk", dev, step.cw.statics, carry, xs_chunk)
    lib = load_lib("step" if _clock is None else "step_clock")
    c = xs_chunk["is_pad"].shape[0]
    outs = alloc_outputs(step, c, dev)
    args = make_args(step, carry, xs_chunk, outs)
    if _clock is not None:
        args.clock = _ptr(_clock, torch.int64, (c * CLOCK_SLOTS + 2,), "clock")
    shards, spill, _masks = plan_cluster(lib, args, _shards, dev)
    check_launch("step_chunk", lib.kss_step_chunk(ctypes.byref(args), shards, 1,
                                                  stream_of(dev)))
    step_chunk.launches += 1
    step_chunk.shards = shards
    step_chunk.spilled = spill is not None
    cls = StepOut if step.out_mode == "full" else CompactOut
    return carry, cls(**{k: outs[k] for k in cls._fields})


step_chunk.launches = 0
step_chunk.shards = None
step_chunk.spilled = None
