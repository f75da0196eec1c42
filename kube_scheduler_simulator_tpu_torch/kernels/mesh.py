"""B12: the node-sharded step and dense eval, each wrapper and, beside it,
its plain PyTorch twin.

    kernel (csrc/)                       wrapper             plain twin                 JAX counterpart
    step_kernel.cuh step_chunk_kernel    step_chunk_sharded  step_chunk_sharded_plain   parallel/mesh.py:130 sharded_step
    spec_eval.cu spec_eval_cluster       spec_eval_sharded   spec_eval_sharded_plain    :143 speculative_scores

A workload sharded over a one-card mesh (parallel/mesh.py
`shard_workload`) splits its node axis into S contiguous slices,
`node_slices(N, S)`.  On the card the mesh runs the unsharded kernels'
own cluster plan: a cluster of R CTAs (16 where the card has room, as
step_chunk and spec_eval pick it) serves the S shards, each a group of
G = R / S CTAs over its own slice, split again as `cta_slices(N, S, G)`
(csrc/slices.cuh).  The twins compute the same decomposition in plain
PyTorch: each CTA slice evaluates the plugins over its own nodes of every
[.., N] tensor, every reduction over the node axis (the spread minima, the
feasible count, the raw-overflow OR, the normalizing min/max/any, the
argmax) is a partial per slice combined in rank order, and the bind
updates each slice of the node-space carries, with the exactly-once
updates made for the slice that owns the selected node.  So the CPU tests
exercise the decomposition itself, not the unsharded step
(framework/pipeline.py `Step.plain`), which they compare it with.

As kernels/step.py does: for tensors on the card a wrapper launches on
PyTorch's current stream without synchronising and adds one to its
`launches`; for tensors on the CPU it runs the twin.  There is no
fallback: a failed build or launch raises, and each wrapper raises
`cudaGetLastError()`'s code.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ..framework.pipeline import (CompactOut, StepOut, _bind_phase, _filter_one,
                                  _prefilter_reject, _score_one, _stack, slice_pod)
from ..plugins import interpod, topologyspread
from ..plugins.base import default_normalize_apply
from ..plugins.custom import CustomXS
from ..state.compile import CUSTOM_XS_AXES, NODE_AXES
from . import spec as kspec
from . import step as kstep

# csrc/cluster.cuh KSS_MESH_MAX_SHARDS: at most 8 shards, so that each is a
# group of CTAs at either cluster size the plan takes (16, or 8)
MAX_SHARDS = 8
_BIG = 1 << 40


def node_slices(n: int, shards: int) -> tuple[tuple[int, int], ...]:
    """Shard r's nodes [r N/S, (r+1) N/S): the contiguous slices a
    NamedSharding of the node axis gives (JAX parallel/mesh.py:62)."""
    check_shards(n, shards)
    w = n // shards
    return tuple((r * w, (r + 1) * w) for r in range(shards))


def check_shards(n: int, shards: int) -> None:
    """What the sharded kernels take: 1 to MAX_SHARDS shards that divide
    the node axis."""
    if not 1 <= shards <= MAX_SHARDS:
        raise ValueError(f"{shards} node shards: the sharded kernels take 1 to {MAX_SHARDS}, "
                         f"each a group of a cluster's CTAs")
    if n % shards:
        raise ValueError(f"node axis ({n}) must divide evenly across the mesh's 'nodes' "
                         f"extent ({shards}); pick a divisor shard count")


# ------------------------------------------------------------ shard views

_IP_MATS = ("matched", "have_req_anti", "have_req_aff", "sym_pref_aff", "sym_pref_anti")


def _cut(t: torch.Tensor, axis: int | None, n: int, lo: int, hi: int) -> torch.Tensor:
    """t's [lo, hi) along its node axis (None: t has none); a width-1 row
    (the compact always-pass rows of VolumeZone and VolumeBinding) stays
    as it is."""
    if axis is None or (t.shape[axis] == 1 and n != 1):
        return t
    if t.shape[axis] != n:
        raise ValueError(f"node axis {axis} of shape {tuple(t.shape)} is not {n}")
    return t.narrow(axis, lo, hi - lo)


def _axis(axes: dict, part: str, *path: str):
    try:
        for key in path:
            axes = axes[key]
    except (KeyError, TypeError):
        raise KeyError(f"{part} leaf {'.'.join(path)} has no entry in state/compile.py "
                       "NODE_AXES: declare its node axis there") from None
    return axes


def _cut_tree(tree: dict, part: str, n: int, lo: int, hi: int) -> dict:
    """Every tensor leaf of a statics, carry or one-pod xs tree cut to the
    nodes [lo, hi) along the axis NODE_AXES declares for it (a custom
    plugin's rows: CUSTOM_XS_AXES)."""
    axes = NODE_AXES[part]
    out = {}
    for name, v in tree.items():
        if isinstance(v, CustomXS):
            axes = {**axes, name: CUSTOM_XS_AXES}
        if isinstance(v, torch.Tensor):
            out[name] = _cut(v, _axis(axes, part, name), n, lo, hi)
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            out[name] = v._replace(**{
                f: _cut(getattr(v, f), _axis(axes, part, name, f), n, lo, hi)
                for f in v._fields if isinstance(getattr(v, f), torch.Tensor)})
        else:
            out[name] = v
    return out


class _Shard:
    """One shard's view of the workload, its carry and one pod's xs: every
    [.., N] leaf cut to the shard's nodes; cluster-wide leaves whole."""

    def __init__(self, cw, carry: dict, sl: dict, lo: int, hi: int):
        n = cw.n_nodes
        self.lo, self.hi = lo, hi
        self.statics = _cut_tree(cw.statics, "statics", n, lo, hi)
        self.carry = _cut_tree(carry, "carry", n, lo, hi)
        self.sl = _cut_tree(sl, "xs", n, lo, hi)
        # what _filter_one / _score_one read of a workload
        self.cw = _ShardWorkload(cw, self.statics, hi - lo)


class _ShardWorkload:
    __slots__ = ("statics", "n_nodes", "config", "schema")

    def __init__(self, cw, statics: dict, n: int):
        self.statics, self.n_nodes, self.config, self.schema = statics, n, cw.config, cw.schema


def _combine(parts: list, op):
    """The shards' partials folded in rank order."""
    acc = parts[0]
    for p in parts[1:]:
        acc = op(acc, p)
    return acc


def _skipped(sl: dict, name: str, flag: str) -> bool:
    x = sl.get(name)
    return x is not None and hasattr(x, flag) and bool(getattr(x, flag))


# ------------------------------------------------------------ the twins

def _eval_sharded(step, carry: dict, sl: dict, plan) -> StepOut | CompactOut:
    """One pod's step outputs against `carry`, without the bind, computed
    slice by slice over the node slices of `plan`, contiguous and in
    order (csrc/pod.cuh under ClusterScope, one slice a CTA:
    kernels/spec.py cta_slices).  An empty slice adds only identities to
    each combine, so it is left out."""
    cw = step.cw
    shards = [_Shard(cw, carry, sl, lo, hi) for lo, hi in plan if hi > lo]
    dev = carry["core"].requested.device
    reject = _prefilter_reject(cw, carry, sl)  # cluster-wide carries: no node axis

    # ---- 0. the spread minima: per-shard partials, min-combined
    slot_mins = None
    spread = "PodTopologySpread"
    if spread in step.filter_names and not _skipped(sl, spread, "filter_skip"):
        slot_mins = _combine([topologyspread.minima_partial(
            s.statics[spread], s.sl[spread], s.carry[spread]) for s in shards], torch.minimum)

    # ---- 1. filters over each shard's nodes; the feasible count summed
    codes, feas = [], []
    for s in shards:
        w = s.hi - s.lo
        rows = []
        ok = torch.ones(w, dtype=torch.bool, device=dev)
        for name in step.filter_names:
            if name == spread:
                code = topologyspread.filter_kernel(
                    s.statics[spread], s.sl[spread], s.carry[spread], slot_mins)
            else:
                code = _filter_one(name, s.cw, s.carry, s.sl)
            code = torch.broadcast_to(code, (w,))
            if _skipped(sl, name, "filter_skip"):
                code = torch.zeros_like(code)
            rows.append(code)
            ok = ok & (code == 0)
        codes.append(torch.stack(rows) if rows
                     else torch.zeros((0, w), dtype=torch.int32, device=dev))
        feas.append(ok)
    count = _combine([f.sum(dtype=torch.int64) for f in feas], torch.add)
    feasible_count = torch.where(reject > 0, 0, count).to(torch.int32)

    # ---- 2. raw scores over each shard's nodes (0 where the scorer Skips)
    raws, ignored = [], []
    for s, f in zip(shards, feas):
        rows = []
        ign = torch.zeros(s.hi - s.lo, dtype=torch.bool, device=dev)
        for name in step.score_names:
            if _skipped(sl, name, "score_skip"):
                rows.append(torch.zeros(s.hi - s.lo, dtype=torch.int64, device=dev))
                continue
            if name == spread:
                raw, ign = topologyspread.score_kernel(
                    s.statics[spread], s.sl[spread], s.carry[spread])
            else:
                raw, _ = _score_one(name, s.cw, s.carry, s.sl, f)
            rows.append(torch.broadcast_to(raw.to(torch.int64), (s.hi - s.lo,)))
        raws.append(rows)
        ignored.append(ign)
    overflow = None
    if step.out_mode == "compact" and step.score_names:
        overflow = _combine([step.raw_overflow(torch.stack(r)) for r in raws], torch.logical_or)

    # ---- 3/4. the normalizing scorers' reductions combined; normalize x
    # weight per shard; the argmax partials combined (value desc, index asc)
    finals = [[] for _ in shards]
    for k, name in enumerate(step.score_names):
        skip = _skipped(sl, name, "score_skip")
        rk = [r[k] for r in raws]
        if skip:
            normed = [torch.zeros_like(r) for r in rk]
        elif name in ("NodeAffinity", "TaintToleration"):
            hi = _combine([torch.where(f, r, 0).max() for r, f in zip(rk, feas)], torch.maximum)
            rev = name == "TaintToleration"
            normed = [default_normalize_apply(r, hi, rev) for r in rk]
        elif name == spread:
            scored = [f & ~i for f, i in zip(feas, ignored)]
            lo = _combine([torch.where(sc, r, _BIG).min() for r, sc in zip(rk, scored)],
                          torch.minimum)
            hi = _combine([torch.where(sc, r, 0).max() for r, sc in zip(rk, scored)],
                          torch.maximum)
            anys = _combine([sc.any() for sc in scored], torch.logical_or)
            normed = [topologyspread.normalize_apply(r, i, lo, hi, anys)
                      for r, i in zip(rk, ignored)]
        elif name == "InterPodAffinity":
            lo = _combine([torch.where(f, r, _BIG).min() for r, f in zip(rk, feas)],
                          torch.minimum)
            hi = _combine([torch.where(f, r, -_BIG).max() for r, f in zip(rk, feas)],
                          torch.maximum)
            normed = [interpod.normalize_apply(r, lo, hi) for r in rk]
        else:
            normed = rk  # no ScoreExtensions
        for j, v in enumerate(normed):
            finals[j].append(v * step.weights[k])
    best_v, best_i = None, None
    for s, f, fin in zip(shards, feas, finals):
        total = torch.zeros(s.hi - s.lo, dtype=torch.int64, device=dev)
        for v in fin:
            total = total + v
        total = torch.where(f, total, -1)
        i = int(torch.argmax(total))  # first max: the lowest node of the shard
        v = int(total[i])
        if best_v is None or v > best_v or (v == best_v and s.lo + i < best_i):
            best_v, best_i = v, s.lo + i
    selected = torch.tensor(best_i if int(feasible_count) > 0 else -1, dtype=torch.int32,
                            device=dev)
    is_pad = sl.get("is_pad")
    if is_pad is not None:
        selected = torch.where(is_pad, -1, selected)

    n_s = len(step.score_names)

    def cat(rows_by_shard, k):
        if k == 0:
            return torch.zeros((0, cw.n_nodes), dtype=torch.int64, device=dev)
        return torch.cat([torch.stack(r) for r in rows_by_shard], dim=1)

    return step.pod_out(torch.cat(codes, dim=1), cat(raws, n_s), cat(finals, n_s), selected,
                        feasible_count, reject, overflow)


def _bind_sharded(cw, carry: dict, sl: dict, selected, plan) -> dict:
    """The bind of one pod at `selected`, shard by shard (csrc/pod.cuh
    bind_pod): each shard's slice of the spread counts and the InterPod
    matrices takes its same-domain increments; the exactly-once updates
    (the selected node's core, NodePorts, disk and CSI rows, matched_total,
    the cluster-wide ReadWriteOncePod bits, VolumeBinding's claims) are
    made once, for the slice that owns the selected node."""
    sel = int(selected)
    coupled = ("PodTopologySpread", "InterPodAffinity")
    out = _bind_phase(cw, {k: v for k, v in carry.items() if k not in coupled}, sl, selected)
    for name in coupled:
        if name in carry:
            out[name] = carry[name]
    if sel < 0:
        return {k: out[k] for k in carry}
    if "PodTopologySpread" in carry:
        dom = cw.statics["PodTopologySpread"].dom_idx
        dcol = dom[:, sel]
        valid = (dcol >= 0) & sl["PodTopologySpread"].pm
        counts = carry["PodTopologySpread"].clone()
        for lo, hi in plan:
            same = (dom[:, lo:hi] == dcol[:, None]) & valid[:, None]
            counts[:, lo:hi] += same.to(counts.dtype)
        out["PodTopologySpread"] = counts
    if "InterPodAffinity" in carry:
        ic, pod = carry["InterPodAffinity"], sl["InterPodAffinity"]
        dom = cw.statics["InterPodAffinity"].dom_idx
        dcol = dom[:, sel]
        valid = dcol >= 0
        incs = (pod.t_matches, pod.h_req_anti, pod.h_req_aff, pod.h_pref_aff_w,
                pod.h_pref_anti_w)
        mats = {f: getattr(ic, f).clone() for f in _IP_MATS}
        for lo, hi in plan:
            same = (dom[:, lo:hi] == dcol[:, None]) & valid[:, None]
            for f, inc in zip(_IP_MATS, incs):
                m = mats[f]
                m[:, lo:hi] += torch.where(same, inc.to(m.dtype)[:, None], 0)
        # the owner's one update of the cluster-wide count
        total = ic.matched_total + torch.where(valid, pod.t_matches.to(torch.int32), 0)
        out["InterPodAffinity"] = ic._replace(matched_total=total, **mats)
    return {k: out[k] for k in carry}  # the carry's own order


def _stack_outs(step, outs: list):
    cls = StepOut if step.out_mode == "full" else CompactOut
    return cls(*[_stack([getattr(o, f) for o in outs]) for f in cls._fields])


def groups_of(step, groups: int | None) -> int:
    """The CTAs a shard of step's mesh: `groups`, or where it is None the
    card's usual plan, MAX_CTAS // S (a cluster of 16)."""
    return groups if groups else kspec.MAX_CTAS // step.cw.mesh.shape["nodes"]


def _plan(step, groups: int | None = None) -> tuple[tuple[int, int], ...]:
    """The CTA slices of the workload's mesh, each of its S shards a group
    of `groups` CTAs (groups_of) -> cta_slices(N, S, G), after node_slices'
    checks of the shard count and the node axis."""
    mesh = step.cw.mesh
    if mesh is None:
        raise ValueError("the node-sharded kernels run a workload sharded over a mesh "
                         "(parallel/mesh.py shard_workload)")
    n, shards = step.cw.n_nodes, mesh.shape["nodes"]
    node_slices(n, shards)
    g = groups_of(step, groups)
    if not 1 <= shards * g <= kspec.MAX_CTAS:
        raise ValueError(f"{shards} shards of {g} CTAs: a cluster holds 1 to {kspec.MAX_CTAS}")
    return kspec.cta_slices(n, shards, g)


def step_chunk_sharded_plain(step, carry: dict, xs_chunk: dict, groups: int | None = None):
    """The twin of step_chunk_sharded: a chunk of pods in order, each
    evaluated and bound slice by slice, each shard a group of `groups`
    CTAs (groups_of) -> (carry', stacked outs)."""
    plan = _plan(step, groups)
    outs = []
    for i in range(xs_chunk["is_pad"].shape[0]):
        sl = slice_pod(xs_chunk, i)
        out = _eval_sharded(step, carry, sl, plan)
        carry = _bind_sharded(step.cw, carry, sl, out.selected, plan)
        outs.append(out)
    return carry, _stack_outs(step, outs)


def spec_eval_sharded_plain(step, carry: dict, xs: dict, groups: int | None = None):
    """The twin of spec_eval_sharded: every pod of the batch against one
    frozen carry, slice by slice, each shard a group of `groups` CTAs
    (groups_of), no bind."""
    plan = _plan(step, groups)
    outs = [_eval_sharded(step, carry, slice_pod(xs, i), plan)
            for i in range(xs["is_pad"].shape[0])]
    return _stack_outs(step, outs)


# ------------------------------------------------------------ the wrappers

def step_chunk_sharded(step, carry: dict, xs_chunk: dict, *, _groups: int = 0):
    """B12 sharded_step: one chunk of pods -> (carry, StepOut / CompactOut
    with a leading pod axis), over the workload's mesh.  CUDA tensors: one
    launch of step_chunk's cluster kernel (csrc/step_kernel.cuh) at
    step_chunk's cluster size, each of the mesh's S shards a group of R / S
    CTAs (`step_chunk_sharded.groups` records it), carry updated in place.
    CPU tensors: step_chunk_sharded_plain.  For tests and measurement
    only, `_groups` forces the CTAs a shard (R = S x `_groups` <= 16; on
    the CPU, the twin's split)."""
    dev = carry["core"].requested.device
    if dev.type == "cpu":
        return step_chunk_sharded_plain(step, carry, xs_chunk, _groups or None)
    _plan(step, _groups or 1)  # the shard count and the node axis, before a launch
    shards = step.cw.mesh.shape["nodes"]
    kstep.check_device("step_chunk_sharded", dev, step.cw.statics, carry, xs_chunk)
    lib = kstep.load_lib("step")
    c = xs_chunk["is_pad"].shape[0]
    outs = kstep.alloc_outputs(step, c, dev)
    args = kstep.make_args(step, carry, xs_chunk, outs)
    ctas, *held = kstep.plan_cluster(lib, args, shards * _groups, dev, shards)  # to the launch
    kstep.check_launch("step_chunk_sharded", lib.kss_step_chunk(
        ctypes.byref(args), ctas, shards, kstep.stream_of(dev)))
    step_chunk_sharded.launches += 1
    step_chunk_sharded.groups = ctas // shards
    cls = StepOut if step.out_mode == "full" else CompactOut
    return carry, cls(**{k: outs[k] for k in cls._fields})


step_chunk_sharded.launches = 0
step_chunk_sharded.groups = None


def spec_eval_sharded(step, carry: dict, xs: dict, outs: dict | None = None, *,
                      _groups: int = 0, _light: bool | None = None):
    """B12 speculative_scores: every pod of the batch against one frozen
    carry, no bind -> StepOut / CompactOut with a leading pod axis, over
    the workload's mesh.  CUDA tensors: one launch of spec_eval's cluster
    kernel (kernels/spec.py launch_eval), one cluster a pod, each of the
    mesh's S shards a group of G CTAs (G as spec_eval picks its cluster
    size, from the batch; `spec_eval_sharded.groups` records it), in the
    CTA shape the plan picks (kernels/spec.py eval_light;
    `spec_eval_sharded.light`), into `outs` (kernels/spec.py
    round_outputs) when the caller allocated them;
    `spec_eval_sharded.batches` counts the launches by batch size.  CPU
    tensors: spec_eval_sharded_plain.  For tests and measurement only,
    `_groups` forces G (one of kernels/spec.py EVAL_SHARDS; on the CPU,
    the twin's split) and `_light` the CTA shape."""
    dev = carry["core"].requested.device
    if dev.type == "cpu":
        return spec_eval_sharded_plain(step, carry, xs, _groups or None)
    _plan(step, _groups or 1)
    if outs is None:
        outs = kstep.alloc_outputs(step, xs["is_pad"].shape[0], dev)
    spec_eval_sharded.groups, spec_eval_sharded.light = kspec.launch_eval(
        "spec_eval_sharded", [(step, carry, xs, outs)], _groups, step.cw.mesh.shape["nodes"],
        _light)
    spec_eval_sharded.launches += 1
    spec_eval_sharded.batches[xs["is_pad"].shape[0]] += 1
    cls = StepOut if step.out_mode == "full" else CompactOut
    return cls(**{k: outs[k] for k in cls._fields})


spec_eval_sharded.launches = 0
spec_eval_sharded.groups = None
spec_eval_sharded.light = None
spec_eval_sharded.batches = collections.Counter()
