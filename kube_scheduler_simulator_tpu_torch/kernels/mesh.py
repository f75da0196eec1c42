"""B12 and B12b: the node-sharded step and dense eval on one card and over
cards, each wrapper and, beside it, its plain PyTorch twin.

    kernel (csrc/)                       wrapper             plain twin                 JAX counterpart
    step_kernel.cuh step_chunk_kernel    step_chunk_sharded  step_chunk_sharded_plain   parallel/mesh.py:130 sharded_step
    spec_eval.cu spec_eval_cluster       spec_eval_sharded   spec_eval_sharded_plain    :143 speculative_scores
    step_kernel.cuh step_cards_kernel    step_chunk_cards    step_chunk_cards_plain     :130, shards on separate cards
    spec_eval.cu spec_eval_cards_kernel  spec_eval_cards     spec_eval_cards_plain      :143, shards on separate cards
    spec_commit.cu (B5, a card's slice)  spec_commit_cards   spec_commit_cards_plain    speculative.py:501 over cards

Over a card mesh (B12b; parallel/mesh.py) the workload is `Cards`, a part
a card (place_cards), and each card's kernel runs over its own slice under
csrc/scope.cuh PeerScope: every reduction over the nodes ends inside the
card, then across the cards of its "dp" row through an exchange buffer on
each card (Exchange), folded in card order.  The twins walk the per-card
tensors and fold the per-card partials in card order through the same
decomposition as B12's (_eval_shards, _bind_cards).  The B12b wrappers
issue every card's launch before they wait for any, then wait and raise
on the exchange's error word (a wait past the spin bound), and join the
outputs in card order on the mesh's first card.

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
import copy
import ctypes
import threading

import torch

from ..framework.pipeline import (CompactOut, StepOut, _bind_phase, _filter_one, _map_tree,
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


# B12b: the rows a bind reads at a selected node that may be another
# card's (csrc/common.cuh whole_at): every card of a card mesh keeps them
# whole, by part, component and field
WHOLE = {"statics": {("PodTopologySpread", "dom_idx"), ("InterPodAffinity", "dom_idx"),
                     ("VolumeBinding", "pv_node_ok")},
         "xs": {("VolumeBinding", "provision_ok")},
         "carry": set()}


def _cut_whole(tree: dict, part: str, n: int, lo: int, hi: int, lead: int) -> dict:
    """A card's tree with its WHOLE leaves cut to the nodes [lo, hi) (every
    other leaf is the card's slice already); `lead` leading axes (a pod
    axis) come before each leaf's NODE_AXES axis."""
    out = dict(tree)
    for comp, field in WHOLE[part]:
        v = tree.get(comp)
        if v is None:
            continue
        axis = _axis(NODE_AXES[part], part, comp, field)
        t = getattr(v, field)
        out[comp] = v._replace(**{field: _cut(t, axis + lead if axis >= 0 else axis, n, lo, hi)})
    return out


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

    @classmethod
    def of_card(cls, cw, statics: dict, carry: dict, sl: dict, lo: int, hi: int):
        """A card's view (B12b): its statics, carry and pod are its node
        slice already but for the rows every card keeps whole (WHOLE),
        which are cut here."""
        self = cls.__new__(cls)
        self.lo, self.hi = lo, hi
        self.statics = _cut_whole(statics, "statics", cw.n_nodes, lo, hi, 0)
        self.carry = carry
        self.sl = _cut_whole(sl, "xs", cw.n_nodes, lo, hi, 0)
        self.cw = _ShardWorkload(cw, self.statics, hi - lo)
        return self


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
    return _eval_shards(step, [_Shard(step.cw, carry, sl, lo, hi) for lo, hi in plan if hi > lo])


def _eval_shards(step, shards: list) -> StepOut | CompactOut:
    """One pod's step outputs over `shards` (_Shard views, contiguous and
    in node order: a plan's CTA slices, or a card mesh's cards), every
    reduction over the nodes a partial per shard folded in order; the
    node-axis outputs joined on the first shard's device."""
    cw = step.cw
    first = shards[0]
    carry, sl = first.carry, first.sl
    dev = carry["core"].requested.device
    # cluster-wide carries: no node axis, whole (replicated) on every shard
    reject = _prefilter_reject(first.cw, carry, sl)

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
    count = _combine([f.sum(dtype=torch.int64).to(dev) for f in feas], torch.add)
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


# ------------------------------------------------------------ B12b: cards
#
# A card mesh (parallel/mesh.py make_mesh over several cards, or
# `_virtual` cards) holds the workload as a `Cards` tree per part: card k
# of "dp" row r = k // S holds node shard j = k % S, every [.., N] leaf cut
# to [j N / S, (j + 1) N / S) but the WHOLE rows, and the cluster-wide
# carries replicated.  The rows of a "dp" row hold the same slices.

MAX_CARDS = 8  # csrc/scope.cuh KSS_MAX_CARDS
XHEAD, XW = 16, 16  # csrc/scope.cuh KSS_XHEAD, KSS_XW
XSLOTS = 256  # pod slots an exchange buffer holds
SPIN_BOUND = 1 << 34  # clock64() cycles a wait may take: about 8.7 s at 1.98 GHz
ERR_RESIDENT = 1000  # csrc/cluster.cuh KSS_ERR_RESIDENT


class Cards(tuple):
    """A workload tree (statics, xs or carry) over a card mesh: one part a
    card, in the mesh's card order, each part a dict on its card.  Setting
    a key (the padding mask of a chunk) sets it on every card."""

    def __new__(cls, parts, devices):
        self = super().__new__(cls, parts)
        self.devices = tuple(devices)
        return self

    def __setitem__(self, key: str, value: torch.Tensor) -> None:
        for part, dev in zip(self, self.devices):
            part[key] = value.to(dev)

    def map(self, fn) -> "Cards":
        return Cards([fn(p) for p in self], self.devices)


def _own(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """A contiguous copy of t on dev: a card's own tensor."""
    return torch.empty(t.shape, dtype=t.dtype, device=dev).copy_(t)


def _place_tree(tree: dict, part: str, n: int, lo: int, hi: int, dev, lead: int) -> dict:
    """Every tensor leaf of `tree` as card `dev` holds it: cut to the nodes
    [lo, hi) along its NODE_AXES axis (after `lead` leading axes), the
    WHOLE rows and the leaves without a node axis whole, each a copy of
    its own on dev."""
    axes = NODE_AXES[part]
    whole = WHOLE[part]

    def place(t, axis, key):
        if key in whole or axis is None:
            return _own(t, dev)
        return _own(_cut(t, axis + lead if axis >= 0 else axis, n, lo, hi), dev)

    out = {}
    for name, v in tree.items():
        comp_axes = {**axes, name: CUSTOM_XS_AXES} if isinstance(v, CustomXS) else axes
        if isinstance(v, torch.Tensor):
            out[name] = place(v, _axis(comp_axes, part, name), (name, None))
        elif isinstance(v, tuple) and hasattr(v, "_fields"):
            out[name] = v._replace(**{
                f: place(getattr(v, f), _axis(comp_axes, part, name, f), (name, f))
                for f in v._fields if isinstance(getattr(v, f), torch.Tensor)})
        else:
            out[name] = v
    return out


def place_cards(cw, mesh) -> tuple[Cards, Cards, Cards]:
    """The workload's (statics, xs, init_carry) over the mesh's cards."""
    n, shards = cw.n_nodes, mesh.shape["nodes"]
    sl = node_slices(n, shards)
    parts = ([], [], [])
    for k, dev in enumerate(mesh.cards):
        lo, hi = sl[k % shards]
        parts[0].append(_place_tree(cw.statics, "statics", n, lo, hi, dev, 0))
        parts[1].append(_place_tree(cw.xs, "xs", n, lo, hi, dev, 1))
        parts[2].append(_place_tree(cw.init_carry, "carry", n, lo, hi, dev, 0))
    return tuple(Cards(p, mesh.cards) for p in parts)


class _CardWorkload:
    """What the kernels' argument code reads of a workload, for card k: its
    statics, its nodes, where they start and the WHOLE rows' width."""

    __slots__ = ("statics", "n_nodes", "config", "schema", "node_base", "whole_n", "mesh")

    def __init__(self, cw, k: int):
        shards = cw.mesh.shape["nodes"]
        w = cw.n_nodes // shards
        self.statics, self.n_nodes = cw.statics[k], w
        self.config, self.schema, self.mesh = cw.config, cw.schema, None
        self.node_base, self.whole_n = (k % shards) * w, cw.n_nodes


def card_steps(step) -> list:
    """The step of each card of step's card mesh: step's plugins and
    layout over the card's workload (_CardWorkload), made once a step."""
    steps = getattr(step, "_card_steps", None)
    if steps is None:
        steps = []
        for k in range(len(step.cw.mesh.cards)):
            s = copy.copy(step)
            s.cw = _CardWorkload(step.cw, k)
            steps.append(s)
        step._card_steps = steps
    return steps


def _row_views(step, carry: Cards, sl: Cards, row: int, dev) -> list:
    """The _Shard views of one pod over the cards of "dp" row `row`, each
    card's tensors on `dev` (the twins fold on one device)."""
    cw, shards = step.cw, step.cw.mesh.shape["nodes"]
    views = []
    for j, (lo, hi) in enumerate(node_slices(cw.n_nodes, shards)):
        k = row * shards + j
        move = (lambda t: t.to(dev)) if cw.mesh.cards[k] != dev else (lambda t: t)
        views.append(_Shard.of_card(cw, _map_tree(move, cw.statics[k]), _map_tree(move, carry[k]),
                                    _map_tree(move, sl[k]), lo, hi))
    return views


def _cluster_wide(name: str, v, owner_v, dev):
    """Card copy `v` of carry component `name` with its cluster-wide leaves
    (no node axis) taken from the owner card's bound copy `owner_v`."""
    axes = NODE_AXES["carry"][name]
    if isinstance(v, torch.Tensor):
        return owner_v.to(dev) if axes is None else v
    return v._replace(**{f: getattr(owner_v, f).to(dev) for f in v._fields
                         if axes.get(f, 0) is None})


def _bind_cards(step, carry: Cards, sl: Cards, selected: int) -> Cards:
    """The bind of one pod at node `selected` (the mesh's index; -1 binds
    nothing) on every card, as csrc/pod.cuh bind_pod does under PeerScope:
    the card that owns the node makes the exactly-once row updates (core,
    NodePorts, disk and CSI rows) and, as every card does, the cluster-wide
    ones (the ReadWriteOncePod bits, VolumeBinding's claims, InterPod's
    matched_total); each card's slice of the spread counts and the InterPod
    matrices takes its same-domain increments, the domain read from the
    card's whole rows.  -> new per-card carries."""
    if selected < 0:
        return carry
    cw = step.cw
    shards = cw.mesh.shape["nodes"]
    w = cw.n_nodes // shards
    owner = selected // w
    coupled = ("PodTopologySpread", "InterPodAffinity")
    out, bound = [], {}
    for k, dev in enumerate(cw.mesh.cards):
        row, j = divmod(k, shards)
        lo = j * w
        view = _Shard.of_card(cw, cw.statics[k], carry[k], sl[k], lo, lo + w)
        base = {name: v for name, v in carry[k].items() if name not in coupled}
        ko = row * shards + owner
        if row not in bound:  # the owner card's bind, once a row
            ov = _Shard.of_card(cw, cw.statics[ko], carry[ko], sl[ko], owner * w, owner * w + w)
            sel_o = torch.tensor(selected - owner * w, dtype=torch.int32,
                                 device=cw.mesh.cards[ko])
            bound[row] = _bind_phase(ov.cw, {name: carry[ko][name] for name in base}, ov.sl,
                                     sel_o)
        new = bound[row] if k == ko else {name: _cluster_wide(name, v, bound[row][name], dev)
                                          for name, v in base.items()}
        new = {name: (v.to(dev) if isinstance(v, torch.Tensor) else
                      type(v)(*[a.to(dev) for a in v])) for name, v in new.items()}
        if "PodTopologySpread" in carry[k]:
            dom = view.statics["PodTopologySpread"].dom_idx
            dcol = cw.statics[k]["PodTopologySpread"].dom_idx[:, selected]
            valid = (dcol >= 0) & sl[k]["PodTopologySpread"].pm
            counts = carry[k]["PodTopologySpread"]
            new["PodTopologySpread"] = counts + (
                (dom == dcol[:, None]) & valid[:, None]).to(counts.dtype)
        if "InterPodAffinity" in carry[k]:
            ic, pod = carry[k]["InterPodAffinity"], sl[k]["InterPodAffinity"]
            dom = view.statics["InterPodAffinity"].dom_idx
            dcol = cw.statics[k]["InterPodAffinity"].dom_idx[:, selected]
            valid = dcol >= 0
            same = (dom == dcol[:, None]) & valid[:, None]
            incs = (pod.t_matches, pod.h_req_anti, pod.h_req_aff, pod.h_pref_aff_w,
                    pod.h_pref_anti_w)
            mats = {f: getattr(ic, f) + torch.where(same, inc.to(getattr(ic, f).dtype)[:, None], 0)
                    for f, inc in zip(_IP_MATS, incs)}
            total = ic.matched_total + torch.where(valid, pod.t_matches.to(torch.int32), 0)
            new["InterPodAffinity"] = ic._replace(matched_total=total, **mats)
        out.append({name: new[name] for name in carry[k]})  # the carry's own order
    return Cards(out, carry.devices)


def _pods(xs: dict, lo: int, hi: int) -> dict:
    """Pods [lo, hi) of a batch's xs."""
    return _map_tree(lambda a: a[lo:hi], xs)


def step_chunk_cards_plain(step, carry: Cards, xs_chunk: Cards):
    """The twin of step_chunk_cards: a chunk of pods in order, each
    evaluated over row 0's cards, their partials folded in card order, and
    bound on every card -> (carry', stacked outs on the mesh's first
    card)."""
    dev = step.cw.mesh.cards[0]
    outs = []
    for i in range(xs_chunk[0]["is_pad"].shape[0]):
        sl = xs_chunk.map(lambda x: slice_pod(x, i))
        out = _eval_shards(step, _row_views(step, carry, sl, 0, dev))
        carry = _bind_cards(step, carry, sl, int(out.selected))
        outs.append(out)
    return carry, _stack_outs(step, outs)


def _row_batches(step, xs: Cards, b: int) -> list:
    """Each card's pods of a batch of b: "dp" row r's cards take its r-th
    group of b / dp pods (JAX parallel/mesh.py:160-170)."""
    dp, shards = step.cw.mesh.shape["dp"], step.cw.mesh.shape["nodes"]
    if b % dp:
        raise ValueError(f"a batch of {b} pods does not split into the mesh's {dp} 'dp' rows")
    q = b // dp
    return [_pods(x, (k // shards) * q, (k // shards + 1) * q) for k, x in enumerate(xs)]


def spec_eval_cards_plain(step, carry: Cards, xs: Cards):
    """The twin of spec_eval_cards: every pod of the batch against one
    frozen carry, each "dp" row's group over that row's cards, the
    partials folded in card order, no bind -> outs on the first card."""
    dev = step.cw.mesh.cards[0]
    shards = step.cw.mesh.shape["nodes"]
    b = xs[0]["is_pad"].shape[0]
    mine = Cards(_row_batches(step, xs, b), xs.devices)
    outs = []
    for r in range(step.cw.mesh.shape["dp"]):
        for i in range(mine[r * shards]["is_pad"].shape[0]):
            sl = mine.map(lambda x: slice_pod(x, i) if x["is_pad"].shape[0] > i else x)
            outs.append(_eval_shards(step, _row_views(step, carry, sl, r, dev)))
    return _stack_outs(step, outs)


def spec_commit_cards_plain(step, carry: Cards, xs: Cards, selected, k: int) -> Cards:
    """The twin of spec_commit_cards: the batch's binds b < k folded in
    order on every card."""
    sel = selected.cpu().tolist()
    for b in range(min(int(k), len(sel))):
        carry = _bind_cards(step, carry, xs.map(lambda x: slice_pod(x, b)), int(sel[b]))
    return carry


class PeerArgs(ctypes.Structure):
    """Mirror of `struct PeerArgs` in csrc/scope.cuh."""

    _fields_ = [("xbuf", ctypes.c_void_p * MAX_CARDS), ("epoch", ctypes.c_longlong),
                ("bound", ctypes.c_longlong), ("cards", ctypes.c_int), ("slots", ctypes.c_int),
                ("card0", ctypes.c_int)]


# (card, peer) pairs whose peer access this process enabled (a second
# enable of a pair is no error, so two threads racing here are harmless)
_PEERS_ENABLED: set = set()


class Exchange:
    """A card mesh's exchange (csrc/scope.cuh PeerScope): a buffer on each
    card, zeroed once, and the epoch counter.  A launch takes epochs past
    the last launch's, so flags only grow; its lock keeps two threads'
    launches over one mesh from interleaving."""

    def __init__(self, mesh, lib):
        shards = mesh.shape["nodes"]
        self.mesh = mesh
        self.lock = threading.Lock()
        self.epoch = 0
        words = XHEAD + XSLOTS * 2 * shards * XW
        self.bufs = [torch.zeros(words, dtype=torch.int64, device=d) for d in mesh.cards]
        distinct = sorted({d.index for d in mesh.cards})
        for a in distinct:
            for b in distinct:
                if a != b and (a, b) not in _PEERS_ENABLED:
                    with torch.cuda.device(a):
                        kstep.check_launch(f"peer access cuda:{a} -> cuda:{b}",
                                           lib.kss_enable_peer(a, b))
                    _PEERS_ENABLED.add((a, b))

    def take(self, epochs: int) -> int:
        """The base epoch of a launch that takes up to `epochs` epochs."""
        base = self.epoch
        self.epoch += epochs + 1
        return base

    def args(self, base: int, slots: int, card0: int, bound: int) -> PeerArgs:
        p = PeerArgs()
        for k, buf in enumerate(self.bufs):
            p.xbuf[k] = buf.data_ptr()
        p.epoch, p.bound = base, bound
        p.cards, p.slots, p.card0 = self.mesh.shape["nodes"], slots, card0
        return p

    def check(self, what: str) -> None:
        """After the launches: raise where a card's wait ran past the spin
        bound (its buffer's error word: 1 + the card it waited for)."""
        words = [int(b[0]) for b in self.bufs]
        for b in self.bufs:
            b[0] = 0
        bad = [(k, w - 1) for k, w in enumerate(words) if w]
        if bad:
            raise RuntimeError(f"{what}: " + "; ".join(
                f"card {k} ({self.mesh.cards[k]}) waited past the spin bound for card {j} "
                f"({self.mesh.cards[j]})" for k, j in bad))


def exchange(mesh, lib) -> Exchange:
    x = getattr(mesh, "_exchange", None)
    if x is None:
        x = mesh._exchange = Exchange(mesh, lib)
    return x


def _launch_groups(mesh) -> list:
    """(card, mesh indices) of each launch: one launch of every card on
    virtual cards, else one a card."""
    if mesh.virtual:
        return [(mesh.cards[0], list(range(len(mesh.cards))))]
    return [(d, [k]) for k, d in enumerate(mesh.cards)]


def _table(args: list, ks: list):
    return (kstep.StepArgs * len(ks))(*[args[k] for k in ks])


def _join(step, dst: dict, outs: list, rows: int, q: int) -> None:
    """Each "dp" row's card outputs written into dst (full width, on the
    mesh's first card): row r's pods [r q, (r + 1) q), card j's nodes."""
    mesh = step.cw.mesh
    shards, w = mesh.shape["nodes"], step.cw.n_nodes // mesh.shape["nodes"]
    for r in range(rows):
        for j in range(shards):
            o = outs[r * shards + j]
            for f, t in o.items():
                if f in ("selected", "feasible_count", "prefilter_reject", "raw_overflow"):
                    if j == 0:
                        dst[f][r * q:(r + 1) * q].copy_(t)
                else:
                    kspec._bits(dst[f])[r * q:(r + 1) * q, ..., j * w:(j + 1) * w].copy_(
                        kspec._bits(t))


def _resident(what: str, plan: str, have: int, need: int) -> None:
    if have < need:
        raise RuntimeError(f"{what}: the card holds {have} clusters of the plan ({plan}) at "
                           f"once, the launch needs {need}: its clusters spin on each other")


def _finish(what: str, x: Exchange, mesh) -> None:
    for d in {d for d in mesh.cards}:
        torch.cuda.current_stream(d).synchronize()
    x.check(what)


def step_chunk_cards(step, carry: Cards, xs_chunk: Cards, *, _ctas: int = 0, _bound: int = 0,
                     _only: tuple | None = None, _events: tuple | None = None):
    """B12b sharded_step over a card mesh: one chunk of pods -> (carry,
    StepOut / CompactOut on the mesh's first card).  CUDA tensors: one
    launch of csrc/step_kernel.cuh step_cards_kernel a card (one launch of
    every card on virtual cards), all issued before any is awaited, a
    cluster of R CTAs a card, the cards of each "dp" row combining through
    the exchange; every card's carry updated in place; the wrapper waits
    for its launches and raises where a wait ran past the spin bound; the
    first row's outputs joined on the first card.  CPU tensors:
    step_chunk_cards_plain.  For tests and measurement only: `_ctas`
    forces R, `_bound` the spin bound in clock64() cycles, `_only` (mesh
    card indices) launches those cards alone, so their waits fail;
    `_events`, two CUDA events, are recorded on the first card's stream
    before the first launch and after the last (virtual cards: the
    launch's device time, without the wait and the join)."""
    mesh = step.cw.mesh
    if mesh.cards[0].type == "cpu":
        return step_chunk_cards_plain(step, carry, xs_chunk)
    lib = kstep.load_lib("step")
    steps = card_steps(step)
    c = xs_chunk[0]["is_pad"].shape[0]
    outs, args = [], []
    for k, dev in enumerate(mesh.cards):
        kstep.check_device("step_chunk_cards", dev, steps[k].cw.statics, carry[k], xs_chunk[k])
        outs.append(kstep.alloc_outputs(steps[k], c, dev))
        args.append(kstep.make_args(steps[k], carry[k], xs_chunk[k], outs[-1]))
    x = exchange(mesh, lib)
    held = []
    groups = _launch_groups(mesh)
    if _only is not None:
        groups = [(dev, [k for k in ks if k in _only]) for dev, ks in groups]
        groups = [(dev, ks) for dev, ks in groups if ks]
    with x.lock:
        base = x.take(3 * c + 1)
        if _events is not None:
            _events[0].record(torch.cuda.current_stream(mesh.cards[0]))
        for dev, ks in groups:
            ctas, spill, masks, resident = (ctypes.c_int(0), ctypes.c_longlong(0),
                                            ctypes.c_longlong(0), ctypes.c_int(0))
            with torch.cuda.device(dev):
                kstep.check_launch("step_chunk_cards plan", lib.kss_step_cards_plan(
                    _table(args, ks), len(ks), _ctas, dev.index, ctypes.byref(ctas),
                    ctypes.byref(spill), ctypes.byref(masks), ctypes.byref(resident)))
                _resident("step_chunk_cards", f"{ctas.value} CTAs a card", resident.value, len(ks))
                for k in ks:
                    if spill.value:
                        held.append(torch.empty(spill.value, dtype=torch.uint8, device=dev))
                        args[k].spill = held[-1].data_ptr()
                if masks.value:
                    held.append(kstep.vb_masks(masks.value, dev, [args[k] for k in ks]))
                peer = x.args(base, 1, ks[0], _bound or SPIN_BOUND)
                err = lib.kss_step_cards(_table(args, ks), len(ks), ctas.value,
                                         ctypes.byref(peer), dev.index, kstep.stream_of(dev))
            if err == ERR_RESIDENT:
                _resident("step_chunk_cards", f"{ctas.value} CTAs a card", 0, len(ks))
            kstep.check_launch("step_chunk_cards", err)
            step_chunk_cards.launches += 1
            step_chunk_cards.ctas = ctas.value
        if _events is not None:
            _events[1].record(torch.cuda.current_stream(mesh.cards[0]))
        _finish("step_chunk_cards", x, mesh)
    joined = kstep.alloc_outputs(step, c, mesh.cards[0])
    _join(step, joined, outs, 1, c)
    cls = StepOut if step.out_mode == "full" else CompactOut
    return carry, cls(**{k: joined[k] for k in cls._fields})


step_chunk_cards.launches = 0
step_chunk_cards.ctas = None


def spec_eval_cards(step, carry: Cards, xs: Cards, outs: dict | None = None, *, _ctas: int = 0,
                    _bound: int = 0, _events: tuple | None = None):
    """B12b speculative_scores over a card mesh: every pod of the batch
    against one frozen carry, no bind -> StepOut / CompactOut on the mesh's
    first card (into `outs` where the caller allocated them there).
    "dp" row r's cards take the batch's r-th group of b / dp pods.  CUDA
    tensors: one launch of csrc/spec_eval.cu spec_eval_cards_kernel a card
    (one of every card on virtual cards), all issued before any is
    awaited: a card's clusters are pod slots, as many as the card holds
    with every other card's (`spec_eval_cards.slots`), each walking its
    pods; the wrapper waits and raises as step_chunk_cards does.  CPU
    tensors: spec_eval_cards_plain.  `_ctas`, `_bound`, `_events`: as
    step_chunk_cards."""
    mesh = step.cw.mesh
    if mesh.cards[0].type == "cpu":
        return spec_eval_cards_plain(step, carry, xs)
    lib = kstep.load_lib("spec_eval")
    steps = card_steps(step)
    b = xs[0]["is_pad"].shape[0]
    mine = _row_batches(step, xs, b)
    q = b // mesh.shape["dp"]
    card_outs, args = [], []
    for k, dev in enumerate(mesh.cards):
        kstep.check_device("spec_eval_cards", dev, steps[k].cw.statics, carry[k], mine[k])
        card_outs.append(kstep.alloc_outputs(steps[k], q, dev))
        args.append(kstep.make_args(steps[k], carry[k], mine[k], card_outs[-1]))
    x = exchange(mesh, lib)
    held = []
    groups = _launch_groups(mesh)
    plans = []
    for dev, ks in groups:
        ctas, slots, spill, masks, resident = (ctypes.c_int(0), ctypes.c_int(0),
                                               ctypes.c_longlong(0), ctypes.c_longlong(0),
                                               ctypes.c_int(0))
        with torch.cuda.device(dev):
            kstep.check_launch("spec_eval_cards plan", lib.kss_eval_cards_plan(
                _table(args, ks), len(ks), _ctas, dev.index, ctypes.byref(ctas),
                ctypes.byref(slots), ctypes.byref(spill), ctypes.byref(masks),
                ctypes.byref(resident)))
        _resident("spec_eval_cards", f"{ctas.value} CTAs a pod", resident.value, len(ks))
        plans.append((ctas.value, slots.value, spill.value, masks.value))
    ctas = plans[0][0]
    # a row's cards walk the same pods in the same slots
    slots = min(XSLOTS, *(p[1] for p in plans))
    with x.lock:
        base = x.take(3 * -(-q // slots) + 1)
        if _events is not None:
            _events[0].record(torch.cuda.current_stream(mesh.cards[0]))
        for (dev, ks), (_, _, cta_spill, mask_bytes) in zip(groups, plans):
            with torch.cuda.device(dev):
                for k in ks:
                    if cta_spill:
                        held.append(torch.empty(cta_spill * slots * ctas, dtype=torch.uint8,
                                                device=dev))
                        args[k].spill = held[-1].data_ptr()
                if mask_bytes:  # the plan's slots, at least these
                    held.append(kstep.vb_masks(mask_bytes, dev, [args[k] for k in ks]))
                peer = x.args(base, slots, ks[0], _bound or SPIN_BOUND)
                err = lib.kss_eval_cards(_table(args, ks), len(ks), ctas, ctypes.byref(peer),
                                         dev.index, kstep.stream_of(dev))
            if err == ERR_RESIDENT:
                _resident("spec_eval_cards", f"{ctas} CTAs a pod, {slots} slots a card", 0,
                          len(ks) * slots)
            kstep.check_launch("spec_eval_cards", err)
            spec_eval_cards.launches += 1
        if _events is not None:
            _events[1].record(torch.cuda.current_stream(mesh.cards[0]))
        _finish("spec_eval_cards", x, mesh)
    spec_eval_cards.ctas, spec_eval_cards.slots = ctas, slots
    spec_eval_cards.batches[b] += 1
    if outs is None:
        outs = kstep.alloc_outputs(step, b, mesh.cards[0])
    _join(step, outs, card_outs, mesh.shape["dp"], q)
    cls = StepOut if step.out_mode == "full" else CompactOut
    return cls(**{k: outs[k] for k in cls._fields})


spec_eval_cards.launches = 0
spec_eval_cards.ctas = None
spec_eval_cards.slots = None
spec_eval_cards.batches = collections.Counter()


def spec_commit_cards(step, carry: Cards, xs: Cards, selected, k: int) -> Cards:
    """B5 over a card mesh: rows b < k of the batch bound into every card's
    carry.  CUDA tensors: B5's kernel (spec_commit_core on a core-only
    carry, else spec_commit_bind) on each card over its node slice, in
    place, `selected` the mesh's node indices (csrc/spec_commit.cu).  CPU
    tensors: spec_commit_cards_plain."""
    mesh = step.cw.mesh
    if mesh.cards[0].type == "cpu":
        return spec_commit_cards_plain(step, carry, xs, selected, k)
    kernel = kspec.spec_commit_core if kspec.core_only(carry[0]) else kspec.spec_commit_bind
    for j, (s, dev) in enumerate(zip(card_steps(step), mesh.cards)):
        with torch.cuda.device(dev):
            kspec._commit(kernel, s, carry[j], xs[j], selected.to(dev), k)
        spec_commit_cards.launches += 1
    return carry


spec_commit_cards.launches = 0
