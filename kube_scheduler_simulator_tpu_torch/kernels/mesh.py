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

Over a process mesh (B12c; parallel/distributed.py) card k is held by
process k: `Cards` holds this process's part alone (`Cards.ks` its mesh
index), each process launches its own card, and the exchange (Exchange)
takes one of two transports: on one host the buffers are the processes'
own allocations on their cards, opened by the others over CUDA IPC;
across hosts each process keeps its card's buffer and an outbox for each
other card of its row in page-locked host memory mapped into its card,
and its host relay (kernels/relay.py, csrc/relay.cpp) carries the
entries between the processes, armed while a launch is in flight.  After
the launch every card's outputs and error word are gathered through the
process group (_gather_cards), so every process joins the full outputs on
its own card and raises alike.  The twins fold
each combine's partials across the processes through the process group,
one gather a combine (_ProcFold), and each card binds from its own
tensors (_bind_card), as the kernels do.

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
import contextlib
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


_OPS = ("min", "max", "sum", "or")


def _fold_in_order(parts: list, ops) -> torch.Tensor:
    """Vectors of partials (int64, one a shard) folded in rank order,
    entry j by ops[j] (or every entry by `ops`, one name): csrc/scope.cuh
    op_apply."""
    code = torch.tensor([_OPS.index(o) for o in ([ops] * parts[0].shape[0]
                                                 if isinstance(ops, str) else ops)],
                        device=parts[0].device)
    acc = parts[0]
    for p in parts[1:]:
        acc = torch.where(code == 0, torch.minimum(acc, p), torch.where(
            code == 1, torch.maximum(acc, p), torch.where(code == 2, acc + p, acc | p)))
    return acc


def _argmax_in_order(pairs) -> int:
    """The (value, node) partials' argmax, value desc, node asc -> node."""
    best_v, best_i = None, None
    for v, i in pairs:
        if best_v is None or v > best_v or (v == best_v and i < best_i):
            best_v, best_i = v, i
    return best_i


class _Fold:
    """A pod's combines over shards all held here."""

    def __call__(self, parts: list, ops) -> torch.Tensor:
        return _fold_in_order(parts, ops)

    def argmax(self, pairs) -> int:
        return _argmax_in_order(pairs)


_FOLD = _Fold()


class _ProcFold(_Fold):
    """A pod's combines over the cards of "dp" row `row` of a process mesh
    (B12c): this process's partials folded, gathered from every process
    through the process group (once a combine), and the row's folded in
    card order.  Every process takes part in every gather, whichever row
    it serves."""

    def __init__(self, mesh, row: int):
        shards = mesh.shape["nodes"]
        self.peers = [mesh.procs[row * shards + j] for j in range(shards)]

    def __call__(self, parts: list, ops) -> torch.Tensor:
        from ..parallel import distributed

        every = distributed.all_gather(_fold_in_order(parts, ops))
        return _fold_in_order([every[q] for q in self.peers], ops)

    def argmax(self, pairs) -> int:
        from ..parallel import distributed

        mine = _argmax_in_order(pairs)
        v = next(v for v, i in pairs if i == mine)
        every = distributed.all_gather(torch.tensor([v, mine], dtype=torch.int64))
        return _argmax_in_order([(int(every[q][0]), int(every[q][1])) for q in self.peers])


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


def _eval_shards(step, shards: list, fold=None, out_step=None) -> StepOut | CompactOut:
    """One pod's step outputs over `shards` (_Shard views, contiguous and
    in node order: a plan's CTA slices, or a card mesh's cards), every
    reduction over the nodes a partial per shard folded in order by
    `fold` (_Fold: these shards alone; _ProcFold: with the shards of the
    other processes of a process mesh, one gather a combine, as PeerScope
    exchanges once a combine: the spread minima, one vector of the feasible
    count, the overflow and the normalizing reductions, and the argmax);
    the node-axis outputs joined on the first shard's device, as wide as
    `shards` (`out_step`'s node count: step's where they cover it)."""
    fold = fold or _FOLD
    out_step = out_step or step
    first = shards[0]
    carry, sl = first.carry, first.sl
    dev = carry["core"].requested.device
    # cluster-wide carries: no node axis, whole (replicated) on every shard
    reject = _prefilter_reject(first.cw, carry, sl)

    # ---- 0. the spread minima: per-shard partials, min-combined (for a
    # pod whose filter Skips too, so that every pod takes the same combines)
    slot_mins = None
    spread = "PodTopologySpread"
    if spread in step.filter_names:
        slot_mins = fold([topologyspread.minima_partial(
            s.statics[spread], s.sl[spread], s.carry[spread]) for s in shards], "min")

    # ---- 1. filters over each shard's nodes
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

    # ---- 3. one combine: the feasible count, the raw-overflow OR and the
    # normalizing scorers' reductions (every scorer's, Skip or not: the
    # vector's layout is the step's)
    ops, parts = [], [[] for _ in shards]

    def partial(op, values):
        ops.append(op)
        for part, v in zip(parts, values):
            part.append(v.to(torch.int64))

    partial("sum", [f.sum() for f in feas])
    has_overflow = step.out_mode == "compact" and bool(step.score_names)
    if has_overflow:
        partial("or", [step.raw_overflow(torch.stack(r)) for r in raws])
    for k, name in enumerate(step.score_names):
        rk = [r[k] for r in raws]
        if name in ("NodeAffinity", "TaintToleration"):
            partial("max", [torch.where(f, r, 0).max() for r, f in zip(rk, feas)])
        elif name == spread:
            scored = [f & ~i for f, i in zip(feas, ignored)]
            partial("min", [torch.where(sc, r, _BIG).min() for r, sc in zip(rk, scored)])
            partial("max", [torch.where(sc, r, 0).max() for r, sc in zip(rk, scored)])
            partial("or", [sc.any() for sc in scored])
        elif name == "InterPodAffinity":
            partial("min", [torch.where(f, r, _BIG).min() for r, f in zip(rk, feas)])
            partial("max", [torch.where(f, r, -_BIG).max() for r, f in zip(rk, feas)])
    stats = iter(fold([torch.stack(p) for p in parts], ops))
    count = next(stats)
    feasible_count = torch.where(reject > 0, 0, count).to(torch.int32)
    overflow = (next(stats) != 0) if has_overflow else None

    # ---- 4. normalize x weight per shard; the argmax partials combined
    # (value desc, index asc)
    finals = [[] for _ in shards]
    for k, name in enumerate(step.score_names):
        skip = _skipped(sl, name, "score_skip")
        rk = [r[k] for r in raws]
        if name in ("NodeAffinity", "TaintToleration"):
            hi = next(stats)
            rev = name == "TaintToleration"
            normed = None if skip else [default_normalize_apply(r, hi, rev) for r in rk]
        elif name == spread:
            lo, hi, anys = next(stats), next(stats), next(stats) != 0
            normed = None if skip else [topologyspread.normalize_apply(r, i, lo, hi, anys)
                                        for r, i in zip(rk, ignored)]
        elif name == "InterPodAffinity":
            lo, hi = next(stats), next(stats)
            normed = None if skip else [interpod.normalize_apply(r, lo, hi) for r in rk]
        else:
            normed = rk  # no ScoreExtensions
        if skip:
            normed = [torch.zeros_like(r) for r in rk]
        for j, v in enumerate(normed):
            finals[j].append(v * step.weights[k])
    pairs = []
    for s, f, fin in zip(shards, feas, finals):
        total = torch.zeros(s.hi - s.lo, dtype=torch.int64, device=dev)
        for v in fin:
            total = total + v
        total = torch.where(f, total, -1)
        i = int(torch.argmax(total))  # first max: the lowest node of the shard
        pairs.append((int(total[i]), s.lo + i))
    best_i = fold.argmax(pairs)
    selected = torch.tensor(best_i if int(feasible_count) > 0 else -1, dtype=torch.int32,
                            device=dev)
    is_pad = sl.get("is_pad")
    if is_pad is not None:
        selected = torch.where(is_pad, -1, selected)

    n_s = len(step.score_names)

    def cat(rows_by_shard, k):
        if k == 0:
            return torch.zeros((0, out_step.cw.n_nodes), dtype=torch.int64, device=dev)
        return torch.cat([torch.stack(r) for r in rows_by_shard], dim=1)

    return out_step.pod_out(torch.cat(codes, dim=1), cat(raws, n_s), cat(finals, n_s), selected,
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
RELAY_LOST = 1 + MAX_CARDS  # error word RELAY_LOST + j: the relay lost card j (csrc/relay.cpp)


class Cards(tuple):
    """A workload tree (statics, xs or carry) over a card mesh: one part a
    card this process holds, in the mesh's card order (every card, but on
    a process mesh, B12c, where a process holds its own), each part a
    dict on its card; `ks` are the parts' mesh indices.  Setting a key
    (the padding mask of a chunk) sets it on every part."""

    def __new__(cls, parts, devices, ks=None):
        self = super().__new__(cls, parts)
        self.devices = tuple(devices)
        self.ks = tuple(range(len(self))) if ks is None else tuple(ks)
        return self

    def __setitem__(self, key: str, value: torch.Tensor) -> None:
        for part, dev in zip(self, self.devices):
            part[key] = value.to(dev)

    def map(self, fn) -> "Cards":
        return Cards([fn(p) for p in self], self.devices, self.ks)


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
    """The workload's (statics, xs, init_carry) over the cards of the mesh
    that this process holds (every card, but on a process mesh)."""
    n, shards = cw.n_nodes, mesh.shape["nodes"]
    sl = node_slices(n, shards)
    parts = ([], [], [])
    for k in mesh.local:
        dev = mesh.cards[k]
        lo, hi = sl[k % shards]
        parts[0].append(_place_tree(cw.statics, "statics", n, lo, hi, dev, 0))
        parts[1].append(_place_tree(cw.xs, "xs", n, lo, hi, dev, 1))
        parts[2].append(_place_tree(cw.init_carry, "carry", n, lo, hi, dev, 0))
    devices = [mesh.cards[k] for k in mesh.local]
    return tuple(Cards(p, devices, mesh.local) for p in parts)


class _CardWorkload:
    """What the kernels' argument code reads of a workload, for the card of
    mesh index k (this process's part i): its statics, its nodes, where
    they start and the WHOLE rows' width."""

    __slots__ = ("statics", "n_nodes", "config", "schema", "node_base", "whole_n", "mesh")

    def __init__(self, cw, i: int, k: int):
        shards = cw.mesh.shape["nodes"]
        w = cw.n_nodes // shards
        self.statics, self.n_nodes = cw.statics[i], w
        self.config, self.schema, self.mesh = cw.config, cw.schema, None
        self.node_base, self.whole_n = (k % shards) * w, cw.n_nodes


def card_steps(step) -> list:
    """The step of each card this process holds of step's card mesh:
    step's plugins and layout over the card's workload (_CardWorkload),
    made once a step."""
    steps = getattr(step, "_card_steps", None)
    if steps is None:
        steps = []
        for i, k in enumerate(step.cw.mesh.local):
            s = copy.copy(step)
            s.cw = _CardWorkload(step.cw, i, k)
            steps.append(s)
        step._card_steps = steps
    return steps


def _row_views(step, carry: Cards, sl: Cards, row: int, dev) -> list:
    """The _Shard views of one pod over the cards of "dp" row `row` that
    this process holds, each card's tensors on `dev` (the twins fold on
    one device)."""
    cw, shards = step.cw, step.cw.mesh.shape["nodes"]
    slices = node_slices(cw.n_nodes, shards)
    views = []
    for i, k in enumerate(carry.ks):
        if k // shards != row:
            continue
        lo, hi = slices[k % shards]
        move = (lambda t: t.to(dev)) if carry.devices[i] != dev else (lambda t: t)
        views.append(_Shard.of_card(cw, _map_tree(move, cw.statics[i]), _map_tree(move, carry[i]),
                                    _map_tree(move, sl[i]), lo, hi))
    return views


def _twin_fold(step):
    """(the "dp" row the twins walk, its _Fold, the step that sizes their
    outputs): row 0, the in-order fold and the full step where this
    process holds every card; on a process mesh the row of this process's
    card, the fold across processes and the card's own step."""
    mesh = step.cw.mesh
    if mesh.procs is None:
        return 0, _FOLD, step
    (k,) = mesh.local
    row = k // mesh.shape["nodes"]
    return row, _ProcFold(mesh, row), card_steps(step)[0]


_COUPLED = ("PodTopologySpread", "InterPodAffinity")


def _cluster_wide(name: str, v, bound_v):
    """Carry component `name` of a card with its cluster-wide leaves (no
    node axis) taken from `bound_v`, the same component after the bind."""
    axes = NODE_AXES["carry"][name]
    if isinstance(v, torch.Tensor):
        return bound_v if axes is None else v
    return v._replace(**{f: getattr(bound_v, f) for f in v._fields if axes.get(f, 0) is None})


def _bind_card(step, i: int, k: int, carry: dict, sl: dict, selected: int) -> dict:
    """The bind of one pod at node `selected` (the mesh's index, >= 0) on
    the card of mesh index k (this process's part i), from the card's own
    tensors alone, as csrc/pod.cuh bind_pod does under PeerScope: the card
    that owns the node makes the exactly-once row updates (core,
    NodePorts, disk and CSI rows); every card makes the cluster-wide ones
    (the ReadWriteOncePod bits, VolumeBinding's claims, InterPod's
    matched_total) from its whole rows (WHOLE) at the node, over a
    one-node view of its tensors; each card's slice of the spread counts
    and the InterPod matrices takes its same-domain increments, the domain
    read from the card's whole rows.  -> the card's new carry."""
    cw = step.cw
    n, shards = cw.n_nodes, cw.mesh.shape["nodes"]
    w = n // shards
    lo = (k % shards) * w
    statics = cw.statics[i]
    dev = carry["core"].requested.device
    base = {name: v for name, v in carry.items() if name not in _COUPLED}
    if lo <= selected < lo + w:
        view = _Shard.of_card(cw, statics, carry, sl, lo, lo + w)
        new = _bind_phase(view.cw, base, view.sl,
                          torch.tensor(selected - lo, dtype=torch.int32, device=dev))
    else:
        one = _cut_tree(_cut_whole(statics, "statics", n, selected, selected + 1, 0), "statics",
                        w, 0, 1)
        sl1 = _cut_tree(_cut_whole(sl, "xs", n, selected, selected + 1, 0), "xs", w, 0, 1)
        bound = _bind_phase(_ShardWorkload(cw, one, 1), _cut_tree(base, "carry", w, 0, 1), sl1,
                            torch.tensor(0, dtype=torch.int32, device=dev))
        new = {name: _cluster_wide(name, v, bound[name]) for name, v in base.items()}
    if "PodTopologySpread" in carry:
        dom = statics["PodTopologySpread"].dom_idx
        dcol = dom[:, selected]
        valid = (dcol >= 0) & sl["PodTopologySpread"].pm
        counts = carry["PodTopologySpread"]
        new["PodTopologySpread"] = counts + (
            (dom[:, lo:lo + w] == dcol[:, None]) & valid[:, None]).to(counts.dtype)
    if "InterPodAffinity" in carry:
        ic, pod = carry["InterPodAffinity"], sl["InterPodAffinity"]
        dom = statics["InterPodAffinity"].dom_idx
        dcol = dom[:, selected]
        valid = dcol >= 0
        same = (dom[:, lo:lo + w] == dcol[:, None]) & valid[:, None]
        incs = (pod.t_matches, pod.h_req_anti, pod.h_req_aff, pod.h_pref_aff_w,
                pod.h_pref_anti_w)
        mats = {f: getattr(ic, f) + torch.where(same, inc.to(getattr(ic, f).dtype)[:, None], 0)
                for f, inc in zip(_IP_MATS, incs)}
        total = ic.matched_total + torch.where(valid, pod.t_matches.to(torch.int32), 0)
        new["InterPodAffinity"] = ic._replace(matched_total=total, **mats)
    return {name: new[name] for name in carry}  # the carry's own order


def _bind_cards(step, carry: Cards, sl: Cards, selected: int) -> Cards:
    """The bind of one pod at node `selected` (the mesh's index; -1 binds
    nothing) on every card this process holds (_bind_card) -> new
    per-card carries."""
    if selected < 0:
        return carry
    return Cards([_bind_card(step, i, k, carry[i], sl[i], selected)
                  for i, k in enumerate(carry.ks)], carry.devices, carry.ks)


def _pods(xs: dict, lo: int, hi: int) -> dict:
    """Pods [lo, hi) of a batch's xs."""
    return _map_tree(lambda a: a[lo:hi], xs)


def _proc_join(step, stacked, rows: int, q: int):
    """A process mesh's twin outputs: this process's card's (`stacked`,
    the card's width) gathered with every other card's through the
    process group and joined on this process's card, as the wrappers join
    theirs."""
    mesh = step.cw.mesh
    joined = kstep.alloc_outputs(step, rows * q, mesh.cards[mesh.local[0]])
    mine = {f: getattr(stacked, f) for f in stacked._fields}
    _join(step, joined, _gather_cards(mesh, mine, [0])[0], rows, q)
    return type(stacked)(**{f: joined[f] for f in stacked._fields})


def step_chunk_cards_plain(step, carry: Cards, xs_chunk: Cards):
    """The twin of step_chunk_cards: a chunk of pods in order, each
    evaluated over row 0's cards (a process mesh: over the row of this
    process's card, the other cards' partials through the process group),
    their partials folded in card order, and bound on every card ->
    (carry', stacked outs on the mesh's first card; a process mesh's
    joined on this process's card)."""
    row, fold, out_step = _twin_fold(step)
    dev = carry.devices[0]
    c = xs_chunk[0]["is_pad"].shape[0]
    outs = []
    for i in range(c):
        sl = xs_chunk.map(lambda x: slice_pod(x, i))
        out = _eval_shards(step, _row_views(step, carry, sl, row, dev), fold, out_step)
        carry = _bind_cards(step, carry, sl, int(out.selected))
        outs.append(out)
    stacked = _stack_outs(out_step, outs)
    if step.cw.mesh.procs is None:
        return carry, stacked
    return carry, _proc_join(step, stacked, 1, c)


def _row_batches(step, xs: Cards, b: int) -> list:
    """Each held card's pods of a batch of b: "dp" row r's cards take its
    r-th group of b / dp pods (JAX parallel/mesh.py:160-170)."""
    dp, shards = step.cw.mesh.shape["dp"], step.cw.mesh.shape["nodes"]
    if b % dp:
        raise ValueError(f"a batch of {b} pods does not split into the mesh's {dp} 'dp' rows")
    q = b // dp
    return [_pods(x, (k // shards) * q, (k // shards + 1) * q) for k, x in zip(xs.ks, xs)]


def spec_eval_cards_plain(step, carry: Cards, xs: Cards):
    """The twin of spec_eval_cards: every pod of the batch against one
    frozen carry, each "dp" row's group over that row's cards, the
    partials folded in card order, no bind -> outs on the first card (a
    process mesh: each process its row's group, joined on its card)."""
    dp = step.cw.mesh.shape["dp"]
    dev = carry.devices[0]
    b = xs[0]["is_pad"].shape[0]
    q = b // dp
    mine = Cards(_row_batches(step, xs, b), xs.devices, xs.ks)
    row, fold, out_step = _twin_fold(step)
    rows = range(dp) if step.cw.mesh.procs is None else (row,)
    outs = []
    for r in rows:
        for i in range(q):
            sl = mine.map(lambda x: slice_pod(x, i))
            outs.append(_eval_shards(step, _row_views(step, carry, sl, r, dev), fold, out_step))
    stacked = _stack_outs(out_step, outs)
    if step.cw.mesh.procs is None:
        return stacked
    return _proc_join(step, stacked, dp, q)


def spec_commit_cards_plain(step, carry: Cards, xs: Cards, selected, k: int) -> Cards:
    """The twin of spec_commit_cards: the batch's binds b < k folded in
    order on every card this process holds."""
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
IPC_HANDLE_BYTES = 64  # sizeof(cudaIpcMemHandle_t), csrc/step.cu


class _DeviceWords:
    """`__cuda_array_interface__` of `words` int64 at a device pointer:
    torch.as_tensor wraps it without a copy (the exchange buffer this
    process allocated, which outlives the tensor)."""

    def __init__(self, ptr: int, words: int):
        self.__cuda_array_interface__ = {"shape": (words,), "typestr": "<i8",
                                         "data": (ptr, False), "version": 2, "strides": None}


class Exchange:
    """A card mesh's exchange (csrc/scope.cuh PeerScope): a buffer on each
    card, zeroed once, and the epoch counter.  A launch takes epochs past
    the last launch's, so flags only grow; its lock keeps two threads'
    launches over one mesh from interleaving.  On a process mesh (B12c)
    `transport` is "ipc" where its processes share a host: each process
    allocates its own card's buffer (csrc/step.cu kss_ipc_export),
    publishes its IPC handle through the coordinator's store and opens
    every other card's (kss_ipc_open; `ipc_opened` counts the handles
    opened in this process).  Where they span hosts it is "relay": each
    process allocates its card's buffer (the inbox) and an outbox for each
    other card of its row in page-locked host memory mapped into its card
    (kss_mapped_alloc), and its Relay carries the outboxes' entries to
    their cards' processes.  `ptrs` are every card's buffer as this
    process's card addresses it, `bufs` its own cards' (a CPU view of the
    inbox on the relay).  Every process issues the same launches in the
    same order (SPMD), so their epochs agree with no exchange of their
    own; a process that strays makes its peers' waits run past the spin
    bound, which raises."""

    ipc_opened = 0

    def __init__(self, mesh, lib):
        shards = mesh.shape["nodes"]
        self.mesh = mesh
        self.lock = threading.Lock()
        self.epoch = 0
        self.words = XHEAD + XSLOTS * 2 * shards * XW
        self.relay = None
        if mesh.procs is not None:
            if len(set(mesh.hosts)) > 1:
                self.transport = "relay"
                self._open_relay()
            else:
                self.transport = "ipc"
                self._open_ipc()
            return
        self.transport = "local"
        self.bufs = [torch.zeros(self.words, dtype=torch.int64, device=d) for d in mesh.cards]
        self.ptrs = [b.data_ptr() for b in self.bufs]
        distinct = sorted({d.index for d in mesh.cards})
        for a in distinct:
            for b in distinct:
                if a != b and (a, b) not in _PEERS_ENABLED:
                    with torch.cuda.device(a):
                        kstep.check_launch(f"peer access cuda:{a} -> cuda:{b}",
                                           lib.kss_enable_peer(a, b))
                    _PEERS_ENABLED.add((a, b))

    def _open_ipc(self) -> None:
        from ..parallel import distributed

        mesh = self.mesh
        lib = kstep.load_lib("step")
        store = distributed.store()
        key = distributed.next_key("x")
        self.ptrs = [0] * len(mesh.cards)
        self.owned, self.opened, self.bufs = [], [], []
        for k in mesh.local:
            dev = mesh.cards[k]
            ptr, handle = ctypes.c_void_p(), ctypes.create_string_buffer(IPC_HANDLE_BYTES)
            kstep.check_launch(f"exchange buffer on {dev}", lib.kss_ipc_export(
                dev.index, self.words * 8, ctypes.byref(ptr), handle))
            self.owned.append((dev, ptr.value))
            self.ptrs[k] = ptr.value
            self.bufs.append(torch.as_tensor(_DeviceWords(ptr.value, self.words), device=dev))
            store.set(f"{key}/{k}", handle.raw)
        home = mesh.cards[mesh.local[0]]
        for k in range(len(mesh.cards)):
            if k in mesh.local:
                continue
            ptr = ctypes.c_void_p()
            kstep.check_launch(
                f"exchange buffer of card {k} (process {mesh.procs[k]}) opened on {home}",
                lib.kss_ipc_open(home.index, store.get(f"{key}/{k}"), ctypes.byref(ptr)))
            Exchange.ipc_opened += 1
            self.opened.append((home, ptr.value))
            self.ptrs[k] = ptr.value
        distributed.on_shutdown(self.close)

    def _open_relay(self) -> None:
        from ..parallel import distributed
        from . import relay as krelay

        mesh = self.mesh
        lib = kstep.load_lib("step")
        (k,) = mesh.local
        dev, shards = mesh.cards[k], mesh.shape["nodes"]
        row = range(k // shards * shards, (k // shards + 1) * shards)
        self.ptrs = [0] * len(mesh.cards)
        self.mapped, host = [], {}
        for j in row:
            h, d = ctypes.c_void_p(), ctypes.c_void_p()
            kstep.check_launch(
                f"{card_name(mesh, k)}: mapped host buffer for card {j}",
                lib.kss_mapped_alloc(dev.index, self.words * 8, ctypes.byref(h), ctypes.byref(d)))
            self.mapped.append(h.value)
            host[j], self.ptrs[j] = h.value, d.value
        self.bufs = [torch.frombuffer((ctypes.c_int64 * self.words).from_address(host[k]),
                                      dtype=torch.int64)]
        distributed.on_shutdown(self.close)
        self.relay = krelay.Relay(distributed.next_key("x"), k, shards, XSLOTS, host[k],
                                  {j: host[j] for j in row if j != k}, mesh.procs)

    def close(self) -> None:
        """A process mesh's: wait until every process has ended its launches;
        on the relay stop it (its sockets closed) and free the mapped
        buffers, over IPC close the opened handles, wait until every
        process has closed its own and free this process's buffers."""
        import torch.distributed as dist

        lib = kstep.load_lib("step")
        if self.transport == "relay":
            torch.cuda.synchronize(self.mesh.cards[self.mesh.local[0]])
            dist.barrier()
            if self.relay is not None:
                self.relay.stop()
            self.bufs = []
            for h in self.mapped:
                kstep.check_launch("freeing a mapped exchange buffer", lib.kss_mapped_free(h))
            self.mapped = []
            return
        for dev, _ in self.owned + self.opened:
            torch.cuda.synchronize(dev)
        for dev, ptr in self.opened:
            kstep.check_launch("closing an exchange buffer", lib.kss_ipc_close(dev.index, ptr, 1))
        self.opened, self.bufs = [], []
        dist.barrier()
        for dev, ptr in self.owned:
            kstep.check_launch("freeing an exchange buffer", lib.kss_ipc_close(dev.index, ptr, 0))
        self.owned = []

    def take(self, epochs: int) -> int:
        """The base epoch of a launch that takes up to `epochs` epochs."""
        base = self.epoch
        self.epoch += epochs + 1
        return base

    @contextlib.contextmanager
    def armed(self, slots: int):
        """Around a launch over `slots` pod slots and its wait: the relay
        spins while it is in flight (nothing for the other transports)."""
        if self.relay is None:
            yield
            return
        self.relay.arm(slots)
        try:
            yield
        finally:
            self.relay.park()

    def args(self, base: int, slots: int, card0: int, bound: int) -> PeerArgs:
        p = PeerArgs()
        for k, ptr in enumerate(self.ptrs):
            p.xbuf[k] = ptr
        p.epoch, p.bound = base, bound
        p.cards, p.slots, p.card0 = self.mesh.shape["nodes"], slots, card0
        return p

    def errors(self) -> list[int]:
        """After the launches: the error word of each buffer this process
        holds (0; 1 + the card its wait ran past the spin bound for; on the
        relay RELAY_LOST + the card whose connection it lost), each reset."""
        words = [int(b[0]) for b in self.bufs]
        for b in self.bufs:
            b[0] = 0
        return words

    def check(self, what: str, words: list[int], ks=None) -> None:
        """Raise where a card's wait ran past the spin bound or its relay
        lost a connection; `words` are the error words of the cards `ks`
        (every card, in mesh order, by default)."""
        ks = range(len(words)) if ks is None else ks
        bad = [error_says(self.mesh, k, w) for k, w in zip(ks, words) if w]
        if bad:
            raise RuntimeError(f"{what}: " + "; ".join(bad))


def card_name(mesh, k: int) -> str:
    """Card k of a card mesh as a message names it: its device, and on a
    process mesh its process and host."""
    where = str(mesh.cards[k])
    return where if mesh.procs is None else f"process {mesh.procs[k]} on {mesh.hosts[k]}:{where}"


def error_says(mesh, k: int, word: int) -> str:
    """What error word `word` (not 0) of card k's exchange buffer says."""
    if word >= RELAY_LOST:
        j = word - RELAY_LOST
        return (f"card {k} ({card_name(mesh, k)}) lost its relay connection to card {j} "
                f"({card_name(mesh, j)})")
    return (f"card {k} ({card_name(mesh, k)}) waited past the spin bound for card {word - 1} "
            f"({card_name(mesh, word - 1)})")


def exchange(mesh, lib) -> Exchange:
    x = getattr(mesh, "_exchange", None)
    if x is None:
        x = mesh._exchange = Exchange(mesh, lib)
    return x


def _gather_cards(mesh, outs: dict, words: list[int]) -> tuple[list[dict], list[int]]:
    """A process mesh's card outputs and error words: this process's card's
    `outs` (a dict of tensors, the same shapes on every card) and error
    word, gathered through the process group in one collective (every
    process calls it) -> every card's outputs, on this process's card, and
    error words, in mesh order."""
    from ..parallel import distributed

    dev = mesh.cards[mesh.local[0]]
    keys = list(outs)
    flat = [torch.tensor(words, dtype=torch.int64)] + [
        outs[f].detach().reshape(-1).cpu() for f in keys]
    sizes = [t.numel() * t.element_size() for t in flat]
    every = distributed.all_gather(torch.cat([t.contiguous().view(torch.uint8) for t in flat]))
    cards, errs = [None] * len(mesh.cards), [0] * len(mesh.cards)
    for k, q in enumerate(mesh.procs):
        pieces = every[q].split(sizes)
        errs[k] = int(pieces[0].clone().view(torch.int64)[0])
        # a piece may start at any byte: each is copied before its view
        cards[k] = {f: p.clone().view(outs[f].dtype).reshape(outs[f].shape).to(dev)
                    for f, p in zip(keys, pieces[1:])}
    return cards, errs


def _launch_groups(mesh) -> list:
    """(card, this process's part indices) of each launch: one launch of
    every card on virtual cards, else one a card."""
    if mesh.virtual:
        return [(mesh.cards[0], list(range(len(mesh.cards))))]
    return [(mesh.cards[k], [i]) for i, k in enumerate(mesh.local)]


def _table(args: list, ids: list):
    return (kstep.StepArgs * len(ids))(*[args[i] for i in ids])


def _join(step, dst: dict, outs: list, rows: int, q: int) -> None:
    """Each "dp" row's card outputs (`outs` in mesh order) written into dst
    (full width, on the mesh's first card, or this process's card):
    row r's pods [r q, (r + 1) q), card j's nodes."""
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


def _finish(what: str, x: Exchange, mesh, outs: list) -> list:
    """Wait for this process's launches and raise where a wait ran past the
    spin bound -> every card's outputs in mesh order.  On a process mesh
    the other cards' outputs and error words come through the process
    group, so every process raises alike; a relay that lost a connection
    raises before the gather (its peer may be gone)."""
    for d in {mesh.cards[k] for k in mesh.local}:
        torch.cuda.current_stream(d).synchronize()
    words = x.errors()
    if mesh.procs is not None:
        x.check(what, [w if w >= RELAY_LOST else 0 for w in words], mesh.local)
        (mine,) = outs
        outs, words = _gather_cards(mesh, mine, words)
    x.check(what, words)
    return outs


def _agreed_slots(step, q: int, ctas: int, slots: int) -> int:
    """The pod slots of a launch on every card: this process's plan's, and
    on a process mesh the least of every process's (the cards of a row
    walk the same pods in the same slots).  The plan is a function of the
    step, the batch's pods a row `q` and the CTAs asked for, so the
    processes agree once for each (on their first such launch, which
    SPMD order makes the same launch in each) and keep the answer."""
    if step.cw.mesh.procs is None:
        return slots
    agreed = step.__dict__.setdefault("_agreed_slots", {})
    if (q, ctas) not in agreed:
        from ..parallel import distributed

        agreed[q, ctas] = min(int(t) for t in distributed.all_gather(torch.tensor(slots)))
    return agreed[q, ctas]


def step_chunk_cards(step, carry: Cards, xs_chunk: Cards, *, _ctas: int = 0, _bound: int = 0,
                     _only: tuple | None = None, _events: tuple | None = None):
    """B12b sharded_step over a card mesh: one chunk of pods -> (carry,
    StepOut / CompactOut on the mesh's first card).  CUDA tensors: one
    launch of csrc/step_kernel.cuh step_cards_kernel a card (one launch of
    every card on virtual cards), all issued before any is awaited, a
    cluster of R CTAs a card, the cards of each "dp" row combining through
    the exchange; every card's carry updated in place; the wrapper waits
    for its launches and raises where a wait ran past the spin bound; the
    first row's outputs joined on the first card.  On a process mesh
    (B12c) each process launches its own card and joins the outputs on
    it.  CPU tensors: step_chunk_cards_plain.  For tests and measurement
    only: `_ctas` forces R, `_bound` the spin bound in clock64() cycles,
    `_only` (mesh card indices) launches those cards alone, so their waits
    fail; `_events`, two CUDA events, are recorded on this process's first
    card's stream before the first launch and after the last (virtual
    cards: the launch's device time, without the wait and the join)."""
    mesh = step.cw.mesh
    if mesh.cards[0].type == "cpu":
        return step_chunk_cards_plain(step, carry, xs_chunk)
    lib = kstep.load_lib("step")
    steps = card_steps(step)
    c = xs_chunk[0]["is_pad"].shape[0]
    outs, args = [], []
    for i, dev in enumerate(carry.devices):
        kstep.check_device("step_chunk_cards", dev, steps[i].cw.statics, carry[i], xs_chunk[i])
        outs.append(kstep.alloc_outputs(steps[i], c, dev))
        args.append(kstep.make_args(steps[i], carry[i], xs_chunk[i], outs[-1]))
    x = exchange(mesh, lib)
    held = []
    groups = _launch_groups(mesh)
    if _only is not None:
        groups = [(dev, [i for i in ids if mesh.local[i] in _only]) for dev, ids in groups]
        groups = [(dev, ids) for dev, ids in groups if ids]
    home = carry.devices[0]
    with x.lock, x.armed(1):
        base = x.take(3 * c + 1)
        if _events is not None:
            _events[0].record(torch.cuda.current_stream(home))
        for dev, ids in groups:
            ctas, spill, masks, resident = (ctypes.c_int(0), ctypes.c_longlong(0),
                                            ctypes.c_longlong(0), ctypes.c_int(0))
            with torch.cuda.device(dev):
                kstep.check_launch("step_chunk_cards plan", lib.kss_step_cards_plan(
                    _table(args, ids), len(ids), _ctas, dev.index, ctypes.byref(ctas),
                    ctypes.byref(spill), ctypes.byref(masks), ctypes.byref(resident)))
                _resident("step_chunk_cards", f"{ctas.value} CTAs a card", resident.value,
                          len(ids))
                for i in ids:
                    if spill.value:
                        held.append(torch.empty(spill.value, dtype=torch.uint8, device=dev))
                        args[i].spill = held[-1].data_ptr()
                if masks.value:
                    held.append(kstep.vb_masks(masks.value, dev, [args[i] for i in ids]))
                peer = x.args(base, 1, mesh.local[ids[0]], _bound or SPIN_BOUND)
                err = lib.kss_step_cards(_table(args, ids), len(ids), ctas.value,
                                         ctypes.byref(peer), dev.index, kstep.stream_of(dev))
            if err == ERR_RESIDENT:
                _resident("step_chunk_cards", f"{ctas.value} CTAs a card", 0, len(ids))
            kstep.check_launch("step_chunk_cards", err)
            step_chunk_cards.launches += 1
            step_chunk_cards.ctas = ctas.value
        if _events is not None:
            _events[1].record(torch.cuda.current_stream(home))
        outs = _finish("step_chunk_cards", x, mesh, outs)
    joined = kstep.alloc_outputs(step, c, home)
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
    with every other card's (`spec_eval_cards.slots`; on a process mesh
    the least over the processes), each walking its pods; the wrapper
    waits and raises as step_chunk_cards does.  CPU tensors:
    spec_eval_cards_plain.  `_ctas`, `_bound`, `_events`: as
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
    for i, dev in enumerate(carry.devices):
        kstep.check_device("spec_eval_cards", dev, steps[i].cw.statics, carry[i], mine[i])
        card_outs.append(kstep.alloc_outputs(steps[i], q, dev))
        args.append(kstep.make_args(steps[i], carry[i], mine[i], card_outs[-1]))
    x = exchange(mesh, lib)
    held = []
    groups = _launch_groups(mesh)
    plans = []
    for dev, ids in groups:
        ctas, slots, spill, masks, resident = (ctypes.c_int(0), ctypes.c_int(0),
                                               ctypes.c_longlong(0), ctypes.c_longlong(0),
                                               ctypes.c_int(0))
        with torch.cuda.device(dev):
            kstep.check_launch("spec_eval_cards plan", lib.kss_eval_cards_plan(
                _table(args, ids), len(ids), _ctas, dev.index, ctypes.byref(ctas),
                ctypes.byref(slots), ctypes.byref(spill), ctypes.byref(masks),
                ctypes.byref(resident)))
        _resident("spec_eval_cards", f"{ctas.value} CTAs a pod", resident.value, len(ids))
        plans.append((ctas.value, slots.value, spill.value, masks.value))
    ctas = plans[0][0]
    # a row's cards walk the same pods in the same slots
    slots = _agreed_slots(step, q, _ctas, min(XSLOTS, *(p[1] for p in plans)))
    home = carry.devices[0]
    with x.lock, x.armed(slots):
        base = x.take(3 * -(-q // slots) + 1)
        if _events is not None:
            _events[0].record(torch.cuda.current_stream(home))
        for (dev, ids), (_, _, cta_spill, mask_bytes) in zip(groups, plans):
            with torch.cuda.device(dev):
                for i in ids:
                    if cta_spill:
                        held.append(torch.empty(cta_spill * slots * ctas, dtype=torch.uint8,
                                                device=dev))
                        args[i].spill = held[-1].data_ptr()
                if mask_bytes:  # the plan's slots, at least these
                    held.append(kstep.vb_masks(mask_bytes, dev, [args[i] for i in ids]))
                peer = x.args(base, slots, mesh.local[ids[0]], _bound or SPIN_BOUND)
                err = lib.kss_eval_cards(_table(args, ids), len(ids), ctas, ctypes.byref(peer),
                                         dev.index, kstep.stream_of(dev))
            if err == ERR_RESIDENT:
                _resident("spec_eval_cards", f"{ctas} CTAs a pod, {slots} slots a card", 0,
                          len(ids) * slots)
            kstep.check_launch("spec_eval_cards", err)
            spec_eval_cards.launches += 1
        if _events is not None:
            _events[1].record(torch.cuda.current_stream(home))
        card_outs = _finish("spec_eval_cards", x, mesh, card_outs)
    spec_eval_cards.ctas, spec_eval_cards.slots = ctas, slots
    spec_eval_cards.batches[b] += 1
    if outs is None:
        outs = kstep.alloc_outputs(step, b, home)
    _join(step, outs, card_outs, mesh.shape["dp"], q)
    cls = StepOut if step.out_mode == "full" else CompactOut
    return cls(**{k: outs[k] for k in cls._fields})


spec_eval_cards.launches = 0
spec_eval_cards.ctas = None
spec_eval_cards.slots = None
spec_eval_cards.batches = collections.Counter()


def spec_commit_cards(step, carry: Cards, xs: Cards, selected, k: int) -> Cards:
    """B5 over a card mesh: rows b < k of the batch bound into the carry of
    every card this process holds.  CUDA tensors: B5's kernel
    (spec_commit_core on a core-only carry, else spec_commit_bind) on each
    card over its node slice, in place, `selected` the mesh's node indices
    (csrc/spec_commit.cu).  CPU tensors: spec_commit_cards_plain."""
    mesh = step.cw.mesh
    if mesh.cards[0].type == "cpu":
        return spec_commit_cards_plain(step, carry, xs, selected, k)
    kernel = kspec.spec_commit_core if kspec.core_only(carry[0]) else kspec.spec_commit_bind
    for i, (s, dev) in enumerate(zip(card_steps(step), carry.devices)):
        with torch.cuda.device(dev):
            kspec._commit(kernel, s, carry[i], xs[i], selected.to(dev), k)
        spec_commit_cards.launches += 1
    return carry


spec_commit_cards.launches = 0
