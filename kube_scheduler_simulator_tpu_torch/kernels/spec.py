"""The speculative wave's kernels: each wrapper and, beside it, its plain
PyTorch version.

    kernel (csrc/)                wrapper           plain version         JAX counterpart
    B2 spec_eval.cu               spec_eval         eval_plain            parallel/speculative.py:318 _eval_fn
       spec_eval_cluster
    B3 oracle.cu spec_oracle      spec_oracle       _oracle_core          :299 _oracle_core
    B4 spec_round.cu spec_round   spec_round        sparse_round_plain    :381 _sparse_round_fn
    B5 spec_commit.cu (two)       spec_commit_core  commit_plain          :501 _commit_fn
                                  spec_commit_bind
    B6 grid.cu (two)              grid_append       append_plain          :553 _accum_fns
                                  grid_emit         emit_plain

As kernels/step.py does for the step: for tensors on the card a wrapper
launches its kernel on PyTorch's current stream, without synchronising,
and adds one to its `launches`; for tensors on the CPU it runs the plain
version, because there is no card to launch on.  There is no fallback: a
failed build or launch raises.  The plain versions are the tests' and
chip_smoke.py's reference; nothing on the card's main path calls them.

The JAX package tiles the batch for XLA on a CPU (`_spec_tile`,
`_tiled_vmap`, :253-296, KSS_TPU_SPECULATIVE_TILE); the port has no such
tiling, and its results never depended on it.

spec_eval's kernel, which also serves the host path's phased_eval
(kernels/phased.py), B11's fused dense eval (kernels/fuse.py) and B12's
mesh eval (kernels/mesh.py), takes a table of sessions and spreads each
pod over a thread-block cluster whose size comes from the launch's pods
(`eval_shards`; on a mesh each shard a group of its CTAs, `cta_slices`),
in the CTA shape whose waves times passes over a slice are fewer
(`eval_light`, `eval_cost`);
`eval_sliced_plain` computes the same split in plain PyTorch.  spec_round's kernel, which
also serves B11's fused sparse round, takes a table of sessions and gives
each CTA a group of pods over one shared node pass (`round_pods`);
`round_grouped_plain` computes its split in plain PyTorch.  So the CPU
tests check each decomposition itself.  The oracle's kernel, which also
serves B11's fused oracle, takes a table of sessions and spreads each
session's pairs (j < k) over a thread-block cluster whose size comes from
the batch (`oracle_ctas`); its result is a minimum over rows, which no
split changes.  A session may hand the oracle its round's core-only
commit (`Commit`): the launch then leaves the accepted prefix, rows
b < min(K, m), applied to the carry in place (B5's core folded in: the
rows are added while the gathers run, and the rows past K taken back),
and the round launches no spec_commit_core; `oracle_commit_plain` is its
plain form, the plain oracle and then `commit_plain` at that k.
"""

from __future__ import annotations

import collections
import ctypes
from types import SimpleNamespace
from typing import NamedTuple

import torch

from ..framework.pipeline import (CompactOut, _bind_phase, _filter_phase,
                                  _prefilter_reject, _score_phase, _stack,
                                  _map_tree, pack_filter_codes, slice_pod)
from . import step as kstep

GRID_GROUPS = ("packed", "raw8", "raw16", "raw32", "fc")


def _device(carry) -> torch.device:
    if isinstance(carry, tuple):  # a card mesh's (kernels/mesh.py Cards): its first card
        return carry.devices[0]
    return carry["core"].requested.device


def _bits(t: torch.Tensor) -> torch.Tensor:
    """uint16 (the p16 pack) as int16 bits: PyTorch gives uint16 little
    more than conversions, and these functions only compare with 0, copy
    and stack."""
    return t.view(torch.int16) if t.dtype == torch.uint16 else t


# ------------------------------------------------------------ B2 dense eval

def eval_plain(step, carry: dict, xs: dict) -> CompactOut:
    """The compact step of every pod of the batch against one frozen carry,
    with no bind: `Step.eval_plain` per row, stacked."""
    b = xs["is_pad"].shape[0]
    outs = [step.eval_plain(carry, slice_pod(xs, i)) for i in range(b)]
    return CompactOut(*[_stack([getattr(o, f) for o in outs]) for f in CompactOut._fields])


EVAL_SHARDS = (1, 2, 4, 8, 16)  # CTAs a shard (a pod without a mesh) in csrc/spec_eval.cu
MAX_CTAS = 16                   # CTAs a cluster: csrc/cluster.cuh KSS_MAX_CTAS


def eval_shards(b: int, n: int, clusters_at: dict, shards: int = 1) -> int:
    """The group size G of an eval launch over b clusters (pods of all its
    sessions) of n nodes split over `shards` "nodes" shards (a mesh's; 1
    without one): the largest G of EVAL_SHARDS, R = shards x G <= n and
    <= MAX_CTAS, at which all b clusters are resident on the card at once
    (clusters_at[G] >= b, the card's count of clusters of R CTAs), else
    1.  Without a mesh G is the cluster size."""
    for g in reversed(EVAL_SHARDS):
        if shards * g <= min(n, MAX_CTAS) and clusters_at.get(g, 0) >= b:
            return g
    return 1


def cta_slices(n: int, shards: int, groups: int) -> tuple[tuple[int, int], ...]:
    """The node slices of a cluster of shards x groups CTAs, in rank
    order (csrc/slices.cuh node_slice): shard s owns [s V, (s + 1) V),
    V = ceil(n / shards), and CTA g of its group [g W, (g + 1) W) of it,
    W = ceil(V / groups), clipped to the shard.  A last sub-slice may be
    ragged and, where a shard has fewer nodes than CTAs, sub-slices
    empty."""
    v = -(-n // shards)
    w = max(-(-v // groups), 1)
    out = []
    for s in range(shards):
        slo, shi = min(s * v, n), min(s * v + v, n)
        for g in range(groups):
            lo = min(slo + g * w, shi)
            out.append((lo, min(lo + w, shi)))
    return tuple(out)


def cluster_slices(n: int, ctas: int) -> tuple[tuple[int, int], ...]:
    """CTA r's nodes [r W, (r + 1) W), W = ceil(n / ctas), clipped to n:
    cta_slices without a mesh.  The last slice may be ragged and, where
    n < ctas, slices empty."""
    return cta_slices(n, 1, ctas)


def eval_sliced_plain(step, carry: dict, xs: dict, shards: int):
    """The cluster kernel's split in plain PyTorch: every pod of the batch
    against one frozen carry, no bind, each reduction over the nodes a
    partial per slice of cluster_slices(N, shards) combined in rank order
    (kernels/mesh.py _eval_sharded) -> the outputs of step.out_mode with a
    leading pod axis, equal to eval_plain's."""
    from .mesh import _eval_sharded, _stack_outs

    plan = cluster_slices(step.cw.n_nodes, shards)
    return _stack_outs(step, [_eval_sharded(step, carry, slice_pod(xs, i), plan)
                              for i in range(xs["is_pad"].shape[0])])


EVAL_THREADS = {False: 512, True: 256}  # the CTA shapes' most threads (csrc/spec_eval.cu)


def eval_cost(b: int, n: int, shards: int, groups: int, clusters_at: dict, light: bool) -> float:
    """An eval launch's critical path in the plan's own terms: the waves
    of b clusters the card holds at once at G = `groups` (clusters_at[G],
    kss_eval_plan's occupancy of the shape) times the passes of a CTA's
    threads over its slice (W = the widest of cta_slices(n, shards, G),
    at most EVAL_THREADS[light] threads, one a node) -> waves x passes
    (inf where the card holds no cluster)."""
    held = clusters_at.get(groups, 0)
    if held < 1:
        return float("inf")
    w = max(-(-(-(-n // shards)) // groups), 1)
    threads = min(max(-(-w // 32) * 32, 32), EVAL_THREADS[light])
    return -(-b // held) * -(-w // threads)


def eval_light(b: int, n: int, shards: int, default: tuple, light: tuple) -> bool:
    """Whether an eval launch over b clusters (pods of all its sessions)
    takes the light CTA shape (csrc/spec_eval.cu: at most 256 threads,
    three CTAs an SM) rather than the default one (up to 512 threads, one
    an SM): where its eval_cost is lower, each shape at its own G and
    occupancy (`default`, `light`: (G, clusters_at)).  Past the resident
    clusters three lighter CTAs an SM take fewer waves; within them a G
    that only the light shape holds all at once takes fewer passes."""
    return (eval_cost(b, n, shards, light[0], light[1], True)
            < eval_cost(b, n, shards, default[0], default[1], False))


def launch_eval(what: str, entries: list, groups: int, shards: int = 1,
                light: bool | None = None) -> tuple[int, bool]:
    """One launch of csrc/spec_eval.cu's cluster kernel over a table of
    sessions, `entries` of (step, carry, xs, outs): outs in the layout of
    step.out_mode, every member with the same batch, nodes and state
    bytes; one cluster of R = shards x G CTAs per pod of each batch, each
    of the `shards` "nodes" shards (a mesh's; 1 without one) a group of G.
    G = `groups` (one of EVAL_SHARDS), or where it is 0 eval_shards'
    choice over the launch's K x B clusters from the card's cluster
    occupancy (kss_eval_plan); the CTA shape `light`, or where it is None
    eval_light's choice from both shapes' plans, each at its own G.
    Where a CTA's
    state passes shared memory it goes to device memory allocated here,
    held through the launch, a slot per CTA; so do VolumeBinding's
    open-slot masks where the plan gives them bytes.  Launches on the
    current stream.  -> (G, light)."""
    dev = _device(entries[0][1])
    for step, carry, xs, _ in entries:
        kstep.check_device(what, dev, step.cw.statics, carry, xs)
    if groups not in (0, *EVAL_SHARDS) or shards * groups > MAX_CTAS:
        raise ValueError(f"{what}: {groups} CTAs a shard of {shards}, not one of "
                         f"{EVAL_SHARDS} within a cluster of {MAX_CTAS}")
    lib = kstep.load_lib("spec_eval")
    k, b = len(entries), entries[0][2]["is_pad"].shape[0]
    n = entries[0][0].cw.n_nodes
    table = (kstep.StepArgs * k)()
    member_args = [kstep.make_args(step, carry, xs, outs) for step, carry, xs, outs in entries]
    for i, args in enumerate(member_args):  # kept: their tables on the card outlive the launch
        table[i] = args

    def plan(shape: bool):
        clusters = (ctypes.c_int * len(EVAL_SHARDS))()
        cta_spill = (ctypes.c_longlong * len(EVAL_SHARDS))()
        cta_masks = (ctypes.c_longlong * len(EVAL_SHARDS))()
        kstep.check_launch(f"{what} plan", lib.kss_eval_plan(table, k, shards, int(shape),
                                                             clusters, cta_spill, cta_masks))
        return (dict(zip(EVAL_SHARDS, clusters)), dict(zip(EVAL_SHARDS, cta_spill)),
                dict(zip(EVAL_SHARDS, cta_masks)))

    clusters_at, cta_spill, cta_masks = plan(bool(light))
    g = groups or eval_shards(k * b, n, clusters_at, shards)
    # the light shape's plan is asked only where the default one takes
    # more than one wave of one pass
    if light is None:
        light = False
        if eval_cost(k * b, n, shards, g, clusters_at, False) > 1:
            light_at, light_spill, light_masks = plan(True)
            gl = groups or eval_shards(k * b, n, light_at, shards)
            if eval_light(k * b, n, shards, (g, clusters_at), (gl, light_at)):
                light, g, cta_spill, cta_masks = True, gl, light_spill, light_masks
    spill = masks = None
    if cta_spill[g]:
        per = cta_spill[g] * b * shards * g
        spill = torch.empty(per * k, dtype=torch.uint8, device=dev)
        for i in range(k):
            table[i].spill = spill.data_ptr() + i * per
    if cta_masks[g]:
        masks = kstep.vb_masks(cta_masks[g] * k * b * shards * g, dev, table)
    kstep.check_launch(what, lib.kss_spec_eval(table, k, shards * g, shards, int(light),
                                               kstep.stream_of(dev)))
    return g, light


def spec_eval(step, carry: dict, xs: dict, outs: dict | None = None, *,
              _shards: int = 0, _light: bool | None = None) -> CompactOut:
    """B2: the dense round's evaluation.  CUDA tensors: one launch of one
    thread-block cluster per pod of the batch (launch_eval), into `outs`
    (round_outputs) when the caller allocated them; `spec_eval.shards`
    records the cluster size it took, `spec_eval.light` the CTA shape,
    `spec_eval.batches` the launches by batch size.  CPU tensors:
    eval_plain.  For tests and measurement only, `_shards` forces the
    cluster size (one of EVAL_SHARDS) and `_light` the CTA shape."""
    if step.out_mode != "compact":
        raise ValueError("spec_eval evaluates the compact step")
    dev = _device(carry)
    if dev.type == "cpu":
        return eval_plain(step, carry, xs)
    b = xs["is_pad"].shape[0]
    if outs is None:
        outs = kstep.alloc_outputs(step, b, dev)
    spec_eval.shards, spec_eval.light = launch_eval("spec_eval", [(step, carry, xs, outs)],
                                                    _shards, 1, _light)
    spec_eval.launches += 1
    spec_eval.batches[b] += 1
    return CompactOut(**{k: outs[k] for k in CompactOut._fields})


spec_eval.launches = 0
spec_eval.shards = None
spec_eval.light = None
spec_eval.batches = collections.Counter()


# ------------------------------------------------------------ B3 oracle

def _oracle_core(packed, prefilter_reject, selected, batch: int) -> torch.Tensor:
    """The dirty-node prefix length: pod k conflicts when it is feasible
    (packed word 0, no PreFilter reject) at the node an earlier pod j < k
    selected; K is the first conflicting k, or `batch`.  Pad rows sit past
    the real rows (selected == -1, never bound), so a pad conflict only
    pushes K past them: the caller clamps to the round's real size."""
    feas = (_bits(packed) == 0) & (prefilter_reject == 0)[:, None]
    bound = selected >= 0                                   # [B]
    cols = torch.clamp(selected, min=0).to(torch.int64)
    feas_at_sel = feas[:, cols]                             # [B(k), B(j)]
    before = torch.ones((batch, batch), dtype=torch.bool, device=packed.device).tril(-1)
    conflict = torch.any(feas_at_sel & bound[None, :] & before, dim=1)
    first = torch.argmax(conflict.to(torch.uint8))           # first True
    return torch.where(torch.any(conflict), first, batch).to(torch.int32)


class Commit(NamedTuple):
    """A round's commit folded into its oracle launch: the core-only
    carry (updated in place), the batch's xs and m, the rows that are
    not pad.  The launch commits rows b < min(K, m) with selected[b] >= 0.
    A sparse round's commit also holds its feasible counts [B] and
    candidate cap: where a row b < m passes the cap, the host runs the
    round dense, and the launch commits nothing."""

    carry: dict
    xs: dict
    m: int
    counts: torch.Tensor | None = None
    kcand: int = 0


class OracleCommit(ctypes.Structure):
    """csrc/oracle.cu OracleCommit: the pointers and widths of one
    session's commit (requested == 0: none)."""

    _fields_ = [("requested", ctypes.c_void_p), ("nonzero", ctypes.c_void_p),
                ("num_pods", ctypes.c_void_p), ("pod_requests", ctypes.c_void_p),
                ("pod_nonzero", ctypes.c_void_p), ("counts", ctypes.c_void_p),
                ("R", ctypes.c_int), ("m", ctypes.c_int), ("kcand", ctypes.c_int)]


def _check_commit(commit: Commit) -> None:
    if not core_only(commit.carry):
        raise ValueError(f"a folded commit binds only the core carry, not "
                         f"{sorted(commit.carry)}")


def oracle_commit_args(commit: Commit, b: int) -> OracleCommit:
    """The C struct of one session's commit, its tensors checked."""
    _check_commit(commit)
    core, batch = commit.carry["core"], commit.xs["core"]
    n, r = core.requested.shape
    if not 0 <= commit.m <= b:
        raise ValueError(f"a folded commit of {commit.m} rows in a batch of {b}")
    counts = (None if commit.counts is None else
              kstep._ptr(commit.counts, torch.int32, (b,), "counts"))
    return OracleCommit(
        kstep._ptr(core.requested, torch.int64, (n, r), "requested"),
        kstep._ptr(core.nonzero, torch.int64, (n, 2), "nonzero"),
        kstep._ptr(core.num_pods, torch.int64, (n,), "num_pods"),
        kstep._ptr(batch.requests, torch.int64, (b, r), "pod_requests"),
        kstep._ptr(batch.nonzero, torch.int64, (b, 2), "pod_nonzero"), counts, r, commit.m,
        commit.kcand)


def commit_wide(commit: Commit) -> bool:
    """A sparse round's commit whose rows b < m include one feasible at
    more nodes than the candidate cap: the host runs that round dense
    (parallel/speculative.py `_spec_run`), so its oracle commits nothing."""
    return (commit.counts is not None and commit.m > 0
            and int(commit.counts[:commit.m].max()) > commit.kcand)


def oracle_commit_plain(packed, prefilter_reject, selected, commit: Commit | None):
    """The plain form of an oracle launch with its commit folded in:
    _oracle_core, then, with a commit (and no row b < m of a sparse
    round past its candidate cap), commit_plain of the rows b <
    min(K, m) copied into the carry's tensors in place, as the kernel
    leaves them.  -> K."""
    k = _oracle_core(packed, prefilter_reject, selected, packed.shape[0])
    if commit is not None and not commit_wide(commit):
        _check_commit(commit)
        new = commit_plain(None, commit.carry, commit.xs, selected, min(int(k), commit.m))
        for got, want in zip(commit.carry["core"], new["core"]):
            got.copy_(want)
    return k


ORACLE_CTAS = (1, 2, 4, 8, 16)  # CTAs of a session's cluster in csrc/oracle.cu
ORACLE_ROWS = 32                # rows a CTA of 16 warps takes before the plan adds CTAs


def oracle_ctas(b: int) -> int:
    """The CTAs of each session's cluster in an oracle launch over
    batches of b: the smallest of ORACLE_CTAS whose CTAs hold the b rows
    at ORACLE_ROWS each (two a warp), at most 16.  b <= 32 takes one CTA
    and no cluster, b = 512 sixteen."""
    for c in ORACLE_CTAS:
        if c * ORACLE_ROWS >= b:
            return c
    return ORACLE_CTAS[-1]


def launch_oracle(what: str, rows: list, outs: list, ctas: int = 0,
                  commits: list | None = None) -> int:
    """One launch of csrc/oracle.cu's kernel over a table of sessions:
    rows per session (packed [B, N], prefilter_reject [B], selected [B]),
    each session's K into its own int32 scalar of `outs`, and where
    `commits` gives a session a Commit (else None), its accepted prefix
    bound into its carry; every session of one batch, node count and pack
    width.  One cluster of `ctas` CTAs a session (one of ORACLE_CTAS), or
    where it is 0 oracle_ctas(B).  Launches on the current stream -> the
    CTAs a session took."""
    from . import build

    b, n = rows[0][0].shape
    dtype = rows[0][0].dtype
    dev = rows[0][0].device
    if ctas not in (0, *ORACLE_CTAS):
        raise ValueError(f"{what}: {ctas} CTAs a session, not one of {ORACLE_CTAS}")
    ctas = ctas or oracle_ctas(b)
    k = len(rows)
    commits = commits or [None] * k
    packed, reject, selected, out_k = ((ctypes.c_void_p * k)() for _ in range(4))
    table = (OracleCommit * k)()
    for i, ((p, r, s), out, c) in enumerate(zip(rows, outs, commits, strict=True)):
        kstep.check_device(what, dev, {"p": p, "r": r, "s": s, "k": out})
        packed[i] = kstep._ptr(p, dtype, (b, n), "packed")
        reject[i] = kstep._ptr(r, torch.int32, (b,), "prefilter_reject")
        selected[i] = kstep._ptr(s, torch.int32, (b,), "selected")
        out_k[i] = kstep._ptr(out, torch.int32, (), "k")
        if c is not None:
            kstep.check_device(what, dev, c.carry, {"core": c.xs["core"]})
            table[i] = oracle_commit_args(c, b)
    lib = build.load("oracle")
    if lib.kss_oracle_commit_size() != ctypes.sizeof(OracleCommit):
        raise RuntimeError("OracleCommit differs between csrc/oracle.cu and kernels/spec.py")
    kstep.check_launch(what, lib.kss_spec_oracle(packed, reject, selected, out_k, table, k,
                                                 rows[0][0].element_size(), b, n, ctas,
                                                 kstep.stream_of(dev)))
    return ctas


def spec_oracle(packed, prefilter_reject, selected, out: torch.Tensor | None = None, *,
                commit: Commit | None = None, _ctas: int = 0) -> torch.Tensor:
    """B3: K as an int32 tensor on the inputs' device (`out` when the
    caller allocated it); with `commit`, the round's accepted prefix (rows
    b < min(K, commit.m)) bound into commit.carry in place by the same
    launch, B5's core folded in.  CUDA tensors: the one-session launch of the
    oracle kernel (launch_oracle), one cluster of oracle_ctas(B) CTAs;
    `spec_oracle.ctas` records the CTAs it took, `spec_oracle.commits`
    the launches that committed.  CPU tensors: oracle_commit_plain.  For
    tests and measurement only, `_ctas` forces the cluster's CTAs (one of
    ORACLE_CTAS)."""
    dev = packed.device
    if dev.type == "cpu":
        return oracle_commit_plain(packed, prefilter_reject, selected, commit)
    if out is None:
        out = torch.empty((), dtype=torch.int32, device=dev)
    spec_oracle.ctas = launch_oracle("spec_oracle", [(packed, prefilter_reject, selected)],
                                     [out], _ctas, [commit])
    spec_oracle.launches += 1
    spec_oracle.commits += commit is not None
    return out


spec_oracle.launches = 0
spec_oracle.commits = 0
spec_oracle.ctas = None


# ------------------------------------------------------------ B4 sparse round

def _take_nodes(x, idx, n: int):
    """Gather candidate rows along a leaf's node axis (its first axis whose
    extent == n; leaves without one, and non-tensors, pass through): the
    JAX package's node-axis rule (speculative.py:369)."""
    if not isinstance(x, torch.Tensor):
        return x
    for ax in range(x.dim()):
        if x.shape[ax] == n:
            return torch.index_select(x, ax, idx)
    return x


def _sparse_filter(step, carry: dict, sl: dict):
    """One pod's dense filters -> (packed word [N], PreFilter reject,
    feasibility [N] bool, feasible count: 0 where rejected)."""
    cw = step.cw
    codes, feasible = _filter_phase(cw, carry, sl, step.filter_names)
    packed = pack_filter_codes(codes, cw.n_nodes, step.pack_mode)
    reject = _prefilter_reject(cw, carry, sl)
    count = torch.sum(feasible, dtype=torch.int32)
    return packed, reject, feasible, torch.where(reject > 0, 0, count)


def _sparse_scores(step, carry: dict, sl: dict, weights, cand, count):
    """Score / normalize / select on the candidates `cand` [K] (slots <
    count valid) -> (each scorer's raw [K], selected, the valid slots)."""
    cw = step.cw
    n, kcand = cw.n_nodes, cand.shape[0]
    valid = torch.arange(kcand, dtype=torch.int32, device=cand.device) < count
    idx = cand.to(torch.int64)

    def take(tree):
        return _map_tree(lambda x: _take_nodes(x, idx, n), tree)

    g_sl = take(sl)
    # every sparse-eligible plugin reads its node-axis statics and carry
    # rows positionally, so every entry is gathered
    view = SimpleNamespace(config=cw.config, statics=take(cw.statics),
                           n_nodes=kcand, schema=cw.schema)
    raws, _finals, total = _score_phase(view, take(carry), g_sl, weights,
                                        step.score_names, valid)
    sel_k = torch.argmax(total)
    selected = torch.where(count > 0, cand[sel_k], -1).to(torch.int32)
    is_pad = g_sl.get("is_pad")
    if is_pad is not None:
        selected = torch.where(is_pad, -1, selected)
    return raws, selected, valid


def _sparse_rows(step, raws, valid, place):
    """The raw rows of the compact groups, each scorer's [K] values put
    onto [N] by place(vals [Sg, K], dtype), and the overflow of the checked
    narrowing over the valid slots -> (raw8, raw16, raw32, ovf)."""
    n, dev = step.cw.n_nodes, valid.device
    groups: dict[str, list] = {"i8": [], "i16": [], "i32": []}
    for s, g in enumerate(step.score_dtypes):
        if g == "host":
            continue
        groups["i32" if step.wide_raw else g].append(raws[s])

    def rows(vals, dtype):
        if not vals:
            return torch.zeros((0, n), dtype=dtype, device=dev)
        return place(torch.stack(vals).to(dtype), dtype)

    raw8 = rows(groups["i8"], torch.int8)
    raw16 = rows(groups["i16"], torch.int16)
    raw32 = rows(groups["i32"], torch.int64 if step.wide_raw == "i64" else torch.int32)
    ovf = torch.zeros((), dtype=torch.bool, device=dev)
    if step.wide_raw is None and groups["i16"]:
        full = torch.stack(groups["i16"])
        ovf = torch.any(valid[None, :] & (full != full.to(torch.int16).to(full.dtype)))
    elif step.wide_raw == "i32" and groups["i32"]:
        full = torch.stack(groups["i32"])
        ovf = torch.any(valid[None, :] & (full != full.to(torch.int32).to(full.dtype)))
    return raw8, raw16, raw32, ovf


def _sparse_one(step, carry: dict, sl: dict, weights, kcand: int):
    n = step.cw.n_nodes
    packed, reject, feasible, count = _sparse_filter(step, carry, sl)
    cum = torch.cumsum(feasible.to(torch.int32), 0, dtype=torch.int32)
    dev = feasible.device
    cand = torch.searchsorted(cum, torch.arange(1, kcand + 1, dtype=torch.int32, device=dev))
    cand = torch.clamp(cand, max=n - 1).to(torch.int32)
    raws, selected, valid = _sparse_scores(step, carry, sl, weights, cand, count)
    # scatter the raw columns onto the dense grid: invalid slots park in a
    # shed column past n, sliced off below
    park = torch.where(valid, cand, n).to(torch.int64)

    def scatter(vals, dtype):
        buf = torch.zeros((vals.shape[0], n + 1), dtype=dtype, device=dev)
        buf[:, park] = vals
        return buf[:, :n]

    return (packed, reject, count, *_sparse_rows(step, raws, valid, scatter), selected)


def sparse_round_plain(step, carry: dict, xs: dict, kcand: int):
    """Every pod of the batch: dense filters and pack, the first `kcand`
    feasible nodes by cumsum + searchsorted, score / normalize / select on
    those candidates, raws scattered back onto [N].  The JAX round then
    runs the oracle in the same jit; here the caller runs spec_oracle.
    -> (packed, reject, counts, raw8, raw16, raw32, ovf, selected)."""
    b = xs["is_pad"].shape[0]
    weights = torch.tensor(step.weights, dtype=torch.int64, device=_device(carry))
    rows = [_sparse_one(step, carry, slice_pod(xs, i), weights, kcand) for i in range(b)]
    return tuple(_stack([r[j] for r in rows]) for j in range(8))


ROUND_PODS = (1, 2, 4, 8)  # the pod-group sizes of csrc/spec_round.cu's kernel


def _popc(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int64 word (below bit 32)."""
    bits = (x[..., None] >> torch.arange(32, device=x.device)) & 1
    return bits.sum(-1)


def round_grouped_plain(step, carry: dict, xs: dict, kcand: int, pods: int):
    """The pod-group kernel's split in plain PyTorch: the batch in groups of
    `pods` pods; per group, the pods' feasibility as 32-node words, each
    word's first rank an exclusive scan of the words' popcounts, node n's
    rank that plus the popcount of its word below its lane; candidate r
    the feasible node of rank r < kcand (N-1 past the count); every raw row
    written in one pass, a node's candidate value where it is feasible
    with rank below the valid count, 0 elsewhere.  -> sparse_round_plain's
    tuple, equal to it at every `pods`."""
    if pods not in ROUND_PODS:
        raise ValueError(f"{pods} pods a group, not one of {ROUND_PODS}")
    n = step.cw.n_nodes
    dev = _device(carry)
    b = xs["is_pad"].shape[0]
    weights = torch.tensor(step.weights, dtype=torch.int64, device=dev)
    words = -(-n // 32)
    lanes = torch.arange(32, device=dev)
    nodes = torch.arange(n, device=dev)
    rows = []
    for c0 in range(0, b, pods):
        sls = [slice_pod(xs, c) for c in range(c0, min(c0 + pods, b))]
        filt = [_sparse_filter(step, carry, sl) for sl in sls]
        feas = torch.zeros((len(sls), words * 32), dtype=torch.int64, device=dev)
        feas[:, :n] = torch.stack([f[2] for f in filt]).to(torch.int64)
        bits = feas.view(len(sls), words, 32)
        word = (bits << lanes).sum(-1)                                  # [P, W]
        pop = bits.sum(-1)
        prefix = torch.cumsum(pop, 1) - pop                             # exclusive
        below = _popc(word[:, :, None] & ((1 << lanes) - 1))            # [P, W, 32]
        rank = (prefix[:, :, None] + below).view(len(sls), words * 32)[:, :n]
        for p, (sl, (packed, reject, feasible, count)) in enumerate(zip(sls, filt)):
            cand = torch.full((kcand,), n - 1, dtype=torch.int32, device=dev)
            pick = feasible & (rank[p] < kcand)
            cand[rank[p][pick]] = nodes[pick].to(torch.int32)
            raws, selected, valid = _sparse_scores(step, carry, sl, weights, cand, count)
            valid_n = int(valid.sum())
            take = feasible & (rank[p] < valid_n)
            at = torch.clamp(rank[p], max=kcand - 1)

            def gather(vals, dtype, take=take, at=at):
                return torch.where(take[None, :], vals[:, at], torch.zeros((), dtype=dtype,
                                                                           device=dev))

            rows.append((packed, reject, count, *_sparse_rows(step, raws, valid, gather),
                         selected))
    return tuple(_stack([r[j] for r in rows]) for j in range(8))


PLAN_PODS = (1, 2)  # the group sizes a launch's plan takes (round_pods)


def round_pods(k: int, b: int, resident_at: dict, sms: int) -> int:
    """The pod-group size of a sparse round's launch over k sessions of b
    pods: the largest P of PLAN_PODS at which the launch's k x ceil(b / P)
    CTAs still fill half of the card's resident slots (resident_at[P], the
    CTAs of that group size an SM holds at once, 0 where the group's state
    passes shared memory, times the `sms` SMs), else 1.  Groups of 4 and 8
    stay out of the plan: with four CTAs an SM their node pass costs 1.5
    to 1.8 times a group of 2's a pod (NVIDIA H100 80GB HBM3, 700.00 W;
    PERF.md §6)."""
    for p in reversed(PLAN_PODS):
        if resident_at.get(p, 0) > 0 and 2 * k * -(-b // p) >= resident_at[p] * sms:
            return p
    return 1


def launch_round(what: str, entries: list, kcand: int, pods: int, clocks=None) -> int:
    """One launch of csrc/spec_round.cu's pod-group kernel over a table of
    sessions, `entries` of (step, carry, xs, outs) (round_outputs), every
    member with the same batch, nodes, scorers and candidate cap: groups
    of P pods, one CTA each.  P = `pods` (one of ROUND_PODS), or where it
    is 0 round_pods' choice from the card's residency (kss_round_plan).
    Where a group's state passes shared memory it goes to device memory
    allocated here, held through the launch, a slot per CTA; so do
    VolumeBinding's open-slot masks where the plan gives them bytes.  `clocks`,
    one zeroed int64 [B * CLOCK_SLOTS] tensor per member, runs the
    phase-clock build.  Launches on the current stream.  -> P."""
    dev = _device(entries[0][1])
    for step, carry, xs, _ in entries:
        check_round(step, kcand)
        kstep.check_device(what, dev, step.cw.statics, carry, xs)
    if pods not in (0, *ROUND_PODS):
        raise ValueError(f"{what}: {pods} pods a group, not one of {ROUND_PODS}")
    lib = kstep.load_lib("spec_round" if clocks is None else "spec_round_clock")
    k, b = len(entries), entries[0][2]["is_pad"].shape[0]
    table = (kstep.StepArgs * k)()
    member_args = [kstep.make_args(step, carry, xs, outs) for step, carry, xs, outs in entries]
    for i, args in enumerate(member_args):  # kept: their tables on the card outlive the launch
        table[i] = args
        table[i].K = kcand
    for i, ck in enumerate(clocks or ()):
        table[i].clock = kstep._ptr(ck, torch.int64, (b * kstep.CLOCK_SLOTS,), "clock")
    resident = (ctypes.c_int * len(ROUND_PODS))()
    cta_spill = (ctypes.c_longlong * len(ROUND_PODS))()
    sms, cta_mask = ctypes.c_int(0), ctypes.c_longlong(0)
    kstep.check_launch(f"{what} plan", lib.kss_round_plan(table, k, resident, cta_spill,
                                                          ctypes.byref(sms),
                                                          ctypes.byref(cta_mask)))
    if pods == 0:
        pods = round_pods(k, b, dict(zip(ROUND_PODS, resident)), sms.value)
    j = ROUND_PODS.index(pods)
    spill = masks = None
    if cta_spill[j]:
        per = cta_spill[j] * -(-b // pods)
        spill = torch.empty(per * k, dtype=torch.uint8, device=dev)
        for i in range(k):
            table[i].spill = spill.data_ptr() + i * per
    if cta_mask.value:
        masks = kstep.vb_masks(cta_mask.value * k * -(-b // pods), dev, table)
    kstep.check_launch(what, lib.kss_spec_round(table, k, pods, kstep.stream_of(dev)))
    return pods


def spec_round(step, carry: dict, xs: dict, kcand: int, outs: dict | None = None, *,
               _pods: int = 0, _clock: torch.Tensor | None = None):
    """B4: the sparse round's per-pod pass.  CUDA tensors: one launch of
    the pod-group kernel (launch_round, one session), into `outs`
    (round_outputs) when the caller allocated them;
    `spec_round.pods` records the group size it took, `spec_round.batches`
    the launches by batch size.  CPU tensors: sparse_round_plain.  For
    tests and measurement only, `_pods` forces the group size (one of
    ROUND_PODS); `_clock` (a zeroed int64 [B * CLOCK_SLOTS] tensor on the
    card) runs the phase-clock build (ROUND_CLOCK_PHASES)."""
    if step.out_mode != "compact":
        raise ValueError("spec_round evaluates the compact step")
    dev = _device(carry)
    if dev.type == "cpu":
        return sparse_round_plain(step, carry, xs, kcand)
    b = xs["is_pad"].shape[0]
    if outs is None:
        outs = round_outputs(step, b, dev)
    spec_round.pods = launch_round("spec_round", [(step, carry, xs, outs)], kcand, _pods,
                                   None if _clock is None else [_clock])
    spec_round.launches += 1
    spec_round.batches[b] += 1
    return round_tuple(outs)


spec_round.launches = 0
spec_round.pods = None
spec_round.batches = collections.Counter()
# the sparse round's phase clock (csrc/common.cuh RoundClockSlot): per CTA,
# in its first pod's CLOCK_SLOTS, the ns of each phase, then its first
# and last stamps
ROUND_CLOCK_PHASES = ("filter", "candidates", "scores", "normalize and argmax",
                      "rows and overflow")
ROUND_CLOCK_START, ROUND_CLOCK_END = 5, 6


def round_tuple(outs: dict) -> tuple:
    """A sparse round's outputs: (packed, reject, counts, raw8, raw16,
    raw32, ovf, selected)."""
    return tuple(outs[k] for k in ("packed_filter", "prefilter_reject", "feasible_count",
                                   "raw8", "raw16", "raw32", "raw_overflow", "selected"))


def check_round(step, kcand: int) -> None:
    """What spec_round's kernel takes: the node-local plugins, whose
    node-axis rows it reads positionally at the candidates and which read
    no pre-pass, and a candidate cap in [1, N]."""
    from ..parallel.speculative import SAFE_SPECULATIVE

    plugins = set(step.filter_names) | set(step.score_names)
    if not plugins <= SAFE_SPECULATIVE:
        raise ValueError(f"spec_round scores only node-local plugins, not "
                         f"{sorted(plugins - SAFE_SPECULATIVE)}")
    if not 1 <= kcand <= step.cw.n_nodes:
        raise ValueError(f"kcand {kcand} outside [1, {step.cw.n_nodes}]")


def round_outputs(step, b: int, dev: torch.device) -> dict:
    """Output tensors of one round's launch over b pods, the dense eval's
    or the sparse round's, and the oracle's K ("k")."""
    outs = kstep.alloc_outputs(step, b, dev)
    outs["k"] = torch.empty((), dtype=torch.int32, device=dev)
    return outs


# ------------------------------------------------------------ B5 commit

def core_only(carry: dict) -> bool:
    """The commit's variant (speculative.py:511): the carry holds nothing
    but "core"."""
    return set(carry) <= {"core"}


def commit_plain(step, carry: dict, xs: dict, selected, k: int) -> dict:
    """The accepted prefix (rows < k) bound into the carry -> a new carry.
    Core-only: one scatter-add of requests, non-zero requests and pod
    counts.  Otherwise: `_bind_phase` folded over the batch with the
    selection -1 past the prefix."""
    b = selected.shape[0]
    accept = torch.arange(b, device=selected.device) < k
    if core_only(carry):
        core_batch, core = xs["core"], carry["core"]
        idx = torch.clamp(selected, min=0).to(torch.int64)
        add = (accept & (selected >= 0)).to(torch.int64)
        out = dict(carry)
        out["core"] = core._replace(
            requested=core.requested.index_add(0, idx, core_batch.requests * add[:, None]),
            nonzero=core.nonzero.index_add(0, idx, core_batch.nonzero * add[:, None]),
            num_pods=core.num_pods.index_add(0, idx, add))
        return out
    sel = torch.where(accept, selected, -1)
    for i in range(b):
        carry = _bind_phase(step.cw, carry, slice_pod(xs, i), sel[i])
    return carry


def _commit(kernel, step, carry: dict, xs: dict, selected, k: int) -> dict:
    if kernel is spec_commit_core and not core_only(carry):
        raise ValueError(f"spec_commit_core binds only the core carry, not {sorted(carry)}")
    dev = _device(carry)
    kstep.check_device(kernel.__name__, dev, step.cw.statics, carry, xs, {"s": selected})
    lib = kstep.load_lib("spec_commit")
    b = xs["is_pad"].shape[0]
    args = kstep.make_args(step, carry, xs, None)
    sel_ptr = kstep._ptr(selected, torch.int32, (b,), "selected")
    masks, nbytes = None, ctypes.c_longlong(0)
    if kernel is spec_commit_bind:
        kstep.check_launch(f"{kernel.__name__} plan",
                           lib.kss_commit_plan(ctypes.byref(args), ctypes.byref(nbytes)))
    if nbytes.value:
        masks = kstep.vb_masks(nbytes.value, dev, [args])  # held through the launch
    err = lib.kss_spec_commit(ctypes.byref(args), sel_ptr, int(k),
                              int(kernel is spec_commit_core), kstep.stream_of(dev))
    kstep.check_launch(kernel.__name__, err)
    kernel.launches += 1
    return carry


def spec_commit_core(step, carry: dict, xs: dict, selected, k: int) -> dict:
    """B5, core-only: 64-bit atomic adds, one thread per batch row, carry
    updated in place.  A round whose K the host will not cut launches
    none: its oracle launch commits (spec_oracle's `commit`)."""
    return _commit(spec_commit_core, step, carry, xs, selected, k)


def spec_commit_bind(step, carry: dict, xs: dict, selected, k: int) -> dict:
    """B5, general: one block folds the step's bind over the batch in order,
    carry updated in place."""
    return _commit(spec_commit_bind, step, carry, xs, selected, k)


spec_commit_core.launches = 0
spec_commit_bind.launches = 0


def spec_commit(step, carry: dict, xs: dict, selected, k: int) -> dict:
    """B5: rows < k of the batch bound into the carry.  CUDA tensors: the
    variant's kernel, in place; CPU tensors: commit_plain."""
    if _device(carry).type == "cpu":
        return commit_plain(step, carry, xs, selected, k)
    kernel = spec_commit_core if core_only(carry) else spec_commit_bind
    return kernel(step, carry, xs, selected, k)


# ------------------------------------------------------------ B6 chunk grid

def append_plain(bufs: dict, rows: dict, fill: int) -> dict:
    """rows[name] written into bufs[name] at row `fill`, in place."""
    for name, buf in bufs.items():
        r = rows[name].to(buf.dtype)
        _bits(buf)[fill:fill + r.shape[0]] = _bits(r)
    return bufs


def emit_plain(bufs: dict, chunk: int) -> tuple[dict, dict]:
    """-> (the first `chunk` rows of each buffer, the buffer shifted down
    by `chunk` with zeros after)."""
    heads, rest = {}, {}
    for name, buf in bufs.items():
        x = _bits(buf)
        heads[name] = x[:chunk].clone().view(buf.dtype)
        rest[name] = torch.cat([x[chunk:], torch.zeros_like(x[:chunk])]).view(buf.dtype)
    return heads, rest


class GridArgs(ctypes.Structure):
    """Mirror of `struct GridArgs` in csrc/grid.cu, field for field."""

    _fields_ = (
        [(f, ctypes.c_void_p * len(GRID_GROUPS)) for f in ("buf", "rows", "head", "rest")]
        + [("row_bytes", ctypes.c_longlong * len(GRID_GROUPS))]
        + [(f, ctypes.c_longlong) for f in ("n_rows", "fill", "chunk", "total_rows")]
        + [("unit", ctypes.c_int * len(GRID_GROUPS)), ("groups", ctypes.c_int)]
    )


def _grid_lib(dev: torch.device, bufs: dict) -> ctypes.CDLL:
    from . import build

    if list(bufs) != list(GRID_GROUPS):
        raise ValueError(f"grid buffers {list(bufs)}, expected {list(GRID_GROUPS)}")
    kstep.check_device("grid", dev, bufs)
    lib = build.load("grid")
    if lib.kss_grid_args_size() != ctypes.sizeof(GridArgs):
        raise RuntimeError("GridArgs layout differs between csrc/grid.cu and kernels/spec.py")
    return lib


def _unit(*values: int) -> int:
    """The largest word (16, 8, 4, 2 or 1 bytes) dividing every address and
    length."""
    for u in (16, 8, 4, 2):
        if all(v % u == 0 for v in values):
            return u
    return 1


def _row_bytes(t: torch.Tensor) -> int:
    return t[0].numel() * t.element_size() if t.shape[0] else 0


def grid_append(bufs: dict, rows: dict, fill: int) -> dict:
    """B6 append: rows[name] into bufs[name] at row `fill`, in place.  CUDA
    tensors: one launch over the five buffers; CPU tensors: append_plain."""
    dev = bufs["fc"].device
    if dev.type == "cpu":
        return append_plain(bufs, rows, fill)
    lib = _grid_lib(dev, bufs)
    kstep.check_device("grid_append", dev, rows)
    a = GridArgs()
    n_rows = rows["fc"].shape[0]
    for g, name in enumerate(GRID_GROUPS):
        buf, r = bufs[name], rows[name]
        if (r.dtype != buf.dtype or tuple(r.shape[1:]) != tuple(buf.shape[1:])
                or r.shape[0] != n_rows or not r.is_contiguous() or not buf.is_contiguous()):
            raise ValueError(f"grid_append {name}: rows {r.dtype} {tuple(r.shape)} do not "
                             f"fit the buffer {buf.dtype} {tuple(buf.shape)}")
        if fill + n_rows > buf.shape[0]:
            raise ValueError(f"grid_append {name}: rows [{fill}, {fill + n_rows}) past "
                             f"{buf.shape[0]}")
        rb = _row_bytes(buf)
        a.buf[g], a.rows[g], a.row_bytes[g] = buf.data_ptr(), r.data_ptr(), rb
        a.unit[g] = _unit(buf.data_ptr() + fill * rb, r.data_ptr(), n_rows * rb)
    a.n_rows, a.fill, a.groups = n_rows, fill, len(GRID_GROUPS)
    kstep.check_launch("grid_append", lib.kss_grid_append(ctypes.byref(a), kstep.stream_of(dev)))
    grid_append.launches += 1
    return bufs


def grid_emit(bufs: dict, chunk: int) -> tuple[dict, dict]:
    """B6 emit -> (heads, rest): heads the first `chunk` rows of each
    buffer, rest a second buffer holding the others shifted down, zeros
    after.  CUDA tensors: one launch over the five buffers; CPU tensors:
    emit_plain."""
    dev = bufs["fc"].device
    if dev.type == "cpu":
        return emit_plain(bufs, chunk)
    lib = _grid_lib(dev, bufs)
    a = GridArgs()
    total = bufs["fc"].shape[0]
    heads, rest = {}, {}
    for g, name in enumerate(GRID_GROUPS):
        buf = bufs[name]
        if buf.shape[0] != total or not buf.is_contiguous() or not chunk <= total:
            raise ValueError(f"grid_emit {name}: buffer {tuple(buf.shape)}, chunk {chunk}")
        heads[name] = torch.empty((chunk,) + tuple(buf.shape[1:]), dtype=buf.dtype, device=dev)
        rest[name] = torch.empty_like(buf)
        rb = _row_bytes(buf)
        a.buf[g], a.head[g], a.rest[g], a.row_bytes[g] = (
            buf.data_ptr(), heads[name].data_ptr(), rest[name].data_ptr(), rb)
        a.unit[g] = _unit(buf.data_ptr(), heads[name].data_ptr(), rest[name].data_ptr(),
                          chunk * rb, (total - chunk) * rb)
    a.chunk, a.total_rows, a.groups = chunk, total, len(GRID_GROUPS)
    kstep.check_launch("grid_emit", lib.kss_grid_emit(ctypes.byref(a), kstep.stream_of(dev)))
    grid_emit.launches += 1
    return heads, rest


grid_append.launches = 0
grid_emit.launches = 0

KERNELS = (spec_eval, spec_oracle, spec_round, spec_commit_core, spec_commit_bind,
           grid_append, grid_emit)
