"""Speculative pod-batch scheduling: the engine's default wave.

Port of kube_scheduler_simulator_tpu/parallel/speculative.py for one
device.  The scan replay is sequential-exact: each pod's evaluation sees
every earlier bind.  The wave batches it: evaluate a BATCH of B pending
pods against one frozen carry, let a CONFLICT ORACLE accept the longest
provably non-interfering prefix, fold the accepted binds into the carry
in one device call, and roll the rejected suffix into the next round
re-scored against the updated carry.  Results stay BIT-IDENTICAL to the
scan: the JAX module's docstring (:16-57) gives the exactness argument,
the dirty-node rule for node-local plugins and the interaction rule for
label-coupled ones, and it holds here unchanged.

Each round's device work is a hand-written kernel (kernels/spec.py):

  * sparse round (node-local plugin sets, `_sparse_ok`): spec_round (B4)
    then spec_oracle (B3), which the JAX package fuses into one jit;
  * dense round (label-coupled sets, and rounds whose feasible count
    passes the candidate cap): spec_eval (B2) then spec_oracle (B3);
  * either round as ONE dispatch through the cross-session fuse
    coordinator (parallel/fuse.py), which runs K sessions' rounds of one
    family in one launch of B11 (kernels/fuse.py);
  * commit: spec_commit_core or spec_commit_bind (B5), in place; where
    the host will not cut the round's K (`commit_folds`: a core-only
    carry, no interaction rule, no gang) the round's oracle launch
    commits the accepted prefix instead, and no commit kernel is
    launched;
  * the chunk grid: grid_append and grid_emit (B6);
  * the contention fallback: the scan's step_chunk (B1), resumed from
    the speculative carry.

On a mesh (`mesh=`, parallel/mesh.py, JAX :762-763, :969-979, :992-996)
the stream runs over `shard_workload(cw, mesh)`: the dense round's eval
is B12 `spec_eval_sharded` (kernels/mesh.py), one cluster per pod with
each "nodes" shard a group of its CTAs (a fused round of such sessions:
one table launch of the same kernel); the scan fallback is B12
`step_chunk_sharded`; the
batch ladder rounds its rungs to dp multiples.  The sparse round (B4), the oracle, the commit and the grid
stay unsharded, as in JAX (`_sparse_round_fn` takes no mesh).

Over a card mesh (B12b: the shards on separate cards, parallel/mesh.py)
the carry and the xs are per card (kernels/mesh.py Cards), and the
round's state lives as follows:

  * the dense eval is B12b `spec_eval_cards`: "dp" row r of cards takes
    the batch's r-th group of pods, and the outputs are joined in card
    order on the mesh's first card;
  * the oracle runs there, over the joined outputs, unchanged: it reads
    only the round's outputs;
  * the commit runs on each card over its own slice: B5's kernel with the
    card's node range (kernels/mesh.py spec_commit_cards), the owner card
    making the exactly-once updates and every card the cluster-wide ones
    and its slice's same-domain increments; so no commit is folded into
    the oracle launch (`commit_folds`), whose carry would be one card's;
  * the round is always dense: the sparse round gathers candidate rows
    from anywhere on the node axis and reads the carry at them, which
    over cards would mean gathering the carry each round; the dense round
    gives the same bytes (the module's exactness argument holds for
    either);
  * the grid, B7 and the decode run on the first card, as without a mesh;
  * the scan fallback is B12b `step_chunk_cards`.

Over a process mesh (B12c, parallel/distributed.py) every process runs
the stream alike: each round's outputs are joined on every process's
card, so every process runs the oracle over the same outputs and takes
the same K, the same cuts and the same fallback, with no broadcast of
the decision; the commit runs on each process's own card.

On the CPU each wrapper runs its plain PyTorch version instead.  The
device is the one `cw` lives on: `compile_workload` defaults to the card.

The result is a ReplayResult with the same compact chunk grid as
`replay()`, and `on_chunk(rr, lo, hi)` sees the chunks in ascending
order.  Residency is resolved exactly as the scan's
(framework/replay.py `_resolve_device_resident`): by default, with no
`on_chunk` consumer, each emitted grid chunk stays on the device,
retained under `_DEVICE_BUDGET`, and B7 (kernels/attribution.py) runs on
it so only its sums cross; otherwise each chunk is fetched to the host
as it fills.  The scan fallback's chunks follow the same rung.  The
heads a grid emit hands over are fresh tensors (kernels/spec.py
`grid_emit`), as are a round's and a scan chunk's outputs, so retaining
them aliases nothing.

Gangs: with `gang=` (the engine's wave context: `gid` [P] pod->group,
`start` [G] first member) a round's acceptance cut pulls back to the gang
boundary (framework/gang.py `aligned_cut`, JAX :1085), and `ignore=`
names plugins the caller handles outside the device pipeline (the
engine's Coscheduling plugin), as in JAX :655-661.

Cross-session fusion (JAX :698-717, :724-747, :939-966): each width
tier's stream opens a fuse stream of its family (`_fuse_family`) with
admission read from the session's accept rate, routes every round
through `FUSE.dispatch` keyed (family, kind, b), and closes it in a
finally, and again at once when it falls back to the scan.  The
autopilot's per-session overrides (`CONTROLS.spec_overrides`: starting
rung, candidate cap) are read where the JAX package reads them.  Taps:
the `speculative_round` span; `speculative_rounds_total`,
`speculative_accepted_total` and `speculative_rolled_back_total` under
the session scope (fuse admission and /api/v1/sessions read them),
`speculative_fallbacks_total`; BLACKBOX round and fallback events.
Fault seams: `speculative.round` at the top of every round,
`replay.scan_dispatch` at each round's and scan chunk's dispatch,
`replay.decision_fetch` after each result.

`unroll=` is taken as the JAX package takes it, a hint to the scan
fallback that cannot change a result: a value below 1 raises, as lax.scan
refuses it, and any other selects nothing, since the step kernel walks a
chunk's pods in one launch.

Env knobs, read as in JAX: KSS_TPU_SPECULATIVE_BATCH pins the batch (one
rung); KSS_TPU_SPECULATIVE_CANDIDATES caps the sparse round's candidate
set (default 128); KSS_TPU_SPECULATIVE_MIN_ACCEPT and
KSS_TPU_SPECULATIVE_FALLBACK_ROUNDS tune the scan-fallback trigger.
KSS_TPU_SPECULATIVE_TILE has no effect here (kernels/spec.py).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .. import resolve_device
from ..control import CONTROLS
from ..framework.gang import aligned_cut
from ..framework.pipeline import PACK_MODES, build_step
from ..framework.replay import (_DEVICE_BUDGET, ReplayResult, _CompactChunks, check_unroll,
                                _DeviceAttribution, _Landing, _clone_carry, _ready_event,
                                _compact_plan, _resolve_device_resident, _slice_xs,
                                _workload_scan_key)
from ..kernels import fuse as kfuse
from ..kernels import mesh as kmesh
from ..kernels import spec as kspec
from ..state.compile import CompiledWorkload
from ..utils.blackbox import BLACKBOX
from ..utils.env import env_float, env_int
from ..utils.faults import fault_point
from ..utils.tracing import TRACER
from .fuse import FUSE, fuse_enabled, session_admitted
from .mesh import shard_workload

# per-node plugins with no cross-pod coupling: filters are static or
# monotone in node allocation, scores depend only on the node's own
# accumulated resources, binds touch only carry["core"]  (JAX :129)
SAFE_SPECULATIVE = {
    "NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
    "TaintToleration", "NodeUnschedulable", "NodeName", "ImageLocality",
    "NodePorts",
}

# label-coupled plugins: a bound pod j changes pod k's evaluation ONLY
# when j is visible to k's selectors, or k to a term j imposes  (JAX :142)
LABEL_COUPLED = {"PodTopologySpread", "InterPodAffinity"}


def speculation_ok(cfg, have_manifests: bool = True,
                   ignore: frozenset | set = frozenset()) -> bool:
    """True when the ACTIVE plugin set (enabled list plus every per-point
    override) admits exact speculative batching.  Label-coupled plugins
    require the pod manifests (for the interaction rule); without them
    only the node-local class qualifies.  `ignore` names plugins the
    caller handles outside the device pipeline."""
    active = set(cfg.active_plugins()) - set(ignore)
    if any(cfg.is_custom(n) for n in active):
        return False
    if active <= SAFE_SPECULATIVE:
        return True
    return have_manifests and active <= (SAFE_SPECULATIVE | LABEL_COUPLED)


# ------------------------------------------------------------ interaction

def _pod_terms(pod: dict, namespaces: list[dict] | None) -> tuple[list, list]:
    """(selectors that OTHER pods are matched against for THIS pod's
    evaluation, terms this pod imposes ON others once bound).  Reads: the
    pod's spread-constraint selectors (same namespace, matchLabelKeys
    merged) and its interpod terms; writes: its interpod terms, which act
    on later pods as existing-pod constraints.  The terms come from the
    plugins' own normalizers, so namespaceSelector resolution and
    matchLabelKeys merging cannot diverge from what the evaluation
    matches."""
    from ..plugins.interpod import effective_terms
    from ..plugins.topologyspread import effective_constraints

    meta = pod.get("metadata") or {}
    ns = meta.get("namespace") or "default"
    reads: list[tuple[list, dict]] = []
    writes: list[tuple[list, dict]] = []
    for c in effective_constraints(pod):
        reads.append(([ns], c.get("labelSelector") or {}))
    for field in ("podAffinity", "podAntiAffinity"):
        for preferred in (False, True):
            for term, _w in effective_terms(pod, field, preferred,
                                            namespaces=namespaces):
                entry = (list(term.get("namespaces") or [ns]),
                         term.get("labelSelector") or {})
                reads.append(entry)
                writes.append(entry)
    return reads, writes


def _matches_any(terms: list, pod: dict) -> bool:
    from ..state.selectors import label_selector_matches

    meta = pod.get("metadata") or {}
    ns = meta.get("namespace") or "default"
    labels = {k: str(v) for k, v in (meta.get("labels") or {}).items()}
    for ns_list, sel in terms:
        if ns in ns_list and label_selector_matches(sel, labels):
            return True
    return False


class _InteractionOracle:
    """interacts(j, k): does pod j's bind change pod k's label-coupled
    state?  True when j matches any selector k READS, or k matches any
    term j WRITES.  Conservative and exact: a False guarantees k's
    spread/interpod inputs are untouched by j's bind."""

    def __init__(self, pods: list[dict], namespaces: list[dict] | None = None):
        self.pods = pods
        self.namespaces = namespaces
        self._terms = [None] * len(pods)

    def _t(self, i: int):
        if self._terms[i] is None:
            self._terms[i] = _pod_terms(self.pods[i], self.namespaces)
        return self._terms[i]

    def interacts(self, j: int, k: int) -> bool:
        k_reads, _ = self._t(k)
        _, j_writes = self._t(j)
        return (_matches_any(k_reads, self.pods[j])
                or _matches_any(j_writes, self.pods[k]))


def _interaction_cut(inter: _InteractionOracle, selected: np.ndarray,
                     base: int, k: int) -> int:
    """Shrink the dirty-node-accepted prefix [0, k) to the longest prefix
    with no label-coupled interaction: pod i is kept only when no
    earlier-kept BOUND pod interacts with it either way.  `base` is the
    batch's first absolute pod index."""
    bound: list[int] = []
    for i in range(k):
        if bound and any(inter.interacts(j, base + i) for j in bound):
            return i
        if int(selected[i]) >= 0:
            bound.append(base + i)
    return k


# sparse scoring is exact only for plugins whose node-axis statics/xs rows
# are read POSITIONALLY (gathering candidate rows keeps every read
# identical); label-coupled plugins index domain tables by value, so they
# take the dense eval instead
def _sparse_ok(active: set) -> bool:
    return active <= SAFE_SPECULATIVE


# ------------------------------------------------------------- ladder

def _batch_ladder(chunk: int, dp: int, pinned: int | None) -> list[int]:
    """Adaptive batch rungs: dp multiples growing x4 from 8*dp up to the
    chunk grid; a pinned batch is a one-rung ladder."""
    dp = max(dp, 1)

    def fit(b: int) -> int:
        b = max(b - b % dp, dp)
        return max(min(b, max(chunk - chunk % dp, dp)), 1)

    if pinned is not None:
        return [fit(pinned)]
    rungs: list[int] = []
    b = 8 * dp
    while fit(b) < fit(chunk):
        rungs.append(fit(b))
        b *= 4
    rungs.append(fit(chunk))
    # dedupe while preserving order (tiny workloads collapse rungs)
    out: list[int] = []
    for r in rungs:
        if not out or r != out[-1]:
            out.append(r)
    return out


# ------------------------------------------------------------- stream

class _SpecStats:
    """Per-stream tallies; the final tier's numbers are the wave's."""

    def __init__(self):
        self.rounds: list[tuple[int, int]] = []   # (accepted, round size)
        self.scan_pods = 0
        self.fallback_at: int | None = None
        self.final_batch = 0

    def as_dict(self, adaptive: bool) -> dict:
        accepts = [k for k, _ in self.rounds]
        total = sum(accepts)
        rolled = sum(m - k for k, m in self.rounds)
        return {
            "rounds": len(self.rounds),
            "batch": self.final_batch,
            "adaptive": adaptive,
            "round_batches": [m for _, m in self.rounds],
            "mean_accept": round(float(np.mean(accepts)), 2) if accepts else 0,
            "accepted_first_try": int(sum(k == m for k, m in self.rounds)),
            "accepted": total,
            "rolled_back": rolled,
            "accept_rate": round(total / (total + rolled), 4)
                if total + rolled else None,
            "fallback_at": self.fallback_at,
            "scan_pods": self.scan_pods,
        }


def _host(t: torch.Tensor) -> np.ndarray:
    """Blocking copy of a device tensor to host numpy, C order."""
    return np.ascontiguousarray(t.cpu().numpy())


def replay_speculative_stream(
        cw: CompiledWorkload, mesh=None, chunk: int = 512, unroll: int = 1,
        batch: int | None = None, pods: list[dict] | None = None,
        namespaces: list[dict] | None = None, on_chunk=None,
        device_resident: bool | None = None, gang=None,
        scan_fallback: bool = True, ignore: frozenset | set = frozenset(),
        device=None,
) -> tuple[ReplayResult, dict]:
    """Schedule the whole queue in streaming speculative rounds (module
    doc).  Same consumer contract as framework.replay.replay(): compact
    chunk-grid results, on_chunk(rr, lo, hi) in ascending contiguous order
    with re-delivery from chunk 0 on a width-tier overflow.

    pods: the pod manifests, required when label-coupled plugins
    (PodTopologySpread / InterPodAffinity) are active.  namespaces: the
    namespace manifests for interpod namespaceSelector resolution.

    device_resident: keep the grid chunks on the device (module doc);
    None resolves as the scan's does.

    gang: an object with `gid` ([P] int32 pod->group, -1 for plain pods)
    and `start` ([G] first member index) — round cuts pull back to gang
    boundaries so gangs stream as all-or-nothing prefix units.  ignore:
    plugins the caller handles outside the device pipeline (excluded from
    the sparse-round eligibility).  device: where the stream runs; None
    is the device `cw` was compiled for, anything else must name it.

    mesh: a parallel.mesh.Mesh, on one card or over cards (module doc).  unroll: the JAX
    package's scan unroll (module doc): below 1 raises, else no effect.

    Returns (rr, stats): rr is bit-identical to replay(cw) and the
    sequential oracle; stats records rounds, acceptance and fallback.
    Caller must have checked speculation_ok(cw.config, ...)."""
    check_unroll(unroll)
    if device is not None and resolve_device(device) != cw.device:
        raise ValueError(f"workload compiled for {cw.device}, stream asked for {device}")
    if mesh is not None:
        cw = shard_workload(cw, mesh)
    device_resident = _resolve_device_resident(device_resident, True, on_chunk)
    active = set(cw.config.active_plugins())
    inter: _InteractionOracle | None = None
    if active & LABEL_COUPLED:
        if pods is None:
            raise ValueError(
                "label-coupled plugins active: the speculative stream needs "
                "the pod manifests for the interaction rule")
        inter = _InteractionOracle(pods, namespaces)

    if batch is None:
        batch = env_int("KSS_TPU_SPECULATIVE_BATCH", 0) or None

    tiers = (("i64",) if "i64" in cw.host.get("score_dtypes", ())
             else (None, "i32", "i64"))
    for t, wide in enumerate(tiers):
        # cross-session fused dispatch (parallel/fuse.py): announce this
        # stream's family so compatible sessions' rounds can share one
        # launch.  The try/finally is the lifecycle contract: a wave abort
        # mid-round must not leave partners counting a dead stream as a
        # batch-mate, and the retry re-opens cleanly
        fuse_stream = None
        if fuse_enabled():
            fuse_stream = FUSE.stream_open(
                _fuse_family(cw, chunk, wide, ignore),
                admitted=session_admitted(TRACER.current_session()), mesh=cw.mesh)
        try:
            result = _spec_run(cw, chunk, batch, on_chunk, wide, inter, scan_fallback,
                               device_resident, gang, ignore, fuse_stream)
        finally:
            if fuse_stream is not None:
                FUSE.stream_close(fuse_stream)
        if result is not None:
            result[0].tiers = tiers[:t + 1]
            return result
        TRACER.count("replay_width_retries_total")
    raise AssertionError("unreachable: i64 speculative replay cannot overflow")


def _kcand(cw: CompiledWorkload, override: int | None) -> int:
    """The sparse round's candidate cap: the autopilot's per-session
    override, else KSS_TPU_SPECULATIVE_CANDIDATES (128), in [1, N]."""
    want = override if override is not None else env_int("KSS_TPU_SPECULATIVE_CANDIDATES", 128)
    return min(max(want, 1), cw.n_nodes)


def _fuse_family(cw: CompiledWorkload, chunk: int, wide, ignore: frozenset | set):
    """JAX :724: the fuse-compatibility family, everything that picks the
    round programs a stream will run short of the rung (which joins the
    per-dispatch key): the workload's scan key (statics CONTENT, the
    mesh, xs and carry SHAPES, plugin configuration, chunk), the width
    tier, the round kind and the candidate cap.  Streams of one family fuse, so sessions
    with different pods over the same fleet and queue size share rounds.
    The candidate cap resolves here exactly as _spec_run resolves it, or
    two streams of one family could pick different sparse rounds."""
    chunk = min(chunk, max(cw.n_pods, 1))
    base_key = _workload_scan_key(cw, chunk)
    active_eff = set(cw.config.active_plugins()) - set(ignore)
    _, ov_kcand = CONTROLS.spec_overrides(TRACER.current_session())
    kcand = _kcand(cw, ov_kcand)
    sparse = (_sparse_ok(active_eff) and kcand < cw.n_nodes
              and (cw.mesh is None or cw.mesh.cards is None))
    return (base_key, wide, sparse, kcand if sparse else None)


def commit_folds(carry: dict, inter, gang) -> bool:
    """Whether a round's commit is folded into its oracle launch (B5's
    core in csrc/oracle.cu): the carry is core-only, so the commit
    is spec_commit_core's, and the host cuts K after the launch neither by
    the interaction rule (`_interaction_cut`) nor at a gang boundary
    (`aligned_cut`), so the launch's K is the round's."""
    return kspec.core_only(carry) and inter is None and gang is None


def _spec_run(cw: CompiledWorkload, chunk: int, batch: int | None, on_chunk,
              wide, inter, scan_fallback: bool,
              device_resident: bool, gang=None,
              ignore: frozenset | set = frozenset(),
              fuse_stream=None) -> tuple[ReplayResult, dict] | None:
    """One width tier of the stream; None when a raw overflowed its group
    dtype (the caller reruns from a fresh carry at the next tier)."""
    dev = cw.device
    p = cw.n_pods
    chunk = min(chunk, max(p, 1))
    pack_mode, score_dtypes, score_cols = _compact_plan(cw, wide)
    step = build_step(cw, out_mode="compact", pack_mode=pack_mode,
                      score_dtypes=score_dtypes, wide_raw=wide)
    # a mesh's dp groups split every batch evenly (JAX :762)
    ladder = _batch_ladder(chunk, cw.mesh.shape["dp"] if cw.mesh is not None else 1, batch)
    adaptive = batch is None and len(ladder) > 1
    rung = 0
    min_accept = env_float("KSS_TPU_SPECULATIVE_MIN_ACCEPT", 0.25)
    fallback_rounds = (env_int("KSS_TPU_SPECULATIVE_FALLBACK_ROUNDS", 3)
                       if scan_fallback else 0)
    check_overflow = wide != "i64"

    n = cw.n_nodes
    compact = _CompactChunks(chunk=chunk, pack_mode=pack_mode, score_cols=score_cols)
    selected = np.full(p, -1, dtype=np.int32)
    feasible_count = np.zeros(p, dtype=np.int32)
    prefilter_reject = np.zeros(p, dtype=np.int32)
    rr = ReplayResult(cw=cw, selected=selected,
                      feasible_count=feasible_count,
                      prefilter_reject=prefilter_reject, compact=compact)

    # device-side chunk-grid accumulator: group buffers big enough for one
    # grid chunk plus the largest single append (a top-rung round or a
    # fallback scan chunk)
    extra = max(chunk, max(ladder))
    n8, n16, n32 = 0, 0, 0
    for g, _r in score_cols:
        n8 += g == "raw8"
        n16 += g == "raw16"
        n32 += g == "raw32"
    buf_shapes = {
        "packed": ((chunk + extra, n), PACK_MODES[pack_mode][0]),
        "raw8": ((chunk + extra, n8, n), torch.int8),
        "raw16": ((chunk + extra, n16, n), torch.int16),
        # the i64 tier's raw32 group IS int64: the buffers must not
        # truncate it
        "raw32": ((chunk + extra, n32, n),
                  torch.int64 if wide == "i64" else torch.int32),
        "fc": ((chunk + extra,), torch.int32),
    }
    bufs = {name: torch.zeros(s, dtype=d, device=dev) for name, (s, d) in buf_shapes.items()}
    fill = 0

    def deliver(lo_c: int, hi_c: int) -> None:
        if on_chunk is not None:
            on_chunk(rr, lo_c, hi_c)

    att_ctx = (_DeviceAttribution(cw, chunk, pack_mode, score_cols)
               if device_resident else None)
    if att_ctx is not None and not att_ctx.enabled:
        att_ctx = None

    def ingest_chunk(heads: dict) -> None:
        """Land one grid chunk (group name -> [chunk, ...] tensors) in the
        compact result: retained on the device with B7's sums, or fetched
        to the host; then deliver it to the consumer."""
        ci = len(compact.packed)
        lo_c = ci * chunk
        hi_c = min(lo_c + chunk, p)
        if device_resident:
            att = None
            if att_ctx is not None:
                out_like = SimpleNamespace(
                    packed_filter=heads["packed"], raw8=heads["raw8"], raw16=heads["raw16"],
                    raw32=heads["raw32"], feasible_count=heads["fc"])
                att = _Landing(att_ctx.run(out_like, lo_c)).result()
            compact.d2h_bytes.append(att.pop("_d2h_bytes") if att else 0)
            for group in _CompactChunks.GROUPS:
                getattr(compact, group).append(heads[group])
            compact.ready.append(_ready_event(dev))
            compact.att.append(att)
            _DEVICE_BUDGET.retain(compact, ci, compact.device_nbytes(ci))
        else:
            for group in _CompactChunks.GROUPS:
                getattr(compact, group).append(_host(heads[group]))
            compact.ready.append(None)
            compact.att.append(None)
            compact.d2h_bytes.append(sum(getattr(compact, g)[ci].nbytes
                                         for g in _CompactChunks.GROUPS))
        deliver(lo_c, hi_c)

    def emit_chunk() -> None:
        nonlocal bufs, fill
        heads, bufs = kspec.grid_emit(bufs, chunk)
        fill -= chunk
        ingest_chunk(heads)

    # copy: the commit and the scan update the carry in place, and
    # cw.init_carry must survive for later replays of the same workload
    carry = _clone_carry(cw.init_carry)
    stats = _SpecStats()
    mode = "speculative"
    low_streak = 0
    # sparse-round eligibility: node-local plugin sets score/select on the
    # gathered candidate rows only; label-coupled sets and wide-feasibility
    # rounds run the dense eval.  The session's control-plane overrides
    # (control/autopilot.py) replace the candidate cap and the starting
    # rung; both only partition the same exact rounds differently
    ov_rung, ov_kcand = CONTROLS.spec_overrides(TRACER.current_session())
    kcand = _kcand(cw, ov_kcand)
    # a card mesh's rounds are dense, its commits per card (module doc)
    cards = cw.mesh is not None and cw.mesh.cards is not None
    sparse = (_sparse_ok(set(cw.config.active_plugins()) - set(ignore)) and kcand < n
              and not cards)
    if sparse and adaptive:
        # sparse probes are cheap, so start at the TOP rung: a
        # contention-free wave's rounds are then whole aligned chunks
        # ingested directly; a collapse steps the ladder down round by
        # round and the bottom-rung fallback still engages.  The dense
        # eval keeps the climb-from-8 ramp
        rung = len(ladder) - 1
    if adaptive and ov_rung is not None:
        # the autopilot's starting rung: <0 is the top rung, else clamped
        # to this stream's ladder
        rung = len(ladder) - 1 if ov_rung < 0 else min(max(ov_rung, 0), len(ladder) - 1)

    def fused_call(kind: str, b: int, fn, member):
        """One round's device work, through the fuse coordinator: with no
        open stream (fusion off) or a closed one (this stream already
        fell back to the scan) it IS the direct call.  The key extends
        the family with the round's kind and batch, so only rounds of the
        same program ever share a launch."""
        if fuse_stream is None or fuse_stream.closed:
            return fn(member)
        return FUSE.dispatch(fuse_stream, (fuse_stream.family, kind, b), fn, (member,))

    def rows_of(out) -> dict:
        return {"packed": out.packed_filter, "raw8": out.raw8, "raw16": out.raw16,
                "raw32": out.raw32, "fc": out.feasible_count}

    lo = 0
    while lo < p:
        fault_point("speculative.round")
        if mode == "scan":
            # contention fallback: the scan's chunk kernel, resumed from
            # the speculative carry (bit-identical to the sequential carry
            # at pod `lo`).  The first fallback chunk is sized to reach
            # the chunk grid; every later one is a whole aligned chunk
            # whose outputs ingest directly
            aligned = fill == 0 and lo % chunk == 0
            hi = min(lo + (chunk if aligned else chunk - fill), p)
            m = hi - lo
            fault_point("replay.scan_dispatch")
            xs_chunk = _slice_xs(cw.xs, lo, hi, chunk)
            xs_chunk["is_pad"] = torch.arange(chunk, device=dev) >= m
            carry, out = step.scan(carry, xs_chunk)
            fault_point("replay.decision_fetch")
            sel = _host(out.selected)
            fc = _host(out.feasible_count)
            rej = _host(out.prefilter_reject)
            ovf = _host(out.raw_overflow)
            if check_overflow and ovf[:m].any():
                _DEVICE_BUDGET.drop(compact)
                return None
            selected[lo:hi] = sel[:m]
            feasible_count[lo:hi] = fc[:m]
            prefilter_reject[lo:hi] = rej[:m]
            if aligned:
                # a whole aligned chunk (or the final partial one, whose
                # pad rows are don't-cares exactly like the scan path's)
                ingest_chunk(rows_of(out))
            else:
                bufs = kspec.grid_append(bufs, rows_of(out), fill)
                fill += m
                while fill >= chunk:
                    emit_chunk()
            stats.scan_pods += m
            lo = hi
            continue

        b = ladder[rung]
        hi = min(lo + b, p)
        m = hi - lo
        with TRACER.span("speculative_round", batch=m, rung=b):
            fault_point("replay.scan_dispatch")
            xs = _slice_xs(cw.xs, lo, hi, b)
            xs["is_pad"] = torch.arange(b, device=dev) >= m
            # the round's oracle launch commits its accepted prefix where
            # the host will not cut K (commit_folds); the carry is then
            # updated in place by the launch, before K is read back
            fold = not cards and commit_folds(carry, inter, gang)
            dense = not sparse
            if sparse:
                # one dispatch per round (spec_round + spec_oracle); a
                # wide-feasibility round (max count past the candidate
                # cap) discards the sparse output and re-runs dense: its
                # oracle launch makes the same test and commits nothing
                (packed, reject_d, counts_d, raw8, raw16, raw32, ovf_d,
                 sel_dev, k_dev) = fused_call("round", b, kfuse.sparse_round,
                                              kfuse.Member(step, carry, xs, kcand,
                                                           m if fold else None))
                fault_point("replay.decision_fetch")
                fc = _host(counts_d)
                rej = _host(reject_d)
                if int(fc[:m].max(initial=0)) > kcand:
                    dense = True  # wide feasibility: this round runs dense
                else:
                    sel = _host(sel_dev)
                    ovf = _host(ovf_d)
                    rows = {"packed": packed, "raw8": raw8, "raw16": raw16,
                            "raw32": raw32, "fc": counts_d}
            if dense:
                # one dispatch per round: spec_eval + spec_oracle
                outs, k_dev = fused_call("dense", b, kfuse.dense_round,
                                         kfuse.Member(step, carry, xs, None,
                                                      m if fold else None))
                fault_point("replay.decision_fetch")
                sel = _host(outs.selected)
                fc = _host(outs.feasible_count)
                rej = _host(outs.prefilter_reject)
                ovf = _host(outs.raw_overflow)
                sel_dev = outs.selected
                rows = rows_of(outs)
            k = min(int(k_dev), m)
            if inter is not None and k > 1:
                k = _interaction_cut(inter, sel, lo, k)
            if gang is not None:
                k = aligned_cut(gang.gid, gang.start, lo, k, p)
            if check_overflow and ovf[:k].any():
                _DEVICE_BUDGET.drop(compact)
                return None
            selected[lo:lo + k] = sel[:k]
            feasible_count[lo:lo + k] = fc[:k]
            prefilter_reject[lo:lo + k] = rej[:k]
            if cards:
                carry = kmesh.spec_commit_cards(step, carry, xs, sel_dev, k)
            elif not fold:
                carry = kspec.spec_commit(step, carry, xs, sel_dev, k)
            if k == m == chunk and fill == 0 and lo % chunk == 0:
                # a fully-accepted top-rung round at an aligned position IS
                # a grid chunk: ingest its outputs directly, with no
                # accumulator passes (the steady state of a contention-free
                # wave)
                ingest_chunk(rows)
            else:
                bufs = kspec.grid_append(bufs, rows, fill)
                fill += k
                while fill >= chunk:
                    emit_chunk()
        stats.rounds.append((k, m))
        stats.final_batch = b
        TRACER.count("speculative_rounds_total")
        TRACER.inc("speculative_accepted_total", k)
        if m > k:
            TRACER.inc("speculative_rolled_back_total", m - k)
        TRACER.observe("speculative_accept_fraction", k / m)
        BLACKBOX.record("speculative.round", batch=m, accepted=k, rung=b,
                        accept_fraction=round(k / m, 4))
        lo += k
        # contention-aware controller: full-accept rounds climb the
        # ladder, heavily-cut rounds step down, and a sustained accept
        # collapse at the bottom rung hands the rest of the wave to the
        # sequential scan
        if adaptive:
            if k == m and rung < len(ladder) - 1:
                rung += 1
            elif k < max(1, m // 4) and rung > 0:
                rung -= 1
        if fallback_rounds > 0 and rung == 0 and lo < p:
            if k / m < min_accept:
                low_streak += 1
                if low_streak >= fallback_rounds:
                    mode = "scan"
                    # the scan tail dispatches no more rounds: close the
                    # fuse stream now (idempotent; the tier loop's finally
                    # closes again) so partner leaders stop counting it
                    if fuse_stream is not None:
                        FUSE.stream_close(fuse_stream)
                    stats.fallback_at = lo
                    TRACER.inc("speculative_fallbacks_total")
                    BLACKBOX.record("speculative.fallback", at=lo, rounds=len(stats.rounds))
            else:
                low_streak = 0

    if fill > 0:
        emit_chunk()
    return rr, stats.as_dict(adaptive)


def replay_speculative(cw: CompiledWorkload, mesh=None, batch: int | None = None,
                       pods: list[dict] | None = None,
                       namespaces: list[dict] | None = None,
                       ) -> tuple[ReplayResult, dict]:
    """Whole-queue speculative replay without a streaming consumer, the
    direct-call surface.  Results land in the same compact chunk grid as
    the scan.  The scan fallback stays OFF here: direct callers probe
    speculation itself, and every pod goes through a round."""
    return replay_speculative_stream(cw, mesh, batch=batch, pods=pods,
                                     namespaces=namespaces,
                                     scan_fallback=False)
