"""The scheduling cycle for one pod, as plain PyTorch and as one kernel.

Port of kube_scheduler_simulator_tpu/framework/pipeline.py: `StepOut` :46,
`CompactOut` :59, `PACK_MODES` :99, `choose_pack_mode` :107,
`_filter_phase` :238, `_score_phase` :254, `_prefilter_reject` :323,
`pack_filter_codes` :340, `build_step` :360, and the host-interleaved
path's `renormalize` :198 and `build_phased` :446 (kernel B10,
kernels/phased.py).  Per pod:

    Filter x (plugins x nodes) -> first-fail pack -> Score x (plugins x
    nodes) -> NormalizeScore -> weights -> select -> bind

`build_step(cw, ...)` returns a `Step`.  `Step.plain(carry, sl)` composes
the plugins' plain functions for one pod (the reference the kernel is held
to); `Step.eval_plain(carry, sl)` is the same pod without the bind (the
speculative wave's dense eval, parallel/speculative.py);
`Step.scan(carry, xs_chunk)` walks a chunk of pods in order — the
counterpart of the JAX package's `lax.scan` (framework/replay.py:1130).
For tensors on the CPU, `scan` loops `plain`; for tensors on the card it
launches the hand-written kernel once for the chunk
(kernels/step.py, csrc/step.cu), which updates the carry in place.

Fidelity notes (as in the JAX package):
  * Filter plugins run in upstream order; the framework stops at the first
    failing plugin per node — all codes are computed and the
    stop-at-first-fail truncation is reconstructed by the decoder.
  * Scoring is always computed; the decoder drops it when fewer than two
    nodes are feasible, and selection respects feasibility.
  * Host selection: highest weighted-normalized total; ties go to the
    LOWEST node index (the framework's documented divergence from
    upstream's random tie-break, applied identically in the CPU oracle).
  * PreFilter rejects: bit 0 is VolumeRestrictions' dynamic
    ReadWriteOncePod conflict (against the cluster-wide carry), bit 1 the
    compile-time rejects (xs["force_unsched"]); a rejected pod selects -1
    and binds nothing.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..plugins import (
    affinity, imagelocality, interpod, noderesources, nodevolumelimits, ports,
    taints, topologyspread, volumebinding, volumerestrictions, volumezone,
)
from ..plugins.fitscoring import parse_balanced_resources, parse_fit_strategy
from ..utils.faults import fault_point


class StepOut(NamedTuple):
    filter_codes: torch.Tensor    # [F, N] int32, 0 == pass (already skip-masked)
    score_raw: torch.Tensor       # [S, N] int32
    score_final: torch.Tensor     # [S, N] int32 (normalized x weight)
    selected: torch.Tensor        # int32, -1 == unschedulable
    feasible_count: torch.Tensor  # int32
    prefilter_reject: torch.Tensor  # int32, >0 == PreFilter reject


class CompactOut(NamedTuple):
    """Transfer-optimized step output: the first failing filter plugin and
    its code packed into one word per node (PACK_MODES), raw scores split
    into int8/int16/int32 groups by compile-time bounds with an overflow
    flag that triggers a wider rerun, and no finalscore (the host
    recomputes it, framework/hostnorm.py).  Raws whose group is "host"
    are precompiled host rows and are not emitted."""

    packed_filter: torch.Tensor   # [N]; 0 = all filter plugins passed
    raw8: torch.Tensor            # [S8, N] int8 raw scores (provably |x|<=127)
    raw16: torch.Tensor           # [S16, N] int16 raw scores
    raw32: torch.Tensor           # [S32, N] int32 (int64 on the last tier)
    raw_overflow: torch.Tensor    # bool: some raw didn't fit its group dtype
    selected: torch.Tensor        # int32, -1 == unschedulable
    feasible_count: torch.Tensor  # int32
    prefilter_reject: torch.Tensor  # int32


# packed-filter layouts: mode -> (dtype, code bits, ff bits).
# Layout (LSB first): [code][first_fail_idx + 1].  A word of 0 means
# "all filter plugins passed".
PACK_MODES = {
    "p8": (torch.uint8, 5, 3),
    "p16": (torch.uint16, 8, 8),
    "p32": (torch.int32, 16, 15),
    "p64": (torch.int64, 32, 16),
}


def choose_pack_mode(max_code: int, n_filters: int) -> str:
    for mode in ("p8", "p16", "p32", "p64"):
        _, code_bits, ff_bits = PACK_MODES[mode]
        # the packed word stores first_fail_idx + 1, max value n_filters
        if max_code < (1 << code_bits) and n_filters < (1 << ff_bits):
            return mode
    return "p64"


def _filter_one(name: str, cw, carry, sl) -> torch.Tensor:
    if cw.config.is_custom(name):
        return sl[name].codes.to(torch.int32)  # B13: the precompiled row
    if name == "NodeResourcesFit":
        return noderesources.fit_filter(cw.statics["core"], sl["core"], carry["core"])
    if name == "NodeAffinity":
        return affinity.filter_kernel(cw.statics["NodeAffinity"], sl["NodeAffinity"])
    if name == "TaintToleration":
        return taints.taint_filter(sl["TaintToleration"])
    if name == "NodeUnschedulable":
        return taints.unsched_filter(sl["NodeUnschedulable"])
    if name == "NodeName":
        return taints.nodename_filter(sl["NodeName"])
    if name == "NodePorts":
        return ports.filter_kernel(cw.statics["NodePorts"], sl["NodePorts"], carry["NodePorts"])
    if name == "PodTopologySpread":
        return topologyspread.filter_kernel(
            cw.statics["PodTopologySpread"], sl["PodTopologySpread"], carry["PodTopologySpread"]
        )
    if name == "InterPodAffinity":
        return interpod.filter_kernel(
            cw.statics["InterPodAffinity"], sl["InterPodAffinity"], carry["InterPodAffinity"]
        )
    if name == "VolumeRestrictions":
        return volumerestrictions.filter_kernel(
            cw.statics["VolumeRestrictions"], sl["VolumeRestrictions"],
            carry["VolumeRestrictions"])
    if name == "NodeVolumeLimits":
        return nodevolumelimits.filter_kernel(
            cw.statics["NodeVolumeLimits"], sl["NodeVolumeLimits"], carry["NodeVolumeLimits"])
    if name == "VolumeBinding":
        return volumebinding.filter_kernel(
            cw.statics["VolumeBinding"], sl["VolumeBinding"], carry["VolumeBinding"])
    if name == "VolumeZone":
        return volumezone.filter_kernel(sl["VolumeZone"])
    raise ValueError(f"no filter function for {name}")


def _score_one(name: str, cw, carry, sl, feasible):
    """-> (raw int64 [N], normalized int64 [N])."""
    if cw.config.is_custom(name):
        raw = sl[name].scores.to(torch.int64)  # B13: the precompiled row
        # a custom NormalizeScore cannot run inside the step; the engine
        # routes such configs to the host path (engine._needs_host_path)
        # and replay() refuses them
        return raw, raw
    if name == "NodeResourcesFit":
        raw = noderesources.fit_score(
            cw.statics["core"], sl["core"], carry["core"],
            strategy=parse_fit_strategy(cw.config.args.get(name)),
            schema=cw.schema)
        return raw, raw  # no ScoreExtensions
    if name == "NodeResourcesBalancedAllocation":
        raw = noderesources.balanced_score(
            cw.statics["core"], sl["core"], carry["core"],
            resources=parse_balanced_resources(cw.config.args.get(name)),
            schema=cw.schema)
        return raw, raw  # no ScoreExtensions
    if name == "ImageLocality":
        raw = imagelocality.score_kernel(sl["ImageLocality"])
        return raw, raw  # no ScoreExtensions
    if name == "VolumeBinding":
        raw = volumebinding.score_kernel(feasible.shape[0], feasible.device)
        return raw, raw  # scorer nil with VolumeCapacityPriority off
    if name == "NodeAffinity":
        raw = affinity.score_kernel(cw.statics["NodeAffinity"], sl["NodeAffinity"])
        return raw, affinity.normalize(raw, feasible)
    if name == "TaintToleration":
        raw = taints.taint_score(sl["TaintToleration"])
        return raw, taints.taint_normalize(raw, feasible)
    if name == "PodTopologySpread":
        raw, ignored = topologyspread.score_kernel(
            cw.statics["PodTopologySpread"], sl["PodTopologySpread"], carry["PodTopologySpread"]
        )
        return raw, topologyspread.normalize(raw, ignored, feasible)
    if name == "InterPodAffinity":
        raw = interpod.score_kernel(
            cw.statics["InterPodAffinity"], sl["InterPodAffinity"], carry["InterPodAffinity"]
        )
        return raw, interpod.normalize(raw, feasible)
    raise ValueError(f"no score function for {name}")


def _filter_phase(cw, carry, sl, filter_names):
    """filters in config order -> ([F, N] codes, [N] feasible)."""
    n = cw.n_nodes
    dev = carry["core"].requested.device
    codes = []
    feasible = torch.ones(n, dtype=torch.bool, device=dev)
    for name in filter_names:
        # broadcast: compact builders emit [1]-shaped always-pass rows
        code = torch.broadcast_to(_filter_one(name, cw, carry, sl), (n,))
        x = sl.get(name)
        if x is not None and hasattr(x, "filter_skip"):
            code = torch.where(x.filter_skip, 0, code)
        codes.append(code)
        feasible = feasible & (code == 0)
    filter_codes = (torch.stack(codes) if codes
                    else torch.zeros((0, n), dtype=torch.int32, device=dev))
    return filter_codes, feasible


def _score_phase(cw, carry, sl, weights, score_names, feasible):
    """score -> normalize -> weight over whatever node set the inputs
    cover: the full [N] axis, or a gathered candidate subset (the sparse
    round of parallel/speculative.py passes cw/carry/sl with their node
    axes gathered and `feasible` marking the valid rows; every
    normalization reduces over that mask, so the subset result equals the
    dense one at those positions).  Returns (score_raw [S, n], score_final
    [S, n], total [n] with infeasible forced to -1)."""
    n = feasible.shape[0]
    raws, finals = [], []
    total = torch.zeros(n, dtype=torch.int64, device=feasible.device)
    for i, name in enumerate(score_names):
        raw, normed = _score_one(name, cw, carry, sl, feasible)
        final = normed * weights[i]
        x = sl.get(name)
        if x is not None and hasattr(x, "score_skip"):
            raw = torch.where(x.score_skip, 0, raw)
            final = torch.where(x.score_skip, 0, final)
        raws.append(raw)
        finals.append(final)
        total = total + final
    if raws:
        score_raw, score_final = torch.stack(raws), torch.stack(finals)
    else:
        score_raw = score_final = torch.zeros((0, n), dtype=torch.int64,
                                              device=feasible.device)
    total = torch.where(feasible, total, -1)
    return score_raw, score_final, total


def _bind_phase(cw, carry, sl, selected):
    """Apply a bind of this pod to node `selected` (-1: no-op)."""
    new_carry = dict(carry)
    new_carry["core"] = noderesources.core_bind_update(carry["core"], sl["core"], selected)
    if "NodePorts" in carry:
        new_carry["NodePorts"] = ports.bind_update(
            cw.statics["NodePorts"], sl["NodePorts"], carry["NodePorts"], selected)
    if "PodTopologySpread" in carry:
        new_carry["PodTopologySpread"] = topologyspread.bind_update(
            cw.statics["PodTopologySpread"], sl["PodTopologySpread"],
            carry["PodTopologySpread"], selected,
        )
    if "InterPodAffinity" in carry:
        new_carry["InterPodAffinity"] = interpod.bind_update(
            cw.statics["InterPodAffinity"], sl["InterPodAffinity"],
            carry["InterPodAffinity"], selected,
        )
    if "VolumeRestrictions" in carry:
        new_carry["VolumeRestrictions"] = volumerestrictions.bind_update(
            sl["VolumeRestrictions"], carry["VolumeRestrictions"], selected)
    if "NodeVolumeLimits" in carry:
        new_carry["NodeVolumeLimits"] = nodevolumelimits.bind_update(
            sl["NodeVolumeLimits"], carry["NodeVolumeLimits"], selected)
    if "VolumeBinding" in carry:
        new_carry["VolumeBinding"] = volumebinding.bind_update(
            cw.statics["VolumeBinding"], sl["VolumeBinding"], carry["VolumeBinding"],
            selected)
    return new_carry


def _prefilter_reject(cw, carry, sl) -> torch.Tensor:
    """Dynamic (replay-state-dependent) PreFilter rejects + the static
    compile-time ones (xs['force_unsched']).  >0 forces selected = -1.
    Bit 0: VolumeRestrictions' ReadWriteOncePod conflict; bit 1: the
    compile-time reject; the decoder resolves plugin attribution in
    prefilter order."""
    code = torch.zeros((), dtype=torch.int32, device=carry["core"].requested.device)
    if "VolumeRestrictions" in carry:
        code = volumerestrictions.prefilter_reject(
            sl["VolumeRestrictions"], carry["VolumeRestrictions"])
    force = sl.get("force_unsched")
    if force is not None:
        code = code | torch.where(force, 2, 0).to(torch.int32)
    return code


def pack_filter_codes(filter_codes: torch.Tensor, n: int, mode: str) -> torch.Tensor:
    """[F, N] codes -> [N] packed first-fail word (see PACK_MODES): 0 =
    all pass, else (first_fail_idx + 1) << code_bits | code."""
    dtype, code_bits, _ = PACK_MODES[mode]
    acc_dtype = torch.int64 if mode == "p64" else torch.int32
    if filter_codes.shape[0] == 0:
        packed = torch.zeros(n, dtype=acc_dtype, device=filter_codes.device)
    else:
        fail = filter_codes != 0
        any_fail = fail.any(dim=0)
        ff = torch.argmax(fail.to(torch.uint8), dim=0)  # first max == lowest plugin index
        code_at = torch.gather(filter_codes, 0, ff[None, :])[0]
        packed = torch.where(
            any_fail,
            ((ff.to(acc_dtype) + 1) << code_bits) | code_at.to(acc_dtype),
            0,
        )
    return packed.to(dtype)


class Step:
    """The per-pod step of one compiled workload and output contract.

    out_mode "full" -> StepOut; "compact" -> CompactOut.  score_dtypes:
    per-scorer "i8"/"i16"/"i32"/"host" group (compact mode); wide_raw
    "i32"/"i64" pools every transferred scorer into raw32 at that width
    (the replay's widening ladder)."""

    def __init__(self, cw, out_mode: str = "full", pack_mode: str = "p16",
                 score_dtypes: tuple = (), wide_raw: str | None = None):
        if out_mode not in ("full", "compact"):
            raise ValueError(f"out_mode {out_mode!r}")
        if pack_mode not in PACK_MODES:
            raise ValueError(f"pack_mode {pack_mode!r}")
        if wide_raw not in (None, "i32", "i64"):
            raise ValueError(f"wide_raw {wide_raw!r}")
        cfg = cw.config
        self.cw = cw
        self.out_mode = out_mode
        self.pack_mode = pack_mode
        self.wide_raw = wide_raw
        self.filter_names = cfg.filters()
        self.score_names = cfg.scorers()
        self.weights = [cfg.weight(n) for n in self.score_names]
        # InterPodAffinity's hardPodAffinityWeight as a Python int, read
        # from the device once here: the kernels take it as a scalar, and
        # reading the tensor at every launch would wait for the card
        # a card mesh's statics are per card (kernels/mesh.py Cards); the
        # weight is the same on every card
        statics = cw.statics[0] if isinstance(cw.statics, tuple) else cw.statics
        ip = statics.get("InterPodAffinity")
        self.ip_hard_weight = int(ip.hard_weight) if ip is not None else 0
        if out_mode == "compact" and len(score_dtypes) != len(self.score_names):
            raise ValueError("compact mode needs one score dtype per scorer")
        self.score_dtypes = tuple(score_dtypes)

    def plain(self, carry: dict[str, Any], sl: dict[str, Any]):
        """One pod through the plain PyTorch functions -> (carry', out)."""
        out = self.eval_plain(carry, sl)
        return _bind_phase(self.cw, carry, sl, out.selected), out

    def eval_plain(self, carry: dict[str, Any], sl: dict[str, Any]):
        """One pod's outputs against `carry`, without the bind."""
        cw = self.cw
        weights = torch.tensor(self.weights, dtype=torch.int64,
                               device=carry["core"].requested.device)
        filter_codes, feasible = _filter_phase(cw, carry, sl, self.filter_names)
        score_raw, score_final, total = _score_phase(
            cw, carry, sl, weights, self.score_names, feasible)
        reject = _prefilter_reject(cw, carry, sl)
        feasible_count = torch.sum(feasible, dtype=torch.int32)
        feasible_count = torch.where(reject > 0, 0, feasible_count)
        selected = torch.argmax(total).to(torch.int32)  # first max == lowest index
        selected = torch.where(feasible_count > 0, selected, -1)
        is_pad = sl.get("is_pad")
        if is_pad is not None:
            selected = torch.where(is_pad, -1, selected)
        return self.pod_out(filter_codes, score_raw, score_final, selected,
                            feasible_count, reject)

    def _raw_groups(self, score_raw) -> dict[str, list]:
        """The compact groups' raw rows of [S, n] int64 score_raw."""
        groups: dict[str, list] = {"i8": [], "i16": [], "i32": []}
        for s, g in enumerate(self.score_dtypes):
            if g == "host":
                continue  # precompiled host row: never fetched
            groups["i32" if self.wide_raw else g].append(score_raw[s])
        return groups

    def raw_overflow(self, score_raw) -> torch.Tensor:
        """Whether some raw of [S, n] int64 score_raw does not survive the
        narrowing that is checked (compact mode): the i16 group on the
        first tier, the i32 group on the second.  i8 members are provably
        in range (compile-time bounds).  Any node axis: the node-sharded
        step ORs it over shards."""
        groups = self._raw_groups(score_raw)
        ovf = torch.zeros((), dtype=torch.bool, device=score_raw.device)
        if self.wide_raw is None and groups["i16"]:
            full = torch.stack(groups["i16"])
            ovf = torch.any(full != full.to(torch.int16).to(full.dtype))
        elif self.wide_raw == "i32" and groups["i32"]:
            full = torch.stack(groups["i32"])
            ovf = torch.any(full != full.to(torch.int32).to(full.dtype))
        return ovf

    def pod_out(self, filter_codes, score_raw, score_final, selected, feasible_count,
                reject, overflow=None):
        """One pod's StepOut / CompactOut from its [F, N] codes, [S, N]
        int64 raws and finals and its scalars; the compact raw_overflow is
        computed here unless given (the node-sharded step's OR of its
        shards')."""
        if self.out_mode == "full":
            return StepOut(
                filter_codes=filter_codes.to(torch.int32),
                score_raw=score_raw.to(torch.int32),
                score_final=score_final.to(torch.int32),
                selected=selected,
                feasible_count=feasible_count,
                prefilter_reject=reject,
            )
        groups = self._raw_groups(score_raw)
        n = self.cw.n_nodes

        def stack(rows, dtype):
            if not rows:
                return torch.zeros((0, n), dtype=dtype, device=score_raw.device)
            return torch.stack(rows).to(dtype)

        return CompactOut(
            packed_filter=pack_filter_codes(filter_codes, n, self.pack_mode),
            raw8=stack(groups["i8"], torch.int8),
            raw16=stack(groups["i16"], torch.int16),
            raw32=stack(groups["i32"],
                        torch.int64 if self.wide_raw == "i64" else torch.int32),
            raw_overflow=self.raw_overflow(score_raw) if overflow is None else overflow,
            selected=selected,
            feasible_count=feasible_count,
            prefilter_reject=reject,
        )

    def plain_scan(self, carry: dict[str, Any], xs_chunk: dict[str, Any]):
        """A chunk of pods through `plain`, in order -> (carry', outs
        stacked along a leading pod axis)."""
        c = xs_chunk["is_pad"].shape[0]
        outs = []
        for i in range(c):
            carry, out = self.plain(carry, slice_pod(xs_chunk, i))
            outs.append(out)
        cls = StepOut if self.out_mode == "full" else CompactOut
        return carry, cls(*[_stack([getattr(o, f) for o in outs])
                            for f in cls._fields])

    def scan(self, carry: dict[str, Any], xs_chunk: dict[str, Any]):
        """A chunk of pods, in order -> (carry', stacked outs), through the
        kernel wrapper: one launch of the step kernel for tensors on the
        card (the carry updated in place), `plain_scan` for tensors on the
        CPU.  A workload sharded over a mesh (parallel/mesh.py
        shard_workload) runs the node-sharded step instead (B12,
        kernels/mesh.py step_chunk_sharded; over a card mesh B12b,
        step_chunk_cards, the carry and xs per card)."""
        if self.cw.mesh is not None:
            from ..kernels.mesh import step_chunk_cards, step_chunk_sharded

            if self.cw.mesh.cards is not None:
                return step_chunk_cards(self, carry, xs_chunk)
            return step_chunk_sharded(self, carry, xs_chunk)
        from ..kernels.step import step_chunk

        return step_chunk(self, carry, xs_chunk)

    def __call__(self, carry: dict[str, Any], sl: dict[str, Any]):
        """One pod -> (carry', out): a chunk of one through `scan` (a card
        mesh's carry and pod per card)."""
        if isinstance(sl, tuple):  # kernels/mesh.py Cards
            xs1 = sl.map(lambda part: _map_tree(lambda a: a[None], part))
            if "is_pad" not in xs1[0]:
                xs1["is_pad"] = torch.zeros(1, dtype=torch.bool)
        else:
            xs1 = _map_tree(lambda a: a[None], sl)
            if "is_pad" not in xs1:
                xs1["is_pad"] = torch.zeros(1, dtype=torch.bool,
                                            device=carry["core"].requested.device)
        carry, out = self.scan(carry, xs1)
        return carry, type(out)(*[v[0] for v in out])


def build_step(cw, out_mode: str = "full", pack_mode: str = "p16",
               score_dtypes: tuple = (), wide_raw: str | None = None) -> Step:
    """pipeline.py:360: the step of one compiled workload (see Step).
    The port builds every replay's, stream's and host path's step here,
    so this is the `compile.build` fault seam's one site (the JAX package
    fires it where its compile cache builds a program, replay.py:1023),
    and it keeps the JAX seam's telemetry (replay.py:1025-1051): the
    build's seconds in `scan_compile_build_seconds{key, result}` and a
    black-box `compile.build` (or `compile.fail`) event.  `key` is a
    short id of the step's shape.  The port has no program cache (the
    kernels are built once, as libraries; a step costs a Python object),
    so it keeps no `scan_compile_cache_entries` gauge."""
    import time
    import zlib

    from ..utils.blackbox import BLACKBOX
    from ..utils.tracing import TRACER

    key = (cw.n_nodes, tuple(cw.config.active_plugins()), out_mode, pack_mode,
           tuple(score_dtypes), wide_raw)
    key_id = f"{zlib.crc32(repr(key).encode()) & 0xffffffff:08x}"
    t0 = time.perf_counter()
    try:
        fault_point("compile.build")
        step = Step(cw, out_mode=out_mode, pack_mode=pack_mode,
                    score_dtypes=score_dtypes, wide_raw=wide_raw)
    except BaseException as e:
        TRACER.observe("scan_compile_build_seconds", time.perf_counter() - t0, key=key_id,
                       result="error")
        BLACKBOX.record("compile.fail", key=key_id, error=f"{type(e).__name__}: {e}"[:200])
        raise
    dt = time.perf_counter() - t0
    TRACER.observe("scan_compile_build_seconds", dt, key=key_id, result="ok")
    BLACKBOX.record("compile.build", key=key_id, seconds=round(dt, 3))
    return step


# the in-tree scorers with ScoreExtensions: the ones renormalize recomputes
NORMALIZING = ("NodeAffinity", "TaintToleration", "PodTopologySpread", "InterPodAffinity")


def renormalize_plain(name: str, cw, carry, sl, raw, feasible) -> torch.Tensor:
    """pipeline.py:198 `renormalize` for an in-tree scorer, plain: its
    NormalizeScore over [N] raw scores (possibly hook-modified) and a
    host-edited feasibility -> [N] int64.  `sl` is the pod's slice (no
    leading axis).  The CPU path and the card's reference for
    renormalize_rows (kernels/phased.py), row by row."""
    raw = raw.to(torch.int64)
    if name not in NORMALIZING:
        return raw  # no ScoreExtensions
    if name == "NodeAffinity":
        return affinity.normalize(raw, feasible)
    if name == "TaintToleration":
        return taints.taint_normalize(raw, feasible)
    if name == "InterPodAffinity":
        return interpod.normalize(raw, feasible)
    if name == "PodTopologySpread":
        _, ignored = topologyspread.score_kernel(
            cw.statics["PodTopologySpread"], sl["PodTopologySpread"],
            carry["PodTopologySpread"])
        return topologyspread.normalize(raw, ignored, feasible)
    raise AssertionError(f"{name} is in NORMALIZING without a NormalizeScore here")


def renormalize(name: str, phased: "Phased", carry, xs1, raw, feasible) -> torch.Tensor:
    """pipeline.py:198: host-side NormalizeScore recompute for one plugin
    when AfterScore hooks or hook-changed feasibility invalidate the fused
    normalization.  raw [N] int64 and feasible [N] bool on the carry's
    device; xs1 the pod's xs with a leading axis of 1.

    A custom plugin with normalize() runs it in Python on the feasible
    raws (pipeline.py:208-219; arbitrary Python cannot run in a kernel,
    and upstream wraps out-of-tree ScoreExtensions as in-tree ones,
    wrappedplugin.go:388-415); one without returns its raw, as does an
    in-tree scorer without ScoreExtensions.  An in-tree scorer with them:
    a one-row renormalize_rows, kernel B10 on the card and
    renormalize_plain on the CPU.  The engine's host path calls it for
    custom plugins and renormalizes a pod's in-tree rows together, one
    renormalize_rows launch a flush (engine.py _hooked_score_phase)."""
    cfg = phased.step.cw.config
    if cfg.is_custom(name):
        plugin = cfg.custom[name]
        if not getattr(plugin, "has_normalize", False):
            return raw
        import numpy as np

        raw_np = raw.cpu().numpy()
        idx = np.flatnonzero(feasible.cpu().numpy())
        vals = plugin.normalize([int(raw_np[j]) for j in idx])
        out = np.zeros_like(raw_np)
        out[idx] = np.asarray(list(vals), dtype=out.dtype)
        return torch.from_numpy(out).to(raw.device)
    if name not in NORMALIZING:
        return raw  # no ScoreExtensions
    from ..kernels.phased import renormalize_rows

    return renormalize_rows(phased.step, [name], carry, xs1, raw[None], feasible)[0]


class Phased:
    """pipeline.py:446 `build_phased`: the step split for the
    host-interleaved path (the extender round-trip, SURVEY.md §3.3) —
    the host can veto or boost nodes between the device's score phase
    and the bind.

      eval(carry, xs1) -> StepOut of the pod (selected = the device's own
                          choice, advisory; the carry NOT updated)
      bind(carry, xs1, selected) -> carry with the pod bound at selected

    xs1 is the pod's xs with a leading axis of 1.  On the card eval is
    kernel B10 `phased_eval` and bind is B5's `spec_commit_bind` on a
    batch of one, which updates the carry IN PLACE (the JAX bind_fn
    returns a new carry): a caller starts from a private copy of
    cw.init_carry.  On the CPU: `plain_eval` and `_bind_phase`."""

    def __init__(self, cw):
        self.step = build_step(cw, out_mode="full")

    def plain_eval(self, carry: dict[str, Any], xs1: dict[str, Any]) -> StepOut:
        """B10 eval's plain version: Step.eval_plain of the pod."""
        return self.step.eval_plain(carry, slice_pod(xs1, 0))

    def eval(self, carry: dict[str, Any], xs1: dict[str, Any]) -> StepOut:
        from ..kernels.phased import phased_eval

        return phased_eval(self.step, carry, xs1)

    def bind(self, carry: dict[str, Any], xs1: dict[str, Any], selected: int):
        dev = carry["core"].requested.device
        if dev.type == "cpu":
            return _bind_phase(self.step.cw, carry, slice_pod(xs1, 0),
                               torch.tensor(int(selected), dtype=torch.int32))
        from ..kernels.spec import spec_commit_bind

        sel = torch.tensor([int(selected)], dtype=torch.int32, device=dev)
        return spec_commit_bind(self.step, carry, xs1, sel, 1)


def build_phased(cw) -> Phased:
    """pipeline.py:446: the phased step of one compiled workload (see
    Phased)."""
    return Phased(cw)


def _stack(rows: list) -> torch.Tensor:
    """torch.stack; uint16 (the p16 pack) goes through int32 because
    PyTorch gives that type little more than conversions on every
    device."""
    if rows[0].dtype == torch.uint16:
        return torch.stack([r.to(torch.int32) for r in rows]).to(torch.uint16)
    return torch.stack(rows)


def _map_tree(fn, tree):
    """Apply fn to every tensor of a dict of tensors / NamedTuples of
    tensors (Python-int fields pass through)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, torch.Tensor):
            out[k] = fn(v)
        else:
            out[k] = type(v)(*[fn(a) if isinstance(a, torch.Tensor) else a
                               for a in v])
    return out


def slice_pod(xs_chunk: dict[str, Any], i: int) -> dict[str, Any]:
    """Pod i of a chunk of per-pod xs."""
    return _map_tree(lambda a: a[i], xs_chunk)
