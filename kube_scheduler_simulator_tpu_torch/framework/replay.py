"""Chunked replay of a pod queue.

Port of kube_scheduler_simulator_tpu/framework/replay.py: `ReplayResult`
(:414-607), `_CompactChunks` (:106), `_slice_xs` (:893), the chunk loop of
`_replay_run` (:1479, the carry copied at :1490, `is_pad` on the padded
tail), the raw-width ladder of `replay` (:1420-1429) and `_compact_plan`
(:1432).  Each chunk goes through `Step.scan` (framework/pipeline.py):
one launch of the step kernel on the card, a loop of the plain step on
the CPU.

Every chunk's CompactOut is fetched to the host as it completes — the JAX
package's host-resident rung (KSS_TPU_HOST_RESIDENT=1, bit-identical to
its default, replay.py:1346-1363).  Device-resident retention and its
budget, on-device attribution, meshes, fault points and tracing are later
slices.

The last chunk is padded; padded steps carry `is_pad` and never bind.
"""

from __future__ import annotations

import threading
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from .pipeline import PACK_MODES, build_step, choose_pack_mode
from ..state.compile import CompiledWorkload


class _CompactChunks:
    """Per-chunk CompactOut arrays, host numpy (C order)."""

    GROUPS = ("packed", "raw8", "raw16", "raw32")

    def __init__(self, chunk, pack_mode, score_cols):
        self.packed: list = []    # [C, N]
        self.raw8: list = []      # [C, S8, N] int8
        self.raw16: list = []     # [C, S16, N] int16
        self.raw32: list = []     # [C, S32, N] int32 / int64
        self.chunk = chunk
        self.pack_mode = pack_mode
        self.score_cols = score_cols  # per scorer: ("raw8"|"raw16"|"raw32"|"host", row)

    def host(self, group: str, ci: int) -> np.ndarray:
        return getattr(self, group)[ci]


class ReplayResult:
    """Host-side replay results.

    Two storage layouts:
      * compact (the replay() path): first-fail-packed filters + narrow raw
        scores; full per-pod views are reconstructed chunk-at-a-time on
        demand (finalscore via framework/hostnorm.py);
      * full arrays, passed in directly.

    Use the per-pod accessors (codes_of/raw_of/final_of/feasible_of) —
    they avoid materializing [P, .., N] tensors.  The legacy whole-array
    properties exist for tests and small workloads.

    tiers: the raw-width tiers the replay ran, in order (None, "i32",
    "i64"; each tier runs every chunk once); the last one's outputs are
    the result.
    """

    def __init__(self, cw: CompiledWorkload, filter_codes=None, score_raw=None,
                 score_final=None, selected=None, feasible_count=None,
                 prefilter_reject=None, compact: _CompactChunks | None = None):
        self.cw = cw
        self._filter_codes = filter_codes
        self._score_raw = score_raw
        self._score_final = score_final
        self.selected = selected
        self.feasible_count = feasible_count
        self.prefilter_reject = prefilter_reject
        self._compact = compact
        self._recon_ci = -1
        self._recon: dict[str, np.ndarray] | None = None
        self._recon_lock = threading.Lock()
        self.tiers: tuple = ()

    # ------------------------------------------------------------ summary

    @property
    def scheduled(self) -> int:
        return int((self.selected >= 0).sum())

    def selected_node_name(self, i: int) -> str:
        s = int(self.selected[i])
        return self.cw.node_table.names[s] if s >= 0 else ""

    # ------------------------------------------------------------ access

    def codes_of(self, i: int) -> np.ndarray:
        """[F, N] int32 filter codes for pod i (0 == pass)."""
        if self._filter_codes is not None:
            return self._filter_codes[i]
        d = self._chunk_recon(i // self._compact.chunk)
        return d["codes"][i % self._compact.chunk]

    def raw_of(self, i: int) -> np.ndarray:
        """[S, N] raw scores for pod i."""
        if self._score_raw is not None:
            return self._score_raw[i]
        d = self._chunk_recon(i // self._compact.chunk, scores=True)
        return d["raw"][i % self._compact.chunk]

    def final_of(self, i: int) -> np.ndarray:
        """[S, N] finalscore (normalized x weight) for pod i."""
        if self._score_final is not None:
            return self._score_final[i]
        d = self._chunk_recon(i // self._compact.chunk, scores=True)
        return d["final"][i % self._compact.chunk]

    def feasible_of(self, i: int) -> np.ndarray | None:
        """[N] bool plugin-filter feasibility for pod i, or None when only
        full arrays are stored (the caller derives it from codes_of)."""
        if self._compact is None:
            return None
        d = self._chunk_recon(i // self._compact.chunk)
        return d["feasible"][i % self._compact.chunk]

    def _chunk_recon(self, ci: int, scores: bool = False) -> dict[str, np.ndarray]:
        """Reconstruct one chunk's full views; single-slot cache, safe for
        concurrent readers — a caller evicted mid-read keeps valid
        references to the old arrays.  scores=False skips the raw/final
        assembly."""
        with self._recon_lock:
            return self._chunk_recon_locked(ci, scores)

    def _chunk_recon_locked(self, ci: int, scores: bool) -> dict[str, np.ndarray]:
        d = self._recon if self._recon_ci == ci else None
        if d is not None and (not scores or "raw" in d):
            return d
        from . import hostnorm

        cc = self._compact
        if d is None:
            packed = cc.host("packed", ci)
            c, n = packed.shape
            f = len(self.cw.config.filters())
            _, code_bits, ff_bits = PACK_MODES[cc.pack_mode]
            p_int = packed.astype(np.int64)
            code = p_int & ((1 << code_bits) - 1)
            ffp = (p_int >> code_bits) & ((1 << ff_bits) - 1)  # 0 == all pass
            codes = np.zeros((c, f, n), np.int32)
            if f:
                idx = np.clip(ffp - 1, 0, f - 1)[:, None, :]
                np.put_along_axis(codes, idx, np.where(ffp > 0, code, 0)[:, None, :], axis=1)
            feasible = ffp == 0
            d = {"codes": codes, "feasible": feasible}
            self._recon_ci, self._recon = ci, d
        if scores:
            c, n = d["feasible"].shape
            if "ignored" not in d:  # scores-only cost; codes path skips it
                d["ignored"] = self._tsp_ignored_chunk(ci, c, n)
            raw = np.empty((c, len(cc.score_cols), n), np.int64)
            static_rows = self.cw.host.get("static_score_rows", {})
            sskip = self.cw.host.get("score_skip", {})
            lo = ci * cc.chunk
            for s, (group, row) in enumerate(cc.score_cols):
                if group == "host":
                    # precompiled row, never transferred; mask skipped pods
                    # to 0 exactly as the device output did
                    src = static_rows[row]
                    hi = min(lo + c, src.shape[0])
                    m = hi - lo
                    raw[:, s, :] = 0
                    if m > 0:
                        skip = np.asarray(sskip[row][lo:hi], bool)
                        raw[:m, s, :] = np.where(skip[:, None], 0, src[lo:hi])
                    continue
                raw[:, s, :] = cc.host(group, ci)[:, row, :]
            d["raw"] = raw
            d["final"] = hostnorm.finalize_chunk(
                self.cw, raw, d["feasible"], d["ignored"], ci * cc.chunk)
        return d

    def _tsp_ignored_chunk(self, ci: int, c: int, n: int) -> np.ndarray:
        """PodTopologySpread's score-ignore mask for chunk ci, recomputed
        from STATIC inputs (a node is ignored when it lacks the topology
        key of any of the pod's scored constraints) — dom_idx and the
        per-pod slots never change during a replay, so this never needs to
        travel from the device."""
        tsp = self.cw.host.get("tsp_ignore")
        if tsp is None:
            return np.zeros((c, n), bool)
        dom_neg, c_id, is_score = tsp  # [C, N] bool, [P, MC], [P, MC]
        lo = ci * self._compact.chunk
        hi = min(lo + c, c_id.shape[0])
        out = np.zeros((c, n), bool)
        for m in range(c_id.shape[1]):
            cid = c_id[lo:hi, m]
            scored = is_score[lo:hi, m] & (cid >= 0)
            if not scored.any():
                continue  # slot unused by this chunk: skip the gather
            rows = dom_neg[np.maximum(cid, 0)]       # [hi-lo, N]
            out[: hi - lo] |= scored[:, None] & rows
        return out

    def _materialize(self) -> None:
        """Fill the whole-array caches in ONE pass over the chunks (the
        reconstruction computes every field anyway)."""
        cc = self._compact
        p = self.cw.n_pods
        n = self.cw.n_nodes
        if cc is None or not cc.packed:
            self._filter_codes = np.zeros((0, len(self.cw.config.filters()), n), np.int32)
            self._score_raw = np.zeros((0, len(self.cw.config.scorers()), n), np.int64)
            self._score_final = np.zeros((0, len(self.cw.config.scorers()), n), np.int64)
            return
        pieces = {"codes": [], "raw": [], "final": []}
        for ci in range(len(cc.packed)):
            d = self._chunk_recon(ci, scores=True)
            for k in pieces:
                pieces[k].append(d[k])
        self._filter_codes = np.concatenate(pieces["codes"], axis=0)[:p]
        self._score_raw = np.concatenate(pieces["raw"], axis=0)[:p]
        self._score_final = np.concatenate(pieces["final"], axis=0)[:p]

    # whole-array views (tests / small workloads); raw/final are int64 on
    # the compact path
    @property
    def filter_codes(self) -> np.ndarray:  # [P, F, N]
        if self._filter_codes is None:
            self._materialize()
        return self._filter_codes

    @property
    def score_raw(self) -> np.ndarray:     # [P, S, N]
        if self._score_raw is None:
            self._materialize()
        return self._score_raw

    @property
    def score_final(self) -> np.ndarray:   # [P, S, N]
        if self._score_final is None:
            self._materialize()
        return self._score_final


def _slice_xs(xs: dict[str, Any], lo: int, hi: int, pad_to: int) -> dict[str, Any]:
    """Pods lo..hi of every per-pod tensor, zero-padded to pad_to rows."""
    def cut(a):
        piece = a[lo:hi]
        if pad_to > piece.shape[0]:
            pad = torch.zeros((pad_to - piece.shape[0],) + tuple(piece.shape[1:]),
                              dtype=piece.dtype, device=piece.device)
            piece = torch.cat([piece, pad])
        return piece.contiguous()

    return {k: cut(v) if isinstance(v, torch.Tensor) else type(v)(*[cut(a) for a in v])
            for k, v in xs.items()}


def _clone_carry(carry: dict[str, Any]) -> dict[str, Any]:
    """A private copy of the initial carry: the kernel updates the carry in
    place, and cw.init_carry must survive for later replays of the same
    compiled workload (replay.py:1488-1490, where the scan donates it)."""
    return {k: v.clone() if isinstance(v, torch.Tensor)
            else type(v)(*[a.clone() for a in v]) for k, v in carry.items()}


def _fetch_chunk(out) -> dict[str, np.ndarray]:
    """Blocking copy of one chunk's CompactOut to host numpy, C order."""
    return {f: np.ascontiguousarray(getattr(out, f).cpu().numpy())
            for f in out._fields}


def replay(cw: CompiledWorkload, chunk: int = 512, device="cuda") -> ReplayResult:
    """Run the full queue; returns host-side result arrays.

    device: where the replay runs ("cuda" by default, which needs a card;
    "cpu" runs the plain PyTorch step).  It must be the device `cw` was
    compiled for."""
    device = resolve_device(device)
    if cw.device != device:
        raise ValueError(
            f"workload compiled for {cw.device}, replay asked for {device}")
    # widening ladder: narrow groups -> int32 -> int64 (a raw overflowing
    # its group dtype triggers the next tier; int64 is the upstream score
    # type and cannot overflow).  A compile-time-proven beyond-int32 bound
    # skips straight to i64.
    tiers = (("i64",) if "i64" in cw.host.get("score_dtypes", ())
             else (None, "i32", "i64"))
    for k, wide in enumerate(tiers):
        result = _replay_run(cw, chunk, wide)
        if result is not None:
            result.tiers = tiers[:k + 1]
            return result
    raise AssertionError("unreachable: i64 replay cannot overflow")


def _compact_plan(cw: CompiledWorkload, wide: str | None):
    """(pack_mode, score_dtypes, score_cols) for this workload."""
    pack_mode = choose_pack_mode(
        cw.host.get("max_filter_code", 1 << 62),
        len(cw.config.filters()),
    )
    score_dtypes = cw.host.get(
        "score_dtypes", tuple("i16" for _ in cw.config.scorers()))
    counts = {"i8": 0, "i16": 0, "i32": 0}
    cols = []
    for name, g in zip(cw.config.scorers(), score_dtypes):
        if g == "host":
            # precompiled host-resident raw (cw.host["static_score_rows"]):
            # reconstructed from the host copy, never fetched
            cols.append(("host", name))
            continue
        g = "i32" if wide else g  # widened runs pool every scorer in raw32
        cols.append(({"i8": "raw8", "i16": "raw16", "i32": "raw32"}[g], counts[g]))
        counts[g] += 1
    return pack_mode, score_dtypes, tuple(cols)


def _replay_run(cw: CompiledWorkload, chunk: int,
                wide: str | None) -> ReplayResult | None:
    """One tier of the ladder: every chunk runs; None when a raw overflowed
    its group dtype (the caller reruns at the next tier)."""
    p = cw.n_pods
    chunk = min(chunk, max(p, 1))
    pack_mode, score_dtypes, score_cols = _compact_plan(cw, wide)
    step = build_step(cw, out_mode="compact", pack_mode=pack_mode,
                      score_dtypes=score_dtypes, wide_raw=wide)
    carry = _clone_carry(cw.init_carry)
    compact = _CompactChunks(chunk=chunk, pack_mode=pack_mode,
                             score_cols=score_cols)
    selected = np.full(p, -1, dtype=np.int32)
    feasible_count = np.zeros(p, dtype=np.int32)
    prefilter_reject = np.zeros(p, dtype=np.int32)
    check_overflow = wide != "i64"
    overflow = False
    for lo in range(0, p, chunk):
        hi = min(lo + chunk, p)
        xs_chunk = _slice_xs(cw.xs, lo, hi, chunk)
        xs_chunk["is_pad"] = torch.arange(chunk, device=cw.device) >= (hi - lo)
        carry, out = step.scan(carry, xs_chunk)
        c = _fetch_chunk(out)
        if check_overflow and c["raw_overflow"].any():
            overflow = True
        if overflow:
            continue  # this tier's results are dropped; the tier still runs out
        compact.packed.append(c["packed_filter"])
        compact.raw8.append(c["raw8"])
        compact.raw16.append(c["raw16"])
        compact.raw32.append(c["raw32"])
        m = hi - lo
        selected[lo:hi] = c["selected"][:m]
        feasible_count[lo:hi] = c["feasible_count"][:m]
        prefilter_reject[lo:hi] = c["prefilter_reject"][:m]
    if overflow:
        return None
    return ReplayResult(
        cw=cw, selected=selected, feasible_count=feasible_count,
        prefilter_reject=prefilter_reject, compact=compact,
    )
