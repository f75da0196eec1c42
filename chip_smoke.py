#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kube_scheduler_simulator_tpu_torch)
on one NVIDIA card.

    python3 chip_smoke.py

It drives the port's main path — BASELINE config 5 (10,000 pods x 5,000
nodes, six plugins) from manifests through compile_workload, the chunked
replay on the card and the annotation decode — builds the step kernel
from csrc/, holds the kernel exactly equal to its plain PyTorch version,
times both with CUDA events, and prints one line per phase.  The line
before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}.  Any failure exits non-zero; without a card
it exits 1 before printing a result.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG, SEED, CHUNK = 5, 0, 512
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
FP64_FLOPS = 34e12             # H100 SXM float64 outside the tensor cores (data sheet)
DECODE_CHECK_PODS = (0, 1, 511, 512, 1023)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def _nbytes(tree) -> int:
    import torch

    total = 0
    for v in tree.values():
        leaves = [v] if isinstance(v, torch.Tensor) else list(v)
        total += sum(t.numel() * t.element_size() for t in leaves
                     if isinstance(t, torch.Tensor))
    return total


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import (
        ReplayResult, _CompactChunks, _clone_carry, _compact_plan, _slice_xs, replay)
    from kube_scheduler_simulator_tpu_torch.kernels import build
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
    from kube_scheduler_simulator_tpu_torch.models import baseline_config
    from kube_scheduler_simulator_tpu_torch.state import compile_workload
    from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result

    dev = torch.device("cuda", 0)

    # ---- 1. the device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0] if smi else "unknown"
    print(card, flush=True)  # the card's name and power limit, as nvidia-smi gives them
    print(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
          f"| devices {torch.cuda.device_count()}", flush=True)

    # ---- 2. the build
    res = build.build()
    build.load()
    ptxas = " ".join(ln.strip() for ln in res.log.splitlines()
                     if "registers" in ln or "spill" in ln)
    print(f"[2 build] {res.path.name} compiled={res.compiled} seconds={res.seconds:.2f} "
          f"| {ptxas}", flush=True)

    # the main path's workload, compiled once (timed for phase 4)
    nodes, pods, cfg = baseline_config(CONFIG, scale=1.0, seed=SEED)
    t0 = time.perf_counter()
    cw = compile_workload(nodes, pods, cfg, device=dev)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    p, n = cw.n_pods, cw.n_nodes
    g = cw.statics["PodTopologySpread"].dom_idx.shape[0]
    t = cw.statics["InterPodAffinity"].dom_idx.shape[0]
    r = cw.schema.n

    def chunk_xs(lo: int) -> dict:
        hi = min(lo + CHUNK, p)
        xs = _slice_xs(cw.xs, lo, hi, CHUNK)
        xs["is_pad"] = torch.arange(CHUNK, device=dev) >= (hi - lo)
        return xs

    # ---- 3. kernel vs plain on the card, per plugin row, full outputs
    step_full = build_step(cw, out_mode="full")
    xs0 = chunk_xs(0)
    ck, ok_ = kstep.step_chunk(step_full, _clone_carry(cw.init_carry), xs0)
    cp, op_ = step_full.plain_scan(_clone_carry(cw.init_carry), xs0)
    torch.cuda.synchronize()
    max_err = 0
    rows = []
    for field, names in (("filter_codes", step_full.filter_names),
                         ("score_raw", step_full.score_names),
                         ("score_final", step_full.score_names)):
        a, b = getattr(ok_, field), getattr(op_, field)
        for k, name in enumerate(names):
            err = int((a[:, k].long() - b[:, k].long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"{field}[{name}] differs from the plain step (max |d| {err})")
            rows.append(f"{field}[{name}]")
    for field in ("selected", "feasible_count", "prefilter_reject"):
        err = int((getattr(ok_, field).long() - getattr(op_, field).long()).abs().max())
        max_err = max(max_err, err)
        check(err == 0, f"{field} differs from the plain step")
    for key in ck:
        a_leaves = [ck[key]] if isinstance(ck[key], torch.Tensor) else list(ck[key])
        b_leaves = [cp[key]] if isinstance(cp[key], torch.Tensor) else list(cp[key])
        for a, b in zip(a_leaves, b_leaves):
            err = int((a.long() - b.long()).abs().max()) if a.numel() else 0
            max_err = max(max_err, err)
            check(err == 0, f"carry {key} differs from the plain step")
    print(f"[3 kernel==plain] config {CONFIG} chunk {CHUNK}x{n}: {len(rows)} plugin rows, "
          f"selected, feasible_count and the carry equal; max_abs_err {max_err}; "
          f"scheduled in chunk {int((ok_.selected >= 0).sum())}", flush=True)
    del ok_, op_, ck, cp

    # ---- 4. the main path
    kstep.step_chunk.launches = 0
    t0 = time.perf_counter()
    rr = replay(cw, chunk=CHUNK, device="cuda")
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = kstep.step_chunk.launches
    n_chunks = math.ceil(p / CHUNK)
    check(launches > 0, "the main path launched no kernel")
    check(launches == n_chunks * len(rr.tiers),
          f"launches {launches} != chunks {n_chunks} x tiers {len(rr.tiers)}")
    check(len(rr.selected) == p and rr.selected.min() >= -1 and rr.selected.max() < n,
          "selected out of range")

    # device-only: the same chunk loop at the tier the replay ended on,
    # no fetch, each launch between CUDA events
    wide = rr.tiers[-1]
    pack_mode, score_dtypes, _ = _compact_plan(cw, wide)
    step_c = build_step(cw, out_mode="compact", pack_mode=pack_mode,
                        score_dtypes=score_dtypes, wide_raw=wide)
    carry = _clone_carry(cw.init_carry)
    chunk_inputs = [chunk_xs(lo) for lo in range(0, p, CHUNK)]
    events = []
    for xs in chunk_inputs:
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        carry, out = step_c.scan(carry, xs)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize()
    chunk_ms = [e0.elapsed_time(e1) for e0, e1 in events]
    device_s = sum(chunk_ms) / 1e3
    print(f"[4 main path] config {CONFIG}: {p} pods x {n} nodes (R={r}, G={g}, T={t}); "
          f"scheduled {rr.scheduled}; compile {compile_s:.3f} s; replay device-only "
          f"{device_s:.4f} s, with host fetch {replay_s:.4f} s; "
          f"{p / replay_s:.1f} cycles/s; launches {launches} = {n_chunks} chunks x "
          f"{len(rr.tiers)} tier(s) {list(rr.tiers)}", flush=True)

    # plain replay of the first two chunks on the card, held to the kernel's
    plain_chunks = _CompactChunks(chunk=CHUNK, pack_mode=pack_mode,
                                  score_cols=rr._compact.score_cols)
    sel = rr.selected.copy()
    feas = rr.feasible_count.copy()
    carry = _clone_carry(cw.init_carry)
    for ci in range(2):
        carry, out = step_c.plain_scan(carry, chunk_inputs[ci])
        host = {f: getattr(out, f).cpu().numpy() for f in out._fields}
        for grp, fld in (("packed", "packed_filter"), ("raw8", "raw8"),
                         ("raw16", "raw16"), ("raw32", "raw32")):
            check((rr._compact.host(grp, ci) == host[fld]).all(),
                  f"chunk {ci}: compact {fld} differs from the plain replay")
            getattr(plain_chunks, grp).append(host[fld])
        lo = ci * CHUNK
        check((host["selected"] == rr.selected[lo:lo + CHUNK]).all(),
              f"chunk {ci}: selected differs from the plain replay")
        check((host["feasible_count"] == rr.feasible_count[lo:lo + CHUNK]).all(),
              f"chunk {ci}: feasible_count differs from the plain replay")
        sel[lo:lo + CHUNK] = host["selected"]
        feas[lo:lo + CHUNK] = host["feasible_count"]
    rr_plain = ReplayResult(cw=cw, selected=sel, feasible_count=feas,
                            prefilter_reject=rr.prefilter_reject.copy(),
                            compact=plain_chunks)
    for i in DECODE_CHECK_PODS:
        check(decode_pod_result(rr, i) == decode_pod_result(rr_plain, i),
              f"pod {i}: annotations differ between the kernel and the plain replay")
    sample = sorted(set(range(0, p, p // 8)) | {p - 1})
    # decode time on the host: each sampled pod after the first lies in
    # another chunk than the pod decoded before it, so it also pays for
    # rebuilding its chunk's full views
    t0 = time.perf_counter()
    anns = [decode_pod_result(rr, i) for i in sample]
    decode_ms = (time.perf_counter() - t0) * 1e3 / len(sample)
    for i, ann in zip(sample, anns):
        check(sorted(ann) == sorted(ALL_PLUGIN_KEYS), f"pod {i}: annotation keys")
        check(all(isinstance(v, str) for v in ann.values()), f"pod {i}: annotation values")
        want = cw.node_table.names[rr.selected[i]] if rr.selected[i] >= 0 else ""
        check(ann["kube-scheduler-simulator.sigs.k8s.io/selected-node"] == want,
              f"pod {i}: selected-node annotation")
    print(f"[4 main path] plain replay of chunks 0-1 equal (selected, feasible_count, "
          f"compact outputs); decode bytes equal for pods {list(DECODE_CHECK_PODS)}; "
          f"13 keys on pods {sample}; decode_pod_result {decode_ms:.3f} ms/pod (host, "
          f"mean over those {len(sample)} pods)", flush=True)

    # ---- 5. timing: the kernel per chunk and the plain step, CUDA events.
    # The kernel's launches run back to back, each on a fresh copy of the
    # initial carry, after one untimed launch: each event then fires when
    # the previous kernel ends, and the host's preparation of the next
    # launch overlaps the kernel before it, so the times are device time.
    reps = 3
    carries = [_clone_carry(cw.init_carry) for _ in range(reps + 1)]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    step_c.scan(carries[0], chunk_inputs[0])
    marks[0].record()
    for k in range(reps):
        step_c.scan(carries[k + 1], chunk_inputs[0])
        marks[k + 1].record()
    torch.cuda.synchronize()
    ts = [marks[k].elapsed_time(marks[k + 1]) for k in range(reps)]
    del carries
    kernel_ms = sorted(ts)[len(ts) // 2]
    carry = _clone_carry(cw.init_carry)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    step_c.plain_scan(carry, chunk_inputs[0])
    e1.record()
    torch.cuda.synchronize()
    plain_ms = e0.elapsed_time(e1)

    # least time for the same work (chunk 0): every input read once (the
    # statics, the carry, the chunk's xs) and every output written once
    # (the carry and the compact outputs); against it, the float64
    # operations at the card's float64 rate — about 22 per pod and node
    # (balanced allocation 9, the spread sum over two scored slots 8, the
    # InterPod normalization 5); integer work is not counted
    outs0 = kstep.alloc_outputs(step_c, CHUNK, dev)
    out_bytes = sum(outs0[f].numel() * outs0[f].element_size()
                    for f in ("packed_filter", "raw8", "raw16", "raw32", "raw_overflow",
                              "selected", "feasible_count", "prefilter_reject"))
    carry_bytes = _nbytes(cw.init_carry)
    move_bytes = _nbytes(cw.statics) + 2 * carry_bytes + _nbytes(chunk_inputs[0]) + out_bytes
    f64_ops = CHUNK * n * 22
    bytes_ms = move_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = f64_ops / FP64_FLOPS * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    # the bytes one pod touches (node-axis state rows + its own rows +
    # its compact outputs), over the whole queue
    pod_bytes = (n * (2 * r + 4) * 8 + n * 5 + n * 4 + n + g * n * 8 + t * n * 4 * 6
                 + out_bytes // CHUNK)
    queue_bound_ms = pod_bytes * p / HBM_BYTES_PER_S * 1e3
    print(f"[5 timing] {card}: step_chunk {kernel_ms:.3f} ms/chunk (median of {reps}; "
          f"queue mean {sum(chunk_ms) / len(chunk_ms):.3f} ms/chunk); plain step "
          f"{plain_ms:.3f} ms/chunk = {plain_ms / CHUNK:.4f} ms/pod; bound {bound_ms:.5f} "
          f"ms/chunk by {bound_by} ({move_bytes} B); per-pod touch bound "
          f"{pod_bytes} B/pod -> {queue_bound_ms:.3f} ms/queue", flush=True)

    print(json.dumps({"kernels": [{
        "name": "step_chunk",
        "route": "cuda",
        "source": "kube_scheduler_simulator_tpu_torch/csrc/step.cu",
        "replaces": "kube_scheduler_simulator_tpu/framework/pipeline.py:378",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
