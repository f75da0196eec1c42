#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kube_scheduler_simulator_tpu_torch)
on one NVIDIA card.

    python3 chip_smoke.py

It builds every kernel of the port from csrc/ (one nvcc per source, all
at once) and drives the port's paths on the card, printing one line per
phase:

  1-5  the chunked replay: BASELINE config 5 (10,000 pods x 5,000 nodes,
       six plugins) from manifests through compile_workload, the step
       kernel held exactly equal to its plain PyTorch version, the replay
       and the annotation decode, and the kernel's times;
  6    the speculative wave's kernels (spec_round, spec_oracle, spec_eval,
       spec_commit_core, spec_commit_bind, grid_append, grid_emit, and
       spec_oracle with B5's core commit folded in) held exactly equal to
       their plain versions at full width;
  7    low contention, the wave's main path: the slot-pinned fleet
       (10,000 pods x 5,000 nodes) through replay_speculative_stream,
       equal to the scan of the same workload, every round's commit in
       its oracle launch; the same stream as a gang wave, its commits
       through spec_commit_core;
  8    contended: config 5 through the stream (it falls back to the
       scan), and replay_speculative with no fallback on 1,024 pods x
       5,000 nodes, each equal to its scan;
  9    the wave's kernels' times, their plain versions' and the library
       calls', and their bounds;
  10-13 the scheduler's default profile (B9 fused into the kernels): each
       plugin row against the plain step, the default-profile fleet's
       replay, the SAFE-set stream, each B9 group's share of a launch;
  14   B7 (chunk_attribution) held exactly equal to its plain version on
       chunk 0 of config 5, of the default-profile fleet, of a p64 chunk
       and of an i64-tier chunk, in the plan's shape and each forced (W
       warps a pod, P pods a CTA), with its times, bound and the bytes
       its 32-byte sectors move;
  15   the default result path: config 5 through replay(cw) with default
       arguments (device-resident, B7 on every chunk) against phase 4's
       host-resident replay, again under a 64 MB retention budget, and the
       default-profile fleet against phase 11;
  16   the native annotation codec: the first and last chunk of both
       fleets through decode_release_batches, sampled pods against the
       Python encoder;
  17   the slot-pinned and SAFE-set streams with device_resident=True
       against phases 7 and 12;
  18   B8 (quorum_slice) on a 10,000-pod slice of 1,250 groups, on one
       scattered over 1,250 and over 100,000 groups (past shared memory),
       at the plan's path and each forced one, its page-locked copies and
       its numpy-to-numpy call, and B10 (phased_eval, renormalize_rows) on
       config 5's 5,000 nodes, each held exactly equal to its plain
       version, with times and bounds;
  19   the scheduling engine: config 5 created in an ObjectStore and
       scheduled by SchedulerEngine.schedule_pending() at its default
       wave and rung, then under KSS_TPU_SPECULATIVE=0, every pod's node
       equal to phase 4's replay() and sampled annotations read from the
       store equal to its decode;
  20   gangs at full width: 2,000 PodGroup members on the 5,000 nodes
       (groups that reach quorum, park, or fail the Coscheduling
       PreFilter) through the engine, B8 in every wave, binds
       all-or-nothing and equal across both commit modes and the scan;
  21   the engine's host-interleaved path (B10): 256 config-5 pods with
       a webhook extender on localhost and an AfterScore hook, equal to
       the same run with device="cpu", each pod's rows renormalized in
       one renormalize_rows launch (a launch a flush, at most one a pod);
  22   B11, the cross-session fused round (spec_round_fused and
       spec_eval_fused, the table launches of spec_round's and
       spec_eval's kernels, and spec_oracle_fused): K = 2, 4 and 8 sparse
       rounds on the slot-pinned fleet and K = 2 dense rounds on config
       5, each member held exactly equal to its plain round and to its
       solo launch (also at every forced group and cluster size), the
       oracle's table with folded commits at K = 2 and 4, with the fused
       and the K solo launches' times and bounds;
  23   multi-session serving: four slot-pinned sessions (10,000 pods
       each, one fleet) in a SessionManager(device="cuda") scheduling at
       once, fused against KSS_TPU_FUSE=0 (every pod's node, the bind
       order and the results equal), with the device's idle share; the
       same with PodTopologySpread added (dense rounds); two config-5
       sessions, contended, benched by admission after their first wave;
  24   the HTTP server on localhost: two sessions created and filled
       through POST /api/v1/sessions and .../import (5,000 nodes, 10,000
       pods each), scheduled by their loops, 256 pods of each read back
       and held to a direct replay();
  25   B12, the node-sharded scan: config 5 through replay(cw,
       mesh=make_mesh(S)) for S = 2, 4 and 8 (each "nodes" shard a group
       of the step kernel's CTAs) equal to phase 4, step_chunk_sharded
       at the plan's and each forced group size held to step_chunk (and
       to its plain twin) on chunk 0 and timed against step_chunk in
       turns, and the default-profile fleet's first 1,024 pods on a
       4-shard mesh equal to phase 11, each chunk timed beside
       step_chunk's;
  26   B12 on the stream and the engine: spec_eval_sharded at b = 512
       (dp 1 x nodes 8, dp 2 x nodes 4) held to spec_eval and its plain
       twin; config 5 through replay_speculative_stream on a dp 2 x
       nodes 4 mesh equal to phase 8, through SchedulerEngine on an
       8-shard mesh equal to phase 4 as phase 19 holds itself, its wall
       beside the same engine's without a mesh, and a 4,996-node fleet
       through the engine's unsharded fallback, counted once by
       mesh_fallback_indivisible_nodes_total;
  27   the phase clock: chunk 0 of config 5 and of the default-profile
       fleet through step_chunk's -DKSS_PHASE_CLOCK build, each phase's
       share of the launch;
  28   custom and guest plugins (B13, their rows read in csrc/pod.cuh):
       (a) config 5's plugins plus EvenNodesOnly and HugeScorer (raws
       past 2^33) over 1,024 pods x 5,000 nodes through replay(), chunks
       0-1 held to the plain step and sampled decodes to the plain
       replay's, step_chunk on chunk 0 timed with and without the custom
       plugins; (b) a guest file loaded by SchedulerService with a config
       shaped like examples/scheduler.yaml (the default profile + the
       guest: 13 filters, 9 scorers), 512 pods through
       SchedulerEngine.schedule_pending() against a direct replay();
       (c) a custom NormalizeScore on the engine's host path, phased_eval
       with the rows held to its plain version and the run to
       device="cpu"; (d) (a)'s workload through replay(mesh=make_mesh(8))
       against (a), its chunk 0 timed beside step_chunk's;
  29   the engine over the store's columnar plane: 5,000 nodes from
       make_nodes_columnar and four waves of 2,500 pods from
       make_pods_columnar with config 5's plugins, the node table reused,
       patched (64 node updates) and rebuilt (a node added) between
       waves, under KSS_TPU_COLUMNAR=1 and =0 in turns, every pod's node
       and annotations equal between them, the first wave equal to
       phase 19's engine on the same manifests; each wave's compile split
       (schema, node table, pod requests, each plugin's build, upload),
       its five counters, wall and idle share.

Phases 4, 7, 8, 11 and 12 run the host-resident rung
(KSS_TPU_HOST_RESIDENT=1 or device_resident=False) and time the Python
encoder, so that phases 15-17 compare the default rung and the native
codec against them.

Each path runs with the launch counts set to 0 just before it and read
just after.  The line before the last is the kernel table as JSON; the
last line is {"ok": true, "device": {...}}.  Any failure exits non-zero;
without a card it exits 1 before printing a result.  It imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG, SEED, CHUNK = 5, 0, 512
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (NVIDIA data sheet)
FP64_FLOPS = 34e12             # H100 SXM float64 outside the tensor cores (data sheet)
DECODE_CHECK_PODS = (0, 1, 511, 512, 1023)
# the speculative wave: the JAX package's `make bench-spec` low-contention
# scenario (bench.py:907-1030), and config 5 for the contended one
SLOT_PODS, SLOT_NODES = 10_000, 5_000
SLOT_PLUGINS = ("NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity")
SPEC_BATCH = 512               # the ladder's top rung at chunk 512
KCAND = 128                    # KSS_TPU_SPECULATIVE_CANDIDATES' default
ACCEPT = 37                    # the accept prefix of the general commit's check
GANG_CUT = 6                   # phase 7's gang wave: gangs of 6 pods, cut off 512-pod rounds
FILL = 37                      # an unaligned fill mark for grid_append's check
DIRECT_SCALE = 0.1024          # 1,024 pods x 5,000 nodes for replay_speculative
# phase 20's PodGroups: (family, groups, members, minMember) -> 2,000 pods
GANG_FAMILIES = (("quorum", 200, 8, 8), ("park", 40, 8, 8), ("reject", 20, 4, 8))
HOST_PODS = 256                # phase 21: pods through the host-interleaved path


# the default-profile fleet's decoration (phases 10-12)
GI = 1 << 30
MB = 1 << 20
ZONE_KEY = "topology.kubernetes.io/zone"
CSI_DRIVER = "csi.example.com"
CSI_LIMIT = 4


def decorate_default_profile(nodes: list, pods: list, seed: int,
                             volumes_on: bool = True) -> tuple[dict, list]:
    """Decorate a BASELINE fleet, in place, for the scheduler's default
    profile, from one numpy generator on `seed`: 2 % of nodes
    unschedulable; a catalog of 64 images of 10 MB-2 GB, 6 listed on each
    node, one in 80 % of pods; one hostPort in 30000-30015 in 20 % of pods
    (a quarter UDP, a quarter on a specific hostIP); 0.5 % of pods pinned
    by spec.nodeName.  With volumes_on also: a WaitForFirstConsumer class
    (no provisioner) and 1,500 zone-affine PVs of 1-8 Gi per 10,000 pods,
    in every zone but the last two, one unbound 1-4 Gi claim in 10 % of
    pods; claims bound to zone-labelled
    PVs in 2 %; ReadWriteOncePod claims shared in pairs by 0.5 %; one CSI
    volume of one driver in 5 %, under a CSINode limit of 4 on every node,
    with a tenth of the nodes already at the limit through bound pods; and
    a missing claim in 10 pods per 10,000.  Counts scale with the fleet,
    at least one of each.

    -> (volumes for compile_workload, bound_pods)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n, p = len(nodes), len(pods)
    zones = sorted({nd["metadata"]["labels"].get(ZONE_KEY, "") for nd in nodes})

    def some(frac: float) -> np.ndarray:
        k = min(p, max(1, round(frac * p)))
        return rng.choice(p, size=k, replace=False)

    for j in rng.choice(n, size=max(1, round(0.02 * n)), replace=False):
        nodes[j].setdefault("spec", {})["unschedulable"] = True
    sizes = rng.integers(10 * MB, 2048 * MB, size=64)
    catalog = [f"registry.example/app-{k}:v{k % 3}" for k in range(64)]
    for nd in nodes:
        nd.setdefault("status", {})["images"] = [
            {"names": [catalog[k]], "sizeBytes": int(sizes[k])}
            for k in rng.choice(64, size=6, replace=False)]
    for i in some(0.8):
        pods[i]["spec"]["containers"][0]["image"] = catalog[int(rng.integers(64))]
    for i in some(0.2):
        port = {"containerPort": 8080, "hostPort": int(rng.integers(30000, 30016))}
        if rng.random() < 0.25:
            port["protocol"] = "UDP"
        if rng.random() < 0.25:
            port["hostIP"] = f"10.0.0.{int(rng.integers(1, 4))}"
        pods[i]["spec"]["containers"][0]["ports"] = [port]
    for i in some(0.005):
        pods[i]["spec"]["nodeName"] = nodes[int(rng.integers(n))]["metadata"]["name"]
    if not volumes_on:
        return {}, []

    def claim(pod: dict, name: str) -> None:
        pod["spec"].setdefault("volumes", []).append(
            {"name": f"v-{name}", "persistentVolumeClaim": {"claimName": name}})

    def pvc(name: str, ns: str, sc: str, request: int, modes=("ReadWriteOnce",),
            volume_name: str = "") -> dict:
        spec = {"storageClassName": sc, "accessModes": list(modes),
                "resources": {"requests": {"storage": str(request)}}}
        if volume_name:
            spec["volumeName"] = volume_name
        return {"metadata": {"name": name, "namespace": ns}, "spec": spec}

    def pv(name: str, cap: int, sc: str = "", modes=("ReadWriteOnce",), labels=None,
           zone: str | None = None, claim_ref: tuple | None = None, csi=None) -> dict:
        spec = {"capacity": {"storage": str(cap)}, "accessModes": list(modes),
                "storageClassName": sc}
        if zone is not None:
            spec["nodeAffinity"] = {"required": {"nodeSelectorTerms": [{"matchExpressions": [
                {"key": ZONE_KEY, "operator": "In", "values": [zone]}]}]}}
        if claim_ref is not None:
            spec["claimRef"] = {"namespace": claim_ref[0], "name": claim_ref[1]}
        if csi is not None:
            spec["csi"] = csi
        return {"metadata": {"name": name, "labels": labels or {}}, "spec": spec}

    scs = [{"metadata": {"name": "wffc"}, "provisioner": "kubernetes.io/no-provisioner",
            "volumeBindingMode": "WaitForFirstConsumer"}]
    pvcs, pvs = [], []
    # local PVs in all zones but the last two: there a claim finds none
    local_zones = zones[:max(1, len(zones) - 2)]
    for k in range(max(1, round(0.15 * p))):
        pvs.append(pv(f"pv-local-{k}", int(rng.integers(1, 9)) * GI, sc="wffc",
                      zone=local_zones[int(rng.integers(len(local_zones)))]))
    order = rng.permutation(p)
    counts = [max(1, round(f * p)) for f in (0.10, 0.02, 0.005, 0.05, 0.001)]
    counts[2] = max(2, counts[2] - counts[2] % 2)  # ReadWriteOncePod pairs
    cuts = np.cumsum(counts)
    unbound, zoned, rwop, csi, missing = np.split(order[:cuts[-1]], cuts[:-1])
    for i in unbound:
        ns = pods[i]["metadata"].get("namespace") or "default"
        pvcs.append(pvc(f"claim-{i}", ns, "wffc", int(rng.integers(1, 5)) * GI))
        claim(pods[i], f"claim-{i}")
    for i in zoned:
        ns = pods[i]["metadata"].get("namespace") or "default"
        zone = zones[int(rng.integers(len(zones)))]
        pvs.append(pv(f"pv-zoned-{i}", 10 * GI, labels={ZONE_KEY: zone},
                      claim_ref=(ns, f"zoned-{i}")))
        pvcs.append(pvc(f"zoned-{i}", ns, "", 10 * GI, volume_name=f"pv-zoned-{i}"))
        claim(pods[i], f"zoned-{i}")
    for k in range(0, len(rwop), 2):
        # the pair shares one claim, in the first pod's namespace (every
        # BASELINE pod is in "default")
        ns = pods[rwop[k]]["metadata"].get("namespace") or "default"
        modes = ("ReadWriteOncePod",)
        pvs.append(pv(f"pv-rwop-{k}", GI, modes=modes, claim_ref=(ns, f"rwop-{k}")))
        pvcs.append(pvc(f"rwop-{k}", ns, "", GI, modes=modes, volume_name=f"pv-rwop-{k}"))
        for i in rwop[k:k + 2]:
            claim(pods[i], f"rwop-{k}")
    for i in csi:
        ns = pods[i]["metadata"].get("namespace") or "default"
        pvs.append(pv(f"pv-csi-{i}", GI, claim_ref=(ns, f"csi-{i}"),
                      csi={"driver": CSI_DRIVER, "volumeHandle": f"h-{i}"}))
        pvcs.append(pvc(f"csi-{i}", ns, "", GI, volume_name=f"pv-csi-{i}"))
        claim(pods[i], f"csi-{i}")
    for i in missing:
        claim(pods[i], f"missing-{i}")
    csinodes = [{"metadata": {"name": nd["metadata"]["name"]},
                 "spec": {"drivers": [{"name": CSI_DRIVER, "allocatable": {"count": CSI_LIMIT}}]}}
                for nd in nodes]
    # a tenth of the nodes already hold CSI_LIMIT volumes of the driver
    bound = []
    for j in rng.choice(n, size=max(1, n // 10), replace=False):
        name = nodes[j]["metadata"]["name"]
        filler = {"metadata": {"name": f"csi-filler-{j}", "namespace": "kube-system"},
                  "spec": {"nodeName": name, "containers": [{"name": "c", "image": "filler:v1",
                           "resources": {"requests": {"cpu": "10m"}}}]},
                  "status": {"phase": "Running"}}
        for v in range(CSI_LIMIT):
            key = f"filler-{j}-{v}"
            pvs.append(pv(f"pv-{key}", GI, claim_ref=("kube-system", key),
                          csi={"driver": CSI_DRIVER, "volumeHandle": f"h-{key}"}))
            pvcs.append(pvc(key, "kube-system", "", GI, volume_name=f"pv-{key}"))
            claim(filler, key)
        bound.append((filler, name))
    return {"pvcs": pvcs, "pvs": pvs, "storageclasses": scs, "csinodes": csinodes}, bound


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


@contextlib.contextmanager
def env(**values):
    """The environment variables set (None: unset) for the block."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _nbytes(tree) -> int:
    import torch

    total = 0
    for v in tree.values():
        leaves = [v] if isinstance(v, torch.Tensor) else list(v)
        total += sum(t.numel() * t.element_size() for t in leaves
                     if isinstance(t, torch.Tensor))
    return total


def eval_bytes(cw, carry, xs, out_bytes: int) -> int:
    """The bytes an evaluation of the batch xs against carry must move:
    the rows it reads, each once, and `out_bytes` of outputs.  Read in
    full: the node-axis core columns (statics and carry) and the batch's
    own xs (its taint rows and spread eligibility are [N] a pod).  Read in
    part, the union over the batch: NodeAffinity's required and preferred
    rows (by req_idx / pref_idx, unless skipped), PodTopologySpread's
    dom_idx and count rows of the constraints the pods' slots name, and
    InterPodAffinity's dom_idx and carry rows of the terms their flags
    touch (pod.cuh, interpod.cuh, spread.cuh).  Config 5's plugins only;
    another plugin raises."""
    n = cw.n_nodes
    unknown = (set(cw.statics) | set(carry)) - {
        "core", "NodeAffinity", "PodTopologySpread", "InterPodAffinity"}
    if unknown:
        raise ValueError(f"eval_bytes: no row count for {sorted(unknown)}")
    total = _nbytes({"s": cw.statics["core"], "c": carry["core"]}) + _nbytes(xs)
    pods = range(xs["is_pad"].shape[0])
    if "NodeAffinity" in cw.statics:
        st, x = cw.statics["NodeAffinity"], xs["NodeAffinity"]
        req = {int(x.req_idx[i]) for i in pods if not bool(x.filter_skip[i])}
        pref = {int(x.pref_idx[i]) for i in pods if not bool(x.score_skip[i])}
        total += n * (len(req) * st.req_rows.element_size()
                      + len(pref) * st.pref_rows.element_size())
    if "PodTopologySpread" in cw.statics:
        x = xs["PodTopologySpread"]
        cids = set()
        for i in pods:
            for m, cid in enumerate(x.c_id[i].tolist()):
                used = ((bool(x.is_filter[i, m]) and not bool(x.filter_skip[i]))
                        or (bool(x.is_score[i, m]) and not bool(x.score_skip[i])))
                if cid >= 0 and used:
                    cids.add(cid)
        total += len(cids) * n * 4 * 2  # dom_idx row + count row, int32
    if "InterPodAffinity" in cw.statics:
        x, ic = xs["InterPodAffinity"], carry["InterPodAffinity"]
        rows, totals = set(), set()
        for i in pods:
            filt = not bool(x.filter_skip[i])
            aff, anti = x.h_req_aff[i].tolist(), x.h_req_anti[i].tolist()
            coef = (x.h_pref_aff_w[i] - x.h_pref_anti_w[i]).tolist()
            for t, tm in enumerate(x.t_matches[i].tolist()):
                if filt and aff[t] > 0:
                    rows |= {(t, "dom_idx"), (t, "matched")}
                    totals.add(t)  # matched_total[t]
                if filt and anti[t] > 0:
                    rows.add((t, "matched"))
                if filt and tm:
                    rows.add((t, "have_req_anti"))
                if coef[t] != 0:
                    rows.add((t, "matched"))
                if tm:
                    rows |= {(t, "sym_pref_aff"), (t, "sym_pref_anti"), (t, "have_req_aff")}
        total += len(rows) * n * ic.matched.element_size() + 4 * len(totals)
    return total + out_bytes


def phased_eval_bytes(cw, carry, xs1) -> int:
    """The bytes one pod's phased_eval must move: eval_bytes of the pod
    with the uncompacted StepOut it writes."""
    f_, s_ = len(cw.config.filters()), len(cw.config.scorers())
    return eval_bytes(cw, carry, xs1, (f_ + 2 * s_) * cw.n_nodes * 4 + 3 * 4)


def bound(nbytes: int, f64_ops: int = 0) -> tuple[float, str]:
    """The least time for the work: the bytes over the card's memory rate
    or the float64 operations over its float64 rate, the larger."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = f64_ops / FP64_FLOPS * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def timed(fn, reps: int) -> float:
    """ms per call of fn: `reps` calls back to back between two CUDA events,
    after one untimed call.  The host's preparation of a launch overlaps
    the kernel before it, so for a kernel longer than that preparation
    this is device time; for a shorter one it is the wrapper's host cost."""
    import torch

    fn()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def timed_graph(fn, reps: int) -> float:
    """Device ms per call of fn: `reps` calls captured once in a CUDA graph,
    the graph replayed once untimed and once between two CUDA events, so
    no host work is inside the window."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    graph.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def timed_once(fn) -> float:
    """ms of one call of fn between two CUDA events (the plain versions)."""
    import torch

    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1)


def _leaves(x):
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []  # a Python scalar of a NamedTuple


def tree_err(got, want) -> int:
    """max |got - want| over the tensors of two equal trees; a dtype or
    shape mismatch fails the run."""
    err = 0
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        check(a.dtype == b.dtype and a.shape == b.shape,
              f"{a.dtype} {tuple(a.shape)} vs {b.dtype} {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def same_replay(a, b, what: str, sample) -> None:
    """Equal results: selections, feasible counts, decode bytes of the
    sampled pods, and every compact chunk's bytes over the queue's
    pods (the last chunk's pad rows are don't-cares), the raw scores
    at feasible nodes.  A raw at an infeasible node is a don't-care
    of the compact layout, which never reads it, and the wave's differ
    from the scan's there: a sparse round leaves 0 off its
    candidates, and a round evaluates its pods against the carry of
    the round's start, whose later binds land only on nodes the
    accepted pods cannot use (speculative.py's exactness argument)."""
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.store import decode_pod_result

    check((a.selected == b.selected).all(), f"{what}: selected")
    check((a.feasible_count == b.feasible_count).all(), f"{what}: feasible_count")
    check((a.prefilter_reject == b.prefilter_reject).all(), f"{what}: prefilter_reject")
    for grp in ("packed", "raw8", "raw16", "raw32"):
        check(len(getattr(a._compact, grp)) == len(getattr(b._compact, grp)),
              f"{what}: {grp} chunk count")
        for ci in range(len(getattr(a._compact, grp))):
            real = min(CHUNK, a.cw.n_pods - ci * CHUNK)
            x, y = a._compact.host(grp, ci)[:real], b._compact.host(grp, ci)[:real]
            if grp != "packed":
                feas = (a._compact.host("packed", ci)[:real] == 0)[:, None, :]
                x, y = np.where(feas, x, 0), np.where(feas, y, 0)
            check(x.dtype == y.dtype and x.tobytes() == y.tobytes(),
                  f"{what}: compact {grp} chunk {ci} bytes")
    for i in sample:
        check(decode_pod_result(a, i) == decode_pod_result(b, i),
              f"{what}: pod {i} annotations")


LADDER = (8, 32, 128, 512)      # the speculative ladder's rungs at chunk 512 (_batch_ladder)
EVAL_SHARDS = (1, 2, 4, 8, 16)  # the cluster sizes the eval kernel takes (kernels/spec.py)
ORACLE_BATCHES = (8, 512)       # spec_oracle's batches timed beside each other
DIRECT_RUNS = 3                 # the ladder mode's direct replays
# synthetic oracle batches (oracle_batch): no conflict, a conflict at k =
# 1, one only at k = B - 1 (the one-block walk's worst case), every row
# PreFilter-rejected, and random feasibility and rejects
ORACLE_KINDS = ("accepted", "first", "last", "rejected", "random")
ORACLE_FUSED_KS = (2, 4, 8)     # the ladder's fused oracle at b = SPEC_BATCH


def oracle_batch(kind: str, b: int, n: int, dtype, seed: int = 0, pads: int = 0,
                 device="cpu") -> tuple:
    """A round's oracle inputs made from `seed` with numpy: packed [b, n]
    of dtype (0 = the pod is feasible at the node; half the words are),
    prefilter_reject [b] and selected [b] (random nodes, the last `pads`
    rows -1 as a round's pad rows) -> (packed, reject, selected) on
    `device`.  `kind` is one of ORACLE_KINDS; "accepted", "first" and
    "last" clear every (k, selected[j]) word with j < k first, then
    "first" sets (1, selected[0]) feasible and "last" (B - 1,
    selected[j]) for one j < B - 1 that is not a pad."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    packed = np.where(rng.random((b, n)) < 0.5, 0, rng.integers(1, 100, (b, n)))
    sel = rng.integers(0, n, b)
    if pads:
        sel[b - pads:] = -1
    reject = np.zeros(b, np.int32)
    if kind in ("accepted", "first", "last"):
        for k in range(1, b):
            cols = sel[:k]
            packed[k, cols[cols >= 0]] = 1
        real = np.flatnonzero(sel[:b - 1] >= 0)
        if kind == "first" and b > 1 and sel[0] >= 0:
            packed[1, sel[0]] = 0
        if kind == "last" and real.size:
            packed[b - 1, sel[rng.choice(real)]] = 0
    elif kind == "rejected":
        reject[:] = 1 + rng.integers(0, 3, b)
    elif kind == "random":
        reject = np.where(rng.random(b) < 0.2, 1, 0).astype(np.int32)
    else:
        raise ValueError(f"oracle_batch: kind {kind!r}, not one of {ORACLE_KINDS}")
    t = torch.from_numpy(packed.astype(np.int64)).to(dtype)
    return (t.to(device), torch.from_numpy(reject).to(device),
            torch.from_numpy(sel.astype(np.int32)).to(device))


def batch_xs(w, lo: int, b: int) -> dict:
    """Pods [lo, lo + b) of workload w as a batch of b, pad rows past the
    queue's end."""
    import torch

    from kube_scheduler_simulator_tpu_torch.framework.replay import _slice_xs

    dev = w.init_carry["core"].requested.device
    hi = min(lo + b, w.n_pods)
    xs = _slice_xs(w.xs, lo, hi, b)
    xs["is_pad"] = torch.arange(b, device=dev) >= (hi - lo)
    return xs


# B5's core folded into the oracle launch: the batches it is held to its
# plain form on (the plain oracle, then commit_plain at k = min(K, m)).
# "accepted": no conflict; "first": a conflict at k = 1; "all_pad": every
# row a pad row (m = 0, selected -1); "k0": real selections, m = 0;
# "wide": a sparse round with a row past its candidate cap (no commit);
# "narrow": one within it
FOLD_KINDS = ("accepted", "first", "all_pad", "k0", "wide", "narrow")
FOLD_BATCHES = (8, 32, 512)
FOLD_TABLE_KS = (2, 4)         # phase 22's table launches of the folded oracle


def fold_case(w, kind: str, b: int, seed: int, dtype=None) -> tuple:
    """One folded-oracle case over workload w (a core-only carry): its
    oracle rows (oracle_batch at w's nodes), its batch's xs (pods [0, b)
    of w) and its Commit without a carry: -> (rows, xs, m, counts,
    kcand).  The counts of "wide" and "narrow" are a sparse round's
    feasible counts, one row past KCAND or none."""
    import torch

    dev = w.init_carry["core"].requested.device
    base = "first" if kind == "first" else "accepted"
    pads = b if kind == "all_pad" else 0
    rows = oracle_batch(base, b, w.n_nodes, dtype or torch.uint8, seed=seed, pads=pads,
                        device=dev)
    m = 0 if kind in ("all_pad", "k0") else b
    counts = None
    if kind in ("wide", "narrow"):
        counts = torch.full((b,), KCAND, dtype=torch.int32, device=dev)
        if kind == "wide":
            counts[b // 2] = KCAND + 1
    return rows, batch_xs(w, 0, b), m, counts, KCAND


def fold_err(kspec, rows, xs, m, counts, kcand, carry, launch) -> tuple[int, int]:
    """launch(rows, commit) -> K, the folded launch on a copy of `carry`,
    against kspec.oracle_commit_plain on another copy: -> (max |d| over K
    and the carry, the plain K)."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry

    want = _clone_carry(carry)
    k_want = kspec.oracle_commit_plain(*rows, kspec.Commit(want, xs, m, counts, kcand))
    got = _clone_carry(carry)
    k_got = launch(rows, kspec.Commit(got, xs, m, counts, kcand))
    return max(tree_err(k_got, k_want), tree_err(got, want)), int(k_want)


def fold_table_err(kspec, kfuse, w, step, k: int, b: int, seed: int, dtype=None,
                   _ctas: int = 0) -> int:
    """spec_oracle_fused over k sessions of workload w at batch b, the
    even ones with a folded commit (FOLD_KINDS in turn), the odd ones
    without, each on its own carry: each session's K and carry against
    the plain oracle then commit_plain (or the plain oracle alone and
    its carry untouched) -> max |d|."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry

    cases = [fold_case(w, FOLD_KINDS[i % len(FOLD_KINDS)], b, seed + i, dtype)
             for i in range(k)]
    base = _clone_carry(w.init_carry)
    got = [_clone_carry(base) for _ in range(k)]
    want = [_clone_carry(base) for _ in range(k)]
    commits = [kspec.Commit(got[i], xs, m, counts, kc) if i % 2 == 0 else None
               for i, (_, xs, m, counts, kc) in enumerate(cases)]
    members = [kfuse.Member(step, got[i], cases[i][1]) for i in range(k)]
    n0 = kfuse.spec_oracle_fused.commits
    ks = kfuse.spec_oracle_fused(members, [c[0] for c in cases], commits=commits, _ctas=_ctas)
    check(kfuse.spec_oracle_fused.commits - n0 == (k + 1) // 2,
          "spec_oracle_fused did not count its sessions' commits")
    err = 0
    for i, (rows, xs, m, counts, kc) in enumerate(cases):
        commit = kspec.Commit(want[i], xs, m, counts, kc) if i % 2 == 0 else None
        k_want = kspec.oracle_commit_plain(*rows, commit)
        err = max(err, tree_err(ks[i], k_want), tree_err(got[i], want[i]))
    return err


def shard_times(fn, call, want, reps: int, param: str = "_shards", sizes=EVAL_SHARDS,
                plan: str = "shards") -> tuple[dict, int]:
    """call(), one launch of the wrapper fn, held to `want` and timed
    (device ms per launch, CUDA graph) at the plan's size (the cluster
    size `fn.shards`, or another attribute `plan`), and at each of `sizes`
    where the wrapper takes a forced one (keyword `param`) -> ({"S": the
    plan's size (None: a wrapper without a plan), "ms", "forced": {size:
    ms}, "best": the fastest forced size, "slow": the plan more than 10 %
    slower than that}, max_abs_err over every size)."""
    import inspect

    err = tree_err(call(), want)
    out = {"S": getattr(fn, plan, None), "ms": timed_graph(call, reps)}
    if param in inspect.signature(fn).parameters:
        forced = {}
        for s in sizes:
            err = max(err, tree_err(call(**{param: s}), want))
            forced[s] = timed_graph(lambda s=s: call(**{param: s}), reps)
        best = min(forced, key=forced.get)
        out.update(forced=forced, best=best, slow=out["ms"] > 1.1 * forced[best])
    check(err == 0, f"{fn.__name__} differs from its reference (max |d| {err})")
    return out, err


def shape_times(fn, call, want, reps: int, plan: str) -> tuple[dict, int]:
    """Where the wrapper fn takes a forced CTA shape (`_light`): the plan's
    G (attribute `plan`) and shape after one call(), and call() in each
    forced shape (at that shape's plan G), held to `want` and timed (CUDA
    graph) -> ({"G", "light", "shape": {"False": ms, "True": ms}} or {}
    for a wrapper without shapes, max_abs_err)."""
    import inspect

    if "_light" not in inspect.signature(fn).parameters:
        return {}, 0
    err = tree_err(call(), want)
    out = {"G": getattr(fn, plan), "light": fn.light, "shape": {}}
    for light in (False, True):
        err = max(err, tree_err(call(_light=light), want))
        out["shape"][str(light)] = timed_graph(lambda lt=light: call(_light=lt), reps)
    check(err == 0, f"{fn.__name__} in a forced CTA shape differs from its reference "
                    f"(max |d| {err})")
    return out, err


def eval_ladder(cw, batches, reps: int = 5) -> tuple[dict, int]:
    """spec_eval on pods [0, b) of cw against its initial carry, for each
    b of `batches`: held to eval_plain and timed at the plan's S and each
    forced S (shard_times) and in each CTA shape (shape_times), with its
    bound; spec_oracle on the outputs where b is in ORACLE_BATCHES
    (oracle_times: held to _oracle_core, timed at the plan's CTAs and each
    forced count) -> ({b: times}, max_abs_err)."""
    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    pm, sd, _ = _compact_plan(cw, None)
    step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
    carry = _clone_carry(cw.init_carry)
    res, err = {}, 0
    for b in batches:
        xs = batch_xs(cw, 0, b)
        want = kspec.eval_plain(step, carry, xs)
        t, e = shard_times(kspec.spec_eval, lambda **kw: kspec.spec_eval(step, carry, xs, **kw),
                           want, reps)
        shapes, e2 = shape_times(kspec.spec_eval,
                                 lambda **kw: kspec.spec_eval(step, carry, xs, **kw), want, reps,
                                 "shards")
        t.update(shapes)
        err = max(err, e, e2)
        t["plain_ms"] = timed_once(lambda: kspec.eval_plain(step, carry, xs)) if b <= 8 else None
        out_bytes = sum(v.numel() * v.element_size() for v in want)
        t["bound"] = bound(eval_bytes(cw, carry, xs, out_bytes), b * cw.n_nodes * 22)
        if b in ORACLE_BATCHES:
            args = (want.packed_filter, want.prefilter_reject, want.selected)
            t["oracle"], e3 = oracle_times(kspec.spec_oracle, args)
            err = max(err, e3)
        res[b] = t
    return res, err


def oracle_bytes(packed, reject, selected) -> int:
    """The bytes the oracle must move for these inputs: the packed words
    (k, selected[j]) of every pair j < k up to the first conflict K (all
    B (B - 1) / 2 pairs where there is none), rows with a PreFilter reject
    left out; the rejects and selections of those rows; K."""
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    b = packed.shape[0]
    last = min(int(kspec._oracle_core(packed, reject, selected, b)), b - 1)
    rows = (reject[1:last + 1] == 0).nonzero().flatten()  # row k at k - 1
    real = (selected[:last] >= 0).long().cumsum(0)        # real j < k at k - 1
    pairs = int(real[rows].sum()) if rows.numel() else 0
    return pairs * packed.element_size() + 8 * (last + 1) + 4


def oracle_times(fn, args, reps: int = 20) -> tuple[dict, int]:
    """spec_oracle (fn) over one session's args (packed, reject,
    selected), held to _oracle_core and timed (CUDA graph) at the plan's
    CTAs and each forced count where the wrapper takes one (shard_times),
    with the bound of the data's bytes -> (times, max_abs_err)."""
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    want = kspec._oracle_core(*args, args[0].shape[0])
    t, err = shard_times(fn, lambda **kw: fn(*args, **kw), want, reps, "_ctas",
                         getattr(kspec, "ORACLE_CTAS", ()), "ctas")
    t["k"] = int(want)
    t["bound"] = bound(oracle_bytes(*args))
    return t, err


def oracle_ladder(cw, reps: int = 20) -> tuple[dict, int]:
    """The oracle on four kinds of batch, each held to _oracle_core and
    timed at the plan's CTAs and each forced count: config 5's dense
    round outputs at b = ORACLE_BATCHES (its first conflict early),
    synthetic batches of b = SPEC_BATCH at config 5's nodes and pack width
    whose only conflict is at k = B - 1 and that have none
    (oracle_batch), and spec_oracle_fused at K = ORACLE_FUSED_KS
    sessions of such batches (plan, forced, and the K solo launches)
    -> ({case: times}, max_abs_err)."""
    import torch

    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    dev = cw.init_carry["core"].requested.device
    pm, sd, _ = _compact_plan(cw, None)
    step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
    carry = _clone_carry(cw.init_carry)
    res, err = {}, 0
    for b in ORACLE_BATCHES:
        ev = kspec.spec_eval(step, carry, batch_xs(cw, 0, b))
        args = (ev.packed_filter.clone(), ev.prefilter_reject.clone(), ev.selected.clone())
        res[f"config{CONFIG} b={b}"], e = oracle_times(kspec.spec_oracle, args, reps)
        err = max(err, e)
    dtype, n = args[0].dtype, cw.n_nodes
    for kind in ("last", "accepted"):
        args = oracle_batch(kind, SPEC_BATCH, n, dtype, seed=SEED, device=dev)
        res[f"{kind} b={SPEC_BATCH}"], e = oracle_times(kspec.spec_oracle, args, reps)
        err = max(err, e)
    xs = batch_xs(cw, 0, SPEC_BATCH)
    for k in ORACLE_FUSED_KS:
        rows = [oracle_batch("last", SPEC_BATCH, n, dtype, seed=SEED + i, device=dev)
                for i in range(k)]
        want = [kspec._oracle_core(*r, SPEC_BATCH) for r in rows]

        def fused(k=k, rows=rows, **kw):
            # members made in the call, so a CUDA graph's capture stream is
            # theirs (a member launches on its own stream)
            return kfuse.spec_oracle_fused([kfuse.Member(step, carry, xs) for _ in range(k)],
                                           rows, **kw)

        t, e = shard_times(kfuse.spec_oracle_fused, fused, want, reps, "_ctas",
                           getattr(kspec, "ORACLE_CTAS", ()), "ctas")
        err = max(err, e)
        t["solo_ms"] = timed_graph(lambda: [kspec.spec_oracle(*r) for r in rows], reps)
        t["bound"] = bound(sum(oracle_bytes(*r) for r in rows))
        res[f"fused K={k} b={SPEC_BATCH}"] = t
    torch.cuda.synchronize()
    return res, err


B5_TABLE_K = 4                 # the ladder's b5 entry: B11's table of K = 4 sessions


def b5_ladder(scw, reps: int = 20) -> tuple[dict, int]:
    """B5's core commit on the slot-pinned fleet at b = SPEC_BATCH, as
    phase 7's rounds give it (each batch a sparse round after the one
    before has committed): the oracle alone (unfolded), spec_commit_core
    alone, the two in a row (the parent's round), and, where the checkout
    has it, the oracle with the commit folded in (with the round's
    feasible counts and candidate cap), held to the plain oracle then
    commit_plain; then the same over B11's table of B5_TABLE_K sessions
    (spec_oracle_fused, and the K cores).  Device ms, CUDA graph ->
    ({case: ms}, max_abs_err)."""
    import torch

    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    folds = hasattr(kspec, "Commit")
    pm, sd, _ = _compact_plan(scw, None)
    step = build_step(scw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
    sessions = []
    for s in range(B5_TABLE_K):
        carry = _clone_carry(scw.init_carry)
        xs0 = batch_xs(scw, 2 * s * SPEC_BATCH, SPEC_BATCH)
        r0 = kspec.spec_round(step, carry, xs0, KCAND)
        kspec.spec_commit(step, carry, xs0, r0[7], SPEC_BATCH)
        xs = batch_xs(scw, (2 * s + 1) * SPEC_BATCH, SPEC_BATCH)
        r = kspec.spec_round(step, carry, xs, KCAND)
        sessions.append((carry, xs, (r[0], r[1], r[7]), r[2]))
    torch.cuda.synchronize()
    carry, xs, rows, counts = sessions[0]
    out, err = {"folds": folds}, 0

    def core(c, x, r):
        return kspec.spec_commit_core(step, c, x, r[2], SPEC_BATCH)

    out["oracle"] = timed_graph(lambda: kspec.spec_oracle(*rows), reps)
    out["core"] = timed_graph(lambda: core(carry, xs, rows), reps)
    out["oracle_then_core"] = timed_graph(lambda: (kspec.spec_oracle(*rows),
                                                   core(carry, xs, rows)), reps)
    if folds:
        e, _ = fold_err(kspec, rows, xs, SPEC_BATCH, counts, KCAND, carry,
                        lambda r, c: kspec.spec_oracle(*r, commit=c))
        err = max(err, e)
        out["folded"] = timed_graph(lambda: kspec.spec_oracle(
            *rows, commit=kspec.Commit(carry, xs, SPEC_BATCH, counts, KCAND)), reps)
    table_rows = [r for _, _, r, _ in sessions]

    def members():
        # made in the call, so a CUDA graph's capture stream is theirs
        return [kfuse.Member(step, c, x) for c, x, _, _ in sessions]

    def cores():
        return [core(c, x, r) for c, x, r, _ in sessions]

    out[f"table K={B5_TABLE_K} oracle"] = timed_graph(
        lambda: kfuse.spec_oracle_fused(members(), table_rows), reps)
    out[f"table K={B5_TABLE_K} cores"] = timed_graph(cores, reps)
    out[f"table K={B5_TABLE_K} oracle_then_cores"] = timed_graph(
        lambda: (kfuse.spec_oracle_fused(members(), table_rows), cores()), reps)
    if folds:
        out[f"table K={B5_TABLE_K} folded"] = timed_graph(lambda: kfuse.spec_oracle_fused(
            members(), table_rows, commits=[kspec.Commit(c, x, SPEC_BATCH, n, KCAND)
                                            for c, x, _, n in sessions]), reps)
        err = max(err, fold_table_err(kspec, kfuse, scw, step, B5_TABLE_K, SPEC_BATCH, SEED,
                                      rows[0].dtype))
    check(err == 0, f"b5: the folded oracle differs from its plain form (max |d| {err})")
    torch.cuda.synchronize()
    return out, err


# the compile's parts the ladder times in any checkout (compile_ladder):
# part -> (module under kube_scheduler_simulator_tpu_torch, attribute)
COMPILE_PARTS = {
    "schema": (("state.resources", "ResourceSchema.discover"),
               ("state.resources", "ResourceSchema.discover_columnar")),
    "node_table": (("state.compile", "build_node_table"),
                   ("state.compile", "build_node_table_columnar"),
                   ("state.compile", "patch_node_table"),
                   ("state.compile", "patch_node_table_columnar")),
    "pod_requests": (("state.compile", "_pod_requests"),),
    "NodeResourcesFit": (("plugins.noderesources", "build_fit"),),
    "NodeAffinity": (("plugins.affinity", "build"),),
    "TaintToleration": (("plugins.taints", "build_taints"),),
    "PodTopologySpread": (("plugins.topologyspread", "build"),
                          ("plugins.topologyspread", "assemble_counts")),
    "InterPodAffinity": (("plugins.interpod", "build"), ("plugins.interpod", "assemble_carry")),
}


def compile_ladder(nodes: list, pods: list, cfg) -> dict:
    """compile_workload's split on phase 19's default wave (config 5 in an
    ObjectStore, SchedulerEngine.schedule_pending()) and on a second wave
    of 16 new pods over the same nodes, in whatever checkout is imported:
    each part of COMPILE_PARTS wrapped in a timer (a part the checkout
    lacks is left out), the compile's total from the engine's
    compile_workload span, and the checkout's own compile.* spans and
    counters where it has them (compile_split).  Seconds."""
    import copy
    import importlib

    import torch

    from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
    from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
    from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

    spent: dict = {}
    running: set = set()  # parts timing now: a part that calls itself counts once
    undo = []
    for part, places in COMPILE_PARTS.items():
        for mod_name, attr in places:
            mod = importlib.import_module(f"kube_scheduler_simulator_tpu_torch.{mod_name}")
            owner, _, name = attr.rpartition(".")
            target = getattr(mod, owner) if owner else mod
            fn = target.__dict__.get(name) if owner else getattr(mod, name, None)
            if fn is None:
                continue
            call = fn.__func__ if isinstance(fn, staticmethod) else fn

            def timed_fn(*a, _call=call, _part=part, **kw):
                if _part in running:  # discover_columnar calls discover
                    return _call(*a, **kw)
                running.add(_part)
                t0 = time.perf_counter()
                try:
                    return _call(*a, **kw)
                finally:
                    running.discard(_part)
                    spent[_part] = spent.get(_part, 0.0) + time.perf_counter() - t0

            setattr(target, name, staticmethod(timed_fn) if isinstance(fn, staticmethod)
                    else timed_fn)
            undo.append((target, name, fn))
    out = {}
    try:
        store = ObjectStore()
        for kind, items in (("nodes", nodes), ("pods", pods)):
            for obj in items:
                store.create(kind, obj)
        engine = SchedulerEngine(store, plugin_config=cfg)
        for label in ("wave 1", "wave 2"):
            if label == "wave 2":
                for q in pods[:16]:
                    q = copy.deepcopy(q)
                    q["metadata"]["name"] += "-again"
                    store.create("pods", q)
            spent.clear()
            TRACER.reset()
            t0 = time.perf_counter()
            engine.schedule_pending()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            total = TRACER.summary()["spans"]["compile_workload"]["total_seconds"]
            out[label] = {"wall": round(wall, 4), "compile": round(total, 4),
                          "parts": {k: round(v, 4) for k, v in spent.items()},
                          "rest": round(total - sum(spent.values()), 4),
                          "spans": compile_split(TRACER)}
        engine.close()
    finally:
        for target, name, fn in undo:
            setattr(target, name, fn)
    return out


RENORM_REPS = 20


def renorm_times(ph, carry, xs1, reps: int = RENORM_REPS) -> tuple[dict, int]:
    """renormalize_rows of the pod xs1 against carry over the first R of
    the profile's scorers with ScoreExtensions (R = 1 to all of them),
    their raws from the plain eval, at the pod's feasibility: held to
    renormalize_plain row by row and timed (CUDA graph) at the plan's G
    and each forced G (shard_times), each R with its bound.  A tree
    without renormalize_rows (an older checkout under --ladder --root)
    times its one-row renormalize_row R times -> ({R: times},
    max_abs_err)."""
    import torch

    from kube_scheduler_simulator_tpu_torch.framework import pipeline
    from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased

    cw = ph.step.cw
    n = cw.n_nodes
    out = ph.plain_eval(carry, xs1)
    scorers = list(cw.config.scorers())
    norm = [s for s, nm in enumerate(scorers) if nm in pipeline.NORMALIZING]
    feas = (out.filter_codes == 0).all(0)
    sl = pipeline.slice_pod(xs1, 0)
    fn = getattr(kphased, "renormalize_rows", None)
    res, err = {}, 0
    for r in range(1, len(norm) + 1):
        names = [scorers[s] for s in norm[:r]]
        raws = out.score_raw[norm[:r]].long().contiguous()
        want = torch.stack([pipeline.renormalize_plain(nm, cw, carry, sl, raws[i], feas)
                            for i, nm in enumerate(names)])
        if fn is None:
            def rows():
                return torch.stack([kphased.renormalize_row(ph.step, nm, carry, xs1, raws[i], feas)
                                    for i, nm in enumerate(names)])

            e = tree_err(rows(), want)
            check(e == 0, f"renormalize_row differs from its reference (max |d| {e})")
            t = {"S": None, "ms": timed_graph(rows, reps)}
        else:
            t, e = shard_times(fn, lambda **kw: fn(ph.step, names, carry, xs1, raws, feas, **kw),
                               want, reps, "_ctas", kphased.RENORM_CTAS, "ctas")
        err = max(err, e)
        # the raws and feasibility read, the rows written; a spread row
        # reads its scoring constraints' domain and count rows too
        spread = 0
        if "PodTopologySpread" in names:
            x = sl["PodTopologySpread"]
            spread = int(((x.c_id >= 0) & x.is_score).sum()) * n * 8
        t["bound"] = bound(2 * r * n * 8 + n + spread)
        t["names"] = names
        res[r] = t
    return res, err


def phased_carry(cw, binds: int = 64):
    """The host path's phased step of cw and its carry after `binds` pods
    evaluated and bound through it -> (phased, carry, xs_of(i): pod i's
    xs as a batch of one)."""
    import torch

    from kube_scheduler_simulator_tpu_torch.framework import pipeline
    from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry

    ph = pipeline.build_phased(cw)
    carry = _clone_carry(cw.init_carry)

    def xs_of(i: int) -> dict:
        xs1 = batch_xs(cw, i, 1)
        xs1["is_pad"] = torch.zeros(1, dtype=torch.bool, device=xs1["is_pad"].device)
        return xs1

    for i in range(binds):
        xs1 = xs_of(i)
        carry = ph.bind(carry, xs1, int(ph.eval(carry, xs1).selected))
    return ph, carry, xs_of


def phased_times(ph, carry, xs1, reps: int = 20) -> tuple[dict, int]:
    """phased_eval of the pod xs1 against carry, held to its plain version
    and timed at the plan's S and each forced S (shard_times), with its
    bound -> (times, max_abs_err)."""
    from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased

    want = list(ph.plain_eval(carry, xs1))
    t, err = shard_times(kphased.phased_eval,
                         lambda **kw: list(kphased.phased_eval(ph.step, carry, xs1, **kw)),
                         want, reps)
    t["bound"] = bound(phased_eval_bytes(ph.step.cw, carry, xs1))
    return t, err


# B11's dense eval: (K sessions, b pods), the batches phase 23's dense
# family launches
FUSED_EVAL_CASES = ((2, 8), (2, 32), (2, 128), (2, 512), (4, 512))
ROUND_CASES = ((1, 512), (2, 512), (4, 512), (8, 512))  # the sparse round: solo, then B11
ROUND_PODS = (1, 2, 4, 8)       # the pod-group sizes of the sparse round's kernel
ROUND_CLOCK_CASES = ((1, 512), (4, 512), (8, 512))


def _solo(fn, *args, **kw):
    """One solo launch's outputs, cloned (its buffers are reused)."""
    return [t.clone() for t in _leaves(fn(*args, **kw))]


def fused_eval_ladder(cw, reps: int = 3) -> tuple[dict, int]:
    """B11's dense eval on config 5 for each (K, b) of FUSED_EVAL_CASES:
    K members, member s with pods [s b, (s + 1) b) against the initial
    carry, held to the K solo spec_eval launches and timed at the plan's S
    and each forced S (shard_times) and in each CTA shape (shape_times),
    beside the K solo launches (the
    library column: the same function as K calls of today's spec_eval)
    -> ({"KxB": times}, max_abs_err)."""
    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    pm, sd, _ = _compact_plan(cw, None)
    step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
    carry = _clone_carry(cw.init_carry)
    res, err = {}, 0
    for k, b in FUSED_EVAL_CASES:
        batches = [batch_xs(cw, s * b, b) for s in range(k)]
        want = [_solo(kspec.spec_eval, step, carry, xs) for xs in batches]

        def call(**kw):
            # members made inside the call: a CUDA graph captures them on its own stream
            return [_leaves(o) for o in kfuse.spec_eval_fused(
                [kfuse.Member(step, carry, xs) for xs in batches], **kw)]

        t, e = shard_times(kfuse.spec_eval_fused, call, want, reps)
        shapes, e2 = shape_times(kfuse.spec_eval_fused, call, want, reps, "shards")
        t.update(shapes)
        err = max(err, e, e2)
        t["solo_ms"] = timed_graph(lambda: [kspec.spec_eval(step, carry, xs) for xs in batches],
                                   reps)
        res[f"{k}x{b}"] = t
    return res, err


def round_ladder(scw, reps: int = 3) -> tuple[dict, int]:
    """The sparse round on the slot-pinned fleet for each (K, b) of
    ROUND_CASES (K = 1: the solo spec_round, held to sparse_round_plain;
    K > 1: B11's spec_round_fused, held to the K solo launches), member s
    with pods [s b, (s + 1) b) against the initial carry, timed at the
    plan's pod-group size and each forced one where the wrapper takes one
    (`_pods`); then the phase clock's split of the launches of
    ROUND_CLOCK_CASES -> ({"KxB": times, "clock": {"KxB": split}},
    max_abs_err)."""
    import inspect
    import itertools

    import torch

    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep

    pm, sd, _ = _compact_plan(scw, None)
    step = build_step(scw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
    carry = _clone_carry(scw.init_carry)
    dev = carry["core"].requested.device
    res, err = {}, 0

    def members(batches):
        return [kfuse.Member(step, carry, xs, KCAND) for xs in batches]

    for k, b in ROUND_CASES:
        batches = [batch_xs(scw, s * b, b) for s in range(k)]
        if k == 1:
            fn = kspec.spec_round
            want = [t.clone() for t in _leaves(
                kspec.sparse_round_plain(step, carry, batches[0], KCAND))]

            def call(**kw):
                return _leaves(kspec.spec_round(step, carry, batches[0], KCAND, **kw))
        else:
            fn = kfuse.spec_round_fused
            want = [_solo(kspec.spec_round, step, carry, xs, KCAND) for xs in batches]

            def call(**kw):
                return [_leaves(r) for r in kfuse.spec_round_fused(members(batches), **kw)]

        t, e = shard_times(fn, call, want, reps, "_pods", ROUND_PODS, "pods")
        err = max(err, e)
        if k > 1:
            t["solo_ms"] = timed_graph(
                lambda: [kspec.spec_round(step, carry, xs, KCAND) for xs in batches], reps)
        res[f"{k}x{b}"] = t

    clock = {}
    # each case at the plan's group size, and at each forced one where the
    # wrappers take it
    groups = ((0, *ROUND_PODS) if "_pods" in inspect.signature(kspec.spec_round).parameters
              else (0,))
    for (k, b), pods in itertools.product(ROUND_CLOCK_CASES, groups):
        batches = [batch_xs(scw, s * b, b) for s in range(k)]
        cks = [torch.zeros(b * kstep.CLOCK_SLOTS, dtype=torch.int64, device=dev)
               for _ in range(k)]
        kw = {"_pods": pods} if pods else {}
        if k == 1:
            got = _leaves(kspec.spec_round(step, carry, batches[0], KCAND, _clock=cks[0], **kw))
            want = _leaves(kspec.spec_round(step, carry, batches[0], KCAND))
        else:
            got = _leaves(kfuse.spec_round_fused(members(batches), _clock=cks, **kw))
            want = _leaves(kfuse.spec_round_fused(members(batches)))
        torch.cuda.synchronize()
        check(tree_err(got, want) == 0, f"the sparse round's phase-clock build at {k}x{b}")
        rows = torch.cat([c.view(b, kstep.CLOCK_SLOTS) for c in cks]).cpu()
        ctas = rows[:, kspec.ROUND_CLOCK_START] > 0
        span = int(rows[ctas, kspec.ROUND_CLOCK_END].max() - rows[ctas, kspec.ROUND_CLOCK_START].min())
        n = int(ctas.sum())
        per = rows[ctas].sum(0)
        clock[f"{k}x{b}" + (f" P={pods}" if pods else "")] = {
            "ctas": n, "launch_ms": span / 1e6,
            "ms": {ph: int(per[j]) / 1e6 for j, ph in enumerate(kspec.ROUND_CLOCK_PHASES)},
            "us_per_cta": {ph: int(per[j]) / 1e3 / n
                           for j, ph in enumerate(kspec.ROUND_CLOCK_PHASES)}}
    res["clock"] = clock
    return res, err


MESH_LADDER_SHARDS = (2, 4, 8)  # the mesh's "nodes" extents the ladder times


def mesh_ladder(cw, reps: int = 3) -> tuple[dict, int]:
    """B12 on config 5 for the ladder: spec_eval_sharded on pods [0, b)
    for each b of LADDER and S of MESH_LADDER_SHARDS, held to spec_eval
    and timed at the plan's G and each forced G (shard_times, `_groups`
    where the wrapper takes it) and in each CTA shape (`_light`, where it
    takes it); then step_chunk_sharded on chunk 0 at
    each S, at the plan's G and each forced G, held to step_chunk and
    timed as phase 5 times B1 (back-to-back launches, each on a fresh
    copy of the initial carry, the median of `reps`), in turns with
    step_chunk -> ({"eval": {"S=s b=b": times}, "step": {...}},
    max_abs_err)."""
    import inspect

    import torch

    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
    from kube_scheduler_simulator_tpu_torch.parallel import make_mesh, shard_workload

    pm, sd, _ = _compact_plan(cw, None)
    kw = dict(out_mode="compact", pack_mode=pm, score_dtypes=sd)
    step = build_step(cw, **kw)
    steps = {s: build_step(shard_workload(cw, make_mesh(s)), **kw) for s in MESH_LADDER_SHARDS}
    carry = _clone_carry(cw.init_carry)
    res, err = {"eval": {}, "step": {}}, 0
    for b in LADDER:
        xs = batch_xs(cw, 0, b)
        want = _solo(kspec.spec_eval, step, carry, xs)
        for s in MESH_LADDER_SHARDS:
            def call(s=s, **k):
                return kmesh.spec_eval_sharded(steps[s], carry, xs, **k)

            t, e = shard_times(kmesh.spec_eval_sharded, call, want, reps, "_groups",
                               [g for g in EVAL_SHARDS if s * g <= 16], "groups")
            shapes, e2 = shape_times(kmesh.spec_eval_sharded, call, want, reps, "groups")
            t.update(shapes)
            err = max(err, e, e2)
            res["eval"][f"S={s} b={b}"] = t

    def chunk_ms(run) -> float:
        carries = [_clone_carry(cw.init_carry) for _ in range(reps + 1)]
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        run(carries[0])
        marks[0].record()
        for k in range(reps):
            run(carries[k + 1])
            marks[k + 1].record()
        torch.cuda.synchronize()
        return sorted(marks[k].elapsed_time(marks[k + 1]) for k in range(reps))[reps // 2]

    xs0 = batch_xs(cw, 0, CHUNK)
    cu, ou = kstep.step_chunk(step, _clone_carry(cw.init_carry), xs0)
    want = _leaves(ou) + _leaves(cu)
    forced = "_groups" in inspect.signature(kmesh.step_chunk_sharded).parameters
    runs = {"step_chunk": lambda c: kstep.step_chunk(step, c, xs0)}
    for s in MESH_LADDER_SHARDS:
        runs[f"S={s}"] = lambda c, s=s: kmesh.step_chunk_sharded(steps[s], c, xs0)
        for g in ([g for g in EVAL_SHARDS if s * g <= 16] if forced else []):
            runs[f"S={s} G={g}"] = lambda c, s=s, g=g: kmesh.step_chunk_sharded(
                steps[s], c, xs0, _groups=g)
    for name, run in runs.items():
        cs, os_ = run(_clone_carry(cw.init_carry))
        err = max(err, tree_err(_leaves(os_) + _leaves(cs), want))
        if name.startswith("S=") and " " not in name:
            res["step"][f"{name} plan G"] = getattr(kmesh.step_chunk_sharded, "groups", None)
    check(err == 0, f"the mesh ladder differs from the unsharded kernels (max |d| {err})")
    order = list(runs) + ["step_chunk"]  # in turns: step_chunk first and last
    times: dict = {}
    for name in order:
        times.setdefault(name, []).append(chunk_ms(runs[name]))
    res["step"].update({k: v for k, v in times.items()})
    return res, err


def att_chunk0(w, wide):
    """(B7's context, chunk 0's compact outputs, its pack mode) of
    workload w at the raw tier `wide`."""
    import torch

    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import (
        _DeviceAttribution, _clone_carry, _compact_plan, _slice_xs)

    dev = w.init_carry["core"].requested.device
    pm, sd, cols = _compact_plan(w, wide)
    step = build_step(w, out_mode="compact", pack_mode=pm, score_dtypes=sd, wide_raw=wide)
    hi = min(CHUNK, w.n_pods)
    xs = _slice_xs(w.xs, 0, hi, CHUNK)
    xs["is_pad"] = torch.arange(CHUNK, device=dev) >= hi
    _, out = step.scan(_clone_carry(w.init_carry), xs)
    return _DeviceAttribution(w, CHUNK, pm, cols), out, pm


def att_args(ctx, out) -> tuple:
    """chunk_attribution's arguments for chunk 0 of ctx's replay."""
    m = min(CHUNK, ctx.p)
    return (out.packed_filter, out.raw8, out.raw16, out.raw32, out.feasible_count,
            ctx.fskip_dev[0], ctx.sskip_dev[0], m, ctx.code_bits, ctx.dev_cols, ctx.want_pack)


def att_cases(cw, wide, dcw, dwide) -> dict:
    """B7's four chunks: chunk 0 of config 5 (cw at tier wide), of the
    default-profile fleet dcw (tier dwide: host score columns, so the
    bitmap), of CHUNK config-5 pods on 5,000 nodes with 16 extended
    resources (p64) and of config 5 at the i64 tier -> {name: (context,
    outputs, pack mode)}."""
    from kube_scheduler_simulator_tpu_torch.models import baseline_config
    from kube_scheduler_simulator_tpu_torch.state import compile_workload

    dev = cw.init_carry["core"].requested.device
    pnodes, ppods, pcfg = baseline_config(CONFIG, scale=CHUNK / 10_000, node_scale=1.0, seed=SEED)
    extend_resources(pnodes, ppods, SEED)
    pcw = compile_workload(pnodes, ppods, pcfg, device=dev)
    cases = {"config5": att_chunk0(cw, wide), "default_profile": att_chunk0(dcw, dwide),
             "p64": att_chunk0(pcw, None), "i64": att_chunk0(cw, "i64")}
    check(cases["p64"][2] == "p64", f"the extended-resource chunk packs {cases['p64'][2]}")
    check(cases["default_profile"][0].want_pack, "the default profile has no host score column")
    return cases


def att_bound(ctx, out, want: dict) -> tuple[float, str, int, int]:
    """B7's bound on one chunk: every packed word, each device score
    column's raws where the pod scores and the node is feasible
    (s_evaluated counts them), fc and the skips, the outputs ->
    (ms, "bytes", bytes, raw bytes)."""
    elem = {"raw8": 1, "raw16": 2, "raw32": out.raw32.element_size()}
    raw_bytes = sum(int(want["s_evaluated"][q]) * elem[g]
                    for q, (_s, g, _r) in enumerate(ctx.dev_cols)) if ctx.dev_cols else 0
    nbytes = (out.packed_filter.numel() * out.packed_filter.element_size() + raw_bytes
              + 4 * CHUNK + ctx.fskip_dev[0].numel() + ctx.sskip_dev[0].numel()
              + sum(t.numel() * t.element_size() for t in want.values()))
    return (*bound(nbytes), nbytes, raw_bytes)


def att_sector_bytes(ctx, out) -> int:
    """The bytes a card that reads whole 32-byte sectors moves for B7 on
    one chunk: the packed words, and every sector of a scored device
    column's raws that holds a feasible node of a pod that scores it (the
    bound counts those nodes' bytes alone)."""
    import torch

    m = min(CHUNK, ctx.p)
    packed = out.packed_filter
    feas = (packed.to(torch.int64) >> ctx.code_bits) == 0
    feas[m:] = False
    scored = out.feasible_count > 1
    raws = {"raw8": out.raw8, "raw16": out.raw16, "raw32": out.raw32}
    total = packed.numel() * packed.element_size()
    for s, g, r in ctx.dev_cols:
        x = raws[g]
        es, n = x.element_size(), x.shape[2]
        mask = feas & (scored & ~ctx.sskip_dev[0][s])[:, None]
        at = (torch.arange(x.shape[0], device=x.device)[:, None] * x.shape[1] + r) * n \
            + torch.arange(n, device=x.device)[None, :]
        total += 32 * int(torch.unique((at[mask] * es + x.data_ptr()) // 32).numel())
    return total


ATT_SHAPES = ((1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (2, 2), (2, 4), (4, 1), (4, 2), (8, 1))


def att_times(args, want: dict, reps: int = 20) -> tuple[dict, int]:
    """chunk_attribution on args, held to `want` and timed (device ms a
    launch, CUDA graph) in the plan's shape and, where the wrapper takes
    `_warps` / `_pods`, in each (W, P) of ATT_SHAPES -> ({"shape": the
    plan's (W, P) or None, "ms", "forced": {"W,P": ms}, "best", "slow": the
    plan more than 10 % slower than the best}, max_abs_err)."""
    import inspect

    from kube_scheduler_simulator_tpu_torch.kernels.attribution import chunk_attribution

    got = chunk_attribution(*args)
    check(sorted(got) == sorted(want), f"B7: keys {sorted(got)}")
    err = tree_err(got, want)
    out = {"shape": getattr(chunk_attribution, "shape", None),
           "ms": timed_graph(lambda: chunk_attribution(*args), reps)}
    if "_warps" in inspect.signature(chunk_attribution).parameters:
        forced = {}
        for w, p in ATT_SHAPES:
            err = max(err, tree_err(chunk_attribution(*args, _warps=w, _pods=p), want))
            forced[f"{w},{p}"] = timed_graph(
                lambda w=w, p=p: chunk_attribution(*args, _warps=w, _pods=p), reps)
        best = min(forced, key=forced.get)
        out.update(forced=forced, best=best, slow=out["ms"] > 1.1 * forced[best])
    check(err == 0, f"chunk_attribution differs from its plain version (max |d| {err})")
    return out, err


def att_ladder(cw) -> tuple[dict, int]:
    """B7 for the ladder: att_cases over config 5 (cw) and a
    default-profile fleet of CHUNK pods on 5,000 nodes, each chunk's times
    (att_times) beside its bound, and config 5's chunk with m = 0 (the
    launch's fixed cost) -> ({case: times}, max_abs_err)."""
    import torch

    from kube_scheduler_simulator_tpu_torch.kernels.attribution import chunk_attribution_plain
    from kube_scheduler_simulator_tpu_torch.models import baseline_config
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.state import compile_workload

    dev = cw.init_carry["core"].requested.device
    dnodes, dpods, _ = baseline_config(CONFIG, scale=CHUNK / 10_000, node_scale=1.0, seed=SEED)
    volumes, bound_pods = decorate_default_profile(dnodes, dpods, SEED)
    dcw = compile_workload(dnodes, dpods, PluginSetConfig(), volumes=volumes,
                           bound_pods=bound_pods, device=dev)
    res, err = {}, 0
    cases = att_cases(cw, None, dcw, None)
    for name, (ctx, out, pm) in cases.items():
        args = att_args(ctx, out)
        want = chunk_attribution_plain(*args)
        t, e = att_times(args, want)
        err = max(err, e)
        t["pack"] = pm
        t["bound"] = att_bound(ctx, out, want)[:2]
        t["sector_bytes"] = att_sector_bytes(ctx, out)
        res[name] = t
    # config 5's launch with every row a pad row: what a launch costs that
    # reads nothing of the chunk
    ctx, out, pm = cases["config5"]
    args = (*att_args(ctx, out)[:7], 0, *att_args(ctx, out)[8:])
    res["config5_all_pad"], e = att_times(args, chunk_attribution_plain(*args))
    res["config5_all_pad"]["pack"] = pm
    err = max(err, e)
    torch.cuda.synchronize()
    return res, err


def gang_slice(rng, gn: int, gg: int, n_nodes: int):
    """Phase 18's slice: gn pods in contiguous gangs of 2-8 members of gg
    groups (a tenth absent, runs of ungrouped pods between some), 85 %
    selected -> (gid, selected, already, min_member) int32."""
    import numpy as np

    gid = np.full(gn, -1, np.int32)
    pos, k = 0, 0
    while pos < gn and k < gg:
        if rng.random() < 0.1:
            k += 1  # a group absent from the slice
            continue
        size = int(rng.integers(2, 9))
        gid[pos:pos + size] = k
        pos += size + (int(rng.integers(1, 6)) if rng.random() < 0.3 else 0)  # -1 runs
        k += 1
    sel = np.where(rng.random(gn) < 0.85, rng.integers(0, n_nodes, gn), -1).astype(np.int32)
    return (gid, sel, rng.integers(0, 3, gg).astype(np.int32),
            rng.integers(1, 9, gg).astype(np.int32))


def scattered_slice(rng, gn: int, gg: int, n_nodes: int):
    """A slice whose groups are not contiguous: each pod in a random one
    of gg groups (80 %) or ungrouped, 85 % selected."""
    import numpy as np

    gid = np.where(rng.random(gn) < 0.8, rng.integers(0, gg, gn), -1).astype(np.int32)
    sel = np.where(rng.random(gn) < 0.85, rng.integers(0, n_nodes, gn), -1).astype(np.int32)
    return (gid, sel, rng.integers(0, 3, gg).astype(np.int32),
            rng.integers(1, 9, gg).astype(np.int32))


def gang_wave_slice(lo: int, hi: int):
    """A commit range [lo, hi) of phase 20's gang wave: GANG_FAMILIES'
    members in pending order (contiguous gangs), every member selected, the
    wave's groups all in G."""
    import numpy as np

    gid = np.concatenate([np.repeat(np.arange(groups) + sum(f[1] for f in
                                                           GANG_FAMILIES[:i]), size)
                          for i, (_fam, groups, size, _mm) in enumerate(GANG_FAMILIES)])
    mm = np.concatenate([np.full(groups, need, np.int32) for _f, groups, _s, need in GANG_FAMILIES])
    gid = gid[lo:hi].astype(np.int32)
    return gid, np.zeros(hi - lo, np.int32), np.zeros(len(mm), np.int32), mm


def quorum_times(args, dev, reps: int = 20) -> tuple[dict, int]:
    """B8 on the slice args = (gid, selected, already, min_member): the
    kernel held to quorum_slice_plain and timed (CUDA graph) at the plan's
    path and, where the wrapper takes `_path`, each path its tables fit;
    the copies as the checkout's framework/gang.py makes them (into and
    out of its page-locked buffers where it has them, else pageable),
    median device ms of `reps` (CUDA events); the numpy-to-numpy call
    (host clock, median of `reps` after one untimed); the bound ->
    (times, max_abs_err)."""
    import inspect

    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch.framework import gang
    from kube_scheduler_simulator_tpu_torch.kernels import gang as kgang

    n, g = len(args[0]), len(args[3])
    packed = np.concatenate([np.asarray(a, np.int32) for a in args])
    packed_dev = torch.from_numpy(packed).to(dev)
    admit, wave, wait = gang.quorum_slice_plain(*(torch.from_numpy(np.asarray(a, np.int32))
                                                  .to(dev) for a in args))
    want = torch.cat([admit.to(torch.int32), wave, wait.to(torch.int32)])
    err = tree_err(kgang.quorum_slice(packed_dev, n, g), want)
    out = {"n": n, "G": g, "path": getattr(kgang.quorum_slice, "path", None),
           "ms": timed_graph(lambda: kgang.quorum_slice(packed_dev, n, g), reps)}
    if "_path" in inspect.signature(kgang.quorum_slice).parameters:
        forced = {}
        for path in kgang.QUORUM_PATHS:
            if path == "shared" and kgang.quorum_tables(n, g) > kgang.QUORUM_SMEM:
                continue
            err = max(err, tree_err(kgang.quorum_slice(packed_dev, n, g, _path=path), want))
            forced[path] = timed_graph(lambda p=path: kgang.quorum_slice(packed_dev, n, g,
                                                                         _path=p), reps)
        out["forced"] = forced
    for a, b in zip(gang.quorum_slice(*args, device=dev), gang.quorum_slice(*args, device="cpu")):
        check(a.dtype == b.dtype and (a == b).all(), "B8 through framework/gang.py differs "
                                                     "from the CPU's")
    staging = getattr(gang, "_STAGING", None)
    h2d, d2h = [], []
    for _ in range(reps):
        e = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        if staging is not None:
            hin_np, hin, _hout_np, hout = staging.buffers(2 * n + 2 * g, 2 * g + n)
            hin_np[:] = packed
            e[0].record()
            din = hin.to(dev, non_blocking=True)
            e[1].record()
            dout = kgang.quorum_slice(din, n, g)
            e[2].record()
            hout.copy_(dout, non_blocking=True)
            e[3].record()
        else:
            host_in = torch.from_numpy(packed)
            e[0].record()
            din = host_in.to(dev)
            e[1].record()
            dout = kgang.quorum_slice(din, n, g)
            e[2].record()
            dout.cpu()
            e[3].record()
        torch.cuda.synchronize()
        h2d.append(e[0].elapsed_time(e[1]))
        d2h.append(e[2].elapsed_time(e[3]))
    calls = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        gang.quorum_slice(*args, device=dev)
        calls.append((time.perf_counter() - t0) * 1e3)
    out.update(h2d_ms=float(np.median(h2d)), d2h_ms=float(np.median(d2h)),
               call_ms=float(np.median(calls[1:])), pinned=staging is not None,
               bound=bound((2 * n + 2 * g) * 4 + (2 * g + n) * 4))
    check(err == 0, f"quorum_slice differs from its plain version (max |d| {err})")
    return out, err


QUORUM_LADDER = {"phase18": (10_000, 1_250), "scattered": (10_000, 1_250),
                 "past_shared": (10_000, 100_000)}
GANG_RANGE = 512                # phase 20's commit ranges of the gang wave, at most


def quorum_ladder(dev, n_nodes: int) -> tuple[dict, int]:
    """B8 for the ladder (quorum_times): phase 18's slice (n = 10,000,
    G = 1,250), a scattered one of that size, one with G = 100,000 past
    shared memory, and phase 20's shapes (gang_wave_slice: its first
    commit range of GANG_RANGE members and the whole wave of 2,000, G =
    260) -> ({case: times}, max_abs_err)."""
    import numpy as np

    res, err = {}, 0
    for name, (gn, gg) in QUORUM_LADDER.items():
        rng = np.random.default_rng(SEED)
        make = gang_slice if name == "phase18" else scattered_slice
        res[name], e = quorum_times(make(rng, gn, gg, n_nodes), dev)
        err = max(err, e)
    members = sum(groups * size for _f, groups, size, _mm in GANG_FAMILIES)
    for name, (lo, hi) in (("phase20_range", (0, GANG_RANGE)), ("phase20_wave", (0, members))):
        res[name], e = quorum_times(gang_wave_slice(lo, hi), dev)
        err = max(err, e)
    return res, err


def ptxas_summary(log: str) -> str:
    """nvcc's -Xptxas -v lines of each kernel: its name, registers and
    spills."""
    return " ".join(ln.strip() for ln in log.splitlines()
                    if "entry function" in ln or "registers" in ln or "spill" in ln)


def ladder_main(root: Path, only: set | None = None) -> int:
    """`python3 chip_smoke.py --ladder [--root DIR]`: the dense round's
    evaluation on config 5 at the ladder's batches (and b = 1), the host
    path's phased_eval and renormalize_rows (renorm_times: R = 1 to 4), the
    oracle (oracle_ladder: config 5's batches at ORACLE_BATCHES, b = 512
    with its only conflict at k = B - 1 and with none, B11's fused oracle
    at ORACLE_FUSED_KS; plan and forced CTAs), B11's dense eval at
    FUSED_EVAL_CASES, the sparse round at ROUND_CASES with its phase
    clock (the slot-pinned fleet), B12's eval and step on config 5
    (mesh_ladder: the eval at each rung and step_chunk_sharded on chunk
    0 at S = 2, 4, 8, beside step_chunk), B7 (att_ladder: chunk 0 of
    config 5, of a default-profile fleet, p64 and i64, in the plan's and
    each forced shape, and config 5's with every row a pad row), B8
    (quorum_ladder: phase 18's slice, a scattered
    one, G past shared memory and phase 20's shapes; the kernel at each
    path, the copies and the numpy-to-numpy call), B5's core (b5_ladder:
    the oracle, the core and the two in a row, and the oracle with the
    core folded in where the checkout has it; solo at b = 512 and over
    B11's table of 4 sessions), and DIRECT_RUNS
    direct replay_speculative runs on 1,024 x 5,000 with spec_eval's
    launches by batch size, and the compile's split on phase 19's wave
    (compile_ladder), for the port found under DIR (default: this
    checkout), so that two trees are compared in one call.  Two JSON lines
    after the card's name: the kernels', then the direct replays'.
    `--only NAME,...` runs only those entries of the first line (and the
    direct replays only if "direct" is named)."""
    import collections

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    sys.path.insert(0, str(root))
    from kube_scheduler_simulator_tpu_torch.kernels import build
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.models import (
        baseline_config, make_slot_pinned_workload)
    from kube_scheduler_simulator_tpu_torch.parallel import replay_speculative
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.state import compile_workload

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    for stem, res in build.build([*build.SIGNATURES]).items():  # the clock builds too
        print(f"[build] {stem}: {ptxas_summary(res.log)}", flush=True)
    nodes, pods, cfg = baseline_config(CONFIG, scale=1.0, seed=SEED)
    res, errs = {}, [0]

    def run(name: str, fn) -> None:
        if only and name not in only:
            return
        res[name], err = fn()
        errs.append(err)

    if not only or only - {"b5", "compile"}:
        cw = compile_workload(nodes, pods, cfg, device=dev)
        run("spec_eval", lambda: eval_ladder(cw, (1, *LADDER)))
        if not only or {"phased_eval", "renormalize_rows"} & only:
            ph, carry, xs_of = phased_carry(cw)
            run("phased_eval", lambda: phased_times(ph, carry, xs_of(64)))
            run("renormalize_rows", lambda: renorm_times(ph, carry, xs_of(64)))
            del carry
        run("oracle", lambda: oracle_ladder(cw))
        run("spec_eval_fused", lambda: fused_eval_ladder(cw))
        run("mesh", lambda: mesh_ladder(cw))
        run("b7", lambda: att_ladder(cw))
        run("b8", lambda: quorum_ladder(dev, cw.n_nodes))
        del cw
    if not only or {"sparse_round", "b5"} & only:
        snodes, spods = make_slot_pinned_workload(SLOT_PODS, SLOT_NODES, seed=SEED)
        scw = compile_workload(snodes, spods, PluginSetConfig(enabled=list(SLOT_PLUGINS)),
                               device=dev)
        run("sparse_round", lambda: round_ladder(scw))
        run("b5", lambda: b5_ladder(scw))
        del scw
    run("compile", lambda: (compile_ladder(nodes, pods, cfg), 0))
    print(json.dumps({"card": card, "root": str(root), "max_abs_err": max(errs), **res}),
          flush=True)
    if only and "direct" not in only:
        return 0

    dnodes, dpods, dcfg = baseline_config(CONFIG, scale=DIRECT_SCALE, node_scale=1.0, seed=SEED)
    dcw = compile_workload(dnodes, dpods, dcfg, device=dev)
    orig = kspec.spec_eval
    direct = []
    for _ in range(DIRECT_RUNS):
        seen = collections.Counter()

        def counted(step, carry, xs, *a, **kw):
            seen[xs["is_pad"].shape[0]] += 1
            return orig(step, carry, xs, *a, **kw)

        # the wrapper counts its launch on the name it is called by
        counted.launches, counted.batches = 0, collections.Counter()
        kspec.spec_eval = counted
        try:
            t0 = time.perf_counter()
            _, stats = replay_speculative(dcw, pods=dpods)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            kspec.spec_eval = orig
        direct.append({"s": wall, "rounds": stats["rounds"], "accepted": stats["accepted"],
                       "rolled_back": stats["rolled_back"],
                       "by_batch": dict(sorted(seen.items()))})
    print(json.dumps({"card": card, "root": str(root), "direct": direct}), flush=True)
    return 0


def speculative_phases(dev, card: str, cw, pods: list, rr) -> list[dict]:
    """Phases 6-9: the speculative wave's kernels against their plain
    versions, its two paths (low contention, contended) and the kernels'
    times.  -> ({"slot": (the slot-pinned workload, its host-resident
    stream), "contended": phase 8's config-5 stream, "eval_bounds": {b:
    spec_eval's bound at the ladder's rung b}}, the kernels' entries of
    the JSON line)."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import (
        _clone_carry, _compact_plan, replay)
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
    from kube_scheduler_simulator_tpu_torch.models import (
        baseline_config, make_slot_pinned_workload)
    from kube_scheduler_simulator_tpu_torch.parallel import (
        replay_speculative, replay_speculative_stream)
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.state import compile_workload

    kernels = (*kspec.KERNELS, kstep.step_chunk)

    def counts() -> dict:
        return {f.__name__: f.launches for f in kernels}

    def reset() -> None:
        for f in kernels:
            f.launches = 0
        kspec.spec_oracle.commits = 0
        kspec.spec_eval.batches.clear()
        kspec.spec_round.batches.clear()

    errs: dict[str, int] = {}

    def held(name: str, got, want) -> None:
        err = tree_err(got, want)
        errs[name] = max(errs.get(name, 0), err)
        check(err == 0, f"{name} differs from its plain version (max |d| {err})")

    # ---- 6. the wave's kernels == their plain versions, at full width
    t6 = time.perf_counter()
    snodes, spods = make_slot_pinned_workload(SLOT_PODS, SLOT_NODES, seed=SEED)
    t0 = time.perf_counter()
    scw = compile_workload(snodes, spods, PluginSetConfig(enabled=list(SLOT_PLUGINS)),
                           device=dev)
    torch.cuda.synchronize()
    slot_compile_s = time.perf_counter() - t0
    sp, sn = scw.n_pods, scw.n_nodes
    spm, ssd, _ = _compact_plan(scw, None)
    sstep = build_step(scw, out_mode="compact", pack_mode=spm, score_dtypes=ssd)
    sxs0, sxs1 = batch_xs(scw, 0, SPEC_BATCH), batch_xs(scw, SPEC_BATCH, SPEC_BATCH)
    scarry = _clone_carry(scw.init_carry)
    r0 = kspec.spec_round(sstep, scarry, sxs0, KCAND)
    round0_plain = kspec.sparse_round_plain(sstep, scarry, sxs0, KCAND)
    held("spec_round", r0, round0_plain)
    round0_pods = kspec.spec_round.pods
    for group in kspec.ROUND_PODS:  # every group size of the kernel
        held("spec_round", kspec.spec_round(sstep, scarry, sxs0, KCAND, _pods=group),
             round0_plain)
    k0 = kspec.spec_oracle(r0[0], r0[1], r0[7])
    held("spec_oracle", k0, kspec._oracle_core(r0[0], r0[1], r0[7], SPEC_BATCH))
    check(int(k0) == SPEC_BATCH, f"slot-pinned round 0 accepted {int(k0)} of {SPEC_BATCH}")
    committed = kspec.commit_plain(sstep, _clone_carry(scarry), sxs0, r0[7], SPEC_BATCH)
    kspec.spec_commit_core(sstep, scarry, sxs0, r0[7], SPEC_BATCH)
    held("spec_commit_core", scarry, committed)
    r1 = kspec.spec_round(sstep, scarry, sxs1, KCAND)
    held("spec_round", r1, kspec.sparse_round_plain(sstep, scarry, sxs1, KCAND))
    k1 = kspec.spec_oracle(r1[0], r1[1], r1[7])
    held("spec_oracle", k1, kspec._oracle_core(r1[0], r1[1], r1[7], SPEC_BATCH))
    # the oracle with B5's core folded in, on the slot-pinned carry after
    # round 0's commit, against the plain oracle then commit_plain
    fold_k, c0 = {}, kspec.spec_oracle.commits
    for b in FOLD_BATCHES:
        for i, kind in enumerate(FOLD_KINDS):
            rows, fxs, fm, fcounts, fk = fold_case(scw, kind, b, SEED + i, r0[0].dtype)
            err, fold_k[f"{kind} b={b}"] = fold_err(
                kspec, rows, fxs, fm, fcounts, fk, scarry,
                lambda rows, c: kspec.spec_oracle(*rows, commit=c))
            errs["spec_oracle_commit"] = max(errs.get("spec_oracle_commit", 0), err)
            check(err == 0, f"the folded oracle differs from the plain oracle then "
                            f"commit_plain ({kind}, b = {b}; max |d| {err})")
    check(kspec.spec_oracle.commits - c0 == len(FOLD_BATCHES) * len(FOLD_KINDS),
          "a folded oracle launch was not counted")

    cpm, csd, _ = _compact_plan(cw, None)
    cstep = build_step(cw, out_mode="compact", pack_mode=cpm, score_dtypes=csd)
    cxs = batch_xs(cw, 0, SPEC_BATCH)
    ccarry = _clone_carry(cw.init_carry)
    ev = kspec.spec_eval(cstep, ccarry, cxs)
    held("spec_eval", ev, kspec.eval_plain(cstep, ccarry, cxs))
    kd = kspec.spec_oracle(ev.packed_filter, ev.prefilter_reject, ev.selected)
    held("spec_oracle", kd, kspec._oracle_core(ev.packed_filter, ev.prefilter_reject,
                                               ev.selected, SPEC_BATCH))
    committed = kspec.commit_plain(cstep, _clone_carry(ccarry), cxs, ev.selected, ACCEPT)
    cbound = kspec.spec_commit_bind(cstep, _clone_carry(ccarry), cxs, ev.selected, ACCEPT)
    held("spec_commit_bind", cbound, committed)
    del committed, cbound

    # the chunk grid at the slot-pinned stream's shapes, random contents
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows0 = {"packed": r0[0], "raw8": r0[3], "raw16": r0[4], "raw32": r0[5], "fc": r0[2]}
    bufs = {k: torch.randint(0, 100, (CHUNK + SPEC_BATCH,) + tuple(v.shape[1:]), device=dev,
                             generator=gen, dtype=torch.int32).to(v.dtype)
            for k, v in rows0.items()}
    appended = kspec.grid_append({k: v.clone() for k, v in bufs.items()}, rows0, FILL)
    want = kspec.append_plain({k: v.clone() for k, v in bufs.items()}, rows0, FILL)
    held("grid_append", appended, want)
    held("grid_emit", kspec.grid_emit(appended, CHUNK), kspec.emit_plain(want, CHUNK))
    torch.cuda.synchronize()
    print(f"[6 spec kernels==plain] slot-pinned {sp}x{sn} (compile {slot_compile_s:.3f} s): "
          f"spec_round rounds 0 (the plan's groups of {round0_pods} pods and each forced size "
          f"of {kspec.ROUND_PODS}) and 1 at batch {SPEC_BATCH}, K={KCAND}, round 1 after "
          f"spec_commit_core; spec_oracle with the core commit folded in, on that carry, "
          f"against the plain oracle then commit_plain, K {fold_k}; config {CONFIG} "
          f"{cw.n_pods}x{cw.n_nodes}: spec_eval and "
          f"spec_oracle at batch {SPEC_BATCH}, spec_commit_bind with accept prefix {ACCEPT}; "
          f"grid_append at fill {FILL} then grid_emit; max_abs_err {errs}; "
          f"{time.perf_counter() - t6:.1f} s", flush=True)

    # ---- 7. low contention, the slice's main path: the slot-pinned stream
    t7 = time.perf_counter()
    reset()
    t0 = time.perf_counter()
    srr, sstats = replay_speculative_stream(scw, chunk=CHUNK, device_resident=False)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    low = counts()
    folded = kspec.spec_oracle.commits
    low["spec_oracle_commit"] = folded
    low_batches = dict(sorted(kspec.spec_round.batches.items()))
    check(sstats["rounds"] == 20 and sstats["accepted"] == sp and sstats["rolled_back"] == 0
          and sstats["fallback_at"] is None, f"slot-pinned stream stats {sstats}")
    for name in ("spec_round", "spec_oracle", "grid_append", "grid_emit"):
        check(low[name] > 0, f"the low-contention path launched no {name}")
    # every round's commit is folded into its oracle launch (a core-only
    # carry, no interaction rule, no gang): no spec_commit_core
    check(folded == sstats["rounds"] and low["spec_commit_core"] == 0,
          f"slot-pinned stream: {folded} of {sstats['rounds']} rounds folded, "
          f"{low['spec_commit_core']} spec_commit_core launches")
    t0 = time.perf_counter()
    sbase = replay(scw, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    scan_s = time.perf_counter() - t0
    sample = sorted(set(range(0, sp, sp // 8)) | {1, CHUNK - 1, CHUNK, sp - 1})
    same_replay(srr, sbase, "slot-pinned stream vs scan", sample)
    check(srr.scheduled == sp, f"slot-pinned: {srr.scheduled} of {sp} scheduled")
    # the same stream as an engine's gang wave runs it (gangs of GANG_CUT
    # pods, contiguous): the host may cut a round's K at a gang boundary
    # after reading it, so no round folds, and each commits through
    # spec_commit_core
    reset()
    gid = np.arange(sp, dtype=np.int32) // GANG_CUT
    gang = SimpleNamespace(gid=gid, start=np.arange(0, sp, GANG_CUT, dtype=np.int64))
    t0 = time.perf_counter()
    grr, gstats = replay_speculative_stream(scw, chunk=CHUNK, device_resident=False, gang=gang)
    torch.cuda.synchronize()
    gang_s = time.perf_counter() - t0
    gang_low = counts()
    check(kspec.spec_oracle.commits == 0 and gang_low["spec_commit_core"] == gstats["rounds"],
          f"gang stream: {kspec.spec_oracle.commits} rounds folded, "
          f"{gang_low['spec_commit_core']} spec_commit_core of {gstats['rounds']} rounds")
    same_replay(grr, sbase, "slot-pinned gang stream vs scan", sample)
    # the JSON line's launches: the main stream's, and spec_commit_core's
    # from the gang wave, the path that runs it now
    low_json = dict(low, spec_commit_core=gang_low["spec_commit_core"])
    # device time of each: the same launches again, no fetch, between events
    carry = _clone_carry(scw.init_carry)
    spans = []
    for lo in range(0, sp, SPEC_BATCH):
        m = min(SPEC_BATCH, sp - lo)
        xs = batch_xs(scw, lo, SPEC_BATCH)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = kspec.spec_round(sstep, carry, xs, KCAND)
        kspec.spec_oracle(out[0], out[1], out[7], commit=kspec.Commit(carry, xs, m, out[2],
                                                                       KCAND))
        if m < SPEC_BATCH:
            grid = {k: torch.zeros((CHUNK + SPEC_BATCH,) + tuple(v.shape[1:]), dtype=v.dtype,
                                   device=dev) for k, v in rows0.items()}
            grid = kspec.grid_append(grid, {"packed": out[0], "raw8": out[3], "raw16": out[4],
                                            "raw32": out[5], "fc": out[2]}, 0)
            kspec.grid_emit(grid, CHUNK)
        e1.record()
        spans.append((e0, e1))
    carry = _clone_carry(scw.init_carry)
    scan_spans = []
    for lo in range(0, sp, CHUNK):
        xs = batch_xs(scw, lo, CHUNK)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        carry, _ = sstep.scan(carry, xs)
        e1.record()
        scan_spans.append((e0, e1))
    torch.cuda.synchronize()
    stream_dev_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    scan_dev_s = sum(a.elapsed_time(b) for a, b in scan_spans) / 1e3
    # the host fetch of one grid chunk, as the stream's ingest does it
    t0 = time.perf_counter()
    fetched = sum(np.ascontiguousarray(v.cpu().numpy()).nbytes for v in rows0.values())
    fetch_ms = (time.perf_counter() - t0) * 1e3
    print(f"[7 low contention] slot-pinned {sp} pods x {sn} nodes, "
          f"{'+'.join(SLOT_PLUGINS)}, chunk {CHUNK}: stats {json.dumps(sstats)}; "
          f"stream {stream_s:.4f} s = {sp / stream_s:.1f} cycles/s (device {stream_dev_s:.4f} s); "
          f"scan {scan_s:.4f} s = {sp / scan_s:.1f} cycles/s (device {scan_dev_s:.4f} s); "
          f"host fetch of one chunk's outputs {fetch_ms:.3f} ms ({fetched} B); "
          f"selected, feasible_count, every compact chunk's bytes (raws at feasible nodes) "
          f"and decode bytes of pods {sample} equal to the scan; launches {low}, spec_round's "
          f"by batch size {low_batches}; rounds folded (the commit in the oracle launch) "
          f"{folded} of {sstats['rounds']}, unfolded {sstats['rounds'] - folded} | as a gang "
          f"wave (gangs of {GANG_CUT} pods): {gstats['rounds']} rounds, none folded, "
          f"{gang_low['spec_commit_core']} spec_commit_core launches, {gang_s:.4f} s, equal to "
          f"the scan; {time.perf_counter() - t7:.1f} s",
          flush=True)

    # ---- 8. contended: config 5 through the stream (it falls back to the
    # scan), then the direct replay with no fallback on 1,024 pods
    t8 = time.perf_counter()
    reset()
    t0 = time.perf_counter()
    crr, cstats = replay_speculative_stream(cw, chunk=CHUNK, pods=pods, device_resident=False)
    torch.cuda.synchronize()
    cstream_s = time.perf_counter() - t0
    hot = counts()
    check(cstats["fallback_at"] is not None, f"config {CONFIG} stream did not fall back: {cstats}")
    for name in ("spec_eval", "spec_oracle", "spec_commit_bind", "step_chunk"):
        check(hot[name] > 0, f"the contended stream launched no {name}")
    same_replay(crr, rr, f"config {CONFIG} stream vs phase 4",
                [i for i in DECODE_CHECK_PODS if i < cw.n_pods])
    dnodes, dpods, dcfg = baseline_config(CONFIG, scale=DIRECT_SCALE, node_scale=1.0, seed=SEED)
    dcw = compile_workload(dnodes, dpods, dcfg, device=dev)
    reset()
    t0 = time.perf_counter()
    drr, dstats = replay_speculative(dcw, pods=dpods)
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    direct = counts()
    direct_batches = dict(sorted(kspec.spec_eval.batches.items()))
    for name in ("spec_eval", "spec_oracle", "spec_commit_bind"):
        check(direct[name] > 0, f"the direct replay launched no {name}")
    t0 = time.perf_counter()
    dbase = replay(dcw, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    dscan_s = time.perf_counter() - t0
    dp = dcw.n_pods
    same_replay(drr, dbase, f"config {CONFIG} direct vs scan",
                sorted({0, 1, dp // 2, dp - 1}))
    print(f"[8 contended] {card}: config {CONFIG} {cw.n_pods}x{cw.n_nodes} stream: stats "
          f"{json.dumps(cstats)}; {cstream_s:.4f} s = {cw.n_pods / cstream_s:.1f} cycles/s; "
          f"equal to phase 4's scan; launches {hot} | direct replay_speculative "
          f"{dp}x{dcw.n_nodes}: stats rounds {dstats['rounds']} accepted {dstats['accepted']} "
          f"rolled_back {dstats['rolled_back']} mean_accept {dstats['mean_accept']} "
          f"fallback_at {dstats['fallback_at']}; {direct_s:.4f} s = {dp / direct_s:.1f} "
          f"cycles/s against the scan's {dscan_s:.4f} s; equal to the scan; launches {direct}, "
          f"spec_eval's by batch size {direct_batches}; {time.perf_counter() - t8:.1f} s",
          flush=True)

    # ---- 9. the kernels' times, at the phase-6 inputs: device time from
    # CUDA graphs, and the time per wrapper call back to back (which for
    # a short kernel is the wrapper's host cost)
    scarry = _clone_carry(scw.init_carry)
    ccarry = _clone_carry(cw.init_carry)
    sel0, sel_eval = r0[7], ev.selected
    grid = {k: v.clone() for k, v in bufs.items()}
    calls = {
        "spec_oracle": (lambda: kspec.spec_oracle(r0[0], r0[1], sel0), 20),
        # the oracle with the core commit folded in, as phase 7's sparse
        # rounds launch it (its feasible counts and candidate cap)
        "spec_oracle_commit": (lambda: kspec.spec_oracle(
            r0[0], r0[1], sel0, commit=kspec.Commit(scarry, sxs0, SPEC_BATCH, r0[2], KCAND)),
            20),
        "spec_commit_core": (
            lambda: kspec.spec_commit_core(sstep, scarry, sxs0, sel0, SPEC_BATCH), 20),
        "spec_commit_bind": (
            lambda: kspec.spec_commit_bind(cstep, ccarry, cxs, sel_eval, ACCEPT), 5),
        "grid_append": (lambda: kspec.grid_append(grid, rows0, FILL), 20),
        "grid_emit": (lambda: kspec.grid_emit(grid, CHUNK), 20),
    }
    # spec_round at the plan's group size and each forced one, held to its
    # plain version
    rounds, rerr = shard_times(kspec.spec_round,
                               lambda **kw: kspec.spec_round(sstep, scarry, sxs0, KCAND, **kw),
                               round0_plain, 5, "_pods", kspec.ROUND_PODS, "pods")
    errs["spec_round"] = max(errs["spec_round"], rerr)
    ms = {"spec_round": rounds["ms"],
          **{name: timed_graph(fn, reps) for name, (fn, reps) in calls.items()}}
    calls["spec_round"] = (lambda: kspec.spec_round(sstep, scarry, sxs0, KCAND), 5)
    call_ms = {name: timed(fn, reps) for name, (fn, reps) in calls.items()}
    scarry = _clone_carry(scw.init_carry)
    ccarry = _clone_carry(cw.init_carry)
    plain = {
        "spec_round": timed_once(lambda: kspec.sparse_round_plain(sstep, scarry, sxs0, KCAND)),
        "spec_oracle": timed_once(lambda: kspec._oracle_core(r0[0], r0[1], sel0, SPEC_BATCH)),
        "spec_oracle_commit": timed_once(lambda: kspec.oracle_commit_plain(
            r0[0], r0[1], sel0, kspec.Commit(scarry, sxs0, SPEC_BATCH, r0[2], KCAND))),
        "spec_commit_core": timed_once(
            lambda: kspec.commit_plain(sstep, scarry, sxs0, sel0, SPEC_BATCH)),
        "spec_commit_bind": timed_once(
            lambda: kspec.commit_plain(cstep, ccarry, cxs, sel_eval, ACCEPT)),
        "grid_append": timed_once(lambda: kspec.append_plain(grid, rows0, FILL)),
        "grid_emit": timed_once(lambda: kspec.emit_plain(grid, CHUNK)),
    }
    # one PyTorch call (per carry tensor / per buffer) computing the same
    # function, timed like the kernels; never used by the port
    core, sx = scarry["core"], sxs0["core"]
    idx = sel0.long()

    def lib_commit():
        core.requested.index_add_(0, idx, sx.requests)
        core.nonzero.index_add_(0, idx, sx.nonzero)
        core.num_pods.index_add_(0, idx, torch.ones_like(idx))

    def lib_append():
        for k, v in rows0.items():
            grid[k][FILL:FILL + v.shape[0]].copy_(v)

    heads = {k: torch.empty((CHUNK,) + tuple(v.shape[1:]), dtype=v.dtype, device=dev)
             for k, v in grid.items()}
    rest = {k: torch.empty_like(v) for k, v in grid.items()}

    def lib_emit():
        for k, v in grid.items():
            heads[k].copy_(v[:CHUNK])
            rest[k][:SPEC_BATCH].copy_(v[CHUNK:])
            rest[k][SPEC_BATCH:].zero_()

    library = {"spec_commit_core": timed_graph(lib_commit, 20),
               "grid_append": timed_graph(lib_append, 20), "grid_emit": timed_graph(lib_emit, 20)}

    # bounds: each input read once and each output written once, at the
    # timed inputs; float64 work where the kernel has it
    def nb(*xs) -> int:
        return sum(t.numel() * t.element_size() for x in xs for t in _leaves(x))

    s_stat = scw.statics
    aff_rows = (len(torch.unique(sxs0["NodeAffinity"].req_idx)) * sn
                + len(torch.unique(sxs0["NodeAffinity"].pref_idx)) * sn * 4)
    round_out = nb(r0)
    bounds = {
        # core statics and carry, the referenced affinity rows, the batch's
        # xs, the outputs; balanced allocation's ~9 float64 ops per candidate
        "spec_round": bound(nb(s_stat["core"], scw.init_carry, sxs0) + aff_rows + round_out,
                            SPEC_BATCH * KCAND * 9),
        # the packed words of the pairs up to the first conflict, their
        # rows' rejects and selections, K
        "spec_oracle": bound(oracle_bytes(r0[0], r0[1], sel0)),
        # the batch's core rows and selections; the selected carry rows read
        # and written
        "spec_commit_core": bound(nb(sx, sel0) + 2 * SPEC_BATCH * (scw.schema.n + 3) * 8),
        # the oracle's bytes, and the commit's, and the feasible counts it
        # tests against the candidate cap
        "spec_oracle_commit": bound(oracle_bytes(r0[0], r0[1], sel0) + nb(sx, r0[2])
                                    + 2 * SPEC_BATCH * (scw.schema.n + 3) * 8),
        # the carry read and written once, the batch's xs and selections
        "spec_commit_bind": bound(2 * nb(cw.init_carry) + nb(cxs, sel_eval)),
        "grid_append": bound(2 * nb(rows0)),
        # the buffer read, the head and the second buffer written
        "grid_emit": bound(nb(grid) + nb(heads) + nb(rest)),
    }
    # spec_eval and spec_oracle at the ladder's rungs (config 5, the
    # initial carry): the JSON line takes them at b = 8, the batch of the
    # direct replay's launches (phase 8)
    ladder, lerr = eval_ladder(cw, LADDER)
    errs["spec_eval"] = max(errs["spec_eval"], lerr)
    at8 = ladder[8]
    ms["spec_eval"], plain["spec_eval"], bounds["spec_eval"] = (
        at8["ms"], at8["plain_ms"], at8["bound"])
    ms["spec_oracle"], bounds["spec_oracle"] = at8["oracle"]["ms"], at8["oracle"]["bound"]
    plain["spec_oracle"] = timed_once(lambda: kspec._oracle_core(
        ev.packed_filter[:8], ev.prefilter_reject[:8], ev.selected[:8], 8))
    # spec_commit_bind at the main path's batch: the direct replay's
    # launches are at b = 8 (phase 8), accept prefix k <= 8; the JSON line
    # takes k = 8
    bind512 = ms["spec_commit_bind"]
    xs8 = batch_xs(cw, 0, 8)
    sel8 = kspec.spec_eval(cstep, ccarry, xs8).selected.clone()
    bind8 = {}
    for k in (1, 8):
        held("spec_commit_bind", kspec.spec_commit_bind(cstep, _clone_carry(ccarry), xs8, sel8, k),
             kspec.commit_plain(cstep, _clone_carry(ccarry), xs8, sel8, k))
        bind8[k] = timed_graph(lambda k=k: kspec.spec_commit_bind(cstep, ccarry, xs8, sel8, k), 5)
    ccarry = _clone_carry(cw.init_carry)
    ms["spec_commit_bind"] = bind8[8]
    plain["spec_commit_bind"] = timed_once(lambda: kspec.commit_plain(cstep, ccarry, xs8, sel8, 8))
    bounds["spec_commit_bind"] = bound(2 * nb(cw.init_carry) + nb(xs8, sel8))
    flag = " FLAG: the plan is over 10 % slower than the best"
    rungs = "; ".join(
        f"b={b}: plan S={t['S']} {t['ms']:.5f} ms, forced "
        + ", ".join(f"S={k} {v:.5f}" for k, v in t["forced"].items())
        + f", best S={t['best']}{flag if t['slow'] else ''}"
        + f", bound {t['bound'][0]:.6f} ms by {t['bound'][1]}"
        for b, t in ladder.items())
    oracle = ", ".join(
        f"b={b} (K = {o['k']}) plan C={o['S']} {o['ms']:.5f} ms, forced "
        + ", ".join(f"C={c} {v:.5f}" for c, v in o["forced"].items())
        + f" (bound {o['bound'][0]:.7f})"
        for b, o in ((b, ladder[b]["oracle"]) for b in ORACLE_BATCHES))
    print(f"[9 timing] {card}: device ms per launch (CUDA graph) {ms}; ms per wrapper call back "
          f"to back {call_ms}; plain {plain}; library (CUDA graph) {library}; bounds {bounds}",
          flush=True)
    print(f"[9 timing] {card}: spec_eval on config {CONFIG} (max_abs_err {lerr} at every S) | "
          f"{rungs} | spec_oracle {oracle} | spec_commit_bind at b = 8 (== commit_plain): "
          f"k = 1 {bind8[1]:.5f} ms, k = 8 {bind8[8]:.5f} ms (at b = {SPEC_BATCH}, k = {ACCEPT}: "
          f"{bind512:.5f}); plain {plain['spec_commit_bind']:.3f} ms, bound "
          f"{bounds['spec_commit_bind'][0]:.6f} ms by {bounds['spec_commit_bind'][1]}", flush=True)
    print(f"[9 timing] {card}: spec_round on the slot-pinned batch of {SPEC_BATCH} (max_abs_err "
          f"{rerr} at every group size): plan P={rounds['S']} {rounds['ms']:.5f} ms, forced "
          + ", ".join(f"P={k} {v:.5f}" for k, v in rounds["forced"].items())
          + f", best P={rounds['best']}"
          + (" FLAG: the plan is over 10 % slower than the best" if rounds["slow"] else ""),
          flush=True)

    launches = {name: low_json[name] + hot.get(name, 0) + direct.get(name, 0) for name in ms}
    ctx = {"slot": (scw, srr), "contended": crr,
           "eval_bounds": {b: t["bound"] for b, t in ladder.items()}}
    sources = {"spec_eval": "spec_eval.cu", "spec_oracle": "oracle.cu",
               "spec_oracle_commit": "oracle.cu",
               "spec_round": "spec_round.cu", "spec_commit_core": "spec_commit.cu",
               "spec_commit_bind": "spec_commit.cu", "grid_append": "grid.cu",
               "grid_emit": "grid.cu"}
    replaces = {"spec_eval": 318, "spec_oracle": 299, "spec_round": 381,
                "spec_oracle_commit": 501, "spec_commit_core": 501, "spec_commit_bind": 501,
                "grid_append": 553, "grid_emit": 553}
    return ctx, [{
        "name": name,
        "route": "cuda",
        "source": f"kube_scheduler_simulator_tpu_torch/csrc/{sources[name]}",
        "replaces": f"kube_scheduler_simulator_tpu/parallel/speculative.py:{replaces[name]}",
        "launches": launches[name],
        "max_abs_err": errs[name],
        "ms": ms[name],
        "plain_ms": plain[name],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        "library_ms": library.get(name),
    } for name in ms]


# the default profile's further plugins, fused into the kernels: group ->
# (plugins, source, the JAX function it replaces)
B9_GROUPS = {
    "B9a": (("NodeUnschedulable", "NodeName"), "taints.cuh",
            "kube_scheduler_simulator_tpu/plugins/taints.py:139"),
    "B9b": (("NodePorts",), "ports.cuh", "kube_scheduler_simulator_tpu/plugins/ports.py:152"),
    "B9c": (("ImageLocality",), "pod.cuh",
            "kube_scheduler_simulator_tpu/plugins/imagelocality.py:109"),
    "B9d": (("VolumeZone",), "volumes.cuh",
            "kube_scheduler_simulator_tpu/plugins/volumezone.py:97"),
    "B9e": (("NodeVolumeLimits",), "volumes.cuh",
            "kube_scheduler_simulator_tpu/plugins/nodevolumelimits.py:125"),
    "B9f": (("VolumeRestrictions",), "volumes.cuh",
            "kube_scheduler_simulator_tpu/plugins/volumerestrictions.py:173"),
    "B9g": (("VolumeBinding",), "volumes.cuh",
            "kube_scheduler_simulator_tpu/plugins/volumebinding.py:222"),
}
SAFE_PLUGINS = ("NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
                "TaintToleration", "NodeUnschedulable", "NodeName", "ImageLocality", "NodePorts")


def default_profile_phases(dev, card: str) -> list[dict]:
    """Phases 10-12: the scheduler's default profile.  10: every B9 row of
    step_chunk at full width, and spec_eval / spec_round /
    spec_commit_bind on the SAFE-set fleet, against the plain versions;
    11: the default-profile fleet through compile and replay (B1 with B9
    fused in), held to the plain replay; 12: the SAFE-set stream, held to
    its scan.  -> ({"default": (the fleet, its host-resident replay),
    "safe": (the SAFE-set fleet, its host-resident stream), "decode_ms":
    phase 11's Python-encoder ms per pod}, the B9 entries of the JSON
    line)."""
    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch.framework import pipeline
    from kube_scheduler_simulator_tpu_torch.framework.pipeline import PACK_MODES, build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import (
        ReplayResult, _CompactChunks, _clone_carry, _compact_plan, replay)
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
    from kube_scheduler_simulator_tpu_torch.models import (
        baseline_config, make_slot_pinned_workload)
    from kube_scheduler_simulator_tpu_torch.parallel import replay_speculative_stream
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.state import compile_workload
    from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result

    kernels = (*kspec.KERNELS, kstep.step_chunk)

    def counts() -> dict:
        return {f.__name__: f.launches for f in kernels}

    def reset() -> None:
        for f in kernels:
            f.launches = 0

    group_of = {name: g for g, (names, _, _) in B9_GROUPS.items() for name in names}
    errs = {g: 0 for g in B9_GROUPS}

    # ---- 10. B9 == plain at full width
    t10 = time.perf_counter()
    dnodes, dpods, _ = baseline_config(CONFIG, scale=1.0, seed=SEED)
    volumes, bound_pods = decorate_default_profile(dnodes, dpods, SEED)
    t0 = time.perf_counter()
    dcw = compile_workload(dnodes, dpods, PluginSetConfig(), volumes=volumes,
                           bound_pods=bound_pods, device=dev)
    torch.cuda.synchronize()
    dcompile_s = time.perf_counter() - t0
    p, n = dcw.n_pods, dcw.n_nodes
    step_full = build_step(dcw, out_mode="full")
    xs0 = batch_xs(dcw, 0, CHUNK)
    ck, ok_ = kstep.step_chunk(step_full, _clone_carry(dcw.init_carry), xs0)
    cp, op_ = step_full.plain_scan(_clone_carry(dcw.init_carry), xs0)
    torch.cuda.synchronize()
    rows = 0
    for field, names in (("filter_codes", step_full.filter_names),
                         ("score_raw", step_full.score_names),
                         ("score_final", step_full.score_names)):
        a, b = getattr(ok_, field), getattr(op_, field)
        for k, name in enumerate(names):
            err = tree_err(a[:, k], b[:, k])
            check(err == 0, f"default profile {field}[{name}] differs from the plain step "
                            f"(max |d| {err})")
            rows += 1
            if name in group_of:
                errs[group_of[name]] = max(errs[group_of[name]], err)
    for field in ("selected", "feasible_count", "prefilter_reject"):
        check(tree_err(getattr(ok_, field), getattr(op_, field)) == 0,
              f"default profile {field} differs from the plain step")
    for key in ck:
        err = tree_err(ck[key], cp[key])
        check(err == 0, f"default profile carry {key} differs from the plain step")
        if key in group_of:
            errs[group_of[key]] = max(errs[group_of[key]], err)
    rejected0 = int((op_.prefilter_reject != 0).sum())
    del ck, cp, ok_, op_

    snodes, spods = make_slot_pinned_workload(SLOT_PODS, SLOT_NODES, seed=SEED)
    decorate_default_profile(snodes, spods, SEED, volumes_on=False)
    t0 = time.perf_counter()
    scw = compile_workload(snodes, spods, PluginSetConfig(enabled=list(SAFE_PLUGINS)),
                           device=dev)
    torch.cuda.synchronize()
    scompile_s = time.perf_counter() - t0
    spm, ssd, _ = _compact_plan(scw, None)
    sstep = build_step(scw, out_mode="compact", pack_mode=spm, score_dtypes=ssd)
    scarry = _clone_carry(scw.init_carry)
    spec_err = {}
    for lo in (0, SPEC_BATCH):
        sxs = batch_xs(scw, lo, SPEC_BATCH)
        got = kspec.spec_round(sstep, scarry, sxs, KCAND)
        spec_err["spec_round"] = max(spec_err.get("spec_round", 0), tree_err(
            got, kspec.sparse_round_plain(sstep, scarry, sxs, KCAND)))
        ev = kspec.spec_eval(sstep, scarry, sxs)
        spec_err["spec_eval"] = max(spec_err.get("spec_eval", 0), tree_err(
            ev, kspec.eval_plain(sstep, scarry, sxs)))
        k = int(kspec.spec_oracle(got[0], got[1], got[7]))
        want = kspec.commit_plain(sstep, _clone_carry(scarry), sxs, got[7], k)
        scarry = kspec.spec_commit_bind(sstep, scarry, sxs, got[7], k)
        spec_err["spec_commit_bind"] = max(spec_err.get("spec_commit_bind", 0),
                                           tree_err(scarry, want))
    for name, err in spec_err.items():
        check(err == 0, f"SAFE set: {name} differs from its plain version (max |d| {err})")
    for g in ("B9a", "B9b", "B9c"):
        errs[g] = max(errs[g], *spec_err.values())
    torch.cuda.synchronize()
    print(f"[10 default profile kernels==plain] default-profile fleet {p}x{n} (compile "
          f"{dcompile_s:.3f} s, {len(bound_pods)} bound pods, {len(volumes['pvs'])} PVs): "
          f"step_chunk chunk 0 in full mode, {rows} plugin rows ({len(step_full.filter_names)} "
          f"filters, {len(step_full.score_names)} scorers), selections, PreFilter rejects "
          f"({rejected0} in the chunk) and every carry equal; SAFE-set fleet "
          f"{scw.n_pods}x{scw.n_nodes} (compile {scompile_s:.3f} s): spec_round, spec_eval, "
          f"spec_commit_bind at batch {SPEC_BATCH} over two rounds equal; max_abs_err "
          f"{errs} {spec_err}; {time.perf_counter() - t10:.1f} s", flush=True)

    # ---- 11. the default profile's main path: compile -> replay (B1 + B9)
    t11 = time.perf_counter()
    reset()
    t0 = time.perf_counter()
    with env(KSS_TPU_HOST_RESIDENT="1"):
        drr = replay(dcw, chunk=CHUNK, device="cuda")
    torch.cuda.synchronize()
    dwall_s = time.perf_counter() - t0
    main_counts = counts()
    n_chunks = math.ceil(p / CHUNK)
    check(main_counts["step_chunk"] == n_chunks * len(drr.tiers),
          f"default profile: step_chunk launches {main_counts['step_chunk']}")
    wide = drr.tiers[-1]
    pack_mode, score_dtypes, _ = _compact_plan(dcw, wide)
    check(pack_mode == drr._compact.pack_mode, "pack mode")
    dstep = build_step(dcw, out_mode="compact", pack_mode=pack_mode,
                       score_dtypes=score_dtypes, wide_raw=wide)
    # the first pod of each kind, from the replay's packed words
    col = {name: k for k, name in enumerate(dcw.config.filters())}
    _, code_bits, ff_bits = PACK_MODES[pack_mode]
    first: dict[str, int] = {}
    for ci, packed in enumerate(drr._compact.packed):
        w = packed[:min(CHUNK, p - ci * CHUNK)].astype(np.int64)
        ff, code = (w >> code_bits) & ((1 << ff_bits) - 1), w & ((1 << code_bits) - 1)
        for kind, hit in (("NodePorts conflict", ff == col["NodePorts"] + 1),
                          ("VolumeBinding bind conflict",
                           (ff == col["VolumeBinding"] + 1) & ((code & 2) != 0)),
                          ("NodeVolumeLimits rejection", ff == col["NodeVolumeLimits"] + 1),
                          ("VolumeZone conflict", ff == col["VolumeZone"] + 1)):
            rows_hit = np.flatnonzero(hit.any(axis=1))
            if kind not in first and len(rows_hit):
                first[kind] = ci * CHUNK + int(rows_hit[0])
    for kind, bit in (("static PreFilter reject", 2), ("ReadWriteOncePod reject", 1)):
        hit = np.flatnonzero(drr.prefilter_reject & bit)
        if len(hit):
            first[kind] = int(hit[0])
    for kind in ("static PreFilter reject", "NodePorts conflict", "VolumeBinding bind conflict",
                 "NodeVolumeLimits rejection"):
        check(kind in first, f"default profile: no pod with a {kind}")
    check_chunks = sorted({0, 1} | {i // CHUNK for i in first.values()})

    # the same chunk loop, kernel launches between CUDA events (device
    # time); at the checked chunks the plain step runs from the same carry
    carry = _clone_carry(dcw.init_carry)
    plain_chunks = _CompactChunks(chunk=CHUNK, pack_mode=pack_mode,
                                  score_cols=drr._compact.score_cols)
    psel, pfc, prej = (drr.selected.copy(), drr.feasible_count.copy(),
                       drr.prefilter_reject.copy())
    events = []
    for ci in range(n_chunks):
        lo = ci * CHUNK
        m = min(CHUNK, p - lo)
        xs = batch_xs(dcw, lo, CHUNK)
        before = _clone_carry(carry) if ci in check_chunks else None
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        carry, out = dstep.scan(carry, xs)
        e1.record()
        events.append((e0, e1))
        for grp in _CompactChunks.GROUPS:
            getattr(plain_chunks, grp).append(drr._compact.host(grp, ci))
        if before is None:
            continue
        pc, pout = dstep.plain_scan(before, xs)
        host = {f: getattr(out, f).cpu().numpy() for f in out._fields}
        phost = {f: getattr(pout, f).cpu().numpy() for f in pout._fields}
        for f in ("selected", "feasible_count", "prefilter_reject", "packed_filter",
                  "raw8", "raw16", "raw32", "raw_overflow"):
            check(host[f].tobytes() == phost[f].tobytes(),
                  f"default profile chunk {ci}: {f} differs from the plain step")
        for grp, f in (("packed", "packed_filter"), ("raw8", "raw8"), ("raw16", "raw16"),
                       ("raw32", "raw32")):
            check(drr._compact.host(grp, ci).tobytes() == host[f].tobytes(),
                  f"default profile chunk {ci}: replay's {grp} differs from the relaunch")
            getattr(plain_chunks, grp)[ci] = phost[f]
        check(tree_err(carry, pc) == 0, f"default profile chunk {ci}: carry differs")
        psel[lo:lo + m] = phost["selected"][:m]
        pfc[lo:lo + m] = phost["feasible_count"][:m]
        prej[lo:lo + m] = phost["prefilter_reject"][:m]
    torch.cuda.synchronize()
    ddevice_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    rr_plain = ReplayResult(cw=dcw, selected=psel, feasible_count=pfc, prefilter_reject=prej,
                            compact=plain_chunks)
    for what in ("selected", "feasible_count", "prefilter_reject"):
        check((getattr(rr_plain, what) == getattr(drr, what)).all(),
              f"default profile: {what} differs from the plain path")
    sample = sorted(set(first.values()) | {0, 1, CHUNK - 1, CHUNK, 2 * CHUNK - 1})
    with env(KSS_TPU_DISABLE_NATIVE="1"):  # the Python encoder, as phase 16 compares
        t0 = time.perf_counter()
        anns = {i: decode_pod_result(drr, i) for i in sample}
        decode_ms = (time.perf_counter() - t0) * 1e3 / len(sample)
    for i in sample:
        check(sorted(anns[i]) == sorted(ALL_PLUGIN_KEYS), f"pod {i}: annotation keys")
        check(anns[i] == decode_pod_result(rr_plain, i),
              f"default profile pod {i}: annotations differ from the plain path")
        want = dcw.node_table.names[drr.selected[i]] if drr.selected[i] >= 0 else ""
        check(anns[i]["kube-scheduler-simulator.sigs.k8s.io/selected-node"] == want,
              f"pod {i}: selected-node annotation")
    for kind in ("static PreFilter reject", "ReadWriteOncePod reject"):
        if kind in first:
            pf = json.loads(anns[first[kind]]["kube-scheduler-simulator.sigs.k8s.io/"
                                              "prefilter-result-status"])
            check("VolumeRestrictions" in pf or "VolumeBinding" in pf, f"{kind}: {pf}")
    ms_launch = ddevice_s * 1e3 / n_chunks
    print(f"[11 default profile main path] {p} pods x {n} nodes, PluginSetConfig() "
          f"({len(dcw.config.filters())} filters, {len(dcw.config.scorers())} scorers): "
          f"scheduled {drr.scheduled}, PreFilter-rejected {int((drr.prefilter_reject != 0).sum())}; "
          f"compile {dcompile_s:.3f} s; device {ddevice_s:.4f} s; wall {dwall_s:.4f} s = "
          f"{p / dwall_s:.1f} cycles/s; step_chunk {ms_launch:.3f} ms per launch; launches "
          f"{main_counts['step_chunk']} = {n_chunks} chunks x {len(drr.tiers)} tier(s) "
          f"{list(drr.tiers)}; chunks {check_chunks} equal to the plain step from the same carry "
          f"(0-1 the plain replay from the start: selected, feasible_count, prefilter_reject, "
          f"compact bytes, carry); first pods {first}; annotations equal for pods {sample}; "
          f"decode_pod_result {decode_ms:.3f} ms/pod (Python encoder); "
          f"{time.perf_counter() - t11:.1f} s",
          flush=True)

    # ---- 12. the SAFE-set stream against its scan
    t12 = time.perf_counter()
    reset()
    t0 = time.perf_counter()
    srr, sstats = replay_speculative_stream(scw, chunk=CHUNK, device_resident=False)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_counts = counts()
    check(sstats["rounds"] > 0 and sstats["accepted"] > 0, f"SAFE-set stream stats {sstats}")
    for name in ("spec_oracle", "spec_commit_bind", "grid_append"):
        check(stream_counts[name] > 0, f"the SAFE-set stream launched no {name}")
    check(stream_counts["spec_round"] + stream_counts["spec_eval"] > 0,
          "the SAFE-set stream launched no round kernel")
    check(stream_counts["spec_commit_core"] == 0,
          "the SAFE-set stream took the core-only commit with a NodePorts carry")
    t0 = time.perf_counter()
    sbase = replay(scw, chunk=CHUNK, device=dev)
    torch.cuda.synchronize()
    sscan_s = time.perf_counter() - t0
    sp = scw.n_pods
    ssample = sorted(set(range(0, sp, sp // 8)) | {1, CHUNK - 1, CHUNK, sp - 1})
    same_replay(srr, sbase, "SAFE-set stream vs scan", ssample)
    print(f"[12 SAFE-set stream] slot-pinned {sp}x{scw.n_nodes}, {'+'.join(SAFE_PLUGINS)}, "
          f"chunk {CHUNK}: stats {json.dumps(sstats)}; stream {stream_s:.4f} s = "
          f"{sp / stream_s:.1f} cycles/s; scan {sscan_s:.4f} s = {sp / sscan_s:.1f} cycles/s; "
          f"scheduled {srr.scheduled}; selected, feasible_count, prefilter_reject, compact "
          f"bytes (raws at feasible nodes) and decode bytes of pods {ssample} equal to the "
          f"scan; launches {stream_counts}; {time.perf_counter() - t12:.1f} s", flush=True)

    # ---- the B9 entries: each group's share of step_chunk on chunk 0 of
    # the default fleet (the launch with the group's plugins against the
    # same launch without them), its plain functions on the same pods, and
    # the bytes its rows and carry need
    xs0 = batch_xs(dcw, 0, CHUNK)
    reps = 3

    def kernel_ms(step) -> float:
        carries = [_clone_carry(dcw.init_carry) for _ in range(reps + 1)]
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        step.scan(carries[0], xs0)
        marks[0].record()
        for k in range(reps):
            step.scan(carries[k + 1], xs0)
            marks[k + 1].record()
        torch.cuda.synchronize()
        ts = sorted(marks[k].elapsed_time(marks[k + 1]) for k in range(reps))
        return ts[len(ts) // 2]

    full_ms = kernel_ms(dstep)
    entries = []
    for g, (names, source, replaces) in B9_GROUPS.items():
        without = build_step(dcw, out_mode="compact", pack_mode=pack_mode,
                             score_dtypes=score_dtypes, wide_raw=wide)
        keep = [k for k, nm in enumerate(without.score_names) if nm not in names]
        without.filter_names = [nm for nm in without.filter_names if nm not in names]
        without.score_names = [without.score_names[k] for k in keep]
        without.weights = [without.weights[k] for k in keep]
        without.score_dtypes = tuple(without.score_dtypes[k] for k in keep)
        g_ms = full_ms - kernel_ms(without)
        carry0 = _clone_carry(dcw.init_carry)
        filters = [nm for nm in names if nm in step_full.filter_names]
        scorers = [nm for nm in names if nm in step_full.score_names]
        feas = torch.ones(n, dtype=torch.bool, device=dev)

        def plain_group():
            for i in range(CHUNK):
                sl = pipeline.slice_pod(xs0, i)
                for nm in filters:
                    pipeline._filter_one(nm, dcw, carry0, sl)
                for nm in scorers:
                    pipeline._score_one(nm, dcw, carry0, sl, feas)

        plain_ms = timed_once(plain_group)
        nbytes = sum(t.numel() * t.element_size()
                     for nm in names for tree in (xs0.get(nm), dcw.statics.get(nm))
                     if tree is not None for t in _leaves(tree))
        nbytes += sum(2 * t.numel() * t.element_size()
                      for nm in names if nm in dcw.init_carry
                      for t in _leaves(dcw.init_carry[nm]))
        b_ms, b_by = bound(nbytes)
        entries.append({
            "name": f"step_chunk[{g} {'+'.join(names)}]",
            "route": "cuda",
            "source": f"kube_scheduler_simulator_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": main_counts["step_chunk"],
            "max_abs_err": errs[g],
            "ms": g_ms,
            "plain_ms": plain_ms,
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        })
    print(f"[13 default profile timing] {card}: step_chunk {full_ms:.3f} ms on chunk 0 of the "
          f"default fleet (median of {reps}); per B9 group, its share of that launch "
          f"(ms without it subtracted), plain ms and bound ms: "
          f"{ {e['name']: (round(e['ms'], 3), round(e['plain_ms'], 3), e['bound_ms']) for e in entries} }",
          flush=True)
    ctx = {"default": (dcw, drr), "safe": (scw, srr), "decode_ms": decode_ms}
    return ctx, entries


def extend_resources(nodes: list, pods: list, seed: int, k: int = 16) -> None:
    """Give every node k extended resources (0-3 each) and a third of the
    pods a request of 2 of one, from a numpy generator on `seed`:
    NodeResourcesFit's filter code then needs k + 4 bits, so the compact
    pack is p64."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for nd in nodes:
        for j in range(k):
            nd["status"]["allocatable"][f"example.com/dev-{j}"] = str(int(rng.integers(0, 4)))
    for i, pod in enumerate(pods):
        if i % 3 == 0:
            pod["spec"]["containers"][0]["resources"].setdefault("requests", {})[
                f"example.com/dev-{int(rng.integers(k))}"] = "2"


def result_path_phases(dev, card: str, cw, pods: list, rr, spec_ctx: dict,
                       dp_ctx: dict) -> dict:
    """Phases 14-17: the default result path.  14: B7 against its plain
    version on four chunks; 15: config 5 (then the default-profile fleet)
    through replay() with default arguments, device-resident, against
    phase 4's (phase 11's) host-resident replay, and under a 64 MB
    retention budget; 16: the native chunk decode against the Python
    encoder; 17: the slot-pinned and SAFE-set streams with
    device_resident=True against phases 7 and 12.  -> B7's entry of the
    JSON line."""
    import numpy as np
    import torch

    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import (
        _DEVICE_BUDGET, _clone_carry, _compact_plan, _DeviceAttribution, _slice_xs,
        plugin_attribution, replay)
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
    from kube_scheduler_simulator_tpu_torch.kernels.attribution import (
        chunk_attribution, chunk_attribution_plain)
    from kube_scheduler_simulator_tpu_torch.parallel import replay_speculative_stream
    from kube_scheduler_simulator_tpu_torch.store import decode_pod_result, decode_release_batches
    from kube_scheduler_simulator_tpu_torch.store.decode import _decode_path_label

    # ---- 14. B7 == its plain version, exactly, in the plan's shape and
    # in each forced one
    t14 = time.perf_counter()
    dcw, drr = dp_ctx["default"]
    cases = att_cases(cw, rr.tiers[-1], dcw, drr.tiers[-1])
    att_err, att_info, att_t = 0, {}, {}
    for name, (ctx, out, pm) in cases.items():
        args = att_args(ctx, out)
        want = chunk_attribution_plain(*args)
        att_t[name], err = att_times(args, want)
        att_err = max(att_err, err)
        att_info[name] = (pm, str(out.raw32.dtype).replace("torch.", ""),
                          int(want["f_rejects"].sum()) if "f_rejects" in want else 0,
                          att_bound(ctx, out, want)[0], att_sector_bytes(ctx, out))
    torch.cuda.synchronize()
    ctx, out, _ = cases["config5"]
    args = att_args(ctx, out)
    att_ms = att_t["config5"]["ms"]
    att_call_ms = timed(lambda: chunk_attribution(*args), 20)
    att_plain_ms = timed_once(lambda: chunk_attribution_plain(*args))
    att_bound_ms, att_bound_by, att_bytes, raw_bytes = att_bound(
        ctx, out, chunk_attribution_plain(*args))
    print(f"[14 B7==plain] {card}: chunk_attribution on chunk 0 of config {CONFIG}, of the "
          f"default-profile fleet (host score columns: the feasibility bitmap), of "
          f"{CHUNK} config-{CONFIG} pods on nodes with 16 extended resources, and of config "
          f"{CONFIG} at the i64 tier, in the plan's shape and every forced (W warps a pod, P "
          f"pods a CTA) {list(ATT_SHAPES)}: (pack, raw32 dtype, rejects, bound ms, bytes in 32-byte "
          f"sectors) {att_info}; "
          f"max_abs_err {att_err}; ms per launch (CUDA graph) "
          + "; ".join(f"{k}: plan {t['shape']} {t['ms']:.5f}, best {t['best']} "
                      f"{t['forced'][t['best']]:.5f}"
                      + (" FLAG: the plan is over 10 % slower than the best" if t["slow"] else "")
                      for k, t in att_t.items())
          + f"; config {CONFIG} forced {att_t['config5']['forced']}; {att_call_ms:.5f} ms per "
          f"wrapper call back to back, plain {att_plain_ms:.3f} ms, bound {att_bound_ms:.6f} ms "
          f"by {att_bound_by} ({att_bytes} B: packed + the {raw_bytes} B of raws scored at "
          f"feasible nodes); {time.perf_counter() - t14:.1f} s", flush=True)
    del cases

    kernels = (kstep.step_chunk, chunk_attribution)

    def reset() -> None:
        for f in kernels:
            f.launches = 0

    def counts() -> dict:
        return {f.__name__: f.launches for f in kernels}

    def held(got, want, want_att: dict, what: str, sample) -> None:
        for f in ("selected", "feasible_count", "prefilter_reject"):
            check((getattr(got, f) == getattr(want, f)).all(), f"{what}: {f}")
        check(plugin_attribution(got) == want_att, f"{what}: attribution")
        for i in sample:
            check(decode_pod_result(got, i) == decode_pod_result(want, i),
                  f"{what}: pod {i} annotations")

    # ---- 15. config 5 through replay(cw) with default arguments
    t15 = time.perf_counter()
    p, n = cw.n_pods, cw.n_nodes
    n_chunks = math.ceil(p / CHUNK)
    with env(KSS_TPU_HOST_RESIDENT=None, KSS_TPU_EAGER_DECODE=None,
             KSS_TPU_DEVICE_RESULT_BUDGET_MB=None):
        reset()
        t0 = time.perf_counter()
        drr15 = replay(cw)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
        main = counts()
    cc = drr15._compact
    check(main["step_chunk"] == n_chunks * len(drr15.tiers) and main["chunk_attribution"]
          == n_chunks * len(drr15.tiers), f"config {CONFIG} default replay launches {main}")
    check(all(cc.is_device(ci) for ci in range(len(cc.packed))), "a chunk is not retained")
    retained = sum(cc.device_nbytes(ci) for ci in range(len(cc.packed)))
    d2h_dev, d2h_host = np.mean(cc.d2h_bytes), np.mean(rr._compact.d2h_bytes)
    att15 = plugin_attribution(drr15)
    check(cc.materialized == 0, "the attribution fold fetched a chunk")
    att4 = plugin_attribution(rr)  # phase 4's host tally
    check(att15 == att4, "device fold != phase 4's host tally")
    for f in ("selected", "feasible_count", "prefilter_reject"):
        check((getattr(drr15, f) == getattr(rr, f)).all(), f"default replay: {f} != phase 4")
    sample = sorted(set(range(0, p, p // 8)) | {1, CHUNK - 1, CHUNK, p - 1})
    for i in sample:
        check(decode_pod_result(drr15, i) == decode_pod_result(rr, i),
              f"default replay: cold read of pod {i} != phase 4")
    cold = cc.materialized
    check(cold == len({i // CHUNK for i in sample}), f"{cold} chunk fetches for the sample")
    # device-only time: the same launches (step + B7 per chunk) between events
    wide = drr15.tiers[-1]
    pm, sd, cols = _compact_plan(cw, wide)
    step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd, wide_raw=wide)
    actx = _DeviceAttribution(cw, CHUNK, pm, cols)
    carry = _clone_carry(cw.init_carry)
    spans = []
    for lo in range(0, p, CHUNK):
        xs = _slice_xs(cw.xs, lo, min(lo + CHUNK, p), CHUNK)
        xs["is_pad"] = torch.arange(CHUNK, device=dev) >= min(CHUNK, p - lo)
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        carry, out = step.scan(carry, xs)
        actx.run(out, lo)
        e1.record()
        spans.append((e0, e1))
    torch.cuda.synchronize()
    device_s = sum(a.elapsed_time(b) for a, b in spans) / 1e3
    del carry, out, spans
    # under a 64 MB retention budget: chunks spill on the background thread
    with env(KSS_TPU_HOST_RESIDENT=None, KSS_TPU_EAGER_DECODE=None,
             KSS_TPU_DEVICE_RESULT_BUDGET_MB="64"):
        spilled0 = _DEVICE_BUDGET.spilled
        brr = replay(cw)
        _DEVICE_BUDGET.drain()
    spilled = _DEVICE_BUDGET.spilled - spilled0
    b_left = sum(brr._compact.device_nbytes(ci) for ci in range(len(brr._compact.packed)))
    check(spilled > 0 and b_left <= 64 << 20, f"budget 64 MB: {spilled} spilled, {b_left} B left")
    held(brr, rr, att4, "budget 64 MB vs phase 4", sample[:4])
    del brr
    # the default-profile fleet, the same way, against phase 11
    with env(KSS_TPU_HOST_RESIDENT=None, KSS_TPU_EAGER_DECODE=None,
             KSS_TPU_DEVICE_RESULT_BUDGET_MB=None):
        reset()
        t0 = time.perf_counter()
        dprr = replay(dcw)
        torch.cuda.synchronize()
        dwall_s = time.perf_counter() - t0
        dmain = counts()
    dp = dcw.n_pods
    check(all(dprr._compact.is_device(ci) for ci in range(len(dprr._compact.packed))),
          "default profile: a chunk is not retained")
    dsample = sorted({0, 1, CHUNK - 1, CHUNK, dp // 2, dp - 1})
    held(dprr, drr, plugin_attribution(drr), "default profile default replay vs phase 11",
         dsample)
    print(f"[15 default rung] {card}: config {CONFIG} {p}x{n} replay(cw): wall {wall_s:.4f} s = "
          f"{p / wall_s:.1f} cycles/s; device-only (step_chunk + B7) {device_s:.4f} s, idle "
          f"share {1 - device_s / wall_s:.4f}; launches {main}; D2H per chunk {d2h_dev:.1f} B "
          f"device-resident vs {d2h_host:.1f} B host-resident (phase 4); retained on the device "
          f"{retained} B in {len(cc.packed)} chunks; selections, feasible counts, PreFilter "
          f"rejects and plugin_attribution equal phase 4's (host tally), with no chunk fetched "
          f"for the attribution; cold reads of pods {sample} ({cold} chunk fetches) decode to "
          f"phase 4's bytes | KSS_TPU_DEVICE_RESULT_BUDGET_MB=64: {spilled} chunks spilled, "
          f"{b_left} B left on the device, reads equal | default-profile fleet {dp}x"
          f"{dcw.n_nodes} replay(dcw): wall {dwall_s:.4f} s = {dp / dwall_s:.1f} cycles/s; "
          f"launches {dmain}; equal to phase 11 (attribution, pods {dsample}); "
          f"{time.perf_counter() - t15:.1f} s", flush=True)
    del dprr

    # ---- 16. the native chunk decode, first and last chunk of each fleet
    t16 = time.perf_counter()
    lines = []
    for name, w_rr, py_ms in ((f"config {CONFIG}", drr15, dp_ctx["decode_ms"][4]),
                              ("default profile", drr, dp_ctx["decode_ms"][11])):
        check(_decode_path_label(w_rr) == "native_chunk", f"{name}: decode path "
              f"{_decode_path_label(w_rr)}")
        wp = w_rr.cw.n_pods
        last = (wp - 1) // CHUNK * CHUNK
        checked, decoded, dt = [], 0, 0.0
        for lo in (0, last):
            hi = min(lo + CHUNK, wp)
            picks = {lo, lo + 1, (lo + hi) // 2, hi - 1}
            kept = {}

            def on_pod(i, a, picks=picks, kept=kept):
                nonlocal decoded
                decoded += 1
                if i in picks:
                    kept[i] = a  # the others are released as the batch goes

            w_rr._compact.host("packed", lo // CHUNK)  # the chunk's fetch is phase 15's cost
            t0 = time.perf_counter()
            decode_release_batches(w_rr, lo, hi, on_pod=on_pod)
            dt += time.perf_counter() - t0
            with env(KSS_TPU_DISABLE_NATIVE="1"):
                for i in sorted(picks):
                    check(kept[i] == decode_pod_result(w_rr, i),
                          f"{name}: pod {i} native != Python encoder")
            checked += sorted(picks)
        check(decoded == min(CHUNK, wp) + (wp - last), f"{name}: {decoded} pods decoded")
        lines.append(f"{name}: {decoded} pods in {dt:.3f} s = {dt * 1e3 / decoded:.3f} ms/pod "
                     f"native (Python encoder: {py_ms:.3f} ms/pod, phase "
                     f"{4 if name.startswith('config') else 11}); pods {checked} equal the "
                     f"Python "
                     f"encoder's bytes")
    print(f"[16 native decode] decode_release_batches, path native_chunk: {'; '.join(lines)}; "
          f"{time.perf_counter() - t16:.1f} s", flush=True)
    del drr15

    # ---- 17. the streams with device_resident=True
    t17 = time.perf_counter()
    lines = []
    for name, (scw, srr) in (("slot-pinned", spec_ctx["slot"]), ("SAFE-set", dp_ctx["safe"])):
        reset()
        t0 = time.perf_counter()
        vrr, vstats = replay_speculative_stream(scw, chunk=CHUNK, device_resident=True)
        torch.cuda.synchronize()
        s_wall = time.perf_counter() - t0
        launched = chunk_attribution.launches
        vcc = vrr._compact
        check(launched == len(vcc.packed), f"{name}: {launched} B7 launches for "
              f"{len(vcc.packed)} chunks")
        check(all(vcc.is_device(ci) for ci in range(len(vcc.packed))), f"{name}: not retained")
        check(plugin_attribution(vrr) == plugin_attribution(srr), f"{name}: attribution")
        sp = scw.n_pods
        same_replay(vrr, srr, f"{name} device-resident stream vs host-resident",
                    sorted({0, 1, CHUNK, sp - 1}))
        lines.append(f"{name} {sp}x{scw.n_nodes}: {vstats['rounds']} rounds, {s_wall:.4f} s = "
                     f"{sp / s_wall:.1f} cycles/s, B7 launches {launched} = chunks")
    print(f"[17 streams, device_resident=True] {'; '.join(lines)}; equal to phases 7 and 12 "
          f"(selections, compact bytes, attribution, sampled annotations); "
          f"{time.perf_counter() - t17:.1f} s", flush=True)

    return {
        "name": "chunk_attribution",
        "route": "cuda",
        "source": "kube_scheduler_simulator_tpu_torch/csrc/attribution.cu",
        "replaces": "kube_scheduler_simulator_tpu/framework/replay.py:1217",
        "launches": main["chunk_attribution"],
        "max_abs_err": att_err,
        "ms": att_ms,
        "plain_ms": att_plain_ms,
        "bound_ms": att_bound_ms,
        "bound_by": att_bound_by,
        "library_ms": None,
    }


class _Extender:
    """An in-process webhook extender for phase 21 on localhost: filter
    drops every node whose index is a multiple of 7; prioritize gives 10
    to every node whose index ends in 3."""

    def __init__(self):
        import threading
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                names = body.get("NodeNames") or []
                if self.path.endswith("/filter"):
                    resp = {"NodeNames": [nm for nm in names if int(nm[-5:]) % 7],
                            "FailedNodes": {nm: "vetoed by extender"
                                            for nm in names if int(nm[-5:]) % 7 == 0}}
                else:
                    resp = [{"Host": nm, "Score": 10 if nm.endswith("3") else 0}
                            for nm in names]
                data = json.dumps(resp).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join()


COMPILE_COUNTERS = ("node_table_reuse_total", "node_table_delta_patches_total",
                    "node_table_delta_rows_total", "node_table_builds_total",
                    "compile_requests_gathered_total")


def compile_split(tracer) -> dict:
    """The compile's spans since the tracer's last reset (seconds: the
    schema, the node table, the pods' requests, each plugin's build, the
    upload) and its five counters."""
    spans = tracer.summary()["spans"]
    totals = tracer.counter_totals()
    out = {k[len("compile."):]: round(v["total_seconds"], 4) for k, v in spans.items()
           if k.startswith("compile.")}
    out.update({k: totals.get(k, 0) for k in COMPILE_COUNTERS})
    return out


def _device_busy_s(prof) -> float:
    """Seconds of device activity (kernels and copies) a CUDA-only
    torch.profiler trace recorded; 0.0 when it recorded none."""
    total = 0.0
    for evt in prof.key_averages():
        t = getattr(evt, "self_device_time_total", None)
        if t is None:
            t = getattr(evt, "self_cuda_time_total", 0)
        total += float(t or 0)
    return total / 1e6


def engine_phases(dev, card: str, cw, nodes: list, pods: list, cfg, rr) -> list[dict]:
    """Phases 18-21: the scheduling engine.  18: B8 and B10 against their
    plain versions; 19: config 5 through SchedulerEngine.schedule_pending()
    on an ObjectStore, the default wave and the pinned scan, against
    phase 4's replay; 20: gangs at full width (B8 in every wave); 21: the
    host-interleaved path (B10) with a webhook extender and an AfterScore
    hook, against the same run on the CPU.  -> the entries of B8 and B10
    for the JSON line."""
    import copy

    import numpy as np
    import torch
    from torch import profiler

    from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
    from kube_scheduler_simulator_tpu_torch.framework import gang, pipeline
    from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
    from kube_scheduler_simulator_tpu_torch.kernels import gang as kgang
    from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
    from kube_scheduler_simulator_tpu_torch.kernels.attribution import chunk_attribution
    from kube_scheduler_simulator_tpu_torch.models import make_gang_workload
    from kube_scheduler_simulator_tpu_torch.plugins.coscheduling import (
        Coscheduling, ensure_podgroup_resource)
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.scheduler.debuggable import PluginExtender
    from kube_scheduler_simulator_tpu_torch.scheduler.extender import ExtenderService
    from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result
    from kube_scheduler_simulator_tpu_torch.store import annotations as ann
    from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

    kernels = (kstep.step_chunk, chunk_attribution, kspec.spec_eval, kspec.spec_oracle,
               kspec.spec_round, kspec.spec_commit_core, kspec.spec_commit_bind,
               kspec.grid_append, kspec.grid_emit, kgang.quorum_slice,
               kphased.phased_eval, kphased.renormalize_rows)

    def reset() -> None:
        for f in kernels:
            f.launches = 0

    def counts() -> dict:
        return {f.__name__: f.launches for f in kernels if f.launches}

    def fresh_store(objects: dict):
        store = ObjectStore()
        ensure_podgroup_resource(store)
        for res, items in objects.items():
            for obj in items:
                store.create(res, obj)  # create() deep-copies
        return store

    rng = np.random.default_rng(SEED)
    p, n = cw.n_pods, cw.n_nodes

    # ---- 18. B8 and B10 == their plain versions, at full width
    t18 = time.perf_counter()
    gn, gg = 10_000, 1_250
    gid, sel, already, min_member = gang_slice(rng, gn, gg, n)
    b8_t, b8_err = quorum_times((gid, sel, already, min_member), dev)
    b8_ms = b8_t["ms"]
    packed_dev = torch.from_numpy(np.concatenate([gid, sel, already, min_member])).to(dev)
    b8_plain_ms = timed_once(lambda: gang.quorum_slice_plain(
        packed_dev[:gn], packed_dev[gn:2 * gn], packed_dev[2 * gn:2 * gn + gg],
        packed_dev[2 * gn + gg:]))
    (b8_bound_ms, b8_bound_by), b8_bytes = b8_t["bound"], (2 * gn + 2 * gg + 2 * gg + gn) * 4
    absent = int((np.bincount(gid[gid >= 0], minlength=gg) == 0).sum())
    # groups that are not contiguous, and G past shared memory (the plan
    # takes the global path there)
    b8_more = {}
    for name, (sn, sg) in (("scattered", (gn, gg)), ("past shared", (gn, 100_000))):
        b8_more[name], err = quorum_times(scattered_slice(rng, sn, sg, n), dev)
        b8_err = max(b8_err, err)
    check(b8_t["path"] == "shared" and b8_more["past shared"]["path"] == "global",
          f"B8 paths {b8_t['path']}, {b8_more['past shared']['path']}")
    # the empty slice and no groups: answered without a launch; a small
    # slice whose groups are mostly absent
    before = kgang.quorum_slice.launches
    for args in ((gid[:0], sel[:0], already, min_member),
                 (gid, sel, already[:0], min_member[:0])):
        out = gang.quorum_slice(*args, device=dev)
        check(all(a.size == 0 or not a.any() for a in out), "B8 empty case")
    check(kgang.quorum_slice.launches == before, "B8 launched on an empty slice")
    small = (np.array([-1, 7, 7, -1, 3], np.int32), np.array([0, 4, -1, 2, 9], np.int32),
             rng.integers(0, 3, 12).astype(np.int32), rng.integers(1, 4, 12).astype(np.int32))
    for a, b in zip(gang.quorum_slice(*small, device=dev), gang.quorum_slice(*small, device="cpu")):
        check(a.dtype == b.dtype and (a == b).all(), "B8 absent-group case differs from plain")
    torch.cuda.synchronize()
    h2d_ms, d2h_ms, call_ms = b8_t["h2d_ms"], b8_t["d2h_ms"], b8_t["call_ms"]

    # B10 on config 5's 5,000 nodes: 64 pods bound through the phased
    # path, then 8 pods evaluated and renormalized against that carry
    ph, carry, xs_of = phased_carry(cw)
    pe_err = rn_err = 0
    norm = [s for s in cw.config.scorers() if s in pipeline.NORMALIZING]
    for i in range(64, 72):
        xs1 = xs_of(i)
        out, want = ph.eval(carry, xs1), ph.plain_eval(carry, xs1)
        err = tree_err(list(out), list(want))
        check(err == 0, f"phased_eval pod {i} differs from its plain version (max |d| {err})")
        pe_err = max(pe_err, err)
        scorers = list(cw.config.scorers())
        raws = want.score_raw.long() + torch.from_numpy(
            rng.integers(-3, 4, (len(scorers), n))).to(dev)
        sl = pipeline.slice_pod(xs1, 0)
        # a hook-edited feasibility, and none (no node scored)
        for feas in ((want.filter_codes == 0).all(0)
                     & torch.from_numpy(rng.random(n) < 0.8).to(dev),
                     torch.zeros(n, dtype=torch.bool, device=dev)):
            want_r = torch.stack([pipeline.renormalize_plain(nm, cw, carry, sl, raws[s], feas)
                                  for s, nm in enumerate(scorers)])
            for s, name in enumerate(scorers):  # one row a launch
                err = tree_err(pipeline.renormalize(name, ph, carry, xs1, raws[s], feas),
                               want_r[s])
                check(err == 0, f"renormalize_rows {name} pod {i} differs (max |d| {err})")
                rn_err = max(rn_err, err)
            rows = [s for s, nm in enumerate(scorers) if nm in pipeline.NORMALIZING]
            for g in (0, *kphased.RENORM_CTAS):  # every row at once, plan and forced G
                err = tree_err(kphased.renormalize_rows(ph.step, [scorers[s] for s in rows],
                                                        carry, xs1, raws[rows], feas, _ctas=g),
                               want_r[rows])
                check(err == 0, f"renormalize_rows pod {i} at G = {g} differs (max |d| {err})")
                rn_err = max(rn_err, err)
    torch.cuda.synchronize()
    xs1 = xs_of(64)
    want = ph.plain_eval(carry, xs1)
    feas = (want.filter_codes == 0).all(0)
    pe, err = phased_times(ph, carry, xs1)
    pe_err = max(pe_err, err)
    pe_ms, (pe_bound_ms, pe_bound_by) = pe["ms"], pe["bound"]
    pe_plain_ms = timed_once(lambda: ph.plain_eval(carry, xs1))
    # renormalize_rows at R = 1 to all of config 5's scorers with
    # ScoreExtensions, plan and forced G; phase 21 picks the JSON's R
    rn, err = renorm_times(ph, carry, xs1)
    rn_err = max(rn_err, err)
    sl64 = pipeline.slice_pod(xs1, 0)
    rn_plain = {r: timed_once(lambda t=t: [pipeline.renormalize_plain(
        nm, cw, carry, sl64, want.score_raw[cw.config.scorers().index(nm)].long(), feas)
        for nm in t["names"]]) for r, t in rn.items()}
    pe_bytes = phased_eval_bytes(cw, carry, xs1)
    print(f"[18 B8, B10==plain] {card}: quorum_slice on n={gn}, G={gg} ({absent} groups absent "
          f"from the slice, -1 runs between groups), on n={gn} scattered over G={gg} and over "
          f"G=100,000 (past shared memory), each at the plan's path and each forced one, the "
          f"empty slice, no groups and a small absent-group slice: max_abs_err {b8_err}; "
          f"plan path {b8_t['path']} {b8_ms:.5f} ms per launch (CUDA graph), forced "
          f"{b8_t.get('forced')}; H2D {h2d_ms:.4f} ms, D2H {d2h_ms:.4f} ms (page-locked: "
          f"{b8_t['pinned']}; medians), {call_ms:.4f} ms per numpy-to-numpy call; "
          + "; ".join(f"{k}: plan {t['path']} {t['ms']:.5f} ms, forced {t.get('forced')}"
                      for k, t in b8_more.items())
          + f"; plain {b8_plain_ms:.3f} ms; bound {b8_bound_ms:.6f} ms by {b8_bound_by} "
          f"({b8_bytes} B) "
          f"| config {CONFIG} {n} nodes, 8 pods after 64 phased binds: phased_eval and "
          f"renormalize_rows ({', '.join(norm)}; the others return their raws; a row a "
          f"launch, and every scorer in one launch at the plan's and each forced G, at an "
          f"edited feasibility and at none) max_abs_err {pe_err} and {rn_err} (phased_eval at "
          f"the plan's S and each forced S); phased_eval "
          f"at b=1: plan S={pe['S']} {pe_ms:.5f} ms per launch, forced "
          f"{', '.join(f'S={k} {v:.5f}' for k, v in pe['forced'].items())}, best S={pe['best']}"
          f"{' FLAG: the plan is over 10 % slower than the best' if pe['slow'] else ''}; plain "
          f"{pe_plain_ms:.3f} ms, bound {pe_bound_ms:.6f} ms by {pe_bound_by} ({pe_bytes} B); "
          f"renormalize_rows (plan G, forced G; plain; bound) "
          + "; ".join(f"R={r} {'+'.join(t['names'])}: plan G={t['S']} {t['ms']:.5f} ms, forced "
                      + ", ".join(f"G={g} {v:.5f}" for g, v in t["forced"].items())
                      + (" FLAG: the plan is over 10 % slower than the best" if t["slow"] else "")
                      + f"; plain {rn_plain[r]:.3f} ms; bound {t['bound'][0]:.7f} ms by "
                      f"{t['bound'][1]}" for r, t in rn.items())
          + f"; {time.perf_counter() - t18:.1f} s", flush=True)
    del carry

    # ---- 19. config 5 through the engine: ObjectStore -> schedule_pending()
    t19 = time.perf_counter()
    names = cw.node_table.names
    lines19, main19 = [], None
    for label, spec in (("default wave", None), ("KSS_TPU_SPECULATIVE=0", "0")):
        with env(KSS_TPU_SPECULATIVE=spec, KSS_TPU_HOST_RESIDENT=None,
                 KSS_TPU_EAGER_DECODE=None, KSS_TPU_DEVICE_RESULT_BUDGET_MB=None):
            store = fresh_store({"nodes": nodes, "pods": pods})
            engine = SchedulerEngine(store, plugin_config=cfg)
            order = [q["metadata"]["name"] for q in engine.pending_pods()]
            check(order == [q["metadata"]["name"] for q in pods],
                  "the engine's pending order is not the queue's")
            reset()
            TRACER.reset()
            with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                bound_n = engine.schedule_pending()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            launched = counts()
            busy = _device_busy_s(prof)
            spans = {k: round(v["total_seconds"], 4) for k, v in TRACER.summary()["spans"].items()
                     if k in ("compile_workload", "replay_and_decode_stream",
                              "commit_and_reflect", "commit_stream")}
            split = compile_split(TRACER)
        check(launched.get("step_chunk", 0) + launched.get("spec_eval", 0) > 0,
              f"engine ({label}) launched no step or wave kernel: {launched}")
        check(bound_n == rr.scheduled, f"engine ({label}) bound {bound_n}, replay {rr.scheduled}")
        by_name = {q["metadata"]["name"]: (q.get("spec") or {}).get("nodeName")
                   for q in store.list("pods", copy_objects=False)[0]}
        for i, q in enumerate(pods):
            s = int(rr.selected[i])
            check(by_name[q["metadata"]["name"]] == (names[s] if s >= 0 else None),
                  f"engine ({label}): pod {i} node differs from replay()")
        sample = sorted(set(range(0, p, p // 11)) | {p - 1})[:12]
        for i in sample:
            got_a = store.get("pods", pods[i]["metadata"]["name"])["metadata"]["annotations"]
            want_a = decode_pod_result(rr, i)
            for key in ALL_PLUGIN_KEYS:
                check(got_a.get(key) == want_a[key], f"engine ({label}): pod {i} {key}")
        engine.close()
        idle = f"{1 - busy / wall:.4f}" if busy > 0 else "not measured"
        if main19 is None:
            main19 = launched
        lines19.append(f"{label}: bound {bound_n}, wall {wall:.4f} s = {p / wall:.1f} cycles/s, "
                       f"device busy {busy:.4f} s, idle share {idle}, engine spans (s) {spans}, "
                       f"the compile's split (s) and counters {split}, launches {launched}")
        del store, engine
    print(f"[19 engine] {card}: config {CONFIG} {p}x{n} in an ObjectStore through "
          f"SchedulerEngine(store, plugin_config=cfg).schedule_pending(): {'; '.join(lines19)}; "
          f"every pod's spec.nodeName equals phase 4's replay() (the engine's pending order is "
          f"the queue's), the 13 annotations of pods {sample} read from the store equal its "
          f"decode; wall under a CUDA-only torch.profiler trace; "
          f"{time.perf_counter() - t19:.1f} s", flush=True)

    # ---- 20. gangs at full width: B8 in every wave
    t20 = time.perf_counter()
    families = GANG_FAMILIES
    gang_objects = {"nodes": nodes, "podgroups": [], "pods": []}
    members: dict[str, list[str]] = {}
    family_of: dict[str, str] = {}
    for fam, groups, size, mm in families:
        pgs, gpods = make_gang_workload(groups, size, min_member=mm, seed=SEED + 20,
                                        name_prefix=f"{fam}-gang")
        if fam == "park":  # two members of each group fit nowhere: below quorum
            for q in gpods:
                if q["metadata"]["name"].endswith(("006", "007")):
                    q["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "9999999m"
        for pg in pgs:
            family_of[pg["metadata"]["name"]] = fam
        for q in gpods:
            members.setdefault(q["metadata"]["labels"]["scheduling.x-k8s.io/pod-group"],
                               []).append(q["metadata"]["name"])
        gang_objects["podgroups"] += pgs
        gang_objects["pods"] += gpods
    gang_cfg = list(cfg.enabled) + ["Coscheduling"]
    runs20, lines20, main20 = [], [], None
    for label, pipeline_commit, spec in (("pipelined commit, default wave", True, None),
                                         ("sequential commit, default wave", False, None),
                                         ("pipelined commit, pinned scan", True, "0")):
        with env(KSS_TPU_SPECULATIVE=spec):
            store = fresh_store(gang_objects)
            engine = SchedulerEngine(store, plugin_config=PluginSetConfig(
                enabled=gang_cfg, custom={"Coscheduling": Coscheduling()}),
                pipeline_commit=pipeline_commit)
            reset()
            t0 = time.perf_counter()
            bound_n = engine.schedule_pending()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = counts()
        check(launched.get("quorum_slice", 0) > 0, f"gangs ({label}): B8 never launched")
        pods_now = {q["metadata"]["name"]: q for q in store.list("pods", copy_objects=False)[0]}
        parked = {k[1] for k in engine.gang_parked}
        tally = {"admitted": 0, "parked": 0, "rejected": 0}
        for gname, ms in members.items():
            fam = family_of[gname]
            placed = [pods_now[m]["spec"].get("nodeName") for m in ms]
            n_bound = sum(1 for x in placed if x)
            if fam == "quorum":
                check(n_bound == len(ms), f"gangs ({label}): {gname} did not admit")
                tally["admitted"] += 1
            elif fam == "park":
                check(n_bound == 0 and sum(m in parked for m in ms) == 6,
                      f"gangs ({label}): {gname} did not park its 6 feasible members")
                tally["parked"] += 1
            else:
                a = pods_now[ms[0]]["metadata"].get("annotations") or {}
                check(n_bound == 0 and "cannot reach quorum" in a.get(
                    ann.PRE_FILTER_STATUS_RESULT, ""), f"gangs ({label}): {gname} not rejected")
                tally["rejected"] += 1
        runs20.append(({k: q["spec"].get("nodeName") for k, q in pods_now.items()},
                       sorted(parked), bound_n))
        if main20 is None:
            main20 = launched
        lines20.append(f"{label}: bound {bound_n}, {tally}, parked pods {len(parked)}, wall "
                       f"{wall:.4f} s, B8 launches {launched.get('quorum_slice', 0)}, launches "
                       f"{launched}")
        engine.close()
        del store, engine
    check(runs20[0] == runs20[1] == runs20[2], "gang binds differ between the commit modes "
          "and the pinned scan")
    print(f"[20 gangs] {card}: {len(gang_objects['pods'])} pods in {len(members)} PodGroups on "
          f"config {CONFIG}'s {n} nodes, plugins {gang_cfg}: {'; '.join(lines20)}; binds "
          f"all-or-nothing per group and equal across the three runs; "
          f"{time.perf_counter() - t20:.1f} s", flush=True)

    # ---- 21. the host path: webhook extender + AfterScore hook (B10)
    t21 = time.perf_counter()
    host_pods = [copy.deepcopy(q) for q in pods[:HOST_PODS]]

    class Invert(PluginExtender):
        def after_score(self, pod, node_name, score):
            return 1000 - 3 * score

    ext = _Extender()
    try:
        snaps, lines21, flushes = [], [], []
        for device in ("cuda", "cpu"):
            store = fresh_store({"nodes": nodes, "pods": host_pods})
            engine = SchedulerEngine(store, plugin_config=cfg, device=device)
            engine.set_extenders(ExtenderService([{
                "urlPrefix": ext.url, "filterVerb": "filter", "prioritizeVerb": "prioritize",
                "weight": 2}]))
            engine.plugin_extenders = {"NodeAffinity": Invert()}
            reset()
            kphased.renormalize_rows.rows.clear()
            t0 = time.perf_counter()
            bound_n = engine.schedule_pending()
            if device == "cuda":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = counts()
            flushes.append(engine.renormalize_flushes)
            snaps.append((bound_n, {q["metadata"]["name"]: (
                q["spec"].get("nodeName"), q["metadata"].get("annotations"))
                for q in store.list("pods")[0]}))
            if device == "cuda":
                main21 = launched
                check(launched.get("phased_eval", 0) == len(host_pods),
                      f"host path: phased_eval launches {launched}")
                # one launch a flush, at most one flush a pod (no
                # AfterNormalize hook)
                check(0 < launched.get("renormalize_rows", 0) == flushes[0] <= len(host_pods),
                      f"host path: {launched.get('renormalize_rows', 0)} renormalize_rows "
                      f"launches for {flushes[0]} flushes of {len(host_pods)} pods")
                rows21 = dict(sorted(kphased.renormalize_rows.rows.items()))
                check(launched.get("spec_commit_bind", 0) == bound_n,
                      f"host path: {launched} for {bound_n} binds")
            else:
                check(not launched, f"the CPU run launched {launched}")
            lines21.append(f"device={device}: bound {bound_n}, {wall:.3f} s = "
                           f"{wall * 1e3 / len(host_pods):.3f} ms/pod")
            engine.close()
            del store, engine
    finally:
        ext.close()
    check(snaps[0] == snaps[1], "host path: the card's run differs from device='cpu'")
    check(flushes[0] == flushes[1], f"host path: flushes {flushes} on the card and the CPU")
    # renormalize_rows' entry: its time at phase 21's most frequent R
    r21 = min(max(rows21, key=rows21.get, default=1), max(rn))
    check(all(v[0] != names[0] for v in snaps[0][1].values()), "an extender-vetoed node won")
    print(f"[21 host path] {card}: {len(host_pods)} config-{CONFIG} pods on {n} nodes with a "
          f"webhook extender (filter, prioritize) and an AfterScore hook on NodeAffinity: "
          f"{'; '.join(lines21)}; launches on the card {main21}; renormalize_rows: "
          f"{flushes[0]} flushes (the CPU run's {flushes[1]}), launches by rows {rows21} (the "
          f"JSON entry times R = {r21}); "
          f"nodes and every annotation "
          f"(extender results included) equal; {time.perf_counter() - t21:.1f} s", flush=True)

    src = "kube_scheduler_simulator_tpu_torch/csrc/"
    return [
        {"name": "quorum_slice", "route": "cuda", "source": src + "gang.cu",
         "replaces": "kube_scheduler_simulator_tpu/framework/gang.py:195",
         "launches": main20.get("quorum_slice", 0), "max_abs_err": b8_err, "ms": b8_ms,
         "plain_ms": b8_plain_ms, "bound_ms": b8_bound_ms, "bound_by": b8_bound_by,
         "library_ms": None},
        {"name": "phased_eval", "route": "cuda", "source": src + "spec_eval.cu",
         "replaces": "kube_scheduler_simulator_tpu/framework/pipeline.py:446",
         "launches": main21.get("phased_eval", 0), "max_abs_err": pe_err, "ms": pe_ms,
         "plain_ms": pe_plain_ms, "bound_ms": pe_bound_ms, "bound_by": pe_bound_by,
         "library_ms": None},
        {"name": "renormalize_rows", "route": "cuda", "source": src + "phased.cu",
         "replaces": "kube_scheduler_simulator_tpu/framework/pipeline.py:198",
         "launches": main21.get("renormalize_rows", 0), "max_abs_err": rn_err,
         "ms": rn[r21]["ms"], "plain_ms": rn_plain[r21],
         "bound_ms": rn[r21]["bound"][0], "bound_by": rn[r21]["bound"][1], "library_ms": None},
    ]


FUSE_KS = (2, 4, 8)            # phase 22: sessions per fused sparse round
FUSE_K = 4                     # phase 22's JSON entry and phase 23's sessions
HTTP_SAMPLE = 256              # phase 24: pods read back per session
SESSION_WINDOW_MS = 200        # phases 23-24: the fuse window (KSS_TPU_FUSE_WINDOW_MS)
CONTENDED_WINDOW_MS = 1000     # phase 23's config-5 pair: their four rounds may meet
# phase 23's dense family: its label-coupled rounds cost the host an
# interaction walk per round, so its queues are cut to 2,048 pods
DENSE_PODS = 2048


def _session_state(mgr, sids, rrs, orders) -> dict:
    """Per session: every pod's nodeName, the bind order, and a digest of
    the wave's results (selections, feasible counts, PreFilter rejects and
    every compact chunk's bytes), from which the 13 annotations of every
    pod are decoded (decode is a function of those and the workload,
    which both arms compile from the same manifests)."""
    import hashlib

    out = {}
    for sid in sids:
        sess = mgr.get(sid, touch=False)
        nodes = {p["metadata"]["name"]: (p.get("spec") or {}).get("nodeName")
                 for p in sess.di.store.list("pods", copy_objects=False)[0]}
        h = hashlib.sha256()
        for rr in rrs[sid]:
            for a in (rr.selected, rr.feasible_count, rr.prefilter_reject):
                h.update(a.tobytes())
            cc = rr._compact
            for grp in cc.GROUPS:
                for ci in range(len(getattr(cc, grp))):
                    h.update(cc.host(grp, ci).tobytes())
        out[sid] = (nodes, list(orders[sid]), h.hexdigest())
    return out


def _spy_engine(sess, order: list) -> None:
    """Record the session engine's binds, in order (as tests/test_fuse.py)."""
    eng = sess.di.engine
    orig_batch, orig_bind = eng._commit_pod_batch, eng._bind

    def batch_spy(items):
        order.extend((ns, n, node) for ns, n, node in items if node)
        return orig_batch(items)

    def bind_spy(ns, n, node):
        order.append((ns, n, node))
        return orig_bind(ns, n, node)

    eng._commit_pod_batch = batch_spy
    eng._bind = bind_spy


def fuse_phases(dev, card: str, cw, nodes5: list, pods5: list, cfg5, spec_ctx: dict
                ) -> list[dict]:
    """Phases 22-24: multi-session serving and B11.  22: the fused round
    kernels on the slot-pinned fleet (K = 2, 4, 8 sparse) and config 5
    (K = 2 dense) against their plain versions and the K solo launches,
    with times and bounds; 23: K = 4 slot-pinned sessions of 10,000 pods
    each through SessionManager(device="cuda") and schedule_pending() at
    once, fused against KSS_TPU_FUSE=0, and two config-5 sessions whose
    first wave fuses and whose later waves are benched; 24: the HTTP
    server with two sessions, each importing the slot-pinned fleet and
    queue, read back against a direct replay().  -> the B11 entries of
    the JSON line."""
    import copy
    import threading
    import urllib.request

    import torch
    from torch import profiler

    from kube_scheduler_simulator_tpu_torch.framework.pipeline import PACK_MODES, build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import (
        _clone_carry, _compact_plan, replay)
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.models import make_slot_pinned_workload
    from kube_scheduler_simulator_tpu_torch.parallel import speculative as pspec
    from kube_scheduler_simulator_tpu_torch.parallel.fuse import FUSE, session_admitted
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.server.server import SimulatorServer
    from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager
    from kube_scheduler_simulator_tpu_torch.state import compile_workload
    from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result
    from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

    b11 = kfuse.KERNELS

    def reset() -> None:
        for f in b11:
            f.launches = 0
        for f in (kfuse.spec_eval_fused, kfuse.spec_round_fused):
            f.batches.clear()

    def counts() -> dict:
        return {f.__name__: f.launches for f in b11}

    def by_batch() -> dict:
        """The fused rounds' launches by (K sessions, b pods), "KxB"."""
        return {f.__name__: {f"{k}x{b}": v for (k, b), v in sorted(f.batches.items())}
                for f in (kfuse.spec_eval_fused, kfuse.spec_round_fused)}

    def nb(*xs) -> int:
        return sum(t.numel() * t.element_size() for x in xs for t in _leaves(x))

    # ---- 22. B11 alone: K members of one family, each its own batch of
    # the queue and its own carry (one committed batch in), as K sessions
    # with different pods over one fleet hold them
    t22 = time.perf_counter()
    scw = spec_ctx["slot"][0]
    spm, ssd, _ = _compact_plan(scw, None)
    sstep = build_step(scw, out_mode="compact", pack_mode=spm, score_dtypes=ssd)
    cpm, csd, _ = _compact_plan(cw, None)
    cstep = build_step(cw, out_mode="compact", pack_mode=cpm, score_dtypes=csd)

    def pairs_of(w, step, k: int, kcand):
        out = []
        for s in range(k):
            carry = _clone_carry(w.init_carry)
            xs0 = batch_xs(w, s * SPEC_BATCH, SPEC_BATCH)
            sel = (kspec.spec_round(step, carry, xs0, KCAND)[7] if kcand
                   else kspec.spec_eval(step, carry, xs0).selected)
            kspec.spec_commit(step, carry, xs0, sel, SPEC_BATCH // 2)
            out.append((carry, batch_xs(w, (s + 8) * SPEC_BATCH, SPEC_BATCH)))
        return out

    slot_pairs = pairs_of(scw, sstep, max(FUSE_KS), KCAND)
    dense_pairs = pairs_of(cw, cstep, 2, None)

    def members(step, pairs, kcand):
        return [kfuse.Member(step, c, x, kcand) for c, x in pairs]

    errs = {f.__name__: {"plain": 0, "solo": 0} for f in b11}

    def held(name: str, against: str, got, want) -> None:
        err = tree_err(got, want)
        errs[name][against] = max(errs[name][against], err)
        check(err == 0, f"{name} differs from {against} (max |d| {err})")

    # the plain rounds of the eight slot members and the two dense ones;
    # those of the JSON entries' K are timed as they run (each member's
    # solo plain round in turn, the oracle's included)
    slot_plain: list = []
    dense_plain: list = []
    plain_round = timed_once(lambda: slot_plain.extend(
        kfuse.round_plain(members(sstep, slot_pairs[:FUSE_K], KCAND))))
    slot_plain += kfuse.round_plain(members(sstep, slot_pairs[FUSE_K:], KCAND))
    plain_eval = timed_once(lambda: dense_plain.extend(
        kfuse.round_plain(members(cstep, dense_pairs, None))))
    lines22 = []
    timing: dict = {}
    reset()
    for k in FUSE_KS:
        ms_ = members(sstep, slot_pairs[:k], KCAND)
        fused = [tuple(t.clone() for t in _leaves(r)) for r in kfuse.sparse_round_fused(ms_)]
        solo = [tuple(t.clone() for t in _leaves(kfuse.sparse_round(m))) for m in ms_]
        plan_pods = kfuse.spec_round_fused.pods
        for i in range(k):
            held("spec_round_fused", "plain", fused[i][:8], _leaves(slot_plain[i])[:8])
            held("spec_round_fused", "solo", fused[i][:8], solo[i][:8])
            held("spec_oracle_fused", "plain", fused[i][8], _leaves(slot_plain[i])[8])
            held("spec_oracle_fused", "solo", fused[i][8], solo[i][8])
        for group in kspec.ROUND_PODS:  # every group size of the kernel
            forced = kfuse.spec_round_fused(members(sstep, slot_pairs[:k], KCAND), _pods=group)
            for i in range(k):
                held("spec_round_fused", "solo", forced[i], solo[i][:8])
        rows = [(r[0], r[1], r[7]) for r in fused]
        orc_ctas = kfuse.spec_oracle_fused.ctas
        for ctas in kspec.ORACLE_CTAS:  # every CTA count of the oracle's clusters
            forced = kfuse.spec_oracle_fused(members(sstep, slot_pairs[:k], KCAND), rows,
                                             _ctas=ctas)
            for i in range(k):
                held("spec_oracle_fused", "solo", forced[i], solo[i][8])
        pk = slot_pairs[:k]
        t_round = timed_graph(lambda: kfuse.spec_round_fused(members(sstep, pk, KCAND)), 3)
        t_round_solo = timed_graph(
            lambda: [kspec.spec_round(sstep, c, x, KCAND) for c, x in pk], 3)
        t_orc = timed_graph(lambda: kfuse.spec_oracle_fused(members(sstep, pk, KCAND), rows), 20)
        t_orc_solo = timed_graph(lambda: [kspec.spec_oracle(*r) for r in rows], 20)
        timing[k] = (t_round, t_round_solo, t_orc, t_orc_solo)
        lines22.append(f"K={k}: spec_round_fused (P={plan_pods}) {t_round:.4f} ms vs {k} solo "
                       f"spec_round "
                       f"{t_round_solo:.4f} ms; spec_oracle_fused (C={orc_ctas}) {t_orc:.5f} ms "
                       f"vs {k} solo "
                       f"{t_orc_solo:.5f} ms")
    # the table launch with B5's core folded in: K = 2 and 4 sessions,
    # folded and unfolded in turn, at the plan's CTAs and each forced count
    for k in FOLD_TABLE_KS:
        for ctas in (0, *kspec.ORACLE_CTAS):
            err = fold_table_err(kspec, kfuse, scw, sstep, k, SPEC_BATCH, SEED + k, PACK_MODES[spm][0],
                                 _ctas=ctas)
            errs["spec_oracle_fused"]["plain"] = max(errs["spec_oracle_fused"]["plain"], err)
            check(err == 0, f"spec_oracle_fused with folded commits differs from the plain "
                            f"oracle then commit_plain (K = {k}, {ctas} CTAs; max |d| {err})")
    lines22.append(f"spec_oracle_fused with the core commit folded in (K = "
                   f"{', '.join(map(str, FOLD_TABLE_KS))}, folded and unfolded sessions in "
                   f"turn, every CTA count) == the plain oracle then commit_plain, carry for "
                   f"carry")
    dm = members(cstep, dense_pairs, None)
    dfused = [tuple(t.clone() for t in _leaves(r)) for r in kfuse.dense_round_fused(dm)]
    held22 = by_batch()  # the launches held to the plain and solo rounds
    dsolo = [tuple(t.clone() for t in _leaves(kfuse.dense_round(m))) for m in dm]
    eval_shards = kfuse.spec_eval_fused.shards
    for i in range(2):
        held("spec_eval_fused", "plain", dfused[i][:-1], _leaves(dense_plain[i])[:-1])
        held("spec_eval_fused", "solo", dfused[i][:-1], dsolo[i][:-1])
        held("spec_oracle_fused", "plain", dfused[i][-1], _leaves(dense_plain[i])[-1])
        held("spec_oracle_fused", "solo", dfused[i][-1], dsolo[i][-1])
    for shards in kspec.EVAL_SHARDS:  # every cluster size of the kernel
        forced = kfuse.spec_eval_fused(members(cstep, dense_pairs, None), _shards=shards)
        for i in range(2):
            held("spec_eval_fused", "solo", forced[i], dsolo[i][:-1])
    t_eval = timed_graph(lambda: kfuse.spec_eval_fused(members(cstep, dense_pairs, None)), 3)
    t_eval_solo = timed_graph(lambda: [kspec.spec_eval(cstep, c, x) for c, x in dense_pairs], 3)
    pk = slot_pairs[:FUSE_K]
    frows = [(r[0], r[1], r[7]) for r in kfuse.sparse_round_fused(members(sstep, pk, KCAND))]
    plain_orc = timed_once(lambda: [kspec._oracle_core(p_, r_, s_, SPEC_BATCH)
                                    for p_, r_, s_ in frows])
    # bounds: K x the solo round's bytes (each member's statics, carry,
    # batch and outputs read or written once), as phase 9 counts them
    s0c, s0x = pk[0]
    aff_rows = (len(torch.unique(s0x["NodeAffinity"].req_idx)) * scw.n_nodes
                + len(torch.unique(s0x["NodeAffinity"].pref_idx)) * scw.n_nodes * 4)
    one = kfuse.sparse_round_fused(members(sstep, pk[:1], KCAND))[0]
    solo_round_b = nb(scw.statics["core"], s0c, s0x) + aff_rows + nb(one[:8])
    bounds = {
        "spec_round_fused": bound(FUSE_K * solo_round_b, FUSE_K * SPEC_BATCH * KCAND * 9),
        "spec_oracle_fused": bound(sum(oracle_bytes(*r) for r in frows)),
        "spec_eval_fused": bound(2 * nb(cw.statics, dense_pairs[0][0], dense_pairs[0][1],
                                        dfused[0][:-1]), 2 * SPEC_BATCH * cw.n_nodes * 22),
    }
    ms = {"spec_round_fused": timing[FUSE_K][0], "spec_oracle_fused": timing[FUSE_K][2],
          "spec_eval_fused": t_eval}
    solo_ms = {"spec_round_fused": timing[FUSE_K][1], "spec_oracle_fused": timing[FUSE_K][3],
               "spec_eval_fused": t_eval_solo}
    plain = {"spec_round_fused": plain_round, "spec_oracle_fused": plain_orc,
             "spec_eval_fused": plain_eval}
    print(f"[22 B11 vs solo] {card}: at the JSON entries' K (sparse {FUSE_K}, dense 2) the "
          f"fused launch and the K solo launches it replaces, device ms: fused {ms}, "
          f"K solo {solo_ms}", flush=True)
    torch.cuda.synchronize()
    print(f"[22 B11==plain==solo] {card}: slot-pinned {scw.n_pods}x{scw.n_nodes} sparse rounds "
          f"at batch {SPEC_BATCH}, kcand {KCAND}: {'; '.join(lines22)} | config {CONFIG} dense round "
          f"K=2: spec_eval_fused (S={eval_shards}) {t_eval:.4f} ms vs 2 solo spec_eval "
          f"{t_eval_solo:.4f} ms | each also held to the solo launches at every forced group "
          f"and cluster size | "
          f"device ms per launch (CUDA graph); plain (K={FUSE_K} sparse, K=2 dense) {plain}; "
          f"bounds (K x the solo round's bytes) {bounds}; max_abs_err against the plain "
          f"versions and the solo launches {errs}, those launches by (K, b) {held22}; "
          f"{time.perf_counter() - t22:.1f} s",
          flush=True)
    del slot_pairs, dense_pairs, dm, dfused, dsolo, frows

    # ---- 23. sessions at full width: K = 4 slot-pinned sessions through
    # SessionManager(device="cuda"), schedule_pending() at once from a
    # barrier, fused and KSS_TPU_FUSE=0
    t23 = time.perf_counter()
    snodes = make_slot_pinned_workload(SLOT_PODS, SLOT_NODES, seed=SEED)[0]
    rrs: dict = {}
    real_stream = pspec.replay_speculative_stream

    def stream_spy(*a, **kw):
        rr, stats = real_stream(*a, **kw)
        rrs.setdefault(TRACER.current_session(), []).append(rr)
        return rr, stats

    pspec.replay_speculative_stream = stream_spy

    def run_together(sessions) -> float:
        barrier = threading.Barrier(len(sessions) + 1)
        errors: list = []

        def run(sess):
            try:
                barrier.wait()
                sess.di.engine.schedule_pending()
            except Exception as e:  # noqa: BLE001 — failed below
                errors.append(f"{sess.id}: {type(e).__name__}: {e}")

        threads = [threading.Thread(target=run, args=(s,)) for s in sessions]
        for th in threads:
            th.start()
        barrier.wait()
        t0 = time.perf_counter()
        for th in threads:
            th.join()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(not errors, f"sessions failed: {errors}")
        return wall

    def fold_tally() -> dict:
        return {"solo": kspec.spec_oracle.commits, "fused": kfuse.spec_oracle_fused.commits,
                "spec_commit_core": kspec.spec_commit_core.launches,
                "spec_commit_bind": kspec.spec_commit_bind.launches}

    def run_arms(family: str, plugins, seeds, n_pods: int = SLOT_PODS) -> tuple[list, dict]:
        """Sessions of one family (the slot-pinned fleet, `n_pods` pods of
        each queue seed of `seeds`, `plugins`) scheduling at once, fused
        and KSS_TPU_FUSE=0; every pod's node, the bind order and the
        results digest equal between the arms.  -> (the arms' report
        lines, the fused arm's B11 launches)."""
        queues = {f"{family}-{s}": make_slot_pinned_workload(n_pods, SLOT_NODES, seed=s)[1]
                  for s in seeds}
        core_only = not set(plugins) & pspec.LABEL_COUPLED
        arms, lines, fused_launches = {}, [], None
        for fuse in ("1", "0"):
            rrs.clear()
            with env(KSS_TPU_FUSE=fuse, KSS_TPU_FUSE_WINDOW_MS=SESSION_WINDOW_MS,
                     KSS_TPU_SPECULATIVE=None, KSS_TPU_HOST_RESIDENT=None,
                     KSS_TPU_EAGER_DECODE=None, KSS_TPU_DEVICE_RESULT_BUDGET_MB=None):
                mgr = SessionManager(max_sessions=8, idle_ttl=0, start_scheduler=False,
                                     device="cuda")
                orders = {}
                try:
                    for sid, queue in queues.items():
                        sess = mgr.create(sid)
                        sess.di.engine.set_profiles(None)
                        sess.di.engine.plugin_config = PluginSetConfig(enabled=list(plugins))
                        for obj in snodes:
                            sess.di.store.create("nodes", obj)
                        for obj in queue:
                            sess.di.store.create("pods", obj)
                        orders[sid] = []
                        _spy_engine(sess, orders[sid])
                    f0 = FUSE.stats()
                    reset()
                    c0 = fold_tally()
                    with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
                        wall = run_together([mgr.get(sid) for sid in queues])
                    launched = counts()
                    folds = {k: v - c0[k] for k, v in fold_tally().items()}
                    batches = by_batch()
                    f1 = FUSE.stats()
                    busy = _device_busy_s(prof)
                    check(all(rrs.get(sid) for sid in queues),
                          f"a session's wave took no speculative stream: {sorted(rrs)}")
                    arms[fuse] = _session_state(mgr, list(queues), rrs, orders)
                finally:
                    mgr.shutdown()
            calls = f1["fusedDeviceCalls"] - f0["fusedDeviceCalls"]
            tally = {k: v - f0["dispatches"].get(k, 0) for k, v in f1["dispatches"].items()}
            if fuse == "1":
                fused_launches = launched
                check(calls >= 1, f"{family} fused arm: fusedDeviceCalls {calls}")
            else:
                check(calls == 0 and not any(launched.values()),
                      f"{family} KSS_TPU_FUSE=0 arm fused")
            # a core-only family's rounds commit in their oracle launches,
            # solo or fused; a label-coupled one's never do
            folded = folds["solo"] + folds["fused"]
            if core_only:
                check(folded > 0 and folds["spec_commit_core"] == 0,
                      f"{family} KSS_TPU_FUSE={fuse}: commits {folds}")
            else:
                check(folded == 0, f"{family} KSS_TPU_FUSE={fuse}: commits {folds}")
            idle = f"{1 - busy / wall:.4f}" if busy > 0 else "not measured"
            lines.append(f"KSS_TPU_FUSE={fuse}: wall {wall:.4f} s, "
                         f"{len(queues) * n_pods / wall:.1f} cycles/s summed over sessions, "
                         f"device busy {busy:.4f} s, idle share {idle}, fusedDeviceCalls "
                         f"{calls}, dispatches {tally}, B11 launches {launched}, by (K, b) "
                         f"{batches}, rounds folded (the commit in the oracle launch: solo "
                         f"launches, fused sessions) {folds['solo']}, {folds['fused']}, "
                         f"spec_commit_core {folds['spec_commit_core']}, spec_commit_bind "
                         f"{folds['spec_commit_bind']}")
        for sid in queues:
            fz, so = arms["1"][sid], arms["0"][sid]
            check(fz[0] == so[0], f"{sid}: nodeName differs between the arms")
            check(all(fz[0].values()), f"{sid}: a pod stayed unbound")
            check(fz[1] == so[1], f"{sid}: bind order differs between the arms")
            check(fz[2] == so[2], f"{sid}: results (the 13 annotations' source) differ")
        return lines, fused_launches

    try:
        # the sparse family: the three-plugin set, rounds of spec_round
        lines23, main23 = run_arms("slot", SLOT_PLUGINS, range(FUSE_K))
        check(main23["spec_round_fused"] > 0, f"the sparse arm launched no B11: {main23}")
        print(f"[23 sessions] {card}: {FUSE_K} sessions x {SLOT_PODS} slot-pinned pods "
              f"(queue seeds 0-{FUSE_K - 1}, plugins {list(SLOT_PLUGINS)}) on the "
              f"{SLOT_NODES}-node fleet, SessionManager(device='cuda'), schedule_pending() of "
              f"every session at once from a barrier, window {SESSION_WINDOW_MS} ms: "
              f"{'; '.join(lines23)}; every pod's nodeName, every session's bind order and its "
              f"results digest (selected, feasible counts, PreFilter rejects, every compact "
              f"chunk's bytes: the 13 annotations' whole input) equal between the arms; "
              f"{time.perf_counter() - t23:.1f} s", flush=True)
        # the dense family: PodTopologySpread joins the set (label-coupled,
        # so every round is spec_eval's; these pods carry no constraint,
        # so the rounds still accept whole batches)
        t23d = time.perf_counter()
        dense_lines, dense23 = run_arms("spread", (*SLOT_PLUGINS, "PodTopologySpread"),
                                        range(FUSE_K, 2 * FUSE_K), DENSE_PODS)
        check(dense23["spec_eval_fused"] > 0, f"the dense arm launched no B11: {dense23}")
        print(f"[23 sessions, dense] {card}: {FUSE_K} sessions x {DENSE_PODS} slot-pinned pods "
              f"(queue seeds {FUSE_K}-{2 * FUSE_K - 1}) under the three plugins and "
              f"PodTopologySpread (dense rounds), as above: {'; '.join(dense_lines)}; equal "
              f"between the arms; {time.perf_counter() - t23d:.1f} s", flush=True)
        main23 = {k: main23[k] + dense23[k] for k in main23}
        queues = {f"slot-{s}": make_slot_pinned_workload(SLOT_PODS, SLOT_NODES, seed=s)[1]
                  for s in range(2)}

        # the contended case: two config-5 sessions (one family).  Their
        # first wave is admitted (no history), and its dense rounds fuse
        # where the two streams meet; it rolls most rounds back and falls
        # to the scan, so their later waves are benched: they time-share
        with env(KSS_TPU_FUSE="1", KSS_TPU_FUSE_WINDOW_MS=CONTENDED_WINDOW_MS,
                 KSS_TPU_SPECULATIVE=None, KSS_TPU_HOST_RESIDENT=None,
                 KSS_TPU_EAGER_DECODE=None, KSS_TPU_DEVICE_RESULT_BUDGET_MB=None):
            mgr = SessionManager(max_sessions=4, idle_ttl=0, start_scheduler=False,
                                 device="cuda")
            try:
                cids = ("config5-a", "config5-b")
                for sid in cids:
                    sess = mgr.create(sid)
                    sess.di.engine.set_profiles(None)
                    sess.di.engine.plugin_config = cfg5
                    for obj in nodes5:
                        sess.di.store.create("nodes", obj)
                    for obj in pods5:
                        sess.di.store.create("pods", obj)
                f0 = FUSE.stats()
                reset()
                wall_c1 = run_together([mgr.get(sid) for sid in cids])
                contended = counts()
                contended_batches = by_batch()
                f1 = FUSE.stats()
                rates = [(TRACER.labeled_totals("speculative_accepted_total", "session").get(s, 0),
                          TRACER.labeled_totals("speculative_rolled_back_total", "session")
                          .get(s, 0)) for s in cids]
                benched = [sid for sid in cids if not session_admitted(sid)]
                check(len(benched) == 2, f"contended sessions not benched: {benched}")
                for sid in cids:
                    sess = mgr.get(sid)
                    for q in pods5[:SPEC_BATCH]:
                        q = copy.deepcopy(q)
                        q["metadata"]["name"] += "-again"
                        sess.di.store.create("pods", q)
                reset()
                wall_c2 = run_together([mgr.get(sid) for sid in cids])
                f2 = FUSE.stats()
                later = counts()
            finally:
                mgr.shutdown()
        check(f2["fusedDeviceCalls"] == f1["fusedDeviceCalls"] and not any(later.values()),
              f"benched sessions fused: {later}")
        check(f2["dispatches"]["timeshared"] > f1["dispatches"]["timeshared"],
              "benched sessions dispatched no time-shared round")
    finally:
        pspec.replay_speculative_stream = real_stream
    c_calls = f1["fusedDeviceCalls"] - f0["fusedDeviceCalls"]
    print(f"[23 contended] {card}: two config-{CONFIG} sessions ({len(pods5)} pods each, one "
          f"family), window {CONTENDED_WINDOW_MS} ms: first wave {wall_c1:.4f} s, "
          f"fusedDeviceCalls {c_calls}, B11 launches {contended}, by (K, b) "
          f"{contended_batches}; (accepted, rolled back) per "
          f"session {rates} -> both benched by admission; a later wave of {SPEC_BATCH} pods "
          f"each {wall_c2:.4f} s, time-shared, no fused call", flush=True)
    launches = {name: main23[name] + contended[name] for name in main23}

    # ---- 24. HTTP: SimulatorServer on localhost, two sessions, each
    # importing the slot-pinned fleet and a queue
    t24 = time.perf_counter()
    sched_cfg = {"apiVersion": "kubescheduler.config.k8s.io/v1",
                 "kind": "KubeSchedulerConfiguration",
                 "profiles": [{"schedulerName": "default-scheduler", "plugins": {"multiPoint": {
                     "enabled": [{"name": nm} for nm in SLOT_PLUGINS],
                     "disabled": [{"name": "*"}]}}}]}

    def req(srv, method, path, body=None):
        data = json.dumps(body).encode() if body is not None else None
        r = urllib.request.Request(f"http://127.0.0.1:{srv.port}{path}", data=data,
                                   method=method, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(r, timeout=600) as resp:
            raw = resp.read()
            return resp.status, json.loads(raw) if raw else None

    with env(KSS_TPU_FUSE="1", KSS_TPU_FUSE_WINDOW_MS=SESSION_WINDOW_MS,
             KSS_TPU_SPECULATIVE=None, KSS_TPU_HOST_RESIDENT=None,
             KSS_TPU_EAGER_DECODE=None, KSS_TPU_DEVICE_RESULT_BUDGET_MB=None):
        srv = SimulatorServer(port=0, device="cuda")
        srv.start(block=False)
        try:
            http, http_orders = {}, {}
            f0 = FUSE.stats()
            sids = []
            for s in range(2):
                code, made = req(srv, "POST", "/api/v1/sessions", {"id": f"http-{s}"})
                check(code == 201, f"POST /api/v1/sessions: {code}")
                sids.append(made["id"])
                http_orders[made["id"]] = []
                _spy_engine(srv.manager.get(made["id"]), http_orders[made["id"]])
            t0 = time.perf_counter()
            for sid in sids:
                snap = {"nodes": snodes, "pods": queues[f"slot-{sids.index(sid)}"],
                        "schedulerConfig": sched_cfg}
                code, _ = req(srv, "POST", f"/api/v1/sessions/{sid}/import", snap)
                check(code == 200, f"import into {sid}: {code}")
            deadline = time.time() + 600
            done = set()
            while len(done) < len(sids) and time.time() < deadline:
                for sid in sids:
                    _, m = req(srv, "GET", f"/api/v1/sessions/{sid}/metrics")
                    if m["counters"].get("pods_scheduled_total", 0) >= SLOT_PODS:
                        done.add(sid)
                time.sleep(0.2)
            bind_s = time.perf_counter() - t0
            check(len(done) == len(sids), f"HTTP sessions bound only {sorted(done)}")
            code, listing = req(srv, "GET", "/api/v1/sessions")
            check(code == 200 and {"fusedDeviceCalls", "dispatches"} <= set(listing["fuse"]),
                  "/api/v1/sessions has no fuse stats")
            # the served annotations of a sample against a direct replay()
            # of the same queue under the profile the server parsed.  The
            # import applies pods on several threads and the scheduling
            # loop's waves take them as they land, so the queue's order is
            # the creation order, which the binds follow: replay in it
            for k, sid in enumerate(sids):
                by_name = {q["metadata"]["name"]: q for q in queues[f"slot-{k}"]}
                queue = [by_name[nm] for _ns, nm, _node in http_orders[sid]]
                check(len(queue) == SLOT_PODS and len(set(map(id, queue))) == SLOT_PODS,
                      f"{sid}: {len(queue)} binds for {SLOT_PODS} pods")
                sess = srv.manager.get(sid)
                prof_cfg = sess.di.engine.profiles["default-scheduler"]
                dcw = compile_workload(snodes, queue, prof_cfg, device=dev)
                drr = replay(dcw, chunk=CHUNK, device=dev)
                sample = list(range(HTTP_SAMPLE // 2)) + list(
                    range(SLOT_PODS - HTTP_SAMPLE // 2, SLOT_PODS))
                for i in sample:
                    name = queue[i]["metadata"]["name"]
                    _, pod = req(srv, "GET", f"/api/v1/sessions/{sid}/pods/default/{name}")
                    got = pod["metadata"]["annotations"]
                    want = decode_pod_result(drr, i)
                    for key in ALL_PLUGIN_KEYS:
                        check(got.get(key) == want[key], f"{sid} pod {i} {key} != replay()")
                    check((pod["spec"].get("nodeName") or "") ==
                          want["kube-scheduler-simulator.sigs.k8s.io/selected-node"],
                          f"{sid} pod {i} nodeName != replay()")
                http[sid] = len(sample)
                del dcw, drr
            f1 = FUSE.stats()
        finally:
            srv.shutdown()
    print(f"[24 HTTP] {card}: SimulatorServer(device='cuda') on localhost, sessions "
          f"{sids} created through POST /api/v1/sessions, each importing {SLOT_NODES} nodes "
          f"and {SLOT_PODS} pods (POST .../import with a three-plugin scheduler config); all "
          f"bound in {bind_s:.3f} s from the first import; the 13 annotations and nodeName of "
          f"pods {sample[0]}-{sample[HTTP_SAMPLE // 2 - 1]} and "
          f"{sample[HTTP_SAMPLE // 2]}-{sample[-1]} of each session (GET .../pods/<ns>/<name>) "
          f"equal a direct replay() of the same queue ({http}); /api/v1/sessions fuse stats "
          f"{listing['fuse']} (fusedDeviceCalls during the phase: "
          f"{f1['fusedDeviceCalls'] - f0['fusedDeviceCalls']}); "
          f"{time.perf_counter() - t24:.1f} s", flush=True)

    sources = {"spec_eval_fused": "spec_eval.cu", "spec_round_fused": "spec_round.cu",
               "spec_oracle_fused": "oracle.cu"}
    return [{
        "name": name,
        "route": "cuda",
        "source": f"kube_scheduler_simulator_tpu_torch/csrc/{sources[name]}",
        "replaces": "kube_scheduler_simulator_tpu/parallel/fuse.py:356",
        "launches": launches[name],
        "max_abs_err": max(errs[name].values()),
        "ms": ms[name],
        "plain_ms": plain[name],
        "bound_ms": bounds[name][0],
        "bound_by": bounds[name][1],
        "library_ms": None,
    } for name in ("spec_eval_fused", "spec_round_fused", "spec_oracle_fused")]


# phases 25-26: the node-sharded mesh (B12)
MESH_SHARDS = (2, 4, 8)        # phase 25: the "nodes" extents; 5,000 nodes divide by each
MESH_DEFAULT_PODS = 1024       # phase 25: the default-profile fleet's pods on the mesh
MESH_ODD_NODES = 4996          # phase 26: a fleet that 8 shards do not divide
MESH_ODD_PODS = 1024
ENGINE_PAIRS = 3               # phase 26: the engine's (none, mesh, mesh, none) turns


def mesh_phases(dev, card: str, cw, nodes: list, pods: list, cfg, rr, spec_ctx: dict,
                dp_ctx: dict, step_entry: dict) -> list[dict]:
    """Phases 25-26: the node-sharded mesh on one card, each "nodes" shard
    a group of CTAs of the unsharded kernels' clusters (B12: step_chunk's
    kernel, csrc/step_kernel.cuh, and spec_eval_cluster, csrc/
    spec_eval.cu).  25: config 5 through replay(cw, mesh=make_mesh(S))
    for S = 2, 4, 8 against phase 4, step_chunk_sharded at the plan's G
    and at each forced G against step_chunk on chunk 0 (at S = 8 and the
    plan's G against its plain twin too), its times at each against
    step_chunk's, in turns, the default-profile fleet's first 1,024 pods
    at S = 4 against phase 11, each of its chunks timed beside
    step_chunk's default launch; 26: spec_eval_sharded at b = 512 and
    S = 2, 4, 8 (make_mesh(2), make_mesh(8, dp=2), make_mesh(8)) against
    spec_eval and its plain twin, the config-5 stream on a dp 2 x nodes
    4 mesh against phase 8, then spec_eval_sharded at that stream's own
    batch and mesh against spec_eval and its twin (the JSON entry's
    times), the engine on an 8-shard mesh against phase 4 as phase 19
    holds itself, beside the same engine run without a mesh (phase 19's
    default wave, in turns, ENGINE_PAIRS times), and a 4,996-node fleet
    through the engine's unsharded fallback.  -> the entries of B12 for
    the JSON line."""
    import torch

    from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
    from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import (
        _clone_carry, _compact_plan, plugin_attribution, replay)
    from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
    from kube_scheduler_simulator_tpu_torch.models import baseline_config
    from kube_scheduler_simulator_tpu_torch.parallel import (make_mesh, replay_speculative_stream,
                                                             shard_workload)
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.state import compile_workload
    from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result
    from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

    kernels = (kmesh.step_chunk_sharded, kmesh.spec_eval_sharded, kstep.step_chunk,
               *kspec.KERNELS)

    def reset() -> None:
        for f in kernels:
            f.launches = 0

    def counts() -> dict:
        return {f.__name__: f.launches for f in kernels if f.launches}

    p, n = cw.n_pods, cw.n_nodes
    n_chunks = math.ceil(p / CHUNK)
    sample = sorted(set(DECODE_CHECK_PODS) | {p // 2, p - 1})

    # ---- 25. the sharded scan at full width
    t25 = time.perf_counter()
    walls, step_err = {}, 0
    main_launches = None
    for s in MESH_SHARDS:
        # S = 8 at the default, device-resident rung (B7 on every chunk);
        # S = 2 and 4 host-resident, as phase 4
        rung = None if s == 8 else "1"
        reset()
        with env(KSS_TPU_HOST_RESIDENT=rung):
            t0 = time.perf_counter()
            mrr = replay(cw, chunk=CHUNK, device="cuda", mesh=make_mesh(s))
            torch.cuda.synchronize()
            walls[s] = time.perf_counter() - t0
        launched = counts()
        check(launched.get("step_chunk_sharded", 0) == n_chunks * len(mrr.tiers),
              f"mesh S={s}: launches {launched}, chunks {n_chunks} x tiers {len(mrr.tiers)}")
        check("step_chunk" not in launched, f"mesh S={s} ran the unsharded step: {launched}")
        same_replay(mrr, rr, f"replay on mesh S={s} vs phase 4", sample)
        if s == 8:
            main_launches = launched.get("step_chunk_sharded", 0)
            check(plugin_attribution(mrr) == plugin_attribution(rr),
                  "mesh S=8 device-resident attribution != phase 4's host tally")
        del mrr

    wide = rr.tiers[-1]
    pm, sd, _ = _compact_plan(cw, wide)
    step_c = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd, wide_raw=wide)
    # the same step over the workload sharded S ways (S from the mesh)
    step_s = {s: build_step(shard_workload(cw, make_mesh(s)), out_mode="compact", pack_mode=pm,
                            score_dtypes=sd, wide_raw=wide) for s in MESH_SHARDS}
    xs0 = batch_xs(cw, 0, CHUNK)
    cu, ou = kstep.step_chunk(step_c, _clone_carry(cw.init_carry), xs0)
    sharded_out = {}
    for s in MESH_SHARDS:
        cs, os_ = kmesh.step_chunk_sharded(step_s[s], _clone_carry(cw.init_carry), xs0)
        torch.cuda.synchronize()
        err = max(tree_err(list(os_), list(ou)), tree_err(cs, cu))
        check(err == 0, f"step_chunk_sharded S={s} differs from step_chunk on chunk 0 "
                        f"(max |d| {err})")
        sharded_out[s] = (cs, os_)
    twin = []
    plain_ms = timed_once(lambda: twin.append(kmesh.step_chunk_sharded_plain(
        step_s[8], _clone_carry(cw.init_carry), xs0)))
    cs8, os8 = sharded_out[8]
    step_err = max(tree_err(list(os8), list(twin[0][1])), tree_err(cs8, twin[0][0]))
    check(step_err == 0, f"step_chunk_sharded S=8 differs from its plain twin (max |d| {step_err})")
    del twin, sharded_out
    # each forced group size (R = S x G <= 16): == step_chunk on chunk 0
    forced_g = {s: [g for g in EVAL_SHARDS if s * g <= 16] for s in MESH_SHARDS}
    plan_g = {}
    for s in MESH_SHARDS:
        kmesh.step_chunk_sharded(step_s[s], _clone_carry(cw.init_carry), xs0)
        plan_g[s] = kmesh.step_chunk_sharded.groups
        for g in forced_g[s]:
            cs, os_ = kmesh.step_chunk_sharded(step_s[s], _clone_carry(cw.init_carry), xs0,
                                               _groups=g)
            err = max(tree_err(list(os_), list(ou)), tree_err(cs, cu))
            check(err == 0, f"step_chunk_sharded S={s} G={g} differs from step_chunk on chunk 0 "
                            f"(max |d| {err})")
    del cu, ou, cs, os_

    # times as phase 5 takes B1's: back-to-back launches, each on a fresh
    # copy of the initial carry, after one untimed launch; in turns
    # (unsharded, S = 2, 4, 8, unsharded)
    def chunk_ms(run, reps: int = 3) -> float:
        carries = [_clone_carry(cw.init_carry) for _ in range(reps + 1)]
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
        run(carries[0])
        marks[0].record()
        for k in range(reps):
            run(carries[k + 1])
            marks[k + 1].record()
        torch.cuda.synchronize()
        ts = sorted(marks[k].elapsed_time(marks[k + 1]) for k in range(reps))
        return ts[len(ts) // 2]

    b1_ms = [chunk_ms(lambda c: kstep.step_chunk(step_c, c, xs0))]
    sharded_ms = {s: chunk_ms(lambda c, s=s: kmesh.step_chunk_sharded(step_s[s], c, xs0))
                  for s in MESH_SHARDS}
    b1_ms.append(chunk_ms(lambda c: kstep.step_chunk(step_c, c, xs0)))
    forced_ms = {s: {g: chunk_ms(lambda c, s=s, g=g: kmesh.step_chunk_sharded(
        step_s[s], c, xs0, _groups=g)) for g in forced_g[s]} for s in MESH_SHARDS}
    b1_ms.append(chunk_ms(lambda c: kstep.step_chunk(step_c, c, xs0)))
    unsharded_ms = sum(b1_ms) / len(b1_ms)

    # the default-profile fleet's first 1,024 pods at S = 4, against phase 11
    dnodes, dpods, _ = baseline_config(CONFIG, scale=1.0, seed=SEED)
    volumes, bound_pods = decorate_default_profile(dnodes, dpods, SEED)
    fcw = compile_workload(dnodes, dpods[:MESH_DEFAULT_PODS], PluginSetConfig(),
                           volumes=volumes, bound_pods=bound_pods, device=dev)
    drr = dp_ctx["default"][1]
    reset()
    with env(KSS_TPU_HOST_RESIDENT="1"):
        t0 = time.perf_counter()
        frr = replay(fcw, chunk=CHUNK, device="cuda", mesh=make_mesh(4))
        torch.cuda.synchronize()
        fwall = time.perf_counter() - t0
    flaunched = counts()
    # each of its chunks on the mesh beside step_chunk's default launch,
    # in turns (unsharded, mesh, mesh, unsharded), from the initial carry
    fpm, fsd, _ = _compact_plan(fcw, frr.tiers[-1])
    fkw = dict(out_mode="compact", pack_mode=fpm, score_dtypes=fsd, wide_raw=frr.tiers[-1])
    fstep, fstep4 = build_step(fcw, **fkw), build_step(shard_workload(fcw, make_mesh(4)), **fkw)

    def fchunk_ms(run, xs) -> float:
        carries = [_clone_carry(fcw.init_carry) for _ in range(2)]
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        run(carries[0], xs)
        marks[0].record()
        run(carries[1], xs)
        marks[1].record()
        torch.cuda.synchronize()
        return marks[0].elapsed_time(marks[1])

    fms = {}
    for lo in range(0, fcw.n_pods, CHUNK):
        fxs = batch_xs(fcw, lo, CHUNK)
        fms[lo] = [fchunk_ms(lambda c, x: kstep.step_chunk(fstep, c, x), fxs),
                   fchunk_ms(lambda c, x: kmesh.step_chunk_sharded(fstep4, c, x), fxs),
                   fchunk_ms(lambda c, x: kmesh.step_chunk_sharded(fstep4, c, x), fxs),
                   fchunk_ms(lambda c, x: kstep.step_chunk(fstep, c, x), fxs)]
    del fstep, fstep4
    check(flaunched.get("step_chunk_sharded", 0) > 0 and "step_chunk" not in flaunched,
          f"default profile on the mesh: launches {flaunched}")
    fp = fcw.n_pods
    for f in ("selected", "feasible_count", "prefilter_reject"):
        check((getattr(frr, f) == getattr(drr, f)[:fp]).all(),
              f"default profile on mesh S=4: {f} != phase 11's")
    fsample = sorted(i for i in {0, 1, CHUNK - 1, CHUNK, fp - 1} | set(range(0, fp, fp // 8))
                     if i < fp)
    for i in fsample:
        check(decode_pod_result(frr, i) == decode_pod_result(drr, i),
              f"default profile on mesh S=4: pod {i} annotations != phase 11's")
    del frr, fcw
    print(f"[25 mesh scan] {card}: config {CONFIG} {p}x{n} through replay(cw, "
          f"mesh=make_mesh(S)), S = 2, 4, 8 ({n // 8}-{n // 2} nodes a shard): wall "
          f"{ {s: round(w, 4) for s, w in walls.items()} } s; selected, feasible_count, "
          f"prefilter_reject, every compact chunk's bytes (raws at feasible nodes) and decode "
          f"bytes of pods {sample} equal phase 4's (S = 8 at the device-resident rung, its "
          f"plugin_attribution equal phase 4's host tally); launches {main_launches} at S = 8 | "
          f"chunk 0: step_chunk_sharded == step_chunk (outputs and carry) at every S, == its "
          f"plain twin at S = 8, max_abs_err {step_err}; plain twin {plain_ms:.3f} ms | "
          f"step_chunk_sharded == step_chunk at every S and forced G {forced_g} | "
          f"ms per chunk (median of 3, in turns): step_chunk {[round(x, 3) for x in b1_ms]}, "
          f"step_chunk_sharded at the plan's G {plan_g}: "
          f"{ {s: round(v, 3) for s, v in sharded_ms.items()} } = "
          f"{ {s: round(v / unsharded_ms, 4) for s, v in sharded_ms.items()} } x step_chunk; "
          f"forced G {json.dumps(forced_ms)}; bound {step_entry['bound_ms']:.6f} ms by "
          f"{step_entry['bound_by']} | default profile {fp} pods x {n} nodes on mesh S=4: "
          f"{fwall:.4f} s, launches {flaunched}, selected, feasible_count, prefilter_reject and "
          f"decode bytes of pods {fsample} equal phase 11's; ms per chunk from the initial carry "
          f"(step_chunk, S=4, S=4, step_chunk) {json.dumps(fms)}; "
          f"{time.perf_counter() - t25:.1f} s", flush=True)

    # ---- 26. the stream and the engine on a mesh
    t26 = time.perf_counter()
    cpm, csd, _ = _compact_plan(cw, None)
    cstep = build_step(cw, out_mode="compact", pack_mode=cpm, score_dtypes=csd)
    cxs = batch_xs(cw, 0, SPEC_BATCH)
    ccarry = _clone_carry(cw.init_carry)
    want = kspec.spec_eval(cstep, ccarry, cxs)
    torch.cuda.synchronize()
    eval_err, eval_ms, eval_plain_ms, eval_g = 0, {}, {}, {}
    # S = 8, 4, 2 shards; a mesh's dp extent only rounds the stream's rungs
    for mesh in (make_mesh(8), make_mesh(8, dp=2), make_mesh(2)):
        s = mesh.shape["nodes"]
        sstep = build_step(shard_workload(cw, mesh), out_mode="compact", pack_mode=cpm,
                           score_dtypes=csd)
        got = kmesh.spec_eval_sharded(sstep, ccarry, cxs)
        torch.cuda.synchronize()
        eval_g[s] = (kmesh.spec_eval_sharded.groups, kmesh.spec_eval_sharded.light)
        err = tree_err(list(got), list(want))
        check(err == 0, f"spec_eval_sharded S={s} differs from spec_eval (max |d| {err})")
        twin = []
        # the twin over the kernel's own slices (the plan's G)
        eval_plain_ms[s] = timed_once(lambda: twin.append(kmesh.spec_eval_sharded_plain(
            sstep, ccarry, cxs, eval_g[s][0])))
        err = tree_err(list(got), list(twin[0]))
        check(err == 0, f"spec_eval_sharded S={s} differs from its plain twin (max |d| {err})")
        eval_err = max(eval_err, err)
        eval_ms[s] = timed_graph(lambda: kmesh.spec_eval_sharded(sstep, ccarry, cxs), 3)
        del twin, got
    b2_ms = timed_graph(lambda: kspec.spec_eval(cstep, ccarry, cxs), 3)

    crr = spec_ctx["contended"]
    smesh = make_mesh(8, dp=2)
    reset()
    kmesh.spec_eval_sharded.batches.clear()
    t0 = time.perf_counter()
    mrr, mstats = replay_speculative_stream(cw, smesh, chunk=CHUNK, pods=pods,
                                            device_resident=False)
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_launched = counts()
    stream_batches = dict(kmesh.spec_eval_sharded.batches)
    check(stream_launched.get("spec_eval_sharded", 0) > 0,
          f"the mesh stream launched no spec_eval_sharded: {stream_launched}")
    check("spec_eval" not in stream_launched and "step_chunk" not in stream_launched,
          f"the mesh stream ran an unsharded eval or scan: {stream_launched}")
    if mstats["fallback_at"] is not None:
        check(stream_launched.get("step_chunk_sharded", 0) > 0,
              "the mesh stream's scan fallback launched no step_chunk_sharded")
    check(all(b % 2 == 0 for b in mstats["round_batches"]), f"rungs not dp multiples: {mstats}")
    same_replay(mrr, crr, "stream on mesh dp 2 x nodes 4 vs phase 8", sample)
    del mrr

    # the eval at the stream's own batch and mesh (its most launched
    # batch): the G and shape its plan takes there, held to spec_eval and
    # to the twin at that G, timed for the JSON line beside the twin and
    # spec_eval on the same inputs
    main_b = max(stream_batches, key=stream_batches.get)
    main_s = smesh.shape["nodes"]
    sstep = build_step(shard_workload(cw, smesh), out_mode="compact", pack_mode=cpm,
                       score_dtypes=csd)
    mxs = batch_xs(cw, 0, main_b)
    mwant = _solo(kspec.spec_eval, cstep, ccarry, mxs)
    got = kmesh.spec_eval_sharded(sstep, ccarry, mxs)
    torch.cuda.synchronize()
    main_g = (kmesh.spec_eval_sharded.groups, kmesh.spec_eval_sharded.light)
    main_err = tree_err(list(got), mwant)
    check(main_err == 0, f"spec_eval_sharded S={main_s} b={main_b} differs from spec_eval "
                         f"(max |d| {main_err})")
    twin = []
    main_plain_ms = timed_once(lambda: twin.append(kmesh.spec_eval_sharded_plain(
        sstep, ccarry, mxs, main_g[0])))
    main_err = tree_err(list(got), list(twin[0]))
    check(main_err == 0, f"spec_eval_sharded S={main_s} b={main_b} differs from its plain twin "
                         f"(max |d| {main_err})")
    eval_err = max(eval_err, main_err)
    main_ms = timed_graph(lambda: kmesh.spec_eval_sharded(sstep, ccarry, mxs), 20)
    main_b2_ms = timed_graph(lambda: kspec.spec_eval(cstep, ccarry, mxs), 20)
    main_bound = bound(eval_bytes(cw, ccarry, mxs, sum(t.numel() * t.element_size()
                                                        for t in mwant)),
                       main_b * n * 22)
    del twin, got, mwant

    names = cw.node_table.names

    def engine_run(objects: dict, mesh):
        store = ObjectStore()
        for res, items in objects.items():
            for obj in items:
                store.create(res, obj)  # create() deep-copies
        engine = SchedulerEngine(store, plugin_config=cfg, mesh=mesh)
        reset()
        t0 = time.perf_counter()
        bound_n = engine.schedule_pending()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched = counts()
        engine.close()
        return store, bound_n, wall, launched

    with env(KSS_TPU_SPECULATIVE=None, KSS_TPU_HOST_RESIDENT=None, KSS_TPU_EAGER_DECODE=None,
             KSS_TPU_DEVICE_RESULT_BUDGET_MB=None):
        # phase 19's default wave without a mesh and on the mesh, in turns
        # (none, mesh, mesh, none) under the same conditions; the first
        # mesh run is the one checked below
        walls26 = {"none": [], "mesh": []}
        store = None
        for arm in ("none", "mesh", "mesh", "none") * ENGINE_PAIRS:
            astore, abound, awall, alaunched = engine_run(
                {"nodes": nodes, "pods": pods}, make_mesh(8) if arm == "mesh" else None)
            check(abound == rr.scheduled, f"engine ({arm}) bound {abound}, replay {rr.scheduled}")
            walls26[arm].append(awall)
            if arm == "none":
                ulaunched = alaunched
            elif store is None:
                store, bound_n, elaunched = astore, abound, alaunched
            del astore
        check(elaunched.get("spec_eval_sharded", 0) + elaunched.get("step_chunk_sharded", 0) > 0,
              f"the engine on a mesh launched no B12 kernel: {elaunched}")
        check("spec_eval" not in elaunched and "step_chunk" not in elaunched,
              f"the engine on a mesh ran an unsharded eval or scan: {elaunched}")
        check(bound_n == rr.scheduled, f"engine on a mesh bound {bound_n}, replay {rr.scheduled}")
        by_name = {q["metadata"]["name"]: (q.get("spec") or {}).get("nodeName")
                   for q in store.list("pods", copy_objects=False)[0]}
        for i, q in enumerate(pods):
            s = int(rr.selected[i])
            check(by_name[q["metadata"]["name"]] == (names[s] if s >= 0 else None),
                  f"engine on a mesh: pod {i} node differs from phase 4's replay")
        esample = sorted(set(range(0, p, p // 11)) | {p - 1})[:12]
        for i in esample:
            got_a = store.get("pods", pods[i]["metadata"]["name"])["metadata"]["annotations"]
            want_a = decode_pod_result(rr, i)
            for key in ALL_PLUGIN_KEYS:
                check(got_a.get(key) == want_a[key], f"engine on a mesh: pod {i} {key}")
        del store

        # a fleet the mesh does not divide: the wave runs unsharded, counted
        odd = {"nodes": nodes[:MESH_ODD_NODES], "pods": pods[:MESH_ODD_PODS]}
        key = "mesh_fallback_indivisible_nodes_total"
        before = TRACER.counter_totals().get(key, 0)
        ostore, obound, owall, olaunched = engine_run(odd, make_mesh(8))
        fallbacks = TRACER.counter_totals().get(key, 0) - before
        check(fallbacks == 1, f"{key} rose by {fallbacks}, not 1")
        check(not {"spec_eval_sharded", "step_chunk_sharded"} & set(olaunched)
              and olaunched.get("spec_eval", 0) + olaunched.get("step_chunk", 0) > 0,
              f"the indivisible fleet's launches {olaunched}")
        pstore, pbound, _, _ = engine_run(odd, None)
        check(obound == pbound, f"indivisible fleet bound {obound}, without a mesh {pbound}")
        snap = {q["metadata"]["name"]: (q["spec"].get("nodeName"),
                                        q["metadata"].get("annotations"))
                for q in ostore.list("pods", copy_objects=False)[0]}
        psnap = {q["metadata"]["name"]: (q["spec"].get("nodeName"),
                                         q["metadata"].get("annotations"))
                 for q in pstore.list("pods", copy_objects=False)[0]}
        check(snap == psnap, "indivisible fleet: placements or annotations differ from the "
                             "engine without a mesh")
        del ostore, pstore, snap, psnap
    wmed = {arm: sorted(w)[len(w) // 2] for arm, w in walls26.items()}
    print(f"[26 mesh stream, engine] {card}: spec_eval_sharded at the stream's batch "
          f"b={main_b} on S={main_s} (its launches by batch {stream_batches}): (G, light) "
          f"{main_g}, == spec_eval and == its plain twin at that G; {main_ms:.5f} ms per launch "
          f"(CUDA graph) against spec_eval {main_b2_ms:.5f}; plain twin {main_plain_ms:.3f} ms; "
          f"bound {main_bound[0]:.6f} ms by {main_bound[1]} | extras at b={SPEC_BATCH} on "
          f"config {CONFIG}: == spec_eval and == its plain twin at S = 8, 4, 2 ((G, light) "
          f"{eval_g}), max_abs_err {eval_err}; ms per launch (CUDA graph) by S "
          f"{ {s: round(v, 5) for s, v in eval_ms.items()} } against spec_eval {b2_ms:.5f}; "
          f"plain twin { {s: round(v, 3) for s, v in eval_plain_ms.items()} } ms | "
          f"replay_speculative_stream(cw, make_mesh(8, dp=2)): stats {json.dumps(mstats)}; "
          f"{stream_s:.4f} s = {p / stream_s:.1f} cycles/s; equal to phase 8 (selected, "
          f"feasible_count, compact bytes, decode bytes of pods {sample}); launches "
          f"{stream_launched} | SchedulerEngine(mesh=make_mesh(8)).schedule_pending(): bound "
          f"{bound_n}, launches {elaunched}; walls in turns ((none, mesh, mesh, none) x "
          f"{ENGINE_PAIRS}; phase 19's default wave, no profiler): mesh "
          f"{[round(w, 4) for w in walls26['mesh']]} s, none "
          f"{[round(w, 4) for w in walls26['none']]} s, medians {json.dumps(wmed)} "
          f"(launches {ulaunched}); "
          f"every spec.nodeName equals phase 4's replay, the 13 annotations of pods {esample} "
          f"its decode | {MESH_ODD_NODES} nodes x {MESH_ODD_PODS} pods on make_mesh(8): "
          f"{key} +{fallbacks}, bound {obound} in {owall:.4f} s through launches {olaunched}, "
          f"equal to the engine without a mesh; {time.perf_counter() - t26:.1f} s", flush=True)

    return [{
        "name": "step_chunk_sharded",
        "route": "cuda",
        "source": "kube_scheduler_simulator_tpu_torch/csrc/step_kernel.cuh",
        "replaces": "kube_scheduler_simulator_tpu/parallel/mesh.py:130",
        "launches": main_launches,
        "max_abs_err": step_err,
        "ms": sharded_ms[8],
        "plain_ms": plain_ms,
        "bound_ms": step_entry["bound_ms"],
        "bound_by": step_entry["bound_by"],
        "library_ms": unsharded_ms,
    }, {
        "name": "spec_eval_sharded",
        "route": "cuda",
        "source": "kube_scheduler_simulator_tpu_torch/csrc/spec_eval.cu",
        "replaces": "kube_scheduler_simulator_tpu/parallel/mesh.py:143",
        "launches": stream_launched.get("spec_eval_sharded", 0),
        "max_abs_err": eval_err,
        "ms": main_ms,
        "plain_ms": main_plain_ms,
        "bound_ms": main_bound[0],
        "bound_by": main_bound[1],
        "library_ms": main_b2_ms,
    }]


def clock_phase(dev, card: str, fleets: dict) -> dict:
    """Phase 27: the phase clock.  Chunk 0 of each fleet through the
    phase-clock build of step_chunk (csrc/step.cu under -DKSS_PHASE_CLOCK,
    loaded here only), held to the plain build's outputs, with each
    phase's share of the launch: the sums over the chunk's pods of the
    ns that thread 0 of the leading block spent in it (kernels/step.py
    CLOCK_PHASES), and the launch from its first stamp to its last.
    -> {fleet: {phase: ms}}."""
    import torch

    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import (
        _clone_carry, _compact_plan, _slice_xs)
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep

    t27 = time.perf_counter()
    split = {}
    for label, w in fleets.items():
        pack_mode, score_dtypes, _ = _compact_plan(w, None)
        step = build_step(w, out_mode="compact", pack_mode=pack_mode, score_dtypes=score_dtypes)
        xs = _slice_xs(w.xs, 0, min(CHUNK, w.n_pods), CHUNK)
        xs["is_pad"] = torch.arange(CHUNK, device=dev) >= min(CHUNK, w.n_pods)
        clock = torch.zeros(CHUNK * kstep.CLOCK_SLOTS + 2, dtype=torch.int64, device=dev)
        _, got = kstep.step_chunk(step, _clone_carry(w.init_carry), xs, _clock=clock)
        _, want = kstep.step_chunk(step, _clone_carry(w.init_carry), xs)
        torch.cuda.synchronize()
        check(tree_err(got, want) == 0, f"{label}: the phase-clock build differs from the plain "
                                        "build")
        ck = clock.cpu()
        per_pod = ck[:-2].view(CHUNK, kstep.CLOCK_SLOTS).sum(0)
        split[label] = {"launch": int(ck[-1] - ck[-2]) / 1e6,
                        **{ph: int(per_pod[k]) / 1e6 for k, ph in enumerate(kstep.CLOCK_PHASES)}}
    print(f"[27 phase clock] {card}: chunk 0 ({CHUNK} pods) through the phase-clock build of "
          f"step_chunk, equal to the plain build; ms per chunk by phase (thread 0 of the leading "
          f"block; NodeVolumeLimits and VolumeBinding are shares of the others): "
          f"{json.dumps(split)}; {time.perf_counter() - t27:.1f} s", flush=True)
    return split


CUSTOM_PODS = 1024             # phase 28 (a), (d): the queue with custom rows (2 chunks)
GUEST_PODS = 512               # phase 28 (b): the guest's wave through the service
HOST_CUSTOM_PODS = 64          # phase 28 (c): a custom NormalizeScore on the host path
CUSTOM_MESH_SHARDS = 8         # phase 28 (d)
GUEST_SRC = """
from kube_scheduler_simulator_tpu_torch.plugins.custom import CustomPlugin


class Plugin(CustomPlugin):
    default_weight = 1

    def filter(self, pod, node):
        if int(node["metadata"]["name"].rsplit("-", 1)[1]) % 3 == 0:
            return "guest says no"
        return None

    def score(self, pod, node):
        return int(node["metadata"]["name"].rsplit("-", 1)[1]) % 17
"""


def _node_index(obj) -> int:
    return int(obj["metadata"]["name"].rsplit("-", 1)[1])


def custom_plugins() -> dict:
    """Phase 28's custom plugins (kube_scheduler_simulator_tpu_torch.plugins.custom):
    EvenNodesOnly filters and scores, HugeScorer scores past int32 (2^33),
    HalfNormalize scores and has a NormalizeScore -> {name: instance}."""
    from kube_scheduler_simulator_tpu_torch.plugins.custom import CustomPlugin

    class EvenNodesOnly(CustomPlugin):
        name = "EvenNodesOnly"
        default_weight = 2

        def filter(self, pod, node):
            return None if _node_index(node) % 2 == 0 else "odd nodes not allowed"

        def score(self, pod, node):
            return _node_index(node)

    class HugeScorer(CustomPlugin):
        name = "HugeScorer"

        def score(self, pod, node):
            return (1 << 33) + _node_index(node)

    class HalfNormalize(CustomPlugin):
        name = "HalfNormalize"
        default_weight = 3

        def score(self, pod, node):
            return _node_index(node) * 10

        def normalize(self, scores):
            return [v // 2 for v in scores]

    return {p.name: p for p in (EvenNodesOnly(), HugeScorer(), HalfNormalize())}


def chunk_ms(step, w, xs, reps: int = 5) -> float:
    """step_chunk's device ms on one chunk: `reps` launches back to back
    after an untimed one, each on a fresh copy of w's initial carry (as
    phase 5 times it), the median."""
    import torch

    from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry

    carries = [_clone_carry(w.init_carry) for _ in range(reps + 1)]
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    step.scan(carries[0], xs)
    marks[0].record()
    for k in range(reps):
        step.scan(carries[k + 1], xs)
        marks[k + 1].record()
    torch.cuda.synchronize()
    return sorted(marks[k].elapsed_time(marks[k + 1]) for k in range(reps))[reps // 2]


def custom_phase(dev, card: str, nodes: list, pods: list, cfg) -> dict:
    """Phase 28: custom and guest plugins (B13, their [P, N] filter and
    score rows read by the per-pod body of csrc/pod.cuh).  (a) config 5's
    plugins plus EvenNodesOnly and HugeScorer over CUSTOM_PODS pods on its
    nodes through replay() on the card: chunks 0-1 against the plain step,
    sampled decodes against the plain replay's, step_chunk's ms on chunk 0
    with and without the custom plugins; (b) a guest file loaded through
    SchedulerService with a config shaped like examples/scheduler.yaml
    (the default profile plus the guest), GUEST_PODS pods through
    SchedulerEngine.schedule_pending() against a direct replay(); (c) a
    custom NormalizeScore on the engine's host path (phased_eval with the
    rows), against phased_eval's plain version and against device="cpu";
    (d) replay(mesh=make_mesh(CUSTOM_MESH_SHARDS)) of (a)'s workload
    against (a).  -> B13's entry for the JSON line."""
    import copy
    import tempfile

    import torch
    from torch import profiler

    from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
    from kube_scheduler_simulator_tpu_torch.framework import pipeline
    from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import (
        ReplayResult, _CompactChunks, _clone_carry, _compact_plan, replay)
    from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
    from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
    from kube_scheduler_simulator_tpu_torch.parallel import make_mesh, shard_workload
    from kube_scheduler_simulator_tpu_torch.plugins import custom as pcustom
    from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
    from kube_scheduler_simulator_tpu_torch.scheduler.service import SchedulerService
    from kube_scheduler_simulator_tpu_torch.state import compile_workload
    from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result
    from kube_scheduler_simulator_tpu_torch.store import annotations as ann
    from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

    kernels = (kstep.step_chunk, kmesh.step_chunk_sharded, kphased.phased_eval,
               kphased.renormalize_rows, kspec.spec_eval, kspec.spec_round,
               kspec.spec_commit_bind)

    def reset() -> None:
        for f in kernels:
            f.launches = 0

    def counts() -> dict:
        return {f.__name__: f.launches for f in kernels if f.launches}

    n = len(nodes)
    plugins = custom_plugins()
    rows = ("EvenNodesOnly", "HugeScorer")
    qpods = pods[:CUSTOM_PODS]

    # ---- (a) replay with custom rows
    t28 = time.perf_counter()
    orig_build, build_s = pcustom.build_custom, []

    def timed_build(*a, **kw):
        t0 = time.perf_counter()
        out = orig_build(*a, **kw)
        build_s.append(time.perf_counter() - t0)
        return out

    ccfg = PluginSetConfig(enabled=list(cfg.enabled) + list(rows),
                           custom={k: plugins[k] for k in rows}, weights=dict(cfg.weights),
                           args=copy.deepcopy(cfg.args))
    pcustom.build_custom = timed_build  # compile_workload calls it through the module
    try:
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated(dev)
        t0 = time.perf_counter()
        ccw = compile_workload(nodes, qpods, ccfg, device=dev)
        torch.cuda.synchronize()
        compile_s = time.perf_counter() - t0
    finally:
        pcustom.build_custom = orig_build
    row_bytes = sum(t.numel() * t.element_size() for k in rows for t in ccw.xs[k])
    check(ccw.config.filters()[-1] == "EvenNodesOnly"
          and ccw.config.scorers()[-2:] == list(rows), "custom plugins' order")
    check(all(ccw.host["score_dtypes"][ccw.config.scorers().index(k)] == "host" for k in rows),
          "custom raws are not host columns")
    reset()
    t0 = time.perf_counter()
    crr = replay(ccw, chunk=CHUNK, device="cuda")
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launched_a = counts()
    mem_retained = torch.cuda.memory_allocated(dev) - mem0
    n_chunks = -(-CUSTOM_PODS // CHUNK)
    check(launched_a.get("step_chunk", 0) == n_chunks * len(crr.tiers),
          f"(a) launches {launched_a} for {n_chunks} chunks x tiers {crr.tiers}")
    wide = crr.tiers[-1]
    pack_mode, score_dtypes, _ = _compact_plan(ccw, wide)
    step_c = build_step(ccw, out_mode="compact", pack_mode=pack_mode,
                        score_dtypes=score_dtypes, wide_raw=wide)
    plain_chunks = _CompactChunks(chunk=CHUNK, pack_mode=pack_mode,
                                  score_cols=crr._compact.score_cols)
    sel, feas = crr.selected.copy(), crr.feasible_count.copy()
    carry = _clone_carry(ccw.init_carry)
    xs_chunks = [batch_xs(ccw, lo, CHUNK) for lo in range(0, CUSTOM_PODS, CHUNK)]
    for ci, xs in enumerate(xs_chunks):
        carry, out = step_c.plain_scan(carry, xs)
        host = {f: getattr(out, f).cpu().numpy() for f in out._fields}
        for grp, fld in (("packed", "packed_filter"), ("raw8", "raw8"), ("raw16", "raw16"),
                         ("raw32", "raw32")):
            check((crr._compact.host(grp, ci) == host[fld]).all(),
                  f"(a) chunk {ci}: compact {fld} differs from the plain step")
            getattr(plain_chunks, grp).append(host[fld])
        lo = ci * CHUNK
        for fld, got in (("selected", crr.selected), ("feasible_count", crr.feasible_count)):
            check((host[fld] == got[lo:lo + CHUNK]).all(),
                  f"(a) chunk {ci}: {fld} differs from the plain step")
        sel[lo:lo + CHUNK], feas[lo:lo + CHUNK] = host["selected"], host["feasible_count"]
    plain_rr = ReplayResult(cw=ccw, selected=sel, feasible_count=feas,
                            prefilter_reject=crr.prefilter_reject.copy(), compact=plain_chunks)
    sample = sorted(set(range(0, CUSTOM_PODS, CUSTOM_PODS // 8)) | {CUSTOM_PODS - 1})
    names = ccw.node_table.names
    vetoes = 0  # sampled pods whose filter-result shows EvenNodesOnly's message
    for i in sample:
        got = decode_pod_result(crr, i)
        check(got == decode_pod_result(plain_rr, i), f"(a) pod {i}: annotations differ from "
                                                     "the plain replay's")
        s_i = int(crr.selected[i])
        check(s_i < 0 or s_i % 2 == 0, f"(a) pod {i} on odd node {s_i}")
        scores = json.loads(got[ann.SCORE_RESULT])
        if s_i >= 0 and len(scores) > 1:
            check(scores[names[s_i]]["HugeScorer"] == str((1 << 33) + s_i),
                  f"(a) pod {i}: HugeScorer raw {scores[names[s_i]]}")
        # a node's record stops at its first failing plugin
        msg = json.loads(got[ann.FILTER_RESULT]).get(names[1], {}).get("EvenNodesOnly")
        check(msg in (None, "odd nodes not allowed"), f"(a) pod {i}: filter-result {msg!r}")
        vetoes += msg is not None
    check(crr.scheduled > 0 and vetoes > 0, f"(a) scheduled {crr.scheduled}, vetoes {vetoes}")
    # step_chunk on chunk 0 with and without the custom plugins: the same
    # pods compiled without them, so every other row is the same
    bcw = compile_workload(nodes, qpods, cfg, device=dev)
    b_pack, b_dtypes, _ = _compact_plan(bcw, wide)
    step_0 = build_step(bcw, out_mode="compact", pack_mode=b_pack, score_dtypes=b_dtypes,
                        wide_raw=wide)
    xs0 = batch_xs(bcw, 0, CHUNK)
    with_ms, without_ms = chunk_ms(step_c, ccw, xs_chunks[0]), chunk_ms(step_0, bcw, xs0)
    with_ms2, without_ms2 = chunk_ms(step_c, ccw, xs_chunks[0]), chunk_ms(step_0, bcw, xs0)
    all_feasible = torch.ones(n, dtype=torch.bool, device=dev)

    def plain_rows():  # the plain step's custom branches on chunk 0, as phase 13 times B9
        for i in range(CHUNK):
            sl = pipeline.slice_pod(xs_chunks[0], i)
            for k in rows:
                if plugins[k].has_filter:
                    pipeline._filter_one(k, ccw, None, sl)
                pipeline._score_one(k, ccw, None, sl, all_feasible)

    plain_ms = timed_once(plain_rows)
    # B13's bytes a chunk: each custom filter's int32 code and each custom
    # scorer's int64 raw, read once per (pod, node)
    b13_bytes = CHUNK * n * (4 * sum(plugins[k].has_filter for k in rows)
                             + 8 * sum(plugins[k].has_score for k in rows))
    b13_bound_ms, b13_bound_by = bound(b13_bytes)
    rows_ms = min(with_ms, with_ms2) - min(without_ms, without_ms2)
    print(f"[28a custom rows] {card}: config {CONFIG}'s plugins + {list(rows)} over "
          f"{CUSTOM_PODS} pods x {n} nodes through replay(): {len(ccw.config.filters())} "
          f"filters, {len(ccw.config.scorers())} scorers; compile {compile_s:.3f} s, of it "
          f"build_custom {sum(build_s):.3f} s ({len(build_s)} plugins, one Python call per "
          f"(pod, node) and point); rows {row_bytes} B on the card; replay {replay_s:.4f} s, "
          f"scheduled {crr.scheduled}, tiers {list(crr.tiers)}, launches {launched_a}; device "
          f"memory the run retains {mem_retained} B; chunks 0-1 equal the plain step "
          f"(selected, feasible_count, compact outputs), decodes of pods {sample} equal the "
          f"plain replay's; step_chunk on chunk 0 (the same pods compiled without the custom "
          f"plugins, alternating) with the rows {with_ms:.3f} / {with_ms2:.3f} ms, without "
          f"{without_ms:.3f} / {without_ms2:.3f} ms (the rows' share {rows_ms:.3f} ms, the "
          f"lesser of each); S = {kstep.step_chunk.shards}; the plain step's custom branches "
          f"on that chunk {plain_ms:.3f} ms; B13 bound {b13_bound_ms:.6f} "
          f"ms a chunk by {b13_bound_by} ({b13_bytes} B); {time.perf_counter() - t28:.1f} s",
          flush=True)

    # ---- (b) a guest through the service, the default profile + the guest
    tb = time.perf_counter()
    gpods = qpods[:GUEST_PODS]
    with tempfile.TemporaryDirectory() as tmp:
        guest = Path(tmp) / "guest_plugin.py"
        guest.write_text(GUEST_SRC)
        sched_cfg = {
            "apiVersion": "kubescheduler.config.k8s.io/v1",
            "kind": "KubeSchedulerConfiguration",
            "profiles": [{
                "schedulerName": "default-scheduler",
                "plugins": {"multiPoint": {"enabled": [
                    {"name": "NodeResourcesFit", "weight": 2},
                    {"name": "NodeAffinity", "weight": 3}, {"name": "MyGuest"}]}},
                "pluginConfig": [{"name": "MyGuest", "args": {"guestURL": str(guest)}}],
            }],
        }
        store = ObjectStore()
        for res, items in (("nodes", nodes), ("pods", gpods)):
            for obj in items:
                store.create(res, obj)
        engine = SchedulerEngine(store)
        svc = SchedulerService(engine)
        svc.restart_scheduler(sched_cfg)
        gcfg = engine.plugin_config
        check("MyGuest" in gcfg.custom and len(gcfg.scorers()) == 9
              and len(gcfg.filters()) == 13,
              f"(b) the guest's profile: {len(gcfg.filters())} filters, "
              f"{len(gcfg.scorers())} scorers")
        reset()
        TRACER.reset()
        with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bound_b = engine.schedule_pending()
            torch.cuda.synchronize()
            wall_b = time.perf_counter() - t0
        launched_b = counts()
        busy = _device_busy_s(prof)
        spans = {k: round(v["total_seconds"], 4) for k, v in TRACER.summary()["spans"].items()
                 if k in ("compile_workload", "replay_and_decode_stream", "commit_stream",
                          "commit_and_reflect")}
        check(launched_b.get("step_chunk", 0) > 0, f"(b) no step_chunk launch: {launched_b}")
        ref = replay(compile_workload(nodes, gpods, gcfg, device=dev), chunk=CHUNK,
                     device="cuda")
        check(bound_b == ref.scheduled, f"(b) engine bound {bound_b}, replay {ref.scheduled}")
        by_name = {q["metadata"]["name"]: q for q in store.list("pods")[0]}
        vetoes = 0
        for i, q in enumerate(gpods):
            got = by_name[q["metadata"]["name"]]
            s_i = int(ref.selected[i])
            check(got["spec"].get("nodeName") == (names[s_i] if s_i >= 0 else None),
                  f"(b) pod {i}: node differs from replay()")
            check(s_i < 0 or s_i % 3 != 0, f"(b) pod {i} on a node the guest vetoes")
            if i in sample or i == GUEST_PODS - 1:
                want = decode_pod_result(ref, i)
                for key in ALL_PLUGIN_KEYS:
                    check(got["metadata"]["annotations"].get(key) == want[key],
                          f"(b) pod {i} {key}")
                msg = json.loads(want[ann.FILTER_RESULT]).get(names[0], {}).get("MyGuest")
                check(msg in (None, "guest says no"), f"(b) pod {i}: filter-result {msg!r}")
                vetoes += msg is not None
        check(vetoes > 0, "(b) no sampled filter-result shows the guest's message")
        engine.close()
        del store, engine
    idle_b = f"{1 - busy / wall_b:.4f}" if busy > 0 else "not measured"
    print(f"[28b guest] {card}: a guest file importing the port's CustomPlugin, loaded by "
          f"SchedulerService.restart_scheduler (examples/scheduler.yaml's shape: the default "
          f"profile + MyGuest, 13 filters, 9 scorers); {GUEST_PODS} pods x {n} nodes through "
          f"schedule_pending(): bound {bound_b}, wall {wall_b:.4f} s, device busy {busy:.4f} s, "
          f"idle share {idle_b}, engine spans (s) {spans}, launches {launched_b}; every pod's "
          f"node and the sampled annotations equal a direct replay(); "
          f"{time.perf_counter() - tb:.1f} s", flush=True)

    # ---- (c) a custom NormalizeScore on the host path (phased_eval + rows)
    tc = time.perf_counter()
    hcfg = PluginSetConfig(enabled=list(cfg.enabled) + ["HalfNormalize", "EvenNodesOnly"],
                           custom={k: plugins[k] for k in ("HalfNormalize", "EvenNodesOnly")},
                           weights=dict(cfg.weights), args=copy.deepcopy(cfg.args))
    hpods = [copy.deepcopy(q) for q in qpods[:HOST_CUSTOM_PODS]]
    hcw = compile_workload(nodes, hpods, hcfg, device=dev)
    ph = pipeline.build_phased(hcw)
    hcarry = _clone_carry(hcw.init_carry)
    pe_err = 0
    for i in range(8):
        xs1 = batch_xs(hcw, i, 1)
        out, want = ph.eval(hcarry, xs1), ph.plain_eval(hcarry, xs1)
        e_i = tree_err(list(out), list(want))
        check(e_i == 0, f"(c) phased_eval pod {i} differs from its plain version ({e_i})")
        pe_err = max(pe_err, e_i)
        hcarry = ph.bind(hcarry, xs1, int(want.selected))
    pe, e_i = phased_times(ph, hcarry, batch_xs(hcw, 8, 1))
    pe_err = max(pe_err, e_i)
    snaps, lines_c = [], []
    for device in ("cuda", "cpu"):
        store = ObjectStore()
        for res, items in (("nodes", nodes), ("pods", hpods)):
            for obj in items:
                store.create(res, obj)
        engine = SchedulerEngine(store, plugin_config=hcfg, device=device)
        check(engine._needs_host_path(), "(c) a custom NormalizeScore not on the host path")
        reset()
        t0 = time.perf_counter()
        bound_c = engine.schedule_pending()
        if device == "cuda":
            torch.cuda.synchronize()
        wall_c = time.perf_counter() - t0
        launched = counts()
        if device == "cuda":
            launched_c = launched
            check(launched.get("phased_eval", 0) == len(hpods),
                  f"(c) phased_eval launches {launched}")
            check(launched.get("spec_commit_bind", 0) == bound_c, f"(c) binds {launched}")
        else:
            check(not launched, f"(c) the CPU run launched {launched}")
        snaps.append((bound_c, {q["metadata"]["name"]: (
            q["spec"].get("nodeName"), q["metadata"].get("annotations"))
            for q in store.list("pods")[0]}))
        lines_c.append(f"device={device}: bound {bound_c}, {wall_c:.3f} s = "
                       f"{wall_c * 1e3 / len(hpods):.3f} ms/pod")
        engine.close()
        del store, engine
    check(snaps[0] == snaps[1], "(c) the card's host path differs from device='cpu'")
    finals = 0  # HalfNormalize's finalscore = (raw // 2) x weight at each scored node
    for _node, annos in snaps[0][1].values():
        for node_name, entry in json.loads(annos.get(ann.FINAL_SCORE_RESULT) or "{}").items():
            j = _node_index({"metadata": {"name": node_name}})
            check(entry["HalfNormalize"] == str((j * 10 // 2) * 3),
                  f"(c) HalfNormalize's final score at {node_name}: {entry['HalfNormalize']}")
            finals += 1
    check(finals > 0, "(c) no finalscore-result recorded")
    print(f"[28c host path] {card}: config {CONFIG}'s plugins + HalfNormalize (NormalizeScore "
          f"in Python) + EvenNodesOnly, {len(hpods)} pods on {n} nodes through the engine's "
          f"host path: {'; '.join(lines_c)}; launches on the card {launched_c}; nodes and "
          f"annotations equal; phased_eval with the rows == plain (max_abs_err {pe_err}), "
          f"plan S={pe['S']} {pe['ms']:.5f} ms, forced "
          f"{', '.join(f'S={k} {v:.5f}' for k, v in pe['forced'].items())}, bound "
          f"{pe['bound'][0]:.6f} ms by {pe['bound'][1]}; {time.perf_counter() - tc:.1f} s",
          flush=True)

    # ---- (d) the mesh: replay(mesh=) of (a)'s workload
    td = time.perf_counter()
    reset()
    mrr = replay(ccw, chunk=CHUNK, device="cuda", mesh=make_mesh(CUSTOM_MESH_SHARDS, device=dev))
    torch.cuda.synchronize()
    launched_d = counts()
    check(launched_d.get("step_chunk_sharded", 0) == n_chunks * len(mrr.tiers),
          f"(d) launches {launched_d}")
    same_replay(mrr, crr, f"(d) mesh S={CUSTOM_MESH_SHARDS} vs (a)", sample)
    del mrr
    # chunk 0 with the rows on the mesh, timed as (a) times step_chunk, in
    # turns with the unsharded launch
    mstep = build_step(shard_workload(ccw, make_mesh(CUSTOM_MESH_SHARDS, device=dev)),
                       out_mode="compact", pack_mode=pack_mode, score_dtypes=score_dtypes,
                       wide_raw=wide)
    mesh_ms = [chunk_ms(mstep, ccw, xs_chunks[0]), chunk_ms(step_c, ccw, xs_chunks[0]),
               chunk_ms(mstep, ccw, xs_chunks[0])]
    print(f"[28d mesh] {card}: (a)'s workload through replay(mesh=make_mesh("
          f"{CUSTOM_MESH_SHARDS})): launches {launched_d}; selected, feasible_count, every "
          f"compact chunk and the sampled decodes equal (a) | chunk 0 with the rows, ms (in "
          f"turns: mesh, unsharded, mesh): step_chunk_sharded {mesh_ms[0]:.3f}, "
          f"{mesh_ms[2]:.3f} (G={kmesh.step_chunk_sharded.groups}), step_chunk "
          f"{mesh_ms[1]:.3f} (with_ms in (a): {with_ms:.3f}, {with_ms2:.3f}); "
          f"{time.perf_counter() - td:.1f} s", flush=True)

    launches = (launched_a.get("step_chunk", 0) + launched_b.get("step_chunk", 0)
                + launched_c.get("phased_eval", 0) + launched_d.get("step_chunk_sharded", 0))
    return {
        "name": "step_chunk[B13 custom rows]", "route": "cuda",
        "source": "kube_scheduler_simulator_tpu_torch/csrc/pod.cuh",
        "replaces": "kube_scheduler_simulator_tpu/framework/pipeline.py:107",
        "launches": launches, "max_abs_err": pe_err, "ms": rows_ms, "plain_ms": plain_ms,
        "bound_ms": b13_bound_ms, "bound_by": b13_bound_by, "library_ms": None,
    }


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

    # ---- 2. the build: one nvcc per csrc/*.cu, all started together
    t0 = time.perf_counter()
    # every library, and with them the phase clock's build (phase 27 alone
    # loads it; the main path never does)
    built = build.build([*build.SIGNATURES])
    for stem in built:
        if stem not in build.VARIANTS:
            build.load(stem)
    build_s = time.perf_counter() - t0
    for stem, res in built.items():
        print(f"[2 build] {res.path.name} compiled={res.compiled} seconds={res.seconds:.2f} "
              f"| {ptxas_summary(res.log)}", flush=True)
    print(f"[2 build] {len(built)} libraries in {build_s:.2f} s wall", flush=True)

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
    with env(KSS_TPU_HOST_RESIDENT="1"):  # phase 15 runs the default, device-resident rung
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
    with env(KSS_TPU_DISABLE_NATIVE="1"):  # the Python encoder, as phase 16 compares
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
          f"13 keys on pods {sample}; decode_pod_result {decode_ms:.3f} ms/pod (Python encoder, "
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
    bound_ms, bound_by = bound(move_bytes, CHUNK * n * 22)
    # the bytes one pod touches (node-axis state rows + its own rows +
    # its compact outputs), over the whole queue
    pod_bytes = (n * (2 * r + 4) * 8 + n * 5 + n * 4 + n + g * n * 8 + t * n * 4 * 6
                 + out_bytes // CHUNK)
    queue_bound_ms = pod_bytes * p / HBM_BYTES_PER_S * 1e3
    check(kstep.step_chunk.shards in (8, 16),
          f"step_chunk took a cluster of {kstep.step_chunk.shards} CTAs, not 8 or 16")
    print(f"[5 timing] {card}: step_chunk on a cluster of S = {kstep.step_chunk.shards} CTAs "
          f"{kernel_ms:.3f} ms/chunk (median of {reps}; "
          f"queue mean {sum(chunk_ms) / len(chunk_ms):.3f} ms/chunk); plain step "
          f"{plain_ms:.3f} ms/chunk = {plain_ms / CHUNK:.4f} ms/pod; bound {bound_ms:.5f} "
          f"ms/chunk by {bound_by} ({move_bytes} B); per-pod touch bound "
          f"{pod_bytes} B/pod -> {queue_bound_ms:.3f} ms/queue", flush=True)

    step_entry = {
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
    }
    del chunk_inputs, outs0

    spec_ctx, spec_entries = speculative_phases(dev, card, cw, pods, rr)
    dp_ctx, b9_entries = default_profile_phases(dev, card)
    dp_ctx["decode_ms"] = {4: decode_ms, 11: dp_ctx["decode_ms"]}
    att_entry = result_path_phases(dev, card, cw, pods, rr, spec_ctx, dp_ctx)
    engine_entries = engine_phases(dev, card, cw, nodes, pods, cfg, rr)
    fuse_entries = fuse_phases(dev, card, cw, nodes, pods, cfg, spec_ctx)
    mesh_entries = mesh_phases(dev, card, cw, nodes, pods, cfg, rr, spec_ctx, dp_ctx,
                               step_entry)
    clock_phase(dev, card, {f"config {CONFIG}": cw, "default profile": dp_ctx["default"][0]})
    b13_entry = custom_phase(dev, card, nodes, pods, cfg)
    columnar_phase(dev, card, cfg)
    print(json.dumps({"kernels": [step_entry, *spec_entries, att_entry, *b9_entries,
                                  *engine_entries, *fuse_entries, *mesh_entries, b13_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


COLUMNAR_NODES = 5_000         # phase 29: config 5's fleet, from make_nodes_columnar
COLUMNAR_WAVES = 4             # phase 29: waves of COLUMNAR_WAVE_PODS from make_pods_columnar
COLUMNAR_WAVE_PODS = 2_500
COLUMNAR_UPDATES = 64          # phase 29: node updates before wave 3 (the delta patch)


def _plain_manifest(obj: dict, name: str | None = None) -> dict:
    """A generated manifest as a client would create it: no uid,
    resourceVersion or creationTimestamp (the store stamps them)."""
    import copy

    out = copy.deepcopy(dict(obj))
    meta = out["metadata"]
    for key in ("uid", "resourceVersion", "creationTimestamp"):
        meta.pop(key, None)
    if name is not None:
        meta["name"] = name
    return out


def columnar_phase(dev, card: str, cfg) -> None:
    """Phase 29: the engine over the store's columnar plane at config 5's
    width.  COLUMNAR_NODES nodes from make_nodes_columnar, bulk-loaded,
    and COLUMNAR_WAVES waves of COLUMNAR_WAVE_PODS pods from
    make_pods_columnar (the first bulk-loaded, the later created one by
    one), each scheduled by SchedulerEngine.schedule_pending() with
    config 5's plugins.  Between waves: nothing (the node table reused),
    COLUMNAR_UPDATES node updates (patched), one node added (rebuilt).
    Run with KSS_TPU_COLUMNAR=1 and =0 in turns; every pod's node and
    annotation bytes equal between the two after every wave, and the
    first wave equal to phase 19's engine (a store filled by create())
    on the same manifests.  Each wave prints the compile's split and
    counters, the wall and the device's idle share."""
    import torch
    from torch import profiler

    from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
    from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
    from kube_scheduler_simulator_tpu_torch.kernels import attribution as katt
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
    from kube_scheduler_simulator_tpu_torch.models import (make_nodes_columnar,
                                                           make_pods_columnar)
    from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER

    t29 = time.perf_counter()
    kernels = (*kspec.KERNELS, kstep.step_chunk, katt.chunk_attribution)

    def node_bank():
        return make_nodes_columnar(COLUMNAR_NODES, seed=SEED, taint_fraction=0.1,
                                   unschedulable_fraction=0.01)

    def pod_bank(w: int):
        return make_pods_columnar(COLUMNAR_WAVE_PODS, seed=SEED + w, with_affinity=True)

    def wave_pods(w: int) -> list:
        bank = pod_bank(w)
        return [_plain_manifest(bank.synthesize(r), f"w{w}-pod-{r:05d}") for r in range(bank.n)]

    def state(store) -> dict:
        out = {}
        for q in store.list("pods")[0]:
            meta = q["metadata"]
            out[meta["name"]] = ((q.get("spec") or {}).get("nodeName"),
                                 dict(meta.get("annotations") or {}))
        return out

    def edit(store, w: int) -> str:
        """The churn before wave w -> what the compile should do."""
        if w == 2:
            return "reuse"
        if w == 3:
            for i in range(0, COLUMNAR_NODES, COLUMNAR_NODES // COLUMNAR_UPDATES)[
                    :COLUMNAR_UPDATES]:
                nd = store.get("nodes", f"node-{i:05d}")
                nd["status"]["allocatable"]["cpu"] = "96000m"
                store.update("nodes", nd)
            return "delta patch"
        store.create("nodes", {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": "node-added", "labels": {
                "kubernetes.io/hostname": "node-added", "disktype": "ssd",
                "topology.kubernetes.io/zone": "zone-0",
                "topology.kubernetes.io/region": "region-0",
                "node.kubernetes.io/instance-type": "type-0"}},
            "status": {"allocatable": {"cpu": "64000m", "memory": str(256 << 30),
                                       "ephemeral-storage": str(512 << 30), "pods": "110"}}})
        return "rebuild"

    def wave(store, engine) -> tuple:
        for f in kernels:
            f.launches = 0
        TRACER.reset()
        with profiler.profile(activities=[profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            bound_n = engine.schedule_pending()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy = _device_busy_s(prof)
        split = compile_split(TRACER)
        launched = {f.__name__: f.launches for f in kernels if f.launches}
        check(launched, "an engine wave over the columnar store launched no kernel")
        idle = f"{1 - busy / wall:.4f}" if busy > 0 else "not measured"
        return bound_n, wall, idle, split, launched

    want_counts = {"build": {"node_table_builds_total": 1},
                   "reuse": {"node_table_reuse_total": 1},
                   "delta patch": {"node_table_delta_patches_total": 1,
                                   "node_table_delta_rows_total": COLUMNAR_UPDATES},
                   "rebuild": {"node_table_builds_total": 1}}
    arms, lines = {}, []
    for columnar in ("1", "0"):
        with env(KSS_TPU_COLUMNAR=columnar, KSS_TPU_SPECULATIVE=None,
                 KSS_TPU_HOST_RESIDENT=None, KSS_TPU_EAGER_DECODE=None,
                 KSS_TPU_DEVICE_RESULT_BUDGET_MB=None):
            t0 = time.perf_counter()
            store = ObjectStore()
            store.load_columnar("nodes", node_bank())
            store.load_columnar("pods", pod_bank(1))
            load_s = time.perf_counter() - t0
            engine = SchedulerEngine(store, plugin_config=cfg)
            states, waves = [], []
            for w in range(1, COLUMNAR_WAVES + 1):
                what = "build" if w == 1 else edit(store, w)
                if w > 1:
                    for q in wave_pods(w):
                        store.create("pods", q)
                bound_n, wall, idle, split, launched = wave(store, engine)
                moved = {k: v for k, v in split.items()
                         if k in COMPILE_COUNTERS[:4] and v}
                check(moved == want_counts[what],
                      f"KSS_TPU_COLUMNAR={columnar} wave {w} ({what}): counters {moved}")
                gathered = split["compile_requests_gathered_total"]
                check((gathered > 0) == (columnar == "1"),
                      f"KSS_TPU_COLUMNAR={columnar} wave {w}: {gathered} request rows gathered")
                check(bound_n > 0, f"KSS_TPU_COLUMNAR={columnar} wave {w} bound no pod")
                states.append(state(store))
                waves.append(f"wave {w} ({what}): bound {bound_n}, wall {wall:.4f} s, idle "
                             f"share {idle}, compile split (s) and counters {split}, launches "
                             f"{launched}")
            engine.close()
            arms[columnar] = states
            lines.append(f"KSS_TPU_COLUMNAR={columnar} (load {load_s:.3f} s): "
                         + "; ".join(waves))
            del store, engine
    for w, (a, b) in enumerate(zip(arms["1"], arms["0"]), 1):
        check(a.keys() == b.keys(), f"wave {w}: the arms hold different pods")
        for name in b:
            check(a[name] == b[name], f"wave {w}: pod {name} differs between KSS_TPU_COLUMNAR=1 "
                                      f"and =0")
    # phase 19's engine (a store filled by create()) on the first wave's
    # manifests
    nb = node_bank()
    store = ObjectStore()
    for r in range(nb.n):
        store.create("nodes", _plain_manifest(nb.synthesize(r)))
    pb = pod_bank(1)
    for r in range(pb.n):
        store.create("pods", _plain_manifest(pb.synthesize(r)))
    engine = SchedulerEngine(store, plugin_config=cfg)
    bound19, wall19, idle19, split19, _ = wave(store, engine)
    engine.close()
    first = state(store)
    check(first == arms["1"][0], "wave 1 differs from phase 19's engine on the same manifests")
    del store, engine
    print(f"[29 columnar store] {card}: {COLUMNAR_NODES} nodes from make_nodes_columnar and "
          f"{COLUMNAR_WAVES} waves of {COLUMNAR_WAVE_PODS} pods from make_pods_columnar, config "
          f"{CONFIG}'s plugins, SchedulerEngine.schedule_pending(): {' | '.join(lines)} | every "
          f"pod's node and annotation bytes equal between the arms after every wave; wave 1 "
          f"equal to phase 19's engine on the same manifests (bound {bound19}, wall "
          f"{wall19:.4f} s, idle share {idle19}, compile {split19}); walls under a CUDA-only "
          f"torch.profiler trace; {time.perf_counter() - t29:.1f} s", flush=True)


if __name__ == "__main__":
    try:
        if "--ladder" in sys.argv[1:]:
            at = sys.argv.index("--root") + 1 if "--root" in sys.argv else 0
            sel = sys.argv.index("--only") + 1 if "--only" in sys.argv else 0
            sys.exit(ladder_main(Path(sys.argv[at]).resolve() if at else ROOT,
                                 set(sys.argv[sel].split(",")) if sel else None))
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
