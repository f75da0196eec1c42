"""The step kernel (csrc/step.cu) against its plain PyTorch version, on
the card: every output and the carry equal, exactly, in "full" mode and
in "compact" mode under every pack mode and raw-width tier, on configs
1-5 at test scale, the tiny workload, a workload with per-slot spread
eligibility, and the scheduler's default profile (every plugin row of
the default lineup, the volume family included); the speculative wave's
kernels likewise, the SAFE-set fleet included; B7, the chunk
attribution, in every pack mode and raw tier, at config 5's full width
and an odd node count, at its limits (16 filters, 8 device columns, all
pad rows), in every forced shape and on two streams at once; the
device-resident replay and stream, B8 (on any group layout, at each
path, G past shared memory, from four threads at once through its
page-locked copies), B10 and the engine on the card against the CPU
port; and B11, the fused round, against its members' solo launches and
plain rounds (members on streams of their own included), and sessions
on the card fused against unfused; and B12, the node-sharded step and
dense eval at 1, 2, 4 and 8 shards, against their plain twins and the
unsharded kernels; step_chunk's cluster at 8 and 16 CTAs, from several
threads at once, and past shared memory (its state in device memory),
and spec_commit_bind's grid of node slices against their plain versions;
and the eval kernel's cluster (spec_eval and phased_eval) at the plan's
cluster size and at every forced one; and the two table kernels over K =
1, 2, 4, 8, 16 sessions (the dense eval's clusters, the sparse round's
pod groups) against the solo launches and the plain versions; and B13,
custom plugins' filter and score rows, in step_chunk, step_chunk_sharded
and phased_eval against their plain versions; and the oracle (B3, and
B11's fused oracle over K = 1..8 sessions, two streams at once) at every
batch kind, pack width and CTA count, with B5's core commit folded into
its launch (solo and over K = 2, 4, 16 sessions, folded and not, two
streams at once) against the plain oracle then commit_plain, and
renormalize_rows (B10) at every R and G.  A CUDA kernel has
no CPU mode, so these tests skip where there is no card; run them on one
with

    python -m pytest tests/test_torch_kernel.py -q
"""

import pytest
import torch

from kube_scheduler_simulator_tpu_torch.framework.pipeline import PACK_MODES, build_step
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _slice_xs
from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
from kube_scheduler_simulator_tpu_torch.models import baseline_config, make_nodes, make_pods
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload

pytestmark = pytest.mark.cuda

SIX = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
       "TaintToleration", "PodTopologySpread", "InterPodAffinity"]
MODES = ([("full", "p16", None)]
         + [("compact", pm, w) for pm in PACK_MODES for w in (None, "i32", "i64")])


def _policies():
    nodes = make_nodes(24, seed=5, taint_fraction=0.3)
    pods = make_pods(40, seed=6, with_affinity=True, with_tolerations=True,
                     with_spread=True, with_interpod=True)
    for i, pod in enumerate(pods):
        for c in pod["spec"].get("topologySpreadConstraints", []):
            if i % 3 == 0:
                c["nodeTaintsPolicy"] = "Honor"
            if i % 5 == 2 and c["whenUnsatisfiable"] == "DoNotSchedule":
                c["minDomains"] = 12
    return nodes, pods, PluginSetConfig(enabled=list(SIX))


WORKLOADS = {
    **{f"config{i}": (lambda i=i, s=s: baseline_config(i, scale=s, seed=0))
       for i, s in ((1, 1.0), (2, 0.1), (3, 0.02), (4, 0.01), (5, 0.05))},
    "tiny": lambda: (make_nodes(8, seed=3, taint_fraction=0.2),
                     make_pods(16, seed=4, with_affinity=True, with_tolerations=True,
                               with_spread=True, with_interpod=True),
                     PluginSetConfig(enabled=list(SIX))),
    "policies": _policies,
}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the step kernel has no CPU mode")
    return torch.device("cuda", 0)


def _leaves(carry):
    for v in carry.values():
        yield from ([v] if isinstance(v, torch.Tensor) else list(v))


@pytest.mark.parametrize("wl", list(WORKLOADS))
def test_kernel_matches_plain(card, wl):
    cw = compile_workload(*WORKLOADS[wl](), device=card)
    chunk = 32
    for out_mode, pack_mode, wide in MODES:
        step = build_step(cw, out_mode=out_mode, pack_mode=pack_mode,
                          score_dtypes=cw.host["score_dtypes"], wide_raw=wide)
        ck, cp = _clone_carry(cw.init_carry), _clone_carry(cw.init_carry)
        launches = kstep.step_chunk.launches
        for lo in range(0, cw.n_pods, chunk):
            hi = min(lo + chunk, cw.n_pods)
            xs = _slice_xs(cw.xs, lo, hi, chunk)
            xs["is_pad"] = torch.arange(chunk, device=card) >= (hi - lo)
            ck, ok = step.scan(ck, xs)
            cp, op = step.plain_scan(cp, xs)
            for f in ok._fields:
                a, b = getattr(ok, f), getattr(op, f)
                assert a.dtype == b.dtype and a.shape == b.shape, f
                assert torch.equal(a.cpu(), b.cpu()), (out_mode, pack_mode, wide, lo, f)
            for a, b in zip(_leaves(ck), _leaves(cp)):
                assert torch.equal(a, b), (out_mode, pack_mode, wide, lo, "carry")
        assert kstep.step_chunk.launches - launches == -(-cw.n_pods // chunk)


# ------------------------------------------------ the speculative wave's kernels

def _slot_mixed():
    # pinned pods around broad ones, on nodes with taints: sparse rounds,
    # wide-feasibility rows, and every node-local scorer
    from kube_scheduler_simulator_tpu_torch.models import SLOT_LABEL, make_slot_pinned_workload

    _, pinned = make_slot_pinned_workload(40, 32, seed=71)
    nodes = make_nodes(32, seed=71, taint_fraction=0.3)
    for i, node in enumerate(nodes):
        node["metadata"]["labels"][SLOT_LABEL] = f"slot-{i % 16}"
    pods = pinned[:10] + make_pods(10, seed=72, with_tolerations=True) + pinned[10:]
    return nodes, pods, PluginSetConfig(enabled=SIX[:4])


def _safe_set():
    # the eight node-local plugins on a slot-pinned fleet with unschedulable
    # nodes, node images, hostPorts and nodeName pins (chip_smoke.py phase 12)
    import chip_smoke
    from kube_scheduler_simulator_tpu_torch.models import make_slot_pinned_workload
    from kube_scheduler_simulator_tpu_torch.parallel.speculative import SAFE_SPECULATIVE

    nodes, pods = make_slot_pinned_workload(96, 48, seed=3)
    chip_smoke.decorate_default_profile(nodes, pods, seed=3, volumes_on=False)
    return nodes, pods, PluginSetConfig(enabled=sorted(SAFE_SPECULATIVE))


SPEC_WORKLOADS = {"tiny": WORKLOADS["tiny"], "config5": WORKLOADS["config5"],
                  "slot_mixed": _slot_mixed, "safe_set": _safe_set}


def _batch(cw, lo, b, dev):
    hi = min(lo + b, cw.n_pods)
    xs = _slice_xs(cw.xs, lo, hi, b)
    xs["is_pad"] = torch.arange(b, device=dev) >= hi - lo
    return xs


def _equal(a, b, what):
    if isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        assert torch.equal(a.cpu(), b.cpu()), what
    elif isinstance(a, dict):
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    else:
        for k, (x, y) in enumerate(zip(a, b, strict=True)):
            _equal(x, y, f"{what}[{k}]")


@pytest.mark.parametrize("wl", list(SPEC_WORKLOADS))
@pytest.mark.parametrize("wide", [None, "i32", "i64"])
def test_spec_kernels_match_plain(card, wl, wide):
    """spec_eval, spec_oracle, spec_round (node-local sets), and the commit
    of the workload's variant, each against its plain version on the
    card, over batches with and without pad rows."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.parallel.speculative import SAFE_SPECULATIVE

    cw = compile_workload(*SPEC_WORKLOADS[wl](), device=card)
    pm, sd, _ = _compact_plan(cw, wide)
    step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd, wide_raw=wide)
    sparse = set(cw.config.active_plugins()) <= SAFE_SPECULATIVE
    carry = _clone_carry(cw.init_carry)
    for lo, b in ((0, 8), (5, 16), (cw.n_pods - 3, 8)):
        xs = _batch(cw, lo, b, card)
        ev = kspec.spec_eval(step, carry, xs)
        _equal(ev, kspec.eval_plain(step, carry, xs), f"spec_eval {lo}")
        k = kspec.spec_oracle(ev.packed_filter, ev.prefilter_reject, ev.selected)
        _equal(k, kspec._oracle_core(ev.packed_filter, ev.prefilter_reject, ev.selected, b),
               f"spec_oracle {lo}")
        if sparse:
            for kcand in (1, 4, cw.n_nodes - 1):
                got = kspec.spec_round(step, carry, xs, kcand)
                _equal(got, kspec.sparse_round_plain(step, carry, xs, kcand),
                       f"spec_round {lo} {kcand}")
        for acc in (0, 3, b):
            want = kspec.commit_plain(step, _clone_carry(carry), xs, ev.selected, acc)
            got = kspec.spec_commit(step, _clone_carry(carry), xs, ev.selected, acc)
            _equal(got, want, f"commit {lo} {acc}")
        carry = want


@pytest.mark.parametrize("pack", [torch.uint8, torch.uint16, torch.int32, torch.int64])
@pytest.mark.parametrize("n", [7, 8])
def test_grid_kernels_match_plain(card, pack, n):
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    chunk, extra = 16, 16
    gen = torch.Generator(device=card).manual_seed(n)
    shapes = {"packed": ((n,), pack), "raw8": ((2, n), torch.int8),
              "raw16": ((0, n), torch.int16), "raw32": ((3, n), torch.int64),
              "fc": ((), torch.int32)}

    def rand(rows, shape, dtype):
        return torch.randint(0, 100, (rows,) + shape, device=card, generator=gen,
                             dtype=torch.int32).to(dtype)

    for fill, b in ((0, 8), (5, 8), (15, 16), (3, 1)):
        bufs = {k: rand(chunk + extra, s, d) for k, (s, d) in shapes.items()}
        rows = {k: rand(b, s, d) for k, (s, d) in shapes.items()}
        got = kspec.grid_append({k: v.clone() for k, v in bufs.items()}, rows, fill)
        want = kspec.append_plain({k: v.clone() for k, v in bufs.items()}, rows, fill)
        _equal(got, want, f"append {fill} {b}")
        _equal(kspec.grid_emit(got, chunk), kspec.emit_plain(want, chunk), f"emit {fill} {b}")


@pytest.mark.parametrize("wl", list(SPEC_WORKLOADS))
def test_speculative_stream_on_card_matches_cpu(card, wl):
    """The whole stream on the card (every round through the kernels)
    equals the stream on the CPU (the plain versions), stats included."""
    from kube_scheduler_simulator_tpu_torch.parallel import replay_speculative_stream

    nodes, pods, cfg = SPEC_WORKLOADS[wl]()
    runs = []
    for dev in (card, "cpu"):
        cw = compile_workload(nodes, pods, cfg, device=dev)
        runs.append(replay_speculative_stream(cw, chunk=16, pods=pods))
    (rr, stats), (want, wstats) = runs
    assert stats == wstats
    assert (rr.selected == want.selected).all()
    for group in ("packed", "raw8", "raw16", "raw32"):
        assert len(getattr(rr._compact, group)) == len(getattr(want._compact, group)), group
        for ci in range(len(getattr(rr._compact, group))):
            a, b = rr._compact.host(group, ci), want._compact.host(group, ci)
            assert a.dtype == b.dtype and (a == b).all(), group


# ------------------------------------------------ the default profile (B9)

B9 = ["NodeUnschedulable", "NodeName", "NodePorts", "VolumeRestrictions", "NodeVolumeLimits",
      "VolumeBinding", "VolumeZone", "ImageLocality"]


def _default_profile():
    """BASELINE config 5 at 500 pods x 250 nodes, decorated as chip_smoke.py
    decorates its full-size fleet, with pods of two unbound claims and
    inline disks -> compile_workload's arguments."""
    import chip_smoke

    nodes, pods, _ = baseline_config(5, scale=0.05, seed=0)
    volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=0)
    disks = [{"gcePersistentDisk": {"pdName": "pd-1"}},
             {"awsElasticBlockStore": {"volumeID": "ebs-1", "readOnly": True}}]
    for i in range(10):
        pods[7 * i]["spec"].setdefault("volumes", []).append({"name": "disk", **disks[i % 2]})
    claimants = [p for p in pods
                 if any((v.get("persistentVolumeClaim") or {}).get("claimName", "")
                        .startswith("claim-") for v in p["spec"].get("volumes", []))]
    for i, p in enumerate(claimants[:6]):
        name = f"second-{i}"
        volumes["pvcs"].append({"metadata": {"name": name, "namespace": "default"},
                                "spec": {"storageClassName": "wffc",
                                         "accessModes": ["ReadWriteOnce"],
                                         "resources": {"requests": {"storage": str(2 << 30)}}}})
        p["spec"]["volumes"].append({"name": name, "persistentVolumeClaim": {"claimName": name}})
    return (nodes, pods, PluginSetConfig()), {"volumes": volumes, "bound_pods": bound}


# 12 filters need the p16 word or wider (pipeline.choose_pack_mode)
DEFAULT_MODES = [("full", "p16", None), ("compact", "p16", None), ("compact", "p32", "i32"),
                 ("compact", "p64", "i64")]


@pytest.mark.parametrize("mode", DEFAULT_MODES, ids=lambda m: "-".join(map(str, m)))
def test_default_profile_rows_of_step_chunk(card, mode):
    """Each B9 plugin's filter row (and ImageLocality's and VolumeBinding's
    score rows) of step_chunk equals the plain step's, chunk after chunk,
    with every carry and the PreFilter rejects."""
    args, kw = _default_profile()
    cw = compile_workload(*args, device=card, **kw)
    out_mode, pack_mode, wide = mode
    step = build_step(cw, out_mode=out_mode, pack_mode=pack_mode,
                      score_dtypes=cw.host["score_dtypes"], wide_raw=wide)
    assert set(B9) <= set(step.filter_names) | set(step.score_names)
    ck, cp = _clone_carry(cw.init_carry), _clone_carry(cw.init_carry)
    chunk, rejects = 64, 0
    for lo in range(0, cw.n_pods, chunk):
        xs = _batch(cw, lo, chunk, card)
        ck, ok = step.scan(ck, xs)
        cp, op = step.plain_scan(cp, xs)
        if out_mode == "full":
            for names, field in ((step.filter_names, "filter_codes"),
                                 (step.score_names, "score_raw"),
                                 (step.score_names, "score_final")):
                for k, name in enumerate(names):
                    if name in B9:
                        _equal(getattr(ok, field)[:, k], getattr(op, field)[:, k],
                               f"{field}[{name}] chunk {lo}")
        _equal(ok, op, f"outputs chunk {lo}")
        _equal(ck, cp, f"carry chunk {lo}")
        rejects += int((op.prefilter_reject != 0).sum())
    assert rejects > 0


@pytest.mark.parametrize("wl", ["default_profile", "safe_set"])
def test_b9_in_spec_kernels(card, wl):
    """spec_eval, spec_round (the SAFE set) and spec_commit_bind with the
    B9 plugins, against their plain versions."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.parallel.speculative import SAFE_SPECULATIVE

    args, kw = _default_profile() if wl == "default_profile" else (_safe_set(), {})
    cw = compile_workload(*args, device=card, **kw)
    pm, sd, _ = _compact_plan(cw, None)
    step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
    sparse = set(cw.config.active_plugins()) <= SAFE_SPECULATIVE
    assert sparse == (wl == "safe_set")
    carry = _clone_carry(cw.init_carry)
    for lo in range(0, cw.n_pods, 32):
        xs = _batch(cw, lo, 32, card)
        ev = kspec.spec_eval(step, carry, xs)
        _equal(ev, kspec.eval_plain(step, carry, xs), f"spec_eval {lo}")
        if sparse:
            got = kspec.spec_round(step, carry, xs, 16)
            _equal(got, kspec.sparse_round_plain(step, carry, xs, 16), f"spec_round {lo}")
        want = kspec.commit_plain(step, _clone_carry(carry), xs, ev.selected, 32)
        carry = kspec.spec_commit_bind(step, carry, xs, ev.selected, 32)
        _equal(carry, want, f"spec_commit_bind {lo}")


# ------------------------------------------- step_chunk's cluster, spec_commit_bind's slices

def _ladder():
    """The width-ladder fleet of tests/test_torch_replay.py: 6 nodes, fewer
    than a cluster's CTAs, and bound anchors whose required pod-affinity
    terms push every queue pod's InterPod raw past int16."""
    nodes = make_nodes(6, seed=1)
    keys = ("kubernetes.io/hostname", "topology.kubernetes.io/zone",
            "topology.kubernetes.io/region")

    def pod(name, terms=()):
        spec = {"containers": [{"name": "main", "resources": {
            "requests": {"cpu": "100m", "memory": str(64 << 20)}}}]}
        if terms:
            spec["affinity"] = {"podAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
                {"topologyKey": k, "labelSelector": {"matchLabels": {"app": "web"}}}
                for k in terms]}}
        return {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": name, "namespace": "default", "labels": {"app": "web"}},
                "spec": spec}

    bound = [(pod(f"anchor-{k}", terms=(key,)), "node-00000") for k, key in enumerate(keys)]
    cfg = PluginSetConfig(enabled=list(SIX),
                          args={"InterPodAffinity": {"hardPodAffinityWeight": 20000}})
    return (nodes, [pod(f"q-{i}") for i in range(10)], cfg), {"bound_pods": bound}


# config 5 at 250 nodes and the policies fleet's 24 divide by neither 16
# nor (config 5) 8; the ladder has 6 nodes
CLUSTER_WORKLOADS = {"config5": lambda: (WORKLOADS["config5"](), {}),
                     "policies": lambda: (_policies(), {}),
                     "ladder": _ladder,
                     "default_profile": lambda: _default_profile()}


@pytest.mark.parametrize("shards", [8, 16])
@pytest.mark.parametrize("wl", list(CLUSTER_WORKLOADS))
def test_step_chunk_cluster_sizes_match_plain_scan(card, wl, shards):
    """step_chunk on a cluster of S = 8 and S = 16 CTAs (forced), chunk
    after chunk, against Step.plain_scan: outputs and every carry equal,
    with N not divisible by S, N < S, and the default profile's volume
    family; left to itself the kernel takes a cluster of 8 or 16."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import _compact_plan

    args, kw = CLUSTER_WORKLOADS[wl]()
    cw = compile_workload(*args, device=card, **kw)
    pm, sd, _ = _compact_plan(cw, None)
    for step in (build_step(cw), build_step(cw, out_mode="compact", pack_mode=pm,
                                            score_dtypes=sd)):
        ck, cp = _clone_carry(cw.init_carry), _clone_carry(cw.init_carry)
        for lo in range(0, cw.n_pods, 32):
            xs = _batch(cw, lo, 32, card)
            ck, ok = kstep.step_chunk(step, ck, xs, _shards=shards)
            assert kstep.step_chunk.shards == shards
            cp, op = step.plain_scan(cp, xs)
            _equal(ok, op, f"{step.out_mode} outputs chunk {lo}")
            _equal(ck, cp, f"{step.out_mode} carry chunk {lo}")
    kstep.step_chunk(step, _clone_carry(cw.init_carry), _batch(cw, 0, 32, card))
    assert kstep.step_chunk.shards in (8, 16)


def test_step_chunk_from_several_threads_on_fleets_of_different_widths(card):
    """Three threads launch step_chunk at once, each on its own stream, on
    fleets whose launches differ in width, scorer count and PVs, so in
    shared memory; one (1,000 nodes on one CTA) takes past the 48 KB a
    launch may take by default.  Every launch succeeds and every chunk
    equals Step.plain_scan: the kernel's function attributes are set once
    per card, never per launch, so no thread's launch can undo another's."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    fleets = []
    for wl in ("config5", "default_profile"):
        args, kw = CLUSTER_WORKLOADS[wl]()
        cw = compile_workload(*args, device=card, **kw)
        fleets.append((cw, build_step(cw), 0))
    nodes, pods, cfg = baseline_config(5, scale=0.2, seed=0)  # 1,000 nodes
    cw = compile_workload(nodes, pods[:256], cfg, device=card)
    fleets.append((cw, build_step(cw), 1))
    chunks = [[_batch(cw, lo, 32, card) for lo in range(0, min(cw.n_pods, 256), 32)]
              for cw, _, _ in fleets]
    want = []
    for (cw, step, _), xss in zip(fleets, chunks):
        cp, outs = _clone_carry(cw.init_carry), []
        for xs in xss:
            cp, op = step.plain_scan(cp, xs)
            outs.append(op)
        want.append((cp, outs))
    torch.cuda.synchronize()  # the fleets and references, before the threads' streams read them
    start = threading.Barrier(len(fleets), timeout=120)

    def run(i):
        (cw, step, shards), xss = fleets[i], chunks[i]
        stream = torch.cuda.Stream(card)
        got = []
        with torch.cuda.stream(stream):
            start.wait()
            for _ in range(16):
                ck, outs = _clone_carry(cw.init_carry), []
                for xs in xss:
                    ck, ok = kstep.step_chunk(step, ck, xs, _shards=shards)
                    outs.append(ok)
                got.append((ck, outs))
        stream.synchronize()
        return got

    with ThreadPoolExecutor(len(fleets)) as pool:
        results = [f.result() for f in [pool.submit(run, i) for i in range(len(fleets))]]
    for i, got in enumerate(results):
        for rep, (ck, outs) in enumerate(got):
            _equal(outs, want[i][1], f"fleet {i} repeat {rep} outputs")
            _equal(ck, want[i][0], f"fleet {i} repeat {rep} carry")


def _config5_full():
    nodes, pods, cfg = baseline_config(5, scale=1.0, seed=0)  # 5,000 nodes
    return nodes, pods[:64], cfg


def test_step_chunk_past_shared_memory(card):
    """A slice too wide for shared memory: config 5's 5,000 nodes on one
    CTA (S = 1 forced) need about 250 KB of state, past the card's 227 KB,
    so the kernel keeps it in device memory, and equals Step.plain_scan.
    The same fleet on its own cluster fits; B12's wrapper at S = 1 takes
    the step's own plan (one group of 16, or 8, CTAs) and equals both."""
    from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh

    cw = compile_workload(*_config5_full(), device=card)
    step = build_step(cw)
    sstep = build_step(_sharded(cw, make_mesh(1, device=card)))
    ck, cs, cp = (_clone_carry(cw.init_carry) for _ in range(3))
    for lo in (0, 32):
        xs = _batch(cw, lo, 32, card)
        ck, ok = kstep.step_chunk(step, ck, xs, _shards=1)
        assert kstep.step_chunk.shards == 1 and kstep.step_chunk.spilled
        cs, os_ = kmesh.step_chunk_sharded(sstep, cs, xs)
        cp, op = step.plain_scan(cp, xs)
        _equal(ok, op, f"S = 1 outputs chunk {lo}")
        _equal(ck, cp, f"S = 1 carry chunk {lo}")
        _equal(os_, op, f"sharded S = 1 outputs chunk {lo}")
        _equal(cs, cp, f"sharded S = 1 carry chunk {lo}")
    kstep.step_chunk(step, _clone_carry(cw.init_carry), _batch(cw, 0, 32, card))
    assert kstep.step_chunk.shards in (8, 16) and not kstep.step_chunk.spilled


@pytest.mark.parametrize("wl", ["config5", "policies", "default_profile"])
def test_spec_commit_bind_over_node_slices(card, wl):
    """spec_commit_bind, a grid of CTAs over node slices, against
    commit_plain: an accept prefix k < B, rows that select -1, two binds at
    one node and a third in the same spread domain, and (the default
    profile, as the host path binds) the volume family's carries."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    args, kw = CLUSTER_WORKLOADS[wl]()
    cw = compile_workload(*args, device=card, **kw)
    pm, sd, _ = _compact_plan(cw, None)
    step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
    carry = _clone_carry(cw.init_carry)
    for lo in (0, 32):
        xs = _batch(cw, lo, 32, card)
        sel = kspec.eval_plain(step, carry, xs).selected.clone()
        sel[3], sel[5] = -1, -1
        first = int(sel[0]) if int(sel[0]) >= 0 else 0
        sel[0], sel[1] = first, first
        dom = cw.statics["PodTopologySpread"].dom_idx[0] if "PodTopologySpread" in cw.statics \
            else None
        if dom is not None:
            mates = torch.nonzero((dom == dom[first]) & (torch.arange(cw.n_nodes, device=card)
                                                         != first)).flatten()
            if mates.numel():
                sel[2] = int(mates[-1])
        want = kspec.commit_plain(step, _clone_carry(carry), xs, sel, 20)
        launches = kspec.spec_commit_bind.launches
        carry = kspec.spec_commit_bind(step, carry, xs, sel, 20)
        assert kspec.spec_commit_bind.launches == launches + 1
        _equal(carry, want, f"spec_commit_bind {lo}")


# ------------------------------------------- B7, the chunk attribution

def _att_chunk(seed, mode, tier, c=40, n=1037, f=None, ncols=4, m=None):
    """A chunk's compact outputs drawn with numpy (n not a multiple of 8:
    the bitmap's padded tail), f filters (7 under p8, else 12 by default),
    ncols device score columns and m real pods (c - 3 by default); the i64
    tier's raws pass int32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f = f if f is not None else (7 if mode == "p8" else 12)
    dtype, code_bits, _ = PACK_MODES[mode]
    ffp = np.where(rng.random((c, n)) < 0.5, 0, rng.integers(1, f + 1, (c, n)))
    code = np.where(ffp > 0, rng.integers(1, 1 << min(code_bits, 20), (c, n)), 0)
    packed = torch.from_numpy((ffp.astype(np.int64) << code_bits) | code).to(dtype)
    cycle = ("raw8", "raw16", "raw32", "raw16") if tier == "narrow" else ("raw32",) * 4
    groups = [cycle[k % 4] for k in range(ncols)]
    seen = {"raw8": 0, "raw16": 0, "raw32": 0}
    cols = []
    for s, g in enumerate(groups):
        cols.append((s, g, seen[g]))
        seen[g] += 1
    wide = 1 << 40 if tier == "i64" else 1 << 31
    raw32 = rng.integers(-wide, wide, (c, seen["raw32"], n))
    m = c - 3 if m is None else m
    t = {
        "packed": packed,
        "raw8": torch.from_numpy(rng.integers(-128, 128, (c, seen["raw8"], n)).astype(np.int8)),
        "raw16": torch.from_numpy(
            rng.integers(-(1 << 15), 1 << 15, (c, seen["raw16"], n)).astype(np.int16)),
        "raw32": torch.from_numpy(raw32.astype(np.int64 if tier == "i64" else np.int32)),
        "fc": torch.from_numpy(rng.integers(0, 4, c).astype(np.int32)),
        "fskip": torch.from_numpy(np.concatenate(
            [rng.random((f, m)) < 0.3, np.ones((f, c - m), bool)], 1)),
        "sskip": torch.from_numpy(np.concatenate(
            [rng.random((len(groups) + 1, m)) < 0.3, np.ones((len(groups) + 1, c - m), bool)],
            1)),
    }
    return t, m, code_bits, tuple(cols)


@pytest.mark.parametrize("tier", ["narrow", "i32", "i64"])
@pytest.mark.parametrize("mode", list(PACK_MODES))
def test_chunk_attribution_matches_plain(card, mode, tier):
    """B7 on the card equals its plain version exactly: every pack mode
    (unsigned p8 and p16 words, the int64 p64 word), every raw tier (int64
    raws past int32 in the i64 tier), a padded tail, skips, the bitmap."""
    from kube_scheduler_simulator_tpu_torch.kernels.attribution import (
        chunk_attribution, chunk_attribution_plain)

    for seed, want_pack in ((1, True), (2, False)):
        t, m, code_bits, cols = _att_chunk(seed, mode, tier)
        args = ("packed", "raw8", "raw16", "raw32", "fc", "fskip", "sskip")
        before = chunk_attribution.launches
        got = chunk_attribution(*[t[k].to(card) for k in args], m, code_bits, cols, want_pack)
        assert chunk_attribution.launches == before + 1
        want = chunk_attribution_plain(*[t[k] for k in args], m, code_bits, cols, want_pack)
        _equal(got, want, f"chunk_attribution {mode} {tier} {seed}")
        assert int(want["f_rejects"].sum()) > 0


ATT_ARGS = ("packed", "raw8", "raw16", "raw32", "fc", "fskip", "sskip")


def _att_case(card, seed, mode, tier, want_pack=True, **kw):
    """(the card's inputs, the plain version's outputs) of _att_chunk."""
    from kube_scheduler_simulator_tpu_torch.kernels.attribution import chunk_attribution_plain

    t, m, code_bits, cols = _att_chunk(seed, mode, tier, **kw)
    want = chunk_attribution_plain(*[t[k] for k in ATT_ARGS], m, code_bits, cols, want_pack)
    return (*[t[k].to(card) for k in ATT_ARGS], m, code_bits, cols, want_pack), want


def _att_equal(got, want, what):
    assert sorted(got) == sorted(want), what
    _equal(got, want, what)


@pytest.mark.parametrize("n", [5000, 4999])
@pytest.mark.parametrize("mode", list(PACK_MODES))
def test_chunk_attribution_at_full_width(card, mode, n):
    """B7 at config 5's full width (512 pods x 5,000 nodes) and at an odd
    node count (4,999: every row's 16-byte alignment differs, under p8
    and p16 too) in each pack mode, with the bitmap and without: one
    launch, in the planned shape, equal to the plain version."""
    from kube_scheduler_simulator_tpu_torch.kernels.attribution import (
        att_shape, chunk_attribution)

    for seed, tier, want_pack in ((n, "narrow", True), (n + 1, "i64", False)):
        args, want = _att_case(card, seed, mode, tier, want_pack, c=512, n=n)
        before = chunk_attribution.launches
        got = chunk_attribution(*args)
        assert chunk_attribution.launches == before + 1
        assert chunk_attribution.shape == att_shape(512, n, 12 - 5 * (mode == "p8"), 4)
        _att_equal(got, want, f"chunk_attribution {mode} n={n} {tier}")


@pytest.mark.parametrize("mode", list(PACK_MODES))
def test_chunk_attribution_at_the_limits(card, mode):
    """B7 with F = 16 filters and Q = 8 device score columns (the kernel's
    limits) in each tier, and with m = 0 (every row a pad row)."""
    from kube_scheduler_simulator_tpu_torch.kernels.attribution import chunk_attribution

    for tier in ("narrow", "i32", "i64"):
        args, want = _att_case(card, 16, mode, tier, c=64, n=2053, f=16, ncols=8)
        _att_equal(chunk_attribution(*args), want, f"{mode} {tier} F=16 Q=8")
    args, want = _att_case(card, 17, mode, "narrow", c=24, n=777, m=0)
    _att_equal(chunk_attribution(*args), want, f"{mode} m=0")
    assert int(want["f_rejects"].sum()) == 0 and not want["feas_packed"].any()


@pytest.mark.parametrize("mode", ["p8", "p16", "p64"])
def test_chunk_attribution_at_every_forced_shape(card, mode):
    """B7 at every forced (W warps a pod, P pods a CTA) the kernel takes,
    on a chunk whose C is no multiple of P (the last CTA's empty slots)."""
    from kube_scheduler_simulator_tpu_torch.kernels.attribution import (
        ATT_MAX_WARPS, ATT_PODS, ATT_WARPS, chunk_attribution)

    args, want = _att_case(card, 18, mode, "i32", c=37, n=3001, f=16, ncols=8)
    shapes = [(w, p) for w in ATT_WARPS for p in ATT_PODS if w * p <= ATT_MAX_WARPS]
    assert len(shapes) == 10
    for w, p in shapes:
        got = chunk_attribution(*args, _warps=w, _pods=p)
        assert chunk_attribution.shape == (w, p)
        _att_equal(got, want, f"{mode} W={w} P={p}")


def test_chunk_attributions_on_two_streams_at_once(card):
    """Two sessions launching B7 on streams of their own, in turns, each
    on a chunk of its own: each launch zeroes and sums its own totals, so
    every result equals the plain version of its own chunk."""
    from kube_scheduler_simulator_tpu_torch.kernels.attribution import chunk_attribution

    cases = [_att_case(card, 20 + s, "p16", "narrow", c=512, n=5000) for s in range(2)]
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    outs = [[], []]
    torch.cuda.synchronize()
    for j in range(20):
        for s, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                outs[s].append(chunk_attribution(*cases[s][0], _warps=(1, 4)[j % 2]))
    torch.cuda.synchronize()
    for s in range(2):
        for j, got in enumerate(outs[s]):
            _att_equal(got, cases[s][1], f"stream {s} launch {j}")


RESIDENT_WORKLOADS = {"config5": lambda: (WORKLOADS["config5"](), {}),
                      "policies": lambda: (_policies(), {}),
                      "default_profile": _default_profile}


@pytest.mark.parametrize("wl", list(RESIDENT_WORKLOADS))
def test_device_resident_replay_on_card_matches_cpu(card, wl):
    """replay() at its default, device-resident rung on the card equals
    the CPU port: decisions, B7's attribution (one launch per chunk, no
    chunk fetched for it), every chunk's bytes on a cold read, annotations."""
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.framework.replay import plugin_attribution, replay
    from kube_scheduler_simulator_tpu_torch.kernels.attribution import chunk_attribution
    from kube_scheduler_simulator_tpu_torch.store import decode_pod_result

    args, kw = RESIDENT_WORKLOADS[wl]()
    got = []
    for dev in (card, "cpu"):
        cw = compile_workload(*args, **kw, device=dev)
        before = chunk_attribution.launches
        rr = replay(cw, chunk=32, device=dev)
        cc = rr._compact
        assert all(cc.is_device(ci) for ci in range(len(cc.packed)))
        launched = chunk_attribution.launches - before
        got.append((rr, plugin_attribution(rr), launched))
        assert cc.materialized == 0
    (rr, att, launched), (want, watt, _) = got
    assert launched == len(rr._compact.packed) * len(rr.tiers)
    assert att == watt
    for f in ("selected", "feasible_count", "prefilter_reject"):
        assert np.array_equal(getattr(rr, f), getattr(want, f)), f
    for group in ("packed", "raw8", "raw16", "raw32"):
        for ci in range(len(rr._compact.packed)):
            a, b = rr._compact.host(group, ci), want._compact.host(group, ci)
            assert a.dtype == b.dtype and (a == b).all(), f"{group} {ci}"
    for i in sorted({0, 1, 31, 32, rr.cw.n_pods - 1}):
        assert decode_pod_result(rr, i) == decode_pod_result(want, i), f"pod {i}"


@pytest.mark.parametrize("wl", list(SPEC_WORKLOADS))
def test_device_resident_stream_on_card_matches_cpu(card, wl):
    """replay_speculative_stream(device_resident=True) on the card equals
    the CPU port, stats and attribution included, with one B7 launch per
    emitted chunk."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import plugin_attribution
    from kube_scheduler_simulator_tpu_torch.kernels.attribution import chunk_attribution
    from kube_scheduler_simulator_tpu_torch.parallel import replay_speculative_stream

    nodes, pods, cfg = SPEC_WORKLOADS[wl]()
    runs = []
    for dev in (card, "cpu"):
        cw = compile_workload(nodes, pods, cfg, device=dev)
        before = chunk_attribution.launches
        rr, stats = replay_speculative_stream(cw, chunk=16, pods=pods, device_resident=True)
        runs.append((rr, stats, plugin_attribution(rr), chunk_attribution.launches - before))
    (rr, stats, att, launched), (want, wstats, watt, _) = runs
    assert stats == wstats and att == watt
    assert launched == len(rr._compact.packed)
    assert (rr.selected == want.selected).all()
    for group in ("packed", "raw8", "raw16", "raw32"):
        for ci in range(len(rr._compact.packed)):
            a, b = rr._compact.host(group, ci), want._compact.host(group, ci)
            assert a.dtype == b.dtype and (a == b).all(), group


# ------------------------------------------------ B8, B10 and the engine

def _gang_slice(rng, n, g):
    import numpy as np

    gid = np.full(n, -1, np.int32)
    pos = 0
    for k in range(g):
        if rng.random() < 0.2:
            continue  # absent from the slice
        size = int(rng.integers(1, 12))
        gid[pos:pos + size] = k
        pos += size + int(rng.integers(0, 4))
        if pos >= n:
            break
    sel = np.where(rng.random(n) < 0.7, rng.integers(0, 5000, n), -1).astype(np.int32)
    return (gid[:n], sel, rng.integers(0, 4, g).astype(np.int32),
            rng.integers(1, 10, g).astype(np.int32))


@pytest.mark.parametrize("n,g", [(1, 1), (37, 5), (1000, 40), (10_000, 1_250), (3, 50)])
def test_quorum_slice_kernel_matches_plain(card, n, g):
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.framework import gang
    from kube_scheduler_simulator_tpu_torch.kernels import gang as kgang

    rng = np.random.default_rng(n + g)
    for _ in range(4):
        args = _gang_slice(rng, n, g)
        before = kgang.quorum_slice.launches
        got = gang.quorum_slice(*args, device=card)
        assert kgang.quorum_slice.launches == before + 1
        want = gang.quorum_slice(*args, device="cpu")
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()


def _scattered_slice(rng, n, g):
    """Groups that are not contiguous: each pod in a random group or
    ungrouped, so a group's members are runs spread over the slice and
    some groups are absent."""
    import numpy as np

    gid = np.where(rng.random(n) < 0.8, rng.integers(0, g, n), -1).astype(np.int32)
    sel = np.where(rng.random(n) < 0.7, rng.integers(0, 5000, n), -1).astype(np.int32)
    return (gid, sel, rng.integers(0, 4, g).astype(np.int32),
            rng.integers(1, 10, g).astype(np.int32))


def _quorum_paths(n, g):
    from kube_scheduler_simulator_tpu_torch.kernels import gang as kgang

    return [p for p in kgang.QUORUM_PATHS
            if p == "global" or kgang.quorum_tables(n, g) <= kgang.QUORUM_SMEM]


@pytest.mark.parametrize("n,g", [(37, 5), (1000, 40), (10_000, 1_250), (10_000, 100_000),
                                 (40_000, 300), (3, 50)])
def test_quorum_slice_kernel_on_any_layout_and_path(card, n, g):
    """B8 equal to the plain version on contiguous and on scattered groups
    (a group in several runs, interleaved with others, absent), on an
    all-ungrouped slice, at the planned path and at each path forced; G =
    100,000 passes shared memory (the plan takes the global path), n =
    40,000 scans two tiles of words."""
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.framework import gang
    from kube_scheduler_simulator_tpu_torch.kernels import gang as kgang

    rng = np.random.default_rng(n + g)
    slices = [_gang_slice(rng, n, g), _scattered_slice(rng, n, g),
              (np.full(n, -1, np.int32), np.arange(n, dtype=np.int32),
               np.zeros(g, np.int32), np.ones(g, np.int32))]
    assert (kgang.quorum_path(n, g) == "global") == (g == 100_000)
    for args in slices:
        packed = torch.from_numpy(np.concatenate(args)).to(card)
        admit, wave, wait = gang.quorum_slice_plain(*(torch.from_numpy(a) for a in args))
        want = torch.cat([admit.to(torch.int32), wave, wait.to(torch.int32)])
        for path in (None, *_quorum_paths(n, g)):
            got = kgang.quorum_slice(packed, n, g, _path=path)
            assert kgang.quorum_slice.path == (path or kgang.quorum_path(n, g))
            _equal(got, want, (n, g, path))
        for a, b in zip(gang.quorum_slice(*args, device=card), gang.quorum_slice(*args,
                                                                                 device="cpu")):
            assert a.dtype == b.dtype and a.shape == b.shape and (a == b).all()


def test_quorum_slice_from_four_threads_at_once(card):
    """Four commit workers calling framework/gang.py quorum_slice at once,
    each on slices of its own sizes: each thread packs into and reads back
    from its own page-locked buffers, so every result equals the CPU's."""
    import threading

    import numpy as np

    from kube_scheduler_simulator_tpu_torch.framework import gang

    errors, pinned = [], set()

    def worker(k):
        try:
            rng = np.random.default_rng(100 + k)
            for j in range(40):
                n, g = int(rng.integers(1, 3000)), int(rng.integers(1, 400))
                args = (_gang_slice if j % 2 else _scattered_slice)(rng, n, g)
                got = gang.quorum_slice(*args, device=card)
                want = gang.quorum_slice(*args, device="cpu")
                for a, b in zip(got, want):
                    if not (a.dtype == b.dtype and a.shape == b.shape and (a == b).all()):
                        errors.append((k, j, n, g))
            pinned.add((gang._STAGING.host_in.data_ptr(), gang._STAGING.host_in.is_pinned(),
                        gang._STAGING.host_out.is_pinned()))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append((k, repr(e)))

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert len(pinned) == 4 and all(a and b for _p, a, b in pinned)


PHASED_WORKLOADS = {k: WORKLOADS[k] for k in ("config3", "config5", "policies")}


def _phased_workload(wl):
    if wl == "default_profile":
        return _default_profile()
    return PHASED_WORKLOADS[wl](), {}


@pytest.mark.parametrize("wl", list(PHASED_WORKLOADS) + ["default_profile"])
def test_phased_kernels_match_plain(card, wl):
    """B10 on the card: phased_eval == Phased.plain_eval (every StepOut
    field), renormalize (a one-row renormalize_rows) == renormalize_plain
    for every scorer on edited raws and feasibility, and the bind
    (spec_commit_bind on a batch of one) == _bind_phase, pod after pod
    from one carry."""
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.framework import pipeline
    from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased

    args, kw = _phased_workload(wl)
    cw = compile_workload(*args, **kw, device=card)
    ph = pipeline.build_phased(cw)
    ck, cp = _clone_carry(cw.init_carry), _clone_carry(cw.init_carry)
    rng = np.random.default_rng(3)
    for i in range(min(cw.n_pods, 10)):
        xs1 = _slice_xs(cw.xs, i, i + 1, 1)
        xs1["is_pad"] = torch.zeros(1, dtype=torch.bool, device=card)
        before = kphased.phased_eval.launches
        out = ph.eval(ck, xs1)
        assert kphased.phased_eval.launches == before + 1
        want = ph.plain_eval(cp, xs1)
        for f in want._fields:
            a, b = getattr(out, f), getattr(want, f)
            assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), (i, f)
        feas = (want.filter_codes == 0).all(0) if want.filter_codes.shape[0] else \
            torch.ones(cw.n_nodes, dtype=torch.bool, device=card)
        feas &= torch.from_numpy(rng.random(cw.n_nodes) < 0.8).to(card)
        for s, name in enumerate(cw.config.scorers()):
            raw = want.score_raw[s].long() + torch.from_numpy(
                rng.integers(-3, 4, cw.n_nodes)).to(card)
            got = pipeline.renormalize(name, ph, ck, xs1, raw, feas)
            ref = pipeline.renormalize_plain(name, cw, cp, pipeline.slice_pod(xs1, 0), raw, feas)
            assert got.dtype == ref.dtype and torch.equal(got, ref), (i, name)
        sel = int(want.selected)
        ck = ph.bind(ck, xs1, sel)
        cp = pipeline._bind_phase(cw, cp, pipeline.slice_pod(xs1, 0),
                                  torch.tensor(sel, dtype=torch.int32, device=card))
    torch.cuda.synchronize()
    for a, b in zip(_leaves(ck), _leaves(cp)):
        assert torch.equal(a, b)


def _engine_snapshot(device, objects, cfg, hooks=None, ext_cfgs=None, **kw):
    import copy

    from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
    from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
    from kube_scheduler_simulator_tpu_torch.plugins.coscheduling import (
        ensure_podgroup_resource)

    store = ObjectStore()
    ensure_podgroup_resource(store)
    for res, items in objects.items():
        for obj in items:
            store.create(res, copy.deepcopy(obj))
    engine = SchedulerEngine(store, plugin_config=cfg, device=device, **kw)
    if hooks:
        engine.plugin_extenders = hooks
    if ext_cfgs:
        from kube_scheduler_simulator_tpu_torch.scheduler.extender import ExtenderService

        engine.set_extenders(ExtenderService(ext_cfgs))
    bound = engine.schedule_pending()
    snap = {p["metadata"]["name"]: ((p.get("spec") or {}).get("nodeName"),
                                    p.get("status"), p["metadata"].get("annotations"))
            for p in store.list("pods")[0]}
    parked = sorted(engine.gang_parked)
    engine.close()
    return bound, snap, parked


def _engine_cases():
    from kube_scheduler_simulator_tpu_torch.models import make_gang_workload
    from kube_scheduler_simulator_tpu_torch.plugins.coscheduling import Coscheduling
    from kube_scheduler_simulator_tpu_torch.scheduler.debuggable import PluginExtender

    nodes, pods, cfg = baseline_config(5, scale=0.02, seed=0)

    class Invert(PluginExtender):
        def after_score(self, pod, node_name, score):
            return 1000 - 3 * score

    def preemption():
        # the default profile, whose PostFilter is DefaultPreemption: four
        # 1-CPU nodes full of lower-priority pods (three of them guarded by
        # a PDB that allows no disruption), three pods that fit only after
        # victims go, and one that fits nowhere even then
        def node(name):
            return {"metadata": {"name": name, "labels": {"kubernetes.io/hostname": name}},
                    "spec": {}, "status": {
                        "allocatable": {"cpu": "1", "memory": "1Gi", "pods": "110"},
                        "capacity": {"cpu": "1", "memory": "1Gi", "pods": "110"}}}

        def pod(name, cpu, priority, node_name=None, app="free"):
            p = {"metadata": {"name": name, "namespace": "default", "labels": {"app": app}},
                 "spec": {"priority": priority, "containers": [
                     {"name": "c", "resources": {"requests": {"cpu": cpu}}}]},
                 "status": {}}
            if node_name:
                p["spec"]["nodeName"] = node_name
                p["status"]["phase"] = "Running"
            return p

        running = [pod(f"r{i}", "450m", i % 3, f"n{i // 2 + 1}",
                       "guarded" if i in (0, 1, 5) else "free") for i in range(8)]
        pending = [pod("hi1", "800m", 100), pod("hi2", "800m", 100),
                   pod("mid", "900m", 50), pod("huge", "2", 100)]
        pdb = {"metadata": {"name": "guard", "namespace": "default"},
               "spec": {"selector": {"matchLabels": {"app": "guarded"}}},
               "status": {"disruptionsAllowed": 0}}
        return ({"nodes": [node(f"n{i}") for i in range(1, 5)], "pods": running + pending,
                 "poddisruptionbudgets": [pdb]}, PluginSetConfig(), {})

    def gangs():
        pgs, gpods = make_gang_workload(6, 5, seed=2, cpu_milli=700)
        gpods[7]["spec"]["containers"][0]["resources"]["requests"]["cpu"] = "9999999m"
        gcfg = PluginSetConfig(enabled=list(cfg.enabled) + ["Coscheduling"],
                               custom={"Coscheduling": Coscheduling()})
        return {"nodes": nodes, "podgroups": pgs, "pods": gpods + pods[:40]}, gcfg, {}

    return {
        "config5": lambda: ({"nodes": nodes, "pods": pods}, cfg, {}),
        "preemption": preemption,
        "gangs": gangs,
        "hooks": lambda: ({"nodes": nodes, "pods": pods[:24]}, cfg,
                          {"hooks": {"NodeAffinity": Invert()}}),
    }


@pytest.mark.parametrize("case", ["config5", "preemption", "gangs", "hooks"])
@pytest.mark.parametrize("spec", ["1", "0"])
def test_engine_on_card_matches_cpu(card, case, spec, monkeypatch):
    """SchedulerEngine.schedule_pending() with device="cuda" equals the
    same run with device="cpu": every pod's node, status (the nominated
    node included) and annotations (the post-filter result included),
    the deleted victims, the parked gang members; B8 runs in the gang
    waves, B10 on the host path and step_chunk in DefaultPreemption's
    dry runs."""
    from kube_scheduler_simulator_tpu_torch.framework.preemption import Preemptor
    from kube_scheduler_simulator_tpu_torch.kernels import gang as kgang
    from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased

    dry = {"calls": 0, "launches": 0}
    fits = Preemptor._fits

    def counted_fits(self, *a, **kw):
        before = kstep.step_chunk.launches
        try:
            return fits(self, *a, **kw)
        finally:
            dry["calls"] += 1
            dry["launches"] += kstep.step_chunk.launches - before

    monkeypatch.setattr(Preemptor, "_fits", counted_fits)
    monkeypatch.setenv("KSS_TPU_SPECULATIVE", spec)
    runs = []
    for dev in ("cuda", "cpu"):
        objects, cfg, extra = _engine_cases()[case]()
        b8, b10 = kgang.quorum_slice.launches, kphased.phased_eval.launches
        calls, dry_launches = dry["calls"], dry["launches"]
        runs.append((_engine_snapshot(dev, objects, cfg, chunk=64, **extra),
                     kgang.quorum_slice.launches - b8, kphased.phased_eval.launches - b10,
                     dry["calls"] - calls, dry["launches"] - dry_launches))
    (got, b8_card, b10_card, fits_card, dry_card), (want, b8_cpu, b10_cpu, _, dry_cpu) = runs
    assert got == want
    assert b8_cpu == 0 and b10_cpu == 0 and dry_cpu == 0
    if case == "preemption":
        import json

        from kube_scheduler_simulator_tpu_torch.store import annotations as ann

        bound, snap, _ = got
        running = {f"r{i}" for i in range(8)}
        victims = running - set(snap)
        # n1's two guarded pods stay: the PDB sends every preemptor elsewhere
        assert victims and not victims & {"r0", "r1"}
        assert bound == 3 and snap["huge"][0] is None
        assert all(snap[name][1].get("nominatedNodeName") == snap[name][0]
                   for name in ("hi1", "hi2", "mid"))
        # a dry run not answered from the fit cache is one step_chunk launch
        assert 0 < dry_card <= fits_card
        post = [json.loads(h[ann.POST_FILTER_RESULT])
                for name in ("hi1", "hi2", "mid")
                for h in json.loads((snap[name][2] or {}).get(ann.RESULT_HISTORY, "[]"))
                if h.get(ann.POST_FILTER_RESULT)]
        assert any("preemption victim" in json.dumps(pf) for pf in post)
    if case == "gangs":
        assert b8_card > 0
    if case == "hooks":
        assert b10_card == 24


# ------------------------------------------------------ B11, the fused round


def _fuse_members(dev, kind, k, b=16, kcand=6):
    """K members of one family on `dev`: the slot-pinned fleet (sparse
    rounds) or config 5 with its pods permuted per member (dense rounds),
    each carry advanced by four committed pods."""
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.framework.replay import _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.models.workloads import make_slot_pinned_workload

    members = []
    for s in range(k):
        if kind == "sparse":
            nodes, pods = make_slot_pinned_workload(48, 24, seed=200 + s)
            cfg = PluginSetConfig(enabled=["NodeResourcesFit", "NodeResourcesBalancedAllocation",
                                           "NodeAffinity"])
        else:
            nodes, pods, cfg = baseline_config(5, scale=0.01, seed=0)
            pods = [pods[i] for i in np.random.default_rng(s).permutation(len(pods))]
        cw = compile_workload(nodes, pods, cfg, device=dev)
        pm, sd, _ = _compact_plan(cw, None)
        step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
        carry = _clone_carry(cw.init_carry)
        xs0 = _batch(cw, 0, 4, dev)
        carry = kspec.commit_plain(step, carry, xs0, kspec.eval_plain(step, carry, xs0).selected, 4)
        members.append(kfuse.Member(step, carry, _batch(cw, 4, b, dev),
                                    kcand if kind == "sparse" else None))
    return members


@pytest.mark.parametrize("kind,k", [("sparse", 2), ("sparse", 5), ("sparse", 16),
                                    ("dense", 2), ("dense", 3)])
def test_fused_kernels_match_solo_and_plain(card, kind, k):
    """B11 (spec_eval_fused / spec_round_fused, then spec_oracle_fused) on
    K members: each member's outputs equal its solo launch and its plain
    round, exactly; one launch of each fused kernel per call."""
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse

    members = _fuse_members(card, kind, k)
    first = kfuse.spec_round_fused if kind == "sparse" else kfuse.spec_eval_fused
    n0, o0 = first.launches, kfuse.spec_oracle_fused.launches
    fused = (kfuse.sparse_round_fused if kind == "sparse" else kfuse.dense_round_fused)(members)
    fused = [tuple(t.clone() for t in _flat(r)) for r in fused]
    assert first.launches - n0 == 1 and kfuse.spec_oracle_fused.launches - o0 == 1
    solo_fn = kfuse.sparse_round if kind == "sparse" else kfuse.dense_round
    plain = kfuse.round_plain(members)
    for i, m in enumerate(members):
        solo = tuple(t.clone() for t in _flat(solo_fn(m)))
        _equal(fused[i], solo, f"{kind} K={k} member {i} vs solo")
        _equal(fused[i], tuple(_flat(plain[i])), f"{kind} K={k} member {i} vs plain")


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _flat(v)]


def test_fused_members_on_their_own_streams(card):
    """Members whose work is queued on streams of their own: the leader's
    stream waits for each member's, and each member's waits for the
    launch, so the result equals the solo rounds."""
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse

    streams = [torch.cuda.Stream(card) for _ in range(3)]
    members = []
    for s, m in zip(streams, _fuse_members(card, "sparse", 3)):
        with torch.cuda.stream(s):
            # a long op on the member's stream before it joins
            torch.cuda._sleep(20_000_000)
            members.append(type(m)(m.step, m.carry, m.xs, m.kcand))
    assert len({m.stream for m in members}) == 3
    fused = kfuse.sparse_round_fused(members)
    for s in streams:
        s.synchronize()
    for i, m in enumerate(members):
        _equal(tuple(_flat(fused[i])), tuple(_flat(kfuse.round_plain([m])[0])), f"member {i}")


def test_sharded_members_on_their_own_streams(card):
    """Members sharded over a mesh (B12), each carry written on a stream of
    the member's own behind a long op: the fused dense round is ONE table
    launch of the eval kernel over the members (each shard a group of
    CTAs) on the leader's stream, which waits for each member's, and each
    member's waits for the launch, so the result equals the plain rounds."""
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh, shard_workload

    mesh = make_mesh(2, device=card)
    streams = [torch.cuda.Stream(card) for _ in range(3)]
    members = []
    for s, m in zip(streams, _fuse_members(card, "dense", 3)):
        step = build_step(shard_workload(m.step.cw, mesh), out_mode="compact",
                          pack_mode=m.step.pack_mode, score_dtypes=m.step.score_dtypes)
        with torch.cuda.stream(s):
            torch.cuda._sleep(20_000_000)
            members.append(kfuse.Member(step, _clone_carry(m.carry), m.xs))
    assert len({m.stream for m in members}) == 3
    n0 = (kfuse.spec_eval_fused.launches, kmesh.spec_eval_sharded.launches)
    fused = kfuse.dense_round.fused([(m,) for m in members])
    assert (kfuse.spec_eval_fused.launches, kmesh.spec_eval_sharded.launches) == (n0[0] + 1,
                                                                                  n0[1])
    for s in streams:
        s.synchronize()
    for i, m in enumerate(members):
        _equal(tuple(_flat(fused[i])), tuple(_flat(kfuse.round_plain([m])[0])), f"member {i}")


@pytest.mark.parametrize("candidates", ["128", "4"])
def test_sessions_fuse_on_card(card, monkeypatch, candidates):
    """Two sessions of one family on the card: fused rounds (B11 launched;
    dense rounds with the default candidate cap past the 24 nodes, sparse
    ones with a cap of 4) and KSS_TPU_FUSE=0 give every pod the same node
    and annotations."""
    import copy
    import threading

    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.models.workloads import make_slot_pinned_workload
    from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager

    from kube_scheduler_simulator_tpu_torch.parallel.fuse import FUSE

    nodes, pods_a = make_slot_pinned_workload(64, 24, seed=71)
    pods = {"a": pods_a, "b": make_slot_pinned_workload(64, 24, seed=72)[1]}
    monkeypatch.setenv("KSS_TPU_SPECULATIVE", "1")
    monkeypatch.setenv("KSS_TPU_FUSE_WINDOW_MS", "2000")
    monkeypatch.setenv("KSS_TPU_SPECULATIVE_CANDIDATES", candidates)
    fused_kernel = kfuse.spec_round_fused if candidates == "4" else kfuse.spec_eval_fused
    arms = []
    for fuse in ("1", "0"):
        monkeypatch.setenv("KSS_TPU_FUSE", fuse)
        mgr = SessionManager(max_sessions=3, idle_ttl=0, start_scheduler=False, device="cuda")
        try:
            sess = {}
            for name in pods:
                s = sess[name] = mgr.create(name)
                s.di.engine.set_profiles(None)
                s.di.engine.plugin_config = PluginSetConfig(
                    enabled=["NodeResourcesFit", "NodeResourcesBalancedAllocation",
                             "NodeAffinity"])
                for obj in nodes:
                    s.di.store.create("nodes", copy.deepcopy(obj))
                for obj in pods[name]:
                    s.di.store.create("pods", copy.deepcopy(obj))
            n0 = fused_kernel.launches
            barrier = threading.Barrier(2)
            if fuse == "1":
                # each session's first round waits for the other's, so the
                # two meet inside the window whatever each wave's host
                # work before it took
                first_round = threading.Barrier(2, timeout=120)
                seen, seen_mu, dispatch = set(), threading.Lock(), FUSE.dispatch

                def meet_then_dispatch(stream, *args, **kw):
                    with seen_mu:
                        first = len(seen) < 2 and id(stream) not in seen
                        seen.add(id(stream))
                    if first:
                        first_round.wait()
                    return dispatch(stream, *args, **kw)

                monkeypatch.setattr(FUSE, "dispatch", meet_then_dispatch)

            def run(s):
                barrier.wait()
                s.di.engine.schedule_pending()

            threads = [threading.Thread(target=run, args=(s,)) for s in sess.values()]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=300)
            arms.append(({name: {p["metadata"]["name"]: (p["spec"].get("nodeName"),
                                                         p["metadata"].get("annotations"))
                                 for p in s.di.store.list("pods")[0]}
                          for name, s in sess.items()},
                         fused_kernel.launches - n0))
        finally:
            mgr.shutdown()
            if fuse == "1":
                monkeypatch.setattr(FUSE, "dispatch", dispatch)
    (fused, fused_launches), (solo, solo_launches) = arms
    assert fused == solo
    assert fused_launches > 0 and solo_launches == 0
    assert all(v[0] for st in fused.values() for v in st.values())


# ------------------------------------------------ B12, the node-sharded mesh

def _default_fleet_96():
    # the decorated default-profile fleet (chip_smoke.py phase 10) cut to
    # 96 nodes, which divide by 1, 2, 4 and 8 shards
    import chip_smoke

    nodes, pods, _ = baseline_config(5, scale=0.02, seed=0)
    nodes, pods = nodes[:96], pods[:64]
    volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=0)
    return nodes, pods, PluginSetConfig(), {"volumes": volumes, "bound_pods": bound}


MESH_WORKLOADS = {
    "tiny": lambda: (*WORKLOADS["tiny"](), {}),          # 8 nodes
    "policies": lambda: (*_policies(), {}),              # 24 nodes
    "default_profile": _default_fleet_96,                # 96 nodes
}
MESH_MODES = [("full", "p16", None), ("compact", "p16", None), ("compact", "p64", "i64")]


def _mesh_cw(wl, dev):
    nodes, pods, cfg, kw = MESH_WORKLOADS[wl]()
    return compile_workload(nodes, pods, cfg, device=dev, **kw)


def _sharded(cw, mesh):
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import shard_workload

    return shard_workload(cw, mesh)


def _claiming_shards(cw, shards):
    """cw carrying a mesh that claims `shards` node shards, past what
    make_mesh and shard_workload accept: what a wrapper must refuse."""
    import dataclasses

    from kube_scheduler_simulator_tpu_torch.parallel.mesh import Mesh

    mesh = object.__new__(Mesh)
    mesh.shape, mesh.device = {"dp": 1, "nodes": shards}, cw.device
    return dataclasses.replace(cw, mesh=mesh)


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("wl", list(MESH_WORKLOADS))
def test_step_chunk_sharded_matches_plain_and_unsharded(card, wl, shards):
    """B12 step_chunk_sharded, each shard a group of the plan's CTAs,
    against its plain twin over the same CTA slices and against the
    unsharded step_chunk (B1), and at forced group sizes G = 1, 2 (8
    nodes at S = 8, G = 2: empty sub-slices) against step_chunk, outputs
    and carry, exactly; every launch's error code checked by the wrapper,
    faults surfaced by synchronize."""
    from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh

    cw = _mesh_cw(wl, card)
    scw = _sharded(cw, make_mesh(shards, device=card))
    chunk = 32
    for out_mode, pack_mode, wide in MESH_MODES:
        kw = dict(out_mode=out_mode, pack_mode=pack_mode,
                  score_dtypes=cw.host["score_dtypes"], wide_raw=wide)
        step, sstep = build_step(cw, **kw), build_step(scw, **kw)
        cs, cp, cu = (_clone_carry(cw.init_carry) for _ in range(3))
        cg = {g: _clone_carry(cw.init_carry) for g in (1, 2)}
        launches = kmesh.step_chunk_sharded.launches
        for lo in range(0, cw.n_pods, chunk):
            hi = min(lo + chunk, cw.n_pods)
            xs = _slice_xs(cw.xs, lo, hi, chunk)
            xs["is_pad"] = torch.arange(chunk, device=card) >= (hi - lo)
            cs, os_ = kmesh.step_chunk_sharded(sstep, cs, xs)
            torch.cuda.synchronize()
            plan = kmesh.step_chunk_sharded.groups
            cp, op = kmesh.step_chunk_sharded_plain(sstep, cp, xs, plan)
            cu, ou = kstep.step_chunk(step, cu, xs)
            assert plan * shards == kstep.step_chunk.shards
            for f in os_._fields:
                what = (wl, shards, out_mode, pack_mode, wide, lo, f)
                _equal(getattr(os_, f), getattr(op, f), ("plain",) + what)
                _equal(getattr(os_, f), getattr(ou, f), ("unsharded",) + what)
            _equal(cs, cp, (wl, shards, lo, "carry vs plain"))
            _equal(cs, cu, (wl, shards, lo, "carry vs unsharded"))
            for g in cg:
                cg[g], og = kmesh.step_chunk_sharded(sstep, cg[g], xs, _groups=g)
                assert kmesh.step_chunk_sharded.groups == g
                _equal(og, ou, (wl, shards, g, out_mode, wide, lo, "forced G vs unsharded"))
                _equal(cg[g], cu, (wl, shards, g, lo, "forced G carry vs unsharded"))
        assert kmesh.step_chunk_sharded.launches - launches == 3 * -(-cw.n_pods // chunk)


@pytest.mark.parametrize("n,dp", [(1, 1), (2, 1), (8, 2), (8, 1)])  # S = 1, 2, 4, 8
@pytest.mark.parametrize("wl", list(MESH_WORKLOADS))
def test_spec_eval_sharded_matches_plain_and_unsharded(card, wl, n, dp):
    """B12 spec_eval_sharded, each shard a group of the plan's G CTAs,
    against its plain twin over the same CTA slices and spec_eval (B2),
    and at forced G = 1, 2 and the light CTA shape against spec_eval, in
    compact mode at three tiers and in full mode against the plain eval;
    S is the mesh's "nodes" extent, whatever its dp."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh

    cw = _mesh_cw(wl, card)
    mesh = make_mesh(n, dp=dp, device=card)
    shards = mesh.shape["nodes"]
    scw = _sharded(cw, mesh)
    carry = _clone_carry(cw.init_carry)
    for wide in (None, "i32", "i64"):
        pm, sd, _ = _compact_plan(cw, wide)
        kw = dict(out_mode="compact", pack_mode=pm, score_dtypes=sd, wide_raw=wide)
        step, sstep = build_step(cw, **kw), build_step(scw, **kw)
        for lo, b in ((0, 8), (cw.n_pods - 3, 16)):
            xs = _batch(cw, lo, b, card)
            got = kmesh.spec_eval_sharded(sstep, carry, xs)
            torch.cuda.synchronize()
            g = kmesh.spec_eval_sharded.groups
            assert shards * g <= 16
            _equal(got, kmesh.spec_eval_sharded_plain(sstep, carry, xs, g),
                   (wl, shards, g, wide, lo, "plain"))
            _equal(got, kspec.spec_eval(step, carry, xs), (wl, shards, g, wide, lo, "B2"))
            for kw in ({"_groups": 1}, {"_groups": 2}, {"_light": True}, {"_light": False}):
                _equal(kmesh.spec_eval_sharded(sstep, carry, xs, **kw), got,
                       (wl, shards, kw, wide, lo, "forced vs plan"))
    full = build_step(scw)
    xs = _batch(cw, 0, 8, card)
    got = kmesh.spec_eval_sharded(full, carry, xs)
    _equal(got, kmesh.spec_eval_sharded_plain(full, carry, xs, kmesh.spec_eval_sharded.groups),
           (wl, shards, "full"))
    _equal(kmesh.spec_eval_sharded(full, carry, xs, _light=True), got, (wl, shards, "full light"))


def test_sharded_launch_of_16_refused(card):
    """S = 16 shards are past what the sharded kernels take (1 to 8, each
    a group of a cluster's CTAs), and so is a forced group past a cluster
    of 16: the wrappers refuse them before a launch, and the C entry
    point returns an error code without one."""
    import ctypes

    from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh

    cw = _mesh_cw("policies", card)
    step = build_step(cw)
    wide16 = build_step(_claiming_shards(cw, 16))
    xs = _batch(cw, 0, 8, card)
    n0 = (kmesh.step_chunk_sharded.launches, kmesh.spec_eval_sharded.launches)
    with pytest.raises(ValueError, match="1 to 8"):
        kmesh.step_chunk_sharded(wide16, _clone_carry(cw.init_carry), xs)
    with pytest.raises(ValueError, match="1 to 8"):
        kmesh.spec_eval_sharded(wide16, cw.init_carry, xs)
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh

    wide = build_step(_sharded(cw, make_mesh(8, device=card)))
    with pytest.raises(ValueError, match="cluster holds"):
        kmesh.step_chunk_sharded(wide, _clone_carry(cw.init_carry), xs, _groups=4)
    with pytest.raises(ValueError, match="cluster holds"):
        kmesh.spec_eval_sharded(wide, cw.init_carry, xs, _groups=4)
    assert (kmesh.step_chunk_sharded.launches, kmesh.spec_eval_sharded.launches) == n0
    lib = kstep.load_lib("step")
    assert lib.kss_mesh_max_shards() == kmesh.MAX_SHARDS
    outs = kstep.alloc_outputs(step, 8, card)
    args = kstep.make_args(step, _clone_carry(cw.init_carry), xs, outs)
    for ctas, shards in ((16, 16), (16, 3), (32, 8), (12, 8)):
        assert lib.kss_step_chunk(ctypes.byref(args), ctas, shards, kstep.stream_of(card)) != 0
    torch.cuda.synchronize()


# ------------------------------------------------ the eval kernel's cluster

EVAL_FLEETS = {
    "config5": lambda: baseline_config(5, scale=1.0, seed=0),               # 5,000 nodes
    "n4999": lambda: baseline_config(5, scale=0.0512, seed=0, node_scale=4999.5 / 5000),
    "six_nodes": lambda: baseline_config(5, scale=0.0512, seed=0, node_scale=6.5 / 5000),
}
_EVAL_CASES = {}


def _eval_case(wl, dev):
    """A fleet of EVAL_FLEETS, its compact step and the carry the step
    kernel leaves after pods [0, 64)."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import _compact_plan

    if wl not in _EVAL_CASES:
        cw = compile_workload(*EVAL_FLEETS[wl](), device=dev)
        pm, sd, _ = _compact_plan(cw, None)
        step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
        carry, _ = kstep.step_chunk(step, _clone_carry(cw.init_carry), _batch(cw, 0, 64, dev))
        _EVAL_CASES[wl] = (cw, step, carry)
    return _EVAL_CASES[wl]


@pytest.mark.parametrize("b", [1, 8, 32, 128, 512])
@pytest.mark.parametrize("wl", list(EVAL_FLEETS))
def test_spec_eval_cluster_at_every_size_matches_plain(card, wl, b):
    """spec_eval (csrc/spec_eval.cu, one pod per cluster) on b pods from
    pod 64 against the carry of the first 64, at the plan's S, forced to
    each S of EVAL_SHARDS and forced to each CTA shape, == eval_plain,
    exactly: 5,000 nodes (slices of 313 and 305 at S = 16, the state past
    shared memory at S = 1), a ragged 4,999 and 6 nodes (empty slices from
    S = 8)."""
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    cw, step, carry = _eval_case(wl, card)
    xs = _batch(cw, 64, b, card)
    want = kspec.eval_plain(step, carry, xs)
    before = kspec.spec_eval.launches
    _equal(kspec.spec_eval(step, carry, xs), want, (wl, b, "plan"))
    assert kspec.spec_eval.shards in kspec.EVAL_SHARDS and kspec.spec_eval.shards <= cw.n_nodes
    for s in kspec.EVAL_SHARDS:
        _equal(kspec.spec_eval(step, carry, xs, _shards=s), want, (wl, b, s))
        assert kspec.spec_eval.shards == s
    for light in (False, True):
        _equal(kspec.spec_eval(step, carry, xs, _light=light), want, (wl, b, "light", light))
        assert kspec.spec_eval.light is light
    assert kspec.spec_eval.launches == before + 3 + len(kspec.EVAL_SHARDS)


@pytest.mark.parametrize("wl", ["config5", "default_profile"])
def test_phased_eval_cluster_at_every_size_matches_plain(card, wl):
    """phased_eval (the same kernel, full outputs) at the plan's S and
    forced to each S == Phased.plain_eval, pod after pod as the carry
    advances: config 5's 5,000 nodes and the default profile (the volume
    family's per-pod lists in the cluster's shared memory)."""
    from kube_scheduler_simulator_tpu_torch.framework import pipeline
    from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    if wl == "config5":
        cw = _eval_case("config5", card)[0]
    else:
        args, kw = _default_profile()
        cw = compile_workload(*args, **kw, device=card)
    ph = pipeline.build_phased(cw)
    carry = _clone_carry(cw.init_carry)
    for i in range(6):
        xs1 = _slice_xs(cw.xs, i, i + 1, 1)
        xs1["is_pad"] = torch.zeros(1, dtype=torch.bool, device=card)
        want = ph.plain_eval(carry, xs1)
        _equal(list(ph.eval(carry, xs1)), list(want), (wl, i, "plan"))
        assert kphased.phased_eval.shards in kspec.EVAL_SHARDS
        for s in kspec.EVAL_SHARDS:
            _equal(list(kphased.phased_eval(ph.step, carry, xs1, _shards=s)), list(want),
                   (wl, i, s))
        carry = ph.bind(carry, xs1, int(want.selected))


# ------------------------------------------ the table kernels over sessions

TABLE_KS = (1, 2, 4, 8, 16)  # sessions a launch: every table size (KM = 1, 2, 4, 8, 16)


def _members_of(step, carry, batches, kcand=None):
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse

    return [kfuse.Member(step, carry, xs, kcand) for xs in batches]


def _table_batches(cw, b, k, dev, lo=64):
    """K batches of b pods from pod `lo`, two distinct ones alternating (so
    each is held to its plain version once)."""
    return [_batch(cw, lo + (s % 2) * min(b, 7), b, dev) for s in range(k)]


@pytest.mark.parametrize("b", [1, 8, 512])
@pytest.mark.parametrize("wl", list(EVAL_FLEETS))
def test_eval_table_at_every_session_count_matches_solo_and_plain(card, wl, b):
    """B11's dense eval (spec_eval_fused: the eval kernel over a table of
    sessions) at K = 1, 2, 4, 8, 16 sessions of b pods == each member's
    solo spec_eval launch == eval_plain, exactly, at the plan's S (from
    the K x B clusters) and, at K = 2 and 16, forced to each S and each
    CTA shape: 5,000, 4,999 and 6 nodes."""
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    cw, step, carry = _eval_case(wl, card)
    batches = _table_batches(cw, b, max(TABLE_KS), card)
    plain = [tuple(kspec.eval_plain(step, carry, xs)) for xs in batches[:2]]
    solo = [tuple(t.clone() for t in kspec.spec_eval(step, carry, xs)) for xs in batches[:2]]
    for i in range(2):
        _equal(solo[i], plain[i], (wl, b, i, "solo vs plain"))
    for k in TABLE_KS:
        for s in (0, *(kspec.EVAL_SHARDS if k in (2, 16) else ())):
            before = kfuse.spec_eval_fused.launches
            got = kfuse.spec_eval_fused(_members_of(step, carry, batches[:k]), _shards=s)
            assert kfuse.spec_eval_fused.launches == before + 1
            assert kfuse.spec_eval_fused.shards in kspec.EVAL_SHARDS
            assert s in (0, kfuse.spec_eval_fused.shards)
            for i, o in enumerate(got):
                _equal(tuple(o), solo[i % 2], (wl, b, k, s, i))
        for light in ((False, True) if k in (2, 16) else ()):
            got = kfuse.spec_eval_fused(_members_of(step, carry, batches[:k]), _light=light)
            assert kfuse.spec_eval_fused.light is light
            for i, o in enumerate(got):
                _equal(tuple(o), solo[i % 2], (wl, b, k, "light", light, i))


ROUND_FLEETS = (6, 37, 4999)
_ROUND_CASES = {}


def _round_case(n, dev):
    """The slot-pinned fleet of n nodes, tainted nodes, broad pods 100-139
    among the pinned ones, its compact step and the carry after 64 pods
    committed."""
    from kube_scheduler_simulator_tpu_torch.framework.replay import _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
    from kube_scheduler_simulator_tpu_torch.models import make_slot_pinned_workload

    if n not in _ROUND_CASES:
        nodes, pinned = make_slot_pinned_workload(1200, n, seed=n)
        tainted = make_nodes(n, seed=n + 1, taint_fraction=0.3)
        for node, t in zip(nodes, tainted):
            if t["spec"].get("taints"):
                node["spec"]["taints"] = t["spec"]["taints"]
        pods = pinned[:100] + make_pods(40, seed=n + 2, with_affinity=True,
                                        with_tolerations=True) + pinned[100:]
        cw = compile_workload(nodes, pods, PluginSetConfig(enabled=SIX[:4]), device=dev)
        pm, sd, _ = _compact_plan(cw, None)
        step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
        carry = _clone_carry(cw.init_carry)
        xs0 = _batch(cw, 0, 64, dev)
        carry = kspec.commit_plain(step, carry, xs0, kspec.eval_plain(step, carry, xs0).selected,
                                   64)
        _ROUND_CASES[n] = (cw, step, carry)
    return _ROUND_CASES[n]


@pytest.mark.parametrize("b", [1, 8, 512])
@pytest.mark.parametrize("n", ROUND_FLEETS)
def test_round_table_at_every_session_count_matches_solo_and_plain(card, n, b):
    """The sparse round's pod-group kernel: spec_round (one session) and
    B11's spec_round_fused at K = 2, 4, 8, 16 sessions of b pods, each
    member == its solo launch == sparse_round_plain, exactly, at the
    plan's group size and, at K = 1 and 4, forced to each P of ROUND_PODS;
    candidate caps below N and at N (whose groups of 8 pass shared memory
    on 4,999 nodes and keep their state in device memory)."""
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    cw, step, carry = _round_case(n, card)
    batches = _table_batches(cw, b, max(TABLE_KS), card, lo=99)  # pinned, then broad pods
    for kcand in sorted({min(128, n - 1), n}):
        plain = [kspec.sparse_round_plain(step, carry, xs, kcand) for xs in batches[:2]]
        solo = [tuple(t.clone() for t in kspec.spec_round(step, carry, xs, kcand))
                for xs in batches[:2]]
        for i in range(2):
            _equal(solo[i], plain[i], (n, b, kcand, i, "solo vs plain"))
        for s in kspec.ROUND_PODS:
            _equal(kspec.spec_round(step, carry, batches[0], kcand, _pods=s), plain[0],
                   (n, b, kcand, "solo", s))
            assert kspec.spec_round.pods == s
        for k in TABLE_KS[1:]:
            for s in (0, *(kspec.ROUND_PODS if k == 4 else ())):
                before = kfuse.spec_round_fused.launches
                got = kfuse.spec_round_fused(_members_of(step, carry, batches[:k], kcand),
                                             _pods=s)
                assert kfuse.spec_round_fused.launches == before + 1
                assert kfuse.spec_round_fused.pods in kspec.ROUND_PODS
                for i, r in enumerate(got):
                    _equal(tuple(r), solo[i % 2], (n, b, kcand, k, s, i))


# ------------------------------------------ B13: custom plugins' rows

def _custom_plugins():
    """A filter-and-scorer with three messages and negative raws, a
    scorer past int32 (2^33), and a filter that rejects every node for
    the pods of chunk 1 (pods 32-63) and every seventh pod."""
    from kube_scheduler_simulator_tpu_torch.plugins.custom import CustomPlugin

    def idx(obj):
        return int(obj["metadata"]["name"].rsplit("-", 1)[1])

    class Zoned(CustomPlugin):
        name = "Zoned"
        default_weight = 2

        def filter(self, pod, node):
            i, j = idx(pod), idx(node)
            return f"zone {(i * j) % 3} is closed" if (i + j) % 7 == 0 else None

        def score(self, pod, node):
            return (idx(pod) * 31 + idx(node) * 17) % 101 - 50

    class Huge(CustomPlugin):
        name = "Huge"

        def score(self, pod, node):
            return (1 << 33) + idx(node) * (idx(pod) + 1)

    class RejectAll(CustomPlugin):
        name = "RejectAll"

        def filter(self, pod, node):
            i = idx(pod)
            return "no room here" if 32 <= i < 64 or i % 7 == 0 else None

    return {p.name: p for p in (Zoned(), Huge(), RejectAll())}


def _custom_fleet(default_profile: bool):
    """(nodes, pods, cfg, compile kwargs): the six plugins on 40 nodes and
    96 pods, or the default profile's 96-node fleet (13 filters and 9
    scorers with Zoned), with the custom plugins of _custom_plugins."""
    plugins = _custom_plugins()
    if default_profile:
        nodes, pods, _, kw = _default_fleet_96()
        plugins = {"Zoned": plugins["Zoned"]}
        enabled = PluginSetConfig().enabled
    else:
        nodes = make_nodes(40, seed=13, taint_fraction=0.25)
        pods = make_pods(96, seed=14, with_affinity=True, with_tolerations=True,
                         with_spread=True, with_interpod=True)
        kw, enabled = {}, list(SIX)
    return nodes, pods, PluginSetConfig(enabled=enabled + list(plugins), custom=plugins), kw


CUSTOM_FLEETS = {"six": lambda: _custom_fleet(False), "default_profile": lambda: _custom_fleet(True)}


@pytest.mark.parametrize("wl", list(CUSTOM_FLEETS))
def test_custom_rows_in_step_chunk_match_plain(card, wl):
    """B13 in step_chunk: every output and the carry == Step.plain_scan in
    every mode, pack mode and tier; a chunk whose every pod a custom filter
    rejects at every node selects nothing; the 2^33 raws stay exact."""
    nodes, pods, cfg, kw = CUSTOM_FLEETS[wl]()
    cw = compile_workload(nodes, pods, cfg, device=card, **kw)
    if wl == "default_profile":
        assert len(cw.config.filters()) == 13 and len(cw.config.scorers()) == 9
    chunk = 32
    for out_mode, pack_mode, wide in MODES:
        step = build_step(cw, out_mode=out_mode, pack_mode=pack_mode,
                          score_dtypes=cw.host["score_dtypes"], wide_raw=wide)
        ck, cp = _clone_carry(cw.init_carry), _clone_carry(cw.init_carry)
        for lo in range(0, cw.n_pods, chunk):
            xs = _batch(cw, lo, chunk, card)
            ck, ok = kstep.step_chunk(step, ck, xs)
            cp, op = step.plain_scan(cp, xs)
            _equal(ok, op, (wl, out_mode, pack_mode, wide, lo))
            _equal(ck, cp, (wl, out_mode, pack_mode, wide, lo, "carry"))
            if wl == "six" and lo == 32:
                assert (ok.selected == -1).all() and (ok.feasible_count == 0).all()
            if wl == "six" and wide == "i64" and out_mode == "compact":
                huge = step.score_names.index("Huge")
                assert cw.host["score_dtypes"][huge] == "host"
    if wl == "six":
        assert (cw.xs["Huge"].scores >= (1 << 33)).all()


@pytest.mark.parametrize("shards", [1, 2, 4, 8])
def test_custom_rows_in_step_chunk_sharded_match_plain(card, shards):
    """B13 in step_chunk_sharded: each shard reads its node slice of the
    rows (global node index), == the twin and the unsharded kernel."""
    from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh

    nodes, pods, cfg, kw = CUSTOM_FLEETS["six"]()
    cw = compile_workload(nodes, pods, cfg, device=card, **kw)
    scw = _sharded(cw, make_mesh(shards, device=card))
    for out_mode, pack_mode, wide in MESH_MODES:
        kw = dict(out_mode=out_mode, pack_mode=pack_mode,
                  score_dtypes=cw.host["score_dtypes"], wide_raw=wide)
        step, sstep = build_step(cw, **kw), build_step(scw, **kw)
        cs, cp, cu = (_clone_carry(cw.init_carry) for _ in range(3))
        for lo in range(0, cw.n_pods, 32):
            xs = _batch(cw, lo, 32, card)
            cs, os_ = kmesh.step_chunk_sharded(sstep, cs, xs)
            cp, op = kmesh.step_chunk_sharded_plain(sstep, cp, xs)
            cu, ou = kstep.step_chunk(step, cu, xs)
            _equal(os_, op, (shards, out_mode, wide, lo, "plain"))
            _equal(os_, ou, (shards, out_mode, wide, lo, "unsharded"))
            _equal(cs, cp, (shards, lo, "carry"))


@pytest.mark.parametrize("wl", list(CUSTOM_FLEETS))
def test_custom_rows_in_phased_eval_match_plain(card, wl):
    """B13 in phased_eval (spec_eval_cluster, full outputs) at the plan's
    S and every forced S == Phased.plain_eval, pod after pod, the pods
    the custom filter rejects everywhere among them."""
    from kube_scheduler_simulator_tpu_torch.framework import pipeline
    from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    nodes, pods, cfg, kw = CUSTOM_FLEETS[wl]()
    cw = compile_workload(nodes, pods, cfg, device=card, **kw)
    ph = pipeline.build_phased(cw)
    carry = _clone_carry(cw.init_carry)
    for i in (0, 1, 2, 7, 32, 33):
        xs1 = _batch(cw, i, 1, card)
        want = ph.plain_eval(carry, xs1)
        _equal(list(ph.eval(carry, xs1)), list(want), (wl, i, "plan"))
        for s in kspec.EVAL_SHARDS:
            _equal(list(kphased.phased_eval(ph.step, carry, xs1, _shards=s)), list(want),
                   (wl, i, s))
        if wl == "six" and (i % 7 == 0 or 32 <= i < 64):
            assert int(want.selected) == -1 and int(want.feasible_count) == 0
        carry = ph.bind(carry, xs1, int(want.selected))


# ------------------------------------------------ the oracle (csrc/oracle.cu)

ORACLE_BATCHES = (1, 2, 7, 8, 31, 32, 33, 512)
ORACLE_NODES = 300


class _OracleMember:
    """What spec_oracle_fused reads of a fused round's member: its device,
    stream, K and commit (none)."""

    def __init__(self, dev):
        self.device = dev
        self.stream = torch.cuda.current_stream(dev)
        self.outs = {"k": torch.empty((), dtype=torch.int32, device=dev)}
        self.commit = None


@pytest.mark.parametrize("pack", [mode[0] for mode in PACK_MODES.values()])
@pytest.mark.parametrize("b", ORACLE_BATCHES)
def test_oracle_matches_plain(card, b, pack):
    """spec_oracle (B3) == _oracle_core on batches all accepted, with a
    conflict at k = 1, with one only at k = B - 1, all rejected and
    random, with pad rows (selected -1) and without, at the plan's CTAs
    and every forced count; the plan's count is oracle_ctas(b)."""
    import chip_smoke
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    for kind in chip_smoke.ORACLE_KINDS:
        for pads in sorted({0, min(3, b - 1)}):
            args = chip_smoke.oracle_batch(kind, b, ORACLE_NODES, pack, seed=b, pads=pads,
                                           device=card)
            want = kspec._oracle_core(*args, b)
            n0 = kspec.spec_oracle.launches
            _equal(kspec.spec_oracle(*args), want, (b, kind, pads, "plan"))
            assert kspec.spec_oracle.launches == n0 + 1
            assert kspec.spec_oracle.ctas == kspec.oracle_ctas(b)
            for ctas in kspec.ORACLE_CTAS:
                _equal(kspec.spec_oracle(*args, _ctas=ctas), want, (b, kind, pads, ctas))
                assert kspec.spec_oracle.ctas == ctas


@pytest.mark.parametrize("k", range(1, 9))
def test_fused_oracle_matches_solo(card, k):
    """spec_oracle_fused (B11) over K = 1..8 sessions of different kinds
    of batch: one launch, each session's K equal to its solo spec_oracle
    and to _oracle_core, at the plan's CTAs and every forced count."""
    import chip_smoke
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    for b in (8, 33, 512):
        rows = [chip_smoke.oracle_batch(chip_smoke.ORACLE_KINDS[i % 5], b, ORACLE_NODES,
                                        torch.uint16, seed=10 * k + i, pads=i % 2,
                                        device=card) for i in range(k)]
        want = [kspec._oracle_core(*r, b) for r in rows]
        solo = [kspec.spec_oracle(*r).clone() for r in rows]
        for ctas in (0, *kspec.ORACLE_CTAS):
            members = [_OracleMember(card) for _ in range(k)]
            n0 = kfuse.spec_oracle_fused.launches
            got = kfuse.spec_oracle_fused(members, rows, _ctas=ctas)
            assert kfuse.spec_oracle_fused.launches == n0 + 1
            assert kfuse.spec_oracle_fused.ctas == (ctas or kspec.oracle_ctas(b))
            for i in range(k):
                _equal(got[i], solo[i], (k, b, ctas, i, "solo"))
                _equal(got[i], want[i], (k, b, ctas, i, "plain"))


def test_oracles_on_two_streams_at_once(card):
    """Two sessions launching the oracle on streams of their own, in turns,
    each into K tensors of its own: nothing is shared between launches,
    so every K equals _oracle_core."""
    import chip_smoke
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    streams = [torch.cuda.Stream(card) for _ in range(2)]
    rows = [chip_smoke.oracle_batch(kind, 512, ORACLE_NODES, torch.uint8, seed=s, device=card)
            for s, kind in enumerate(("last", "first"))]
    want = [int(kspec._oracle_core(*r, 512)) for r in rows]
    assert want == [511, 1]
    outs = [[torch.empty((), dtype=torch.int32, device=card) for _ in range(50)]
            for _ in streams]
    torch.cuda.synchronize()
    for j in range(50):
        for s, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                kspec.spec_oracle(*rows[s], out=outs[s][j], _ctas=16 if j % 2 else 0)
    torch.cuda.synchronize()
    for s in range(2):
        assert [int(t) for t in outs[s]] == [want[s]] * 50


# ------------------------------------------------ B5's core folded into the oracle

def _fold_workload(card, extended: int):
    """A core-only fleet (NodeResourcesFit, BalancedAllocation,
    NodeAffinity) of 300 nodes and 600 pods, with `extended` extended
    resources on every node (chip_smoke.extend_resources): R = 3 +
    extended schema columns."""
    import chip_smoke

    nodes = make_nodes(ORACLE_NODES, seed=7, taint_fraction=0.1)
    pods = make_pods(600, seed=8, with_affinity=True)
    if extended:
        chip_smoke.extend_resources(nodes, pods, seed=9, k=extended)
    cfg = PluginSetConfig(enabled=["NodeResourcesFit", "NodeResourcesBalancedAllocation",
                                   "NodeAffinity"])
    cw = compile_workload(nodes, pods, cfg, device=card)
    assert set(cw.init_carry) == {"core"} and cw.schema.n == 3 + extended
    return cw


@pytest.mark.parametrize("extended", [0, 16], ids=["R3", "R19"])
@pytest.mark.parametrize("b", [8, 32, 512])
def test_folded_oracle_matches_plain(card, b, extended):
    """spec_oracle with B5's core commit folded in == the plain oracle then
    commit_plain at k = min(K, m), K and carry exactly: all accepted, an
    early conflict, all pad rows, m = 0 (K = 0 committed), a sparse
    round past its candidate cap (nothing committed) and within it, at
    the plan's CTAs and every forced count, at R = 3 and the widest
    schema here; one launch, counted as a commit."""
    import chip_smoke
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    cw = _fold_workload(card, extended)
    carry = _clone_carry(cw.init_carry)
    carry["core"].requested.add_(7)  # a carry that is not all zeros
    for i, kind in enumerate(chip_smoke.FOLD_KINDS):
        for pack in (torch.uint8, torch.int64):
            for ctas in (0, *kspec.ORACLE_CTAS):
                rows, xs, m, counts, kc = chip_smoke.fold_case(cw, kind, b, 31 * i + b, pack)
                n0, c0 = kspec.spec_oracle.launches, kspec.spec_oracle.commits
                err, k = chip_smoke.fold_err(
                    kspec, rows, xs, m, counts, kc, carry,
                    lambda rows, c: kspec.spec_oracle(*rows, commit=c, _ctas=ctas))
                assert err == 0, (b, extended, kind, pack, ctas)
                assert kspec.spec_oracle.launches == n0 + 1
                assert kspec.spec_oracle.commits == c0 + 1
                if kind == "first" and b > 1:
                    assert k == 1


@pytest.mark.parametrize("k", [2, 4, 16])
def test_fused_folded_oracle_matches_plain(card, k):
    """spec_oracle_fused over K sessions, folded and unfolded in turn:
    each session's K and carry equal the plain oracle then commit_plain
    (its carry untouched where it has no commit), at the plan's CTAs and
    every forced count, at b = 8 and 512."""
    import chip_smoke
    from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
    from kube_scheduler_simulator_tpu_torch.framework.replay import _compact_plan
    from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    cw = _fold_workload(card, 16)
    pm, sd, _ = _compact_plan(cw, None)
    step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
    for b in (8, 512):
        for ctas in (0, *kspec.ORACLE_CTAS):
            assert chip_smoke.fold_table_err(kspec, kfuse, cw, step, k, b, 3 * k + b,
                                             PACK_MODES[pm][0], _ctas=ctas) == 0, (k, b, ctas)


def test_folded_oracles_on_two_streams_at_once(card):
    """Two sessions launching the folded oracle on streams of their own, in
    turns, 50 times each into carries of their own: each carry ends at 50
    commits of its own batch, as the plain form applied 50 times."""
    import chip_smoke
    from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec

    cw = _fold_workload(card, 0)
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    cases = [chip_smoke.fold_case(cw, kind, 512, s) for s, kind in enumerate(("accepted",
                                                                            "first"))]
    carries = [_clone_carry(cw.init_carry) for _ in streams]
    want = [_clone_carry(cw.init_carry) for _ in streams]
    outs = [[torch.empty((), dtype=torch.int32, device=card) for _ in range(50)]
            for _ in streams]
    torch.cuda.synchronize()
    for j in range(50):
        for s, stream in enumerate(streams):
            rows, xs, m, counts, kc = cases[s]
            with torch.cuda.stream(stream):
                kspec.spec_oracle(*rows, out=outs[s][j], _ctas=16 if j % 2 else 0,
                                  commit=kspec.Commit(carries[s], xs, m, counts, kc))
    torch.cuda.synchronize()
    for s in range(2):
        rows, xs, m, counts, kc = cases[s]
        for _ in range(50):
            k = kspec.oracle_commit_plain(*rows, kspec.Commit(want[s], xs, m, counts, kc))
        assert [int(t) for t in outs[s]] == [int(k)] * 50
        _equal(list(carries[s]["core"]), list(want[s]["core"]), ("stream", s))


# ------------------------------------------------ renormalize_rows (csrc/phased.cu)

@pytest.mark.parametrize("r", [1, 2, 3, 4])
def test_renormalize_rows_match_plain(card, r):
    """renormalize_rows (B10) over R = 1..4 of config 5's scorers with
    ScoreExtensions, on hook-edited raws == renormalize_plain row by
    row, at the plan's G
    and every forced G, at a random feasibility and at none (no node
    scored), pod after pod on a carry the binds advance; one launch a
    call."""
    import numpy as np

    from kube_scheduler_simulator_tpu_torch.framework import pipeline
    from kube_scheduler_simulator_tpu_torch.kernels import phased as kphased

    nodes, pods, cfg = baseline_config(5, scale=0.06, seed=0)
    cw = compile_workload(nodes, pods, cfg, device=card)
    ph = pipeline.build_phased(cw)
    carry = _clone_carry(cw.init_carry)
    scorers = list(cw.config.scorers())
    norm = [nm for nm in scorers if nm in pipeline.NORMALIZING]
    names = norm[:r]
    rows = [scorers.index(nm) for nm in names]
    rng = np.random.default_rng(r)
    n = cw.n_nodes
    for i in range(6):
        xs1 = _batch(cw, i, 1, card)
        xs1["is_pad"] = torch.zeros(1, dtype=torch.bool, device=card)
        out = ph.plain_eval(carry, xs1)
        raws = out.score_raw[rows].long() + torch.from_numpy(
            rng.integers(-5, 6, (r, n))).to(card)
        sl = pipeline.slice_pod(xs1, 0)
        for feas in ((out.filter_codes == 0).all(0) & torch.from_numpy(
                rng.random(n) < 0.7).to(card), torch.zeros(n, dtype=torch.bool, device=card)):
            want = torch.stack([pipeline.renormalize_plain(nm, cw, carry, sl, raws[j], feas)
                                for j, nm in enumerate(names)])
            for g in (0, *kphased.RENORM_CTAS):
                n0 = kphased.renormalize_rows.launches
                got = kphased.renormalize_rows(ph.step, names, carry, xs1, raws, feas, _ctas=g)
                assert kphased.renormalize_rows.launches == n0 + 1
                assert kphased.renormalize_rows.ctas == (g or kphased.renorm_ctas(n))
                _equal(got, want, (r, i, g, bool(feas.any())))
        carry = ph.bind(carry, xs1, int(out.selected))
    torch.cuda.synchronize()
