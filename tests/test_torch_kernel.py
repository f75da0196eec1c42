"""The step kernel (csrc/step.cu) against its plain PyTorch version, on
the card: every output and the carry equal, exactly, in "full" mode and
in "compact" mode under every pack mode and raw-width tier, on configs
1-5 at test scale, the tiny workload, a workload with per-slot spread
eligibility, and the scheduler's default profile (every plugin row of
the default lineup, the volume family included); the speculative wave's
kernels likewise, the SAFE-set fleet included; B7, the chunk
attribution, in every pack mode and raw tier; and the device-resident
replay and stream on the card against the CPU port.  A CUDA kernel has
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


# ------------------------------------------- B7, the chunk attribution

def _att_chunk(seed, mode, tier, c=40, n=1037):
    """A chunk's compact outputs drawn with numpy (n not a multiple of 8:
    the bitmap's padded tail); the i64 tier's raws pass int32."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f = 7 if mode == "p8" else 12
    dtype, code_bits, _ = PACK_MODES[mode]
    ffp = np.where(rng.random((c, n)) < 0.5, 0, rng.integers(1, f + 1, (c, n)))
    code = np.where(ffp > 0, rng.integers(1, 1 << min(code_bits, 20), (c, n)), 0)
    packed = torch.from_numpy((ffp.astype(np.int64) << code_bits) | code).to(dtype)
    groups = ("raw8", "raw16", "raw32", "raw16") if tier == "narrow" else ("raw32",) * 4
    seen = {"raw8": 0, "raw16": 0, "raw32": 0}
    cols = []
    for s, g in enumerate(groups):
        cols.append((s, g, seen[g]))
        seen[g] += 1
    wide = 1 << 40 if tier == "i64" else 1 << 31
    raw32 = rng.integers(-wide, wide, (c, seen["raw32"], n))
    m = c - 3
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


PHASED_WORKLOADS = {k: WORKLOADS[k] for k in ("config3", "config5", "policies")}


def _phased_workload(wl):
    if wl == "default_profile":
        return _default_profile()
    return PHASED_WORKLOADS[wl](), {}


@pytest.mark.parametrize("wl", list(PHASED_WORKLOADS) + ["default_profile"])
def test_phased_kernels_match_plain(card, wl):
    """B10 on the card: phased_eval == Phased.plain_eval (every StepOut
    field), renormalize_row == renormalize_plain for every scorer on
    edited raws and feasibility, and the bind (spec_commit_bind on a
    batch of one) == _bind_phase, pod after pod from one carry."""
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
