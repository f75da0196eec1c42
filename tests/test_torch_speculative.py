"""The port's speculative wave against the JAX package's.

Per kernel, the plain PyTorch versions (kernels/spec.py) against the JAX
functions of parallel/speculative.py on the same inputs, seeded random
carries included: B2 `_eval_fn`, B3 `_oracle_core`, B4 `_sparse_round_fn`,
B5 `_commit_fn` (both variants) and B6 `_accum_fns`.  End to end,
`replay_speculative` and `replay_speculative_stream` of the port against
the JAX package's on the workloads of tests/test_speculative.py (no mesh,
no engine): selections, feasible counts, every compact chunk's bytes,
every pod's decoded annotations and the stats dict, all exact.  The JAX
runs are shared through module-level caches; they run with
KSS_TPU_HOST_RESIDENT=1, the JAX package's bit-identical host-fetch rung,
which is what the port does.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.framework.replay import _compact_plan as jax_compact_plan
from kube_scheduler_simulator_tpu.framework.replay import _slice_xs as jax_slice_xs
from kube_scheduler_simulator_tpu.framework.replay import _workload_scan_key
from kube_scheduler_simulator_tpu.models import workloads as jwl
from kube_scheduler_simulator_tpu.parallel import speculative as jspec
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.reference_impl.sequential import SequentialScheduler
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework import replay
from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
from kube_scheduler_simulator_tpu_torch.framework.replay import (_clone_carry, _compact_plan,
                                                                 _slice_xs)
from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
from kube_scheduler_simulator_tpu_torch.models import workloads as pwl
from kube_scheduler_simulator_tpu_torch.parallel import speculative as pspec
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.state.convert import from_numpy_workload
from kube_scheduler_simulator_tpu_torch.store import decode_pod_result

SAFE = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
        "TaintToleration"]
COUPLED = SAFE + ["PodTopologySpread"]
SIX = COUPLED + ["InterPodAffinity"]


@contextlib.contextmanager
def env(**values):
    old = {k: os.environ.get(k) for k in values}
    os.environ.update({k: str(v) for k, v in values.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    assert np.array_equal(a, b), f"{what} differs"


def assert_same_carry(carry, jcarry):
    for name, sub in jcarry.items():
        ref = list(sub) if hasattr(sub, "_fields") else [sub]
        got = list(carry[name]) if hasattr(carry[name], "_fields") else [carry[name]]
        for k, (a, b) in enumerate(zip(got, ref)):
            assert_same(a, b, f"carry {name}[{k}]")


# ------------------------------------------------------------ workloads

def _safe(m):
    # tight capacity so pods contend for the same nodes
    nodes = m.make_nodes(24, seed=9, taint_fraction=0.2)
    pods = m.make_pods(60, seed=10, with_affinity=True, with_tolerations=True)
    return nodes, pods, SAFE


def _contention(m):
    return (m.make_nodes(2, seed=3), m.make_pods(30, seed=4),
            ["NodeResourcesFit", "NodeResourcesBalancedAllocation"])


def _coupled(m, interpod=False, n_nodes=20, n_pods=48, seed=13):
    nodes = m.make_nodes(n_nodes, seed=seed, taint_fraction=0.2)
    pods = m.make_pods(n_pods, seed=seed + 1, with_affinity=True, with_tolerations=True,
                       with_spread=True, with_interpod=interpod)
    return nodes, pods, SIX if interpod else COUPLED


def _mixed(m, seed=71):
    # pinned pods (2 feasible nodes) around broad ones (feasible nearly
    # everywhere): with 4 candidates, sparse rounds and wide-feasibility
    # dense rounds in one stream
    nodes, pinned = m.make_slot_pinned_workload(20, 16, seed=seed)
    pods = pinned[:10] + m.make_pods(10, seed=seed + 1) + pinned[10:]
    return nodes, pods, SAFE[:3]


def _i64(m):
    nodes, pinned = m.make_slot_pinned_workload(20, 16, seed=81)
    pods = pinned[:10] + m.make_pods(8, seed=82) + pinned[10:]
    return nodes, pods, SAFE[:2]


def _pinned(m):
    # one pod per node: disjoint feasibility, every round accepted whole
    nodes = m.make_nodes(80, seed=61)
    pods = []
    for i in range(80):
        pods.append({
            "metadata": {"name": f"pin-{i:03d}", "namespace": "default"},
            "spec": {
                "containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}}}],
                "affinity": {"nodeAffinity": {
                    "requiredDuringSchedulingIgnoredDuringExecution": {
                        "nodeSelectorTerms": [{"matchExpressions": [{
                            "key": "kubernetes.io/hostname", "operator": "In",
                            "values": [f"node-{i:05d}"]}]}]}}},
            }})
    return nodes, pods, ["NodeResourcesFit", "NodeAffinity"]


def _slots(m):
    nodes, pods = m.make_slot_pinned_workload(640, 320, seed=0)
    return nodes, pods, SAFE[:3]


def _namespaces(m):
    def node(name, zone, cpu):
        return {"metadata": {"name": name, "labels": {"topology.kubernetes.io/zone": zone,
                                                      "kubernetes.io/hostname": name}},
                "status": {"allocatable": {"cpu": cpu, "memory": "8Gi", "pods": "10"}}}

    nodes = [node("n0", "A", "300m"), node("n1", "A", "4"), node("n2", "B", "4")]
    p0 = {"metadata": {"name": "p0", "namespace": "a", "labels": {"app": "x"}},
          "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "200m"}}}]}}
    p1 = {"metadata": {"name": "p1", "namespace": "b", "labels": {"app": "y"}},
          "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "1"}}}],
                   "affinity": {"podAntiAffinity": {
                       "requiredDuringSchedulingIgnoredDuringExecution": [{
                           "labelSelector": {"matchLabels": {"app": "x"}},
                           "namespaceSelector": {},
                           "topologyKey": "topology.kubernetes.io/zone"}]}}}}
    return nodes, [p0, p1], ["NodeResourcesFit", "InterPodAffinity"]


NAMESPACES = [{"metadata": {"name": "a", "labels": {"team": "x"}}},
              {"metadata": {"name": "b", "labels": {"team": "y"}}}]


def _force_i64(cw):
    cw.host["score_dtypes"] = tuple("i64" for _ in cw.config.scorers())
    return cw


# name -> (workload function, compile kwargs, run kwargs, env knobs, force i64)
CASES = {
    "safe_b4": (_safe, {}, dict(batch=4), {}, False),
    "contention_b8": (_contention, {}, dict(batch=8), {}, False),
    "coupled_b8": (_coupled, {}, dict(batch=8), {}, False),
    "interpod_b8": (lambda m: _coupled(m, interpod=True), {}, dict(batch=8), {}, False),
    "namespaces_b2": (_namespaces, {"namespaces": NAMESPACES},
                      dict(batch=2, namespaces=NAMESPACES), {}, False),
    "mixed_b8_k4": (_mixed, {}, dict(batch=8), {"KSS_TPU_SPECULATIVE_CANDIDATES": 4}, False),
    "i64_b8_k4": (_i64, {}, dict(batch=8), {"KSS_TPU_SPECULATIVE_CANDIDATES": 4}, True),
    "ladder_coupled": (lambda m: _coupled(m, n_nodes=24, n_pods=80, seed=51), {}, {}, {},
                       False),
    "ladder_pinned": (_pinned, {}, {}, {}, False),
    # the streams, scan fallback on
    "stream_slots": (_slots, {}, dict(stream=True, chunk=64), {}, False),
    "stream_contention": (_contention, {}, dict(stream=True, chunk=8), {}, False),
}

_RUNS = {}


def runs(name):
    """-> (port cw, port (rr, stats), JAX (rr, stats)) of one case."""
    if name not in _RUNS:
        build, ckw, rkw, knobs, i64 = CASES[name]
        rkw = dict(rkw)
        stream = rkw.pop("stream", False)
        nodes, pods, enabled = build(pwl)
        jnodes, jpods, _ = build(jwl)
        cw = compile_workload(nodes, pods, PluginSetConfig(enabled=enabled), device="cpu",
                              **ckw)
        jcw = jax_compile(jnodes, jpods, JPluginSetConfig(enabled=enabled), **ckw)
        if i64:
            cw, jcw = _force_i64(cw), _force_i64(jcw)
        needs_pods = bool(set(enabled) & pspec.LABEL_COUPLED)
        if needs_pods:
            rkw["pods"] = pods
        with env(**knobs, KSS_TPU_HOST_RESIDENT=1):
            if stream:
                got = pspec.replay_speculative_stream(cw, **rkw)
                if needs_pods:
                    rkw["pods"] = jpods
                want = jspec.replay_speculative_stream(jcw, **rkw)
            else:
                got = pspec.replay_speculative(cw, **rkw)
                if needs_pods:
                    rkw["pods"] = jpods
                want = jspec.replay_speculative(jcw, None, **rkw)
        _RUNS[name] = (cw, got, want)
    return _RUNS[name]


def assert_same_replay(rr, jrr):
    assert_same(rr.selected, jrr.selected, "selected")
    assert_same(rr.feasible_count, jrr.feasible_count, "feasible_count")
    assert_same(rr.prefilter_reject, jrr.prefilter_reject, "prefilter_reject")
    for group in ("packed", "raw8", "raw16", "raw32"):
        got, want = getattr(rr._compact, group), getattr(jrr._compact, group)
        assert len(got) == len(want), group
        for ci, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"compact {group} chunk {ci}")
    for i in range(rr.cw.n_pods):
        assert decode_pod_result(rr, i) == jax_decode(jrr, i), f"pod {i}"


# ------------------------------------------------------------ end to end

@pytest.mark.parametrize("name", list(CASES))
def test_speculative_matches_jax(name):
    _cw, (rr, stats), (jrr, jstats) = runs(name)
    assert stats == jstats
    assert_same_replay(rr, jrr)


@pytest.mark.parametrize("name", ["safe_b4", "coupled_b8", "mixed_b8_k4", "i64_b8_k4",
                                  "stream_slots", "stream_contention"])
def test_speculative_matches_port_scan(name):
    cw, (rr, _), _ = runs(name)
    base = replay(cw, chunk=rr._compact.chunk, device="cpu")
    assert rr.tiers == base.tiers
    assert (rr.selected == base.selected).all()
    assert (rr.feasible_count == base.feasible_count).all()
    for i in range(cw.n_pods):
        assert decode_pod_result(rr, i) == decode_pod_result(base, i), f"pod {i}"


def test_what_the_cases_exercise():
    """The workloads do what they are there for: contention cuts batches,
    interactions cut them, the ladder climbs, the slot-pinned stream
    accepts everything in whole top-rung rounds, and the contended
    stream falls back to the scan."""
    assert runs("contention_b8")[1][1]["mean_accept"] < 8
    coupled = runs("coupled_b8")[1][1]
    assert coupled["mean_accept"] < coupled["batch"]
    ns = runs("namespaces_b2")[1][1]
    assert ns["rounds"] == 2 and ns["mean_accept"] == 1.0
    assert runs("ladder_coupled")[1][1]["adaptive"]
    pinned = runs("ladder_pinned")[1][1]
    assert pinned["round_batches"][:2] == [8, 32]
    assert pinned["accepted_first_try"] == pinned["rounds"]
    assert pinned["fallback_at"] is None and pinned["accept_rate"] == 1.0
    slots = runs("stream_slots")[1][1]
    assert slots["accept_rate"] == 1.0 and slots["rolled_back"] == 0
    assert slots["round_batches"] == [64] * 10 and slots["fallback_at"] is None
    fell = runs("stream_contention")[1][1]
    assert fell["fallback_at"] is not None and fell["scan_pods"] > 0
    i64 = runs("i64_b8_k4")[1][0]
    assert i64.tiers == ("i64",) and i64._compact.raw32
    assert all(i64._compact.host("raw32", ci).dtype == np.int64
               for ci in range(len(i64._compact.raw32)))


@pytest.mark.parametrize("name,batch", [("safe_oracle", 6), ("coupled_oracle", 6)])
def test_speculative_oracle_parity(name, batch):
    """Every annotation equals the scalar sequential oracle's."""
    if name == "safe_oracle":
        nodes, pods, enabled = (pwl.make_nodes(12, seed=21, taint_fraction=0.2),
                                pwl.make_pods(24, seed=22, with_affinity=True,
                                              with_tolerations=True), SAFE)
        jnodes, jpods = (jwl.make_nodes(12, seed=21, taint_fraction=0.2),
                         jwl.make_pods(24, seed=22, with_affinity=True, with_tolerations=True))
    else:
        nodes, pods, enabled = _coupled(pwl, interpod=True, n_nodes=10, n_pods=20, seed=29)
        jnodes, jpods, _ = _coupled(jwl, interpod=True, n_nodes=10, n_pods=20, seed=29)
    oracle = SequentialScheduler(jnodes, jpods, JPluginSetConfig(enabled=enabled)).schedule_all()
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=enabled), device="cpu")
    rr, _ = pspec.replay_speculative(cw, batch=batch, pods=pods)
    for i, (ann, sel) in enumerate(oracle):
        assert int(rr.selected[i]) == sel, f"pod {i}"
        got = decode_pod_result(rr, i)
        for key, v in ann.items():
            assert got[key] == v, f"pod {i} {key}"


def test_label_coupled_requires_manifests():
    nodes, pods, enabled = _coupled(pwl, n_nodes=6, n_pods=6)
    cfg = PluginSetConfig(enabled=enabled)
    assert not pspec.speculation_ok(cfg, have_manifests=False)
    assert pspec.speculation_ok(cfg)
    with pytest.raises(ValueError):
        pspec.replay_speculative(compile_workload(nodes, pods, cfg, device="cpu"), batch=4)


def test_init_carry_survives_speculative_replay():
    """The commit updates the carry in place on the card; the stream copies
    the workload's init_carry first, so the same cw replays again."""
    nodes, pods, _ = _safe(pwl)
    cw = compile_workload(nodes[:8], pods[:10], PluginSetConfig(enabled=SAFE), device="cpu")
    before = cw.init_carry["core"].requested.clone()
    rr1, _ = pspec.replay_speculative(cw, batch=4)
    rr2, _ = pspec.replay_speculative(cw, batch=4)
    assert (rr1.selected == rr2.selected).all()
    assert torch.equal(cw.init_carry["core"].requested, before)
    assert (replay(cw, chunk=4, device="cpu").selected == rr1.selected).all()


def test_unported_options_raise():
    nodes, pods, _ = _safe(pwl)
    cw = compile_workload(nodes[:4], pods[:4], PluginSetConfig(enabled=SAFE), device="cpu")
    # a one-card mesh is ported (B12, tests/test_torch_mesh.py); shards on
    # separate cards (B12b) stay unported and raise.  gang= is ported with
    # the engine (tests/test_torch_gang.py test_stream_takes_gang_and_ignore)
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(NotImplementedError, match="B12b"):
        pspec.replay_speculative_stream(cw, mesh=make_mesh(4, device=["cuda:0", "cuda:1"]))


@pytest.mark.parametrize("fuse", ["1", "0"])
def test_stream_on_a_cpu_mesh_matches_unsharded(fuse, monkeypatch):
    """The SAFE-set stream (sparse rounds, unsharded B4) and a contended
    one (dense rounds through spec_eval_sharded, then the sharded scan
    fallback) on a one-card CPU mesh of dp = 2 x nodes = 4, with fusion on
    and off: rows and annotations equal the unsharded stream's."""
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh

    monkeypatch.setenv("KSS_TPU_FUSE", fuse)
    mesh = make_mesh(8, dp=2, device="cpu")
    contended = (pwl.make_nodes(4, seed=3), pwl.make_pods(30, seed=4),
                 ["NodeResourcesFit", "NodeResourcesBalancedAllocation"])
    for nodes, pods, enabled in (_safe(pwl), contended):
        cw = compile_workload(nodes, pods, PluginSetConfig(enabled=enabled), device="cpu")
        base, _ = pspec.replay_speculative_stream(cw, chunk=16, pods=pods)
        got, stats = pspec.replay_speculative_stream(cw, mesh, chunk=16, pods=pods)
        assert (got.selected == base.selected).all()
        assert all(b % 2 == 0 for b in stats["round_batches"])
        for i in range(cw.n_pods):
            assert decode_pod_result(got, i) == decode_pod_result(base, i), i


def test_on_chunk_ascending():
    """on_chunk sees every grid chunk once, in ascending order, with the
    rows of that chunk already landed."""
    cw = runs("stream_contention")[0]
    seen = []
    rr, _ = pspec.replay_speculative_stream(
        cw, chunk=8, on_chunk=lambda r, lo, hi: seen.append((lo, hi, int(r.selected[hi - 1]))))
    assert [(lo, hi) for lo, hi, _ in seen] == [(lo, min(lo + 8, 30)) for lo in range(0, 30, 8)]
    assert [s for _, hi, s in seen] == [int(rr.selected[hi - 1]) for _, hi, _ in seen]


@pytest.mark.parametrize("chunk,dp,pinned", [(512, 1, None), (64, 1, None), (8, 1, None),
                                             (5, 1, None), (512, 1, 100), (64, 2, None)])
def test_batch_ladder_matches_jax(chunk, dp, pinned):
    assert pspec._batch_ladder(chunk, dp, pinned) == jspec._batch_ladder(chunk, dp, pinned)


# ------------------------------------------------------------ per kernel

_KW = {}


def kernel_workload(name):
    """-> (port cw, JAX cw) of a per-kernel workload."""
    if name not in _KW:
        build = {"mixed": _mixed, "interpod": lambda m: _coupled(m, interpod=True)}[name]
        nodes, pods, enabled = build(pwl)
        jnodes, jpods, _ = build(jwl)
        _KW[name] = (compile_workload(nodes, pods, PluginSetConfig(enabled=enabled),
                                      device="cpu"),
                     jax_compile(jnodes, jpods, JPluginSetConfig(enabled=enabled)))
    return _KW[name]


def random_carry(jcw, seed):
    """A seeded random carry shaped like jcw.init_carry, as numpy: core
    usage up to 95 % of allocatable and up to 120 pods a node (past the
    110 allowed), small random counts in the label-coupled carries."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, sub in jcw.init_carry.items():
        if name == "core":
            alloc = np.asarray(jcw.statics["core"].allocatable)
            req = (rng.random(alloc.shape) * 0.95 * alloc).astype(np.int64)
            nz = np.asarray(sub.nonzero)
            out[name] = type(sub)(requested=req, nonzero=req[:, :nz.shape[1]].copy(),
                                  num_pods=rng.integers(0, 121, np.shape(sub.num_pods)))
        elif hasattr(sub, "_fields"):
            out[name] = type(sub)(*[rng.integers(0, 3, np.shape(a)).astype(np.asarray(a).dtype)
                                    for a in sub])
        else:
            out[name] = rng.integers(0, 4, np.shape(sub)).astype(np.asarray(sub).dtype)
    return out


def both_inputs(name, lo, b, seed, wide=None):
    """The batch [lo, lo + b) (pad rows past the queue) and a random carry,
    for both packages: -> (port step, carry, xs, JAX cw, carry, xs,
    (pack_mode, score_dtypes))."""
    cw, jcw = kernel_workload(name)
    hi = min(lo + b, cw.n_pods)
    carry_np = random_carry(jcw, seed)
    carry = from_numpy_workload({}, {}, carry_np)[2]
    jcarry = jax.tree.map(jnp.asarray, carry_np)
    xs = _slice_xs(cw.xs, lo, hi, b)
    xs["is_pad"] = torch.arange(b) >= hi - lo
    jxs = jax_slice_xs(jcw.xs, lo, hi, b)
    jxs["is_pad"] = jnp.arange(b) >= hi - lo
    pack_mode, score_dtypes, _ = _compact_plan(cw, wide)
    assert (pack_mode, score_dtypes) == jax_compact_plan(jcw, wide)[:2]
    step = build_step(cw, out_mode="compact", pack_mode=pack_mode, score_dtypes=score_dtypes,
                      wide_raw=wide)
    return step, carry, xs, jcw, jcarry, jxs, (pack_mode, score_dtypes)


# (workload, lo, batch): a batch of label-coupled pods, a batch with
# wide-feasibility rows among pinned ones, and one with pad rows
WINDOWS = [("interpod", 8, 8), ("mixed", 6, 8), ("mixed", 24, 8)]


@pytest.mark.parametrize("name,lo,b", WINDOWS)
@pytest.mark.parametrize("wide", [None, "i64"])
def test_eval_plain_matches_jax(name, lo, b, wide):
    step, carry, xs, jcw, jcarry, jxs, (pm, sd) = both_inputs(name, lo, b, seed=lo, wide=wide)
    fn = jspec._eval_fn(jcw, _workload_scan_key(jcw, b), b, pm, sd, wide, None)
    want = fn(jcarry, jxs)
    got = kspec.eval_plain(step, carry, xs)
    for f in want._fields:
        assert_same(getattr(got, f), getattr(want, f), f)
    assert (_np(got.selected)[_np(xs["is_pad"])] == -1).all()


@pytest.mark.parametrize("name,lo,b", WINDOWS)
def test_oracle_core_matches_jax_on_eval(name, lo, b):
    step, carry, xs, *_ = both_inputs(name, lo, b, seed=lo + 1)
    out = kspec.eval_plain(step, carry, xs)
    got = kspec._oracle_core(out.packed_filter, out.prefilter_reject, out.selected, b)
    want = jspec._oracle_core(jnp.asarray(_np(out.packed_filter)),
                              jnp.asarray(_np(out.prefilter_reject)),
                              jnp.asarray(_np(out.selected)), b)
    assert_same(got, want, "K")


@pytest.mark.parametrize("b", [1, 8, 32])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_oracle_core_matches_jax_random(b, seed):
    rng = np.random.default_rng(seed)
    n = 40
    packed = (rng.integers(0, 4, (b, n)) * (rng.random((b, n)) < 0.7)).astype(np.uint16)
    reject = (rng.random(b) < 0.1).astype(np.int32) * 2
    selected = rng.integers(-1, n, b).astype(np.int32)
    got = kspec._oracle_core(torch.from_numpy(packed), torch.from_numpy(reject),
                             torch.from_numpy(selected), b)
    want = jspec._oracle_core(jnp.asarray(packed), jnp.asarray(reject),
                              jnp.asarray(selected), b)
    assert_same(got, want, "K")


@pytest.mark.parametrize("lo,b,kcand", [(6, 8, 4), (24, 8, 4), (0, 8, 3)])
@pytest.mark.parametrize("wide", [None, "i32"])
def test_sparse_round_plain_matches_jax(lo, b, kcand, wide):
    step, carry, xs, jcw, jcarry, jxs, (pm, sd) = both_inputs("mixed", lo, b, seed=lo + 2,
                                                              wide=wide)
    fn = jspec._sparse_round_fn(jcw, _workload_scan_key(jcw, b), b, pm, sd, wide, kcand)
    want = fn(jcarry, jxs)
    got = kspec.sparse_round_plain(step, carry, xs, kcand)
    got = (*got, kspec._oracle_core(got[0], got[1], got[7], b))
    names = ("packed", "reject", "counts", "raw8", "raw16", "raw32", "ovf", "selected", "K")
    for name, a, w in zip(names, got, want):
        assert_same(a, w, name)
    counts = _np(got[2])
    if lo == 6:
        assert counts.max() > kcand  # a wide-feasibility row is in the batch


@pytest.mark.parametrize("name,lo,b,k", [("mixed", 0, 8, 5), ("mixed", 24, 8, 3),
                                         ("interpod", 8, 8, 5), ("interpod", 40, 16, 6)])
def test_commit_plain_matches_jax(name, lo, b, k):
    step, carry, xs, jcw, jcarry, jxs, _ = both_inputs(name, lo, b, seed=lo + 3)
    selected = kspec.eval_plain(step, carry, xs).selected
    assert kspec.core_only(carry) == (name == "mixed")
    fn = jspec._commit_fn(jcw, _workload_scan_key(jcw, b), b)
    accept = jnp.arange(b) < k
    want = fn(jax.tree.map(jnp.array, jcarry), jxs, jnp.asarray(_np(selected)), accept)
    got = kspec.commit_plain(step, _clone_carry(carry), xs, selected, k)
    assert_same_carry(got, want)


@pytest.mark.parametrize("fill,b", [(0, 8), (5, 8), (3, 16)])
def test_accum_plain_matches_jax(fill, b):
    chunk, extra, n = 16, 16, 7
    rng = np.random.default_rng(fill)
    spec = {"packed": ((n,), np.uint16), "raw8": ((2, n), np.int8), "raw16": ((0, n), np.int16),
            "raw32": ((1, n), np.int64), "fc": ((), np.int32)}
    bufs = {k: rng.integers(0, 100, (chunk + extra,) + s).astype(d) for k, (s, d) in spec.items()}
    rows = {k: rng.integers(0, 100, (b,) + s).astype(d) for k, (s, d) in spec.items()}
    shapes_key = tuple(sorted((k, (chunk + extra,) + s, str(np.dtype(d)))
                              for k, (s, d) in spec.items()))
    append, emit = jspec._accum_fns(shapes_key, chunk)
    jb = append({k: jnp.asarray(v) for k, v in bufs.items()},
                {k: jnp.asarray(v) for k, v in rows.items()}, fill)
    got = kspec.append_plain({k: torch.from_numpy(v.copy()) for k, v in bufs.items()},
                             {k: torch.from_numpy(v) for k, v in rows.items()}, fill)
    for k in spec:
        assert_same(got[k], jb[k], f"append {k}")
    jheads, jrest = emit(jb)
    heads, rest = kspec.emit_plain(got, chunk)
    for k in spec:
        assert_same(heads[k], jheads[k], f"emit head {k}")
        assert_same(rest[k], jrest[k], f"emit rest {k}")


def _ladder(m, cfg_cls, hard_weight):
    """Bound anchor pods with required pod-affinity terms on three topology
    keys; every queue pod matches all three, so its InterPod raw at the
    anchors' node is 3 x hardPodAffinityWeight: past int16 for 20000, and
    the stream reruns at the next width tier."""
    nodes = m.make_nodes(6, seed=1)
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
    pods = [pod(f"q-{i}") for i in range(10)]
    cfg = cfg_cls(enabled=list(SIX), args={"InterPodAffinity": {"hardPodAffinityWeight": hard_weight}})
    return nodes, pods, cfg, bound


def test_stream_width_ladder_matches_jax():
    """A raw past its group's width makes the stream rerun from a fresh
    carry at the next tier; results, stats and on_chunk deliveries equal
    the JAX package's."""
    runs = []
    for m, cfg_cls, compile_, stream in (
            (pwl, PluginSetConfig, lambda *a, **k: compile_workload(*a, device="cpu", **k),
             pspec.replay_speculative_stream),
            (jwl, JPluginSetConfig, jax_compile, jspec.replay_speculative_stream)):
        nodes, pods, cfg, bound = _ladder(m, cfg_cls, 20000)
        seen = []
        with env(KSS_TPU_HOST_RESIDENT=1):
            rr, stats = stream(compile_(nodes, pods, cfg, bound_pods=bound), chunk=4, pods=pods,
                               on_chunk=lambda r, lo, hi: seen.append((lo, hi)))
        runs.append((rr, stats, seen))
    (rr, stats, seen), (jrr, jstats, jseen) = runs
    assert rr.tiers == (None, "i32")
    assert stats == jstats and seen == jseen
    assert seen == [(0, 4), (4, 8), (8, 10)]
    assert_same_replay(rr, jrr)
