"""Cross-session fused dispatch in the port (parallel/fuse.py, kernel B11
in kernels/fuse.py): the coordinator's protocol units of
tests/test_fuse.py on the port's coordinator; B11's plain version against
K solo plain rounds; and the engine-level bar, byte equality: sessions
whose rounds fuse give every pod the same nodeName and 13 annotations,
and every session the same bind order, as their `KSS_TPU_FUSE=0` solo run
AND as the JAX package's SessionManager run of the same specs, including
a gang-bearing session fused with a plain one.  An injected
`fuse.dispatch` fault on one session retries only that session."""

from __future__ import annotations

import copy
import threading
import time

import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.models.workloads import (
    make_slot_pinned_workload as jax_slot_pinned)
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JaxConfig
from kube_scheduler_simulator_tpu.server.sessions import SessionManager as JaxManager
from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
from kube_scheduler_simulator_tpu_torch.framework.replay import (
    _clone_carry, _compact_plan, _slice_xs)
from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
from kube_scheduler_simulator_tpu_torch.models import baseline_config
from kube_scheduler_simulator_tpu_torch.models.workloads import make_slot_pinned_workload
from kube_scheduler_simulator_tpu_torch.parallel.fuse import (
    FUSE, FuseCoordinator, session_admitted)
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.server.sessions import SessionManager
from kube_scheduler_simulator_tpu_torch.state.compile import compile_workload
from kube_scheduler_simulator_tpu_torch.utils import faults
from kube_scheduler_simulator_tpu_torch.utils.tracing import TRACER, validate_exposition

ENABLED = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity"]


# ------------------------------------------------- coordinator protocol


def _solo_fn(c, x):
    return c + x, (c * x).sum()


# the port's fused call runs `solo_fn.fused` over the members' argument
# tuples (B11 for the speculative rounds); a plain function's fused form
# is its solo call per member
_solo_fn.fused = lambda args_list: [_solo_fn(*a) for a in args_list]


def _eq(a, b) -> bool:
    return torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_dispatch_timeshares_without_a_live_partner(monkeypatch):
    monkeypatch.setenv("KSS_TPU_FUSE_WINDOW_MS", "5000")
    c = FuseCoordinator()
    s = c.stream_open("fam-alone")
    out = c.dispatch(s, ("fam-alone", "k1"), _solo_fn, (torch.arange(4), torch.ones(4)))
    assert _eq(out[0], torch.arange(4) + 1)
    # a benched stream never joins batches either, even with partners
    s2 = c.stream_open("fam-alone")
    benched = c.stream_open("fam-alone", admitted=False)
    out = c.dispatch(benched, ("fam-alone", "k1"), _solo_fn, (torch.arange(4), torch.ones(4)))
    assert _eq(out[0], torch.arange(4) + 1)
    assert c.stats()["dispatches"]["timeshared"] == 2
    assert c.stats()["fusedDeviceCalls"] == 0
    for st in (s, s2, benched):
        c.stream_close(st)
    assert c.stats()["openFamilies"] == 0


def test_leader_times_out_when_partner_never_dispatches(monkeypatch):
    monkeypatch.setenv("KSS_TPU_FUSE_WINDOW_MS", "40")
    c = FuseCoordinator()
    s1 = c.stream_open("fam-to")
    s2 = c.stream_open("fam-to")  # live partner that never calls
    t0 = time.monotonic()
    out = c.dispatch(s1, ("fam-to", "k1"), _solo_fn, (torch.arange(3), torch.ones(3)))
    waited = time.monotonic() - t0
    assert _eq(out[0], torch.arange(3) + 1)
    assert waited >= 0.03, "leader should have waited out the window"
    assert c.stats()["dispatches"]["window_timeout"] == 1
    c.stream_close(s1)
    c.stream_close(s2)


def test_two_streams_fuse_one_device_call(monkeypatch):
    monkeypatch.setenv("KSS_TPU_FUSE_WINDOW_MS", "5000")
    c = FuseCoordinator()
    streams = [c.stream_open("fam-2"), c.stream_open("fam-2")]
    rows = [(torch.arange(4) + 10 * i, torch.full((4,), float(i + 1))) for i in range(2)]
    outs: dict = {}

    def run(i):
        outs[i] = c.dispatch(streams[i], ("fam-2", "kA"), _solo_fn, rows[i])

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    for i in range(2):
        solo = _solo_fn(*rows[i])
        assert _eq(outs[i][0], solo[0]), f"row {i} diverged"
        assert _eq(outs[i][1], solo[1])
    st = c.stats()
    assert st["fusedDeviceCalls"] == 1
    assert st["dispatches"]["fused"] == 2
    assert st["meanSessionsPerFusedCall"] == 2.0
    for s in streams:
        c.stream_close(s)


def test_mutual_leader_deadlock_breaks_and_realigns(monkeypatch):
    """Stream B arriving at a DIFFERENT key while A leads runs solo at
    once, then fuses with A when it re-arrives at A's key."""
    monkeypatch.setenv("KSS_TPU_FUSE_WINDOW_MS", "10000")
    c = FuseCoordinator()
    sa, sb = c.stream_open("fam-dl"), c.stream_open("fam-dl")
    args = (torch.arange(4), torch.ones(4))
    out_a: list = []

    ta = threading.Thread(
        target=lambda: out_a.append(c.dispatch(sa, ("fam-dl", "k1"), _solo_fn, args)))
    ta.start()
    time.sleep(0.2)  # A is now the registered leader at k1, waiting

    t0 = time.monotonic()
    out_b1 = c.dispatch(sb, ("fam-dl", "k2"), _solo_fn, args)
    assert time.monotonic() - t0 < 5.0, (
        "second leader at a different key slept toward the window instead of "
        "breaking the mutual-leader deadlock")
    out_b2 = c.dispatch(sb, ("fam-dl", "k1"), _solo_fn, args)
    ta.join(timeout=30)
    assert not ta.is_alive(), "leader A never completed"
    solo = _solo_fn(*args)
    for out in (out_a[0], out_b1, out_b2):
        assert _eq(out[0], solo[0])
    st = c.stats()
    assert st["fusedDeviceCalls"] == 1
    assert st["dispatches"]["window_timeout"] == 1  # B's k2 solo
    assert st["dispatches"]["fused"] == 2
    c.stream_close(sa)
    c.stream_close(sb)


def test_fused_call_failure_surfaces_to_every_member(monkeypatch):
    monkeypatch.setenv("KSS_TPU_FUSE_WINDOW_MS", "5000")
    c = FuseCoordinator()
    streams = [c.stream_open("fam-err"), c.stream_open("fam-err")]

    def boom(carry, xs):
        raise ValueError("device fell over")

    def boom_fused(args_list):
        raise ValueError("device fell over")

    boom.fused = boom_fused
    errs: dict = {}

    def run(i):
        try:
            c.dispatch(streams[i], ("fam-err", "kE"), boom, (torch.ones(2), torch.ones(2)))
        except ValueError as e:
            errs[i] = str(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert errs == {0: "device fell over", 1: "device fell over"}
    assert c.stats()["dispatches"]["fused"] == 0
    for s in streams:
        c.stream_close(s)


def test_fused_call_needs_a_fused_form(monkeypatch):
    """The port stacks nothing: a function with no fused form cannot share
    a launch, and the error reaches every member."""
    monkeypatch.setenv("KSS_TPU_FUSE_WINDOW_MS", "5000")
    c = FuseCoordinator()
    streams = [c.stream_open("fam-nf"), c.stream_open("fam-nf")]

    def plain(a):
        return a

    errs: dict = {}

    def run(i):
        try:
            c.dispatch(streams[i], ("fam-nf", "k"), plain, (torch.ones(1),))
        except TypeError as e:
            errs[i] = str(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert len(errs) == 2 and "no fused form" in errs[0]
    for s in streams:
        c.stream_close(s)


def test_admission_reads_session_accept_rates(monkeypatch):
    monkeypatch.setenv("KSS_TPU_FUSE_MIN_ACCEPT", "0.25")
    TRACER.reset()
    with TRACER.session_scope("adm-hot"):
        TRACER.inc("speculative_accepted_total", 9)
        TRACER.inc("speculative_rolled_back_total", 1)
    with TRACER.session_scope("adm-cold"):
        TRACER.inc("speculative_accepted_total", 1)
        TRACER.inc("speculative_rolled_back_total", 9)
    assert session_admitted("adm-hot")
    assert not session_admitted("adm-cold")
    assert session_admitted("adm-never-seen")  # no history: optimistic


# ------------------------------------------------ B11's plain version


def _members(kind: str, k: int, b: int = 8):
    """K members of one family: the slot-pinned fleet (sparse) or config 5
    (dense, label-coupled), each with its own pods (seed) and a carry
    advanced by a few committed pods."""
    out = []
    for s in range(k):
        if kind == "sparse":
            nodes, pods = make_slot_pinned_workload(32, 12, seed=100 + s)
            cfg = PluginSetConfig(enabled=list(ENABLED))
        else:
            nodes, pods, cfg = baseline_config(5, scale=0.004, seed=0)
            rng = np.random.default_rng(s)
            pods = [pods[i] for i in rng.permutation(len(pods))]
        cw = compile_workload(nodes, pods, cfg, device="cpu")
        pack_mode, score_dtypes, _ = _compact_plan(cw, None)
        step = build_step(cw, out_mode="compact", pack_mode=pack_mode,
                          score_dtypes=score_dtypes)
        carry = _clone_carry(cw.init_carry)
        xs0 = _slice_xs(cw.xs, 0, 4, 4)
        xs0["is_pad"] = torch.zeros(4, dtype=torch.bool)
        sel0 = kspec.eval_plain(step, carry, xs0).selected
        carry = kspec.commit_plain(step, carry, xs0, sel0, 4)
        m = min(b, cw.n_pods - 4)
        xs = _slice_xs(cw.xs, 4, 4 + m, b)
        xs["is_pad"] = torch.arange(b) >= m
        out.append(kfuse.Member(step, carry, xs, 6 if kind == "sparse" else None))
    return out


def _flat(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _flat(v)]


@pytest.mark.parametrize("kind,k", [("sparse", 2), ("sparse", 4), ("dense", 2), ("dense", 3)])
def test_b11_plain_equals_k_solo_plain_rounds(kind, k):
    members = _members(kind, k)
    fused = (kfuse.sparse_round_fused if kind == "sparse" else kfuse.dense_round_fused)(members)
    solo_fn = kfuse.sparse_round if kind == "sparse" else kfuse.dense_round
    plain = kfuse.round_plain(members)
    assert len(fused) == len(plain) == k
    for i, m in enumerate(members):
        solo = solo_fn(m)
        for got, want, ref in zip(_flat(fused[i]), _flat(solo), _flat(plain[i])):
            assert torch.equal(got, want) and torch.equal(got, ref), (kind, k, i)
    # the session axis is real: members' outputs differ where their pods do
    sel = [(r[7] if kind == "sparse" else r[0].selected) for r in fused]
    assert any(not torch.equal(sel[0], s) for s in sel[1:])


def test_b11_refuses_members_of_different_families():
    a = _members("sparse", 1)[0]
    nodes, pods = make_slot_pinned_workload(32, 10, seed=5)  # 10 nodes, not 12
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=list(ENABLED)), device="cpu")
    pack_mode, score_dtypes, _ = _compact_plan(cw, None)
    step = build_step(cw, out_mode="compact", pack_mode=pack_mode, score_dtypes=score_dtypes)
    xs = _slice_xs(cw.xs, 0, 8, 8)
    xs["is_pad"] = torch.zeros(8, dtype=torch.bool)
    b = kfuse.Member(step, _clone_carry(cw.init_carry), xs, 6)
    with pytest.raises(ValueError, match="does not fit the batch"):
        kfuse.sparse_round_fused([a, b])
    with pytest.raises(ValueError, match="candidate cap"):
        kfuse.dense_round_fused([a])


def test_sharded_members_fuse_as_their_solo_rounds():
    """Members sharded over one CPU mesh (B12): a fused dense round runs
    their spec_eval_sharded rounds in turn inside the one `_run_fused`,
    each equal to the unsharded B11 round of the same member; a fused
    call on one mesh refuses a member on another."""
    from kube_scheduler_simulator_tpu_torch.parallel.fuse import _place_sessions
    from kube_scheduler_simulator_tpu_torch.parallel.mesh import make_mesh, shard_workload

    mesh = make_mesh(8, dp=2, device="cpu")
    members = _members("dense", 2)
    sharded = []
    for m in members:
        step = build_step(shard_workload(m.step.cw, mesh), out_mode="compact",
                          pack_mode=m.step.pack_mode, score_dtypes=m.step.score_dtypes)
        sharded.append(kfuse.Member(step, m.carry, m.xs))
    args = [(m,) for m in sharded]
    got = FuseCoordinator()._run_fused("key", kfuse.dense_round, args, 2, mesh)
    want = kfuse.dense_round_fused(members)
    assert len(got) == 2
    for g, w in zip(got, want):
        for a, b in zip(_flat(g), _flat(w), strict=True):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="fused call on"):
        _place_sessions(args, make_mesh(4, device="cpu"), 2)


# ----------------------------------------------- engine golden parity


def _mk_sessions(mgr, specs, jax_side: bool):
    """specs: [(name, nodes, config, podgroups)] -> ({name: sess},
    {name: bind-order list})."""
    sessions, orders = {}, {}
    for name, nodes, cfg, pgs in specs:
        sess = mgr.create(name)
        eng = sess.di.engine
        eng.set_profiles(None)
        eng.plugin_config = cfg
        if pgs is not None:
            if jax_side:
                from kube_scheduler_simulator_tpu.plugins.coscheduling import (
                    ensure_podgroup_resource)
            else:
                from kube_scheduler_simulator_tpu_torch.plugins.coscheduling import (
                    ensure_podgroup_resource)
            ensure_podgroup_resource(sess.di.store)
            for pg in pgs:
                sess.di.store.create("podgroups", copy.deepcopy(pg))
        for n in nodes:
            sess.di.store.create("nodes", copy.deepcopy(n))
        order: list = []
        orig_batch, orig_bind = eng._commit_pod_batch, eng._bind

        def batch_spy(items, _orig=orig_batch, _order=order):
            _order.extend((ns, n, node) for ns, n, node in items if node)
            return _orig(items)

        def bind_spy(ns, n, node, _orig=orig_bind, _order=order):
            _order.append((ns, n, node))
            return _orig(ns, n, node)

        eng._commit_pod_batch = batch_spy
        eng._bind = bind_spy
        sessions[name] = sess
        orders[name] = order
    return sessions, orders


def _run_arm(monkeypatch, sessions, orders, pods_by_session, fuse_on, window_ms=4000):
    """One concurrent wave across all sessions -> per session (state, bind
    order), state mapping pod -> (nodeName, sorted annotations)."""
    monkeypatch.setenv("KSS_TPU_SPECULATIVE", "1")
    monkeypatch.setenv("KSS_TPU_FUSE", "1" if fuse_on else "0")
    monkeypatch.setenv("KSS_TPU_FUSE_WINDOW_MS", str(window_ms))
    for name, sess in sessions.items():
        for p in pods_by_session[name]:
            sess.di.store.create("pods", copy.deepcopy(p))
        orders[name].clear()
    barrier = threading.Barrier(len(sessions))
    errs: list = []

    def run(sess):
        try:
            barrier.wait()
            sess.di.engine.schedule_pending()
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(s,), daemon=True) for s in sessions.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errs, errs
    result = {}
    for name, sess in sessions.items():
        state = {}
        for p in sess.di.store.list("pods", copy_objects=False)[0]:
            meta = p["metadata"]
            state[meta["name"]] = ((p.get("spec") or {}).get("nodeName"),
                                   tuple(sorted((meta.get("annotations") or {}).items())))
        result[name] = (state, list(orders[name]))
        for p in sess.di.store.list("pods", copy_objects=False)[0][:]:
            meta = p["metadata"]
            sess.di.store.delete("pods", meta["name"], meta.get("namespace"))
    return result


def _assert_arms_identical(fused, solo):
    for name in solo:
        fs, fo = fused[name]
        ss, so = solo[name]
        diff = sorted(k for k in ss if ss[k] != fs.get(k))
        assert fs == ss, f"{name}: state diverged at {diff[:4]}"
        assert fo == so, f"{name}: bind order diverged"


def _jax_arm(monkeypatch, specs, pods):
    """The JAX package's SessionManager run of the same specs (fused)."""
    mgr = JaxManager(max_sessions=len(specs) + 1, idle_ttl=0, start_scheduler=False)
    try:
        sessions, orders = _mk_sessions(mgr, specs, jax_side=True)
        return _run_arm(monkeypatch, sessions, orders, pods, fuse_on=True)
    finally:
        mgr.shutdown()


@pytest.mark.parametrize("candidates", ["128", "4"])
def test_fused_sessions_byte_identical_to_solo_and_jax(monkeypatch, candidates):
    """Two sessions with DIFFERENT pods over the same fleet fuse into
    shared launches, and every annotation byte and bind order matches
    their KSS_TPU_FUSE=0 runs and the JAX package's sessions; the fused
    metric families land validator-clean.  With the default candidate cap
    (past the 12 nodes) the rounds are dense; with a cap of 4, sparse."""
    monkeypatch.setenv("KSS_TPU_SPECULATIVE_CANDIDATES", candidates)
    kind = "sparse_round_fused" if candidates == "4" else "dense_round_fused"
    calls = {"n": 0}
    real = getattr(kfuse, kind)

    def counted(members):
        calls["n"] += 1
        return real(members)

    monkeypatch.setattr(kfuse, kind, counted)
    nodes, pods_a = make_slot_pinned_workload(24, 12, seed=71)
    pods_b = make_slot_pinned_workload(24, 12, seed=72)[1]
    jnodes, jpods_a = jax_slot_pinned(24, 12, seed=71)
    assert jnodes == nodes and jpods_a == pods_a
    pods = {"fz-a": pods_a, "fz-b": pods_b}
    mgr = SessionManager(max_sessions=3, idle_ttl=0, start_scheduler=False, device="cpu")
    try:
        sessions, orders = _mk_sessions(
            mgr, [(n, nodes, PluginSetConfig(enabled=list(ENABLED)), None) for n in pods],
            jax_side=False)
        before = FUSE.stats()["fusedDeviceCalls"]
        fused = _run_arm(monkeypatch, sessions, orders, pods, fuse_on=True)
        assert FUSE.stats()["fusedDeviceCalls"] - before >= 1, (
            "the fused arm never shared a cross-session launch")
        solo = _run_arm(monkeypatch, sessions, orders, pods, fuse_on=False)
        _assert_arms_identical(fused, solo)
        assert all(v[0] for st, _o in fused.values() for v in st.values()), \
            "slot-pinned workload should bind every pod"
        assert calls["n"] >= 1, f"no fused {kind} ran"
        fams = validate_exposition(TRACER.prometheus_text())
        assert fams["kss_tpu_fused_dispatch_total"]["type"] == "counter"
        assert fams["kss_tpu_fused_sessions_per_dispatch"]["type"] == "histogram"
    finally:
        mgr.shutdown()
    jax = _jax_arm(monkeypatch, [(n, nodes, JaxConfig(enabled=list(ENABLED)), None)
                                 for n in pods], pods)
    _assert_arms_identical(fused, jax)


def _gang_specs(port_side: bool):
    from kube_scheduler_simulator_tpu_torch.framework.gang import (
        POD_GROUP_API_VERSION, POD_GROUP_LABEL)

    nodes, base_pods = make_slot_pinned_workload(16, 8, seed=81)
    gang_pods = copy.deepcopy(base_pods)
    pgs = []
    for g, lo in enumerate((0, 3)):
        gname = f"fzgang-{g}"
        pgs.append({"apiVersion": POD_GROUP_API_VERSION, "kind": "PodGroup",
                    "metadata": {"name": gname, "namespace": "default"},
                    "spec": {"minMember": 3, "scheduleTimeoutSeconds": 30}})
        for p in gang_pods[lo:lo + 3]:
            p["metadata"].setdefault("labels", {})[POD_GROUP_LABEL] = gname
    if port_side:
        from kube_scheduler_simulator_tpu_torch.plugins.coscheduling import Coscheduling
        mk = PluginSetConfig
    else:
        from kube_scheduler_simulator_tpu.plugins.coscheduling import Coscheduling
        mk = JaxConfig
    cos = Coscheduling()
    enabled = ["NodeResourcesFit", "Coscheduling"]

    def cfg():
        return mk(enabled=list(enabled), custom={"Coscheduling": cos})

    specs = [("fz-gang", nodes, cfg(), pgs), ("fz-plain", nodes, cfg(), [])]
    return specs, {"fz-gang": gang_pods, "fz-plain": base_pods}, POD_GROUP_LABEL


def test_gang_bearing_session_fuses_with_plain_session(monkeypatch):
    """A gang-bearing session and a plain-pod session share one fused
    batch and both stay byte-identical to their solo runs and to the JAX
    package's sessions, gang admission included."""
    specs, pods, label = _gang_specs(port_side=True)
    mgr = SessionManager(max_sessions=3, idle_ttl=0, start_scheduler=False, device="cpu")
    try:
        sessions, orders = _mk_sessions(mgr, specs, jax_side=False)
        before = FUSE.stats()["fusedDeviceCalls"]
        fused = _run_arm(monkeypatch, sessions, orders, pods, fuse_on=True)
        assert FUSE.stats()["fusedDeviceCalls"] - before >= 1, (
            "gang-bearing and plain sessions never fused")
        solo = _run_arm(monkeypatch, sessions, orders, pods, fuse_on=False)
        _assert_arms_identical(fused, solo)
        gang_state = fused["fz-gang"][0]
        members: dict = {}
        for p in pods["fz-gang"]:
            g = (p["metadata"].get("labels") or {}).get(label)
            if g:
                members.setdefault(g, []).append(p["metadata"]["name"])
        for g, names in members.items():
            assert sum(bool(gang_state[n][0]) for n in names) == 3, \
                f"{g}: admitted gang must bind whole"
    finally:
        mgr.shutdown()
    jspecs, jpods, _ = _gang_specs(port_side=False)
    _assert_arms_identical(fused, _jax_arm(monkeypatch, jspecs, jpods))


def test_mid_dispatch_fault_retries_only_faulted_session(monkeypatch):
    """A `fuse.dispatch` fault scoped to one session aborts only that
    session's wave (suffix retry); its batch-mate proceeds untouched, and
    both end byte-identical to the fault-free solo runs."""
    nodes, pods_a = make_slot_pinned_workload(24, 12, seed=91)
    pods_b = make_slot_pinned_workload(24, 12, seed=92)[1]
    pods = {"fz-f0": pods_a, "fz-f1": pods_b}
    mgr = SessionManager(max_sessions=3, idle_ttl=0, start_scheduler=False, device="cpu")
    try:
        sessions, orders = _mk_sessions(
            mgr, [(n, nodes, PluginSetConfig(enabled=list(ENABLED)), None) for n in pods],
            jax_side=False)
        for s in sessions.values():
            s.di.engine._retry_sleep = lambda _d: None
        solo = _run_arm(monkeypatch, sessions, orders, pods, fuse_on=False)
        TRACER.reset()
        plan = faults.FaultPlan([
            faults.FaultRule("fuse.dispatch", nth=2, error="runtime", sessions=["fz-f0"]),
        ], seed=3)
        with faults.armed(plan):
            faulted = _run_arm(monkeypatch, sessions, orders, pods, fuse_on=True,
                               window_ms=500)
        assert plan.stats()["rules"][0]["trips"] == 1, "fault never fired"
        retried = TRACER.snapshot(session="fz-f0")["counters"]
        neighbor = TRACER.snapshot(session="fz-f1")["counters"]
        assert retried.get("wave_retries_total", 0) >= 1, retried
        assert neighbor.get("wave_retries_total", 0) == 0, (
            "the fault leaked into the batch-mate's wave", neighbor)
        _assert_arms_identical(faulted, solo)
    finally:
        mgr.shutdown()


def test_contended_session_is_benched_after_its_first_wave(monkeypatch):
    """Admission reads the stream's own counters: a session whose waves
    roll most rounds back (config 5, label-coupled, contended) time-shares
    from its next stream on."""
    nodes, pods, cfg = baseline_config(5, scale=0.004, seed=0)
    monkeypatch.setenv("KSS_TPU_SPECULATIVE", "1")
    monkeypatch.setenv("KSS_TPU_FUSE", "1")
    mgr = SessionManager(max_sessions=2, idle_ttl=0, start_scheduler=False, device="cpu")
    try:
        sess = mgr.create("fz-contended")
        eng = sess.di.engine
        eng.set_profiles(None)
        eng.plugin_config = cfg
        for n in nodes:
            sess.di.store.create("nodes", copy.deepcopy(n))
        for p in pods:
            sess.di.store.create("pods", copy.deepcopy(p))
        assert session_admitted("fz-contended")  # no history yet
        eng.schedule_pending()
        rates = TRACER.labeled_totals("speculative_rolled_back_total", "session")
        assert rates.get("fz-contended", 0) > 0
        assert not session_admitted("fz-contended")
    finally:
        mgr.shutdown()
