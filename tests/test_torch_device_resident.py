"""Device-resident replay results in the port, replay by replay: the
decision-only in-wave fetch, on-demand materialization and the retention
budget (framework/replay.py), mirroring the replay-level cases of
tests/test_device_resident.py.

Whatever a reader observes (selections, the 13 annotations of every pod,
the attribution dict) is bit-identical across the three rungs: the
device-resident default, KSS_TPU_HOST_RESIDENT=1 and
KSS_TPU_EAGER_DECODE=1, and equal to the JAX package's eager replay.  On
the CPU "the device" is the CPU: a retained chunk is a torch tensor until
a read turns it into a host numpy array, through the same code the card
takes.
"""

import contextlib
import gc
import importlib
import os
import threading

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.parallel import speculative as jspec
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework.replay import (
    _DEVICE_BUDGET, _resolve_device_resident, materialize_failure_streak,
    plugin_attribution, replay)
from kube_scheduler_simulator_tpu_torch.kernels.attribution import chunk_attribution
from kube_scheduler_simulator_tpu_torch.models import baseline_config, make_nodes, make_pods
from kube_scheduler_simulator_tpu_torch.parallel import speculative as pspec
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import decode_pod_result

jreplay = importlib.import_module("kube_scheduler_simulator_tpu.framework.replay")
replay_mod = importlib.import_module("kube_scheduler_simulator_tpu_torch.framework.replay")

ENABLED = ["NodeResourcesFit", "NodeResourcesBalancedAllocation",
           "NodeAffinity", "TaintToleration", "PodTopologySpread"]
RUNGS = {"device": {}, "host": {"KSS_TPU_HOST_RESIDENT": "1"},
         "eager": {"KSS_TPU_EAGER_DECODE": "1"}}
KNOBS = ("KSS_TPU_HOST_RESIDENT", "KSS_TPU_EAGER_DECODE", "KSS_TPU_DEVICE_RESULT_BUDGET_MB",
         "KSS_TPU_DISABLE_NATIVE")


@contextlib.contextmanager
def rung(name: str, **extra):
    """The result-path knobs of one rung, every other knob unset."""
    values = {k: None for k in KNOBS}
    values.update(RUNGS[name])
    values.update(extra)
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


def _mixed_workload():
    """Taints, affinity and toleration pods, a host score column (spread)
    and two PreFilter-rejected pods mid-queue (tests/test_device_resident.py
    `_mixed_workload`)."""
    nodes = make_nodes(16, seed=3, taint_fraction=0.3)
    pods = make_pods(50, seed=4, with_affinity=True, with_tolerations=True, with_spread=True)
    for j, at in enumerate((7, 33)):
        pods.insert(at, {
            "metadata": {"name": f"pvc-pod-{j}", "namespace": "default"},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}}}],
                     "volumes": [{"name": "v", "persistentVolumeClaim": {
                         "claimName": f"missing-{j}"}}]},
        })
    for i, p in enumerate(pods):
        p["spec"]["priority"] = (i % 3) * 100
    return nodes, pods


def _compiled():
    nodes, pods = _mixed_workload()
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=list(ENABLED)), device="cpu")
    jcw = jax_compile(nodes, pods, JPluginSetConfig(enabled=list(ENABLED)))
    return cw, jcw


def _retained(cc) -> int:
    """Chunks of one result the budget holds."""
    return sum(1 for key in list(_DEVICE_BUDGET._entries) if key[0] == id(cc))


def _decode_all(rr):
    return [decode_pod_result(rr, i) for i in range(rr.cw.n_pods)]


def _jax_eager(jcw, chunk):
    with rung("eager"):
        jrr = jreplay.replay(jcw, chunk=chunk)
        return jrr, [jax_decode(jrr, i) for i in range(jcw.n_pods)], \
            jreplay.plugin_attribution(jrr)


# ----------------------------------------------------- three-rung parity


@pytest.mark.parametrize("native", [True, False])
def test_three_rung_byte_parity(native):
    """The device-resident default, the host-resident and the eager rungs
    of one replay read back byte-identical (selections, every annotation,
    the attribution), equal to the JAX package's eager replay, with the
    native codec and with the Python encoder; the device rung moved only
    decision rows and B7's sums in-wave."""
    cw, jcw = _compiled()
    jrr, janns, jatt = _jax_eager(jcw, 16)
    seen = {}
    for name in RUNGS:
        with rung(name, KSS_TPU_DISABLE_NATIVE=None if native else "1"):
            rr = replay(cw, chunk=16, device="cpu")
            cc = rr._compact
            assert all(cc.is_device(ci) == (name == "device") for ci in range(len(cc.packed)))
            att = plugin_attribution(rr)  # before any read: the device fold
            anns = _decode_all(rr)
        assert (rr.selected == jrr.selected).all() and (rr.feasible_count == jrr.feasible_count).all()
        assert anns == janns, name
        assert att == jatt, name
        seen[name] = sum(cc.d2h_bytes)
    assert seen["device"] < 64 * cw.n_pods + 4096, seen
    assert seen["host"] == seen["eager"] > seen["device"]


def test_residency_resolution():
    """Device-resident by default; an on_chunk consumer, collect=False or
    either host knob selects the host fetch; an explicit request wins over
    on_chunk but not over the knobs."""
    with rung("device"):
        assert _resolve_device_resident(None, True, None)
        assert not _resolve_device_resident(None, True, print)
        assert _resolve_device_resident(True, True, print)
        assert not _resolve_device_resident(True, False, None)
    for name in ("host", "eager"):
        with rung(name):
            assert not _resolve_device_resident(True, True, None)


def test_attribution_device_fold_matches_host_tally():
    """B7's fold (per-pod int64 sums, the bitmap-fed host column) equals
    the host tally over the same replay values, and computing it
    materializes no chunk."""
    cw, _ = _compiled()
    with rung("device"):
        launches = chunk_attribution.launches
        rr = replay(cw, chunk=16, device="cpu")
        cc = rr._compact
        assert all(a is not None for a in cc.att)
        assert chunk_attribution.launches == launches  # the plain version on the CPU
        att_dev = plugin_attribution(rr)
        assert all(cc.is_device(ci) for ci in range(len(cc.packed))) and cc.materialized == 0
        cc.att = [None] * len(cc.att)  # force the host tally over the same result
        assert plugin_attribution(rr) == att_dev
    assert "feas_packed" in replay(cw, chunk=16, device="cpu")._compact.att[0]


# ------------------------------------------------- width-tier re-runs


def test_width_tier_rerun_with_device_chunks(monkeypatch):
    """An injected score-width overflow on the third chunk re-runs the
    replay wider while the first tier's chunks were retained on the
    device; the abandoned tier's chunks leave the budget, on_chunk sees
    chunk 0 again, and the annotations equal the Python encoder's."""
    nodes, pods, cfg = baseline_config(4, scale=0.02, seed=11)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    real = replay_mod._fetch_decisions
    state = {"fired": False, "count": 0}

    def inject(out, att):
        landing = real(out, att)
        state["count"] += 1
        if not state["fired"] and state["count"] == 3:
            state["fired"] = True
            land = landing.result

            def overflowed():
                c = land()
                c["raw_overflow"] = np.ones_like(c["raw_overflow"])
                return c

            landing.result = overflowed
        return landing

    monkeypatch.setattr(replay_mod, "_fetch_decisions", inject)
    delivered = []
    with rung("device"):
        gc.collect()
        retained0 = _DEVICE_BUDGET.retained_chunks()
        rr = replay(cw, chunk=32, device="cpu", on_chunk=lambda r, lo, hi: delivered.append(lo),
                    device_resident=True)
        assert rr.tiers == (None, "i32")
        n_chunks = len(rr._compact.packed)
        assert _retained(rr._compact) == n_chunks
        assert _DEVICE_BUDGET.retained_chunks() - retained0 == n_chunks
        assert delivered.count(0) == 2 and delivered[:2] == [0, 32]
        out = _decode_all(rr)
    with rung("device", KSS_TPU_DISABLE_NATIVE="1"):
        assert out == _decode_all(rr)


# -------------------------------------------------- concurrent cold reads


def test_concurrent_cold_reads_one_fetch_per_chunk():
    """Eight threads reading every pod of a device-resident replay at once:
    every read equals the eager bytes, and each chunk is fetched exactly
    once (latecomers wait on the owner)."""
    cw, jcw = _compiled()
    _, janns, _ = _jax_eager(jcw, 16)
    with rung("device"):
        rr = replay(cw, chunk=16, device="cpu")
        n_chunks = len(rr._compact.packed)
        errors, results, start = [], {}, threading.Barrier(8)
        mu = threading.Lock()

        def reader(k):
            try:
                start.wait(timeout=30)
                for i in list(range(cw.n_pods))[k % 2::2]:
                    a = decode_pod_result(rr, i)
                    with mu:
                        assert results.setdefault(i, a) == a
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=reader, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert [results[i] for i in range(cw.n_pods)] == janns
    assert rr._compact.materialized == n_chunks
    assert not any(rr._compact.is_device(ci) for ci in range(n_chunks))


def test_failed_materialize_clears_for_retry():
    """A fetch that fails leaves the chunk on the device, counts in the
    failure streak and lets the next reader retry; a success resets it."""
    cw, _ = _compiled()
    with rung("device"):
        rr = replay(cw, chunk=16, device="cpu")
    cc = rr._compact

    class Flaky:
        def synchronize(self):
            cc.ready[0] = None
            raise RuntimeError("injected fetch failure")

    cc.ready[0] = Flaky()
    with pytest.raises(RuntimeError):
        cc.host("packed", 0)
    assert cc.is_device(0) and materialize_failure_streak() >= 1
    assert cc.host("packed", 0).flags["C_CONTIGUOUS"]
    assert materialize_failure_streak() == 0 and cc.materialized == 1


# ------------------------------------------------------- retention budget


def test_spill_then_read_round_trip():
    """KSS_TPU_DEVICE_RESULT_BUDGET_MB=0 spills every retained chunk to the
    host on the background thread; reads after the spill return the eager
    bytes without another fetch."""
    cw, jcw = _compiled()
    _, janns, jatt = _jax_eager(jcw, 16)
    with rung("device", KSS_TPU_DEVICE_RESULT_BUDGET_MB="0"):
        spilled0 = _DEVICE_BUDGET.spilled
        rr = replay(cw, chunk=16, device="cpu")
        _DEVICE_BUDGET.drain()
        n_chunks = len(rr._compact.packed)
        assert _DEVICE_BUDGET.spilled - spilled0 >= n_chunks  # others' chunks spill too
        assert not any(rr._compact.is_device(ci) for ci in range(n_chunks))
        assert _retained(rr._compact) == 0
        assert rr._compact.materialized == n_chunks
        assert _decode_all(rr) == janns
        assert plugin_attribution(rr) == jatt
        assert rr._compact.materialized == n_chunks  # the reads fetched nothing more


def test_budget_knob_parsing():
    """KSS_TPU_DEVICE_RESULT_BUDGET_MB: unset or negative is no cap, a
    number is MiB, and a typo fails safe to retaining nothing."""
    for raw, want in ((None, None), ("-1", None), ("0", 0), ("64", 64 << 20),
                      ("1.5", 1 << 20), ("512MB", 0)):
        with rung("device", KSS_TPU_DEVICE_RESULT_BUDGET_MB=raw):
            assert _DEVICE_BUDGET.limit_bytes() == want, raw


def test_budget_drops_dead_results():
    """A retained chunk's accounting goes with its result: dropping the last
    handle releases it, with no explicit call."""
    cw, _ = _compiled()
    with rung("device"):
        gc.collect()
        before = _DEVICE_BUDGET.retained_chunks()
        rr = replay(cw, chunk=16, device="cpu")
        assert _DEVICE_BUDGET.retained_chunks() - before == len(rr._compact.packed)
        assert _DEVICE_BUDGET.retained_bytes() > 0
        del rr
        gc.collect()
        assert _DEVICE_BUDGET.retained_chunks() == before


def test_collect_false_keeps_only_decisions():
    cw, _ = _compiled()
    with rung("device"):
        full = replay(cw, chunk=16, device="cpu")
        tiny = replay(cw, chunk=16, device="cpu", collect=False)
    assert tiny._compact is None
    for field in ("selected", "feasible_count", "prefilter_reject"):
        assert np.array_equal(getattr(tiny, field), getattr(full, field)), field
    assert plugin_attribution(tiny)["prefilter"] == plugin_attribution(full)["prefilter"]


# ------------------------------------------------------------ the stream

SAFE = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity", "TaintToleration"]


def _stream_slots():
    from kube_scheduler_simulator_tpu_torch.models import make_slot_pinned_workload

    nodes, pods = make_slot_pinned_workload(160, 80, seed=0)
    return nodes, pods, SAFE[:3], {"chunk": 32}


def _stream_contention():
    # tight nodes: rounds roll back and the stream falls back to the scan
    return (make_nodes(2, seed=3), make_pods(30, seed=4),
            ["NodeResourcesFit", "NodeResourcesBalancedAllocation"], {"chunk": 8})


def _stream_coupled():
    nodes = make_nodes(20, seed=13, taint_fraction=0.2)
    pods = make_pods(48, seed=14, with_affinity=True, with_tolerations=True, with_spread=True)
    return nodes, pods, SAFE + ["PodTopologySpread"], {"chunk": 16, "pods": pods}


STREAMS = {"slots": _stream_slots, "contention": _stream_contention, "coupled": _stream_coupled}


@pytest.mark.parametrize("name", list(STREAMS))
def test_stream_device_resident_matches_jax(name):
    """replay_speculative_stream(device_resident=True) against the JAX
    package's stream on the same rung: stats, selections, every chunk's
    bytes, every annotation and the attribution; one B7 run per emitted
    chunk, and the port's host rung reads the same."""
    nodes, pods, enabled, kw = STREAMS[name]()
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=enabled), device="cpu")
    jcw = jax_compile(nodes, pods, JPluginSetConfig(enabled=enabled))
    with rung("device"):
        rr, stats = pspec.replay_speculative_stream(cw, device_resident=True, **kw)
        att = plugin_attribution(rr)
        jrr, jstats = jspec.replay_speculative_stream(jcw, device_resident=True, **kw)
        jatt = jreplay.plugin_attribution(jrr)
        hrr, hstats = pspec.replay_speculative_stream(cw, device_resident=False, **kw)
    assert stats == jstats == hstats
    cc = rr._compact
    assert all(cc.is_device(ci) and cc.att[ci] is not None for ci in range(len(cc.packed)))
    assert not any(hrr._compact.is_device(ci) for ci in range(len(hrr._compact.packed)))
    assert att == jatt == plugin_attribution(hrr)
    assert np.array_equal(rr.selected, jrr.selected)
    for group in ("packed", "raw8", "raw16", "raw32"):
        for ci in range(len(cc.packed)):
            a, b = cc.host(group, ci), jrr._compact.host(group, ci)
            assert a.dtype == b.dtype and np.array_equal(a, b), f"{group} chunk {ci}"
    anns = _decode_all(rr)
    assert anns == [jax_decode(jrr, i) for i in range(cw.n_pods)]
    assert anns == _decode_all(hrr)
    if name == "contention":
        assert stats["fallback_at"] is not None  # the scan fallback's chunks were retained too
