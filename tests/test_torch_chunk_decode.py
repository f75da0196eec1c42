"""The port's chunk-granular native decode: parity, edge pods,
re-delivery, threads (the cases of tests/test_chunk_decode.py).

The three decoder rungs (chunk-granular ctx_decode_chunk -> per-pod fused
ctx_decode_pod -> the Python encoder) must be byte-identical on every pod,
and equal to the JAX package's decode, including the shapes the chunk call
special-cases: PreFilter-rejected pods (the Python early-out owns them),
empty-active-mask pods, host-resident score columns, ranges that start
mid-chunk, width-tier re-delivery and concurrent chunk calls (per-call
arenas must not be shared).
"""

import importlib
import threading

import numpy as np

from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework.replay import replay
from kube_scheduler_simulator_tpu_torch.models import baseline_config, make_nodes, make_pods
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import annotations as ann
from kube_scheduler_simulator_tpu_torch.store.decode import (
    _decode_path_label, decode_chunk_into, decode_pod_result)

replay_mod = importlib.import_module("kube_scheduler_simulator_tpu_torch.framework.replay")
decode_mod = importlib.import_module("kube_scheduler_simulator_tpu_torch.store.decode")


def _decode_three_ways(rr, n, monkeypatch):
    """(chunk, per-pod fused, Python encoder) annotation lists for pods 0..n."""
    chunk: list = [None] * n
    decode_chunk_into(rr, 0, n, chunk)
    fused = [decode_pod_result(rr, i) for i in range(n)]
    monkeypatch.setenv("KSS_TPU_DISABLE_NATIVE", "1")
    try:
        pure = [decode_pod_result(rr, i) for i in range(n)]
    finally:
        monkeypatch.delenv("KSS_TPU_DISABLE_NATIVE")
    return chunk, fused, pure


def _assert_all_equal(chunk, fused, pure, jax_anns):
    for i, (ca, fa, pa, ja) in enumerate(zip(chunk, fused, pure, jax_anns, strict=True)):
        for k in pa:
            assert ca[k] == pa[k], (f"pod {i} key {k} (chunk vs pure)\n chunk={ca[k][:300]}\n"
                                    f" pure={pa[k][:300]}")
            assert fa[k] == pa[k], f"pod {i} key {k} (fused vs pure)"
            assert pa[k] == ja[k], f"pod {i} key {k} (port vs JAX)"


def _jax_anns(nodes, pods, enabled, chunk):
    jrr = jax_replay(jax_compile(nodes, pods, JPluginSetConfig(enabled=list(enabled))),
                     chunk=chunk)
    return [jax_decode(jrr, i) for i in range(len(pods))]


def test_chunk_decode_parity_with_rejects_and_host_columns(monkeypatch):
    """PreFilter-rejected pods (a missing PVC), plain and affinity pods,
    taints and host-resident score columns (NodeAffinity and
    VolumeBinding): all three decoder rungs byte-identical."""
    nodes = make_nodes(25, seed=3, taint_fraction=0.3)
    pods = make_pods(40, seed=4, with_affinity=True, with_tolerations=True)
    for j, at in enumerate((7, 23)):
        pods.insert(at, {
            "metadata": {"name": f"pvc-pod-{j}", "namespace": "default"},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "100m"}}}],
                     "volumes": [{"name": "v", "persistentVolumeClaim": {
                         "claimName": f"missing-{j}"}}]},
        })
    enabled = ["NodeResourcesFit", "NodeAffinity", "TaintToleration", "VolumeBinding"]
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=enabled), device="cpu")
    assert "host" in cw.host["score_dtypes"]  # a host column
    assert "prefilter_reject" in cw.host      # the reject path
    rr = replay(cw, chunk=16, device="cpu")
    assert _decode_path_label(rr) == "native_chunk"
    chunk, fused, pure = _decode_three_ways(rr, len(pods), monkeypatch)
    _assert_all_equal(chunk, fused, pure, _jax_anns(nodes, pods, enabled, 16))
    for at in (7, 23):
        assert chunk[at][ann.FILTER_RESULT] == "{}"
        assert "VolumeBinding" in chunk[at][ann.PRE_FILTER_STATUS_RESULT]


def test_chunk_decode_parity_empty_active_mask(monkeypatch):
    """Pods whose every enabled Filter is PreFilter-skipped emit
    filter-result {} with the score maps still populated from the
    host-resident column."""
    nodes = make_nodes(12, seed=5)
    pods = make_pods(20, seed=6)  # no affinity: NodeAffinity skips
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=["NodeAffinity"]), device="cpu")
    assert all(cw.host["filter_skip"]["NodeAffinity"])
    rr = replay(cw, chunk=8, device="cpu")
    chunk, fused, pure = _decode_three_ways(rr, len(pods), monkeypatch)
    _assert_all_equal(chunk, fused, pure, _jax_anns(nodes, pods, ["NodeAffinity"], 8))
    assert chunk[0][ann.FILTER_RESULT] == "{}"
    assert chunk[0][ann.SELECTED_NODE] != ""


def _inject_overflow(monkeypatch, fetch_name: str) -> dict:
    """Flip raw_overflow in the third chunk fetched through
    replay_mod.<fetch_name>, once: the replay re-runs at the next tier and
    re-delivers every chunk from pod 0 with the same values."""
    real = getattr(replay_mod, fetch_name)
    state = {"fired": False, "count": 0}

    def fetch(*args):
        landing = real(*args)
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

    monkeypatch.setattr(replay_mod, fetch_name, fetch)
    return state


def _redelivered(monkeypatch, **kw):
    nodes, pods, cfg = baseline_config(4, scale=0.02, seed=11)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    out: list = [None] * len(pods)
    deliveries: list = []

    def on_chunk(rr_, lo, hi):
        deliveries.append((lo, hi))
        decode_chunk_into(rr_, lo, hi, out)

    rr = replay(cw, chunk=32, device="cpu", on_chunk=on_chunk, **kw)
    assert rr.tiers == (None, "i32")
    assert deliveries.count(deliveries[0]) >= 2, deliveries  # chunk 0 re-delivered
    monkeypatch.setenv("KSS_TPU_DISABLE_NATIVE", "1")
    try:
        pure = [decode_pod_result(rr, i) for i in range(len(pods))]
    finally:
        monkeypatch.delenv("KSS_TPU_DISABLE_NATIVE")
    for i, (ca, pa) in enumerate(zip(out, pure)):
        assert ca == pa, f"pod {i} diverged after width-tier re-delivery"
    return rr


def test_chunk_decode_width_tier_redelivery(monkeypatch):
    """A score-width overflow makes replay() re-deliver chunks from pod 0
    at a wider dtype (the host rung an on_chunk consumer gets by default);
    the chunk decoder's per-index writes are idempotent."""
    monkeypatch.delenv("KSS_TPU_HOST_RESIDENT", raising=False)
    _inject_overflow(monkeypatch, "_fetch_chunk")
    rr = _redelivered(monkeypatch)
    assert not rr._compact.is_device(0)


def test_chunk_decode_width_tier_redelivery_device_rung_single_core(monkeypatch):
    """The same re-delivery on the device-resident rung, with one effective
    core (the decoders' serial branch): the abandoned tier's retained chunks
    are never delivered twice with other values, and the decode reads the
    retained chunks of the final tier."""
    monkeypatch.delenv("KSS_TPU_HOST_RESIDENT", raising=False)
    monkeypatch.delenv("KSS_TPU_EAGER_DECODE", raising=False)
    monkeypatch.setattr(decode_mod, "effective_cpu_count", lambda: 1)
    _inject_overflow(monkeypatch, "_fetch_decisions")
    rr = _redelivered(monkeypatch, device_resident=True)
    assert rr._compact.materialized == len(rr._compact.packed)


def test_chunk_decode_threaded_soak():
    """Concurrent chunk calls over one result: every call gets its own
    arena, so parallel decoders never see another chunk's blobs.  Ranges
    start mid-chunk; the chunks are device-resident, so the first readers
    also race to fetch them."""
    nodes, pods, cfg = baseline_config(4, scale=0.02, seed=13)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    rr = replay(cw, chunk=32, device="cpu")
    ref = replay(cw, chunk=32, device="cpu", device_resident=False)
    n = len(pods)
    expected: list = [None] * n
    decode_chunk_into(ref, 0, n, expected)

    errors: list = []
    rng = np.random.RandomState(0)
    ranges = []
    for _ in range(24):
        lo = int(rng.randint(0, n - 1))
        hi = int(min(n, lo + 1 + rng.randint(0, 40)))
        ranges.append((lo, hi))

    def worker(my_ranges):
        try:
            for lo, hi in my_ranges:
                sink: list = [None] * (hi - lo)
                decode_chunk_into(rr, lo, hi, sink, base=lo)
                for j, a in enumerate(sink):
                    if a != expected[lo + j]:
                        errors.append(f"pod {lo + j} (range {lo}..{hi}) diverged")
                        return
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    threads = [threading.Thread(target=worker, args=(ranges[k::4],)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert rr._compact.materialized <= len(rr._compact.packed)
