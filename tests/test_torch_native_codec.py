"""The port's native annotation codec (kube_scheduler_simulator_tpu_torch/
native/annotation_codec.cpp) against its Python encoder and the JAX
package's decode, byte for byte: the cases of tests/test_native_codec.py.

The codec builds with g++ at first use; a missing compiler or a failed
build raises, so these tests fail loudly rather than skip where the codec
cannot be built.
"""

import ctypes
import json
import shutil

import numpy as np
import pytest

from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.annotations import marshal as jax_marshal
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu.store.reflector import update_result_history
from kube_scheduler_simulator_tpu_torch import native
from kube_scheduler_simulator_tpu_torch.framework.replay import replay
from kube_scheduler_simulator_tpu_torch.models import baseline_config, make_nodes, make_pods
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import annotations as ann
from kube_scheduler_simulator_tpu_torch.store import native_decode
from kube_scheduler_simulator_tpu_torch.store.decode import (
    _decode_path_label, decode_chunk_into, decode_pod_result, decode_release_batches)
from kube_scheduler_simulator_tpu_torch.store.native_decode import (
    build_context, encode_filter, encode_string_map)


def _python(monkeypatch, fn):
    """fn() with the Python encoder selected."""
    monkeypatch.setenv("KSS_TPU_DISABLE_NATIVE", "1")
    try:
        return fn()
    finally:
        monkeypatch.delenv("KSS_TPU_DISABLE_NATIVE")


@pytest.mark.parametrize("idx,scale", [(3, 0.02), (5, 0.01)])
def test_native_matches_python(idx, scale, monkeypatch):
    nodes, pods, cfg = baseline_config(idx, scale=scale, seed=42)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    rr = replay(cw, chunk=64, device="cpu")
    assert _decode_path_label(rr) == "native_chunk"
    native_anns = [decode_pod_result(rr, i) for i in range(len(pods))]
    pure = _python(monkeypatch, lambda: [decode_pod_result(rr, i) for i in range(len(pods))])
    jrr = jax_replay(jax_compile(nodes, pods, JPluginSetConfig(enabled=list(cfg.enabled))),
                     chunk=64)
    for i, (na, pa) in enumerate(zip(native_anns, pure)):
        ja = jax_decode(jrr, i)
        for k in pa:
            assert na[k] == pa[k] == ja[k], (
                f"pod {i} key {k}\n native={na[k][:300]}\n python={pa[k][:300]}")


def test_native_escaping(monkeypatch):
    """Message content with JSON-special and HTML-escaped characters."""
    nodes = [
        {"metadata": {"name": 'n"0'},
         "spec": {"taints": [{"key": 'a<b&"c', "value": "x\\y", "effect": "NoSchedule"}]},
         "status": {"allocatable": {"cpu": "2", "memory": "2Gi", "pods": "10"}}},
        {"metadata": {"name": "n1"},
         "status": {"allocatable": {"cpu": "2", "memory": "2Gi", "pods": "10"}}},
    ]
    pods = [{"metadata": {"name": "p", "namespace": "default"},
             "spec": {"containers": [{"name": "c", "resources": {"requests": {"cpu": "1"}}}]}}]
    enabled = ["TaintToleration", "NodeResourcesFit"]
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=enabled), device="cpu")
    rr = replay(cw, device="cpu")
    got = decode_pod_result(rr, 0)
    assert got == _python(monkeypatch, lambda: decode_pod_result(rr, 0))
    jrr = jax_replay(jax_compile(nodes, pods, JPluginSetConfig(enabled=enabled)))
    assert got == jax_decode(jrr, 0)


def test_codec_rebuilds_from_source(tmp_path, monkeypatch):
    """A fresh checkout (no library) builds the codec from the port's own
    annotation_codec.cpp, into the build directory, never beside the
    source; a missing compiler raises instead of handing the decode to the
    Python encoder."""
    so = tmp_path / "libcodec.so"
    built = native.build_codec(so)
    assert built == so and so.exists()
    lib = ctypes.CDLL(str(built))
    for sym in ("encode_filter_result", "encode_score_result", "codec_free",
                "ctx_decode_chunk", "codec_ctx_new"):
        assert getattr(lib, sym) is not None
    assert native.library_path().parent.name == "kss_torch_native"
    assert not list(native.SOURCE.parent.glob("*.so"))
    monkeypatch.setattr(shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="not found"):
        native.build_codec(tmp_path / "other.so")


def test_a_codec_that_cannot_build_raises(monkeypatch):
    """No quiet hand-over: decode raises when the codec cannot be loaded,
    unless KSS_TPU_DISABLE_NATIVE=1 selects the Python encoder."""
    nodes, pods, cfg = baseline_config(1, scale=0.05, seed=0)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    rr = replay(cw, chunk=64, device="cpu")

    def broken():
        raise RuntimeError("building the native annotation codec failed")

    monkeypatch.setattr("kube_scheduler_simulator_tpu_torch.store.native_decode.get_lib", broken)
    with pytest.raises(RuntimeError, match="codec"):
        decode_pod_result(rr, 0)
    assert "_native_ctx" not in cw.host
    monkeypatch.setenv("KSS_TPU_DISABLE_NATIVE", "1")
    assert decode_pod_result(rr, 0)[ann.SELECTED_NODE] == rr.selected_node_name(0)


def test_encode_string_map_matches_marshal():
    """The native record encoder is byte-identical to marshal() on quotes,
    backslashes, control chars, HTML-escaped chars and unicode."""
    cases = [
        {},
        {"k": "v"},
        {"b-key": "1", "a-key": "2"},  # sorted output
        {"blob": '{"n1":{"P":"passed"}}'},
        {"nasty": 'q"uo\\te <&> \t\n\r\b\f \x01\x1f'},
        {"uni": "üñíçødé ✓ 漢"},
    ]
    for d in cases:
        fast = encode_string_map(d)
        assert fast == ann.marshal(d) == jax_marshal(d)
        assert json.loads(fast) == d


def test_history_splice_matches_full_marshal():
    """Result-history records encoded one by one and joined equal the whole
    array marshalled at once, and the JAX reflector's history bytes."""
    records = [
        {ann.SELECTED_NODE: "n1", ann.FILTER_RESULT: '{"n1":{"P":"passed"}}'},
        {ann.SELECTED_NODE: "", ann.FILTER_RESULT: '{"n1":{"P":"Insufficient cpu"}}'},
        {ann.SELECTED_NODE: "n2"},
    ]
    got = "[" + ",".join(encode_string_map(r) for r in records) + "]"
    pod = {"metadata": {"name": "p"}}
    for r in records:
        update_result_history(pod, r)
    assert got == ann.marshal(records) == pod["metadata"]["annotations"][ann.RESULT_HISTORY]
    assert json.loads(got) == records


def test_fused_decode_on_strided_host_arrays(monkeypatch):
    """The fused decoder hands raw pointers to C, so a compact chunk held in
    another memory order (here Fortran order) must be made C-contiguous,
    not walked as if it were."""
    nodes, pods, cfg = baseline_config(1, scale=0.05, seed=0)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    rr = replay(cw, chunk=64, device="cpu")
    cc = rr._compact
    for field in cc.GROUPS:
        setattr(cc, field, [np.asfortranarray(cc.host(field, ci))
                            for ci in range(len(getattr(cc, field)))])
        for x in getattr(cc, field):
            assert x.size == 0 or not x.flags["C_CONTIGUOUS"] or x.ndim < 2
    strided = [decode_pod_result(rr, i) for i in range(len(pods))]
    pure = _python(monkeypatch, lambda: [decode_pod_result(rr, i) for i in range(len(pods))])
    for i, (sa, pa) in enumerate(zip(strided, pure)):
        assert sa == pa, f"pod {i}: strided fused decode diverged"


def test_decode_chunk_into_base_offset():
    """decode_chunk_into with a chunk-local sink (base=lo) fills the same
    annotations as the whole-queue list."""
    nodes, pods, cfg = baseline_config(1, scale=0.05, seed=1)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    rr = replay(cw, chunk=4, device="cpu")
    whole: list = [None] * len(pods)
    decode_chunk_into(rr, 0, len(pods), whole)
    for lo in range(0, len(pods), 4):
        hi = min(lo + 4, len(pods))
        sink = [None] * (hi - lo)
        decode_chunk_into(rr, lo, hi, sink, base=lo)
        assert sink == whole[lo:hi]
    jrr = jax_replay(jax_compile(nodes, pods, JPluginSetConfig(enabled=list(cfg.enabled))),
                     chunk=4)
    assert whole == [jax_decode(jrr, i) for i in range(len(pods))]


def test_decode_release_batches_aligns_to_compact_chunks(monkeypatch):
    """The release-style consumer never straddles a compact chunk, calls
    on_pod in pod order and decodes every pod byte-identically to
    decode_pod_result, with the native codec and with the Python encoder."""
    nodes, pods, cfg = baseline_config(2, scale=0.06, seed=9)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    rr = replay(cw, chunk=10, device="cpu")  # chunk NOT a multiple of the 64 batch
    seen: list = []
    calls: list = []
    real_start = native_decode.decode_chunk_start

    def start(ctx, rr_, lo, hi, skip=None):
        calls.append((lo, hi))
        return real_start(ctx, rr_, lo, hi, skip)

    monkeypatch.setattr(native_decode, "decode_chunk_start", start)
    decode_release_batches(rr, 0, len(pods), on_pod=lambda i, a: seen.append((i, a)))
    assert [i for i, _ in seen] == list(range(len(pods)))
    assert all(lo // 10 == (hi - 1) // 10 for lo, hi in calls) and calls
    for i in (0, 9, 10, len(pods) - 1):
        assert seen[i][1] == decode_pod_result(rr, i)
    pure: dict = {}
    _python(monkeypatch, lambda: decode_release_batches(rr, 0, len(pods),
                                                        on_pod=pure.__setitem__))
    assert [pure[i] for i in range(len(pods))] == [a for _, a in seen]


def test_empty_active_mask_on_reused_cache_slot():
    """An empty-active-mask pod that lands on a reused FilterCache slot
    (round-robin eviction at 8 entries) emits {} and not the slot's old
    nodes."""
    nodes = make_nodes(3, seed=1)
    pods = make_pods(2, seed=2)
    cfg = PluginSetConfig(enabled=[
        "NodeUnschedulable", "NodeName", "TaintToleration", "NodeAffinity"])
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    ctx = build_context(cw)
    f = len(cw.config.filters())
    codes = np.zeros((f, cw.node_table.n), np.int32)
    # churn 8 distinct non-empty masks (fills the thread-local cache), so
    # the 9th, the empty mask, lands on a round-robin-evicted slot
    for m in range(1, 9):
        active = np.array([(m >> b) & 1 for b in range(f)], np.uint8)
        assert encode_filter(ctx, codes, active).startswith("{\"")
    assert encode_filter(ctx, codes, np.zeros(f, np.uint8)) == "{}"
    assert encode_filter(ctx, codes, np.zeros(f, np.uint8)) == "{}"
