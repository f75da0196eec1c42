"""B7, the per-chunk attribution, and the attribution a replay reports,
against the JAX package.

* `chunk_attribution_plain` against the JAX function it ports,
  framework/replay.py `_build_att_fn`, on seeded random chunks: the pack
  modes p8, p16 and p32, the narrow and the i32 raw tiers, padded tails,
  PreFilter and score skips, with and without the feasibility bitmap.
  Every count, every per-pod score sum (the JAX limb triples recombined)
  and every bitmap byte is equal.
* Under p64 and in the i64 tier the port follows the JAX package's host
  tally (`ChunkAttribution._tally_chunk`), not its device fold, which
  casts the packed word and the raws to int32 first: the device fold
  drops every first-fail index under p64 and wraps raws past int32
  (ROADMAP Queue C).  The tests show both the port's agreement and the
  reference's divergence.
* `plugin_attribution` of the port's replay against the JAX package's on
  BASELINE configs 1-5 and the decorated default profile, under the
  device-resident default and KSS_TPU_HOST_RESIDENT=1.
"""

import contextlib
import importlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kube_scheduler_simulator_tpu.models.workloads import make_nodes as jax_make_nodes
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu_torch.framework.pipeline import PACK_MODES
from kube_scheduler_simulator_tpu_torch.framework.replay import plugin_attribution, replay
from kube_scheduler_simulator_tpu_torch.kernels.attribution import (
    chunk_attribution, chunk_attribution_plain)
from kube_scheduler_simulator_tpu_torch.models import baseline_config, make_nodes
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from test_torch_replay import _ladder_workload

jreplay = importlib.import_module("kube_scheduler_simulator_tpu.framework.replay")

C, N = 24, 37   # N not a multiple of 8: the bitmap's padded tail


@contextlib.contextmanager
def env(**values):
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


def random_chunk(seed: int, mode: str, tier: str, f: int, m: int, ncols: int = 4):
    """A chunk's compact outputs drawn with numpy: packed first-fail words
    (0 on about half the nodes), raws over each group's full range, feasible
    counts and skips, ncols device score columns.  -> (arrays dict,
    dev_cols)."""
    rng = np.random.default_rng(seed)
    dtype, code_bits, _ = PACK_MODES[mode]
    ffp = np.where(rng.random((C, N)) < 0.5, 0, rng.integers(1, f + 1, (C, N)))
    code = np.where(ffp > 0, rng.integers(1, 1 << min(code_bits, 20), (C, N)), 0)
    packed = (ffp.astype(np.int64) << code_bits) | code
    np_dtype = {torch.uint8: np.uint8, torch.uint16: np.uint16, torch.int32: np.int32,
                torch.int64: np.int64}[dtype]
    cycle = {"narrow": ("raw8", "raw16", "raw32", "raw16"), "i32": ("raw32",) * 4}[tier]
    groups = tuple(cycle[k % 4] for k in range(ncols))
    counts = {g: groups.count(g) for g in ("raw8", "raw16", "raw32")}
    seen = {"raw8": 0, "raw16": 0, "raw32": 0}
    dev_cols = []
    for s, g in enumerate(groups):
        dev_cols.append((s, g, seen[g]))
        seen[g] += 1
    s_total = len(groups) + 1  # one more scorer: a host column
    arrays = {
        "packed": packed.astype(np_dtype),
        "raw8": rng.integers(-128, 128, (C, counts["raw8"], N)).astype(np.int8),
        "raw16": rng.integers(-(1 << 15), 1 << 15, (C, counts["raw16"], N)).astype(np.int16),
        "raw32": rng.integers(-(1 << 31), 1 << 31, (C, counts["raw32"], N)).astype(np.int32),
        "fc": rng.integers(0, 4, C).astype(np.int32),
        "fskip": np.concatenate([rng.random((f, m)) < 0.3, np.ones((f, C - m), bool)], 1),
        "sskip": np.concatenate([rng.random((s_total, m)) < 0.3,
                                 np.ones((s_total, C - m), bool)], 1),
    }
    return arrays, tuple(dev_cols)


def port_att(arrays, m, code_bits, dev_cols, want_pack, fn=chunk_attribution_plain):
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}
    out = fn(t["packed"], t["raw8"], t["raw16"], t["raw32"], t["fc"], t["fskip"], t["sskip"],
             m, code_bits, dev_cols, want_pack)
    return {k: v.numpy() for k, v in out.items()}


def jax_att(arrays, m, code_bits, dev_cols, want_pack):
    """The JAX function's outputs in the port's layout: per-pod int64 score
    sums, the limb triples recombined."""
    f = arrays["fskip"].shape[0]
    fn = jreplay._att_fn_for(C, N, code_bits, f, dev_cols, want_pack)
    j = fn(*[jnp.asarray(arrays[k]) for k in ("packed", "raw8", "raw16", "raw32", "fc",
                                               "fskip", "sskip")], np.int32(m))
    j = {k: np.asarray(v) for k, v in j.items()}
    out = {}
    if f:
        out["f_rejects"] = j["f_rejects"].astype(np.int64)
        out["f_evaluated"] = j["f_evaluated"].astype(np.int64)
    if dev_cols:
        cols, qn, qw = [], 0, 0
        for _s, g, _r in dev_cols:
            if jreplay._col_needs_limbs(g, N):
                lb = j["s_limbs"][:, qw].astype(np.int64)
                cols.append((lb[:, 2] << 22) + (lb[:, 1] << 11) + lb[:, 0])
                qw += 1
            else:
                cols.append(j["s_sums"][:, qn].astype(np.int64))
                qn += 1
        out["s_sums"] = np.stack(cols, 1)
        out["s_evaluated"] = j["s_evaluated"].astype(np.int64)
    if want_pack:
        out["feas_packed"] = j["feas_packed"]
    return out


def assert_same(got: dict, want: dict, what: str) -> None:
    assert sorted(got) == sorted(want), what
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, f"{what}: {k}"
        assert np.array_equal(got[k], want[k]), f"{what}: {k}\n{got[k]}\n{want[k]}"


@pytest.mark.parametrize("tier", ["narrow", "i32"])
@pytest.mark.parametrize("mode", ["p8", "p16", "p32"])
def test_plain_matches_jax_att_fn(mode, tier):
    f = 7 if mode == "p8" else 12
    code_bits = PACK_MODES[mode][1]
    for seed, m, want_pack in ((1, C, False), (2, C - 5, True), (3, 1, True)):
        arrays, dev_cols = random_chunk(seed, mode, tier, f, m)
        got = port_att(arrays, m, code_bits, dev_cols, want_pack)
        assert_same(got, jax_att(arrays, m, code_bits, dev_cols, want_pack),
                    f"{mode} {tier} seed {seed}")


@pytest.mark.parametrize("tier", ["narrow", "i32"])
@pytest.mark.parametrize("mode", ["p8", "p16", "p32"])
def test_plain_matches_jax_att_fn_at_the_kernel_limits(mode, tier):
    """F = 16 filters and Q = 8 device score columns, the most B7's kernel
    takes (kernels/attribution.py MAX_F, MAX_Q), with pad rows and the
    bitmap, and with every row a pad row (m = 0)."""
    code_bits = PACK_MODES[mode][1]
    for seed, m, want_pack in ((7, C - 4, True), (8, 0, True), (9, C, False)):
        arrays, dev_cols = random_chunk(seed, mode, tier, 16, m, ncols=8)
        assert len(dev_cols) == 8 and arrays["fskip"].shape[0] == 16
        got = port_att(arrays, m, code_bits, dev_cols, want_pack)
        assert_same(got, jax_att(arrays, m, code_bits, dev_cols, want_pack),
                    f"{mode} {tier} seed {seed} F=16 Q=8")
        if m == 0:
            assert not got["f_rejects"].any() and not got["s_sums"].any()


def test_plain_without_filters_or_device_columns():
    """No filter plugin, only a host score column: the bitmap alone."""
    arrays, _ = random_chunk(4, "p16", "narrow", 3, C - 2)
    arrays["fskip"] = arrays["fskip"][:0]
    got = port_att(arrays, C - 2, PACK_MODES["p16"][1], (), True)
    assert_same(got, jax_att(arrays, C - 2, PACK_MODES["p16"][1], (), True), "bitmap only")


def test_wrapper_on_cpu_is_the_plain_version():
    arrays, dev_cols = random_chunk(5, "p32", "narrow", 9, C - 3)
    before = chunk_attribution.launches
    got = port_att(arrays, C - 3, 16, dev_cols, True, fn=chunk_attribution)
    assert_same(got, port_att(arrays, C - 3, 16, dev_cols, True), "wrapper")
    assert chunk_attribution.launches == before  # no kernel launch on the CPU


def test_jax_att_fn_drops_p64_first_fail():
    """The reference fault: under p64 the JAX function casts the packed
    word to int32 before the shift, so every node reads as feasible."""
    arrays, dev_cols = random_chunk(6, "p64", "i32", 12, C)
    code_bits = PACK_MODES["p64"][1]
    got = port_att(arrays, C, code_bits, dev_cols, False)
    ref = jax_att(arrays, C, code_bits, dev_cols, False)
    assert got["f_rejects"].sum() > 0
    assert ref["f_rejects"].sum() == 0
    # the port's counts are the host tally's: a numpy histogram of the
    # full words
    ffp = arrays["packed"].astype(np.int64) >> code_bits
    assert np.array_equal(got["f_rejects"], [(ffp == k + 1).sum() for k in range(12)])


# ------------------------------------------------------------ replays

def _p64_fleet(nodes, pods):
    """16 extended resources on every node, one of them requested by a third
    of the pods: NodeResourcesFit's code needs 20 bits, so the pack is p64."""
    rng = np.random.default_rng(0)
    for nd in nodes:
        for j in range(16):
            nd["status"]["allocatable"][f"example.com/dev-{j}"] = str(int(rng.integers(0, 4)))
    for k, p in enumerate(pods):
        if k % 3 == 0:
            p["spec"]["containers"][0]["resources"].setdefault("requests", {})[
                f"example.com/dev-{int(rng.integers(16))}"] = "2"


def _workload(name: str):
    """-> (nodes, pods, port config, JAX config, volumes, bound pods)."""
    if name.startswith("config"):
        idx, scale = {"config1": (1, 1.0), "config2": (2, 0.1), "config3": (3, 0.02),
                      "config4": (4, 0.01), "config5": (5, 0.01)}[name]
        nodes, pods, cfg = baseline_config(idx, scale=scale, seed=0)
        return nodes, pods, cfg, JPluginSetConfig(enabled=list(cfg.enabled)), None, None
    if name == "default_profile":
        nodes, pods, _ = baseline_config(5, scale=0.02, seed=0)
        volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=0)
        return nodes, pods, PluginSetConfig(), JPluginSetConfig(), volumes, bound
    if name == "p64":
        nodes, pods, cfg = baseline_config(5, scale=0.01, seed=0)
        _p64_fleet(nodes, pods)
        return nodes, pods, cfg, JPluginSetConfig(enabled=list(cfg.enabled)), None, None
    assert name == "i64"
    nodes, pods, cfg, bound = _ladder_workload(make_nodes, PluginSetConfig, 1 << 30)
    _, _, jcfg, _ = _ladder_workload(jax_make_nodes, JPluginSetConfig, 1 << 30)
    return nodes, pods, cfg, jcfg, None, bound


def _attributions(name: str, rung: str, chunk: int):
    """(port, JAX device fold or None, JAX host tally) of one workload; the
    port's under `rung`."""
    nodes, pods, cfg, jcfg, volumes, bound = _workload(name)
    cw = compile_workload(nodes, pods, cfg, volumes=volumes, bound_pods=bound, device="cpu")
    jcw = jax_compile(nodes, pods, jcfg, volumes=volumes, bound_pods=bound)
    with env(KSS_TPU_HOST_RESIDENT="1" if rung == "host" else None):
        rr = replay(cw, chunk=chunk, device="cpu")
        port = plugin_attribution(rr)
    assert all(rr._compact.is_device(ci) == (rung == "device")
               for ci in range(len(rr._compact.packed)))
    with env(KSS_TPU_HOST_RESIDENT="1"):
        host = jreplay.plugin_attribution(jreplay.replay(jcw, chunk=chunk))
    with env(KSS_TPU_HOST_RESIDENT=None):
        jrr = jreplay.replay(jcw, chunk=chunk)
        assert any(a is not None for a in jrr._compact.att)  # the device fold ran
        dev = jreplay.plugin_attribution(jrr)
    return port, dev, host, rr


@pytest.mark.parametrize("rung", ["device", "host"])
@pytest.mark.parametrize("name", ["config1", "config2", "config3", "config4", "config5",
                                  "default_profile"])
def test_plugin_attribution_matches_jax(name, rung):
    port, dev, host, rr = _attributions(name, rung, chunk=32)
    assert port is not None and port["filter"]
    assert port == host == dev
    if rung == "device":
        assert all(rr._compact.att[ci] is not None for ci in range(len(rr._compact.packed)))
        assert rr._compact.materialized == 0  # the fold fetched no chunk


@pytest.mark.parametrize("name", ["p64", "i64"])
def test_port_follows_the_host_tally_where_the_jax_fold_diverges(name):
    port, dev, host, rr = _attributions(name, "device", chunk=8)
    if name == "p64":
        assert rr._compact.pack_mode == "p64"
        assert sum(v["rejects"] for v in host["filter"].values()) > 0
    else:
        assert rr.tiers[-1] == "i64"
    assert port == host
    assert dev != host  # the reference's device fold (ROADMAP Queue C)
