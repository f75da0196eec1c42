"""B13, custom plugins' filter and score rows, in the port on the CPU.

The rows themselves (plugins/custom.py `build_custom`) and every plain
version that reads them, each against the JAX package on the same
manifests, exactly (tolerance 0):

  * `build_custom`: codes, raw scores, the message table, the host stash
    and the number of plugin calls;
  * the plain step (`Step.plain_scan`, what `step_chunk` is held to) in
    full mode and at each compact tier, against the JAX `build_step`;
  * the node-sharded twin (`step_chunk_sharded_plain`) at S = 2, 4 and 8
    against the JAX `sharded_step` on a mesh of the conftest's devices;
  * the host path's plain eval (`Phased.plain_eval`, `phased_eval`'s
    version) and a custom NormalizeScore (`renormalize`) against the JAX
    `build_phased` / `renormalize`;
  * the default profile plus one custom filter-and-scorer (13 filters, 9
    scorers) through `compile_workload` and `replay()` against the JAX
    replay's annotations;
  * the first-fail pack mode the compile picks, against the JAX
    package's, up to a plugin with 300 messages.

The carries are random: the pods bound before the queue (bound_pods) are
drawn with a numpy generator from a seed, so both packages fold the same
ones into their initial carry.  Custom raws reach past int32 and below 0.
"""

import ctypes
import subprocess
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kube_scheduler_simulator_tpu.framework import pipeline as jpipeline
from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.models.workloads import make_nodes, make_pods
from kube_scheduler_simulator_tpu.parallel import mesh as jmesh
from kube_scheduler_simulator_tpu.plugins import custom as jcustom
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework import pipeline as ppipeline
from kube_scheduler_simulator_tpu_torch.framework.pipeline import choose_pack_mode
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _slice_xs, replay
from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
from kube_scheduler_simulator_tpu_torch.models import workloads as pworkloads
from kube_scheduler_simulator_tpu_torch.parallel import make_mesh, shard_workload
from kube_scheduler_simulator_tpu_torch.plugins import custom as pcustom
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result

SIX = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
       "TaintToleration", "PodTopologySpread", "InterPodAffinity"]


def _i(obj) -> int:
    return int(obj["metadata"]["name"].rsplit("-", 1)[1])


def plugins_for(base, calls: list | None = None):
    """Custom plugins of one package (subclasses of `base`), each call
    logged into `calls` when given: {name: instance}."""

    def log(what, pod, node):
        if calls is not None:
            calls.append((what, pod["metadata"]["name"], node["metadata"]["name"]))

    class Zoned(base):
        """Filters with three messages, scores negative and positive."""

        name = "Zoned"
        default_weight = 2

        def filter(self, pod, node):
            log("Zoned.filter", pod, node)
            i, j = _i(pod), _i(node)
            return f"zone {(i * j) % 3} is closed" if (i + j) % 7 == 0 else None

        def score(self, pod, node):
            log("Zoned.score", pod, node)
            return (_i(pod) * 31 + _i(node) * 17) % 101 - 50

    class Huge(base):
        """Raw scores past int32."""

        name = "Huge"
        default_weight = 1

        def score(self, pod, node):
            log("Huge.score", pod, node)
            return (1 << 33) + _i(node) * (_i(pod) + 1)

    class RejectAll(base):
        """Rejects every node for every fifth pod."""

        name = "RejectAll"

        def filter(self, pod, node):
            log("RejectAll.filter", pod, node)
            return "no room here" if _i(pod) % 5 == 0 else None

    class Halve(base):
        """A scorer with NormalizeScore (the host path's)."""

        name = "Halve"
        default_weight = 3

        def score(self, pod, node):
            return _i(node) * 10 + _i(pod)

        def normalize(self, scores):
            return [s // 2 - 7 for s in scores]

    return {c.name: c() for c in (Zoned, Huge, RejectAll, Halve)}


def _manifests(n_nodes=48, n_pods=24, n_bound=12, seed=90):
    """(nodes, queue pods, bound pods) from the JAX package's generator;
    the bound pods and their nodes drawn from `seed`."""
    nodes = make_nodes(n_nodes, seed=seed, taint_fraction=0.25)
    pods = make_pods(n_pods + n_bound, seed=seed + 1, with_affinity=True,
                     with_tolerations=True, with_spread=True, with_interpod=True)
    rng = np.random.default_rng(seed)
    bound = [(pods[n_pods + k], nodes[int(rng.integers(n_nodes))]["metadata"]["name"])
             for k in range(n_bound)]
    return nodes, pods[:n_pods], bound


ROWS = ["Zoned", "Huge", "RejectAll"]


def _both(custom=ROWS, in_tree=SIX, **kw):
    """(port workload, JAX workload) of _manifests(**kw) with in_tree and
    the custom plugins enabled."""
    nodes, pods, bound = _manifests(**kw)
    pp, jp = plugins_for(pcustom.CustomPlugin), plugins_for(jcustom.CustomPlugin)
    cw = compile_workload(nodes, pods, PluginSetConfig(enabled=in_tree + custom,
                                                       custom={n: pp[n] for n in custom}),
                          bound_pods=bound, device="cpu")
    jcw = jax_compile(nodes, pods, JCfg(enabled=in_tree + custom,
                                        custom={n: jp[n] for n in custom}), bound_pods=bound)
    return cw, jcw


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _assert_tree_equal(got, want, what):
    for name, sub in want.items():
        ref = [sub] if not hasattr(sub, "_fields") else list(sub)
        mine = [got[name]] if not hasattr(got[name], "_fields") else list(got[name])
        for a, b in zip(mine, ref):
            assert np.array_equal(_np(a), _np(b)), f"{what} {name} differs"


def _assert_outs_equal(outs, jouts, what):
    assert type(outs).__name__ == type(jouts).__name__
    for f in jouts._fields:
        a, b = _np(getattr(outs, f)), _np(getattr(jouts, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f"{what} {f}: {a.dtype}{a.shape}"
        assert np.array_equal(a, b), f"{what} {f} differs"


# ------------------------------------------------------------ the rows

@pytest.mark.parametrize("name", ["Zoned", "Huge", "RejectAll", "Halve"])
def test_build_custom_matches_jax(name):
    nodes, pods, _ = _manifests(n_nodes=20, n_pods=15)
    pcalls, jcalls = [], []
    p, j = plugins_for(pcustom.CustomPlugin, pcalls)[name], plugins_for(jcustom.CustomPlugin,
                                                                          jcalls)[name]
    table = types.SimpleNamespace(n=len(nodes))  # what build_custom reads of the node table
    phost, jhost = {}, {}
    x, msgs = pcustom.build_custom(p, table, pods, nodes, name=name, host_out=phost,
                                   device="cpu")
    jx, jmsgs = jcustom.build_custom(j, table, pods, nodes, name=name, host_out=jhost)
    assert x.codes.dtype == torch.int32 and x.scores.dtype == torch.int64
    assert np.array_equal(x.codes.numpy(), np.asarray(jx.codes))
    assert np.array_equal(x.scores.numpy(), np.asarray(jx.scores))
    assert msgs == jmsgs
    assert phost.keys() == jhost.keys()
    if p.has_score:
        assert np.array_equal(phost["static_score_rows"][name], jhost["static_score_rows"][name])
        assert phost["static_score_rows"][name].dtype == np.int64
    # one call per (pod, node) and point, in the same order
    assert pcalls == jcalls
    if name == "Zoned":
        assert len(msgs) == 3 and x.codes.max() == 3 and (x.scores < 0).any()
    if name == "Huge":
        assert (x.scores > (1 << 32)).all()


def test_compile_holds_the_rows_and_messages_as_jax():
    cw, jcw = _both()
    for name in ROWS:
        assert np.array_equal(_np(cw.xs[name].codes), np.asarray(jcw.xs[name].codes)), name
        assert np.array_equal(_np(cw.xs[name].scores), np.asarray(jcw.xs[name].scores)), name
        assert cw.host["custom_msgs"][name] == jcw.host["custom_msgs"][name]
    assert cw.host["score_dtypes"] == jcw.host["score_dtypes"]
    assert cw.host["max_filter_code"] == jcw.host["max_filter_code"]
    assert sorted(cw.host["static_score_rows"]) == sorted(jcw.host["static_score_rows"])


def test_a_plugin_without_rows_compiles_to_nothing():
    """A custom plugin with neither filter nor score (lifecycle only) has
    no xs; the JAX package builds two rows of zeros, read by nothing."""

    class Lifecycle(pcustom.CustomPlugin):
        name = "Lifecycle"

        def reserve(self, pod, node):
            return None

    nodes, pods, _ = _manifests(n_nodes=8, n_pods=4, n_bound=0)
    cw = compile_workload(nodes, pods, PluginSetConfig(
        enabled=["NodeResourcesFit", "Lifecycle"], custom={"Lifecycle": Lifecycle()}),
        device="cpu")
    assert "Lifecycle" not in cw.xs
    assert "Lifecycle" not in cw.host.get("custom_msgs", {})


# ------------------------------------------------------------ the plain step

MODES = [("full", "p16", None), ("compact", "p16", None), ("compact", "p16", "i32"),
         ("compact", "p16", "i64")]
_JAX_RUNS = {}


def _chunk(cw, k):
    xs = _slice_xs(cw.xs, 0, k, k)
    is_pad = np.arange(k) >= k - 2  # the last two rows pad
    xs["is_pad"] = torch.from_numpy(is_pad)
    return xs, is_pad


def _jax_runs():
    """The JAX step scanned over the queue for every mode of MODES."""
    if not _JAX_RUNS:
        cw, jcw = _both()
        _, is_pad = _chunk(cw, cw.n_pods)
        jxs = dict(jcw.xs)
        jxs["is_pad"] = jnp.asarray(is_pad)
        steps = [jpipeline.build_step(jcw, out_mode=m, pack_mode=p,
                                      score_dtypes=jcw.host["score_dtypes"], wide_raw=w)
                 for m, p, w in MODES]
        runs = jax.jit(lambda c, x: [jax.lax.scan(s, c, x) for s in steps])(jcw.init_carry, jxs)
        _JAX_RUNS.update(zip(MODES, runs))
        _JAX_RUNS["cw"] = cw
    return _JAX_RUNS


@pytest.mark.parametrize("out_mode,pack_mode,wide", MODES,
                         ids=[f"{m}-{p}-{w}" for m, p, w in MODES])
def test_plain_step_matches_jax(out_mode, pack_mode, wide):
    """Step.plain_scan (step_chunk's version) with the custom rows."""
    runs = _jax_runs()
    cw = runs["cw"]
    xs, is_pad = _chunk(cw, cw.n_pods)
    step = ppipeline.build_step(cw, out_mode=out_mode, pack_mode=pack_mode,
                                score_dtypes=cw.host["score_dtypes"], wide_raw=wide)
    carry, outs = kstep.step_chunk(step, _clone_carry(cw.init_carry), xs)
    jcarry, jouts = runs[(out_mode, pack_mode, wide)]
    _assert_outs_equal(outs, jouts, f"{out_mode}-{wide}")
    _assert_tree_equal(carry, jcarry, "carry")
    sel = _np(outs.selected)
    assert (sel[is_pad] == -1).all()
    # RejectAll leaves every fifth pod no node; Zoned never lets a node
    # with (i + j) % 7 == 0 win
    for i in range(cw.n_pods - 2):
        if i % 5 == 0:
            assert sel[i] == -1 and int(outs.feasible_count[i]) == 0
        elif sel[i] >= 0:
            assert (i + int(sel[i])) % 7 != 0
    assert (sel[:-2] >= 0).any()


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_mesh_twin_matches_jax(shards):
    """step_chunk_sharded_plain with the custom rows at S shards against
    the JAX sharded_step (the conftest's 8 devices, dp = 8 / S)."""
    cw, jcw = _both()
    step = ppipeline.build_step(shard_workload(cw, make_mesh(shards, device="cpu")))
    xs, is_pad = _chunk(cw, cw.n_pods)
    carry, outs = kmesh.step_chunk_sharded(step, _clone_carry(cw.init_carry), xs)
    jmcw = jmesh.shard_workload(jcw, jmesh.make_mesh(8, dp=8 // shards))
    jstep = jmesh.sharded_step(jmcw)
    jcarry = jmcw.init_carry
    for i in range(cw.n_pods):
        sl = jax.tree.map(lambda a: a[i] if hasattr(a, "ndim") and a.ndim else a, jmcw.xs)
        sl["is_pad"] = jnp.asarray(bool(is_pad[i]))
        jcarry, jout = jstep(jcarry, sl)
        for f in jout._fields:
            assert np.array_equal(_np(getattr(outs, f))[i], np.asarray(getattr(jout, f))), \
                f"S={shards} pod {i} {f}"
    _assert_tree_equal(carry, jcarry, f"S={shards} carry")
    # and the unsharded plain step on the same chunk
    _, base = ppipeline.build_step(cw).plain_scan(_clone_carry(cw.init_carry), xs)
    _assert_outs_equal(outs, base, f"S={shards} vs unsharded")


# ------------------------------------------------------------ the host path

def test_phased_eval_and_custom_normalize_match_jax():
    """Phased.plain_eval (phased_eval's version) with the custom rows, and
    renormalize of a custom NormalizeScore on raws and feasibility a
    host hook edited, pod by pod on a carry the binds advance."""
    cw, jcw = _both(custom=ROWS + ["Halve"])
    phased = ppipeline.build_phased(cw)
    eval_fn, bind_fn = jpipeline.build_phased(jcw)
    carry, jcarry = _clone_carry(cw.init_carry), jcw.init_carry
    rng = np.random.default_rng(11)
    scorers = cw.config.scorers()
    assert "Halve" in scorers and "Zoned" in scorers and "Huge" in scorers
    for i in range(cw.n_pods):
        xs1 = _slice_xs(cw.xs, i, i + 1, 1)
        xs1["is_pad"] = torch.zeros(1, dtype=torch.bool)
        sl = jax.tree.map(lambda a: a[i] if hasattr(a, "ndim") and a.ndim else a, jcw.xs)
        out, jout = phased.plain_eval(carry, xs1), eval_fn(jcarry, sl)
        for f in out._fields:
            assert np.array_equal(_np(getattr(out, f)), np.asarray(getattr(jout, f))), \
                f"pod {i} {f}"
        feas = (np.asarray(jout.filter_codes).max(axis=0, initial=0) == 0)
        feas &= rng.random(feas.shape[0]) < 0.8
        for s, name in enumerate(scorers):
            raw = np.asarray(cw.host["static_score_rows"][name][i]
                             if name in cw.host["static_score_rows"] else jout.score_raw[s],
                             dtype=np.int64)
            raw = raw + rng.integers(-3, 4, raw.shape[0])
            want = np.asarray(jpipeline.renormalize(name, jcw, jcarry, sl, jnp.asarray(raw),
                                                    jnp.asarray(feas)), dtype=np.int64)
            got = ppipeline.renormalize(name, phased, carry, xs1, torch.from_numpy(raw),
                                        torch.from_numpy(feas))
            assert np.array_equal(got.numpy(), want), f"pod {i} {name}"
            if name == "Halve":
                idx = np.flatnonzero(feas)
                assert np.array_equal(want[idx], raw[idx] // 2 - 7)
                assert (want[~feas] == 0).all()
        sel = int(out.selected)
        carry = phased.bind(carry, xs1, sel)
        jcarry = bind_fn(jcarry, sl, np.int32(sel))
    _assert_tree_equal(carry, jcarry, "carry after the binds")


# ------------------------------------------------------------ end to end

def test_default_profile_plus_a_custom_plugin_replays_as_jax():
    """The default profile (decorated fleet) plus a custom filter-and-
    scorer: 13 filters and 9 scorers, through compile_workload and
    replay() against the JAX replay."""
    nodes, pods, _ = pworkloads.baseline_config(5, scale=0.006, seed=3)
    volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=3)
    cw = compile_workload(nodes, pods, PluginSetConfig(
        enabled=PluginSetConfig().enabled + ["Zoned"],
        custom={"Zoned": plugins_for(pcustom.CustomPlugin)["Zoned"]}),
        volumes=volumes, bound_pods=bound, device="cpu")
    jcw = jax_compile(nodes, pods, JCfg(
        enabled=JCfg().enabled + ["Zoned"],
        custom={"Zoned": plugins_for(jcustom.CustomPlugin)["Zoned"]}),
        volumes=volumes, bound_pods=bound)
    assert len(cw.config.filters()) == 13 and len(cw.config.scorers()) == 9
    assert cw.config.filters()[-1] == "Zoned" and cw.config.scorers()[-1] == "Zoned"
    kstep.make_args(ppipeline.build_step(cw), cw.init_carry, _chunk(cw, 4)[0], None)
    rr = replay(cw, chunk=16, device="cpu")
    jrr = jax_replay(jcw, chunk=16)
    np.testing.assert_array_equal(rr.selected, np.asarray(jrr.selected))
    np.testing.assert_array_equal(rr.feasible_count, np.asarray(jrr.feasible_count))
    rejected = 0
    for i in range(cw.n_pods):
        da, ja = decode_pod_result(rr, i), jax_decode(jrr, i)
        for key in ALL_PLUGIN_KEYS:
            assert da[key] == ja[key], f"pod {i} {key}: port vs JAX"
        rejected += "is closed" in da["kube-scheduler-simulator.sigs.k8s.io/filter-result"]
    assert rejected > 0 and rr.scheduled > 0


@pytest.mark.parametrize("messages", [1, 40, 300])
def test_pack_mode_matches_jax(messages):
    """The first-fail packing the replay picks with a custom filter of
    `messages` distinct messages (p16 needs codes < 256, p32 < 65536)."""

    def plugin(base):
        class Many(base):
            name = "Many"

            def filter(self, pod, node):
                k = (_i(pod) * 48 + _i(node)) % (messages + 1)
                return None if k == 0 else f"message {k}"

        return Many()

    nodes, pods, _ = _manifests(n_nodes=48, n_pods=8, n_bound=0)
    cw = compile_workload(nodes, pods, PluginSetConfig(
        enabled=SIX + ["Many"], custom={"Many": plugin(pcustom.CustomPlugin)}), device="cpu")
    jcw = jax_compile(nodes, pods, JCfg(enabled=SIX + ["Many"],
                                        custom={"Many": plugin(jcustom.CustomPlugin)}))
    assert cw.host["max_filter_code"] == jcw.host["max_filter_code"]
    n_f = len(cw.config.filters())
    mode = choose_pack_mode(cw.host["max_filter_code"], n_f)
    assert mode == jpipeline.choose_pack_mode(jcw.host["max_filter_code"], n_f)
    assert len(cw.host["custom_msgs"]["Many"]) == min(messages, 8 * 48)
    rr, jrr = replay(cw, chunk=8, device="cpu"), jax_replay(jcw, chunk=8)
    assert rr._compact.pack_mode == mode == {1: "p8", 40: "p16", 300: "p32"}[messages]
    for i in range(cw.n_pods):
        da, ja = decode_pod_result(rr, i), jax_decode(jrr, i)
        for key in ALL_PLUGIN_KEYS:
            assert da[key] == ja[key], f"pod {i} {key}"


# ------------------------------------------------------------ the argument block

def test_custom_ids_and_row_pointers():
    """make_args gives each custom plugin P_CUSTOM + its index in name
    order, in config order among the filters and scorers, and points its
    slot at the chunk's rows; past MAX_CUSTOM every table, the custom
    slots' row addresses last, goes to the device array StepArgs.ext."""
    cw, _ = _both()
    step = ppipeline.build_step(cw)
    xs, _ = _chunk(cw, 8)
    args = kstep.make_args(step, cw.init_carry, xs, None)
    ids = kstep.custom_ids(step)
    assert ids == {"Huge": kstep.P_CUSTOM, "RejectAll": kstep.P_CUSTOM + 1,
                   "Zoned": kstep.P_CUSTOM + 2}
    for k, name in enumerate(step.filter_names):
        assert args.filter_ids[k] == ids.get(name, kstep.PLUGIN_IDS.get(name))
    for k, name in enumerate(step.score_names):
        assert args.score_ids[k] == ids.get(name, kstep.PLUGIN_IDS.get(name))
    assert step.filter_names[-2:] == ["Zoned", "RejectAll"]
    for name, pid in ids.items():
        assert args.cu_codes[pid - kstep.P_CUSTOM] == xs[name].codes.data_ptr()
        assert args.cu_scores[pid - kstep.P_CUSTOM] == xs[name].scores.data_ptr()
    assert all(args.cu_codes[k] is None for k in range(len(ids), kstep.MAX_CUSTOM))
    bad = dict(xs)
    bad["Zoned"] = bad["Zoned"]._replace(codes=bad["Zoned"].codes.to(torch.int64))
    with pytest.raises(TypeError, match="Zoned.codes"):
        kstep.make_args(step, cw.init_carry, bad, None)

    many = {f"C{k}": type(f"C{k}", (pcustom.CustomPlugin,), {
        "name": f"C{k}", "score": lambda self, pod, node: 1})() for k in range(9)}
    nodes, pods, _ = _manifests(n_nodes=4, n_pods=2, n_bound=0)
    wide = compile_workload(nodes, pods, PluginSetConfig(
        enabled=["NodeResourcesFit"] + list(many), custom=many), device="cpu")
    wstep = ppipeline.build_step(wide)
    wxs = _chunk(wide, 2)[0]
    wargs = kstep.make_args(wstep, wide.init_carry, wxs, None)
    assert wargs.ext == wargs.ext_tensor.data_ptr()
    vals = wargs.ext_tensor.tolist()
    assert vals == kstep.ext_values(kstep.step_tables(wstep, wxs, 2, 4))
    assert vals[-18:] == [p for k in range(9) for p in (wxs[f"C{k}"].codes.data_ptr(),
                                                         wxs[f"C{k}"].scores.data_ptr())]


def test_step_args_layout_matches_the_c_struct(tmp_path):
    """csrc/common.cuh's StepArgs, compiled by the host compiler with the
    CUDA qualifiers stubbed, has kernels/step.py's size and offsets, and a
    table of KSS_MAX_TABLE of them passes the parameter space."""
    fields = ["cu_codes", "cu_scores", "out_codes", "ip_hard_weight", "score_weight",
              "filter_ids", "score_ids", "score_group", "score_row", "compact", "has_vb"]
    src = tmp_path / "layout.cpp"
    src.write_text(
        "#define __device__\n#define __forceinline__ inline\n"
        "struct Dim { unsigned x; }; static Dim threadIdx, blockDim;\n"
        "static const int warpSize = 32;\n"
        "template <class T> T __shfl_xor_sync(unsigned, T v, int) { return v; }\n"
        "template <class T> T __shfl_up_sync(unsigned, T v, int) { return v; }\n"
        "inline void __syncthreads() {}\n"
        '#include "common.cuh"\n#include <cstddef>\n#include <cstdio>\n'
        "int main() {\n"
        '  printf("%zu %zu\\n", sizeof(StepArgs), sizeof(StepTable<KSS_MAX_TABLE>));\n'
        + "".join(f'  printf("%zu\\n", offsetof(StepArgs, {f}));\n' for f in fields)
        + '  printf("%d %d %d %d\\n", KSS_MAX_S, KSS_MAX_F, KSS_MAX_CUSTOM, (int)P_CUSTOM);\n'
        "}\n")
    exe = tmp_path / "layout"
    csrc = kstep.__file__.rsplit("/", 2)[0] + "/csrc"
    subprocess.run(["g++", "-std=c++17", "-I", csrc, str(src), "-o", str(exe)], check=True)
    out = subprocess.run([str(exe)], capture_output=True, text=True, check=True).stdout.split()
    size, table = int(out[0]), int(out[1])
    assert size == ctypes.sizeof(kstep.StepArgs)
    assert table == 16 * size <= 32764
    for f, off in zip(fields, out[2:2 + len(fields)]):
        assert int(off) == getattr(kstep.StepArgs, f).offset, f
    assert [int(v) for v in out[-4:]] == [kstep.MAX_S, kstep.MAX_F, kstep.MAX_CUSTOM,
                                          kstep.P_CUSTOM]
