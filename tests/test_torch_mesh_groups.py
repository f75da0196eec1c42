"""The one-card mesh's nested node slices (B12): each "nodes" shard a
group of G CTAs of the unsharded kernels' clusters.

  * `cta_slices(N, S, G)` (kernels/spec.py) against `node_slices` and
    `cluster_slices`: the slices nest in the shards, are contiguous and
    ascending, cover [0, N), equal `cluster_slices` at S = 1, and include
    ragged and empty sub-slices;
  * the same function in csrc/slices.cuh, compiled with the host
    compiler, against the Python one;
  * the plain twins (`step_chunk_sharded_plain`, `spec_eval_sharded_plain`)
    at nested slices against the JAX package's `sharded_step` replay and
    `speculative_scores` on the conftest's 8 virtual CPU devices: the
    selected nodes and the 13 annotation blobs byte for byte;
  * the decomposition's edge cases inside one shard: an argmax tie across
    a sub-slice boundary, a spread minimum only in the last sub-slice,
    and InterPodAffinity's matched_total counted once when the bound node
    lies in a shard's second CTA.

Every comparison is exact (tolerance 0).
"""

import functools
import itertools
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.parallel import mesh as jmesh
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework import replay
from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _slice_xs
from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
from kube_scheduler_simulator_tpu_torch.models import baseline_config
from kube_scheduler_simulator_tpu_torch.parallel import (make_mesh, shard_workload,
                                                         speculative_scores)
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result

CPU = "cpu"
CSRC = kspec.__file__.rsplit("/", 2)[0] + "/csrc"

# (S, G) with S x G <= 16: a mesh's shards (and S = 3, which make_mesh(6,
# dp=2) gives) as groups of G CTAs
PLANS = [(s, g) for s in (1, 2, 3, 4, 8) for g in (1, 2, 4, 8, 16) if s * g <= 16]
NODES = (1, 7, 8, 24, 40, 625, 5000)


# ------------------------------------------------ the slice function

@pytest.mark.parametrize("n", NODES)
@pytest.mark.parametrize("shards,groups", PLANS)
def test_cta_slices_nest_in_the_shards(n, shards, groups):
    got = kspec.cta_slices(n, shards, groups)
    assert len(got) == shards * groups
    # contiguous, ascending, covering [0, n)
    assert got[0][0] == 0 and got[-1][1] == n
    for (lo, hi), (lo2, _) in zip(got, got[1:]):
        assert lo <= hi == lo2
    v = -(-n // shards)
    w = max(-(-v // groups), 1)
    for r, (lo, hi) in enumerate(got):
        s = r // groups
        slo, shi = min(s * v, n), min(s * v + v, n)
        assert slo <= lo <= hi <= shi  # inside its shard
        assert hi - lo <= w
    if n % shards == 0:
        assert tuple((got[s * groups][0], got[s * groups + groups - 1][1])
                     for s in range(shards)) == kmesh.node_slices(n, shards)
    if shards == 1:
        assert got == kspec.cluster_slices(n, groups)


def test_cta_slices_take_ragged_and_empty_sub_slices():
    # config 5's 625-node shard at S = 8 over the card's plan of 16 CTAs
    assert kspec.cta_slices(5000, 8, 2)[:2] == ((0, 313), (313, 625))
    # fewer nodes a shard than CTAs: the group's last sub-slices are empty
    assert kspec.cta_slices(8, 8, 2) == tuple(
        x for s in range(8) for x in ((s, s + 1), (s + 1, s + 1)))
    assert kspec.cta_slices(40, 4, 4)[:4] == ((0, 3), (3, 6), (6, 9), (9, 10))


def test_slice_function_compiled_from_csrc_matches(tmp_path):
    """csrc/slices.cuh's slice_width and node_slice (each CTA's own slice
    in the kernels), built by the host compiler, give cta_slices' width
    and slices."""
    src = tmp_path / "slices.cpp"
    cases = [(n, s, g) for n in (0, *NODES, 4999, 13) for s, g in PLANS]
    src.write_text(
        "#define __host__\n#define __device__\n"
        '#include "slices.cuh"\n#include <cstdio>\n'
        "static const int cases[][3] = {"
        + ", ".join(f"{{{n}, {s}, {g}}}" for n, s, g in cases) + "};\n"
        "int main() {\n"
        "  for (const auto& c : cases) {\n"
        "    const int w = slice_width(c[0], c[1], c[2]);\n"
        "    for (int r = 0; r < c[1] * c[2]; ++r) {\n"
        "      const NodeSlice x = node_slice(c[0], c[1], c[2], w, r);\n"
        '      printf("%d %d %d ", w, x.lo, x.hi);\n'
        "    }\n"
        '    printf("\\n");\n'
        "  }\n"
        "}\n")
    exe = tmp_path / "slices"
    subprocess.run(["g++", "-std=c++17", "-I", CSRC, str(src), "-o", str(exe)], check=True)
    lines = subprocess.run([str(exe)], capture_output=True, text=True,
                           check=True).stdout.splitlines()
    assert len(lines) == len(cases)
    for (n, s, g), line in zip(cases, lines):
        vals = [int(v) for v in line.split()]
        assert set(vals[0::3]) == {max(-(-(-(-n // s)) // g), 1)}, (n, s, g)
        assert tuple(zip(vals[1::3], vals[2::3])) == kspec.cta_slices(n, s, g), (n, s, g)


@pytest.mark.parametrize("b,n,shards,clusters,want", [
    (512, 5000, 8, {1: 16, 2: 8}, 1),           # R = 8: every pod a cluster of 8
    (8, 5000, 8, {1: 16, 2: 8}, 2),             # R = 16 holds the contended round
    (8, 5000, 2, {1: 66, 2: 32, 4: 16, 8: 8}, 8),
    (32, 5000, 4, {1: 33, 2: 16, 4: 8}, 1),     # not resident past G = 1
    (8, 8, 8, {1: 16, 2: 8}, 1),                # R <= N
    (8, 5000, 3, {1: 44, 2: 22, 4: 11}, 4),     # R = 12 at S = 3
])
def test_eval_groups_from_the_batch(b, n, shards, clusters, want):
    """The eval's G: the largest group, R = S x G <= 16 and <= N, at which
    the launch's clusters are all resident; else 1."""
    assert kspec.eval_shards(b, n, clusters, shards) == want


@pytest.mark.parametrize("b,shards,default,light,want", [
    # config 5's 5,000 nodes: (G, the shape's clusters held at each G)
    (1, 1, (16, {16: 8}), (16, {16: 24}), False),        # one pass at 313 nodes a CTA
    (512, 1, (1, {1: 132}), (1, {1: 396}), False),       # 4 x 10 passes against 2 x 20
    (1024, 1, (1, {1: 132}), (1, {1: 396}), True),       # 2 x 512: 8 x 10 against 3 x 20
    (32, 1, (2, {2: 66}), (8, {8: 48}), True),           # G = 8 only in the light shape
    (64, 1, (2, {2: 66}), (4, {4: 99}), False),          # 2 x 32: 5 passes either way
    (512, 8, (1, {1: 16}), (1, {1: 48}), True),          # S = 8: 32 x 2 against 11 x 3
    (128, 2, (1, {1: 66}), (1, {1: 198}), False),        # S = 2: 2 x 5 against 1 x 10
    (8, 8, (1, {1: 16}), (2, {2: 24}), False),           # the contended round: a tie
])
def test_eval_light_past_the_resident_clusters(b, shards, default, light, want):
    """The light CTA shape, for every eval launch: where its waves of
    resident clusters times passes over a CTA's slice are fewer than the
    default shape's, each at its own G."""
    assert kspec.eval_light(b, 5000, shards, default, light) == want


def test_eval_cost_counts_waves_and_passes():
    assert kspec.eval_cost(512, 5000, 1, 1, {1: 132}, False) == 4 * 10
    assert kspec.eval_cost(512, 5000, 1, 1, {1: 396}, True) == 2 * 20
    assert kspec.eval_cost(8, 6, 1, 16, {16: 8}, False) == 1   # one node a CTA: 32 threads
    assert kspec.eval_cost(8, 5000, 1, 16, {}, False) == float("inf")


def test_wrappers_refuse_a_group_past_the_cluster():
    nodes, pods, cfg = baseline_config(5, scale=0.01, seed=0)
    cw = shard_workload(compile_workload(nodes[:16], pods[:2], cfg, device=CPU),
                        make_mesh(8, device=CPU))
    step = build_step(cw)
    xs = _slice_xs(cw.xs, 0, 2, 2)
    xs["is_pad"] = torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="cluster holds"):
        kmesh.step_chunk_sharded(step, _clone_carry(cw.init_carry), xs, _groups=4)
    with pytest.raises(ValueError, match="cluster holds"):
        kmesh.spec_eval_sharded(step, cw.init_carry, xs, _groups=4)
    assert kmesh.groups_of(step, None) == 2 and kmesh.groups_of(step, 1) == 1


# ------------------------------------------------ the twins against JAX

def _config5():
    """Config 5 cut to 40 nodes (shards of 20, 10 and 5: ragged
    sub-slices) and 24 pods."""
    nodes, pods, cfg = baseline_config(5, scale=0.01, seed=0)
    return nodes[:40], pods[:24], cfg


@functools.cache
def _jax_side(shards: int):
    """The JAX package's sharded replay and batched scores on its 8-device
    CPU mesh with a "nodes" extent of `shards`."""
    nodes, pods, cfg = _config5()
    mesh = jmesh.make_mesh(8, dp=8 // shards)
    jcw = jax_compile(nodes, pods, JCfg(enabled=cfg.enabled))
    jrr = jax_replay(jcw, chunk=8, mesh=mesh)
    scw = jmesh.shard_workload(jcw, mesh)
    jxs = dict(scw.xs)
    jxs["is_pad"] = jnp.zeros((scw.n_pods,), dtype=bool)
    scores = jmesh.speculative_scores(scw)(scw.init_carry, jxs)
    return jrr, {f: np.asarray(getattr(scores, f)) for f in scores._fields}


@pytest.mark.parametrize("shards,groups",
                         [(s, g) for s, g in itertools.product((2, 4, 8), (1, 2, 4))
                          if s * g <= 16])
def test_twins_at_nested_slices_match_jax(monkeypatch, shards, groups):
    """replay(cw, mesh=) (step_chunk_sharded_plain) and speculative_scores
    (spec_eval_sharded_plain) with each shard a group of `groups` CTAs
    == the JAX package's sharded_step replay and speculative_scores."""
    monkeypatch.setattr(kmesh, "groups_of", lambda step, g: g or groups)
    nodes, pods, cfg = _config5()
    cw = compile_workload(nodes, pods, cfg, device=CPU)
    mesh = make_mesh(8, dp=8 // shards, device=CPU)
    assert mesh.shape["nodes"] == shards
    jrr, jscores = _jax_side(shards)
    rr = replay(cw, chunk=8, device=CPU, mesh=mesh)
    np.testing.assert_array_equal(rr.selected, np.asarray(jrr.selected))
    np.testing.assert_array_equal(rr.feasible_count, np.asarray(jrr.feasible_count))
    for i in range(cw.n_pods):
        got, want = decode_pod_result(rr, i), jax_decode(jrr, i)
        for key in ALL_PLUGIN_KEYS:
            assert got[key] == want[key], f"pod {i} {key}"
    xs = dict(cw.xs)
    xs["is_pad"] = torch.zeros(cw.n_pods, dtype=torch.bool)
    outs = speculative_scores(cw, mesh)(cw.init_carry, xs)
    for f in outs._fields:
        np.testing.assert_array_equal(getattr(outs, f).numpy(), jscores[f], err_msg=f)


# ------------------------------------------------ inside one shard

def _node(name, cpu="4", labels=None, taints=None):
    n = {"metadata": {"name": name, "labels": {"kubernetes.io/hostname": name,
                                                **(labels or {})}},
         "status": {"allocatable": {"cpu": cpu, "memory": "8Gi", "pods": "110"}},
         "spec": {}}
    if taints:
        n["spec"]["taints"] = taints
    return n


def _pod(name, labels=None, spec=None):
    return {"metadata": {"name": name, "namespace": "default", "labels": labels or {}},
            "spec": {"containers": [{"name": "c", "resources": {"requests": {
                "cpu": "100m", "memory": "128Mi"}}}], **(spec or {})}}


def _chunk_both(cw, shards, groups):
    """The whole queue as one chunk through the unsharded plain step and
    the twin at `groups` CTAs a shard -> ((carry, out), (carry, out))."""
    kw = dict(out_mode="compact", pack_mode="p16",
              score_dtypes=tuple("i16" for _ in cw.config.scorers()))
    step = build_step(cw, **kw)
    sstep = build_step(shard_workload(cw, make_mesh(shards, device=CPU)), **kw)
    xs = _slice_xs(cw.xs, 0, cw.n_pods, cw.n_pods)
    xs["is_pad"] = torch.zeros(cw.n_pods, dtype=torch.bool)
    base = step.plain_scan(_clone_carry(cw.init_carry), xs)
    return base, kmesh.step_chunk_sharded_plain(sstep, _clone_carry(cw.init_carry), xs, groups)


def _assert_same_chunk(base, sharded):
    (c0, o0), (c1, o1) = base, sharded
    for f in o0._fields:
        a, b = getattr(o0, f), getattr(o1, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert torch.equal(a.to(torch.int64), b.to(torch.int64)), f
    assert list(c0) == list(c1)
    for k in c0:
        x, y = c0[k], c1[k]
        for a, b in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            assert torch.equal(a, b), k


def _assert_same_as_jax(nodes, pods, shards, groups, monkeypatch, **kw):
    monkeypatch.setattr(kmesh, "groups_of", lambda step, g: g or groups)
    cw = compile_workload(nodes, pods, PluginSetConfig(), device=CPU, **kw)
    rr = replay(cw, chunk=len(pods), device=CPU, mesh=make_mesh(shards, device=CPU))
    jrr = jax_replay(jax_compile(nodes, pods, JCfg(), **kw), chunk=len(pods),
                     mesh=jmesh.make_mesh(8, dp=8 // shards))
    np.testing.assert_array_equal(rr.selected, np.asarray(jrr.selected))
    for i in range(len(pods)):
        got, want = decode_pod_result(rr, i), jax_decode(jrr, i)
        for key in ALL_PLUGIN_KEYS:
            assert got[key] == want[key], f"pod {i} {key}"
    return rr


def test_argmax_tie_across_a_sub_slice_boundary(monkeypatch):
    """16 nodes, S = 2, G = 4: shard 0's CTAs own [0, 2), [2, 4), [4, 6),
    [6, 8).  Nodes 3 and 4 score equal best, on either side of a boundary
    inside shard 0; the combine keeps the lower index, node 3."""
    nodes = [_node(f"n{i}", cpu="4" if i in (3, 4) else "1") for i in range(16)]
    cw = compile_workload(nodes, [_pod("p0")], PluginSetConfig(), device=CPU)
    assert kspec.cta_slices(16, 2, 4)[1:3] == ((2, 4), (4, 6))
    base, sharded = _chunk_both(cw, 2, 4)
    assert int(base[1].selected[0]) == 3
    _assert_same_chunk(base, sharded)
    rr = _assert_same_as_jax(nodes, [_pod("p0")], 2, 4, monkeypatch)
    assert int(rr.selected[0]) == 3


def _spread_pod(name):
    return _pod(name, labels={"app": "web"}, spec={"topologySpreadConstraints": [{
        "maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
        "whenUnsatisfiable": "DoNotSchedule",
        "labelSelector": {"matchLabels": {"app": "web"}}}]})


@pytest.mark.parametrize("groups", [2, 4])
def test_spread_minimum_only_in_the_last_sub_slice(monkeypatch, groups):
    """Hostname spread over 8 nodes, S = 2: nodes 0-6 hold a matching pod,
    node 7 none, so the minimum 0 lies only in the last CTA of the last
    shard.  A CTA-local minimum would pass the other nodes (skew 1); the
    combined one fails them (skew 2)."""
    nodes = [_node(f"n{i}") for i in range(8)]
    bound = [(_spread_pod(f"b{i}"), f"n{i}") for i in range(7)]
    cw = compile_workload(nodes, [_spread_pod("p0")], PluginSetConfig(), bound_pods=bound,
                          device=CPU)
    assert kspec.cta_slices(8, 2, groups)[-1][1] == 8
    base, sharded = _chunk_both(cw, 2, groups)
    assert int(base[1].selected[0]) == 7 and int(base[1].feasible_count[0]) == 1
    _assert_same_chunk(base, sharded)
    rr = _assert_same_as_jax(nodes, [_spread_pod("p0")], 2, groups, monkeypatch,
                             bound_pods=bound)
    assert int(rr.selected[0]) == 7


def _ip_pod(name):
    term = {"labelSelector": {"matchLabels": {"app": "db"}}, "topologyKey": "zone"}
    return _pod(name, labels={"app": "db"}, spec={"affinity": {
        "podAffinity": {"preferredDuringSchedulingIgnoredDuringExecution": [
            {"weight": 10, "podAffinityTerm": term}]},
        "podAntiAffinity": {"requiredDuringSchedulingIgnoredDuringExecution": [
            {**term, "topologyKey": "kubernetes.io/hostname"}]}}})


def test_matched_total_counted_once_in_a_second_cta(monkeypatch):
    """8 nodes, S = 2, G = 2: CTAs own [0, 2), [2, 4), [4, 6), [6, 8).
    Only nodes 2, 3, 6 and 7 (each shard's second CTA) are untainted; four
    pods that match their own terms bind there, one a node.  The carry's
    matched_total counts each bind once, as the unsharded step does."""
    taint = [{"key": "dedicated", "value": "x", "effect": "NoSchedule"}]
    nodes = [_node(f"n{i}", labels={"zone": f"z{i % 2}"},
                   taints=None if i in (2, 3, 6, 7) else taint) for i in range(8)]
    pods = [_ip_pod(f"p{i}") for i in range(4)]
    cw = compile_workload(nodes, pods, PluginSetConfig(), device=CPU)
    base, sharded = _chunk_both(cw, 2, 2)
    _assert_same_chunk(base, sharded)
    sel = sorted(int(s) for s in sharded[1].selected)
    assert sel == [2, 3, 6, 7]
    total = sharded[0]["InterPodAffinity"].matched_total
    assert int(total.sum()) == 4 * int(cw.xs["InterPodAffinity"].t_matches[0].sum()) > 0
    _assert_same_as_jax(nodes, pods, 2, 2, monkeypatch)
