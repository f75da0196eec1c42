"""The evaluation kernel's split (csrc/spec_eval.cu: one pod's nodes over
a thread-block cluster of S CTAs, S chosen from the batch) in plain
PyTorch, against the unsplit plain evaluation and the JAX package's.

`kernels/spec.py eval_sliced_plain` computes what the kernel computes:
each reduction over the nodes (the spread minima, the feasible count, the
raw-overflow OR, the normalizers' min / max / any, the argmax) as a
partial per node slice [r W, (r + 1) W), W = ceil(N / S), combined in
rank order.  Held, exactly (integers and bytes: tolerance 0), to
`eval_plain` and the JAX `_eval_fn` (parallel/speculative.py:318) in the
dense round's compact layout, and to `Step.eval_plain` and the JAX
`build_phased` eval (framework/pipeline.py:446) in the host path's full
layout, at S = 1, 2, 4, 8 and 16 on fleets with ragged last slices and
with empty slices (N < S).  `eval_shards`, the choice of S, on the
ladder's rungs and on cards with room for fewer clusters.  Inputs are
made from seeds with numpy; the kernel itself is held to the same plain
versions on the card (tests/test_torch_kernel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kube_scheduler_simulator_tpu.framework import pipeline as jpipeline
from kube_scheduler_simulator_tpu.framework.replay import _compact_plan as jax_compact_plan
from kube_scheduler_simulator_tpu.framework.replay import _slice_xs as jax_slice_xs
from kube_scheduler_simulator_tpu.framework.replay import _workload_scan_key
from kube_scheduler_simulator_tpu.models import workloads as jwl
from kube_scheduler_simulator_tpu.parallel import speculative as jspec
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu_torch.framework import pipeline as ppipeline
from kube_scheduler_simulator_tpu_torch.framework.pipeline import CompactOut, build_step
from kube_scheduler_simulator_tpu_torch.framework.replay import (_clone_carry, _compact_plan,
                                                                 _slice_xs)
from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
from kube_scheduler_simulator_tpu_torch.models import workloads as pwl
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.state.convert import from_numpy_workload
from test_torch_speculative import assert_same, random_carry

BATCH = 8


def _config5(m, n_nodes):
    """Config 5's six plugins at a small scale: 60 pods on n_nodes."""
    nodes, pods, cfg = m.baseline_config(5, scale=0.006, seed=0,
                                         node_scale=(n_nodes + 0.5) / 5000)
    assert len(nodes) == n_nodes
    return nodes, pods, list(cfg.enabled)


def _slot_pinned(m):
    nodes, pods = m.make_slot_pinned_workload(64, 40, seed=0)
    return nodes, pods, list(chip_smoke.SLOT_PLUGINS)


# fleets: config 5 (30 nodes: slices of 2 at S = 16, the last empty),
# the slot-pinned fleet (40 nodes: a ragged last slice at S = 16), 6 nodes
# (N < S: empty slices from S = 8) and a ragged 37
FLEETS = {
    "config5": lambda m: _config5(m, 30),
    "slot_pinned": _slot_pinned,
    "six_nodes": lambda m: _config5(m, 6),
    "ragged37": lambda m: _config5(m, 37),
}
_CASES = {}


def compact_case(fleet):
    """A batch of BATCH pods (from pod 3) against a seeded random carry,
    for both packages -> (port step, carry, xs, JAX _eval_fn's outputs)."""
    if fleet not in _CASES:
        nodes, pods, enabled = FLEETS[fleet](pwl)
        jnodes, jpods, _ = FLEETS[fleet](jwl)
        cw = compile_workload(nodes, pods, PluginSetConfig(enabled=enabled), device="cpu")
        jcw = jax_compile(jnodes, jpods, JCfg(enabled=enabled))
        carry_np = random_carry(jcw, seed=len(fleet))
        carry = from_numpy_workload({}, {}, carry_np)[2]
        lo, hi = 3, 3 + BATCH
        xs = _slice_xs(cw.xs, lo, hi, BATCH)
        xs["is_pad"] = torch.zeros(BATCH, dtype=torch.bool)
        jxs = jax_slice_xs(jcw.xs, lo, hi, BATCH)
        jxs["is_pad"] = jnp.zeros(BATCH, dtype=bool)
        pm, sd, _ = _compact_plan(cw, None)
        assert (pm, sd) == jax_compact_plan(jcw, None)[:2]
        step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
        fn = jspec._eval_fn(jcw, _workload_scan_key(jcw, BATCH), BATCH, pm, sd, None, None)
        _CASES[fleet] = (step, carry, xs, fn(jax.tree.map(jnp.asarray, carry_np), jxs))
    return _CASES[fleet]


@pytest.mark.parametrize("shards", kspec.EVAL_SHARDS)
@pytest.mark.parametrize("fleet", list(FLEETS))
def test_sliced_eval_matches_plain_and_jax(fleet, shards):
    """The dense round's compact outputs, split over S slices, equal the
    unsplit plain evaluation's and the JAX package's, field for field."""
    step, carry, xs, jout = compact_case(fleet)
    got = kspec.eval_sliced_plain(step, carry, xs, shards)
    plain = kspec.eval_plain(step, carry, xs)
    for f in CompactOut._fields:
        assert_same(getattr(got, f), getattr(plain, f), f"{fleet} S={shards} {f} vs plain")
        assert_same(getattr(got, f), getattr(jout, f), f"{fleet} S={shards} {f} vs JAX")
    assert (got.feasible_count > 0).any() and (got.selected >= 0).any()


def _default_profile(m):
    nodes, pods, _ = m.baseline_config(5, scale=0.006, seed=3)
    volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=3)
    return nodes, pods, None, dict(volumes=volumes, bound_pods=bound)


FULL_FLEETS = {
    "default_profile": _default_profile,
    "six_nodes": lambda m: (*_config5(m, 6), {}),
}


@pytest.mark.parametrize("shards", kspec.EVAL_SHARDS)
@pytest.mark.parametrize("fleet", list(FULL_FLEETS))
def test_sliced_full_eval_matches_phased_and_jax(fleet, shards):
    """The host path's full outputs (every filter code, raw and final at
    every node), split over S slices, equal Phased.plain_eval's and the
    JAX build_phased eval's, pod after pod as the carry advances by the
    pods' binds; on the default profile the volume family included."""
    nodes, pods, enabled, extra = FULL_FLEETS[fleet](pwl)
    pcfg = PluginSetConfig(enabled=enabled) if enabled else PluginSetConfig()
    jcfg = JCfg(enabled=enabled) if enabled else JCfg()
    cw = compile_workload(nodes, pods, pcfg, device="cpu", **extra)
    jcw = jax_compile(nodes, pods, jcfg, **extra)
    phased = ppipeline.build_phased(cw)
    eval_fn, bind_fn = jpipeline.build_phased(jcw)
    carry, jcarry = _clone_carry(cw.init_carry), jcw.init_carry
    for i in range(min(cw.n_pods, 8)):
        xs1 = _slice_xs(cw.xs, i, i + 1, 1)
        xs1["is_pad"] = torch.zeros(1, dtype=torch.bool)
        sl = jax.tree.map(lambda a: a[i] if hasattr(a, "ndim") and a.ndim else a, jcw.xs)
        got = kspec.eval_sliced_plain(phased.step, carry, xs1, shards)
        want, jout = phased.plain_eval(carry, xs1), eval_fn(jcarry, sl)
        for f in want._fields:
            assert_same(getattr(got, f)[0], getattr(want, f), f"{fleet} S={shards} pod {i} {f}")
            assert_same(getattr(got, f)[0], getattr(jout, f), f"{fleet} S={shards} pod {i} {f}")
        sel = int(want.selected)
        carry = phased.bind(carry, xs1, sel)
        jcarry = bind_fn(jcarry, sl, np.int32(sel))


# clusters of S CTAs a card holds at once, as kss_eval_plan reports them:
# room for 8 clusters of 16, and a card (the H100's GPCs) with room for 7
ROOM = {1: 132, 2: 66, 4: 33, 8: 16, 16: 8}
ROOM7 = {**ROOM, 16: 7}


@pytest.mark.parametrize("b,n,clusters,want", [
    (8, 5000, ROOM, 16),        # the contended round: 8 clusters of 16
    (8, 5000, ROOM7, 8),        # only 7 clusters of 16 resident: S = 8
    (32, 5000, ROOM, 4),
    (128, 5000, ROOM, 1),
    (512, 5000, ROOM, 1),       # no S fits 512 clusters at once: one CTA a pod
    (1, 5000, ROOM, 16),        # the host path's one pod
    (1, 5000, ROOM7, 16),
    (1, 6, ROOM, 4),            # S <= N
    (8, 6, ROOM7, 4),
    (1, 1, ROOM, 1),
    (8, 5000, {}, 1),           # no room reported at any S
], ids=lambda v: str(v) if not isinstance(v, dict) else f"room{v.get(16, 0)}")
def test_eval_shards(b, n, clusters, want):
    assert kspec.eval_shards(b, n, clusters) == want


@pytest.mark.parametrize("n,shards,want", [
    (5000, 16, [(r * 313, min(r * 313 + 313, 5000)) for r in range(16)]),  # 313 and 305
    (37, 16, [(3 * r, min(3 * r + 3, 37)) for r in range(13)] + [(37, 37)] * 3),
    (6, 16, [(r, r + 1) for r in range(6)] + [(6, 6)] * 10),
    (6, 1, [(0, 6)]),
])
def test_cluster_slices_cover_the_nodes_in_order(n, shards, want):
    got = kspec.cluster_slices(n, shards)
    assert list(got) == want
    assert got[0][0] == 0 and got[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(got, got[1:]))
