"""The split of the two table kernels, on the CPU, at a small size.

The sparse round's kernel (csrc/spec_round.cu) gives each CTA a group of
P pods of one session over one node pass, with each pod's feasibility as
32-node words and its candidates placed by rank; `round_grouped_plain`
computes that split in plain PyTorch.  Here it is held, at every P, to
`sparse_round_plain` and to the JAX package's `_sparse_round_fn` on
fleets of 6, 37 and 300 nodes, with pad rows in the batch; the rule that
picks P (`round_pods`) and the eval kernel's choice of S over a launch's
K x B clusters (`eval_shards`) are checked on their own; a fused round
refuses members whose CTA state differs (their volume widths); and the
fused dense eval over K sessions equals K solo `eval_plain` calls, its
per-slice split (`eval_sliced_plain`) at the S of the K x B clusters
included.  The kernels themselves run only on a card
(tests/test_torch_kernel.py).
"""

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
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
from kube_scheduler_simulator_tpu_torch.framework.replay import (_clone_carry, _compact_plan,
                                                                 _slice_xs)
from kube_scheduler_simulator_tpu_torch.kernels import fuse as kfuse
from kube_scheduler_simulator_tpu_torch.kernels import spec as kspec
from kube_scheduler_simulator_tpu_torch.models import baseline_config
from kube_scheduler_simulator_tpu_torch.models import workloads as pwl
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.state.convert import from_numpy_workload

NODE_LOCAL = ["NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
              "TaintToleration"]
NAMES = ("packed", "reject", "counts", "raw8", "raw16", "raw32", "ovf", "selected")
# (nodes, candidate cap): the cap at N on the smallest fleet, below the
# widest feasibility on the others
FLEETS = {6: 6, 37: 5, 300: 128}
BATCH = 16


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same(a, b, what):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype, f"{what}: {a.dtype} vs {b.dtype}"
    assert a.shape == b.shape, f"{what}: {a.shape} vs {b.shape}"
    assert np.array_equal(a, b), f"{what} differs"


def _fleet(m, n):
    """n nodes, some tainted: slot-pinned pods (two feasible nodes) around
    broad ones (feasible nearly everywhere)."""
    nodes, pinned = m.make_slot_pinned_workload(24, n, seed=n)
    tainted = m.make_nodes(n, seed=n + 1, taint_fraction=0.3)
    for node, t in zip(nodes, tainted):
        if t["spec"].get("taints"):
            node["spec"]["taints"] = t["spec"]["taints"]
    broad = m.make_pods(10, seed=n + 2, with_affinity=True, with_tolerations=True)
    return nodes, pinned[:8] + broad + pinned[8:]


def _random_carry(jcw, seed):
    """A seeded random core carry shaped like jcw.init_carry, as numpy:
    usage up to 95 % of allocatable and up to 120 pods a node."""
    rng = np.random.default_rng(seed)
    core = jcw.init_carry["core"]
    alloc = np.asarray(jcw.statics["core"].allocatable)
    req = (rng.random(alloc.shape) * 0.95 * alloc).astype(np.int64)
    nz = np.asarray(core.nonzero)
    return {"core": type(core)(requested=req, nonzero=req[:, :nz.shape[1]].copy(),
                               num_pods=rng.integers(0, 121, np.shape(core.num_pods)))}


_CASES = {}


def _case(n):
    """-> (step, carry, xs, kcand, the JAX round's outputs) for the fleet
    of n nodes: the batch's last rows are pads, past the queue's end."""
    if n not in _CASES:
        nodes, pods = _fleet(pwl, n)
        jnodes, jpods = _fleet(jwl, n)
        cw = compile_workload(nodes, pods, PluginSetConfig(enabled=NODE_LOCAL), device="cpu")
        jcw = jax_compile(jnodes, jpods, JPluginSetConfig(enabled=NODE_LOCAL))
        carry_np = _random_carry(jcw, n)
        carry = from_numpy_workload({}, {}, carry_np)[2]
        lo = cw.n_pods - BATCH + 5
        xs = _slice_xs(cw.xs, lo, cw.n_pods, BATCH)
        xs["is_pad"] = torch.arange(BATCH) >= cw.n_pods - lo
        jxs = jax_slice_xs(jcw.xs, lo, cw.n_pods, BATCH)
        jxs["is_pad"] = jnp.arange(BATCH) >= cw.n_pods - lo
        pm, sd, _ = _compact_plan(cw, None)
        assert (pm, sd) == jax_compact_plan(jcw, None)[:2]
        step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
        kcand = FLEETS[n]
        fn = jspec._sparse_round_fn(jcw, _workload_scan_key(jcw, BATCH), BATCH, pm, sd, None,
                                    kcand)
        want = fn(jax.tree.map(jnp.asarray, carry_np), jxs)
        _CASES[n] = (step, carry, xs, kcand, want)
    return _CASES[n]


@pytest.mark.parametrize("pods", kspec.ROUND_PODS)
@pytest.mark.parametrize("n", list(FLEETS))
def test_round_grouped_plain_matches_sparse_round_and_jax(n, pods):
    step, carry, xs, kcand, want = _case(n)
    got = kspec.round_grouped_plain(step, carry, xs, kcand, pods)
    plain = kspec.sparse_round_plain(step, carry, xs, kcand)
    for name, a, p, w in zip(NAMES, got, plain, want):
        assert_same(a, p, f"{name} vs sparse_round_plain")
        assert_same(a, w, f"{name} vs JAX")
    pad = _np(xs["is_pad"])
    assert pad.any() and (_np(got[7])[pad] == -1).all()
    counts = _np(got[2])
    assert counts.max() > min(kcand, n - 1) or kcand == n  # rows with more feasible nodes than slots


def test_round_grouped_plain_refuses_other_group_sizes():
    step, carry, xs, kcand, _ = _case(6)
    with pytest.raises(ValueError, match="pods a group"):
        kspec.round_grouped_plain(step, carry, xs, kcand, 3)


@pytest.mark.parametrize("k,b,resident,want", [
    (1, 512, {1: 4, 2: 4, 4: 4, 8: 4}, 1),        # P = 2: 256 CTAs < half of 4 x 132
    (2, 512, {1: 4, 2: 4, 4: 4, 8: 4}, 2),        # P = 2: 512 >= 264
    (4, 512, {1: 4, 2: 4, 4: 4, 8: 4}, 2),        # groups of 4 and 8 are never planned
    (16, 512, {1: 1, 2: 1, 4: 1, 8: 1}, 2),
    (1, 512, {1: 2, 2: 2, 4: 2, 8: 2}, 2),        # 256 >= 132
    (1, 512, {1: 4, 2: 0, 4: 0, 8: 0}, 1),        # P = 2's state does not fit: no room
    (2, 8, {1: 4, 2: 4, 4: 4, 8: 4}, 1),          # a small batch keeps one pod a CTA
])
def test_round_pods_rule(k, b, resident, want):
    assert kspec.round_pods(k, b, resident, 132) == want


@pytest.mark.parametrize("k,b,want", [(1, 8, 8), (2, 8, 8), (2, 512, 1), (4, 512, 1),
                                      (1, 1, 16), (4, 2, 8), (16, 1, 8)])
def test_eval_shards_counts_every_session_of_the_launch(k, b, want):
    # clusters of S CTAs the card holds at once (one CTA an SM, 132 SMs,
    # clusters of 16 only where a GPC holds them)
    clusters_at = {1: 132, 2: 66, 4: 32, 8: 16, 16: 7}
    assert kspec.eval_shards(k * b, 5000, clusters_at) == want


def _volume_members(extra_pv):
    """Two dense members of the default profile over one decorated fleet;
    the second's volumes hold `extra_pv` more unbound PVs."""
    import copy

    import chip_smoke

    out = []
    for extra in (0, extra_pv):
        nodes, pods, _ = baseline_config(5, scale=0.002, seed=0)
        volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=0)
        for i in range(extra):
            pv = copy.deepcopy(volumes["pvs"][0])
            pv["metadata"]["name"] += f"-extra-{i}"
            pv["spec"].pop("claimRef", None)
            volumes["pvs"].append(pv)
        cw = compile_workload(nodes, pods, PluginSetConfig(), volumes=volumes, bound_pods=bound,
                              device="cpu")
        pm, sd, _ = _compact_plan(cw, None)
        step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
        xs = _slice_xs(cw.xs, 0, 4, 4)
        xs["is_pad"] = torch.zeros(4, dtype=torch.bool)
        out.append(kfuse.Member(step, _clone_carry(cw.init_carry), xs))
    return out


def test_fused_eval_refuses_members_of_different_volume_widths(monkeypatch):
    same = _volume_members(0)
    assert kfuse.state_shape(same[0].step) == kfuse.state_shape(same[1].step)
    outs = kfuse.spec_eval_fused(same)
    for m, o in zip(same, outs):
        want = kspec.eval_plain(m.step, m.carry, m.xs)
        for f in o._fields:
            assert_same(getattr(o, f), getattr(want, f), f)
    wider = _volume_members(3)
    assert kfuse.state_shape(wider[0].step)[2] + 3 == kfuse.state_shape(wider[1].step)[2]
    with pytest.raises(ValueError, match="PVs"):
        kfuse.spec_eval_fused(wider)
    # the state's bytes are all that differ between the two
    monkeypatch.setattr(kfuse, "state_shape", lambda step: ())
    kfuse.spec_eval_fused(wider)


@pytest.mark.parametrize("k", [2, 4])
def test_fused_eval_equals_solo_eval_plain_at_the_sessions_cluster_size(k):
    """K config-5 sessions, each its own batch against its own carry: the
    fused dense eval on the CPU and the eval kernel's split at the S the
    plan takes for the launch's K x B clusters each equal the member's
    solo eval_plain."""
    nodes, pods, cfg = baseline_config(5, scale=0.004, seed=0)
    cw = compile_workload(nodes, pods, cfg, device="cpu")
    pm, sd, _ = _compact_plan(cw, None)
    step = build_step(cw, out_mode="compact", pack_mode=pm, score_dtypes=sd)
    b = 4
    members = []
    for s in range(k):
        carry = _clone_carry(cw.init_carry)
        xs0 = _slice_xs(cw.xs, 0, 8 * (s + 1), 8 * (s + 1))
        xs0["is_pad"] = torch.zeros(8 * (s + 1), dtype=torch.bool)
        carry = kspec.commit_plain(step, carry, xs0, kspec.eval_plain(step, carry, xs0).selected,
                                   8 * (s + 1))
        xs = _slice_xs(cw.xs, 8 * (s + 1), 8 * (s + 1) + b, b)
        xs["is_pad"] = torch.zeros(b, dtype=torch.bool)
        members.append(kfuse.Member(step, carry, xs))
    shards = kspec.eval_shards(k * b, cw.n_nodes, {1: 132, 2: 66, 4: 32, 8: 16, 16: 7})
    assert shards == (16 if k * b <= 7 else 8)
    fused = kfuse.spec_eval_fused(members)
    for m, got in zip(members, fused):
        want = kspec.eval_plain(step, m.carry, m.xs)
        sliced = kspec.eval_sliced_plain(step, m.carry, m.xs, shards)
        for f in want._fields:
            assert_same(getattr(got, f), getattr(want, f), f)
            assert_same(getattr(sliced, f), getattr(want, f), f"sliced {f}")
