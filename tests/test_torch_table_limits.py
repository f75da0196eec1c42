"""Workloads past the card's fixed table sizes, in the port on the CPU.

StepArgs keeps the step's tables in fixed arrays (16 filters, 16
scorers, 8 custom plugins with rows, 8 resources a strategy, 16 shape
points; csrc/common.cuh); past any of them kernels/step.py `make_args`
puts every table in one int64 array on the device (`StepArgs.ext`).  A
pod with more than 8 unbound claims takes VolumeBinding's wide walk, and
B7 takes its wide form past 16 filters or 8 device score columns and its
opt-in shared or device-memory bitmap past 48 KB.  Here:

  * each over-limit workload of chip_smoke.py phase 30 (`table_case`),
    at 96 nodes x 32 pods, through the port's replay and the JAX
    replay: selected nodes and every annotation equal (tolerance 0);
  * `make_args` on the CPU tensors of each case takes the over-limit
    path (the device array's values, the wide VolumeBinding count)
    where it used to raise, and takes 300 claims a pod, past what a
    thread's own mask array holds, with no bound left;
  * the 300-claim case (`claims300`) through the port's replay and the
    JAX replay at 60 nodes x 8 pods, byte for byte;
  * `att_shape` and `att_path` choose B7's wide form and bitmap place,
    and B7's plain version at F = 20 and Q = 10 equals the JAX
    `_build_att_fn`.

The kernels themselves are held to these plain versions on the card
(tests/test_torch_kernel.py `-k table_limits`, chip_smoke.py phase 30).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.plugins import custom as jcustom
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JCfg
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework import pipeline as ppipeline
from kube_scheduler_simulator_tpu_torch.framework.pipeline import PACK_MODES
from kube_scheduler_simulator_tpu_torch.framework.replay import _compact_plan, _slice_xs, replay
from kube_scheduler_simulator_tpu_torch.kernels import attribution as katt
from kube_scheduler_simulator_tpu_torch.kernels import step as kstep
from kube_scheduler_simulator_tpu_torch.plugins import custom as pcustom
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS, decode_pod_result
from test_torch_attribution import assert_same, jax_att, port_att, random_chunk

NODES, PODS, SEED = 96, 32, 11


def _port(kind: str):
    nodes, pods, cfg, volumes, bound = chip_smoke.table_case(
        kind, NODES, PODS, SEED, PluginSetConfig, pcustom.CustomPlugin)
    return compile_workload(nodes, pods, cfg, volumes=volumes, bound_pods=bound, device="cpu")


def _jax(kind: str):
    nodes, pods, cfg, volumes, bound = chip_smoke.table_case(
        kind, NODES, PODS, SEED, JCfg, jcustom.CustomPlugin)
    return jax_compile(nodes, pods, cfg, volumes=volumes, bound_pods=bound)


def _step(cw):
    pack_mode, score_dtypes, _ = _compact_plan(cw, None)
    return ppipeline.build_step(cw, out_mode="compact", pack_mode=pack_mode,
                                score_dtypes=score_dtypes)


def _chunk(cw, c: int) -> dict:
    xs = _slice_xs(cw.xs, 0, min(c, cw.n_pods), c)
    xs["is_pad"] = torch.arange(c) >= min(c, cw.n_pods)
    return xs


@pytest.mark.parametrize("kind", chip_smoke.TABLE_CASES)
def test_replay_past_the_fixed_tables_matches_jax(kind):
    """The port's replay of each over-limit case == the JAX replay, pod by
    pod: the selected node and all annotations, byte for byte."""
    cw, jcw = _port(kind), _jax(kind)
    rr = replay(cw, chunk=16, device="cpu")
    jrr = jax_replay(jcw, chunk=16)
    np.testing.assert_array_equal(rr.selected, np.asarray(jrr.selected))
    np.testing.assert_array_equal(rr.feasible_count, np.asarray(jrr.feasible_count))
    for i in range(cw.n_pods):
        got, want = decode_pod_result(rr, i), jax_decode(jrr, i)
        for key in ALL_PLUGIN_KEYS:
            assert got[key] == want[key], f"{kind} pod {i} {key}"
    assert rr.scheduled > 0, kind


@pytest.mark.parametrize("kind", chip_smoke.TABLE_CASES)
def test_make_args_takes_the_over_limit_path(kind):
    """make_args on the case's CPU tensors no longer raises: the tables go
    to StepArgs.ext in csrc/common.cuh's layout (the claims case keeps
    the fixed arrays and takes the wide VolumeBinding walk, VK > 8)."""
    cw = _port(kind)
    step = _step(cw)
    xs = _chunk(cw, 8)
    args = kstep.make_args(step, cw.init_carry, xs, None)
    tables = kstep.step_tables(step, xs, 8, cw.n_nodes)
    assert (args.F, args.S) == (len(step.filter_names), len(step.score_names))
    if kind == "claims12":
        assert kstep.tables_fit(tables) and not args.ext
        assert kstep.MAX_VBK < args.VK <= 12
        return
    assert not kstep.tables_fit(tables)
    assert args.ext == args.ext_tensor.data_ptr()
    vals = args.ext_tensor.tolist()
    assert vals == kstep.ext_values(tables)
    f, s = args.F, args.S
    assert vals[:f] == [kstep.custom_ids(step).get(n, kstep.PLUGIN_IDS.get(n))
                        for n in step.filter_names]
    assert vals[f + s:f + 2 * s] == step.weights
    want = {"filters17": (17, 8), "custom9": (14, 6), "scores17": (12, 17),
            "rtcr10": (5, 6), "balanced10": (5, 6)}[kind]
    assert (f, s) == want
    assert (args.fit_nres, args.fit_nshape, args.bal_nres) == {
        "rtcr10": (10, 20, 2), "balanced10": (2, 0, 10)}.get(kind, (2, 0, 2))
    assert args.fit_type == (2 if kind == "rtcr10" else 0)


def test_make_args_refuses_past_the_claim_bound():
    """The card's last count bound is gone: make_args takes a pod with 300
    unbound claims (past csrc/common.cuh KSS_VB_WORDS words of 64 slots,
    what a thread's own mask array holds) and leaves StepArgs.vb_masks to
    the launch's wrapper, which allocates the bytes its plan gives; there
    is no MAX_VBK_WIDE to refuse past."""
    nodes, pods, cfg, volumes, bound = chip_smoke.table_case(
        "claims300", 48, 4, SEED, PluginSetConfig, pcustom.CustomPlugin)
    cw = compile_workload(nodes, pods, cfg, volumes=volumes, bound_pods=bound, device="cpu")
    step = _step(cw)
    assert not hasattr(kstep, "MAX_VBK_WIDE")
    args = kstep.make_args(step, cw.init_carry, _chunk(cw, 4), None)
    assert args.VK == 300 > 4 * 64
    assert not args.vb_masks and not args.ext


def test_replay_with_300_claims_a_pod_matches_jax():
    """claims300 (every pod 300 unbound claims: the wide walk's masks past
    a thread's own array on the card) through the port's replay and the
    JAX replay: selected nodes, feasible counts and every annotation equal,
    and some pod binds with its PVs claimed."""
    shape = (60, 8, chip_smoke.SEED)
    nodes, pods, cfg, volumes, bound = chip_smoke.table_case(
        "claims300", *shape, PluginSetConfig, pcustom.CustomPlugin)
    cw = compile_workload(nodes, pods, cfg, volumes=volumes, bound_pods=bound, device="cpu")
    jn, jp, jc, jv, jb = chip_smoke.table_case("claims300", *shape, JCfg, jcustom.CustomPlugin)
    jcw = jax_compile(jn, jp, jc, volumes=jv, bound_pods=jb)
    assert cw.xs["VolumeBinding"].active.shape[1] == 300
    rr = replay(cw, chunk=4, device="cpu")
    jrr = jax_replay(jcw, chunk=4)
    np.testing.assert_array_equal(rr.selected, np.asarray(jrr.selected))
    np.testing.assert_array_equal(rr.feasible_count, np.asarray(jrr.feasible_count))
    for i in range(cw.n_pods):
        got, want = decode_pod_result(rr, i), jax_decode(jrr, i)
        for key in ALL_PLUGIN_KEYS:
            assert got[key] == want[key], f"claims300 pod {i} {key}"
    assert rr.scheduled > 0


@pytest.mark.parametrize("args,shape,path", [
    ((8, 5000, 17, 3), (4, 1), ("shared", True)),        # F = 17: the wide form
    ((512, 5000, 6, 9), (4, 1), ("shared", True)),       # Q = 9
    ((512, 5000, 16, 8), (4, 1), ("shared", False)),     # the fixed form's limits
    ((8, 400_000, 12, 8), (8, 1), ("optin", False)),     # a 50 KB bitmap
    ((8, 393_216, 12, 8), (8, 1), ("shared", False)),    # exactly 48 KB
    ((8, 1_843_200, 12, 8), (8, 1), ("optin", False)),   # exactly ATT_SMEM_MAX
    ((8, 1_843_201, 12, 8), (8, 1), ("device", False)),
    ((8, 2_000_000, 12, 8), (8, 1), ("device", False)),
    ((8, 2_000_000, 20, 10), (8, 1), ("device", True)),
])
def test_att_shape_and_path_past_the_limits(args, shape, path):
    c, n, f, q = args
    assert katt.att_shape(c, n, f, q) == shape
    assert katt.att_path(n, shape[1], f, q) == path


@pytest.mark.parametrize("mode", ["p16", "p32"])
def test_att_plain_past_the_limits_matches_jax(mode):
    """B7's plain version (what the wide form is held to) at F = 20
    filters and Q = 10 device score columns == the JAX function."""
    code_bits = PACK_MODES[mode][1]
    for seed, m, want_pack in ((21, 20, True), (22, 24, False)):
        arrays, dev_cols = random_chunk(seed, mode, "narrow", 20, m, ncols=10)
        assert len(dev_cols) == 10 and arrays["fskip"].shape[0] == 20
        got = port_att(arrays, m, code_bits, dev_cols, want_pack)
        assert_same(got, jax_att(arrays, m, code_bits, dev_cols, want_pack),
                    f"{mode} seed {seed} F=20 Q=10")
        assert got["f_rejects"][16:].sum() > 0
