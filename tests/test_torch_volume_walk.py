"""The NodeVolumeLimits and VolumeBinding walks against the JAX package.

The port's plain versions (plugins/nodevolumelimits.py filter_kernel,
plugins/volumebinding.py _greedy_choices) follow the kernel's walk and
count (csrc/volumes.cuh): per pod, its own volumes compacted, `existing`
a per-(node, driver) count, and its candidate PVs (unclaimed, wanted by
an active slot) in (capacity, index) order, the first one allowed at a
node and not taken by an earlier slot chosen.  The JAX package takes a
per-driver matrix product and a per-slot argmin over every PV instead.
Each case below runs one chunk of pods, filter then bind pod after pod,
through both, from inputs made with numpy, and every filter row and every
carry must be byte-equal; then the decorated default-profile fleet at
small size goes through replay() against the JAX replay.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.plugins import nodevolumelimits as jnvl
from kube_scheduler_simulator_tpu.plugins import volumebinding as jvb
from kube_scheduler_simulator_tpu.plugins.registry import PluginSetConfig as JPluginSetConfig
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework import replay
from kube_scheduler_simulator_tpu_torch.models import baseline_config
from kube_scheduler_simulator_tpu_torch.plugins import nodevolumelimits as tnvl
from kube_scheduler_simulator_tpu_torch.plugins import volumebinding as tvb
from kube_scheduler_simulator_tpu_torch.plugins.registry import PluginSetConfig
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import decode_pod_result


def _both(mod_j, mod_t, cls: str, **arrays):
    """One NamedTuple of the JAX plugin and the port's, from numpy arrays."""
    return (getattr(mod_j, cls)(**{k: jnp.asarray(v) for k, v in arrays.items()}),
            getattr(mod_t, cls)(**{k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}))


def _same(j, t, what):
    a, b = np.asarray(j), t.numpy()
    assert a.dtype == b.dtype and a.shape == b.shape, what
    assert a.tobytes() == b.tobytes(), f"{what}\nJAX  {a}\nport {b}"


# ------------------------------------------------------------ VolumeBinding

def _vb_chunk(cap, node_ok, pods, claimed, selected):
    """Pods (want [K, V], active [K], provision_ok [K, N]) filtered and
    bound in turn at `selected` through both plugins -> the port's filter
    rows and claims after each pod."""
    n = node_ok.shape[1]
    js, ts = _both(jvb, tvb, "BindingStatic", pv_cap=np.asarray(cap, np.int64),
                   pv_node_ok=np.asarray(node_ok, bool))
    jc, tc = _both(jvb, tvb, "BindingCarry", claimed=np.asarray(claimed, bool))
    rows, claims = [], []
    for i, ((want, active, prov), sel) in enumerate(zip(pods, selected, strict=True)):
        jx, tx = _both(jvb, tvb, "BindingXS", bound_code=np.zeros(n, np.int32),
                       want=np.asarray(want, bool), active=np.asarray(active, bool),
                       provision_ok=np.asarray(prov, bool), filter_skip=np.asarray(False))
        jrow, trow = jvb.filter_kernel(js, jx, jc), tvb.filter_kernel(ts, tx, tc)
        _same(jrow, trow, f"pod {i}: filter")
        jc = jvb.bind_update(js, jx, jc, jnp.asarray(sel, jnp.int32))
        tc = tvb.bind_update(ts, tx, tc, torch.tensor(sel, dtype=torch.int32))
        _same(jc.claimed, tc.claimed, f"pod {i}: claimed after its bind at {sel}")
        rows.append(trow.numpy())
        claims.append(tc.claimed.numpy().copy())
    return rows, claims


def test_equal_capacity_goes_to_the_lower_index():
    # PVs 1 and 2 tie at the least capacity; 0 is larger
    rows, claims = _vb_chunk(cap=[2, 1, 1], node_ok=np.ones((3, 2), bool),
                             pods=[([[1, 1, 1]], [1], [[0, 0]])], claimed=[0, 0, 0],
                             selected=[1])
    assert (rows[0] == 0).all()
    assert claims[0].tolist() == [False, True, False]


def test_a_pv_an_earlier_slot_picked_is_taken():
    # both slots want PVs 0 and 1 (equal capacity): slot 0 takes 0, slot 1
    # must take 1; node 1 allows only PV 0, so slot 1 finds nothing there
    node_ok = np.array([[1, 1], [1, 0]], bool)
    rows, claims = _vb_chunk(cap=[1, 1], node_ok=node_ok,
                             pods=[([[1, 1], [1, 1]], [1, 1], [[0, 0], [0, 0]])],
                             claimed=[0, 0], selected=[0])
    assert rows[0].tolist() == [0, jvb.CODE_BIND_CONFLICT]
    assert claims[0].tolist() == [True, True]


def test_a_pv_an_earlier_pod_of_the_chunk_claimed_is_skipped():
    # pod 0 claims the small PV 0 at node 0; pod 1 wants 0 and 2 and gets
    # 2; pod 2 wants only 0 and fails everywhere but where it provisions
    pods = [([[1, 0, 0]], [1], [[0, 0, 0]]),
            ([[1, 0, 1]], [1], [[0, 0, 0]]),
            ([[1, 0, 0]], [1], [[0, 0, 1]])]
    rows, claims = _vb_chunk(cap=[1, 5, 3], node_ok=np.ones((3, 3), bool), pods=pods,
                             claimed=[0, 0, 0], selected=[0, 1, 2])
    assert claims[1].tolist() == [True, False, True]
    assert rows[2].tolist() == [jvb.CODE_BIND_CONFLICT] * 2 + [0]


def test_a_pod_with_no_claims_binds_nothing():
    rows, claims = _vb_chunk(cap=[1, 2], node_ok=np.ones((2, 3), bool),
                             pods=[(np.zeros((1, 2)), [0], np.zeros((1, 3))),
                                   (np.zeros((0, 2)), np.zeros(0), np.zeros((0, 3)))],
                             claimed=[0, 1], selected=[0, 2])
    assert all((r == 0).all() for r in rows)
    assert claims[-1].tolist() == [False, True]


@pytest.mark.parametrize("seed", [3, 17, 29])
def test_random_chunks_of_claims(seed):
    # capacities from a small range (many ties), sparse allowed nodes,
    # up to three slots, some PVs claimed already, rows that bind nothing
    rng = np.random.default_rng(seed)
    v, n, k = 14, 9, 3
    cap = rng.integers(1, 4, v)
    node_ok = rng.random((v, n)) < 0.45
    pods = [(rng.random((k, v)) < 0.5, rng.random(k) < 0.8, rng.random((k, n)) < 0.2)
            for _ in range(10)]
    selected = [int(s) if rng.random() < 0.8 else -1 for s in rng.integers(0, n, 10)]
    _vb_chunk(cap, node_ok, pods, claimed=rng.random(v) < 0.2, selected=selected)


# ------------------------------------------------------------ NodeVolumeLimits

def _nvl_chunk(onehot, limits, on_node, pods, selected):
    """Pods (pod_vols [VC]) filtered and bound in turn through both
    plugins -> the port's filter rows."""
    js, ts = _both(jnvl, tnvl, "LimitsStatic", driver_onehot=np.asarray(onehot, bool),
                   limits=np.asarray(limits, np.int64))
    jc, tc = _both(jnvl, tnvl, "LimitsCarry", on_node=np.asarray(on_node, bool))
    rows = []
    for i, (vols, sel) in enumerate(zip(pods, selected, strict=True)):
        jx, tx = _both(jnvl, tnvl, "LimitsXS", pod_vols=np.asarray(vols, bool),
                       filter_skip=np.asarray(False))
        jrow, trow = jnvl.filter_kernel(js, jx, jc), tnvl.filter_kernel(ts, tx, tc)
        _same(jrow, trow, f"pod {i}: filter")
        jc = jnvl.bind_update(jx, jc, jnp.asarray(sel, jnp.int32))
        tc = tnvl.bind_update(tx, tc, torch.tensor(sel, dtype=torch.int32))
        _same(jc.on_node, tc.on_node, f"pod {i}: on_node after its bind at {sel}")
        rows.append(trow.numpy())
    return rows


def test_a_driver_reaches_its_limit_through_binds_in_the_chunk():
    # one driver, limit 2 on both nodes; each pod brings a new volume and
    # binds at node 0: the third finds node 0 full, node 1 still open
    rows = _nvl_chunk(onehot=np.ones((4, 1), bool), limits=[[2], [2]],
                      on_node=np.zeros((2, 4), bool), pods=np.eye(4, dtype=bool)[:3],
                      selected=[0, 0, 0])
    assert [r.tolist() for r in rows] == [[0, 0], [0, 0], [1, 0]]


def test_a_volume_already_on_the_node_is_not_added():
    # node 0 already holds volumes 0 and 1 at its limit of 2, node 1 holds
    # 2 and 3: a pod with volume 0 adds nothing at node 0 and fails node 1
    on_node = np.array([[1, 1, 0, 0], [0, 0, 1, 1]], bool)
    rows = _nvl_chunk(onehot=np.ones((4, 1), bool), limits=[[2], [2]], on_node=on_node,
                      pods=[[1, 0, 0, 0]], selected=[0])
    assert rows[0].tolist() == [0, 1]


def test_a_pod_with_no_volumes_passes_a_full_node():
    on_node = np.ones((2, 3), bool)
    rows = _nvl_chunk(onehot=np.ones((3, 1), bool), limits=[[1], [-1]], on_node=on_node,
                      pods=[[0, 0, 0]], selected=[0])
    assert rows[0].tolist() == [0, 0]


@pytest.mark.parametrize("seed", [5, 13, 31])
def test_random_chunks_of_volumes(seed):
    # two drivers, limits of -1 (unlimited) to 3, nodes partly filled
    rng = np.random.default_rng(seed)
    vc, vd, n = 11, 2, 7
    onehot = np.eye(vd, dtype=bool)[rng.integers(0, vd, vc)]
    limits = rng.integers(-1, 4, (n, vd))
    pods = rng.random((10, vc)) < 0.2
    selected = [int(s) if rng.random() < 0.8 else -1 for s in rng.integers(0, n, 10)]
    _nvl_chunk(onehot, limits, rng.random((n, vc)) < 0.25, pods, selected)


# ------------------------------------------------------------ the default fleet

def test_default_profile_fleet_through_replay_matches_jax():
    """The decorated default-profile fleet (chip_smoke.decorate_default_profile)
    at 150 pods x 75 nodes, seed 5, through the port's replay() and the JAX
    replay: every selection, feasible count, PreFilter reject and the
    NodeVolumeLimits / VolumeBinding filter results equal, and the fleet
    reaches both plugins' rejections."""
    nodes, pods, _ = baseline_config(5, scale=0.015, seed=5)
    volumes, bound = chip_smoke.decorate_default_profile(nodes, pods, seed=5)
    cw = compile_workload(nodes, pods, PluginSetConfig(), volumes=volumes, bound_pods=bound,
                          device="cpu")
    rr = replay(cw, chunk=32, device="cpu")
    jrr = jax_replay(jax_compile(nodes, pods, JPluginSetConfig(), volumes=volumes,
                                 bound_pods=bound), chunk=32)
    assert (rr.selected == np.asarray(jrr.selected)).all()
    assert (rr.feasible_count == np.asarray(jrr.feasible_count)).all()
    assert (rr.prefilter_reject == np.asarray(jrr.prefilter_reject)).all()
    col = {name: k for k, name in enumerate(cw.config.filters())}
    for name in ("NodeVolumeLimits", "VolumeBinding"):
        assert (rr.filter_codes[:, col[name]] == np.asarray(jrr.filter_codes)[:, col[name]]).all()
    assert (rr.filter_codes[:, col["NodeVolumeLimits"]] != 0).any()
    assert ((rr.filter_codes[:, col["VolumeBinding"]] & 2) != 0).any()
    key = "kube-scheduler-simulator.sigs.k8s.io/filter-result"
    for i in range(0, cw.n_pods, 7):
        assert decode_pod_result(rr, i)[key] == jax_decode(jrr, i)[key], f"pod {i}"
