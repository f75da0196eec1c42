"""The port's mesh across processes (B12c: parallel/distributed.py
initialize_distributed, global_devices; parallel/mesh.py make_mesh over
them; kernels/mesh.py with each process holding its own card) on the CPU,
in spawned processes, against the JAX package's mesh on the conftest's 8
virtual CPU devices and the port's card mesh on virtual cards in one
process.  The mirrors across hosts run the same cases with each process
posing as one of two hosts (`initialize_distributed(_host=...)`): the
processes of a mesh across hosts take the same twins, whose combines go
through the process group, which crosses hosts.

Each case spawns 2 or 4 processes (parallel/distributed.py _spawn: gloo
over a TCPStore that the parent holds at a port the OS chose, `torch.set_num_threads(1)`
in each worker) with a deadline of its own, past which its workers print
their tracebacks and are killed.  The workers' bodies live in
tests/torch_mesh_procs_workers.py, which imports the port alone: each
worker reports whether JAX was imported in it, and none may be.  On the
CPU the twins run, each combine's partials folded across the processes
through the process group.  Every comparison is exact: selected nodes,
feasible counts, PreFilter rejects, the 13 annotations of every pod, the
engine's binds and annotations, the twins' carries and outputs; and
every process returns the same result.
"""

import copy
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import torch_mesh_procs_workers as workers
from kube_scheduler_simulator_tpu.cluster.store import ObjectStore as JObjectStore
from kube_scheduler_simulator_tpu.framework.engine import SchedulerEngine as JEngine
from kube_scheduler_simulator_tpu.framework.replay import replay as jax_replay
from kube_scheduler_simulator_tpu.models import baseline_config as jbaseline
from kube_scheduler_simulator_tpu.parallel import mesh as jmesh
from kube_scheduler_simulator_tpu.parallel import speculative as jspec
from kube_scheduler_simulator_tpu.state.compile import compile_workload as jax_compile
from kube_scheduler_simulator_tpu.store.decode import decode_pod_result as jax_decode
from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _slice_xs
from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
from kube_scheduler_simulator_tpu_torch.parallel import (
    CrossHostMeshError, global_devices, make_mesh, process_count, process_index, shard_workload)
from kube_scheduler_simulator_tpu_torch.parallel.distributed import _spawn
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import ALL_PLUGIN_KEYS

NODES, PODS, CHUNK = 16, 24, 5  # a chunk of 5: its outputs sit at unaligned bytes of the gather
DEADLINE_S = 90.0  # a spawned case, its workers' start included


def _spawned(fn, n: int, args: tuple):
    """The spawned case, its workers running while the caller computes its
    reference in this process: a future of _spawn's results."""
    pool = ThreadPoolExecutor(1)
    fut = pool.submit(_spawn, fn, n, args, deadline_s=DEADLINE_S)
    pool.shutdown(wait=False)
    return fut


def _jax_config5(n_nodes=NODES, n_pods=PODS):
    nodes, pods, cfg = jbaseline(5, scale=0.004, seed=0)
    return nodes[:n_nodes], pods[:n_pods], cfg


def _same_everywhere(results: list) -> dict:
    """Every process returned the same result, and none imported JAX."""
    assert not any(r.pop("jax") for r in results), "a worker imported JAX"
    for r in results[1:]:
        assert r == results[0]
    return results[0]


def _assert_same_as_jax(got: dict, jrr) -> None:
    np.testing.assert_array_equal(got["selected"], np.asarray(jrr.selected))
    np.testing.assert_array_equal(got["feasible"], np.asarray(jrr.feasible_count))
    np.testing.assert_array_equal(got["reject"], np.asarray(jrr.prefilter_reject))
    for i, ann in enumerate(got["annotations"]):
        want = jax_decode(jrr, i)
        assert sorted(ann) == sorted(ALL_PLUGIN_KEYS)
        for key in ALL_PLUGIN_KEYS:
            assert ann[key] == want[key], f"pod {i} {key}: process mesh vs JAX"


@pytest.mark.parametrize("n,dp", [(2, 1), (4, 2)], ids=["p2-dp1", "p4-dp2"])
def test_replay_over_processes_matches_jax(n, dp):
    """replay(cw, mesh=process mesh) in every process == the JAX replay over
    its 8-device mesh at the same dp, every pod and all 13 annotations."""
    fut = _spawned(workers.replay_worker, n, (n, dp, NODES, PODS, CHUNK))
    jn, jp, jcfg = _jax_config5()
    jrr = jax_replay(jax_compile(jn, jp, jcfg), chunk=CHUNK, mesh=jmesh.make_mesh(8, dp=dp))
    _assert_same_as_jax(_same_everywhere(fut.result()), jrr)


@pytest.mark.parametrize("n,dp", [(2, 1), (4, 2)], ids=["p2-hosts2-dp1", "p4-hosts2-dp2"])
def test_replay_across_hosts_matches_jax(n, dp):
    """replay() over processes on two hosts (2 x 1, and 2 x 2 processes) in
    every process == the JAX replay over its 8-device mesh at the same dp,
    every pod and all 13 annotations."""
    fut = _spawned(workers.replay_worker, n, (n, dp, NODES, PODS, CHUNK, 2))
    jn, jp, jcfg = _jax_config5()
    jrr = jax_replay(jax_compile(jn, jp, jcfg), chunk=CHUNK, mesh=jmesh.make_mesh(8, dp=dp))
    _assert_same_as_jax(_same_everywhere(fut.result()), jrr)


def test_stream_across_hosts_matches_jax():
    """replay_speculative_stream over 2 x 2 processes on two hosts == the
    JAX stream over its 8-device mesh at dp 2, every process alike."""
    fut = _spawned(workers.stream_worker, 4, (4, 2, NODES, PODS, CHUNK, 2))
    jn, jp, jcfg = _jax_config5()
    jrr, _ = jspec.replay_speculative_stream(jax_compile(jn, jp, jcfg),
                                             jmesh.make_mesh(8, dp=2), chunk=CHUNK, pods=jp)
    got = _same_everywhere(fut.result())
    assert got["n_rounds"] > 1
    _assert_same_as_jax(got, jrr)


def test_engine_wave_across_hosts_matches_jax(monkeypatch):
    """One engine wave (the default, speculative wave) over 2 processes on
    two hosts == the unsharded JAX engine: the same binds, nodes and
    annotations in every process."""
    fut = _spawned(workers.engine_worker, 2, (2, NODES, 12, "1", 2))
    monkeypatch.setenv("KSS_TPU_SPECULATIVE", "1")
    jn, jp, jcfg = _jax_config5(n_pods=12)
    store = JObjectStore()
    for o in jn:
        store.create("nodes", copy.deepcopy(o))
    for o in jp:
        store.create("pods", copy.deepcopy(o))
    bound = JEngine(store, plugin_config=jcfg).schedule_pending()
    got = _same_everywhere(fut.result())
    assert got["bound"] == bound
    for p in jp:
        cur = store.get("pods", p["metadata"]["name"])
        name = p["metadata"]["name"]
        assert got["placements"][name] == (cur["spec"].get("nodeName") or "")
        assert got["annotations"][name] == dict(cur["metadata"].get("annotations") or {})


def test_stream_over_processes_matches_jax():
    """replay_speculative_stream over 2 x 2 processes (config 5: dense
    rounds, the interaction rule's cuts, the general commit on every card)
    == the JAX stream over its 8-device mesh at dp 2; every process took
    the same rounds, the same accepted K and the same fallback (each runs
    the oracle over the same joined outputs)."""
    fut = _spawned(workers.stream_worker, 4, (4, 2, NODES, PODS, CHUNK))
    jn, jp, jcfg = _jax_config5()
    jrr, _ = jspec.replay_speculative_stream(jax_compile(jn, jp, jcfg),
                                             jmesh.make_mesh(8, dp=2), chunk=CHUNK, pods=jp)
    got = _same_everywhere(fut.result())
    assert got["n_rounds"] > 1
    _assert_same_as_jax(got, jrr)


@pytest.mark.parametrize("spec", ["1", "0"], ids=["wave", "scan"])
def test_engine_wave_over_processes_matches_jax(spec, monkeypatch):
    """One engine wave over 2 processes, each over a store with the same
    objects: every process binds the same pods to the same nodes with the
    same annotations as the unsharded JAX engine."""
    fut = _spawned(workers.engine_worker, 2, (2, NODES, 12, spec))
    monkeypatch.setenv("KSS_TPU_SPECULATIVE", spec)
    jn, jp, jcfg = _jax_config5(n_pods=12)
    store = JObjectStore()
    for o in jn:
        store.create("nodes", copy.deepcopy(o))
    for o in jp:
        store.create("pods", copy.deepcopy(o))
    bound = JEngine(store, plugin_config=jcfg).schedule_pending()
    got = _same_everywhere(fut.result())
    assert got["bound"] == bound
    for p in jp:
        cur = store.get("pods", p["metadata"]["name"])
        name = p["metadata"]["name"]
        assert got["placements"][name] == (cur["spec"].get("nodeName") or "")
        assert got["annotations"][name] == dict(cur["metadata"].get("annotations") or {})


def _leaves(tree):
    return [t.numpy() for t in workers._leaves(tree)]


@pytest.mark.parametrize("n,dp", [(2, 1), (4, 2)], ids=["p2-dp1", "p4-dp2"])
def test_twins_across_processes_match_virtual_cards(n, dp):
    """The twins' decomposition across processes: each process's partials
    folded in card order through the process group give what the twins
    give on n virtual cards in one process: every card's carry after the
    step and after the batch's commit, and the joined outputs of the step
    and the batched eval; and gather_to_host over the process mesh joins
    the first row's node shards of the spread counts."""
    fut = _spawned(workers.twin_worker, n, (n, dp, NODES, 16))
    nodes, pods, cfg = workers.config5(NODES, 16)
    cw = shard_workload(compile_workload(nodes, pods, cfg, device="cpu"),
                        make_mesh(n, dp=dp, device="cpu", _virtual=True))
    step = build_step(cw)
    xs = _slice_xs(cw.xs, 0, 16, 16)
    xs["is_pad"] = torch.zeros(16, dtype=torch.bool)
    carry, out = kmesh.step_chunk_cards_plain(step, _clone_carry(cw.init_carry), xs)
    ev = kmesh.spec_eval_cards_plain(step, cw.init_carry, xs)
    committed = kmesh.spec_commit_cards_plain(step, _clone_carry(cw.init_carry), xs,
                                              ev.selected, 8)
    res = fut.result()
    assert not any(r["jax"] for r in res), "a worker imported JAX"
    spread = np.concatenate([carry[k]["PodTopologySpread"].numpy()
                             for k in range(n // dp)], axis=-1)
    for k, r in enumerate(res):
        np.testing.assert_array_equal(r["spread"], spread, err_msg=f"process {k} gather")
        for what, want in (("carry", _leaves(carry[k])), ("out", _leaves(tuple(out))),
                           ("eval", _leaves(tuple(ev))), ("commit", _leaves(committed[k]))):
            assert len(r[what]) == len(want)
            for a, b in zip(r[what], want):
                np.testing.assert_array_equal(a, b, err_msg=f"process {k} {what}")


@pytest.mark.parametrize("case,error", [
    ("twice", "RuntimeError: initialize_distributed: already initialized"),
    ("relay", "CrossHostMeshError: a mesh across hosts: process 1 on host-1 could not reach "
              "the relay of process 0 on host-0 at 127.0.0.1:1"),
    ("num_processes", "ValueError: initialize_distributed: num_processes"),
    ("partial_mesh", "ValueError: a process mesh over"),
])
def test_process_mesh_refusals(case, error):
    """A second initialize_distributed; a mesh across two hosts (faked
    host tags) whose process 0 published a relay address where nothing
    listens, which every process names with the process, its host and
    the address; processes that disagree on num_processes; a mesh that
    leaves a process out: each raises in every process."""
    got = _spawn(workers.errors_worker, 2, (case,), deadline_s=DEADLINE_S)
    assert all(g.startswith(error) for g in got), got


def test_global_devices_before_initialization():
    assert (process_index(), process_count()) == (0, 1)
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        global_devices()
    assert issubclass(CrossHostMeshError, ConnectionError)


def test_process_zero_holds_the_store(monkeypatch):
    """Without a launcher's store (TORCHELASTIC_USE_AGENT_STORE unset),
    process 0 holds the coordinator's store itself: a mesh of this one
    process, its store at a port the OS chooses."""
    from kube_scheduler_simulator_tpu_torch.parallel import distributed

    monkeypatch.delenv("TORCHELASTIC_USE_AGENT_STORE", raising=False)
    distributed.initialize_distributed("127.0.0.1:0", 1, 0, device="cpu")
    try:
        assert (process_index(), process_count()) == (0, 1)
        (card,) = global_devices()
        assert (card.process, card.device, card.uuid) == (0, torch.device("cpu"), None)
        assert make_mesh(1, device=global_devices()).procs == (0,)
    finally:
        distributed.shutdown_distributed()
    with pytest.raises(RuntimeError, match="initialize_distributed"):
        global_devices()
