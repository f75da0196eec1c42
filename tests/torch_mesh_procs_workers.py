"""The worker bodies of tests/test_torch_mesh_procs.py and
tests/test_torch_relay.py: each runs in a spawned process of a process
mesh (parallel/distributed.py _spawn) and imports the port alone, never
JAX or the JAX package, so the process mesh is held as a user would run
it.  Each returns plain, picklable results: selected nodes, feasible
counts and the 13 annotations a pod; the relay's outcomes and counts.
A worker given `hosts` poses as one of that many hosts (the
`initialize_distributed(_host=...)` of process r is "host-{r * hosts //
n}"), so that two processes of this machine are a mesh across hosts.
"""

import copy
import ctypes
import sys
import time

import torch

from kube_scheduler_simulator_tpu_torch.cluster.store import ObjectStore
from kube_scheduler_simulator_tpu_torch.framework import replay
from kube_scheduler_simulator_tpu_torch.framework.engine import SchedulerEngine
from kube_scheduler_simulator_tpu_torch.framework.pipeline import build_step
from kube_scheduler_simulator_tpu_torch.framework.replay import _clone_carry, _slice_xs
from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
from kube_scheduler_simulator_tpu_torch.models import baseline_config
from kube_scheduler_simulator_tpu_torch.parallel import (
    global_devices, initialize_distributed, make_mesh, process_count, process_index,
    replay_speculative_stream, shard_workload)
from kube_scheduler_simulator_tpu_torch.parallel.mesh import gather_to_host
from kube_scheduler_simulator_tpu_torch.state import compile_workload
from kube_scheduler_simulator_tpu_torch.store import decode_pod_result

CPU = "cpu"


def config5(n_nodes: int, n_pods: int):
    """Config 5 (six plugins, label-coupled) cut to n_nodes x n_pods."""
    nodes, pods, cfg = baseline_config(5, scale=0.004, seed=0)
    return nodes[:n_nodes], pods[:n_pods], cfg


def _result(rr) -> dict:
    return {"selected": rr.selected.tolist(), "feasible": rr.feasible_count.tolist(),
            "reject": rr.prefilter_reject.tolist(),
            "annotations": [decode_pod_result(rr, i) for i in range(rr.cw.n_pods)],
            "jax": "jax" in sys.modules}


def _host(rank: int, n: int, hosts: int):
    return f"host-{rank * hosts // n}" if hosts else None


def _mesh(n: int, dp: int, device=CPU, hosts: int = 0):
    rank = int(__import__("os").environ["RANK"])
    initialize_distributed(device=device, _host=_host(rank, n, hosts))
    devices = global_devices()
    assert [d.process for d in devices] == list(range(process_count()))
    mesh = make_mesh(n, dp=dp, device=devices)
    assert len(set(mesh.hosts)) == (hosts or 1), mesh
    return mesh


def replay_worker(rank: int, n: int, dp: int, n_nodes: int, n_pods: int, chunk: int,
                  hosts: int = 0) -> dict:
    """replay(cw, mesh=process mesh) in every process."""
    mesh = _mesh(n, dp, hosts=hosts)
    assert process_index() == rank and mesh.local == (rank,)
    nodes, pods, cfg = config5(n_nodes, n_pods)
    cw = compile_workload(nodes, pods, cfg, device=CPU)
    rr = replay(cw, chunk=chunk, device=CPU, mesh=mesh)
    return _result(rr)


def stream_worker(rank: int, n: int, dp: int, n_nodes: int, n_pods: int, chunk: int,
                  hosts: int = 0) -> dict:
    """replay_speculative_stream over the process mesh in every process;
    the rounds' accepted K and the fallback point with the result."""
    mesh = _mesh(n, dp, hosts=hosts)
    nodes, pods, cfg = config5(n_nodes, n_pods)
    cw = compile_workload(nodes, pods, cfg, device=CPU)
    rr, stats = replay_speculative_stream(cw, mesh=mesh, chunk=chunk, pods=pods)
    out = _result(rr)
    out["rounds"] = stats["round_batches"], stats["accepted"], stats["fallback_at"]
    out["n_rounds"] = stats["rounds"]
    return out


def engine_worker(rank: int, n: int, n_nodes: int, n_pods: int, spec: str,
                  hosts: int = 0) -> dict:
    """One engine wave over the process mesh, every process over a store
    holding the same objects -> the binds and annotations."""
    import os

    os.environ["KSS_TPU_SPECULATIVE"] = spec
    mesh = _mesh(n, 1, hosts=hosts)
    nodes, pods, cfg = config5(n_nodes, n_pods)
    store = ObjectStore()
    for o in nodes:
        store.create("nodes", copy.deepcopy(o))
    for o in pods:
        store.create("pods", copy.deepcopy(o))
    engine = SchedulerEngine(store, plugin_config=cfg, device=CPU, mesh=mesh)
    bound = engine.schedule_pending()
    placements, annos = {}, {}
    for p in pods:
        cur = store.get("pods", p["metadata"]["name"])
        placements[p["metadata"]["name"]] = cur["spec"].get("nodeName") or ""
        annos[p["metadata"]["name"]] = dict(cur["metadata"].get("annotations") or {})
    return {"bound": bound, "placements": placements, "annotations": annos,
            "jax": "jax" in sys.modules}


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _leaves(v)


def twin_worker(rank: int, n: int, dp: int, n_nodes: int, n_pods: int) -> dict:
    """The twins over the process mesh, each process's partials folded in
    card order through the process group: chunk 0 through
    step_chunk_cards_plain, the batch through spec_eval_cards_plain and its
    binds through spec_commit_cards_plain -> this process's card's carries,
    the joined outputs and the spread counts joined by gather_to_host, for
    the parent to hold against virtual cards in one process."""
    mesh = _mesh(n, dp)
    nodes, pods, cfg = config5(n_nodes, n_pods)
    cw = shard_workload(compile_workload(nodes, pods, cfg, device=CPU), mesh)
    step = build_step(cw)
    xs = _slice_xs(cw.xs, 0, n_pods, n_pods)
    xs["is_pad"] = torch.zeros(n_pods, dtype=torch.bool)
    carry, out = kmesh.step_chunk_cards_plain(step, _clone_carry(cw.init_carry), xs)
    ev = kmesh.spec_eval_cards_plain(step, cw.init_carry, xs)
    committed = kmesh.spec_commit_cards_plain(step, _clone_carry(cw.init_carry), xs,
                                              ev.selected, n_pods // 2)
    spread = gather_to_host(carry[0]["PodTopologySpread"], mesh)
    return {"carry": [t.numpy() for t in _leaves(carry[0])], "spread": spread,
            "out": [t.numpy() for t in _leaves(tuple(out))],
            "eval": [t.numpy() for t in _leaves(tuple(ev))],
            "commit": [t.numpy() for t in _leaves(committed[0])],
            "jax": "jax" in sys.modules}


def errors_worker(rank: int, case: str) -> str:
    """The process mesh's refusals; -> the error's type and message."""
    try:
        if case == "twice":
            initialize_distributed(device=CPU)
            initialize_distributed(device=CPU)
        elif case == "relay":
            # process 0 publishes an address where nothing listens: a relay
            # that cannot be reached
            from kube_scheduler_simulator_tpu_torch.kernels.relay import Relay
            from kube_scheduler_simulator_tpu_torch.parallel import distributed

            initialize_distributed(device=CPU, _host=f"host-{rank}",
                                   _relay="127.0.0.1:1" if rank == 0 else None)
            buf = (ctypes.c_uint64 * 64)()
            Relay(distributed.next_key("x"), rank, 2, 1, ctypes.addressof(buf),
                  {1 - rank: ctypes.addressof(buf)}, (0, 1))
        elif case == "num_processes":
            initialize_distributed(num_processes=2 + rank, device=CPU)
        elif case == "partial_mesh":
            initialize_distributed(device=CPU)
            make_mesh(1, device=global_devices()[:1])
    except Exception as e:  # noqa: BLE001 - the refusal is the result
        return f"{type(e).__name__}: {e}"
    return "no error"


def card_kernels_worker(rank: int, n: int, n_nodes: int, n_pods: int, hosts: int = 0) -> dict:
    """On the card: the three B12c kernels over a process mesh of n
    process-cards (processes sharing a card, or one a card; posing as
    `hosts` hosts, over the relay) against their twins in the same mesh
    -> each kernel's largest difference, the launch counts and the
    exchange's transport, IPC handles opened and relay counts."""
    mesh = _mesh(n, 1, "cuda", hosts)
    dev = mesh.device
    nodes, pods, cfg = config5(n_nodes, n_pods)
    cw = shard_workload(compile_workload(nodes, pods, cfg, device=dev), mesh)
    step = build_step(cw)
    xs = _slice_xs(cw.xs, 0, n_pods, n_pods)
    xs["is_pad"] = torch.zeros(n_pods, dtype=torch.bool, device=dev)

    def err(a, b) -> int:
        return max((int((x.long() - y.long()).abs().max()) if x.numel() else 0)
                   for x, y in zip(_leaves(a), _leaves(b)))

    ck, ok = kmesh.step_chunk_cards(step, _clone_carry(cw.init_carry), xs)
    cp, op = kmesh.step_chunk_cards_plain(step, _clone_carry(cw.init_carry), xs)
    ev = kmesh.spec_eval_cards(step, cw.init_carry, xs)
    evp = kmesh.spec_eval_cards_plain(step, cw.init_carry, xs)
    cc = kmesh.spec_commit_cards(step, _clone_carry(cw.init_carry), xs, ev.selected, n_pods // 2)
    ccp = kmesh.spec_commit_cards_plain(step, _clone_carry(cw.init_carry), xs, ev.selected,
                                        n_pods // 2)
    torch.cuda.synchronize()
    return {"step": max(err(tuple(ok), tuple(op)), err(ck[0], cp[0])),
            "eval": err(tuple(ev), tuple(evp)), "commit": err(cc[0], ccp[0]),
            "launches": (kmesh.step_chunk_cards.launches, kmesh.spec_eval_cards.launches,
                         kmesh.spec_commit_cards.launches),
            "transport": mesh._exchange.transport, "ipc_opened": kmesh.Exchange.ipc_opened,
            "relay": mesh._exchange.relay and mesh._exchange.relay.status()}


def relay_bound_worker(rank: int, n: int, n_nodes: int) -> dict:
    """On the card, over the relay (two processes posing as two hosts):
    step_chunk_cards launched on card 0 alone with a short spin bound, so
    that its wait for card 1 runs past it and both processes raise naming
    process 1 and its host; then a launch of both, which must be whole
    again -> the message and that launch's largest difference from the
    twin."""
    mesh = _mesh(n, 1, "cuda", 2)
    dev = mesh.device
    nodes, pods, cfg = config5(n_nodes, 8)
    cw = shard_workload(compile_workload(nodes, pods, cfg, device=dev), mesh)
    step = build_step(cw)
    xs = _slice_xs(cw.xs, 0, 8, 8)
    xs["is_pad"] = torch.zeros(8, dtype=torch.bool, device=dev)
    msg = ""
    try:
        kmesh.step_chunk_cards(step, _clone_carry(cw.init_carry), xs, _only=(0,),
                               _bound=1 << 22)
    except RuntimeError as e:
        msg = str(e)
    _, out = kmesh.step_chunk_cards(step, _clone_carry(cw.init_carry), xs)
    _, want = kmesh.step_chunk_cards_plain(step, _clone_carry(cw.init_carry), xs)
    err = max(int((a.long() - b.long()).abs().max()) if a.numel() else 0
              for a, b in zip(_leaves(tuple(out)), _leaves(tuple(want))))
    return {"msg": msg, "err": err}


def relay_worker(rank: int, case: str, harness: str, slots: int, epochs: int,
                 n: int = 2) -> dict:
    """The relay's protocol on the CPU, n processes posing as two hosts,
    each card of a row of n played by host threads (harness: the compiled
    tests/torch_relay_cards.cpp) over host buffers of PeerScope's layout.
    Cases: "ordered" (every process plays `epochs` epochs on `slots`
    slots); "silent" (process 1 stops after half, alive: process 0's waits
    pass their bound); "raises" (process 1 raises after half: its
    connection closes without a goodbye, and process 0 raises naming it).
    -> each slot's outcome and epoch, the error word, the relay's status."""
    import numpy as np
    import torch.distributed as dist

    from kube_scheduler_simulator_tpu_torch.kernels import mesh as kmesh
    from kube_scheduler_simulator_tpu_torch.kernels.relay import Relay
    from kube_scheduler_simulator_tpu_torch.parallel import distributed

    mesh = _mesh(n, 1, CPU, 2)
    play = ctypes.CDLL(harness).kss_play
    play.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p]
    words = kmesh.XHEAD + kmesh.XSLOTS * 2 * n * kmesh.XW
    bufs = [np.zeros(words, np.uint64) for _ in range(n)]  # card k's buffer as this card writes it
    relay = Relay(distributed.next_key("x"), rank, n, kmesh.XSLOTS, bufs[rank].ctypes.data,
                  {k: bufs[k].ctypes.data for k in range(n) if k != rank}, mesh.procs)
    half = epochs // 2 if case != "ordered" else epochs
    out = np.zeros(2 * slots, np.int64)
    ptrs = (ctypes.c_void_p * n)(*[b.ctypes.data for b in bufs])
    t0 = time.monotonic()
    relay.arm(slots)
    worst = play(ptrs, n, 0, rank, slots, 0, half, 60_000, out.ctypes.data)
    if rank == 0 and half < epochs and not worst:
        # the second half alone, its waits bounded at 1 s where the peer is silent
        worst = play(ptrs, n, 0, rank, slots, half, epochs - half,
                     1_000 if case == "silent" else 60_000, out.ctypes.data)
    relay.park()
    wait_s = time.monotonic() - t0
    if case == "raises" and rank == 1:
        raise RuntimeError("process 1 raises mid-run")
    word = int(bufs[rank][0])
    if case == "raises":
        raise RuntimeError(f"after {wait_s:.1f} s, outcome {worst}: "
                           + kmesh.error_says(mesh, rank, word))
    dist.barrier()
    status = relay.status()
    relay.stop()
    return {"outcomes": out.reshape(slots, 2).tolist(), "word": word, "status": status,
            "word_after_stop": int(bufs[rank][0]), "jax": "jax" in sys.modules}

