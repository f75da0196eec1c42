"""The mesh across processes (B12c), on one host or across hosts.

Port of kube_scheduler_simulator_tpu/parallel/mesh.py:175-195
`initialize_distributed`.  The JAX package starts the JAX distributed
runtime, so that `jax.devices()` is the global device set and `make_mesh`
lays the "nodes" axis across processes and hosts unchanged.  Here
`initialize_distributed` starts the host control plane of a process mesh:
a `torch.distributed` process group, gloo over a TCPStore at the
coordinator (no NCCL: the control plane runs on the CPU too), and
`global_devices()` is then every process's card in process order, each
tagged with its process, its host and the address of its relay.
`make_mesh(n, dp, device=global_devices())` (parallel/mesh.py) lays them
out as (dp, n / dp), one process a card; the card mesh's kernels
(kernels/mesh.py) then combine through exchange buffers:

  * processes of one host: each process allocates its card's buffer on
    the card and every other process opens it over CUDA IPC;
  * processes on several hosts (no peer memory between them): every
    process keeps its card's buffer and one for each other card of its
    row in page-locked host memory mapped into its card, and a host relay
    in each process (csrc/relay.cpp, kernels/relay.py) carries the
    entries between the processes over TCP.  Every pair of processes of
    such a mesh takes the relay, also two on one host.

Each process listens for its relay's connections from the start, on the
interface that reaches the coordinator (127.0.0.1 where the coordinator
is this host's loopback), at a port the OS chose; the address is
published beside the process's card.

A process's card is its current card (`torch.cuda.set_device` before the
call, as a launcher sets it from its local rank); `device="cpu"` makes a
process mesh of the CPU, where the kernels' plain twins run and combine
through the process group.  Two processes may name the same
card: they are two CUDA contexts, each with memory of its own.

The arguments default from the launcher's environment, as JAX's do from
its own: `MASTER_ADDR` and `MASTER_PORT` (the coordinator, process 0's
store), `WORLD_SIZE` and `RANK` (torchrun's names).  A process may
initialize again after `shutdown_distributed`, in the same store: every
key of an initialization carries its number, each process's count of its
own initializations, which SPMD order keeps the same in every process.
"""

from __future__ import annotations

import dataclasses
import datetime
import ipaddress
import json
import os
import socket
import traceback

import torch
import torch.distributed as dist


class CrossHostMeshError(ConnectionError):
    """A process of a mesh across hosts could not reach another's relay
    at the address that process published (kernels/relay.py)."""


@dataclasses.dataclass(frozen=True)
class ProcessCard:
    """One card of the global device set: its process, its host, the
    device as that process names it, the physical card's UUID (None for
    the CPU) and the "address:port" its process's relay listens at."""

    process: int
    host: str
    device: torch.device
    uuid: str | None
    relay: str

    def __str__(self) -> str:
        return f"process {self.process}:{self.device}"


@dataclasses.dataclass
class _State:
    store: object
    rank: int
    world: int
    devices: tuple
    gen: int  # this initialization's number in the store (each process's own count)
    listener: socket.socket  # the relay's listening socket
    exchanges: list  # close() of every exchange opened in this process
    seq: int = 0


_STATE: _State | None = None
_TIMEOUT_S = 120.0  # the store's and the process group's
_SPAWN_GRACE_S = 10.0  # _spawn: how long the other workers may take to fail after a first


def _local_device(device) -> tuple[torch.device, str | None]:
    from .. import resolve_device

    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev, None
    return dev, str(torch.cuda.get_device_properties(dev.index).uuid)


def _relay_listener(coordinator: str) -> socket.socket:
    """A listening TCP socket for this process's relay, on the interface
    that reaches the coordinator host (127.0.0.1 for a loopback one), at a
    port the OS chooses."""
    ip = socket.gethostbyname(coordinator)
    if ipaddress.ip_address(ip).is_loopback:
        ip = "127.0.0.1"
    else:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as probe:
            probe.connect((ip, 1))  # a route lookup: a datagram socket sends nothing here
            ip = probe.getsockname()[0]
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.bind((ip, 0))
    sock.listen(64)
    return sock


def _env_int(name: str) -> int | None:
    v = os.environ.get(name)
    return None if v in (None, "") else int(v)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *, device="cuda",
                           _host: str | None = None, _relay: str | None = None) -> None:
    """JAX :175: start the process mesh's control plane, once per process,
    before any mesh over `global_devices()` is made.  `coordinator_address`
    is "host:port" of process 0's store (default MASTER_ADDR:MASTER_PORT),
    `num_processes` the processes of the mesh (default WORLD_SIZE) and
    `process_id` this one's index (default RANK).  `device` is this
    process's card ("cuda", the current card, by default, which needs a
    card) or "cpu" for a process mesh of the plain twins.  Process 0 holds
    the store, unless the launcher holds it (TORCHELASTIC_USE_AGENT_STORE,
    as torchrun's agent sets it): then every process is its client.  Raises on a second
    call and where the processes disagree on `num_processes`.  Processes
    may run on several hosts; a mesh over them then exchanges through the
    relays.  For tests only: `_host` names this process's host in place of
    its host name (two processes of one machine pose as two hosts), and
    `_relay` is published as this process's relay address in place of its
    listener's."""
    global _STATE
    if _STATE is not None:
        raise RuntimeError(f"initialize_distributed: already initialized (process "
                           f"{_STATE.rank} of {_STATE.world}); call it once per process")
    if coordinator_address is None:
        addr, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not addr or not port:
            raise ValueError("initialize_distributed: no coordinator address: pass "
                             "coordinator_address or set MASTER_ADDR and MASTER_PORT")
        coordinator_address = f"{addr}:{port}"
    n = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    r = process_id if process_id is not None else _env_int("RANK")
    if n is None or r is None:
        raise ValueError("initialize_distributed: pass num_processes and process_id or set "
                         "WORLD_SIZE and RANK")
    if not 0 <= r < n:
        raise ValueError(f"initialize_distributed: process_id {r} of {n} processes")
    host, _, port = coordinator_address.rpartition(":")
    timeout = datetime.timedelta(seconds=_TIMEOUT_S)
    hosts_store = r == 0 and os.environ.get("TORCHELASTIC_USE_AGENT_STORE") != "True"
    store = dist.TCPStore(host, int(port), None, hosts_store, timeout, wait_for_workers=False)
    gen = store.add(f"kss/inits/{r}", 1)
    dev, uuid = _local_device(device)
    listener = _relay_listener(host)
    me = {"n": n, "host": _host or socket.gethostname(), "device": str(dev), "uuid": uuid,
          "relay": _relay or "%s:%d" % listener.getsockname()}
    store.set(f"kss/{gen}/proc/{r}", json.dumps(me))

    def refuse(err: Exception):
        # process 0 holds the store: it leaves only once every process has
        # read what it needs to raise too
        listener.close()
        store.set(f"kss/{gen}/done/{r}", "1")
        if r == 0:
            store.wait([f"kss/{gen}/done/{q}" for q in range(n)])
        raise err

    # every process reads process 0's count first, so a mismatch raises
    # without waiting for a process that will never come
    zero = json.loads(store.get(f"kss/{gen}/proc/0"))
    if zero["n"] != n:
        refuse(ValueError(f"initialize_distributed: num_processes {n} in process {r}, "
                          f"{zero['n']} in process 0"))
    procs = [json.loads(store.get(f"kss/{gen}/proc/{q}")) for q in range(n)]
    bad = {q: e["n"] for q, e in enumerate(procs) if e["n"] != n}
    if bad:
        refuse(ValueError(f"initialize_distributed: num_processes {n} in process {r}, "
                          f"{bad} elsewhere"))
    dist.init_process_group("gloo", store=dist.PrefixStore(f"kss/{gen}/pg", store), rank=r,
                            world_size=n, timeout=timeout)
    devices = tuple(ProcessCard(q, e["host"], torch.device(e["device"]), e["uuid"], e["relay"])
                    for q, e in enumerate(procs))
    _STATE = _State(store, r, n, devices, gen, listener, [])


def shutdown_distributed() -> None:
    """jax.distributed.shutdown: close every exchange this process opened
    (its relay stopped and its buffers freed, or its IPC handles closed,
    before the process group goes), the relay's listener, and tear the
    group down.  A no-op where nothing was initialized."""
    global _STATE
    state, _STATE = _STATE, None
    if state is None:
        return
    try:
        for close in state.exchanges:
            close()
    finally:
        state.listener.close()
        dist.destroy_process_group()


def _state(what: str) -> _State:
    if _STATE is None:
        raise RuntimeError(f"{what}: initialize_distributed() has not been called in this "
                           "process")
    return _STATE


def process_index() -> int:
    """jax.process_index(): this process's index, 0 without a process mesh."""
    return 0 if _STATE is None else _STATE.rank


def process_count() -> int:
    """jax.process_count(): the processes of the mesh, 1 without one."""
    return 1 if _STATE is None else _STATE.world


def global_devices() -> list[ProcessCard]:
    """jax.devices() after initialize: every process's card in process
    order, each tagged with its process and host."""
    return list(_state("global_devices").devices)


def store():
    """The coordinator's TCPStore (the exchanges publish their IPC handles
    and the relays their connections' outcomes through it)."""
    return _state("the process mesh").store


def next_key(name: str) -> str:
    """A store key the processes of an SPMD program draw in the same order
    (each exchange's), unique to this initialization."""
    s = _state("the process mesh")
    s.seq += 1
    return f"kss/{s.gen}/{name}/{s.seq}"


def listener() -> socket.socket:
    """The relay's listening socket of this process (kernels/relay.py)."""
    return _state("the process mesh").listener


def on_shutdown(close) -> None:
    """Run `close()` at shutdown_distributed, before the group goes."""
    _state("the process mesh").exchanges.append(close)


def all_gather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every process's `t` (the same shape and dtype in each), in process
    order, through the process group on the CPU; each on t's device."""
    src = t.detach().to("cpu").contiguous()
    parts = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(parts, src)
    return [p.to(t.device) for p in parts]


def _proc_main(fn, rank: int, world: int, port: int, card, args, results,
               dump_s: float) -> None:
    import faulthandler

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                      RANK=str(rank), TORCHELASTIC_USE_AGENT_STORE="True")
    # a worker that hangs prints every thread's traceback and exits
    faulthandler.dump_traceback_later(dump_s, exit=True)
    torch.set_num_threads(1)
    try:
        if card is not None:
            torch.cuda.set_device(card)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # noqa: BLE001 - the parent raises it with the traceback
        results.put((rank, False, traceback.format_exc()))
        return  # no shutdown: the other workers may be stuck in a collective
    shutdown_distributed()
    faulthandler.cancel_dump_traceback_later()


def _spawn(fn, nprocs: int, args: tuple = (), *, deadline_s: float, cards=None) -> list:
    """Run `fn(rank, *args)` in `nprocs` fresh processes of this host
    (torch.multiprocessing, spawned), the launcher's environment set for
    `initialize_distributed`; the caller holds the store, as torchrun's
    agent does, at a port the OS chose when it bound it, for the call's
    lifetime; process i on card `cards[i]` where cards are given.  The
    launcher of the tests and of chip_smoke.py's phases 34 and 35; users
    start the processes with torchrun.  `fn` calls initialize_distributed
    itself and returns something picklable; the worker shuts the mesh
    down after it.  -> the results in process order.  A worker that
    raises fails the call with its traceback, once every other worker has
    given its result or failed too, or _SPAWN_GRACE_S after the first
    failure, whichever comes first: the call names every failure (a peer
    of a raising worker raises too, and says what it saw).  Workers not
    all done `deadline_s` after the start print
    every thread's traceback (to their standard error), are killed, and
    the call raises naming them."""
    import queue
    import time

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    master = dist.TCPStore("127.0.0.1", 0, None, True, datetime.timedelta(seconds=_TIMEOUT_S),
                           wait_for_workers=False)
    procs = [ctx.Process(target=_proc_main, args=(fn, i, nprocs, master.port,
                                                  None if cards is None else cards[i],
                                                  args, results, max(deadline_s - 5.0, 1.0)),
                         daemon=True)
             for i in range(nprocs)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline_s
    got, failed = {}, {}
    try:
        while len(got) + len(failed) < nprocs and time.monotonic() < end:
            try:
                rank, ok, value = results.get(timeout=min(max(end - time.monotonic(), 0.01),
                                                          1.0))
            except queue.Empty:
                continue
            if ok:
                got[rank] = value
                continue
            if not failed:
                end = min(end, time.monotonic() + _SPAWN_GRACE_S)
            failed[rank] = value
        if failed:
            raise RuntimeError("process mesh: " + "\n".join(
                f"worker {rank} of {nprocs} failed:\n{failed[rank]}" for rank in sorted(failed)))
        if len(got) < nprocs:
            hung = [i for i in range(nprocs) if i not in got]
            codes = [procs[i].exitcode for i in hung]
            raise TimeoutError(f"process mesh: workers {hung} gave no result within "
                               f"{deadline_s} s (exit codes {codes}; a hung worker printed "
                               "its threads' tracebacks to its standard error)")
        for p in procs:
            p.join(timeout=max(end - time.monotonic(), 10.0))
        # a shutdown that failed after the result (its traceback on the
        # worker's standard error) fails the call too
        bad = {i: p.exitcode for i, p in enumerate(procs) if p.exitcode != 0}
        if bad:
            raise RuntimeError(f"process mesh: workers exited with codes {bad} after their "
                               "results")
        return [got[i] for i in range(nprocs)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
