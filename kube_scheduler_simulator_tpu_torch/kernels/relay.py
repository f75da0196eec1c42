"""B12c across hosts: the host relay of a card mesh whose processes span
hosts (csrc/relay.cpp).

It replaces no TPU kernel.  It is the transport under B12b's kernels
where the cards of a process mesh have no peer memory: the counterpart of
the DCN links that XLA's all-reduces cross in the JAX package once
kube_scheduler_simulator_tpu/parallel/mesh.py:175 `initialize_distributed`
has laid the mesh across hosts.  kernels/mesh.py Exchange keeps each
card's exchange buffer (the inbox) and one outbox for each other card of
its "dp" row in page-locked host memory mapped into the card, and
`Relay` carries the entries that the card publishes into each outbox to
that card's process, which writes them into its inbox (the protocol and
why it loses no epoch: csrc/relay.cpp).  The relay works on any host
buffers of PeerScope's layout: the CPU tests drive it with host threads
playing the cards.

Connections: one TCP connection a pair of processes of a row.  Each
process listens from `initialize_distributed` on (parallel/distributed.py
`listener`, its address published with its card); in each pair the
process of the higher index connects, all connections are made before any
is accepted, and every process posts its outcome to the store and reads
every other's, so a connection that is refused raises CrossHostMeshError
in every process of the mesh, naming the process, the host and the
address.  There is no fallback to IPC, to the twins or to one card.
"""

from __future__ import annotations

import ctypes
import socket
import struct

_HELLO = struct.Struct("<64sq")  # the exchange's key, the connecting process


def load_lib() -> ctypes.CDLL:
    """The relay's library, built with g++ at first use (kernels/build.py
    HOST_SIGNATURES), its buffer layout checked against PeerScope's."""
    from . import build
    from . import mesh as kmesh

    lib = build.load("relay")
    head, width, cards = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    lib.kss_relay_layout(ctypes.byref(head), ctypes.byref(width), ctypes.byref(cards))
    if (head.value, width.value, cards.value) != (kmesh.XHEAD, kmesh.XW, kmesh.MAX_CARDS):
        raise RuntimeError("the exchange layout differs between csrc/relay.cpp and "
                           "csrc/scope.cuh (kernels/mesh.py XHEAD, XW, MAX_CARDS)")
    return lib


def _where(q: int) -> str:
    from ..parallel import distributed

    d = distributed.global_devices()[q]
    return f"process {q} on {d.host}"


def _connect(key: str, peers: list[int]) -> dict[int, socket.socket]:
    """This process's connections to the processes `peers` for the
    exchange `key` (every process of the mesh calls it in the same order):
    it connects to each peer of a lower index and accepts each of a
    higher one -> {peer: connected socket, TCP_NODELAY}."""
    from ..parallel import distributed

    me = distributed.process_index()
    devices = distributed.global_devices()
    store = distributed.store()
    socks, err = {}, ""
    for q in sorted(p for p in peers if p < me):
        addr = devices[q].relay
        ip, _, port = addr.rpartition(":")
        try:
            s = socket.create_connection((ip, int(port)), timeout=distributed._TIMEOUT_S)
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            s.sendall(_HELLO.pack(key.encode(), me))
        except OSError as e:
            err = (f"{_where(me)} could not reach the relay of {_where(q)} at {addr}: "
                   f"{type(e).__name__}: {e}")
            break
        socks[q] = s
    store.set(f"{key}/relay/{me}", err)
    keys = [f"{key}/relay/{q}" for q in range(distributed.process_count())]
    store.wait(keys)
    errs = [m for m in (store.get(k).decode() for k in keys) if m]
    if errs:
        for s in socks.values():
            s.close()
        from ..parallel.distributed import CrossHostMeshError

        raise CrossHostMeshError("a mesh across hosts: " + "; ".join(errs))
    lsock = distributed.listener()
    lsock.settimeout(distributed._TIMEOUT_S)
    want = {p for p in peers if p > me}
    while want:
        s, _ = lsock.accept()
        s.settimeout(distributed._TIMEOUT_S)
        got = b""
        while len(got) < _HELLO.size:
            part = s.recv(_HELLO.size - len(got))
            if not part:
                break
            got += part
        if len(got) < _HELLO.size:
            s.close()
            raise ConnectionError(f"{_where(me)}: a relay connection closed before its hello")
        k, q = _HELLO.unpack(got)
        k = k.rstrip(b"\0").decode()
        if k != key or q not in want:
            s.close()
            raise ConnectionError(f"{_where(me)}: a relay connection for exchange {k!r} from "
                                  f"process {q}, expected {key!r} from {sorted(want)}")
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        socks[q] = s
        want.discard(q)
    for s in socks.values():
        s.settimeout(None)
    return socks


class Relay:
    """The relay of this process's card, mesh index `card` in a "dp" row
    of `cards` cards, each card held by process `procs[k]`: `inbox` the
    address of its card's buffer and `outboxes` {k: the address of its
    outbox for card k} for every other card of the row, host buffers of
    `slots` pod slots, zeroed.  Connects to the row's processes (every
    process of the mesh makes its relay in the same order, `key` from
    distributed.next_key) and starts the relay's thread, parked.  `arm` it
    before a launch and `park` it after the wait; `stop` before the
    buffers are freed."""

    def __init__(self, key: str, card: int, cards: int, slots: int, inbox: int,
                 outboxes: dict[int, int], procs):
        from ..parallel import distributed

        self.procs = tuple(procs)
        try:
            self.lib = load_lib()
        except RuntimeError as e:
            raise RuntimeError(f"{_where(distributed.process_index())}: the host relay "
                               f"did not build: {e}") from e
        peers = sorted(outboxes)
        socks = _connect(key, [self.procs[k] for k in peers])
        n = len(peers)
        fds = (ctypes.c_int * n)(*[socks[self.procs[k]].detach() for k in peers])
        self._h = self.lib.kss_relay_start(
            ctypes.c_void_p(inbox), card, cards, slots, n, (ctypes.c_int * n)(*peers), fds,
            (ctypes.c_void_p * n)(*[outboxes[k] for k in peers]))
        if not self._h:
            raise RuntimeError(f"{_where(distributed.process_index())}: the relay's thread "
                               "did not start")

    def arm(self, slots: int) -> None:
        self.lib.kss_relay_arm(self._h, slots)

    def park(self) -> None:
        self.lib.kss_relay_park(self._h)

    def status(self) -> dict:
        """{"sent", "received": entries, "lost": the card whose connection
        was lost or None, "errno"}."""
        out = (ctypes.c_longlong * 4)()
        self.lib.kss_relay_status(self._h, out)
        return {"sent": out[0], "received": out[1], "lost": out[2] - 1 if out[2] else None,
                "errno": out[3]}

    def stop(self) -> None:
        if self._h:
            self.lib.kss_relay_stop(self._h)
            self._h = None
