"""Scale-out of the node axis over a mesh: on one card, or over cards.

Port of kube_scheduler_simulator_tpu/parallel/mesh.py.  The JAX package
lays the cluster-node axis over the "nodes" axis of a device mesh and
lets GSPMD insert the cross-shard all-reduces; its "dp" axis spreads a
speculative pod batch.  Here a `Mesh` has the same axes, ("dp",
"nodes"), in one of two forms.

A one-card mesh (B12: `device` one card, or "cpu"):

  * its "nodes" extent S splits the node axis into the contiguous slices
    [r N/S, (r+1) N/S), the slices `_node_axis_spec` (JAX :62) gives on a
    device mesh.  The sharded kernels (kernels/mesh.py) are the
    unsharded step's and eval's cluster kernels at their own plan: a
    cluster of R CTAs (16 where the card has room) in which each shard
    is a group of R / S CTAs over its slice, split again among them
    (csrc/slices.cuh).  The cross-shard reductions run through
    distributed shared memory, in node order.  S is at most 8, so every
    shard has a CTA of its own at either cluster size (16 or 8);
  * its "dp" extent sets the batch ladder's rung rounding
    (parallel/speculative.py `_batch_ladder`); each pod of a batch is a
    cluster of its own already, so the kernels take no dp.
  Statics and carries stay one copy on the card; `shard_workload` returns
  a copy of the workload that carries the mesh.

A card mesh (B12b: `device` a list of distinct cards, or `_virtual` cards
on one device), n = dp x S cards laid out (dp, S) as JAX :57-58 lays
them:

  * card k holds the ("dp", "nodes") position (k // S, k % S).
    `shard_workload` places on each card its node shard's slice of every
    [.., N] tensor of the statics, the xs and the carry (the node axis of
    each leaf from state/compile.py NODE_AXES, as `_node_axis_spec`
    places them), the cluster-wide carries replicated, and whole on
    every card the rows a bind reads at a node another card owns (the
    spread and InterPod node-to-domain rows, VolumeBinding's PV and
    provision rows: kernels/mesh.py WHOLE);
  * inside a card its shard is served by the card's own cluster plan; the
    cards of a "dp" row combine every reduction through an exchange
    buffer on each card (csrc/scope.cuh PeerScope: a system-scope
    release of each card's partial, an acquire poll, the partials folded
    in card order), so results are byte-identical to one card's;
  * the step (kernels/mesh.py step_chunk_cards) runs on every row, each
    keeping its replica of the carry; the dense eval
    (spec_eval_cards) gives "dp" row r the batch's r-th group of pods
    (JAX :160-170); outputs are joined in card order on the mesh's first
    card, where the oracle, the chunk grid, B7 and the decode run as
    they do without a mesh;
  * distinct cards need peer access between every pair
    (`torch.cuda.can_device_access_peer`); nothing is staged through the
    host and there is no fallback to one card.  Virtual cards are the
    counterpart of the JAX package's `--xla_force_host_platform_device_count`:
    n cards on one device (the CPU, or one H100, where they are n
    clusters of one launch), each with its own tensors and its own
    exchange buffer, for tests and measurement only (`make_mesh(...,
    _virtual=True)`).

A process mesh (B12c: `device` the global device set of a process mesh,
`global_devices()` after `initialize_distributed`, parallel/distributed.py):
the same card mesh with card k held by process k, one process a card, so
every process of the mesh runs the same program (SPMD) and returns the
same result:

  * each process places only its own card's parts, cut from the same
    compiled workload exactly as above (`shard_workload`);
  * the kernels are B12b's, unchanged, over one of two transports
    (kernels/mesh.py Exchange).  On one host the exchange buffers are each
    process's own allocations on its card, opened by every other process
    over CUDA IPC.  Across hosts (`hosts`: each card's host, from
    `initialize_distributed`) there is no peer memory: each process keeps
    its card's buffer and an outbox for each other card of its row in
    page-locked host memory mapped into its card, and a host relay in each
    process carries the entries over TCP (csrc/relay.cpp); such a mesh
    takes the relay for every pair of cards, also two on one host, and
    needs no peer access.  Every process issues the same launches in the
    same order, which keeps the exchange's epochs in step without a host
    round trip per launch;
  * after each launch the cards' outputs and error words are gathered
    through the process group, so every process joins the full outputs on
    its own card (where the oracle, the grid, B7 and the decode run) and
    every process raises where any card's wait failed;
  * two processes may share one card: they are two CUDA contexts, each
    with its own memory and its own exchange buffers; distinct cards of
    one host need peer access between every pair;
  * on the CPU the twins fold each combine's partials across the processes
    through the process group, one gather a combine, on one host or many.

On the CPU every kernel's plain twin runs, which computes the same
per-shard (or per-card) decomposition.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..framework.pipeline import build_step
from ..kernels.mesh import (MAX_CARDS, MAX_SHARDS, node_slices, place_cards, spec_eval_cards,
                            spec_eval_sharded)
from ..state.compile import CompiledWorkload
from . import distributed
from .distributed import initialize_distributed  # noqa: F401  (JAX :175)


class Mesh:
    """A ("dp", "nodes") mesh: `shape` is {"dp": dp, "nodes": S} as in a
    jax.sharding.Mesh, `device` the card (or the CPU) that holds the
    workload's unsharded tensors and the joined outputs.  `cards` is None
    on a one-card mesh (B12), else the dp x S cards in mesh order (B12b),
    `virtual` when they are virtual cards of `device`.  On a process mesh
    (B12c) `procs` is each card's process, `hosts` its host and `device`
    this process's card; `local` is the mesh indices of the cards this
    process holds."""

    axis_names = ("dp", "nodes")

    def __init__(self, dp: int, nodes: int, device, cards=None, virtual: bool = False,
                 procs=None, hosts=None):
        if cards is None and nodes > MAX_SHARDS:
            raise ValueError(
                f"a mesh's 'nodes' extent ({nodes}) splits a cluster of the sharded "
                f"kernels into groups of CTAs: they take at most {MAX_SHARDS} shards")
        self.shape = {"dp": dp, "nodes": nodes}
        self.device = resolve_device(device)
        self.cards = None if cards is None else tuple(cards)
        self.virtual = virtual
        self.procs = None if procs is None else tuple(procs)
        self.hosts = None if hosts is None else tuple(hosts)
        me = distributed.process_index()
        self.local = (None if cards is None else tuple(range(len(self.cards))) if procs is None
                      else tuple(k for k, q in enumerate(self.procs) if q == me))

    def node_slices(self, n: int) -> tuple[tuple[int, int], ...]:
        """Shard r's nodes [lo, hi), r = 0..S-1."""
        return node_slices(n, self.shape["nodes"])

    def signature(self) -> tuple:
        """What a compiled program depends on: the axes' extents (JAX
        replay.py:1094 mesh_sig), the device, a card mesh's cards (this
        mesh's own, for virtual cards: their buffers are its own) and a
        process mesh's layout (each card's process, of how many)."""
        cards = None if self.cards is None else (
            tuple(map(str, self.cards)), id(self) if self.virtual else None)
        procs = None if self.procs is None else (self.procs, self.hosts,
                                                 distributed.process_count())
        return (tuple(self.shape.items()), str(self.device), cards, procs)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.signature() == other.signature()

    def __hash__(self) -> int:
        return hash(self.signature())

    def __repr__(self) -> str:
        where = (f"device={self.device}" if self.cards is None else
                 f"{len(self.cards)} virtual cards of {self.device}" if self.virtual else
                 f"cards={[str(c) for c in self.cards]}" if self.procs is None else
                 f"{len(self.cards)} processes' cards {[str(c) for c in self.cards]} on "
                 f"hosts {list(self.hosts)}")
        return f"Mesh(dp={self.shape['dp']}, nodes={self.shape['nodes']}, {where})"


def _card(device) -> torch.device:
    """The card (or the CPU) a device names: "cuda" is the current card,
    or card 0 where there is none (the mesh then raises as it resolves)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return d


def _check_cards(cards: list) -> None:
    """Distinct cards: each present, each pair with peer access."""
    if any(c.type != "cuda" for c in cards):
        raise ValueError(f"a mesh over {[str(c) for c in cards]}: a mesh over several devices "
                         "takes cards only")
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    missing = [str(c) for c in cards if c.index >= have]
    if missing:
        raise RuntimeError(f"a mesh over {[str(c) for c in cards]}: {missing} not present "
                           f"(this host has {have} card{'s' if have != 1 else ''})")
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a.index, b.index):
                raise RuntimeError(f"a mesh over {[str(c) for c in cards]}: {a} has no peer "
                                   f"access to {b}")


def _check_process_cards(cards: list) -> None:
    """A process mesh's cards: all cards or all the CPU; on one host, where
    two processes hold distinct physical cards, this process sees both and
    they have peer access (two processes on one card need none; a mesh
    across hosts exchanges through the relays and needs none)."""
    kinds = {c.device.type for c in cards}
    if len(kinds) > 1:
        raise ValueError(f"a mesh over {[str(c) for c in cards]}: a process mesh takes cards "
                         "only or the CPU only")
    if kinds != {"cuda"} or len({c.host for c in cards}) > 1:
        return
    here = {str(torch.cuda.get_device_properties(i).uuid): i
            for i in range(torch.cuda.device_count())}
    uuids = sorted({c.uuid for c in cards})
    if len(uuids) < 2:
        return
    unseen = [str(c) for c in cards if c.uuid not in here]
    if unseen:
        raise RuntimeError(f"a mesh over {[str(c) for c in cards]}: process "
                           f"{distributed.process_index()} does not see the cards of {unseen}")
    for a in uuids:
        for b in uuids:
            if a != b and not torch.cuda.can_device_access_peer(here[a], here[b]):
                raise RuntimeError(f"a mesh over {[str(c) for c in cards]}: cuda:{here[a]} "
                                   f"has no peer access to cuda:{here[b]}")


def make_mesh(n_devices: int | None = None, dp: int = 1, device="cuda", *,
              _virtual: bool = False) -> Mesh:
    """JAX :42: a (dp) x (nodes = n / dp) mesh.  `device` is one card
    ("cuda" by default, which needs a card) or "cpu": a one-card mesh, n
    defaulting to MAX_SHARDS, 8; or a list of devices: of one card, the
    same; of distinct cards, a mesh over them (n defaults to their number,
    and at most that many are taken, as JAX takes jax.devices()[:n]); or
    `global_devices()` of a process mesh (parallel/distributed.py), card k
    held by process k (B12c), which every process of the mesh calls alike.
    For tests and measurement only, `_virtual` gives n virtual cards of
    the one `device` (the counterpart of the JAX package's virtual CPU
    devices)."""
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    across = [d for d in devices if isinstance(d, distributed.ProcessCard)]
    if across and (len(across) != len(devices) or _virtual):
        raise ValueError("a process mesh is laid over global_devices() alone")
    cards = list(dict.fromkeys(_card(d) for d in devices)) if not across else []
    distinct = len(cards) > 1 or bool(across)
    if distinct and _virtual:
        raise ValueError("virtual cards are cards of one device")
    n = n_devices or (len(devices) if distinct else MAX_SHARDS)
    if n < 1:
        raise ValueError(f"asked for {n} devices")
    if distinct and n > len(devices):
        raise ValueError(f"asked for {n} devices, only {len(devices)} present")
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    if n % dp:
        # name the actual constraint, as the JAX package does, instead of
        # a shape error further down
        raise ValueError(
            f"n_devices ({n}) must divide evenly by dp ({dp}): a "
            f"(dp={dp}) x (nodes={n}/{dp}) mesh is not integral — pick a "
            f"dp that divides the device count")
    if not (distinct or _virtual):
        return Mesh(dp, n // dp, devices[0])
    if n > MAX_CARDS:
        raise ValueError(f"a mesh over {n} cards: a card mesh takes at most {MAX_CARDS}")
    if across:
        chosen = across[:n]
        procs = [c.process for c in chosen]
        if sorted(procs) != list(range(distributed.process_count())):
            raise ValueError(f"a process mesh over {[str(c) for c in chosen]}: it holds one "
                             f"card of each of the {distributed.process_count()} processes")
        _check_process_cards(chosen)
        me = procs.index(distributed.process_index())
        return Mesh(dp, n // dp, chosen[me].device, [c.device for c in chosen], procs=procs,
                    hosts=[c.host for c in chosen])
    if distinct:
        cards = [_card(d) for d in devices[:n]]
        if len(set(cards)) != n:
            raise ValueError(f"a mesh over {[str(c) for c in cards]} names a card twice")
        _check_cards(cards)
        return Mesh(dp, n // dp, cards[0], cards)
    home = resolve_device(devices[0])
    return Mesh(dp, n // dp, home, [home] * n, virtual=True)


def gather_to_host(x, mesh: Mesh | None = None) -> np.ndarray:
    """JAX :80: one replay output as a contiguous C-order host array.  A
    sharded output is one full-width tensor already (on one card each
    shard wrote its slice in place; a card mesh's are joined on its first
    card, a process mesh's on every process's card); a sequence of
    per-card shards is joined in card order along its last (node) axis.
    On a process `mesh` `x` is this process's card's node shard (a tensor,
    or a sequence of one): every process of the mesh calls it, the other
    cards' shards come through the process group, and the first "dp"
    row's are joined (every row holds the same values)."""
    if mesh is not None and mesh.procs is not None:
        mine = x[0] if isinstance(x, (list, tuple)) else x
        parts = distributed.all_gather(torch.as_tensor(mine))
        return gather_to_host([parts[q] for q in mesh.procs[:mesh.shape["nodes"]]])
    if isinstance(x, (list, tuple)):
        return np.ascontiguousarray(np.concatenate([gather_to_host(s) for s in x], axis=-1))
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.ascontiguousarray(x)


def can_shard(n_nodes: int, mesh: Mesh | None) -> bool:
    """JAX :90: whether shard_workload accepts this node count on this
    mesh — the predicate the engine's live waves use to degrade to an
    unsharded wave instead of erroring."""
    if mesh is None:
        return False
    shards = mesh.shape.get("nodes", 1)
    return shards <= 1 or n_nodes % shards == 0


def shard_workload(cw: CompiledWorkload, mesh: Mesh) -> CompiledWorkload:
    """JAX :101: a copy of `cw` carrying the mesh (the input workload is
    left untouched, so unsharded replays of the same object stay
    unsharded).  On one card the tensors are shared: each shard reads and
    writes its slice of them in place.  On a card mesh its statics, xs
    and carry are kernels/mesh.py `Cards`, each card's part placed on it
    (module doc); on a process mesh the parts of this process's card, cut
    from `cw` exactly as every other process cuts its own."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if mesh.device != cw.device:
        raise ValueError(f"workload compiled for {cw.device}, mesh on {mesh.device}")
    if cw.mesh is not None and cw.mesh.cards is not None:
        # its tensors are the cards' already
        if cw.mesh != mesh:
            raise ValueError(f"workload placed over {cw.mesh}, asked for {mesh}")
        return cw
    # node_slices raises on an indivisible node count, with the JAX message
    mesh.node_slices(cw.n_nodes)
    if mesh.cards is None:
        return dataclasses.replace(cw, mesh=mesh)
    statics, xs, carry = place_cards(cw, mesh)
    return dataclasses.replace(cw, mesh=mesh, statics=statics, xs=xs, init_carry=carry)


def sharded_step(cw: CompiledWorkload, mesh: Mesh | None = None):
    """JAX :130: the scheduling step over the node-sharded workload, a
    `Step` whose chunk and single-pod calls run B12 `step_chunk_sharded`
    (one cluster per chunk) or, on a card mesh, B12b `step_chunk_cards`.
    `cw` from shard_workload, or unsharded with the mesh given."""
    if mesh is not None and cw.mesh is None:
        cw = shard_workload(cw, mesh)
    return build_step(cw)


def speculative_scores(cw: CompiledWorkload, mesh: Mesh | None = None):
    """JAX :143: batched speculative evaluation, f(carry, xs_batch) ->
    StepOut batch — every pod of the batch scored against one frozen
    carry, through B12 `spec_eval_sharded` (one cluster per pod, each of
    the mesh's S shards a group of its CTAs) or, on a card mesh, B12b
    `spec_eval_cards` (each "dp" row of cards its group of the batch).
    With no mesh the node axis is one shard."""
    if cw.mesh is None:
        cw = shard_workload(cw, mesh if mesh is not None else Mesh(1, 1, cw.device))
    step = build_step(cw)
    if cw.mesh.cards is not None:
        def run(carry, xs_batch):
            return spec_eval_cards(step, carry, xs_batch)
    else:
        def run(carry, xs_batch):
            return spec_eval_sharded(step, carry, xs_batch)

    return run
