"""Scale-out of the node axis over a mesh, on one card.

Port of kube_scheduler_simulator_tpu/parallel/mesh.py.  The JAX package
lays the cluster-node axis over the "nodes" axis of a device mesh and
lets GSPMD insert the cross-shard all-reduces; its "dp" axis spreads a
speculative pod batch.  Here a `Mesh` has the same axes, ("dp",
"nodes"), on ONE card:

  * its "nodes" extent S splits the node axis into the contiguous slices
    [r N/S, (r+1) N/S), the slices `_node_axis_spec` (JAX :62) gives on a
    device mesh.  The sharded kernels (B12, kernels/mesh.py) are the
    unsharded step's and eval's cluster kernels at their own plan: a
    cluster of R CTAs (16 where the card has room) in which each shard
    is a group of R / S CTAs over its slice, split again among them
    (csrc/slices.cuh).  The cross-shard reductions run through
    distributed shared memory, in node order.  S is at most 8, so every
    shard has a CTA of its own at either cluster size (16 or 8);
  * its "dp" extent sets the batch ladder's rung rounding
    (parallel/speculative.py `_batch_ladder`): every speculative batch
    splits into dp equal groups of pods.  On one card each pod of a batch
    is a cluster of its own already, so the kernels take no dp.

Statics and carries stay one copy on the card; `shard_workload` returns a
copy of the workload that carries the mesh, and every
replay, stream and engine wave over it runs the sharded kernels
(kernels/mesh.py).  A mesh on the CPU (`device="cpu"`) runs their plain
twins, which compute the same per-shard decomposition: the counterpart of
the JAX package's virtual CPU devices.

Shards on separate cards (peer memory or NCCL, a multi-card host) are
ROADMAP Queue B item B12b: a mesh over more than one card, and
`initialize_distributed`, raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..framework.pipeline import build_step
from ..kernels.mesh import MAX_SHARDS, node_slices, spec_eval_sharded
from ..state.compile import CompiledWorkload

_B12B = ("shards on separate cards are not ported (ROADMAP Queue B: B12b): a mesh "
         "lives on one card")


class Mesh:
    """A ("dp", "nodes") mesh on one card: `shape` is {"dp": dp, "nodes":
    S} as in a jax.sharding.Mesh, `device` the card (or the CPU)."""

    axis_names = ("dp", "nodes")

    def __init__(self, dp: int, nodes: int, device):
        if nodes > MAX_SHARDS:
            raise ValueError(
                f"a mesh's 'nodes' extent ({nodes}) splits a cluster of the sharded "
                f"kernels into groups of CTAs: they take at most {MAX_SHARDS} shards")
        self.shape = {"dp": dp, "nodes": nodes}
        self.device = resolve_device(device)

    def node_slices(self, n: int) -> tuple[tuple[int, int], ...]:
        """Shard r's nodes [lo, hi), r = 0..S-1."""
        return node_slices(n, self.shape["nodes"])

    def signature(self) -> tuple:
        """What a compiled program depends on: the axes' extents (JAX
        replay.py:1094 mesh_sig) and the device."""
        return (tuple(self.shape.items()), str(self.device))

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self.signature() == other.signature()

    def __hash__(self) -> int:
        return hash(self.signature())

    def __repr__(self) -> str:
        return f"Mesh(dp={self.shape['dp']}, nodes={self.shape['nodes']}, device={self.device})"


def _card(device) -> torch.device:
    """The card (or the CPU) a device names: "cuda" is the current card,
    or card 0 where there is none (the mesh then raises as it resolves)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device() if torch.cuda.is_available() else 0)
    return d


def make_mesh(n_devices: int | None = None, dp: int = 1, device="cuda") -> Mesh:
    """JAX :42: a (dp) x (nodes = n / dp) mesh.  n defaults to MAX_SHARDS,
    8.  `device` is one card ("cuda" by default, which
    needs a card), "cpu", or a list of devices, which must name one card:
    a list over several raises (B12b)."""
    devices = list(device) if isinstance(device, (list, tuple)) else [device]
    cards = {_card(d) for d in devices}
    if len(cards) > 1:
        raise NotImplementedError(f"a mesh over {sorted(map(str, cards))}: {_B12B}")
    n = n_devices or MAX_SHARDS
    if n < 1:
        raise ValueError(f"asked for {n} devices")
    if dp < 1:
        raise ValueError(f"dp must be >= 1, got {dp}")
    if n % dp:
        # name the actual constraint, as the JAX package does, instead of
        # a shape error further down
        raise ValueError(
            f"n_devices ({n}) must divide evenly by dp ({dp}): a "
            f"(dp={dp}) x (nodes={n}/{dp}) mesh is not integral — pick a "
            f"dp that divides the device count")
    return Mesh(dp, n // dp, devices[0])


def gather_to_host(x) -> np.ndarray:
    """JAX :80: one replay output as a contiguous C-order host array.  On
    one card a sharded output is already one full-width tensor (each
    shard wrote its slice in place), so this is a contiguous host copy."""
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
    """JAX :101: a copy of `cw` carrying the mesh (the input workload is left untouched, so unsharded replays of the same
    object stay unsharded).  The tensors are shared: on one card each
    shard reads and writes its slice of them in place."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"expected a parallel.mesh.Mesh, got {type(mesh).__name__}")
    if mesh.device != cw.device:
        raise ValueError(f"workload compiled for {cw.device}, mesh on {mesh.device}")
    # node_slices raises on an indivisible node count, with the JAX message
    mesh.node_slices(cw.n_nodes)
    return dataclasses.replace(cw, mesh=mesh)


def sharded_step(cw: CompiledWorkload, mesh: Mesh | None = None):
    """JAX :130: the scheduling step over the node-sharded workload, a
    `Step` whose chunk and single-pod calls run B12 `step_chunk_sharded`
    (one cluster per chunk).  `cw` from shard_workload, or unsharded with
    the mesh given."""
    if mesh is not None and cw.mesh is None:
        cw = shard_workload(cw, mesh)
    return build_step(cw)


def speculative_scores(cw: CompiledWorkload, mesh: Mesh | None = None):
    """JAX :143: batched speculative evaluation, f(carry, xs_batch) ->
    StepOut batch — every pod of the batch scored against one frozen
    carry, through B12 `spec_eval_sharded` (one cluster per pod, each of
    the mesh's S shards a group of its CTAs).  With no mesh the node axis
    is one shard."""
    if cw.mesh is None:
        cw = shard_workload(cw, mesh if mesh is not None else Mesh(1, 1, cw.device))
    step = build_step(cw)

    def run(carry, xs_batch):
        return spec_eval_sharded(step, carry, xs_batch)

    return run


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """JAX :172: the multi-host entry.  A mesh over several cards is
    ROADMAP Queue B item B12b, waiting for a multi-card host."""
    raise NotImplementedError(f"initialize_distributed: {_B12B}")
